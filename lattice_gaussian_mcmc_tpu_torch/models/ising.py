"""Ising model with a checkerboard Gibbs sampler (counterpart of the JAX
package's `models/ising.py`): each sweep updates the two colours of the
periodic 2D grid in turn, half the lattice per vectorised update."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from lattice_gaussian_mcmc_tpu_torch.utils.device import resolve_device


def ising_energy(spins: torch.Tensor, J: float = 1.0, h: float = 0.0):
    """E = -J sum_<ij> s_i s_j - h sum_i s_i on a periodic 2D grid.
    spins: (H, W) of +-1."""
    nb = torch.roll(spins, 1, 0) + torch.roll(spins, 1, 1)
    return -J * torch.sum(spins * nb) - h * torch.sum(spins)


def _neighbor_sum(spins):
    return (torch.roll(spins, 1, 0) + torch.roll(spins, -1, 0)
            + torch.roll(spins, 1, 1) + torch.roll(spins, -1, 1))


def ising_gibbs_sweep(spins: torch.Tensor, beta: float, J: float = 1.0,
                      h: float = 0.0,
                      generator: Optional[torch.Generator] = None,
                      uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]]
                      = None) -> torch.Tensor:
    """One checkerboard Gibbs sweep (two half-updates), on uniforms drawn
    from `generator` or given as `uniforms=(u0, u1)`, one (H, W) field for
    each colour."""
    H, W = spins.shape
    ii = torch.arange(H, device=spins.device)[:, None]
    jj = torch.arange(W, device=spins.device)[None, :]
    parity = (ii + jj) % 2
    for color in (0, 1):
        # conditional: P(s = +1) = sigmoid(2 beta (J * nbs + h))
        p_up = torch.sigmoid(2.0 * beta * (J * _neighbor_sum(spins) + h))
        if uniforms is None:
            u = torch.rand(spins.shape, generator=generator,
                           dtype=p_up.dtype, device=spins.device)
        else:
            u = torch.as_tensor(uniforms[color], dtype=p_up.dtype).to(
                spins.device)
        new = torch.where(u < p_up, 1.0, -1.0).to(spins.dtype)
        spins = torch.where(parity == color, new, spins)
    return spins


def ising_sample(shape, beta: float, n_sweeps: int = 200, J: float = 1.0,
                 h: float = 0.0, seed: int = 0, dtype=torch.float32,
                 device=None):
    """A configuration after n_sweeps checkerboard sweeps from a random
    start, on `device` (None: the card), its draws from a generator seeded
    with `seed`. Returns (spins, energy, magnetization)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    spins = torch.where(torch.rand(tuple(shape), generator=gen,
                                   device=device) < 0.5, 1.0, -1.0).to(dtype)
    for _ in range(n_sweeps):
        spins = ising_gibbs_sweep(spins, beta, J, h, generator=gen)
    return spins, ising_energy(spins, J, h), spins.mean()
