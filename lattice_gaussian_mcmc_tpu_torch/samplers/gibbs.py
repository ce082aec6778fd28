"""Coordinate-wise Gibbs sampling and annealed Gibbs CVP decoding
(counterpart of the JAX package's `samplers/gibbs.py`).

The target is pi(x) ~ exp(-||B x - t||^2 / (2 sigma^2)) over integer
coefficient vectors x. The conditional of x_i given the rest is a 1D
discrete Gaussian with mu_i = x_i - e_i / G_ii and sigma_i = sigma /
sqrt(G_ii), where G = B^T B and e = G x - B^T t is kept up to date by a
rank-1 update per coordinate. A sweep costs O(n^2) per chain, like one Klein
draw. Plain PyTorch over a batch of chains (the JAX package has no Pallas
kernel here); the draws are inverse-CDF on the window, uniforms from the
Philox stream of `utils/prng.py` (tag TAG_GIBBS, step = sweep + 1, row = i).
On a card a sweep is one captured CUDA graph, replayed (`utils/graphs.py`).

Annealing: sigma_t = sigma0 alpha^t freezes each chain into a local CVP
optimum; the closest point ever visited is kept per chain. Chain 0 of every
target starts at the exact Babai point (`Lattice.nearest_plane`, kernel B7
on a card), so the decoder never returns a worse answer than Babai.
"""

from __future__ import annotations

import torch

from lattice_gaussian_mcmc_tpu_torch.lattices.base import Lattice
from lattice_gaussian_mcmc_tpu_torch.ops.discrete_gaussian import (
    DEFAULT_WINDOW,
    sample_dgauss_inverse_cdf,
)
from lattice_gaussian_mcmc_tpu_torch.utils import graphs
from lattice_gaussian_mcmc_tpu_torch.utils.prng import (
    TAG_GIBBS,
    chain_ids,
    philox_uniform,
)


def _gibbs_sweep(seed, step, chains, x, e, G, sigma, window):
    """One systematic-scan sweep over the coordinates of x (C, n), e (C, n)
    in place; `chains` are the Philox chain ids of the C rows."""
    n = x.shape[1]
    g_diag = torch.diagonal(G)
    sigmas = sigma * torch.sqrt(1.0 / g_diag)
    u = philox_uniform(seed, chains, step, torch.arange(n, device=x.device),
                       TAG_GIBBS).to(x.dtype)                     # (n, C)
    for i in range(n):
        mu = x[:, i] - e[:, i] / g_diag[i]
        z = sample_dgauss_inverse_cdf(u[i], mu, sigmas[i], window)
        e += (z - x[:, i])[:, None] * G[:, i][None, :]
        x[:, i] = z


def _problem(lattice: Lattice, target):
    B = lattice.basis
    t = torch.as_tensor(target).to(device=B.device, dtype=B.dtype)
    return B.T @ B, t, t @ B           # G, targets, (B^T t) per target


def gibbs_chain(seed: int, lattice: Lattice, target, sigma, n_sweeps: int,
                x0=None, window: int = DEFAULT_WINDOW):
    """Fixed-temperature Gibbs chain(s) for one target (n,). x0 is (n,) (one
    chain) or (C, n) (C chains); default the Babai point. Returns (trace
    (T, n) or (T, C, n), final x (n,) or (C, n)). On a card a sweep is one
    captured CUDA graph, replayed (`utils/graphs.py`)."""
    G, t, Bt = _problem(lattice, target)
    if x0 is None:
        x0 = lattice.nearest_plane(t)
    x0 = torch.as_tensor(x0).to(device=G.device, dtype=G.dtype)
    single = x0.ndim == 1
    x = x0.reshape(-1, lattice.n).clone()
    e = x @ G - Bt
    chains = chain_ids(x.shape[0], 0, G.device)
    sig = torch.as_tensor(sigma, dtype=G.dtype, device=G.device)

    def sweep(step, x, e):
        _gibbs_sweep(seed, step, chains, x, e, G, sig, window)
        return x, e

    (x, _), (trace,) = graphs.run_kept(sweep, (x, e), n_sweeps)
    if single:
        return trace[0], x[0]
    return trace.transpose(0, 1), x


def annealed_gibbs_decode(seed: int, lattice: Lattice, target, sigma0,
                          n_sweeps: int = 50, n_chains: int = 64,
                          alpha: float = 0.9, window: int = DEFAULT_WINDOW):
    """Annealed Gibbs CVP decoding of one target (n,) or a batch (T, n):
    n_chains chains per target from the Babai point (chain 0 exactly, the
    others moved by a uniform {-1, 0, 1} per coordinate), sweeps at
    sigma_t = sigma0 alpha^t, the closest point per chain kept. Returns
    (best point, best coefficients, best squared distance), per target. On
    a card a sweep is one captured CUDA graph, replayed (the Babai start
    stays outside it)."""
    G, t, Bt = _problem(lattice, target)
    single = t.ndim == 1
    t, Bt = t.reshape(-1, lattice.n), Bt.reshape(-1, lattice.n)
    T, C, n = t.shape[0], n_chains, lattice.n
    dev, dt = G.device, G.dtype
    x_babai = lattice.nearest_plane(t).to(dt)                     # (T, n)
    chains = chain_ids(T * C, 0, dev)
    # starts: step 0 of the stream; chain 0 of each target unperturbed
    u = philox_uniform(seed, chains, 0, torch.arange(n, device=dev),
                       TAG_GIBBS).T.to(dt)                        # (T C, n)
    pert = torch.floor(3.0 * u) - 1.0
    pert.view(T, C, n)[:, 0] = 0.0
    x = (x_babai[:, None, :] + pert.view(T, C, n)).reshape(T * C, n)
    Bt_c = Bt.repeat_interleave(C, dim=0)
    e = x @ G - Bt_c
    # sweep s (Philox step s + 1) anneals at sigma0 alpha^s
    schedule = torch.tensor([sigma0 * alpha ** s for s in range(n_sweeps)],
                            dtype=dt, device=dev)

    def dist2(x, e):
        # ||B x - t||^2 - ||t||^2 = x . (G x - 2 B^T t)
        return (x * (e - Bt_c)).sum(dim=1)

    def sweep(step, x, e, best_x, best_d):
        sig = schedule.index_select(0, step - 1)
        _gibbs_sweep(seed, step, chains, x, e, G, sig, window)
        d = dist2(x, e)
        better = d < best_d
        return (x, e, torch.where(better[:, None], x, best_x),
                torch.where(better, d, best_d))

    steps = graphs.stepper(sweep, (x, e, x.clone(), dist2(x, e)))
    steps.replay(n_sweeps)
    _, _, best_x, best_d = steps.state
    i = best_d.view(T, C).argmin(dim=1)
    bx = best_x.view(T, C, n)[torch.arange(T, device=dev), i]
    point = bx @ lattice.basis.T
    d2 = ((point - t) ** 2).sum(dim=1)
    if single:
        return point[0], bx[0], d2[0]
    return point, bx, d2
