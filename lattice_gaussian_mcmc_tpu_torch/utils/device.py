"""Device resolution: the port runs on the card unless asked otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the first CUDA device; with no card that raises, so a
    run never drops to the CPU silently. Pass `device="cpu"` to use the
    plain PyTorch versions of the kernels."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


def synchronize(device: torch.device):
    """Wait for the card's work on `device` (nothing to wait for on the
    CPU), so that a host clock read after it covers the work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_backend(backend: str, device: torch.device):
    """A sampler's `backend`: "auto" runs the kernels on a card and their
    plain versions on the CPU; "cuda" raises unless the device is a card."""
    if backend not in ("auto", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "cuda" and device.type != "cuda":
        raise RuntimeError("backend='cuda' needs the sampler on a CUDA "
                           f"device, it is on {device}")
