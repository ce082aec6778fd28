"""PyTorch/CUDA port of the lattice Gaussian sampling framework.

The JAX package `lattice_gaussian_mcmc_tpu` is the reference; this package
imports none of it and no JAX. Its kernels are hand-written CUDA for Hopper
(`csrc/`), built with nvcc at first use. Entry points run on the CUDA card
unless given `device="cpu"`, where the kernels' plain PyTorch versions run.

Ported so far: the IMHK main path (lattices, the Klein precomputation, the
Klein draw and fused IMHK kernels, `IMHKSampler.sample_iid`).
"""

__version__ = "0.1.0"

from lattice_gaussian_mcmc_tpu_torch.lattices import (  # noqa: F401
    Lattice,
    lattice_from_basis,
    ntru_lattice,
    qary_lattice,
)
from lattice_gaussian_mcmc_tpu_torch.samplers import (  # noqa: F401
    IMHKSampler,
    KleinPrecomp,
    klein_precompute,
)
