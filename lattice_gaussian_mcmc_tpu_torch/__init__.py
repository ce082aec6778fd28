"""PyTorch/CUDA port of the lattice Gaussian sampling framework.

The JAX package `lattice_gaussian_mcmc_tpu` is the reference; this package
imports none of it and no JAX. Its kernels are hand-written CUDA for Hopper
(`csrc/`), built with nvcc at first use. Entry points run on the CUDA card
unless given `device="cpu"`, where the kernels' plain PyTorch versions run.

It does everything the JAX package does: the rows of the reference's
flagship benchmark — lattices,
the Klein precomputation, IMHK (`IMHKSampler.sample_iid` and the trajectory
`sample`), symmetric Metropolis-Klein (`MetropolisKleinSampler`), Peikert
(`PeikertSampler`) and the MCMC diagnostics — and the benchmark suite's
rows and reduction rows (`experiments/benchmark.py`), Z^n
(`identity_lattice`, `sample_zn`), `KleinSampler`, Babai and Gibbs
decoding and the `UnifiedLatticeSampler` facade, with kernels B1-B8 (Klein
draw, fused IMHK, IMHK trajectory, fused SMK, Peikert, Klein ring, Babai,
Z^n); FALCON-style signing (`FalconSigner`: hash-to-point, Klein draws
at each message's own centre, the norm bound and redraws); lattice
reduction (`reduction/`, host C++ built with g++ at first
use), the rest of the lattice layer, the convergence, spectral and report
diagnostics, the sampler utilities, precision dispatch
(`samplers/adaptive.py`) and sigma adaptation (`samplers/adaptation.py`),
the experiments `decoding`, `klein_validation`, `convergence_study`,
`dimension_scaling`, `cryptographic`, `parameter_sensitivity`,
`adaptation`, `mesh_scaling` and `klein_scaling` with the
`lattice-mcmc-torch` CLI (`experiments/cli.py`) and the tables and figures
(`experiments/reporting.py`), sharded chains on `torch.distributed`
(`parallel/`), the GMRF, CAR and Ising models (`models/`), checkpoints,
profiling and plots (`utils/`, `visualization/`).
"""

__version__ = "0.1.0"

from lattice_gaussian_mcmc_tpu_torch.lattices import (  # noqa: F401
    Lattice,
    lattice_from_basis,
    ntru_lattice,
    qary_lattice,
)
from lattice_gaussian_mcmc_tpu_torch.samplers import (  # noqa: F401
    FalconSigner,
    IMHKSampler,
    KleinPrecomp,
    KleinSampler,
    MetropolisKleinSampler,
    PeikertSampler,
    SMKSampler,
    UnifiedLatticeSampler,
    identity_lattice,
    imhk_chain,
    klein_precompute,
    klein_sample,
)
