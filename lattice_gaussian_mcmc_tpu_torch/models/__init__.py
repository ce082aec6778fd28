from lattice_gaussian_mcmc_tpu_torch.models.grid import grid_adjacency  # noqa: F401
from lattice_gaussian_mcmc_tpu_torch.models.gmrf import (  # noqa: F401
    gmrf_precision,
    gmrf_sample,
    gmrf_log_density,
)
from lattice_gaussian_mcmc_tpu_torch.models.car import car_precision  # noqa: F401
from lattice_gaussian_mcmc_tpu_torch.models.ising import (  # noqa: F401
    ising_energy,
    ising_gibbs_sweep,
    ising_sample,
)
