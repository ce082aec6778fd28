from lattice_gaussian_mcmc_tpu_torch.lattices.base import (  # noqa: F401
    Lattice,
    coeffs_from_points,
    covering_radius_bound,
    first_minimum_estimate,
    gaussian_heuristic,
    is_integer_basis,
    lattice_from_basis,
    lattice_from_numpy,
    smoothing_parameter,
    volume,
)

from lattice_gaussian_mcmc_tpu_torch.lattices.ntru import (  # noqa: F401
    ntru_keygen,
    ntru_lattice,
    ntru_secret_basis,
)
from lattice_gaussian_mcmc_tpu_torch.lattices.qary import (  # noqa: F401
    falcon_parameters,
    qary_lattice,
)
