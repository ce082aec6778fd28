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
    ducas_prest_bound,
    ntru_keygen,
    ntru_lattice,
    ntru_secret_basis,
    verify_ntru_basis,
)
from lattice_gaussian_mcmc_tpu_torch.lattices.qary import (  # noqa: F401
    dilithium_parameters,
    estimate_bkz_security,
    estimate_security_from_lattice,
    falcon_parameters,
    hnf,
    lattice_volume_qary,
    lwe_lattice,
    module_lattice,
    qary_from_matrix,
    qary_lattice,
    rlwe_lattice,
)
from lattice_gaussian_mcmc_tpu_torch.lattices.identity import (  # noqa: F401,E501
    identity_lattice,
)
