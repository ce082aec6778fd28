from lattice_gaussian_mcmc_tpu_torch.lattices.base import (  # noqa: F401
    Lattice,
    lattice_from_basis,
    lattice_from_numpy,
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
