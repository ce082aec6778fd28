from lattice_gaussian_mcmc_tpu_torch.parallel.mesh import (  # noqa: F401
    CHAIN_AXIS,
    ChainMesh,
    make_mesh,
    shard_range,
)
from lattice_gaussian_mcmc_tpu_torch.parallel.collectives import (  # noqa: F401,E501
    global_acceptance,
    global_gelman_rubin,
    global_moments,
    sharded_imhk_blocked,
    sharded_imhk_chains,
    sharded_klein_batch,
    sharded_peikert,
)
