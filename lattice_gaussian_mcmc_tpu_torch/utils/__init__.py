from lattice_gaussian_mcmc_tpu_torch.utils.stats import (  # noqa: F401
    log_softmax,
    logsumexp,
    softmax,
)
