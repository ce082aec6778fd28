# klein must come before klein_blocked: the kernel module between them
# imports samplers.klein
from lattice_gaussian_mcmc_tpu_torch.samplers.klein import (  # noqa: F401
    KleinPrecomp,
    klein_log_weight,
    klein_points,
    klein_precomp_from_numpy,
    klein_precompute,
    klein_sample_batch,
    suggest_window,
    suggest_window_budget,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.klein_blocked import (  # noqa: F401,E501
    imhk_steps_batch_blocked,
    klein_sample_batch_blocked,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.imhk import (  # noqa: F401
    ChainState,
    IMHKSampler,
    estimate_burn_in,
    imhk_init,
    imhk_step,
    spectral_gap_mc,
)
