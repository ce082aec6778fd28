# klein must come before klein_blocked: the kernel module between them
# imports samplers.klein
from lattice_gaussian_mcmc_tpu_torch.samplers.klein import (  # noqa: F401
    KleinPrecomp,
    KleinSampler,
    klein_log_density,
    klein_log_weight,
    klein_points,
    klein_precomp_from_numpy,
    klein_precompute,
    klein_sample,
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
    MetropolisKleinSampler,
    SMKSampler,
    estimate_burn_in,
    imhk_chain,
    imhk_chains,
    imhk_init,
    imhk_step,
    smk_chain,
    smk_chains,
    smk_step,
    spectral_gap_mc,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.peikert import (  # noqa: F401
    PeikertPrecomp,
    PeikertSampler,
    peikert_precomp_from_numpy,
    peikert_precompute,
    peikert_sample,
    peikert_sample_batch,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.sign import (  # noqa: F401
    FalconSigner,
    verify,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.gibbs import (  # noqa: F401
    annealed_gibbs_decode,
    gibbs_chain,
)
from lattice_gaussian_mcmc_tpu_torch.lattices.identity import (  # noqa: F401
    identity_lattice,
    sample_zn,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.unified import (  # noqa: F401
    UnifiedLatticeSampler,
)
from lattice_gaussian_mcmc_tpu_torch.samplers.adaptive import (  # noqa: F401
    adaptive_klein_sample,
    choose_precision,
    f32_law_distortion_bound,
)
