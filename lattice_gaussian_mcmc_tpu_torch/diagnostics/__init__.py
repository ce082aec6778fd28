from lattice_gaussian_mcmc_tpu_torch.diagnostics.mcmc import (  # noqa: F401
    acceptance_rate,
    autocorrelation,
    diagnose_chain,
    effective_sample_size,
    ess_batch_means,
    integrated_autocorr_time,
    jump_distances,
    mcse,
    mcse_spectral,
    pooled_acf,
    sokal_tau,
)
from lattice_gaussian_mcmc_tpu_torch.diagnostics.convergence import (  # noqa: F401,E501
    batch_means_variance,
    gelman_rubin,
    kl_divergence_discrete,
    ks_2sample,
    mixing_time_from_tvd,
    sliced_wasserstein,
    tvd_discrete,
    tvd_histogram,
    tvd_vs_exact,
    wasserstein_1d,
)
from lattice_gaussian_mcmc_tpu_torch.diagnostics.spectral import (  # noqa: F401
    empirical_transition_gap,
    kmeans_discretize,
    mixing_time_bounds,
    spectral_gap_mc,
    spectral_gap_theoretical,
)
