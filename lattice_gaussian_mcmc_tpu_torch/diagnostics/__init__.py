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
