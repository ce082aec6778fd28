from lattice_gaussian_mcmc_tpu_torch.reduction.lll import (  # noqa: F401
    lll_reduce,
    bkz_reduce,
    lll_reduce_python,
    native_available,
)
from lattice_gaussian_mcmc_tpu_torch.reduction.analysis import (  # noqa: F401
    hermite_factor,
    orthogonality_defect,
    basis_quality_profile,
    sampling_reduce,
    compare_bases,
    reduction_cost_model,
    recommend_strategy,
    lll_with_removals,
    local_gs_swap_improve,
)
