from lattice_gaussian_mcmc_tpu_torch.visualization.plots import PlottingTools  # noqa: F401,E501
