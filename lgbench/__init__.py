"""The benchmark of the PyTorch/CUDA port (`lattice_gaussian_mcmc_tpu_torch`):
`run.py` runs one cell of `BENCHMARK.json`; `harness.py` finds the cell's
files by name; `reference/` is the plain reference that decides `correct`;
`roofline/` holds the frozen counts of the kernels' work."""
