"""The benchmark's plain reference: one module per entry point the cells
drive, each a `Reference(basis, sigma, params, device)` with `shapes()` and
`expected(rows, control=False)`. Plain NumPy and PyTorch; it imports
neither JAX nor the JAX package nor anything of the port, and takes nothing
the port made: it works out the Gram-Schmidt factors, windows, widths and
Cholesky factors again from the basis."""
