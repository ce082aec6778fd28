"""The program under test, one module per entry point a mix drives: each an
`Entry(plan)` whose set-up builds the port's objects from the benchmark's
basis and whose `call(args)` makes one call of that entry point and returns
its rows (one per point or target). These are the only files that import
the port, and only through its public names."""
