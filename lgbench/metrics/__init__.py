"""One file a metric, named as in BENCHMARK.json: `read(ctx)` returns the
metric's value, or None when the run holds nothing for it to read. `ctx`
carries the run's call latencies (s), rows returned (`units`), window and
set-up seconds, the cell's shapes and, in a traced run, the reduced trace
(`lgbench/trace.py`)."""
