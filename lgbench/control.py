"""The control of a cell's check: the plain reference put in the program's
place and computed one precision below what the configuration states, on
the rows a run of the cell checks, compared with the float64 reference by
the run's own comparison. A sound check reads it far above the cell's
limit.

    python3 lgbench/control.py --workload <cell> --seeds 11 12 13

prints one JSON line a seed ({"seed", "rows", "rows_differ", "limit"}).
The rows are drawn as a run of the cell draws them: `rows_per_call` rows of
each of calls 1, 2, .. until the cell's `max_rows` are reached. It runs on
the card when there is one, and on the CPU otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lgbench import harness, traffic  # noqa: E402


def rows_of_a_run(p: harness.Plan, seed: int) -> dict:
    """The reference's rows of the calls a run of seed `seed` checks."""
    calls = traffic.make(p.mix, p.basis, seed, p.device)
    rng = np.random.default_rng(seed)
    per_call, most = int(p.check["rows_per_call"]), int(p.check["max_rows"])
    parts, k = [], 0
    while len(parts) * per_call < most:
        k += 1
        idx = torch.as_tensor(rng.choice(harness.rows_per_call(p.mix),
                                         per_call, replace=False))
        parts.append(calls.call(k).rows(idx))
    calls.close()
    return harness.pick(harness.cat_rows(parts), rng, most)[0]


def reading(bench: harness.Bench, cell: str, seed: int, device) -> dict:
    p = harness.plan(bench, cell, device)
    rows = rows_of_a_run(p, seed)
    ref = p.reference.Reference(p.basis, p.sigma, p.mix, p.device)
    differ = harness.compare(ref.expected(rows, control=True),
                             ref.expected(rows))
    return {"seed": seed, "rows": next(iter(rows.values())).shape[0],
            "rows_differ": differ,
            "limit": float(p.check["limits"]["rows_differ"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    bench = harness.Bench()
    for seed in args.seeds:
        print(json.dumps(dict(reading(bench, args.workload, seed, device),
                              workload=args.workload, device=device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
