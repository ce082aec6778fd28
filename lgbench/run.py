"""Run one cell of the benchmark once and print its result.

    python3 lgbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

(or `python3 -m lgbench.run ...`) from the root of a checkout, on a machine
with the card the cell asks for. The last line of standard output is one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), device and, traced, the
breakdown; the numbers compared to decide `correct` come last, under
"checks", and again as the last lines of standard error. Without a CUDA
card, or with fewer than the cell asks for, it prints no result and exits
2; if a module of JAX or of the JAX package is loaded once the window has
closed, it exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import torch  # noqa: E402

from lgbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = harness.Bench()
    chips = int(bench.cell(args.workload)["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"has {have}", file=sys.stderr)
        return 2
    result = harness.run(bench, args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda:0", T_START)
    found = harness.forbidden_modules()
    if found:
        print("modules of JAX or the JAX package are loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        bound = ", ".join(f"{k} {v}" for k, v in c.items() if k != "value")
        print(f"check {name} {c['value']} ({bound})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
