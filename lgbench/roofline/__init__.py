"""Frozen counts of the algorithms' work, one module per kernel, and the
roofline bound they give on the card.

A kernel module has `SYMBOL`, a regular expression that its launches'
names in the profiler's trace match, and `count(shapes)`, the work of one
launch at the cell's shapes as the algorithm needs it, whatever implements
it: `mma_flop`, the multiply-adds of its matrix products at two FLOP each,
counted once; `exp`, its exps, logs, square roots, sines and cosines, one
operation each; `bytes`, each input byte read once and each output byte
written once. The bound is the largest of the three at the card's published
peaks (`peaks.json`), so no correct implementation reads above 100%.
"""

from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def peaks() -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


def bound(count: dict, pk: dict = None):
    """(seconds, what bounds it) of one launch's count."""
    pk = pk or peaks()
    terms = {"mma": count["mma_flop"] / pk["tensor_flop_s"],
             "exp": count["exp"] / pk["exp_op_s"],
             "bytes": count["bytes"] / pk["hbm_bytes_s"]}
    by = max(terms, key=terms.get)
    return terms[by], by


def port_kernel_patterns() -> list:
    with open(os.path.join(HERE, "port_kernels.json")) as f:
        return json.load(f)["patterns"]
