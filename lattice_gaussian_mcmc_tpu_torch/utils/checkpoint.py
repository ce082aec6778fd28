"""Chain-state checkpoint and resume (counterpart of the JAX package's
`utils/checkpoint.py`), in the JAX package's npz layout: `step_<n>.npz`
under the checkpoint directory, holding `__step` and the state's leaves as
`leaf_<i>` in JAX's flattening order (dict entries by sorted key, lists and
tuples in order, None no leaf). So a checkpoint either package writes
restores in the other. The JAX package writes orbax directories
(`step_<n>/`) where orbax is installed; the port reads only npz and says
so for such a directory.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional

import numpy as np
import torch


def _leaves(state) -> List[Any]:
    if state is None:
        return []
    if isinstance(state, dict):
        return [x for k in sorted(state) for x in _leaves(state[k])]
    if isinstance(state, (list, tuple)):
        return [x for v in state for x in _leaves(v)]
    return [state]


def _rebuild(template, leaves):
    """`template`'s structure filled from the iterator `leaves`: a tensor
    leaf restores as a tensor on the template's device, a Python number
    as one, anything else as a numpy array."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        vals = [_rebuild(v, leaves) for v in template]
        if hasattr(template, "_fields"):        # a namedtuple
            return type(template)(*vals)
        return type(template)(vals)
    arr = next(leaves)
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(template.device)
    if isinstance(template, (bool, int, float)):
        return type(template)(arr.item())
    return arr


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path: str, state, step: int) -> str:
    """Write `state` (a dict, list or tuple of tensors, arrays and numbers)
    as `path/step_<step>.npz`. Returns the file written."""
    os.makedirs(path, exist_ok=True)
    file = os.path.join(path, f"step_{step}.npz")
    np.savez_compressed(
        file, __step=step,
        **{f"leaf_{i}": _host(x) for i, x in enumerate(_leaves(state))})
    return file


def restore_checkpoint(path: str, template, step: Optional[int] = None):
    """Restore the latest (or the given) step into `template`'s structure.
    Returns (state, step), or (None, -1) if there is none."""
    if not os.path.isdir(path):
        return None, -1
    steps = []
    for e in os.listdir(path):
        if e.startswith("step_"):
            s = e[len("step_"):].split(".")[0]
            if s.isdigit():
                steps.append(int(s))
    if not steps:
        return None, -1
    target = step if step is not None else max(steps)
    file = os.path.join(path, f"step_{target}.npz")
    if not os.path.exists(file):
        if os.path.isdir(os.path.join(path, f"step_{target}")):
            raise ValueError(f"{path}/step_{target} is an orbax checkpoint; "
                             "this package reads the npz layout only")
        raise FileNotFoundError(file)
    with np.load(file) as data:
        n = len(_leaves(template))
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    return _rebuild(template, iter(leaves)), target
