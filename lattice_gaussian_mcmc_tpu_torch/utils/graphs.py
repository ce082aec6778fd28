"""The plain chains' steps on a card as one captured CUDA graph, replayed
(the counterpart of the JAX package's `jax.jit` over `lax.scan` and
`fori_loop` in `samplers/imhk.py`, `samplers/klein.py`,
`samplers/gibbs.py` and `experiments/decoding.py`).

The port's chains are per-row PyTorch ops. Run eagerly on a card, each op
is a launch from Python: a 2D IMHK step is hundreds of them. `StepGraph`
records one step once and replays it. A replay runs the recorded kernels
on the same buffers, so a captured chain gives the eager chain's bits.

A step is `body(step, *state)`: it reads the state tensors and returns
their next values, or the same tensors updated in place. `step` is the
Philox step of the step being taken, a one-element int64 tensor on the
state's device, one above the last step's: the graph advances it inside
the capture, so each replay draws the next step. A body reads nothing else
that changes from step to step, and asks the host nothing (no `.item()`,
no `float(tensor)`, no Python branch on a tensor): the capture refuses a
host sync.

`stepper` captures a CUDA state and steps a CPU state eagerly
(`EagerSteps`), the rule the kernel wrappers follow. A capture that fails
raises: nothing on a card falls back to the eager loop.
"""

from __future__ import annotations

import time

import torch

# eager steps on copies of the state before the capture, so that lazy
# set-up (cuBLAS handles and workspaces) happens outside it
WARMUP_STEPS = 1


def _counter(step: int, device) -> torch.Tensor:
    return torch.full((1,), int(step), dtype=torch.int64, device=device)


class EagerSteps:
    """The CPU's route: `replay(k)` calls the body k times."""

    def __init__(self, body, state, step: int = 0):
        self.body = body
        self.state = tuple(state)
        self.step = _counter(step, self.state[0].device)

    def replay(self, k: int = 1):
        for _ in range(k):
            self.step = self.step + 1
            self.state = tuple(self.body(self.step, *self.state))


def step_in_place(body, step: torch.Tensor, state):
    """One step on static buffers, the work a `StepGraph` captures: the
    counter `step` advanced in place, then the body's results copied into
    `state` (a tensor the body updated in place is left as it is)."""
    step.add_(1)
    new = tuple(body(step, *state))
    if [(n.shape, n.dtype) for n in new] != [(s.shape, s.dtype)
                                             for s in state]:
        raise ValueError("a step must return tensors of its state's shapes "
                         "and types")
    for s, n in zip(state, new):
        if n is not s:
            s.copy_(n)


class StepGraph:
    """One step of `body` on CUDA tensors, captured at the first replay
    into a private memory pool; `replay(k)` replays it k times. `state`
    holds the static buffers: copies of the given state, updated by every
    replay. `step` is the device counter: the Philox step of the last step
    taken. `captures` and `replays` count graphs captured and replays run
    since `reset_counts()`, `capture_s` the host seconds their captures
    took (warm-up step, synchronisation and capture)."""

    captures = 0
    replays = 0
    capture_s = 0.0

    def __init__(self, body, state, step: int = 0):
        state = tuple(state)
        for t in state:
            if not t.is_cuda:
                raise ValueError("StepGraph captures CUDA tensors only; a "
                                 "CPU state steps eagerly (EagerSteps)")
        self.body = body
        self.state = tuple(t.clone() for t in state)
        self.step = _counter(step, state[0].device)
        self.graph = None

    def _capture(self):
        t0 = time.perf_counter()
        stream = torch.cuda.Stream(device=self.step.device)
        stream.wait_stream(torch.cuda.current_stream(self.step.device))
        with torch.cuda.stream(stream):
            for _ in range(WARMUP_STEPS):
                self.body(self.step + 1, *(t.clone() for t in self.state))
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=stream):
                step_in_place(self.body, self.step, self.state)
        except RuntimeError as exc:
            raise RuntimeError(
                "capturing the chain step as a CUDA graph failed (a host "
                f"sync inside the step?): {exc}") from exc
        self.graph = graph
        StepGraph.captures += 1
        StepGraph.capture_s += time.perf_counter() - t0

    def replay(self, k: int = 1):
        if k <= 0:
            return
        if self.graph is None:
            self._capture()
        for _ in range(k):
            self.graph.replay()
        StepGraph.replays += k


def reset_counts():
    StepGraph.captures = 0
    StepGraph.replays = 0
    StepGraph.capture_s = 0.0


def stepper(body, state, step: int = 0):
    """A `StepGraph` of `body` for a CUDA state, `EagerSteps` for a CPU one;
    `step` is the Philox step the state was drawn at."""
    if state[0].is_cuda:
        return StepGraph(body, state, step)
    return EagerSteps(body, state, step)


def run_kept(body, state, n_keep: int, thin: int = 1, burn_in: int = 0,
             keep=(0,), step: int = 0):
    """burn_in steps of `body` from `state`, then n_keep times: thin steps
    and one copy of each state[i], i in `keep`, into its preallocated output
    (C, n_keep, ...) for a state tensor (C, ...). Returns (final state,
    outputs)."""
    steps = stepper(body, state, step)
    outs = [torch.empty((state[i].shape[0], n_keep) + state[i].shape[1:],
                        dtype=state[i].dtype, device=state[i].device)
            for i in keep]
    steps.replay(burn_in)
    for t in range(n_keep):
        steps.replay(thin)
        for out, i in zip(outs, keep):
            out[:, t].copy_(steps.state[i])
    return steps.state, outs
