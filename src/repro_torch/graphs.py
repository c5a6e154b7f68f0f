"""One step of a loop, replayed from a CUDA graph.

The reference compiles its loops whole (``lax.scan`` under ``jax.jit``):
``serve.engine.greedy_generate``'s decode loop and ``core.device``'s
Euler time loops.  The port runs such a loop as a Python loop over one
zero-argument step that reads and writes only static device buffers; on
the card the step is captured into one CUDA graph and replayed, so a
step costs one graph launch instead of one launch per op.

``GraphStep`` holds the step.  With ``capture`` its first call runs the
step eagerly (the warm-up: kernels built, workspaces allocated, the
result used), the second captures it into one CUDA graph and replays it
for its result, and every later call replays the graph.  Without
``capture`` every call runs the same step eagerly; that is the CPU's
path and, on the card, the witness the captured loop is held against.
A failed capture raises: there is no eager fallback.
"""
from __future__ import annotations

import contextlib
from typing import Callable, ContextManager, Dict, Optional

import torch

from repro_torch.kernels import launch_counts


def resolve_capture(capture: Optional[bool], device: torch.device) -> bool:
    """``None``: capture on a CUDA device, run eagerly elsewhere;
    ``True`` on a device that is not CUDA raises (a CUDA graph has no CPU
    mode); ``False``: eager."""
    if capture is None:
        return device.type == "cuda"
    if capture and device.type != "cuda":
        raise RuntimeError(
            f"capture=True needs a CUDA device (a CUDA graph has no CPU "
            f"mode), not {device}; pass capture=False or None")
    return bool(capture)


class GraphStep:
    """A step (no arguments, static buffers only) run eagerly or replayed
    from one CUDA graph; :meth:`run` runs it once.

    The step is ``body``, or a subclass's :meth:`body`.  ``scope`` (or a
    subclass's :meth:`scope`) makes the context entered around every
    eager run and around the capture: Python state the step reads (no
    autograd, the crossbar executor's activation) is set there, on the
    host, never inside the graph.  ``pool`` is the memory pool the
    capture allocates from (``None``: a private one, released with the
    graph).  ``stats`` counts captures, replays and eager steps over the
    object's life; ``launches_per_replay`` holds the kernel launches the
    capture recorded (``kernels.launch_counts`` before and after), which
    every replay runs again without counting them.

    A graph must be released at a known point, never by the cyclic
    garbage collector: a graph destroyed while another capture is open
    invalidates that capture.  So the step holds no reference back to
    its owner (a subclass overrides the methods instead), and a loop
    calls :meth:`reset` before it returns.
    """

    def __init__(self, capture: bool,
                 body: Optional[Callable[[], None]] = None,
                 scope: Optional[Callable[[], ContextManager]] = None,
                 pool=None):
        self.capture, self.pool = capture, pool
        self._body_fn, self._scope_fn = body, scope
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._warm = False
        self.stats = {"captures": 0, "replays": 0, "eager_steps": 0}
        self.launches_per_replay: Dict[str, int] = {}

    def body(self) -> None:
        self._body_fn()

    def scope(self) -> ContextManager:
        if self._scope_fn is None:
            return contextlib.nullcontext()
        return self._scope_fn()

    def run(self) -> None:
        """The step once: replayed, captured (the second run), or eager
        (the warm-up, or every run without ``capture``)."""
        if self.graph is not None:
            self.graph.replay()
            self.stats["replays"] += 1
        elif self.capture and self._warm:
            self._capture()
        else:
            with self.scope():
                self.body()
            self.stats["eager_steps"] += 1
            self._warm = True

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with self.scope(), torch.cuda.graph(graph, pool=self.pool):
            self.body()
        self.launches_per_replay = {
            k: n - before.get(k, 0) for k, n in launch_counts().items()
            if n != before.get(k, 0)}
        self.graph = graph
        self.stats["captures"] += 1
        graph.replay()             # the capture recorded; this step runs
        self.stats["replays"] += 1

    def reset(self) -> None:
        """Drop the graph (releasing its memory to the pool); the next
        run is eager, a new warm-up, and the one after captures anew."""
        if self.graph is not None:
            self.graph.reset()
        self.graph, self._warm = None, False

    def report(self) -> Dict[str, object]:
        """The stats with the launches one replay runs."""
        return dict(self.stats,
                    launches_per_replay=dict(self.launches_per_replay))
