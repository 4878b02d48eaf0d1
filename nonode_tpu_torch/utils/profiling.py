"""Spans and phase timing (the port's counterpart of
nonode_tpu/utils/profiling.py).

- ``span(name)``: the program's named range ``nonode:<name>`` on
  torch.profiler's timeline while a profiler records, so that it shares
  the clock of the device trace; otherwise one shared null context, so
  that a span left in the program costs a check and nothing else. The
  profiler keeps the spans with its other events.
- ``PhaseTimer``: wall-clock phase accounting (data load / train / eval /
  rollout breakdown per run), each window closed on the device.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

import torch

PREFIX = "nonode:"
_OFF = contextlib.nullcontext()
# A range that enters the profiler's record directly: ``record_function``
# goes through two dispatcher ops and costs the traced host about ten
# times as much a span.
_RANGE = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """The range ``nonode:<name>`` while a profiler records, else a null
    context (nothing allocated, nothing entered)."""
    if torch.autograd._profiler_enabled():
        return _RANGE(PREFIX + name)
    return _OFF


def _cuda_devices(tree, found: set) -> set:
    """The CUDA devices of the tensors in ``tree`` (a tensor, or a list,
    tuple or dict of them, nested)."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    return found


class PhaseTimer:
    """Accumulates wall-clock per named phase; waits for the device work
    behind ``block_on`` so that the numbers mean what they say."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Time the body as ``name``. ``block_on`` is read when the body
        ends, so a list that the body fills works: every CUDA device that a
        tensor in it lives on is synchronized before the clock stops; CPU
        tensors need no wait."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for device in _cuda_devices(block_on, set()):
                torch.cuda.synchronize(device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {name: {"total_s": round(self.totals[name], 4),
                       "count": self.counts[name],
                       "mean_s": round(self.totals[name] / self.counts[name], 6)}
                for name in self.totals}

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)
