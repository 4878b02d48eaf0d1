"""Training and validation steps captured as CUDA graphs and replayed: the
one step runner (``StepGraphs.run``) of the seed fleet's loop
(parallel/fleet.py ``SeedFleet``) and of the per-seed loop (train/loop.py
``_Experiment``).

A step is ``body(idx)``: the loss on the batch of the index buffer
``idx``, in training with its backward. It is captured once and replayed
for every later step that bakes in the same inputs (its key,
``StepGraphs.key``): one replay in place of the hundreds of host launches
of the forward and backward. The first step under a key runs eagerly and
warms up, the second captures, later ones replay. What a step bakes in of
the loop's windows the experiment says (its ``_window_key``): this layer
knows no model. Adam stays eager after the replay, which leaves the
gradients in the ``.grad`` buffers of the capture; they stay the
parameters' gradients between replays, and each replay overwrites them, as
``zero_grad(set_to_none=True)`` and a fresh backward do. A step whose key
is None runs eagerly.
"""

from __future__ import annotations

import torch

from ..ops.kernels import KERNELS
from ..utils.profiling import span

# the wrappers' launch counters: every kernel's ``launches``, and the
# ``tile_launches`` of those that have a tile route
_COUNTERS = [(k["wrapper"], name) for k in KERNELS
             for name in ("launches", "tile_launches")
             if hasattr(k["wrapper"], name)]


def _launch_counts() -> list[int]:
    return [getattr(w, name) for w, name in _COUNTERS]


def _count_launches(counts) -> None:
    for (w, name), n in zip(_COUNTERS, counts):
        setattr(w, name, getattr(w, name) + n)


def layouts(tensors) -> tuple:
    """What a graph reads of ``tensors``: each one's address and shape."""
    return tuple((t.data_ptr(), t.shape) for t in tensors)


class StepGraph:
    """A step captured as a CUDA graph: ``body(idx)`` on a static index
    buffer, and its outputs. A replay launches the captured kernels in
    their order. The tensors the capture reads (``keep``) live as long as
    the graph, so that no other tensor takes their addresses while the key
    can match."""

    def __init__(self, key, body, idx, keep):
        self.key, self.keep = key, keep
        self.idx = torch.empty(idx.shape, dtype=idx.dtype, device=idx.device)
        self.graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        with torch.cuda.graph(self.graph):
            self.out = body(self.idx)
        # the wrappers counted the kernels as they were captured; the
        # replays launch them
        self.launches = [a - b for a, b in zip(_launch_counts(), before)]
        _count_launches(-n for n in self.launches)

    def replay(self, idx):
        """The step on the batch ``idx``: its outputs, copied out of the
        graph's before the next replay overwrites them."""
        self.idx.copy_(idx)
        self.graph.replay()
        _count_launches(self.launches)
        return tuple(o.clone() for o in self.out)


class StepGraphs:
    """A loop's steps: one live graph for each kind of step (``train``,
    ``eval``), and ``replays``, the steps that replayed one. ``devices``:
    the device types whose steps are captured (empty: every step runs
    eagerly); ``capture``: how a step is captured."""

    devices = ("cuda",)
    capture = StepGraph

    def __init__(self):
        self.graphs = {}       # kind -> its one live graph
        self.seen = {}         # kind -> its last key run without a graph
        self.replays = 0

    def key(self, idx, params, ds, window, *settings):
        """What a captured step on the index buffer ``idx`` bakes in: the
        index shape, the grad mode, ``settings`` (the loop's own: the
        fleet's ``remat``, an experiment's ``compute_dtype``), the storage
        of every parameter in ``params`` and of the dataset's tensors, and
        ``window``, what it bakes in of the windows. None where the step
        runs eagerly: off ``devices``, or on windows that cannot be
        captured (``window`` None)."""
        if window is None or idx.device.type not in self.devices:
            return None
        data = [t for t in vars(ds).values() if isinstance(t, torch.Tensor)]
        return (tuple(idx.shape), torch.is_grad_enabled(), *settings,
                layouts(params), layouts(data), window)

    def run(self, kind, key, body, idx, keep, spans=()):
        """``body(idx)``, a step of this ``kind`` under ``key``: eagerly
        without a key and on a key's first use, its warm-up; the second
        use captures ``body`` on ``idx`` (the tensors it reads, ``keep``)
        and replays it, and every later one replays. A kind keeps one
        graph: another key frees the old one. A replay opens ``spans``,
        those the eager body opens one after another, empty but for
        ``step.forward``, which holds the replay's ``step.replay`` (bare
        where ``spans`` has no forward)."""
        graph = self.graphs.get(kind)
        if graph is not None and graph.key != key:
            del self.graphs[kind]
            graph = None
        if graph is None and key is not None:
            if self.seen.get(kind) == key:
                graph = self.graphs[kind] = self.capture(key, body, idx, keep)
            self.seen[kind] = key
        if graph is None:
            return body(idx)
        if "step.forward" not in spans:
            return self.replay(graph, idx)
        for name in spans:
            with span(name):
                if name == "step.forward":
                    out = self.replay(graph, idx)
        return out

    def replay(self, graph, idx):
        """``graph``'s step on the batch ``idx``, counted."""
        with span("step.replay"):
            self.replays += 1
            return graph.replay(idx)
