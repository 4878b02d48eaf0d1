"""Training and validation steps and rollout windows captured as CUDA
graphs and replayed: the one step runner (``StepGraphs.run``) of the seed
fleet's loop (parallel/fleet.py ``SeedFleet``) and of the per-seed loop and
its rollout (train/loop.py ``_Experiment``).

A step is ``body(*inputs)`` on static inputs: a training step the loss on
the batch of an index buffer with its backward, a validation step the loss,
a rollout window the model's forward on the window's fed-back state. It is
captured once and replayed for every later step that bakes in the same
inputs (its key, ``StepGraphs.key``): one replay, with the inputs copied
into the graph's own buffers, in place of the hundreds of host launches of
the forward (and backward). The first step under a key runs eagerly and
warms up, the second captures, later ones replay. What a step bakes in
beyond its inputs' shapes and the parameters the caller says (an
experiment's ``_window_key``, a rollout's host integers): this layer knows
no model. Adam stays eager after the replay, which leaves the gradients in
the ``.grad`` buffers of the capture; they stay the parameters' gradients
between replays, and each replay overwrites them, as
``zero_grad(set_to_none=True)`` and a fresh backward do. A step whose key
is None runs eagerly and leaves the live graph in place.
"""

from __future__ import annotations

import collections

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


def data_layouts(ds) -> tuple:
    """``layouts`` of a dataset's tensors: what a step that gathers from
    them bakes in."""
    return layouts(t for t in vars(ds).values()
                   if isinstance(t, torch.Tensor))


class StepGraph:
    """A step captured as a CUDA graph: ``body(*inputs)`` on static input
    buffers of the inputs' shapes and dtypes, and its outputs. A replay
    launches the captured kernels in their order. The tensors the capture
    reads besides its inputs (``keep``) live as long as the graph, so that
    no other tensor takes their addresses while the key can match."""

    def __init__(self, key, body, inputs, keep):
        self.key, self.keep = key, keep
        self.inputs = tuple(torch.empty(t.shape, dtype=t.dtype,
                                        device=t.device) for t in inputs)
        self.graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        with torch.cuda.graph(self.graph):
            self.out = body(*self.inputs)
        # the wrappers counted the kernels as they were captured; the
        # replays launch them
        self.launches = [a - b for a, b in zip(_launch_counts(), before)]
        _count_launches(-n for n in self.launches)

    def replay(self, inputs):
        """The step on ``inputs``, copied into the graph's buffers: its
        outputs, copied out of the graph's before the next replay
        overwrites them."""
        for buf, t in zip(self.inputs, inputs):
            buf.copy_(t)
        self.graph.replay()
        _count_launches(self.launches)
        return tuple(o.clone() for o in self.out)


class StepGraphs:
    """A loop's steps: one live graph for each kind of step (``train``,
    ``eval``, ``rollout``), and ``replays``, the steps of each kind that
    replayed one. ``devices``: the device types whose steps are captured
    (empty: every step runs eagerly); ``capture``: how a step is
    captured."""

    devices = ("cuda",)
    capture = StepGraph

    def __init__(self):
        self.graphs = {}       # kind -> its one live graph
        self.seen = {}         # kind -> its last key run without a graph
        self.replays = collections.Counter()

    def key(self, inputs, params, window, *settings):
        """What a step captured on the static ``inputs`` bakes in: their
        shapes and dtypes, the grad mode, ``settings`` (the loop's own: the
        fleet's ``remat``, an experiment's ``compute_dtype``, the layouts
        of the dataset a step gathers from), the storage of every parameter
        in ``params``, and ``window``, what it bakes in of the loop's
        windows or of a rollout window's host integers. None where the step
        runs eagerly: off ``devices``, or on windows that cannot be
        captured (``window`` None)."""
        if window is None or inputs[0].device.type not in self.devices:
            return None
        return (tuple((t.shape, t.dtype) for t in inputs),
                torch.is_grad_enabled(), *settings, layouts(params), window)

    def run(self, kind, key, body, inputs, keep, spans=(),
            replay="step.replay"):
        """``body(*inputs)``, a step of this ``kind`` under ``key``:
        eagerly without a key and on a key's first use, its warm-up; the
        second use captures ``body`` on static copies of ``inputs`` (the
        other tensors it reads, ``keep``) and replays it, and every later
        one replays. A kind keeps one graph: another key frees the old one
        when it is first used, a key of None leaves it in place. A replay
        opens ``spans``, those the eager body opens one after another,
        empty but for ``step.forward``, which holds the replay's span
        ``replay`` (bare where ``spans`` has no forward)."""
        if key is None:
            return body(*inputs)
        graph = self.graphs.get(kind)
        if graph is not None and graph.key != key:
            del self.graphs[kind]
            graph = None
        if graph is None:
            if self.seen.get(kind) != key:
                self.seen[kind] = key
                return body(*inputs)
            graph = self.graphs[kind] = self.capture(key, body, inputs, keep)
        self.replays[kind] += 1
        if "step.forward" not in spans:
            return self.replay(graph, inputs, replay)
        for name in spans:
            with span(name):
                if name == "step.forward":
                    out = self.replay(graph, inputs, replay)
        return out

    def replay(self, graph, inputs, name):
        """``graph``'s step on ``inputs``, in the span ``name``."""
        with span(name):
            return graph.replay(inputs)
