"""Multi-GPU training and serving: the batch over ``--dp`` ranks and the
particle axis over ``--space`` ranks (counterpart of
nonode_tpu/parallel/mesh.py).

The JAX package lays its devices out as a ("data", "space") mesh and lets
XLA shard one program over it. Here every rank is a process of a
``torch.distributed`` group, laid out as the mesh's grid: rank = d * space
+ s. The result is the single-device run's, as in JAX:
- a rank builds each global batch, as one process would, and keeps the rows
  of its data coordinate d (``P("data")``'s contiguous block) and the
  particles [s N / space, (s + 1) N / space) of its space coordinate s;
- the dense [B, N, N, .] tensors hold the rank's receivers i against all N
  senders j (JAX shards the receiver axis and all-gathers the senders): the
  senders' positions and features come through the gather of
  ``Mesh.rows``, whose backward sums the gradient over the space group and
  keeps the rank's rows;
  a mean over the particle axis sums over the space group;
- a rank's loss is its share of the global mean (its sum over the global
  count), so that the losses and the gradients summed over the world are
  the single-device ones: the gradients are summed in one buffer before
  each Adam step; the parameters stay replicated;
- every rank loads the whole split (``replicate_dataset`` has nothing to
  do) and draws the epochs from the driver's seed as one process would.

Backend: ``nccl`` when every rank has a card of its own, ``gloo`` when ranks
share a card (the card's machine has one) or run on the CPU. The tensors
stay on the card either way; gloo takes CUDA tensors for ``all_reduce``,
``broadcast`` and ``all_gather``.

``launch`` starts the ranks (``spawn``), or joins the group that
``torchrun`` made.
"""

from __future__ import annotations

import dataclasses
import multiprocessing.connection
import os
import pickle
import sys
import tempfile
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..ops.dense_graph import ReceiverRows
from ..ops.kernels import KERNELS

# how long a collective waits for a rank that does not come before the
# group gives up (a rank that fails is noticed by ``launch`` at once)
TIMEOUT = timedelta(minutes=10)


@dataclasses.dataclass
class Mesh:
    """The calling rank's place in the (data, space) grid and its groups:
    ``world`` (every rank), ``space`` (the ranks of its data coordinate d,
    which share a batch's graphs) and ``data`` (the ranks of its space
    coordinate s, which share its particles)."""

    dp: int
    space: int
    rank: int
    device: torch.device
    backend: str
    world_group: object
    space_group: object
    data_group: object

    @property
    def world(self) -> int:
        return self.dp * self.space

    @property
    def d(self) -> int:
        return self.rank // self.space

    @property
    def s(self) -> int:
        return self.rank % self.space

    # ---- cutting a global batch ----

    def batch_rows(self, t, dim=0):
        """The data coordinate's contiguous block of ``t``'s batch axis."""
        b = t.shape[dim] // self.dp
        return t.narrow(dim, self.d * b, b)

    def node_rows(self, t, dim):
        """The space coordinate's particles [s n, (s + 1) n) of ``t``'s
        particle axis, n = N / space."""
        n = t.shape[dim] // self.space
        return t.narrow(dim, self.s * n, n)

    def cut(self, t, batch_dim, node_dim=None):
        """``t``'s share of this rank: its batch rows, and its particles
        when ``node_dim`` is given."""
        t = self.batch_rows(t, batch_dim)
        return t if node_dim is None else self.node_rows(t, node_dim)

    # ---- the particle axis ----

    def rows(self, ni: int) -> ReceiverRows | None:
        """The receiver rows of a rank holding ``ni`` particles of each
        graph, None when the particles are not sharded."""
        if self.space == 1:
            return None
        return ReceiverRows(
            i0=self.s * ni, n=ni * self.space,
            gather=lambda t: _GatherSenders.apply(t, self),
            node_sum=lambda t: self.all_reduce(t.clone(), self.space_group))

    def gather_batch(self, t, batch_dim, node_dim):
        """The global tensor of every rank's share ``t``: the particles
        gathered over the space group, then the batch rows over the data
        group, in the single process's order."""
        t = _all_gather(t, node_dim, self.space_group, self.space)
        return _all_gather(t, batch_dim, self.data_group, self.dp)

    # ---- reductions over the world ----

    def all_reduce(self, t, group=None):
        """``t`` summed over ``group`` (the world by default), in place."""
        dist.all_reduce(t, group=self.world_group if group is None else group)
        return t

    def all_reduce_grads(self, params):
        """Sum the gradients of ``params`` over the world in one buffer.
        A parameter with no gradient has none on every rank (one model);
        the step then gives it a zero one (train.loop.zero_missing_grads),
        so that Adam-L2 decays it as optax does."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.all_reduce(flat)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()

    def broadcast_params(self, module):
        """Rank 0's parameters and buffers on every rank, in one buffer."""
        with torch.no_grad():
            tensors = [*module.parameters(), *module.buffers()]
            flat = torch.cat([t.reshape(-1) for t in tensors])
            dist.broadcast(flat, src=0, group=self.world_group)
            off = 0
            for t in tensors:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()

    def barrier(self):
        """Wait for every rank: an all-reduce of one element on the
        group's device (both backends take it)."""
        self.all_reduce(torch.zeros(1, device=self.device))


def _all_gather(t, dim, group, size):
    if size == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


class _GatherSenders(torch.autograd.Function):
    """[..., ni, F] node tensors of the space group's ranks -> the
    [..., N, F] tensor of all senders. Backward: each rank's gradient of the
    gathered tensor (its receivers' dependence on every sender), summed over
    the group, at the rank's rows: an ``all_reduce`` and a slice, which
    both backends take on CUDA tensors (gloo's ``reduce_scatter`` on CUDA
    tensors is untried)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return _all_gather(t, -2, mesh.space_group, mesh.space)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        grad = mesh.all_reduce(grad.contiguous().clone(), mesh.space_group)
        return mesh.node_rows(grad, grad.dim() - 2), None


def make_mesh(dp: int, space: int, rank: int, device: torch.device,
              backend: str) -> Mesh:
    """The mesh of the calling rank in the initialised default group. Every
    rank makes every group, in the same order, as ``new_group`` asks."""
    if dist.get_world_size() != dp * space:
        raise ValueError(f"--dp {dp} x --space {space} needs "
                         f"{dp * space} ranks, the group has "
                         f"{dist.get_world_size()}")
    d, s = divmod(rank, space)
    space_group = data_group = None
    for dd in range(dp):
        g = dist.new_group([dd * space + ss for ss in range(space)])
        if dd == d:
            space_group = g
    for ss in range(space):
        g = dist.new_group([dd * space + ss for dd in range(dp)])
        if ss == s:
            data_group = g
    return Mesh(dp, space, rank, device, backend, dist.group.WORLD,
                space_group, data_group)


def placement(world: int, device: torch.device):
    """(backend, each rank's device): rank r on ``cuda:(r % cards)``,
    ``nccl`` when every rank has a card of its own, ``gloo`` when ranks
    share a card or run on the CPU."""
    if device.type == "cpu":
        return "gloo", [torch.device("cpu")] * world
    cards = torch.cuda.device_count()
    devices = [torch.device("cuda", r % cards) for r in range(world)]
    return ("nccl" if world <= cards else "gloo"), devices


def apply_mesh(exp, mesh: Mesh):
    """Attach the mesh to an experiment (train/loop.py ``_Experiment``):
    its batches are cut to the rank's share, its losses and gradients
    summed over the world; rank 0's weights go to every rank. Call before
    the first epoch. The particle axis is sharded when ``mesh.space > 1``."""
    exp.mesh = mesh
    mesh.broadcast_params(exp.model)
    return exp


def make_sharded_train_step(exp, mesh: Mesh):
    """One Adam-L2 step of ``exp`` on the calling rank's share of a global
    batch: ``step(batch)`` returns the global loss (summed over the world).
    The counterpart of nonode_tpu/parallel/mesh.py:make_sharded_train_step
    (the parameters and Adam's state stay in the experiment)."""
    apply_mesh(exp, mesh)

    def step(batch):
        loss, _ = exp.step(batch)
        return mesh.all_reduce(loss.clone())

    return step


def replicate_dataset(ds, mesh: Mesh):
    """Nothing to do: every rank loads the whole split onto its device, as
    each JAX replica holds it, and cuts its batches from it."""
    return ds


def kernel_launches() -> dict:
    """This process's launch count of every kernel (ops.kernels.KERNELS)."""
    return {k["name"]: k["wrapper"].launches for k in KERNELS}


def _rank_entry(rank, dp, space, device, backend, store_path, fn, args,
                conn):
    """A spawned rank: join the group through the file store, run
    ``fn(mesh, *args)`` and send (status, value, launches) to the parent,
    pickled by value (torch's own reductions would share tensors through
    this process's memory, gone once it exits). Only rank 0 prints."""
    try:
        if rank:
            sys.stdout = open(os.devnull, "w")
        if device.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(device)
        world = dp * space
        dist.init_process_group(backend, rank=rank, world_size=world,
                                store=dist.FileStore(store_path, world),
                                timeout=TIMEOUT)
        try:
            value = fn(make_mesh(dp, space, rank, device, backend), *args)
        finally:
            dist.destroy_process_group()
        conn.send_bytes(pickle.dumps(("ok", value, kernel_launches())))
    except BaseException:
        conn.send_bytes(pickle.dumps(("error", traceback.format_exc(),
                                      None)))
        sys.exit(1)
    finally:
        conn.close()


def launch(fn, args, dp: int, space: int, device: torch.device):
    """Run ``fn(mesh, *args)`` on dp x space ranks and return rank 0's
    value; ``launch.rank_launches`` holds each rank's kernel launches.

    Started by ``torchrun`` (RANK and WORLD_SIZE set), this process is one
    rank of that group and returns its own value. Otherwise the ranks are
    new processes (``spawn``: the caller may have initialised CUDA), meeting
    through a file store in a temporary directory; the first line printed
    says which backend and where each rank runs. A rank that fails stops
    the others and raises here with its traceback."""
    world = dp * space
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        backend, devices = placement(world, device)
        dist.init_process_group(backend, timeout=TIMEOUT)
        dev = devices[rank]
        if rank:
            sys.stdout = open(os.devnull, "w")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        try:
            return fn(make_mesh(dp, space, rank, dev, backend), *args)
        finally:
            dist.destroy_process_group()

    backend, devices = placement(world, device)
    print(f"mesh: data={dp} space={space} backend={backend} ranks on "
          f"{', '.join(f'{r}:{d}' for r, d in enumerate(devices))}",
          flush=True)
    ctx = mp.get_context("spawn")
    procs, conns = [], []
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        try:
            for rank in range(world):
                recv, send = ctx.Pipe(duplex=False)
                p = ctx.Process(target=_rank_entry, args=(
                    rank, dp, space, devices[rank], backend, store, fn, args,
                    send))
                p.start()
                send.close()
                procs.append(p)
                conns.append(recv)
            results = _collect(procs, conns)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
    launch.rank_launches = [launches for _, launches in results]
    return results[0][0]


launch.rank_launches = []


def _collect(procs, conns):
    """Every rank's (value, launches), in rank order; raises as soon as a
    rank reports a failure or exits without reporting."""
    results = [None] * len(procs)
    waiting = dict(enumerate(conns))
    while waiting:
        ready = multiprocessing.connection.wait(
            [*waiting.values(), *(procs[r].sentinel for r in waiting)])
        for r in list(waiting):
            conn = waiting[r]
            if conn not in ready and procs[r].sentinel not in ready:
                continue
            if not conn.poll():
                if procs[r].is_alive():
                    continue
                raise RuntimeError(f"rank {r} exited with code "
                                   f"{procs[r].exitcode} before reporting")
            try:
                status, value, launches = pickle.loads(conn.recv_bytes())
            except EOFError:
                procs[r].join()
                raise RuntimeError(f"rank {r} exited with code "
                                   f"{procs[r].exitcode} before reporting")
            if status != "ok":
                raise RuntimeError(f"rank {r} failed:\n{value}")
            results[r] = (value, launches)
            del waiting[r]
    return results
