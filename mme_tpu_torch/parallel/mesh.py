"""A mesh of ranks: named axes, one process group per axis, and the
collectives the parallel axes use.

Port of ``mme_tpu/parallel/mesh.py``. JAX's ``Mesh`` is a grid of devices
inside one program, and XLA inserts the collectives a sharding implies. The
port's :class:`Mesh` is a grid of ranks (``parallel/distributed.py``): rank
``r`` sits at the row-major coordinates of ``r`` in the mesh's shape, as a
device sits in ``np.asarray(devices).reshape(shape)``, and each axis holds
one process group per line of ranks along it (:class:`AxisGroup`). The
collectives are explicit:

- :meth:`AxisGroup.all_reduce`, :meth:`AxisGroup.all_gather`,
  :meth:`AxisGroup.broadcast_`, :meth:`AxisGroup.all_to_all` (block j of
  dim 0 to coordinate j: the expert exchange) and
  :meth:`AxisGroup.shift_start` (send to the next coordinate, receive from
  the previous one: the ring's P2P step, ``dist.batch_isend_irecv``), and
  :meth:`AxisGroup.send_start` / :meth:`AxisGroup.recv_start` (one message
  between two coordinates: a pipeline stage's step, :class:`Transfer`).
- Under the ``gloo`` backend every collective moves host tensors: a CUDA
  tensor is staged through pinned host memory (the ``_gloo_host`` branch).
  ``nccl`` takes device tensors as they are. The branch follows the group's
  backend; nothing is chosen by catching an error.
- Autograd: :func:`all_reduce_sum` (the backward all-reduces the gradient),
  Megatron's pair for tensor parallelism, :func:`copy_to_axis` (identity
  forward, all-reduced gradient) and :func:`reduce_from_axis` (all-reduced
  forward, identity backward), :func:`all_to_all` (its own transpose),
  :func:`seq_shard` (this rank's block of a replicated sequence; the
  backward gathers the blocks' gradients in full) and :func:`seq_gather`
  (the whole sequence from the blocks; the backward keeps this rank's
  slice, because every rank of the axis holds the same gradient).

The batch axis. JAX's one jitted step over a dp-sharded batch computes
every batch-wide quantity (a loss's sums, BatchNorm's statistics, the MoE
router's token fractions) over the global batch. The port's steps enter
:func:`batch_reduction` with the mesh's ``dp`` axis; inside it,
:func:`batch_sum` all-reduces a partial sum differentiably and
:func:`batch_rand` draws the global batch's random numbers and keeps this
rank's rows, so dropout and the augmentations draw what one process holding
the whole batch draws. Outside it both are the identity of one process.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from mme_tpu_torch.device import DeviceLike
from mme_tpu_torch.parallel import distributed


class AxisGroup:
    """This rank's line of ranks along one mesh axis: ``size`` ranks,
    ``ranks`` (global ranks in coordinate order), ``index`` (this rank's
    coordinate) and the process group (None for an axis of size 1)."""

    def __init__(self, name: str, ranks: Sequence[int], index: int,
                 group: Any):
        self.name = name
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.index = index
        self.group = group
        self.backend = (dist.get_backend(group) if group is not None
                        else None)
        # gloo moves host tensors only: CUDA tensors go through pinned
        # host memory
        self.host_staged = self.backend == "gloo"

    @property
    def next_rank(self) -> int:
        return self.ranks[(self.index + 1) % self.size]

    @property
    def prev_rank(self) -> int:
        return self.ranks[(self.index - 1) % self.size]

    def transport(self, t: torch.Tensor) -> str:
        """The transport a collective on ``t`` takes: ``gloo-host`` (a
        CUDA tensor staged through pinned host memory), ``gloo`` (a host
        tensor) or ``nccl``."""
        if self.backend == "gloo":
            return "gloo-host" if t.is_cuda else "gloo"
        return str(self.backend)

    # ---- the gloo branch: host copies of device tensors ----

    @staticmethod
    def _gloo_host(t: torch.Tensor) -> torch.Tensor:
        if not t.is_cuda:
            return t.contiguous()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        if self.host_staged:
            return self._gloo_host(t)
        if self.backend == "nccl" and not t.is_cuda:
            # nccl moves device tensors only (the loop's host scalars)
            return t.to(torch.cuda.current_device())
        return t.contiguous()

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the axis, as a new tensor on ``t``'s device."""
        if self.size == 1:
            return t.clone()
        w = self._wire(t)
        if w.data_ptr() == t.data_ptr():
            w = w.clone()        # the sum lands in w, never in t
        # gloo sums bf16 / fp16 in fp32 on the host
        wide = self.host_staged and w.dtype in (torch.bfloat16,
                                                torch.float16)
        if wide:
            w = w.float()
        dist.all_reduce(w, group=self.group)
        return w.to(device=t.device, dtype=t.dtype)

    def all_reduce_many(self, tensors: Sequence[torch.Tensor]
                        ) -> List[torch.Tensor]:
        """:meth:`all_reduce` of many tensors, one collective per dtype
        over their flattened concatenation."""
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = self.all_reduce(torch.cat(
                [tensors[i].reshape(-1) for i in idx]))
            for i, part in zip(idx, torch.split(
                    flat, [tensors[i].numel() for i in idx])):
                out[i] = part.view(tensors[i].shape)
        return out

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The axis' tensors concatenated along ``dim`` in coordinate
        order (every rank's ``t`` has the same shape)."""
        if self.size == 1:
            return t
        w = self._wire(t)
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w, group=self.group)
        return torch.cat(parts, dim=dim).to(t.device)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Block j of ``t``'s dim 0 (``size`` equal blocks) goes to
        coordinate j; block i of the result came from coordinate i."""
        if self.size == 1:
            return t
        w = self._wire(t)
        out = torch.empty_like(w)
        dist.all_to_all_single(out, w, group=self.group)
        return out.to(t.device)

    def broadcast_(self, t: torch.Tensor, src_index: int = 0) -> None:
        """Overwrite ``t`` with coordinate ``src_index``'s tensor."""
        if self.size == 1:
            return
        w = self._wire(t)
        dist.broadcast(w, src=self.ranks[src_index], group=self.group)
        if w.data_ptr() != t.data_ptr():
            t.copy_(w)

    def shift_start(self, tensors: Sequence[torch.Tensor],
                    backward: bool = False) -> "Shift":
        """Start sending ``tensors`` to the next coordinate and receiving
        the previous one's (``backward``: to the previous, from the next).
        :meth:`Shift.wait` returns the received tensors on the senders'
        devices."""
        return Shift(self, tensors, backward)

    def send_start(self, t: torch.Tensor, to_index: int) -> "Transfer":
        """Start sending ``t`` to coordinate ``to_index`` alone (a
        pipeline stage's activation or gradient; ``t`` may be reused at
        once, its wire copy stays alive until :meth:`Transfer.wait`)."""
        return Transfer(self, t, to_index, send=True)

    def recv_start(self, like: torch.Tensor, from_index: int) -> "Transfer":
        """Start receiving a tensor of ``like``'s shape and dtype from
        coordinate ``from_index``; :meth:`Transfer.wait` returns it on
        ``like``'s device."""
        return Transfer(self, like, from_index, send=False)


class Shift:
    """One P2P ring step in flight (``dist.batch_isend_irecv``)."""

    def __init__(self, axis: AxisGroup, tensors: Sequence[torch.Tensor],
                 backward: bool):
        self.devices = [t.device for t in tensors]
        self.axis = axis
        if axis.size == 1:
            self.recv, self.reqs = list(tensors), []
            return
        dst, src = ((axis.prev_rank, axis.next_rank) if backward
                    else (axis.next_rank, axis.prev_rank))
        send = [axis._wire(t) for t in tensors]
        self.recv = [torch.empty_like(t) for t in send]
        ops = ([dist.P2POp(dist.isend, t, dst, group=axis.group)
                for t in send]
               + [dist.P2POp(dist.irecv, t, src, group=axis.group)
                  for t in self.recv])
        self._send = send          # alive until the sends complete
        self.reqs = dist.batch_isend_irecv(ops)

    def wait(self) -> List[torch.Tensor]:
        for r in self.reqs:
            r.wait()
        return [t.to(d, non_blocking=False)
                for t, d in zip(self.recv, self.devices)]


class Transfer:
    """One point-to-point message in flight between two coordinates of an
    axis (``dist.isend`` / ``dist.irecv``): the pipeline's stage-to-stage
    step. Under gloo a CUDA tensor travels through pinned host memory, as
    every collective of :class:`AxisGroup` does."""

    def __init__(self, axis: AxisGroup, t: torch.Tensor, peer_index: int,
                 send: bool):
        self.device = t.device
        peer = axis.ranks[peer_index]
        if send:
            self.buf = axis._wire(t)       # alive until the send completes
            self.req = dist.isend(self.buf, peer, group=axis.group)
        else:
            if axis.host_staged:
                self.buf = torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=t.is_cuda)
            else:
                # nccl receives into device memory only
                self.buf = torch.empty(
                    t.shape, dtype=t.dtype,
                    device=t.device if t.is_cuda
                    else torch.cuda.current_device())
            self.req = dist.irecv(self.buf, peer, group=axis.group)
        self.send = send

    def wait(self) -> Optional[torch.Tensor]:
        """Wait for the message; a receive returns the tensor on the
        device of the tensor it was shaped like."""
        self.req.wait()
        if self.send:
            self.buf = None
            return None
        return self.buf.to(self.device)


class Mesh:
    """A grid of ranks with named axes (row-major: the last axis varies
    fastest), the counterpart of ``jax.sharding.Mesh``. ``shape`` maps
    each axis name to its size; :meth:`axis` gives this rank's
    :class:`AxisGroup` along it."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int]):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.size = int(np.prod(list(self.shape.values())))
        world = distributed.world_size()
        if self.size != world:
            raise ValueError(f"mesh {self.shape} holds {self.size} ranks; "
                             f"the world has {world}")
        me = distributed.rank()
        grid = np.arange(self.size).reshape(tuple(self.shape.values()))
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.argwhere(grid == me)[0])))
        self._axes: Dict[str, AxisGroup] = {}
        for a, name in enumerate(self.axis_names):
            lines = np.moveaxis(grid, a, -1).reshape(-1, grid.shape[a])
            mine = None
            for line in lines:
                ranks = [int(r) for r in line]
                if len(ranks) == 1:
                    group = None
                elif len(ranks) == world:
                    group = dist.group.WORLD
                else:
                    # every rank creates every group, in the same order
                    group = dist.new_group(ranks)
                if me in ranks:
                    mine = AxisGroup(name, ranks, ranks.index(me), group)
            self._axes[name] = mine

    @property
    def world(self) -> AxisGroup:
        """Every rank of the mesh, as one group."""
        return AxisGroup("world", list(range(self.size)), distributed.rank(),
                         dist.group.WORLD if self.size > 1 else None)

    def axis(self, name: str) -> AxisGroup:
        if name not in self._axes:
            raise KeyError(f"mesh has no axis {name!r}: {self.axis_names}")
        return self._axes[name]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords})"


def make_mesh(data: int = -1, model: int = 1,
              axis_names: Sequence[str] = ("dp", "mp")) -> Mesh:
    """A (data, model) mesh over the world's ranks; ``data=-1`` takes the
    ranks ``model`` leaves."""
    n = distributed.world_size()
    if data == -1:
        if n % model:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    return Mesh(axis_names, (data, model))


def _rows(x: Any, axis: AxisGroup) -> Any:
    per = x.shape[0] // axis.size
    if per * axis.size != x.shape[0]:
        raise ValueError(f"{x.shape[0]} rows do not split over "
                         f"{axis.name}={axis.size}")
    return x[axis.index * per:(axis.index + 1) * per]


def shard_batch(batch: Dict[str, Any], mesh: Mesh,
                axis: str = "dp") -> Dict[str, Any]:
    """This rank's contiguous rows of every array (numpy or tensor) of a
    global batch along ``axis``."""
    ax = mesh.axis(axis)
    return {k: _rows(v, ax) for k, v in batch.items()}


def replicate(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Overwrite every parameter and buffer of ``module`` with rank 0's,
    on every rank of the mesh (one broadcast per dtype)."""
    if mesh.size == 1:
        return module
    world = mesh.world
    tensors = [t.data for t in itertools.chain(module.parameters(),
                                               module.buffers())]
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            world.broadcast_(flat)
            for t, part in zip(group, torch.split(
                    flat, [t.numel() for t in group])):
                t.copy_(part.view(t.shape))
    return module


def barrier() -> None:
    """Every rank waits for the others (no-op on one process)."""
    if distributed.is_initialized():
        dist.barrier()


def agree(value: float, mesh: Optional[Mesh]) -> float:
    """Rank 0's ``value`` on every rank of ``mesh`` (itself without one):
    what a branch of the loop reads, so that every rank takes it."""
    if mesh is None or mesh.size == 1:
        return value
    t = torch.tensor([float(value)], dtype=torch.float64)
    mesh.world.broadcast_(t)
    return float(t.item())


# ---------------------------- autograd ----------------------------

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g), None


def all_reduce_sum(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """Σ over the axis, differentiable: the backward all-reduces the
    gradient. With every rank back-propagating the same replicated loss,
    the ranks' parameter gradients then sum to ``size`` times the global
    one, so the step averages them."""
    if axis.size == 1:
        return x
    return _AllReduceSum.apply(x, axis)


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g), None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_axis(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """Megatron's "copy to mp": ``x`` (the same on every rank of ``axis``)
    as it is, entering a column-parallel layer. The backward all-reduces
    the gradient, since each rank's holds only its shard's part."""
    return x if axis.size == 1 else _CopyToAxis.apply(x, axis)


def reduce_from_axis(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """Megatron's "reduce from mp": the sum over ``axis`` of a
    row-parallel layer's partial outputs. The backward passes the
    (replicated) gradient to every rank's part unchanged."""
    return x if axis.size == 1 else _ReduceFromAxis.apply(x, axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_to_all(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_to_all(g.contiguous()), None


def all_to_all(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """:meth:`AxisGroup.all_to_all`, differentiable: an exchange of equal
    blocks is its own transpose, so the backward sends the gradients'
    blocks back the same way."""
    return x if axis.size == 1 else _AllToAll.apply(x, axis)


class _SeqShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        n = x.shape[dim] // axis.size
        return x.narrow(dim, axis.index * n, n)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_gather(g.contiguous(), ctx.dim), None, None


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.all_gather(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.axis.size
        return g.narrow(ctx.dim, ctx.axis.index * n, n), None, None


def seq_shard(x: torch.Tensor, axis: AxisGroup, dim: int = 1
              ) -> torch.Tensor:
    """This rank's block of a sequence every rank of ``axis`` holds whole
    (``x.shape[dim]`` divides by the axis size). The gradient comes back
    whole on every rank: the blocks' gradients are gathered."""
    return x if axis.size == 1 else _SeqShard.apply(x, axis, dim)


def seq_gather(x: torch.Tensor, axis: AxisGroup, dim: int = 1
               ) -> torch.Tensor:
    """The whole sequence from every rank's block. The backward keeps
    this rank's slice of the (replicated) gradient: summing the ranks'
    identical gradients would make it ``size`` times too large."""
    return x if axis.size == 1 else _SeqGather.apply(x, axis, dim)


# ---------------------------- the batch axis ----------------------------

# the batch axis of the step in progress. Process-wide, not per thread:
# autograd runs a CUDA backward on its own threads, and a rematerialised
# block (``EncoderSpec.remat``) recomputes its forward there, where its
# dropout must draw the global batch's numbers again
_STEP = {"axis": None}


@contextlib.contextmanager
def batch_reduction(axis: Optional[AxisGroup]) -> Iterator[None]:
    """Inside, :func:`batch_sum` and :func:`batch_rand` act over ``axis``
    (None or an axis of size 1: one process)."""
    prev = _STEP["axis"]
    _STEP["axis"] = axis if axis is not None and axis.size > 1 else None
    try:
        yield
    finally:
        _STEP["axis"] = prev


def batch_axis() -> Optional[AxisGroup]:
    """The axis :func:`batch_reduction` set, or None."""
    return _STEP["axis"]


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """A per-rank partial sum over batch rows → the global batch's sum,
    differentiably; the identity outside :func:`batch_reduction`."""
    axis = batch_axis()
    return x if axis is None else all_reduce_sum(x, axis)


def batch_count(n: int) -> int:
    """Rows of the global batch when every rank holds ``n``."""
    axis = batch_axis()
    return n if axis is None else n * axis.size


def batch_rand(shape: Sequence[int], generator: Optional[torch.Generator],
               device: DeviceLike, batch_dim: int = 0) -> torch.Tensor:
    """``torch.rand(shape)`` whose ``batch_dim`` holds this rank's rows of
    the global batch: under :func:`batch_reduction` the global batch's
    numbers are drawn (the same generator on every rank) and this rank's
    rows kept, so a dp run draws what one process does."""
    axis = batch_axis()
    if axis is None:
        return torch.rand(tuple(shape), generator=generator, device=device)
    full = list(shape)
    n = full[batch_dim]
    full[batch_dim] = n * axis.size
    u = torch.rand(tuple(full), generator=generator, device=device)
    return u.narrow(batch_dim, axis.index * n, n)
