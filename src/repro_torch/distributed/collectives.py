"""Explicit collective patterns on ``torch.distributed``.

``ring_all_gather`` is the overlap-friendly building block: each of the
N-1 steps moves one shard to the ring neighbor by one send and one
receive, so a consumer that needs the gathered tensor shard-by-shard
(e.g. a TP matmul against a weight panel) can overlap compute with the
next hop — the schedule the §Perf collective analysis assumes for the TP
psums.

``reduce_scatter_then_gather`` decomposes an all-reduce into its two
phases explicitly (what GSPMD does internally for ZeRO); useful when the
intermediate (scattered) value is what you actually want to keep.

``all_reduce`` sums in the tensor's dtype, in whatever order the
backend takes, and ``broadcast`` hands every rank of a group its first
rank's tensor.  ``psum`` is the reference's ``jax.lax.psum`` of the
model's partial results (the tensor-parallel blocks, the vocabulary
lookup, the Mixture-of-Experts layer): the partials gathered around the
ring, summed in fp32 in group-rank order and rounded once to their
dtype (``sum_in_order``), so every rank holds the same bits, and one
process that adds the ranks' partials in that order holds them too.
Under autograd its backward is the identity, and ``replicated`` is its
dual (the identity forward, ``psum`` of the gradient backward): the two
ends of a cut product in training.

The reference resolves an axis name inside ``shard_map``; here a function
takes the mesh (``launch.mesh.Mesh``) and the axis name, or a process
group, as keywords, and runs eagerly in each rank on its local shard.

How a tensor travels depends on the group's backend.  With ``nccl`` a
CUDA tensor goes as it is.  With ``gloo``, which moves host memory only, a
CUDA tensor is copied into pinned host memory, sent, and the result
copied back onto the tensor's device; a CPU tensor goes as it is.  No
tensor changes device.  ``HopStats`` counts what the hops moved and
splits their time between the host copies and the transfers; a call
counts into its ``stats``, or, given none, into those of ``counting``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch
import torch.distributed as dist


@dataclasses.dataclass
class HopStats:
    """What a caller's hops moved: point-to-point sends and collectives
    (each collective one hop of its tensor's bytes), the bytes they
    carried, and host seconds spent copying between the device and pinned
    host memory (each copy timed after a device synchronise) apart from
    the seconds in the transfers."""
    hops: int = 0
    bytes: int = 0
    host_copy_seconds: float = 0.0
    transfer_seconds: float = 0.0


#: where a call given no ``stats`` counts its hops (``counting``).  Held
#: by the process, not the thread: autograd may run a backward on a
#: thread of its own.
_COUNTING = {"sums": None, "gathers": None}


@contextlib.contextmanager
def counting(sums: HopStats, gathers: HopStats = None):
    """Within the block, the hops of every ``psum`` and ``replicated``
    (the sums over a model axis, their backward passes included) given no
    ``stats`` count into ``sums``, and those of every other
    ``ring_all_gather`` given none into ``gathers``."""
    before = dict(_COUNTING)
    _COUNTING.update(sums=sums, gathers=gathers)
    try:
        yield
    finally:
        _COUNTING.update(before)


class Wire:
    """How tensors like ``like`` travel on ``group``: on the device with
    ``nccl``; through pinned host memory with ``gloo`` when ``like`` is
    on a GPU."""

    def __init__(self, group, like: torch.Tensor, stats: HopStats = None):
        self.group = group
        self.device = like.device
        self.staged = like.is_cuda and dist.get_backend(group) != "nccl"
        self.stats = stats

    def _timed(self, field: str, fn, *args):
        if self.stats is None:
            return fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn(*args)
        setattr(self.stats, field,
                getattr(self.stats, field) + time.perf_counter() - t0)
        return out

    def empty(self, shape, dtype) -> torch.Tensor:
        """A buffer that can travel."""
        if self.staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as it travels (a pinned host copy, or ``t`` itself)."""
        if not self.staged:
            return t.contiguous()
        host = self.empty(t.shape, t.dtype)
        self._timed("host_copy_seconds", host.copy_, t)
        return host

    def back(self, w: torch.Tensor) -> torch.Tensor:
        """A tensor that travelled, on the caller's device again."""
        if not self.staged:
            return w
        return self._timed("host_copy_seconds", w.to, self.device)

    def place(self, dst: torch.Tensor, w: torch.Tensor) -> None:
        """Copy the travelled ``w`` into ``dst`` on the caller's device."""
        if not self.staged:
            dst.copy_(w)
        else:
            self._timed("host_copy_seconds", dst.copy_, w)

    def exchange(self, send: torch.Tensor, dst: int, recv: torch.Tensor,
                 src: int) -> None:
        """Send ``send`` to global rank ``dst`` while ``recv`` is filled
        from global rank ``src`` (travelling tensors)."""
        self.wait(self.post([dist.P2POp(dist.isend, send, dst, self.group),
                             dist.P2POp(dist.irecv, recv, src, self.group)],
                            sent=send))

    def post(self, ops, sent: torch.Tensor = None) -> list:
        """Post ``ops`` as one batch; ``sent`` is the tensor a send among
        them carries (counted as one hop)."""
        if self.stats is not None and sent is not None:
            self.stats.hops += 1
            self.stats.bytes += sent.numel() * sent.element_size()
        return dist.batch_isend_irecv(ops)

    def collective(self, op, w: torch.Tensor, **kwargs) -> None:
        """Run ``op`` (``dist.all_reduce``, ``dist.broadcast``) on the
        travelling ``w`` in place, counted as one hop of its bytes."""
        if self.stats is not None:
            self.stats.hops += 1
            self.stats.bytes += w.numel() * w.element_size()
        self.wait([op(w, group=self.group, async_op=True, **kwargs)])

    def wait(self, works: list) -> None:
        def run():
            for work in works:
                work.wait()
        self._timed("transfer_seconds", run)


def global_rank(group, group_rank: int) -> int:
    """The world rank of ``group``'s rank ``group_rank``."""
    if group is None or group is dist.GroupMember.WORLD:
        return group_rank
    return dist.get_global_rank(group, group_rank)


def resolve_group(axis_name, mesh, group):
    """The process group a collective runs on: ``group`` if given, else
    this rank's group along ``mesh``'s axis ``axis_name``."""
    if group is None:
        if mesh is None:
            raise TypeError("pass mesh= (with the axis name) or group=")
        group = mesh.group(axis_name)
    if dist.get_rank(group) < 0:
        raise ValueError("this rank is not in the collective's group")
    return group


def ring_all_gather(x: torch.Tensor, axis_name: str = None, *, mesh=None,
                    group=None, stats: HopStats = None) -> torch.Tensor:
    """Gather every rank's shard ``x`` (chunk, ...) over the group with
    N-1 sends to the ring neighbor.  Returns (N*chunk, ...), shard ``i``
    from group rank ``i`` — bitwise equal to ``all_gather_into_tensor``."""
    group = resolve_group(axis_name, mesh, group)
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    dst = global_rank(group, (idx + 1) % n)
    src = global_rank(group, (idx - 1) % n)
    wire = Wire(group, x, _COUNTING["gathers"] if stats is None else stats)
    cur = wire.out(x)
    pieces = [cur]
    for _ in range(n - 1):
        nxt = wire.empty(cur.shape, cur.dtype)
        wire.exchange(cur, dst, nxt, src)
        pieces.append(nxt)
        cur = nxt
    # piece j arrived from group rank (idx - j) mod n; put it in its rows
    chunk = x.shape[0]
    out = torch.empty((n * chunk,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    for j, piece in enumerate(pieces):
        owner = (idx - j) % n
        wire.place(out[owner * chunk:(owner + 1) * chunk], piece)
    return out


def reduce_scatter_then_gather(x: torch.Tensor, axis_name: str = None, *,
                               mesh=None, group=None) -> torch.Tensor:
    """all_reduce(x) == all_gather(reduce_scatter(x)); explicit phases."""
    group = resolve_group(axis_name, mesh, group)
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks")
    wire = Wire(group, x)
    w = wire.out(x)
    scattered = wire.empty((x.shape[0] // n,) + tuple(x.shape[1:]), x.dtype)
    dist.reduce_scatter_tensor(scattered, w, group=group)
    gathered = wire.empty(w.shape, w.dtype)
    dist.all_gather_into_tensor(gathered, scattered, group=group)
    return wire.back(gathered)


def _travelling_copy(wire: Wire, x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` that can travel, never ``x`` itself (the
    collectives below write it in place)."""
    if wire.staged:
        return wire.out(x)
    return x.clone(memory_format=torch.contiguous_format)


def all_reduce(x: torch.Tensor, axis_name: str = None, *, mesh=None,
               group=None, stats: HopStats = None) -> torch.Tensor:
    """The sum of every rank's ``x`` over the group, as ``jax.lax.psum``:
    a new tensor of ``x``'s dtype on ``x``'s device, summed in that dtype
    (gloo rounds a bf16 sum after every add, where XLA rounds its bf16
    psum once: sum a bf16 tensor as fp32 to match it)."""
    group = resolve_group(axis_name, mesh, group)
    wire = Wire(group, x, stats)
    w = _travelling_copy(wire, x)
    wire.collective(dist.all_reduce, w)
    return wire.back(w)


def sum_in_order(parts, dtype: torch.dtype) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` in fp32, left to right, rounded once
    to ``dtype``."""
    total = parts[0].float()
    for part in parts[1:]:
        total = total + part.float()
    return total.to(dtype)


def _sum_partials(x: torch.Tensor, axis_name, mesh, group,
                  stats: HopStats) -> torch.Tensor:
    parts = ring_all_gather(x[None], axis_name, mesh=mesh, group=group,
                            stats=stats)
    return sum_in_order(parts.unbind(0), x.dtype)


class _Sum(torch.autograd.Function):
    """``psum`` under autograd: every rank's output is the same sum, so
    the gradient of each rank's partial is the output's gradient, which
    is the same on every rank (the identity)."""

    @staticmethod
    def forward(ctx, x, axis_name, mesh, group, stats):
        return _sum_partials(x, axis_name, mesh, group, stats)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None, None, None


class _Replicated(torch.autograd.Function):
    """``replicated`` under autograd: the identity forward, the sum of the
    ranks' gradients backward."""

    @staticmethod
    def forward(ctx, x, axis_name, mesh, group, stats):
        ctx.where = (axis_name, mesh, group, stats)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (_sum_partials(grad.contiguous(), *ctx.where),
                None, None, None, None)


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def psum(x: torch.Tensor, axis_name: str = None, *, mesh=None, group=None,
         stats: HopStats = None) -> torch.Tensor:
    """The sum of every rank's partial ``x`` over the group, as the
    reference's ``jax.lax.psum`` of a partial product: a new tensor of
    ``x``'s dtype on ``x``'s device, identical on every rank.

    XLA rounds a bf16 psum once: over 4 CPU devices [256, 1, 1, 1] sums
    to 260, the nearest bf16 to 259.  gloo's bf16 all-reduce rounds after
    every add (256 or 260, by the ranks' order), and its fp32 one adds in
    an order of its own.  So the partials travel as they are, by
    ``ring_all_gather`` (each rank sends its partial N - 1 times: for
    bf16 partials on 4 ranks, the bytes of a ring all-reduce in fp32),
    and each rank adds them in fp32 in group-rank order
    (``sum_in_order``).

    Under autograd the gradient of ``x`` is the output's gradient, with
    no hop: the output is the same on every rank, and so is what follows
    it, so each rank already holds the gradient of the sum.  The dual,
    ``replicated``, marks where a tensor held alike on every rank enters
    a rank's part of a cut product."""
    stats = _COUNTING["sums"] if stats is None else stats
    if _needs_grad(x):
        return _Sum.apply(x, axis_name, mesh, group, stats)
    return _sum_partials(x, axis_name, mesh, group, stats)


def replicated(x: torch.Tensor, axis_name: str = None, *, mesh=None,
               group=None, stats: HopStats = None) -> torch.Tensor:
    """``x``, held alike on every rank of the group, as it enters this
    rank's part of a product cut over the group: the identity forward;
    under autograd the gradient of ``x`` is the sum over the group of the
    ranks' gradients (``psum``'s hops, counted in ``stats``), since each
    rank's part gives only its share of it.  Megatron's ``f`` to
    ``psum``'s ``g``."""
    if not _needs_grad(x):
        return x
    stats = _COUNTING["sums"] if stats is None else stats
    return _Replicated.apply(x, axis_name, mesh, group, stats)


def broadcast(x: torch.Tensor, axis_name: str = None, *, mesh=None,
              group=None, stats: HopStats = None) -> torch.Tensor:
    """The group's first rank's ``x`` on every rank of the group, as a new
    tensor on the caller's device; ``x`` has the same shape and dtype on
    every rank."""
    group = resolve_group(axis_name, mesh, group)
    wire = Wire(group, x, stats)
    w = _travelling_copy(wire, x)
    wire.collective(dist.broadcast, w, src=global_rank(group, 0))
    return wire.back(w)


def make_ring_all_gather(mesh, axis_name: str):
    """Global-array wrapper around ring_all_gather: given the whole ``x``
    on every rank, each rank gathers from its own row block (its
    coordinate along ``axis_name``) and gets the whole of ``x`` back."""
    def fn(x):
        n = mesh.shape[axis_name]
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split over {n}")
        chunk = x.shape[0] // n
        i = mesh.axis_index(axis_name)
        return ring_all_gather(x[i * chunk:(i + 1) * chunk], axis_name,
                               mesh=mesh)
    return fn
