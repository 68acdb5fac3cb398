"""Mixture-of-Experts layer: top-k token-choice routing, capacity dispatch.

Counterpart of ``repro/models/moe.py``.  Without a mesh (``LOCAL_CTX``,
or any ``ShardCtx`` whose mesh is ``None``) the layer runs on one device.
Over a mesh (a ``launch.mesh.Mesh`` of ``torch.distributed`` ranks) it
runs eagerly in each rank, on this rank's block of the layer's
parameters (cut by ``distributed/sharding.py``'s specs, as the
reference's ``shard_map`` cuts them) and this rank's data shard of the
tokens, in the reference's two modes:

  * ``tp`` — every rank holds all experts with each expert's hidden width
    ``d_ff`` sliced over the model axis (any expert count);
  * ``ep`` — experts sliced over the model axis; each rank computes only
    the choices routed to its local experts, ``num_experts`` divisible by
    the model axis (olmoe: 64).

In both the only collective is one sum of the (tokens, d_model) output
over the model axis, the reference's ``psum``
(``distributed/collectives.py::psum``, the sum the dense blocks use too:
fp32 in rank order, rounded once to the output's dtype, as XLA rounds a
bf16 psum).  As in the
reference, the capacity is counted from the rank's own tokens (a data
shard's, not the whole batch's), and every rank returns data shard 0's
aux losses (its ``out_specs`` ``P()`` with ``check_vma=False``).  There
is no backward through the sum, and autograd here raises:
Mixture-of-Experts training over a mesh is ROADMAP A10.2b-moe (the
launcher trains dense and SSD models over a data mesh).

Dispatch uses the capacity trick: scatter into an (E, C+1, d) buffer where
row C is the overflow sink for capacity-dropped tokens, then slice it off.
The reference has no Pallas kernel here (its dispatch is jnp code under
``named_scope("moe_dispatch")``), so neither has the port: the dispatch is
PyTorch indexing and the experts three batched products.  The two
``record_function`` scopes, ``moe_dispatch`` around the whole layer and
``moe_experts`` around the products, let a profiler trace tell the
dispatch and gather from the experts' GEMMs.

Top-k follows ``jax.lax.top_k``: among equal probabilities the lower
expert id comes first (a stable descending sort, not ``torch.topk``,
which promises no order among ties).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.distributed import collectives
from repro_torch.models.common import dense_init, pdtype


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """How model code should shard itself.  mesh=None => single-device."""
    mesh: Optional[object] = None
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: Optional[str] = "model"

    @property
    def model_size(self) -> int:
        if self.mesh is None or self.model_axis is None:
            return 1
        return self.mesh.shape[self.model_axis]


LOCAL_CTX = ShardCtx(mesh=None, data_axes=(), model_axis=None)


def init_moe(generator, cfg, device: DeviceLike = None):
    """Router (d, E) fp32; w_gate/w_up (E, d, f) for swiglu, else w_in;
    w_down (E, f, d); the experts in the parameter dtype."""
    device = resolve_device(device)
    m = cfg.moe
    dt = pdtype(cfg)
    d, f, E = cfg.d_model, m.d_ff, m.num_experts
    p = {"router": dense_init(generator, (d, E), torch.float32,
                              device=device)}
    if cfg.activation == "swiglu":
        p["w_gate"] = dense_init(generator, (E, d, f), dt, fan_in=d,
                                 device=device)
        p["w_up"] = dense_init(generator, (E, d, f), dt, fan_in=d,
                               device=device)
    else:
        p["w_in"] = dense_init(generator, (E, d, f), dt, fan_in=d,
                               device=device)
    p["w_down"] = dense_init(generator, (E, f, d), dt, fan_in=f,
                             device=device)
    return p


def _activation(h, kind):
    hf = h.float()
    if kind == "relu2":
        return F.relu(hf).square().to(h.dtype)
    return F.gelu(hf, approximate="tanh").to(h.dtype)


def _expert_ffn(p, buf, activation):
    """buf: (E, C, d) -> (E, C, d) through each expert's FFN."""
    if "w_gate" in p:
        g = torch.bmm(buf, p["w_gate"])
        u = torch.bmm(buf, p["w_up"])
        h = F.silu(g.float()).to(buf.dtype) * u
    else:
        h = _activation(torch.bmm(buf, p["w_in"]), activation)
    return torch.bmm(h, p["w_down"])


def _route(x2d, router_w, top_k):
    """x2d (T, d) -> gates (T,k) fp32, ids (T,k) int64, aux losses."""
    logits = x2d.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    # the k largest, lower id first among equals (as jax.lax.top_k)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :top_k], ids[:, :top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # switch-style load-balance loss + router z-loss
    E = router_w.shape[-1]
    frac_prob = probs.mean(dim=0)                                    # (E,)
    frac_tok = F.one_hot(ids[:, 0], E).float().mean(dim=0)
    aux = {
        "load_balance": E * torch.sum(frac_prob * frac_tok),
        "router_z": torch.logsumexp(logits, dim=-1).square().mean(),
    }
    return gates, ids, aux


def _slots(ids, capacity, expert_offset, n_local):
    """Each (token, choice)'s expert and row in its queue, in the flat
    token-major order of ``ids.reshape(-1)``.  Returns (flat expert ids
    clipped to the local range, keep mask, slot), the slot being the
    running count of earlier choices of that expert, or ``capacity`` (the
    overflow row) where the choice is dropped or not local."""
    flat_ids = ids.reshape(-1) - expert_offset                       # (T*k,)
    local = (flat_ids >= 0) & (flat_ids < n_local)
    flat_ids_c = flat_ids.clamp(0, n_local - 1)
    # the reference's (T*k, E) one-hot, laid out expert-major so that the
    # running count scans the contiguous axis: on CUDA a scan down the
    # token axis runs one thread an expert (51 ms a layer at 4 x 4096
    # tokens on an H100, PERF.md)
    oh = torch.zeros((n_local, flat_ids.numel()), dtype=torch.int32,
                     device=ids.device)
    oh.scatter_(0, flat_ids_c[None], local[None].to(torch.int32))
    pos = torch.gather(torch.cumsum(oh, dim=1, dtype=torch.int32) - 1, 0,
                       flat_ids_c[None])[0].long()
    keep = local & (pos >= 0) & (pos < capacity)
    slot = torch.where(keep, pos, torch.full_like(pos, capacity))
    return flat_ids_c, keep, slot


def _dispatch_compute_combine(p, x2d, gates, ids, capacity, activation,
                              expert_offset=0, n_local_experts=None):
    """Scatter tokens to (E_local, C(+1 overflow), d), run FFNs, gather back.

    expert_offset / n_local_experts implement the EP mode: choices routed to
    experts outside [offset, offset+n_local) are sent to the overflow row.
    """
    T, d = x2d.shape
    k = ids.shape[1]
    n_local = n_local_experts or p["w_down"].shape[0]
    flat_ids_c, keep, slot = _slots(ids, capacity, expert_offset, n_local)
    x_rep = torch.repeat_interleave(x2d, k, dim=0)                   # (T*k, d)
    buf = x2d.new_zeros((n_local, capacity + 1, d))
    # Rows [0, C) get one choice each (a slot is a running count within
    # its expert); every dropped choice writes the overflow row C, so
    # which of them lands there is unspecified on CUDA -- harmless, the
    # row is sliced off before the experts run
    buf[flat_ids_c, slot] = x_rep
    with record_function("moe_experts"):
        out_buf = _expert_ffn(p, buf[:, :capacity], activation)     # (E, C, d)
    out_buf = F.pad(out_buf, (0, 0, 0, 1))                          # overflow row -> 0
    y_rep = out_buf[flat_ids_c, slot]                                # (T*k, d)
    y_rep = y_rep * keep[:, None].to(y_rep.dtype)
    w = gates.reshape(-1).to(y_rep.dtype)
    return (y_rep * w[:, None]).reshape(T, k, d).sum(dim=1)


def _capacity(n_tokens: int, top_k: int, n_experts: int, factor: float) -> int:
    return max(1, int(n_tokens * top_k / n_experts * factor + 0.999))


def _check_sharded(p, x, cfg, ctx: ShardCtx) -> None:
    """Refuse what the sharded layer cannot compute right."""
    m = cfg.moe
    if not (hasattr(ctx.mesh, "axis_index") and hasattr(ctx.mesh, "group")):
        raise NotImplementedError(
            f"sharded Mixture-of-Experts runs over a mesh of "
            f"torch.distributed ranks (launch.mesh.Mesh: axis_index, group), "
            f"not a {type(ctx.mesh).__name__} (ROADMAP A10)")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in [x, *p.values()]):
        raise RuntimeError(
            "sharded Mixture-of-Experts has no backward through its sum "
            "over the model axis; Mixture-of-Experts training over a mesh "
            "is ROADMAP A10.2b-moe: run it under torch.no_grad() or "
            "torch.inference_mode()")
    size = ctx.model_size
    if size == 1:
        return
    if m.partitioning == "ep":
        if m.num_experts % size:
            raise ValueError(f"ep: {m.num_experts} experts do not split over "
                             f"a model axis of {size}")
        have, want = p["w_down"].shape[0], m.num_experts // size
    else:
        have, want = p["w_down"].shape[1] * size, m.d_ff
    if have != want:
        raise ValueError(f"{m.partitioning}: w_down {tuple(p['w_down'].shape)}"
                         f" is not this rank's block of a model axis of "
                         f"{size} (cut it by distributed/sharding.py)")


def _psum(y, ctx: ShardCtx):
    """The reference's ``psum`` of the layer's output over the model axis
    (``collectives.psum``)."""
    return collectives.psum(y, ctx.model_axis, mesh=ctx.mesh)


def apply_moe(p, x, cfg, ctx: ShardCtx = LOCAL_CTX):
    """x: (B, S, d) -> (y (B,S,d), aux dict of scalars).

    Over a mesh, ``p`` is this rank's block and ``x`` its data shard; ``y``
    is the rank's data shard of the output, summed over the model axis,
    and ``aux`` data shard 0's."""
    if ctx.mesh is not None:
        _check_sharded(p, x, cfg, ctx)
    m = cfg.moe
    B, S, d = x.shape
    mdl_size = ctx.model_size
    x2d = x.reshape(B * S, d)
    with record_function("moe_dispatch"):
        gates, ids, aux = _route(x2d, p["router"], m.top_k)
        cap = _capacity(B * S, m.top_k, m.num_experts, m.capacity_factor)
        if m.partitioning == "ep" and mdl_size > 1:
            n_local = m.num_experts // mdl_size
            idx = ctx.mesh.axis_index(ctx.model_axis)
            y = _dispatch_compute_combine(
                p, x2d, gates, ids, cap, cfg.activation,
                expert_offset=idx * n_local, n_local_experts=n_local)
        else:
            y = _dispatch_compute_combine(p, x2d, gates, ids, cap,
                                          cfg.activation)
    if ctx.mesh is not None:
        if mdl_size > 1:
            # tp: partial sums over f slices; ep: per-token expert
            # contributions
            y = _psum(y, ctx)
        # the reference's aux out_specs P(): data shard 0's values
        values = torch.stack(list(aux.values()))
        for axis in ctx.data_axes:
            if ctx.mesh.shape[axis] > 1:
                values = collectives.broadcast(values, axis, mesh=ctx.mesh)
        aux = dict(zip(aux, values.unbind()))
    return y.reshape(B, S, d), aux


def routing_stats(p, x, cfg) -> dict:
    """What ``apply_moe`` does with the tokens of ``x`` (B, S, d) at
    ``cfg``'s capacity: the capacity, the share of (token, choice) pairs
    dropped, the largest expert's load (choices routed to it, kept or
    not) over the mean load, and the two aux losses.  Reads the values
    back to the host."""
    m = cfg.moe
    x2d = x.reshape(-1, x.shape[-1])
    _, ids, aux = _route(x2d, p["router"], m.top_k)
    cap = _capacity(x2d.shape[0], m.top_k, m.num_experts, m.capacity_factor)
    _, keep, _ = _slots(ids, cap, 0, m.num_experts)
    load = torch.bincount(ids.reshape(-1), minlength=m.num_experts).float()
    return {"capacity": cap, "choices": int(keep.numel()),
            "dropped": int((~keep).sum()),
            "drop_share": float((~keep).float().mean()),
            "max_load_over_mean": float(load.max() / load.mean()),
            "load_balance": float(aux["load_balance"]),
            "router_z": float(aux["router_z"])}
