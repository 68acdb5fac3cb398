"""Train-step factory + the host-side training loop (counterpart of
``repro/train/train_loop.py``).

``make_train_step`` builds the step
    (params, opt_state, batch) -> (params, opt_state, metrics):
``train_forward`` (each group's blocks recomputed in the backward pass,
the sequence-chunked loss), the backward pass, optionally the int8
gradient compression (``compress_grads="int8"``), then AdamW with fp32
masters.  PyTorch runs it eagerly: there is nothing to jit, and the
state's tensors are updated in place where the reference donates them.
On CUDA tensors the blocks run the hand kernels, forward and backward.

``TrainLoop`` drives it: deterministic batches, periodic checkpointing,
automatic resume, and the hooks the fault-tolerance harness uses.  Its
weights are drawn from ``torch.Generator(device)`` seeded with ``seed``
(the reference draws from ``jax.random.PRNGKey(seed)``).

Data parallelism with ZeRO-1.  Under a ``ctx`` whose mesh has data axes
of product n > 1, the step runs in each rank of the mesh, as GSPMD runs
the reference's over its devices:

  * the loop draws the **global** batch; each rank takes its rows
    (``sharding.batch_specs`` and ``local_shard``);
  * each rank's gradients and metrics, scaled by its share of the global
    ``mask`` sum, are summed over the data axes as one fp32 buffer
    (``collectives.all_reduce``): the gradient of the global token mean;
  * the compression, the global norm and the clip act on the summed
    tree, in the reference's order;
  * each rank holds only its block of the fp32 masters, m and v
    (``sharding.opt_state_specs``: the first free dimension that the
    data axes divide; a leaf with none stays whole on every rank),
    updates it, casts it to the parameter's dtype, and the ranks gather
    the blocks (``collectives.ring_all_gather``), so every rank holds the
    whole new parameters.

A checkpoint under a mesh is the whole tree in the one-device format:
the ranks gather the state and rank 0 writes it; on resume every rank
reads the whole tree and takes its blocks (``checkpoint.reshard``).  So
a checkpoint moves between one device and any data mesh.

Dense tensor parallelism.  Under a ``ctx`` whose model axis is M > 1,
the step runs in each rank of the model axis:

  * the loop draws the whole tree as one device does and each rank keeps
    its ``sharding.param_specs`` blocks (attention by heads, the dense
    MLP by ``d_ff``, the vocabulary by rows and columns; ``reshard``), so
    the ranks start from the one-device weights;
  * the forward sums each cut product over the model axis and the
    backward sums the gradient of each whole input to one
    (``models/transformer.py``): each rank's gradients are its blocks of
    the one-device gradients, and the leaves it holds whole get the whole
    gradient, the same on every rank;
  * the global norm sums the cut leaves' squares over the model axis and
    counts the whole leaves once (``optimizer.global_norm``), so every
    rank clips alike, updates its own blocks, and updates a whole leaf
    as every other rank does; the metrics are the same on every rank.

Both at once.  Over a (D, M) mesh with D > 1 and M > 1 the two combine,
each rank on its rows and on its model blocks: the gradients of the
blocks are summed over the data axes' sub-groups (the ranks that share
its model index), the norm is the model axis's over the summed blocks,
and ZeRO-1 cuts each rank's model blocks over the data axes
(``zero1_specs``: the model axis on a leaf's cut dimension and the data
axes on the first free dimension they divide).  A rank holds its data
block of its model block of the masters, m and v, and the data ranks
gather the updated blocks back into the model block.  Over a data axis
alone the model blocks are the whole leaves; over a model axis alone the
state is the blocks' own.

The hops over the model axis (the sums and the loss's gather of row
maxima) are counted in ``stats["model_sum"]`` (``collectives.counting``),
those over the data axes in ``stats["grad_sum"]`` and
``stats["param_gather"]``.  Each of these raises, naming its ROADMAP
item: a checkpoint directory or ``compress_grads="int8"`` over a model
axis above 1 (A10.2c-train-ckpt: the checkpoint is the whole tree, and
the int8 row scales are the whole leaf's, so both need the blocks
gathered over the model axis); the RG-LRU, SSD, cross-attention and
encoder blocks (A10.2c-train-rec) and Mixture-of-Experts layers
(A10.2b-moe) under autograd over a model axis
(``models/transformer.py``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.convert import tree_leaves, tree_map, tree_unflatten
from repro_torch.data.pipeline import DataConfig, batch_for_config
from repro_torch.distributed import collectives, sharding
from repro_torch.models import transformer as tr
from repro_torch.models.moe import LOCAL_CTX, ShardCtx
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import (AdamWConfig, apply_updates,
                                         global_norm, init_opt_state)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 200
    keep_checkpoints: int = 3
    log_every: int = 10
    compress_grads: Optional[str] = None       # None | "int8"


def value_and_grad(model_cfg, params, batch, ctx: ShardCtx = LOCAL_CTX,
                   kernels=None):
    """((loss, metrics), grads) of ``train_forward`` at ``params``, the
    gradients in the params' tree and dtypes (a leaf the loss does not
    reach gets zeros, as jax gives)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = tr.train_forward(tree_unflatten(params, leaves),
                                         batch, model_cfg, ctx,
                                         kernels=kernels)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


# --------------------------------------------------------------------------
# Data parallelism and ZeRO-1
# --------------------------------------------------------------------------
def data_parallel(ctx: Optional[ShardCtx]) -> bool:
    """Whether ``ctx`` spreads the batch over ranks: a mesh whose data
    axes' product is above 1 (whatever its model axis)."""
    if ctx is None or ctx.mesh is None:
        return False
    return math.prod(ctx.mesh.shape[a] for a in ctx.data_axes) > 1


def model_parallel(ctx: Optional[ShardCtx]) -> bool:
    """Whether ``ctx`` cuts the model over a model axis above 1 (whatever
    its data axes)."""
    return ctx is not None and ctx.mesh is not None and ctx.model_size > 1


def model_specs(model_cfg, ctx: ShardCtx):
    """``sharding.param_specs`` of ``model_cfg``'s tree over ``ctx``'s
    model axis (drawn on the ``meta`` device)."""
    return sharding.param_specs(
        tr.init_params(model_cfg, torch.Generator(), "meta"), model_cfg,
        ctx.mesh, ctx.model_axis)


def cut_over_model(specs, ctx: ShardCtx) -> list:
    """For each leaf of ``specs`` (``tree_leaves`` order), whether it cuts
    a dimension over ``ctx``'s model axis."""
    def cuts(spec):
        return any(ctx.model_axis in (e if isinstance(e, tuple) else (e,))
                   for e in spec)
    return [cuts(s) for s in tree_leaves(
        specs, lambda x: isinstance(x, sharding.P))]


def _refuse_model_state(train_cfg: TrainConfig, ctx: ShardCtx) -> None:
    """What over a model axis above 1 needs the blocks gathered over it
    (ROADMAP A10.2c-train-ckpt)."""
    for what, on in (("a checkpoint directory", train_cfg.checkpoint_dir),
                     ('compress_grads="int8"', train_cfg.compress_grads)):
        if on:
            raise NotImplementedError(
                f"{what} over a model axis of {ctx.model_size}: the whole "
                f"leaves from the ranks' blocks (a checkpoint's tree, the "
                f"int8 row scales of a whole leaf) are ROADMAP "
                f"A10.2c-train-ckpt")


def zero1_specs(params, model_cfg, ctx: ShardCtx):
    """The optimizer state's specs under ``ctx``'s mesh:
    ``sharding.opt_state_specs`` over the reference's ``param_specs``
    ({"step", "master", "m", "v"}): each leaf's model axis on its cut
    dimension, the data axes on the first free dimension they divide.
    ``params`` is the whole tree (or its ``meta`` shapes)."""
    pspecs = sharding.param_specs(params, model_cfg, ctx.mesh,
                                  ctx.model_axis)
    return sharding.opt_state_specs(
        {"master": params, "m": params, "v": params}, pspecs, ctx.mesh,
        ctx.data_axes)


def state_specs(model_cfg, ctx: ShardCtx):
    """ZeRO-1's specs of a rank's optimizer state on its model blocks:
    ``zero1_specs`` of the whole tree (drawn on the ``meta`` device) with
    every entry that names the model axis set to ``None``, so only the
    data axes cut (``local_shard`` with the whole spec on a model block
    would cut the model dimension a second time)."""
    def data_only(path, spec):
        return sharding.P(*(None if ctx.model_axis in (
            e if isinstance(e, tuple) else (e,)) else e for e in spec))
    return sharding.tree_map_with_path(data_only, zero1_specs(
        tr.init_params(model_cfg, torch.Generator(), "meta"), model_cfg,
        ctx))


def _rows(batch, ctx: ShardCtx):
    """This rank's rows of the global ``batch`` and its share of the
    global ``mask`` sum (a 0-d fp32 tensor)."""
    n = math.prod(ctx.mesh.shape[a] for a in ctx.data_axes)
    if batch["mask"].shape[0] % n:
        raise ValueError(f"a global batch of {batch['mask'].shape[0]} rows "
                         f"does not split over {n} data ranks")
    specs = sharding.batch_specs(batch, ctx.data_axes, ctx.mesh)
    rows = {k: sharding.local_shard(v, specs[k], ctx.mesh)
            for k, v in batch.items()}
    share = rows["mask"].float().sum() / torch.clamp_min(
        batch["mask"].float().sum(), 1.0)
    return rows, share


def sum_over_data(grads, metrics: Dict[str, torch.Tensor], share,
                  ctx: ShardCtx, stats: collectives.HopStats = None):
    """The sum over the data axes of each rank's ``grads`` and
    ``metrics`` scaled by its ``share``: one fp32 buffer, the metrics
    after the gradients, summed by one ``all_reduce`` an axis.  Returns
    (fp32 gradients in ``grads``' nesting, metrics): with two ranks, the
    bits of ``g0 * share0 + g1 * share1`` computed leaf by leaf."""
    leaves = tree_leaves(grads)
    names = list(metrics)
    flat = torch.cat([g.reshape(-1).float() for g in leaves]
                     + [torch.stack([metrics[k] for k in names]).float()])
    flat.mul_(share)
    for axis in ctx.data_axes:
        if ctx.mesh.shape[axis] > 1:
            flat = collectives.all_reduce(flat, axis, mesh=ctx.mesh,
                                          stats=stats)
    parts = flat.split([g.numel() for g in leaves] + [len(names)])
    # each leaf back in the layout autograd gave it (a tied embedding's
    # gradient comes transposed): a reduction's bits, the global norm's
    # sums of squares, follow the order of its input in memory
    summed = [torch.empty_like(g, dtype=torch.float32).copy_(p.view(g.shape))
              for p, g in zip(parts, leaves)]
    return (tree_unflatten(grads, summed),
            dict(zip(names, parts[-1].unbind())))


def _data_dim(spec, data_axes) -> Optional[int]:
    """The dimension ``spec`` cuts over the data axes, if any."""
    for dim, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if any(a in data_axes for a in axes):
            return dim
    return None


def gather_blocks(blocks, specs, ctx: ShardCtx,
                  stats: collectives.HopStats = None):
    """Each rank's model blocks (the whole leaves where the model axis is
    1) from the data blocks it and the ranks of its data axes hold under
    ``specs`` (ZeRO-1's): each dimension cut over data axes is moved to
    the front, gathered over its axes (the innermost first, so the
    blocks fall in ``local_shard``'s order) and moved back.  Only data
    axes are gathered, whatever the model entries of ``specs``.  A leaf
    that is not cut over them comes back as it is."""
    def one(path, block, spec):
        dim = _data_dim(spec, ctx.data_axes)
        if dim is None:
            return block
        entry = spec[dim]
        x = block.movedim(dim, 0).contiguous()
        for axis in reversed(entry if isinstance(entry, tuple) else (entry,)):
            x = collectives.ring_all_gather(x, axis, mesh=ctx.mesh,
                                            stats=stats)
        return x.movedim(0, dim).contiguous()
    return sharding.tree_map_with_path(one, blocks, specs)


def local_blocks(tree, specs, ctx: ShardCtx):
    """This rank's blocks of ``tree`` under ``specs``, as views: of the
    whole tree under whole specs, or of the rank's model blocks under
    ``state_specs`` (its data blocks of them, ZeRO-1's)."""
    return sharding.tree_map_with_path(
        lambda path, t, s: sharding.local_shard(t, s, ctx.mesh), tree, specs)


def make_train_step(model_cfg, train_cfg: TrainConfig,
                    ctx: ShardCtx = LOCAL_CTX, kernels=None,
                    stats: Optional[Dict[str, collectives.HopStats]] = None
                    ) -> Callable:
    """The step function; the optimizer state is updated in place.

    Under a data mesh (``data_parallel(ctx)``) it takes the global batch
    and this rank's ZeRO-1 blocks of the state (``state_specs``); over a
    model axis (``model_parallel(ctx)``) this rank's ``param_specs``
    blocks of the parameters.  Over both, a step: this rank's rows
    (``_rows``); the gradients of its model blocks under ``ctx`` (the
    sums over the model axis forward and backward; every rank of a model
    group computes the same loss and metrics); ``sum_over_data`` of the
    gradients and metrics scaled by the rank's share of the ``mask`` sum;
    the global norm of the summed blocks over the model axis
    (``global_norm`` with ``cut``: after the data sum every data rank
    holds the same blocks, so no sum of squares over the data axes is
    needed); AdamW on the rank's data block of its model block; the
    blocks gathered over the data axes, back into the model block.

    With ``stats``, the hops over the data axes count in
    ``stats["grad_sum"]`` and ``stats["param_gather"]``, those over the
    model axis in ``stats["model_sum"]``.  Building it makes no
    collective."""
    opt_cfg = train_cfg.optimizer
    dp = data_parallel(ctx)
    tp = model_parallel(ctx)
    stats = stats or {}
    cut = model_sum = None
    if dp:
        specs = state_specs(model_cfg, ctx)["master"]
        # the gather counts in stats of its own: a ring_all_gather given
        # none would count in ``counting``'s, the model axis's
        param_gather = stats.get("param_gather") or collectives.HopStats()
    if tp:
        _refuse_model_state(train_cfg, ctx)
        cut = cut_over_model(model_specs(model_cfg, ctx), ctx)
        sums = stats.get("model_sum")

        def model_sum(t):
            return collectives.psum(t, ctx.model_axis, mesh=ctx.mesh)

    def step_fn(params, opt_state, batch):
        if tp:
            with collectives.counting(sums, sums):
                return step(params, opt_state, batch)
        return step(params, opt_state, batch)

    def step(params, opt_state, batch):
        if dp:
            batch, share = _rows(batch, ctx)
        (_, metrics), grads = value_and_grad(model_cfg, params, batch, ctx,
                                             kernels)
        if dp:
            grads, metrics = sum_over_data(grads, metrics, share, ctx,
                                           stats.get("grad_sum"))
        if train_cfg.compress_grads == "int8":
            from repro_torch.distributed.compression import compress_tree_int8
            grads, comp_err = compress_tree_int8(grads)
            metrics = dict(metrics, compression_err=comp_err)
        norm = global_norm(grads, cut=cut, model_sum=model_sum)
        if dp:
            blocks, opt_state, opt_metrics = apply_updates(
                opt_cfg, local_blocks(params, specs, ctx),
                local_blocks(grads, specs, ctx), opt_state, grad_norm=norm)
            params = gather_blocks(blocks, specs, ctx, param_gather)
        else:
            params, opt_state, opt_metrics = apply_updates(
                opt_cfg, params, grads, opt_state, grad_norm=norm)
        metrics = dict(metrics, **opt_metrics)
        return params, opt_state, metrics

    return step_fn


@dataclasses.dataclass
class TrainLoop:
    model_cfg: Any
    data_cfg: DataConfig
    train_cfg: TrainConfig
    ctx: ShardCtx = LOCAL_CTX
    kernels: Optional[Dict] = None
    device: DeviceLike = None          # None = the GPU
    #: what the distributed step's hops moved (``make_train_step``)
    hop_stats: Dict[str, collectives.HopStats] = dataclasses.field(
        default_factory=lambda: {"grad_sum": collectives.HopStats(),
                                 "param_gather": collectives.HopStats(),
                                 "model_sum": collectives.HopStats()})

    def init_or_resume(self, seed: int = 0):
        """(params, opt_state, start step): drawn from ``seed``, or the
        newest checkpoint's.  Every rank draws (or reads) the whole tree;
        over a model axis it keeps its ``param_specs`` blocks (``reshard``)
        and starts their state; under a data mesh it keeps its ZeRO-1
        blocks of that state (``state_specs``: over both axes, its data
        blocks of its model blocks')."""
        dev = resolve_device(self.device)
        tp = model_parallel(self.ctx)
        if tp:
            _refuse_model_state(self.train_cfg, self.ctx)
        gen = torch.Generator(dev).manual_seed(seed)
        params = tr.init_params(self.model_cfg, gen, dev)
        if tp:
            params = ckpt_lib.reshard(params, sharding.named(
                self.ctx.mesh, model_specs(self.model_cfg, self.ctx)), dev)
        opt_state = init_opt_state(params)
        start_step = 0
        if self.train_cfg.checkpoint_dir:      # never over a model axis
            try:
                step, tree, _ = ckpt_lib.restore(
                    self.train_cfg.checkpoint_dir,
                    {"params": params, "opt": opt_state})
                tree = tree_map(lambda t: t.to(dev), tree)
                params, opt_state = tree["params"], tree["opt"]
                start_step = step
            except FileNotFoundError:
                pass
        if data_parallel(self.ctx):
            opt_state = ckpt_lib.reshard(opt_state, sharding.named(
                self.ctx.mesh, state_specs(self.model_cfg, self.ctx)), dev)
        return params, opt_state, start_step

    def _save(self, step: int, params, opt_state) -> None:
        """Write the whole tree at ``step``: under a data mesh the ranks
        gather the state's blocks and rank 0 writes."""
        tree = {"params": params, "opt": opt_state}
        if data_parallel(self.ctx):
            specs = state_specs(self.model_cfg, self.ctx)
            tree["opt"] = dict(opt_state, **{
                k: gather_blocks(opt_state[k], specs[k], self.ctx)
                for k in ("master", "m", "v")})
            if any(self.ctx.mesh.axis_index(a) for a in self.ctx.data_axes):
                return
        ckpt_lib.save(self.train_cfg.checkpoint_dir, step, tree,
                      metadata={"model": self.model_cfg.name})
        ckpt_lib.prune_old(self.train_cfg.checkpoint_dir,
                           self.train_cfg.keep_checkpoints)

    def run(self, num_steps: int, seed: int = 0,
            on_step: Optional[Callable] = None):
        """Train for num_steps (resuming if a checkpoint exists).

        Returns (params, opt_state, history list of metric dicts).
        """
        dev = resolve_device(self.device)
        params, opt_state, start = self.init_or_resume(seed)
        step_fn = make_train_step(self.model_cfg, self.train_cfg, self.ctx,
                                  self.kernels, self.hop_stats)
        history = []
        t0 = time.perf_counter()
        for step in range(start, start + num_steps):
            batch = batch_for_config(self.model_cfg, self.data_cfg, step)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if on_step is not None:
                on_step(step, params, opt_state, metrics)
            if (step + 1) % self.train_cfg.log_every == 0 or step == start:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["wall_s"] = time.perf_counter() - t0
                history.append(m)
            if (self.train_cfg.checkpoint_dir
                    and (step + 1) % self.train_cfg.checkpoint_every == 0):
                self._save(step + 1, params, opt_state)
        return params, opt_state, history
