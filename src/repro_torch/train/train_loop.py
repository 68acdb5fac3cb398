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
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.convert import tree_leaves, tree_map, tree_unflatten
from repro_torch.data.pipeline import DataConfig, batch_for_config
from repro_torch.models import transformer as tr
from repro_torch.models.moe import LOCAL_CTX, ShardCtx
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import (AdamWConfig, apply_updates,
                                         init_opt_state)


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


def make_train_step(model_cfg, train_cfg: TrainConfig,
                    ctx: ShardCtx = LOCAL_CTX, kernels=None) -> Callable:
    """The step function; the optimizer state is updated in place."""
    opt_cfg = train_cfg.optimizer

    def step_fn(params, opt_state, batch):
        (_, metrics), grads = value_and_grad(model_cfg, params, batch, ctx,
                                             kernels)
        if train_cfg.compress_grads == "int8":
            from repro_torch.distributed.compression import compress_tree_int8
            grads, comp_err = compress_tree_int8(grads)
            metrics = dict(metrics, compression_err=comp_err)
        params, opt_state, opt_metrics = apply_updates(
            opt_cfg, params, grads, opt_state)
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

    def init_or_resume(self, seed: int = 0):
        dev = resolve_device(self.device)
        gen = torch.Generator(dev).manual_seed(seed)
        params = tr.init_params(self.model_cfg, gen, dev)
        opt_state = init_opt_state(params)
        start_step = 0
        if self.train_cfg.checkpoint_dir:
            try:
                step, tree, _ = ckpt_lib.restore(
                    self.train_cfg.checkpoint_dir,
                    {"params": params, "opt": opt_state})
                tree = tree_map(lambda t: t.to(dev), tree)
                params, opt_state = tree["params"], tree["opt"]
                start_step = step
            except FileNotFoundError:
                pass
        return params, opt_state, start_step

    def run(self, num_steps: int, seed: int = 0,
            on_step: Optional[Callable] = None):
        """Train for num_steps (resuming if a checkpoint exists).

        Returns (params, opt_state, history list of metric dicts).
        """
        dev = resolve_device(self.device)
        params, opt_state, start = self.init_or_resume(seed)
        step_fn = make_train_step(self.model_cfg, self.train_cfg, self.ctx,
                                  self.kernels)
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
                ckpt_lib.save(self.train_cfg.checkpoint_dir, step + 1,
                              {"params": params, "opt": opt_state},
                              metadata={"model": self.model_cfg.name})
                ckpt_lib.prune_old(self.train_cfg.checkpoint_dir,
                                   self.train_cfg.keep_checkpoints)
        return params, opt_state, history
