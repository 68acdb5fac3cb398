"""Deterministic, shardable synthetic data pipeline.

Every batch is a pure function of (seed, step, shard) so that:
  * restarts resume mid-epoch with no state files (fault tolerance),
  * each data shard generates only its slice (no host broadcast),
  * straggler re-dispatch reproduces the exact same batch elsewhere.

The token stream is a mixture of Zipf-distributed unigrams and short
repeated motifs, giving the LM a learnable signal (loss drops well below
log(V) within a few hundred steps on the quickstart config).
"""
from __future__ import annotations

import dataclasses
import threading
import queue
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 8
    motif_vocab: int = 64
    n_shards: int = 1
    shard_index: int = 0


def _rng_for(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.shard_index]))


def make_batch(cfg: DataConfig, step: int,
               frontend_positions: int = 0,
               frontend_dim: int = 0) -> Dict[str, np.ndarray]:
    """Batch for `step` on this shard: tokens/labels/mask (+frontend)."""
    assert cfg.global_batch % cfg.n_shards == 0
    b = cfg.global_batch // cfg.n_shards
    rng = _rng_for(cfg, step)
    S = cfg.seq_len
    # Zipf unigram background
    ranks = np.arange(1, cfg.vocab_size + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(cfg.vocab_size, size=(b, S + 1), p=probs)
    # overlay repeated motifs (the learnable structure)
    n_motifs = max(1, S // (4 * cfg.motif_len))
    for i in range(b):
        motif = rng.integers(0, cfg.motif_vocab, size=cfg.motif_len)
        for _ in range(n_motifs):
            start = rng.integers(0, S + 1 - cfg.motif_len)
            toks[i, start:start + cfg.motif_len] = motif
    out: Dict[str, np.ndarray] = {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
        "mask": np.ones((b, S), np.int32),
    }
    if frontend_positions:
        out["frontend"] = rng.standard_normal(
            (b, frontend_positions, frontend_dim)).astype(np.float32)
        # labels over patch positions are masked out by construction:
        # the model prepends patches, so shift label/mask accordingly
        pad = np.zeros((b, frontend_positions), np.int32)
        out["labels"] = np.concatenate([pad, out["labels"]], axis=1)
        out["mask"] = np.concatenate([pad, out["mask"]], axis=1)
    return out


def batch_for_config(model_cfg, cfg: DataConfig, step: int):
    """Dispatch on the model config's frontend/enc-dec structure."""
    if model_cfg.frontend is not None and not model_cfg.encoder_layers:
        P = model_cfg.frontend.num_positions
        sub = dataclasses.replace(cfg, seq_len=cfg.seq_len - P)
        return make_batch(sub, step, P, model_cfg.frontend.embed_dim)
    if model_cfg.encoder_layers:
        b = make_batch(cfg, step)
        rng = _rng_for(cfg, step)
        P = model_cfg.frontend.num_positions if model_cfg.frontend else 64
        E = (model_cfg.frontend.embed_dim if model_cfg.frontend
             else model_cfg.d_model)
        b["frontend"] = rng.standard_normal(
            (b["tokens"].shape[0], P, E)).astype(np.float32)
        return b
    return make_batch(cfg, step)


class Prefetcher:
    """Background-thread prefetch of the next `depth` batches."""

    def __init__(self, model_cfg, cfg: DataConfig, start_step: int = 0,
                 depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            step = start_step
            while not self._stop.is_set():
                batch = batch_for_config(model_cfg, cfg, step)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
