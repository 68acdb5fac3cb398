"""Split-serving engines: the paper's system, executing real PyTorch models.

``DiffusionSplitEngine`` — iteration-granularity split (the paper's main
system).  The cloud runs denoising iterations [0, n_final) for each
request, batched within n_final groups (the n_step quantization is what
makes groups batchable AND bounds the number of cached executables),
then ships (latent fp32 + context fp16) through the transport layer.

``DiffusionDeviceSim`` — the mobile side: decodes the payload, finishes
[n_final, n_total) and runs the VAE decoder.

``LayerSplitEngine`` / ``LayerSplitDevice`` — layer-granularity split
for the LM zoo (the generalization of the paper's RegNet Table 1
splitting): the cloud runs pattern groups [0, g) and ships the hidden
state in fp16, the device finishes [g, G), the final norm and the head.
Unlike the reference's, these pass ``kernels.ops.kernel_registry()`` to
``run_layer_range``; its ``rglru`` entry is the wrapper that RG-LRU blocks
also take by default, which runs the scan kernel on the card.

All four measure their own executable-cache size, GPU-seconds and bytes
shipped.  Counterpart of ``repro/serving/engine.py``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.compat import DeviceLike, resolve_device
from repro_torch.core.cost_model import CostParams
from repro_torch.core.planner import PlanRequest, Planner
from repro_torch.core.telemetry import DeviceProfile
from repro_torch.core.transport import (
    LinkProfile,
    WAN_LINK,
    get_wire_format,
    pack_boundary,
    pack_boundary_wire,
    serialize,
    transmission_time,
    unpack_boundary,
)
from repro_torch.kernels import int8_quant
from repro_torch.kernels.ops import kernel_registry
from repro_torch.models import diffusion as dif
from repro_torch.models import transformer as tr
from repro_torch.models.common import pdtype
from repro_torch.models.moe import LOCAL_CTX


#: Unified stats schema — every engine reports exactly these keys.
#: ``gpu_seconds`` is steady-state execution only; warm-up is accounted
#: separately in ``compile_seconds`` (an executable-cache miss warms the
#: program BEFORE the timed region, so a request's cloud_seconds never
#: includes first-call costs: allocator growth, cuDNN algorithm choice).
ENGINE_STATS_KEYS = ("gpu_seconds", "compile_seconds", "bytes_shipped",
                     "requests", "executables", "cache_hits",
                     "cache_misses")


def _new_stats() -> Dict[str, Any]:
    return {"gpu_seconds": 0.0, "compile_seconds": 0.0,
            "bytes_shipped": 0, "requests": 0, "executables": 0,
            "cache_hits": 0, "cache_misses": 0}


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Request:
    request_id: str
    device: DeviceProfile
    cond_tokens: np.ndarray          # (1, text_len)
    uncond_tokens: np.ndarray


@dataclasses.dataclass
class SplitResult:
    request_id: str
    n_cloud: int
    payload: bytes
    cloud_seconds: float
    transfer_seconds: float


class DiffusionSplitEngine:
    def __init__(self, params, cfg, cost: CostParams,
                 link: LinkProfile = WAN_LINK, transfer_mode: str = "paper",
                 planner: Optional[Planner] = None,
                 wire: Optional[str] = None,
                 device: DeviceLike = None):
        #: where the model runs; ``None`` = the GPU (a missing GPU raises).
        #: ``params`` must already lie there
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.cost = cost
        self.link = link
        self.transfer_mode = transfer_mode
        #: wire-format name (core.transport.WIRE_FORMATS): when set it
        #: overrides ``transfer_mode``; the int8 formats quantise a whole
        #: group on the engine's device (``_encode_int8_group``), the others
        #: ship through ``pack_boundary_wire``.  None keeps the legacy
        #: pack_boundary modes
        self.wire = wire
        #: host buffer the int8 codes and scales of a group are copied into,
        #: grown as needed and reused (pinned on a GPU engine)
        self._staging: Optional[torch.Tensor] = None
        # the shared decision-maker: assign() delegates here, so the
        # engine runs the exact per-request policy the simulators and
        # the fleet planner use (pass a shared Planner to keep one
        # adaptive-SLA state across engines).  solve_c_batch=cost.c_batch
        # because this engine EXECUTES groups batched (process_group):
        # the split must be sized for the batched rate
        self.planner = planner if planner is not None else Planner(
            cost, policy="variable", solve_c_batch=cost.c_batch)
        self._exec_cache: Dict[Tuple[int, int], Callable] = {}
        self.stats = _new_stats()

    # -- executable cache: one warmed program per (n_final, batch) ---------
    def _denoise_fn(self, n_cloud: int, batch: int, latent, ctx2):
        """Return the denoise callable for this key.  There is nothing to
        compile: a miss stores a plain callable and runs ONE untimed
        ``denoise_step`` at this batch as warm-up, charged to
        stats["compile_seconds"] — so process_group's timed region
        measures steady-state execution only."""
        key = (n_cloud, batch)
        cached = self._exec_cache.get(key)
        if cached is not None:
            self.stats["cache_hits"] += 1
            return cached
        self.stats["cache_misses"] += 1
        cfg = self.cfg

        def fn(params, latent, ctx2):
            return dif.denoise_range(params, cfg, latent, ctx2, 0, n_cloud)
        t0 = time.perf_counter()
        dif.denoise_step(self.params, cfg, latent, ctx2, 0)
        _sync(self.device)
        self.stats["compile_seconds"] += time.perf_counter() - t0
        self._exec_cache[key] = fn
        self.stats["executables"] = len(self._exec_cache)
        return fn

    def assign(self, device: DeviceProfile) -> int:
        """Thin delegate into the unified planner: split solve + step
        quantization (sized at ``cost.c_batch`` — see __init__), through
        the planner's memoized hot path."""
        return self.planner.plan_profile(device).n_final

    def plan(self, device: DeviceProfile):
        """Full ``PlanDecision`` for one device (JSON-serializable, with
        the explain() trace) — what assign() is a projection of."""
        return self.planner.plan(PlanRequest(device=device))

    def process_group(self, requests: List[Request], n_cloud: int,
                      seed: int = 0,
                      latent: Optional[np.ndarray] = None
                      ) -> List[SplitResult]:
        """Run one batched group at the same n_cloud.

        The starting latent is drawn from a ``torch.Generator`` seeded
        with ``seed`` on the engine's device, unless ``latent``
        (B, C, H, W) is handed in."""
        if not requests:
            return []
        cfg = self.cfg
        dev = self.device
        B = len(requests)
        shape = (B, cfg.latent_channels, cfg.latent_size, cfg.latent_size)
        with torch.inference_mode():
            cond = torch.from_numpy(np.concatenate(
                [r.cond_tokens for r in requests])).to(dev)
            uncond = torch.from_numpy(np.concatenate(
                [r.uncond_tokens for r in requests])).to(dev)
            ctx2 = dif.encode_prompt(self.params, cfg, cond, uncond)
            if latent is None:
                gen = torch.Generator(device=dev).manual_seed(seed)
                lat = torch.randn(shape, generator=gen, device=dev)
            else:
                if tuple(latent.shape) != shape:
                    raise ValueError(f"latent shape {tuple(latent.shape)} "
                                     f"!= {shape}")
                lat = torch.from_numpy(
                    np.array(latent, np.float32)).to(dev)   # own copy
            gpu_s = 0.0
            if n_cloud > 0:
                run = self._denoise_fn(n_cloud, B, lat, ctx2)  # warm first
                _sync(dev)
                t0 = time.perf_counter()
                lat = run(self.params, lat, ctx2)
                _sync(dev)
                gpu_s = time.perf_counter() - t0
            need_ctx = n_cloud < cfg.n_total_iterations
            fmt = None if self.wire is None else get_wire_format(self.wire)
            if fmt is not None and fmt.name in ("int8", "int8_zlib"):
                payloads = self._encode_int8_group(
                    lat, ctx2 if need_ctx else None, fmt)
            else:
                lat_np = lat.float().cpu().numpy()
                ctx_np = ctx2.float().cpu().numpy() if need_ctx else None
                payloads = []
                for i in range(B):
                    ctx_i = None if ctx_np is None else ctx_np[:, i]
                    payloads.append(
                        pack_boundary_wire(lat_np[i], ctx_i, fmt)
                        if fmt is not None else
                        pack_boundary(lat_np[i], ctx_i,
                                      mode=self.transfer_mode))
        results = []
        for r, payload in zip(requests, payloads):
            t_net = transmission_time(len(payload), self.link)
            results.append(SplitResult(
                request_id=r.request_id, n_cloud=n_cloud, payload=payload,
                cloud_seconds=gpu_s / B, transfer_seconds=t_net))
            self.stats["bytes_shipped"] += len(payload)
        self.stats["gpu_seconds"] += gpu_s
        self.stats["requests"] += B
        return results

    def _encode_int8_group(self, lat: torch.Tensor,
                           ctx2: Optional[torch.Tensor], fmt) -> List[bytes]:
        """Each request's payload on an int8 wire format, quantised where
        the boundary lies: the group's latent (B, C, H, W) as (B·C, H·W)
        rows and its context (2, B, L, W) as (2B, L·W) rows go through ONE
        call of ``int8_quantize_group`` (one kernel launch on a GPU), and
        its one buffer of codes and scales comes to the host in ONE copy.
        No fp32 tensor leaves the device.  Each payload is byte for byte
        ``pack_boundary_wire(latent_i, context_i, fmt)``: the same wire
        tree (``latent``, ``latent_rowscales``, ``context``,
        ``context_rowscales``) through ``transport.serialize``."""
        B, C, H, W = lat.shape
        segs = [lat.float().reshape(B * C, H * W)]
        if ctx2 is not None:
            L, Wd = ctx2.shape[2:]
            segs.append(ctx2.float().reshape(2 * B, L * Wd))
        buf = int8_quant.int8_quantize_group(segs)
        n = buf.numel()
        if self._staging is None or self._staging.numel() < n:
            self._staging = torch.empty(
                n, dtype=torch.uint8, pin_memory=self.device.type == "cuda")
        host = self._staging[:n]
        host.copy_(buf)
        parts = int8_quant.split_group(host.numpy(),
                                       [tuple(x.shape) for x in segs])
        q_lat, s_lat = parts[0]
        payloads = []
        for i in range(B):
            rows = slice(i * C, (i + 1) * C)
            tree = {"latent": q_lat[rows].reshape(C, H, W),
                    "latent_rowscales": s_lat[rows]}
            if ctx2 is not None:
                q_ctx, s_ctx = parts[1]
                pick = [i, B + i]          # the uncond and cond rows
                tree["context"] = q_ctx[pick].reshape(2, L, Wd)
                tree["context_rowscales"] = s_ctx[pick]
            payloads.append(serialize(tree, compress=fmt.compress))
        return payloads

    def serve(self, requests: List[Request], seed: int = 0
              ) -> Dict[str, SplitResult]:
        """Schedule + group + execute a batch of requests."""
        groups: Dict[int, List[Request]] = {}
        for r in requests:
            groups.setdefault(self.assign(r.device), []).append(r)
        out: Dict[str, SplitResult] = {}
        for n_cloud, members in sorted(groups.items()):
            for res in self.process_group(members, n_cloud, seed):
                out[res.request_id] = res
        return out


class DiffusionDeviceSim:
    """The mobile side: receives the payload, finishes [n_cloud, n_total)
    and decodes the VAE — on the same host, standing in for the device."""

    def __init__(self, params, cfg, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self._finish_cache: Dict[Tuple[int, int], Callable] = {}
        self.stats = _new_stats()

    def complete(self, result: SplitResult) -> torch.Tensor:
        cfg = self.cfg
        dev = self.device
        lat, ctx = unpack_boundary(result.payload)
        with torch.inference_mode():
            latent = torch.from_numpy(lat).to(dev)
            if lat.ndim == 3:
                latent = latent[None]
            n0 = result.n_cloud
            if ctx is not None:
                ctx2 = torch.from_numpy(
                    np.ascontiguousarray(ctx, np.float32)).to(dev)
                if ctx.ndim == 3:
                    ctx2 = ctx2[:, None]
            else:
                ctx2 = torch.zeros((2, latent.shape[0], cfg.text_len,
                                    cfg.text_width), dtype=torch.float32,
                                   device=dev)
            key = (n0, latent.shape[0])
            run = self._finish_cache.get(key)
            if run is None:
                self.stats["cache_misses"] += 1

                def run(params, latent, ctx2):
                    out = dif.denoise_range(params, cfg, latent, ctx2, n0,
                                            cfg.n_total_iterations)
                    return dif.apply_vae_decoder(params["vae"], cfg, out)
                # warm-up in place of a compile: one VAE decode at this
                # batch, untimed for gpu_seconds
                t0 = time.perf_counter()
                dif.apply_vae_decoder(self.params["vae"], cfg, latent)
                _sync(dev)
                self.stats["compile_seconds"] += time.perf_counter() - t0
                self._finish_cache[key] = run
                self.stats["executables"] = len(self._finish_cache)
            else:
                self.stats["cache_hits"] += 1
            _sync(dev)
            t0 = time.perf_counter()
            out = run(self.params, latent, ctx2)
            _sync(dev)
            self.stats["gpu_seconds"] += time.perf_counter() - t0
            self.stats["requests"] += latent.shape[0]
        return out


# ==========================================================================
# Layer-granularity split for LM architectures
# ==========================================================================
def _batch_key(batch: Dict[str, torch.Tensor]):
    return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                        for k, v in batch.items()))


class LayerSplitEngine:
    """Cloud side of a layer split: embed + groups [0, g), ship hidden."""

    def __init__(self, params, cfg, link: LinkProfile = WAN_LINK,
                 device: DeviceLike = None):
        #: where the model runs; ``None`` = the GPU.  ``params`` must
        #: already lie there
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.link = link
        # one warmed program per (split group, batch signature), as the
        # reference keys its shape-specialized executables
        self._exec_cache: Dict[Tuple[int, Any], Callable] = {}
        self.stats = _new_stats()

    def _run_fn(self, stop_group: int, batch):
        """The callable for this key.  A miss runs it once untimed as the
        warm-up (first-call costs: allocator growth, cuBLAS handles and
        algorithm choice, the kernels' build at the very first launch),
        charged to stats["compile_seconds"]."""
        key = (stop_group, _batch_key(batch))
        cached = self._exec_cache.get(key)
        if cached is not None:
            self.stats["cache_hits"] += 1
            return cached
        self.stats["cache_misses"] += 1
        cfg = self.cfg
        kernels = kernel_registry()

        def fn(params, batch):
            x = tr.embed_inputs(params, batch, cfg)
            positions = torch.arange(x.shape[1], device=x.device)
            return tr.run_layer_range(
                params, x, cfg, LOCAL_CTX, start_group=0,
                stop_group=stop_group, positions=positions, kernels=kernels)
        t0 = time.perf_counter()
        fn(self.params, batch)
        _sync(self.device)
        self.stats["compile_seconds"] += time.perf_counter() - t0
        self._exec_cache[key] = fn
        self.stats["executables"] = len(self._exec_cache)
        return fn

    def process(self, batch: Dict[str, np.ndarray], stop_group: int):
        """Run groups [0, stop_group) on ``batch`` ({"tokens": (B, S)}).
        Returns (hidden state as fp16 numpy (B, S, d), link seconds)."""
        with torch.inference_mode():
            tb = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                  for k, v in batch.items()}
            run = self._run_fn(stop_group, tb)
            _sync(self.device)
            t0 = time.perf_counter()
            hidden = run(self.params, tb)
            _sync(self.device)
            self.stats["gpu_seconds"] += time.perf_counter() - t0
            payload = hidden.to(torch.float16).cpu().numpy()
        self.stats["bytes_shipped"] += payload.nbytes
        self.stats["requests"] += tb["tokens"].shape[0]
        t_net = transmission_time(payload.nbytes, self.link)
        return payload, t_net


class LayerSplitDevice:
    """Device side: groups [g, G) + tail + final norm + head, on the same
    host, standing in for the device."""

    def __init__(self, params, cfg, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self._exec_cache: Dict[Tuple[int, Any], Callable] = {}
        self.stats = _new_stats()

    def complete(self, hidden_fp16: np.ndarray, start_group: int
                 ) -> torch.Tensor:
        """Finish the forward from the shipped hidden state; returns the
        last token's logits (B, 1, padded_vocab)."""
        cfg = self.cfg
        with torch.inference_mode():
            hidden = torch.from_numpy(np.asarray(hidden_fp16)).to(
                self.device).to(pdtype(cfg))
            key = (start_group, tuple(hidden.shape))
            run = self._exec_cache.get(key)
            if run is None:
                self.stats["cache_misses"] += 1
                kernels = kernel_registry()

                def run(params, hidden):
                    positions = torch.arange(hidden.shape[1],
                                             device=hidden.device)
                    x = tr.run_layer_range(
                        params, hidden, cfg, LOCAL_CTX,
                        start_group=start_group, stop_group=cfg.num_groups(),
                        positions=positions, kernels=kernels)
                    x = tr.apply_norm(params["final_norm"], x)
                    return tr.unembed(params, x[:, -1:], cfg)
                # warm-up in place of a compile: the first call, untimed
                # for gpu_seconds
                t0 = time.perf_counter()
                run(self.params, hidden)
                _sync(self.device)
                self.stats["compile_seconds"] += time.perf_counter() - t0
                self._exec_cache[key] = run
                self.stats["executables"] = len(self._exec_cache)
            else:
                self.stats["cache_hits"] += 1
            _sync(self.device)
            t0 = time.perf_counter()
            out = run(self.params, hidden)
            _sync(self.device)
            self.stats["gpu_seconds"] += time.perf_counter() - t0
            self.stats["requests"] += hidden.shape[0]
        return out
