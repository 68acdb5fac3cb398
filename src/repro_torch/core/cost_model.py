"""The paper's closed-form latency cost model (§4.3, §4.4).

End-to-end latency of a split job (iteration granularity):

    T(n_cloud) = n_cloud / (r_cloud / c_batch)
               + (n_total - n_cloud) / r_dev
               + t_network
               + k_decode / r_dev

Solving T(n_cloud) <= t_lim for the **minimum** cloud work:

    n_cloud * (c_batch/r_cloud - 1/r_dev)
        <= t_lim - t_network - (n_total + k_decode)/r_dev

NOTE (fidelity): the paper's printed closed form drops the
``n_total / r_dev`` term; re-deriving from their own latency equation gives
the expression above, and with it our 1000-device simulation reproduces
their Table 4.  See DESIGN.md §8.

The same model generalizes to layer-granularity splits (transformers,
RegNet): replace iterations with per-segment FLOPs and rates with
FLOP-throughputs — see ``solve_split_fraction``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Cloud + job constants for the iteration-granularity model.

    ``r_cloud`` is the REFERENCE cloud rate: for a heterogeneous pool
    (``core.capacity.CloudCapacity``) it is the capacity's count-weighted
    mean rate (see ``capacity.reference_params``), so every closed-form
    solve below keeps working unchanged; class-aware callers pass an
    explicit per-class ``r_cloud`` override instead.
    """
    r_cloud: float            # REFERENCE cloud diffusion rate, iterations / s
    n_total: int              # iterations needed for full quality
    n_step: int               # scheduler quantization step (groups)
    t_lim: float              # SLA: max end-to-end latency, seconds
    k_decode: float = 1.0     # t_decode = k_decode / r_dev  (paper §4.3)
    c_batch: float = 1.0      # batching slowdown of the cloud (paper §4.4)


def e2e_latency(n_cloud: float, r_dev: float, p: CostParams,
                t_network: float, c_batch: Optional[float] = None,
                r_cloud: Optional[float] = None,
                t_wire: float = 0.0) -> float:
    """T(n_cloud) for a device with rate r_dev and measured RTT.

    ``r_cloud`` overrides the reference rate with a specific GPU class's
    rate (class-aware dispatch).  ``t_wire`` is the wire-format
    transfer-time delta versus dense fp32 (``WireFormat.t_wire``:
    negative when byte savings beat the codec charge; 0.0 — the
    bit-identical default — when the wire stage is off or pinned fp32).
    """
    cb = p.c_batch if c_batch is None else c_batch
    rc = p.r_cloud if r_cloud is None else r_cloud
    return (n_cloud * cb / rc
            + (p.n_total - n_cloud) / r_dev
            + (t_network + t_wire if t_wire != 0.0 else t_network)
            + p.k_decode / r_dev)


def solve_n_cloud(r_dev: float, p: CostParams, t_network: float,
                  c_batch: Optional[float] = None,
                  r_cloud: Optional[float] = None,
                  t_wire: float = 0.0) -> float:
    """Minimum (real-valued) n_cloud with T(n_cloud) <= t_lim.

    Returns 0.0 when the device alone meets the SLA, and n_total when even
    all-cloud cannot meet it (best effort; caller may flag infeasible).
    ``r_cloud`` overrides the reference rate (class-aware variant).
    ``t_wire`` folds a wire-format transfer delta into the network term
    (0.0 default is bit-identical to the pre-wire model).

    The closed form itself lives in ``solve_n_cloud_batch`` (single source
    of truth); this scalar wrapper exists for hot single-device call sites
    and for ``solve_n_cloud_cached``.
    """
    cb = p.c_batch if c_batch is None else c_batch
    rc = p.r_cloud if r_cloud is None else r_cloud
    if t_wire != 0.0:
        t_network = t_network + t_wire
    # Scalar transcription of the batch kernel's branch structure.  Every
    # arithmetic expression below appears verbatim in solve_n_cloud_batch,
    # and a hypothesis property test pins exact (bitwise) equality of the
    # two paths over randomized grids, so the closed form cannot drift.
    denom = cb / rc - 1.0 / r_dev
    rhs = p.t_lim - t_network - (p.n_total + p.k_decode) / r_dev
    if rhs >= 0:
        return 0.0                       # local-only already meets the SLA
    if denom >= 0:
        # cloud (with batching slowdown) is not faster than the device:
        # offloading cannot reduce latency.
        return float(p.n_total)
    n = rhs / denom                      # both negative -> positive
    return min(float(p.n_total), max(0.0, n))


def solve_n_cloud_batch(r_dev, t_network, p: CostParams,
                        c_batch=None, r_cloud=None,
                        t_lim=None, k_decode=None, n_total=None,
                        t_wire=0.0):
    """Vectorized ``solve_n_cloud``: one numpy pass over whole cohorts.

    ``r_dev`` and ``t_network`` are arrays (or broadcastable scalars);
    ``c_batch``/``r_cloud``/``t_lim``/``k_decode``/``n_total`` optionally
    override the corresponding ``CostParams`` field, scalar or per-lane.
    Returns a float64 array of the same broadcast shape.

    This is the one source of truth for the closed form: the scalar
    ``solve_n_cloud`` transcribes the same expressions (identical
    operation order, so IEEE-754 makes the two paths bit-identical — a
    property test enforces it).  Degenerate edges match the scalar
    branches exactly: ``rhs >= 0`` lanes (device-only feasible) return
    0.0, ``denom >= 0`` lanes (the ``r_dev -> r_cloud/c_batch``
    crossover, where offloading cannot help) return n_total, and the 0/0
    lanes produced by evaluating the ratio everywhere are discarded by
    the selects.
    """
    cb = np.asarray(p.c_batch if c_batch is None else c_batch, np.float64)
    rc = np.asarray(p.r_cloud if r_cloud is None else r_cloud, np.float64)
    tl = np.asarray(p.t_lim if t_lim is None else t_lim, np.float64)
    kd = np.asarray(p.k_decode if k_decode is None else k_decode, np.float64)
    nt = np.asarray(p.n_total if n_total is None else n_total, np.float64)
    rd = np.asarray(r_dev, np.float64)
    tn = np.asarray(t_network, np.float64)
    if np.any(np.asarray(t_wire) != 0.0):
        tn = tn + t_wire
    denom = cb / rc - 1.0 / rd
    rhs = tl - tn - (nt + kd) / rd
    with np.errstate(divide="ignore", invalid="ignore"):
        n = rhs / denom                  # junk in lanes the selects discard
    n = np.minimum(nt, np.maximum(0.0, n))
    return np.where(rhs >= 0.0, 0.0, np.where(denom >= 0.0, nt, n))


def e2e_latency_batch(n_cloud, r_dev, p: CostParams, t_network,
                      c_batch=None, r_cloud=None, t_wire=0.0):
    """Vectorized ``e2e_latency`` (same operation order, bit-identical
    per lane).  ``t_wire`` may be a scalar or a per-lane array; the 0.0
    default leaves every lane bit-identical to the pre-wire model."""
    cb = p.c_batch if c_batch is None else c_batch
    rc = p.r_cloud if r_cloud is None else r_cloud
    n_cloud = np.asarray(n_cloud, np.float64)
    r_dev = np.asarray(r_dev, np.float64)
    tn = (t_network + t_wire if np.any(np.asarray(t_wire) != 0.0)
          else t_network)
    return (n_cloud * cb / rc
            + (p.n_total - n_cloud) / r_dev
            + tn
            + p.k_decode / r_dev)


def quantize_step_batch(n_cloud, n_step: int, n_total: int):
    """Vectorized ``quantize_step``: int64 array of step-grid round-ups.

    Exact for any realistic grid (ceil and the products stay below 2^53,
    where float64 represents integers exactly).
    """
    n_cloud = np.asarray(n_cloud, np.float64)
    q = np.minimum(float(n_total), np.ceil(n_cloud / n_step) * n_step)
    return np.where(n_cloud <= 0.0, 0.0, q).astype(np.int64)


#: Memoized ``solve_n_cloud`` for hot loops: the same closed-form root,
#: cached per (r_dev, params, t_network, c_batch, r_cloud).  CostParams
#: is frozen (hashable), so a ``set_t_lim``-style params swap is a new
#: key — stale roots can never be served.  Pure and deterministic:
#: cached and direct calls are bit-identical by construction.
solve_n_cloud_cached = functools.lru_cache(maxsize=1 << 16)(solve_n_cloud)


def quantize_step(n_cloud: float, n_step: int, n_total: int) -> int:
    """Round n_cloud up to the step grid (the grouping that enables
    batching and bounds the number of distinct compiled cloud programs).

    The paper prints ``ceil(n) + (n_step - n % n_step)`` which adds a full
    step even at exact multiples; we use the intended round-up-to-multiple.
    ``paper_quantize`` reproduces their printed formula for comparison.
    """
    if n_cloud <= 0:
        return 0
    return min(n_total, int(math.ceil(n_cloud / n_step)) * n_step)


def paper_quantize(n_cloud: float, n_step: int, n_total: int) -> int:
    if n_cloud <= 0:
        return 0
    n = math.ceil(n_cloud) + (n_step - (n_cloud % n_step))
    return min(n_total, int(n))


def cloud_gpu_time(n_cloud: float, p: CostParams,
                   batch_factor: float = 1.0,
                   r_cloud: Optional[float] = None) -> float:
    """Accelerator-seconds the cloud spends on one request.

    batch_factor: c_batch / batch_size for batched execution (e.g. 1.6/2
    when pairs run together), 1.0 when running alone.  ``r_cloud``
    overrides the reference rate with the executing class's rate.
    """
    rc = p.r_cloud if r_cloud is None else r_cloud
    return n_cloud * batch_factor / rc


def batchable(n_final: int, r_dev: float, p: CostParams, t_network: float,
              c_batch: float) -> bool:
    """Paper §4.4 intelligent-batching admission test: does the request
    still meet its SLA at the *batched* cloud rate WITHOUT extra cloud
    iterations?"""
    return e2e_latency(n_final, r_dev, p, t_network, c_batch) <= p.t_lim + 1e-9


# --------------------------------------------------------------------------
# Batching micro-model (paper §4.4): t_batch = t_startup + t_task * n_batch
# --------------------------------------------------------------------------
def fit_batch_model(batch_sizes, times):
    """Least-squares fit of (t_startup, t_task) from measured batch times."""
    n = len(batch_sizes)
    sx = sum(batch_sizes)
    sy = sum(times)
    sxx = sum(b * b for b in batch_sizes)
    sxy = sum(b * t for b, t in zip(batch_sizes, times))
    denom = n * sxx - sx * sx
    t_task = (n * sxy - sx * sy) / denom
    t_startup = (sy - t_task * sx) / n
    return t_startup, t_task


def c_batch_of(batch_size: int, t_startup: float, t_task: float) -> float:
    """Slowdown of a batch launch vs. a single launch:
    c_batch(b) = t_batch(b) / t_batch(1)."""
    return (t_startup + t_task * batch_size) / (t_startup + t_task)


@dataclasses.dataclass(frozen=True)
class BatchModel:
    """Calibrated §4.4 batching micro-model: t_batch = t_startup +
    t_task * b, fitted from REAL multi-point batch timings
    (``fit_batch_model``) instead of the single pinned batch-2
    measurement that ``c_batch_at`` extrapolates from.

    Consumers (``BatchingAdmission``, ``IntelligentBatchingScheduler``,
    the planner) fall back to the ``c_batch_at`` extrapolation when no
    model is given, so the calibrated path is strictly opt-in.
    """
    t_startup: float
    t_task: float

    def __post_init__(self):
        # t_batch must be positive at b=1 and non-decreasing in b, else
        # c_batch(b) < 1 (or negative) silently corrupts every GPU
        # service time downstream
        if self.t_startup + self.t_task <= 0:
            raise ValueError("batch model must have t_startup + t_task > 0")
        if self.t_task < 0:
            raise ValueError(
                f"fitted t_task = {self.t_task:.6g} < 0: measured batch "
                "times DECREASE with batch size — timings are too noisy "
                "or mislabeled to calibrate c_batch from")

    @classmethod
    def fit(cls, batch_sizes: Sequence[int],
            times: Sequence[float]) -> "BatchModel":
        """Least-squares fit from measured (batch_size, seconds) points."""
        if len(batch_sizes) != len(times) or len(batch_sizes) < 2:
            raise ValueError("need >= 2 (batch_size, time) measurements")
        if len(set(batch_sizes)) < 2:
            raise ValueError(
                f"all measurements are at batch size {batch_sizes[0]}: "
                "need >= 2 DISTINCT batch sizes to fit a slope")
        return cls(*fit_batch_model(list(batch_sizes), list(times)))

    @classmethod
    def from_timings(cls, timings) -> "BatchModel":
        """Build from an iterable of (batch_size, seconds) pairs — the
        ``JobSpec.batch_timings`` / ``SimConfig.batch_timings`` format."""
        pairs = [(int(b), float(t)) for b, t in timings]
        return cls.fit([b for b, _ in pairs], [t for _, t in pairs])

    def c_batch(self, batch_size: int) -> float:
        """Fitted slowdown of a batch-b launch vs. a solo launch."""
        if batch_size <= 1:
            return 1.0
        return c_batch_of(batch_size, self.t_startup, self.t_task)

    @property
    def c_batch_2(self) -> float:
        """The batch-2 slowdown (the paper's single measured constant)."""
        return self.c_batch(2)


def c_batch_at(c_batch_2: float, batch_size: int) -> float:
    """Extrapolate the batch-b slowdown from the measured batch-2 value.

    The §4.4 linear micro-model t_batch = t_startup + t_task * b gives
    c(b) = 1 + (c(2) - 1) * (b - 1); a single batch-2 measurement (the
    paper's c_batch=1.6) pins the slope.  b == 2 returns the measurement
    itself (bitwise, so batch-2 paths are unchanged by this helper).
    """
    if batch_size <= 1:
        return 1.0
    if batch_size == 2:
        return c_batch_2
    return 1.0 + (c_batch_2 - 1.0) * (batch_size - 1)


# --------------------------------------------------------------------------
# Layer-granularity generalization (transformers / RegNet)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SegmentCost:
    """Costs of one candidate split point at layer-group granularity.

    ``wire_format``/``wire_bytes``/``wire_codec_s`` describe the payload
    after wire encoding (docs/transport.md): when ``wire_bytes`` is set
    it replaces ``payload_bytes`` on the link and the codec charge is
    added; the defaults leave the pre-wire model untouched.
    """
    split_index: int          # run groups [0, split_index) on the cloud
    cloud_flops: float        # FLOPs of groups [0, split_index)
    device_flops: float       # FLOPs of groups [split_index, G] + head
    payload_bytes: int        # boundary activation (+ state) to transfer
    wire_format: str = "fp32"
    wire_bytes: Optional[float] = None   # encoded size on the wire
    wire_codec_s: float = 0.0            # quantize/dequantize charge


def segment_latency(seg: SegmentCost, cloud_flops_s: float,
                    dev_flops_s: float, rtt: float, bandwidth: float) -> float:
    nbytes = seg.payload_bytes if seg.wire_bytes is None else seg.wire_bytes
    return (seg.cloud_flops / cloud_flops_s
            + seg.device_flops / dev_flops_s
            + rtt + nbytes / bandwidth + seg.wire_codec_s)


def solve_split_fraction(segments, cloud_flops_s: float, dev_flops_s: float,
                         rtt: float, bandwidth: float, t_lim: float):
    """Pick the split with MINIMUM cloud work that satisfies the SLA.

    Returns (SegmentCost, latency) or (None, best_latency) if infeasible —
    mirroring the paper's RegNet finding: when the device is fast enough
    relative to transfer cost, the chosen split is 'all on device'
    (split_index == 0), and when nothing is feasible the caller falls back
    to all-cloud.
    """
    best = None
    best_latency = math.inf
    for seg in sorted(segments, key=lambda s: s.cloud_flops):
        lat = segment_latency(seg, cloud_flops_s, dev_flops_s, rtt, bandwidth)
        if lat < best_latency:
            best_latency = lat
        if lat <= t_lim:
            return seg, lat
    return None, best_latency
