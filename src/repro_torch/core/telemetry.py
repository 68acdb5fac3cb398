"""Client/device telemetry: profiles, network probes, fleet generation.

The scheduler "collects information about network quality, client device
capability, and job requirements" (paper abstract).  This module is that
collection layer: devices register, report measured diffusion rates, and
the network probe keeps EWMA estimates of RTT/bandwidth per client.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class DeviceProfile:
    device_id: str
    r_dev: float                  # measured iterations/s (or FLOP/s scale)
    k_decode: float = 1.0         # decode-cost scale (paper: prop. to r_dev)
    rtt: float = 0.3              # seconds, round trip
    bandwidth: float = 12.5e6     # bytes/s (100 Mbps default)
    has_accelerator: bool = True

    def decode_time(self) -> float:
        return self.k_decode / self.r_dev


# --------------------------------------------------------------------------
# Latency statistics: one percentile definition + fixed-memory streaming
# estimators (the fleet simulator's telemetry sink at 10^6-arrival scale)
# --------------------------------------------------------------------------
def latency_percentile(values: Sequence[float], q: float) -> float:
    """THE percentile definition every exact-stats surface shares
    (``FleetSimResult.latency_percentile`` and the fleet simulator's
    per-snapshot estimates both call this, so run-level and snapshot
    percentiles can never drift apart).  ``q`` is in [0, 100] (the
    ``np.percentile`` convention); empty input returns NaN."""
    if not len(values):
        return math.nan
    return float(np.percentile(values, q))


class P2Quantile:
    """Jain & Chlamtac's P² streaming quantile estimator: tracks one
    quantile of an unbounded stream with five markers — O(1) memory and
    O(1) per observation, no stored samples.

    The first five observations are exact (they seed the markers); after
    that each ``add`` shifts the marker heights by the piecewise-
    parabolic (P²) interpolation.  Accuracy is within a fraction of a
    percent of the exact sample quantile for smooth distributions —
    see the property tests against ``np.percentile``.
    """

    __slots__ = ("q", "n", "_heights", "_pos", "_want", "_dwant")

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = q
        self.n = 0                    # observations seen
        self._heights: List[float] = []
        # marker 0 is pinned at position 1 and marker 4 at position n,
        # so only the three middle desired positions need updating
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._want = [1.0 + 2.0 * q, 1.0 + 4.0 * q, 3.0 + 2.0 * q]
        self._dwant = (q / 2.0, q, (1.0 + q) / 2.0)

    def add(self, x: float) -> None:
        n = self.n = self.n + 1
        h = self._heights
        if n <= 5:
            h.append(x)
            if n == 5:
                h.sort()
            return
        pos = self._pos
        want = self._want
        dw = self._dwant
        want[0] += dw[0]
        want[1] += dw[1]
        want[2] += dw[2]
        # find the cell and bump the marker positions above it (marker 4
        # always moves: its position is simply n)
        pos[4] += 1.0
        if x < h[2]:
            if x < h[1]:
                pos[1] += 1.0
                if x < h[0]:
                    h[0] = x
            pos[2] += 1.0
            pos[3] += 1.0
        elif x < h[3]:
            pos[3] += 1.0
        elif x >= h[4]:
            h[4] = x
        # adjust the three middle markers toward their desired positions
        # (manually unrolled over i=1,2,3: this runs once per
        # observation at 10^7-arrival scale, and the loop frame +
        # computed indices were a measurable slice of the simulator's
        # stats cost; the arithmetic is UNCHANGED — same expressions,
        # same order — so estimates are bit-identical to the loop form)
        pi = pos[1]
        d = want[0] - pi
        if (d >= 1.0 and pos[2] - pi > 1.0) \
                or (d <= -1.0 and pos[0] - pi < -1.0):
            d = 1.0 if d >= 1.0 else -1.0
            self._nudge(1, pi, d)
        pi = pos[2]
        d = want[1] - pi
        if (d >= 1.0 and pos[3] - pi > 1.0) \
                or (d <= -1.0 and pos[1] - pi < -1.0):
            d = 1.0 if d >= 1.0 else -1.0
            self._nudge(2, pi, d)
        pi = pos[3]
        d = want[2] - pi
        if (d >= 1.0 and pos[4] - pi > 1.0) \
                or (d <= -1.0 and pos[2] - pi < -1.0):
            d = 1.0 if d >= 1.0 else -1.0
            self._nudge(3, pi, d)

    def _nudge(self, i: int, pi: float, d: float) -> None:
        """Move marker ``i`` one step toward its desired position: the
        piecewise-parabolic update, with the linear fallback when the
        parabola leaves the neighbour bracket (cold path — markers move
        at most once per observation and usually not at all)."""
        h = self._heights
        pos = self._pos
        hi, lo = h[i + 1], h[i - 1]
        pn, pp = pos[i + 1], pos[i - 1]
        new = h[i] + d / (pn - pp) * (
            (pi - pp + d) * (hi - h[i]) / (pn - pi)
            + (pn - pi - d) * (h[i] - lo) / (pi - pp))
        if lo < new < hi:
            h[i] = new
        else:                         # fall back to linear interpolation
            j = i + int(d)
            h[i] = h[i] + d * (h[j] - h[i]) / (pos[j] - pi)
        pos[i] = pi + d

    def value(self) -> float:
        """Current estimate (NaN before any observation; exact while
        fewer than five observations have been seen)."""
        h = self._heights
        if not h:
            return math.nan
        if self.n < 5:
            xs = sorted(h)
            # linear-interpolated sample quantile (np.percentile default)
            rank = self.q * (len(xs) - 1)
            lo = int(rank)
            hi = min(lo + 1, len(xs) - 1)
            return xs[lo] + (rank - lo) * (xs[hi] - xs[lo])
        return h[2]

    def _knots(self) -> List[Tuple[float, float]]:
        """(cumulative probability, height) knots of this estimator's
        piecewise-linear CDF approximation — marker i sits at empirical
        rank ``(pos[i]-1)/(n-1)``.  Small streams use the exact sorted
        samples."""
        if self.n < 5:
            xs = sorted(self._heights)
            if len(xs) == 1:
                return [(0.0, xs[0]), (1.0, xs[0])]
            k = len(xs) - 1
            return [(i / k, x) for i, x in enumerate(xs)]
        n = self.n
        return [((self._pos[i] - 1.0) / (n - 1.0), self._heights[i])
                for i in range(5)]

    def merge(self, other: "P2Quantile") -> "P2Quantile":
        """Fold ``other``'s state into this estimator, as if (approximately)
        this one had seen both streams.

        Exact while the combined count is <= 5 (both sides still hold raw
        samples); beyond that the two piecewise-linear marker CDFs are
        averaged weighted by observation count and re-inverted at the P²
        marker quantiles.  Used by the v2 simulation core to fold
        per-cohort shards into the run-level stats.

        Pairwise accuracy caveat: each fold collapses the combined CDF
        back to five knots, and the linear segment under a convex CDF
        underestimates it, so inverting the averaged CDF overshoots the
        tail once shard markers spread — sequential pairwise folding
        over small heavy-tailed shards measured up to ~90 % p99 error
        (lognormal, shards of 500 observations).  Callers folding k
        shards at once should use ``merge_many``, which keeps the error
        at the single-estimator level; pairwise ``merge`` keeps its
        exact historical arithmetic (the v2 fast-lane golden pins its
        bits).
        """
        if other.q != self.q:
            raise ValueError(
                f"cannot merge P2Quantile({other.q}) into P2Quantile({self.q})")
        if other.n == 0:
            return self
        if self.n == 0:
            self.n = other.n
            self._heights = list(other._heights)
            self._pos = list(other._pos)
            self._want = list(other._want)
            return self
        n = self.n + other.n
        if n <= 5:
            self._heights = sorted(self._heights + other._heights)
            self.n = n
            return self

        # Combined CDF F(x) = (n1*F1(x) + n2*F2(x)) / (n1+n2), each Fi
        # piecewise linear through its marker knots; invert it at the five
        # marker quantiles to seed the merged marker state.
        k1, k2 = self._knots(), other._knots()
        w1 = self.n / n
        w2 = other.n / n
        xs = sorted({h for _, h in k1} | {h for _, h in k2})
        cs = [w1 * _cdf_at(k1, x) + w2 * _cdf_at(k2, x) for x in xs]
        return self._reseed(xs, cs, n)

    def merge_many(self, others: Sequence["P2Quantile"]) -> "P2Quantile":
        """One-shot k-way fold by QUANTILE-function (Vincent) averaging:
        each marker of the merged estimator is the observation-weighted
        mean of the shards' piecewise-linear quantile functions at that
        marker's cumulative probability (extremes take the true
        min-of-mins / max-of-maxes).

        Pairwise ``merge`` averages CDFs instead, which carries a
        systematic bias once shard markers spread: the linear segment
        under a convex CDF underestimates it, so inversion overshoots
        the tail (the hardening property tests measured ~30-35 % p99
        error over 8 shards of 500 observations, against ~8 % for this
        fold — at the single-estimator noise level).  Quantile
        averaging is also exactly order-insensitive (a weighted mean
        via ``math.fsum``), which is the property the multiprocess
        shard coordinator leans on."""
        live = []
        for e in others:
            if e.q != self.q:
                raise ValueError(f"cannot merge P2Quantile({e.q}) into "
                                 f"P2Quantile({self.q})")
            if e.n > 0:
                live.append(e)
        if not live:
            return self
        if self.n > 0:
            live = [self] + live
        n = sum(e.n for e in live)
        if n <= 5:                    # every contributor holds raw samples
            self._heights = sorted(h for e in live for h in e._heights)
            self.n = n
            return self
        knots = [e._knots() for e in live]
        ws = [e.n / n for e in live]
        q = self.q
        desired = (0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0)
        h = ([min(k[0][1] for k in knots)]
             + [math.fsum(w * _quantile_at(k, d)
                          for w, k in zip(ws, knots))
                for d in desired[1:4]]
             + [max(k[-1][1] for k in knots)])
        return self._seed_markers(h, n)

    def _reseed(self, xs: List[float], cs: List[float],
                n: int) -> "P2Quantile":
        """Re-seed marker state from a combined piecewise-linear CDF
        (``cs[j]`` = cumulative probability at height ``xs[j]``)."""
        q = self.q
        desired = (0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0)
        h = [_invert_cdf(xs, cs, d) for d in desired]
        return self._seed_markers(h, n)

    def _seed_markers(self, h: List[float], n: int) -> "P2Quantile":
        """Install merged marker heights: monotonize, then rebuild
        positions/desired positions consistent with count ``n``."""
        q = self.q
        desired = (0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0)
        for i in range(1, 5):
            if h[i] < h[i - 1]:
                h[i] = h[i - 1]
        pos = [1.0] + [1.0 + (n - 1.0) * d for d in desired[1:4]] + [float(n)]
        # P² needs strictly increasing marker positions with unit gaps
        for i in (1, 2, 3):
            if pos[i] < pos[i - 1] + 1.0:
                pos[i] = pos[i - 1] + 1.0
        for i in (3, 2, 1):
            if pos[i] > pos[i + 1] - 1.0:
                pos[i] = pos[i + 1] - 1.0
        self.n = n
        self._heights = h
        self._pos = pos
        # desired positions consistent with the merged count (the same
        # linear-in-n form ``add`` increments by _dwant each observation)
        self._want = [1.0 + (n - 1.0) * desired[1],
                      1.0 + (n - 1.0) * desired[2],
                      1.0 + (n - 1.0) * desired[3]]
        return self


def _cdf_at(knots: List[Tuple[float, float]], x: float) -> float:
    """Piecewise-linear CDF through ``(cum_prob, height)`` knots."""
    if x <= knots[0][1]:
        return 0.0
    if x >= knots[-1][1]:
        return 1.0
    for (p_lo, h_lo), (p_hi, h_hi) in zip(knots, knots[1:]):
        if h_lo <= x <= h_hi:
            if h_hi <= h_lo:          # zero-width (duplicate heights)
                return p_hi
            return p_lo + (p_hi - p_lo) * (x - h_lo) / (h_hi - h_lo)
    return 1.0


def _quantile_at(knots: List[Tuple[float, float]], d: float) -> float:
    """Piecewise-linear quantile function through ``(cum_prob, height)``
    knots: the height at cumulative probability ``d``."""
    if d <= knots[0][0]:
        return knots[0][1]
    for (p_lo, h_lo), (p_hi, h_hi) in zip(knots, knots[1:]):
        if d <= p_hi:
            dp = p_hi - p_lo
            if dp <= 0.0:             # duplicate cum-probs
                return h_hi
            return h_lo + (h_hi - h_lo) * (d - p_lo) / dp
    return knots[-1][1]


def _invert_cdf(xs: List[float], cs: List[float], d: float) -> float:
    """Invert a piecewise-linear CDF at cumulative probability ``d``."""
    if d <= cs[0]:
        return xs[0]
    for j in range(1, len(xs)):
        if cs[j] >= d:
            dc = cs[j] - cs[j - 1]
            if dc <= 0.0:
                return xs[j]
            return xs[j - 1] + (xs[j] - xs[j - 1]) * (d - cs[j - 1]) / dc
    return xs[-1]


class StreamingLatencyStats:
    """Fixed-memory replacement for the fleet simulator's grow-forever
    ``completed`` / latency lists: counters plus one ``P2Quantile`` per
    tracked quantile.  ``percentile(q)`` (q in [0, 100], matching
    ``latency_percentile``) answers only for tracked quantiles — the
    simulator tracks exactly what its result serializes (p50/p99 by
    default)."""

    __slots__ = ("count", "batched", "sum", "max", "_estimators",
                 "_est_tuple")

    def __init__(self, quantiles: Tuple[float, ...] = (50.0, 99.0)):
        self.count = 0
        self.batched = 0
        self.sum = 0.0
        self.max = 0.0
        self._estimators = {float(q): P2Quantile(q / 100.0)
                            for q in quantiles}
        self._est_tuple = tuple(self._estimators.values())

    def add(self, latency: float, batched: bool = False) -> None:
        self.count += 1
        if batched:
            self.batched += 1
        self.sum += latency
        if latency > self.max:
            self.max = latency
        for est in self._est_tuple:
            est.add(latency)

    def add_many(self, latencies: Sequence[float],
                 n_batched: int) -> None:
        """Bulk ``add``: a batch of latencies of which ``n_batched``
        came from batched dispatches.  Counters fold at C speed
        (sum/max builtins) and each P² estimator consumes the batch
        through one bound method — the v2 fast lane's per-chunk
        completion drain.  Estimator state after ``add_many`` equals a
        sequence of scalar ``add`` calls in the same order."""
        if not latencies:
            return
        self.count += len(latencies)
        self.batched += n_batched
        self.sum += sum(latencies)
        m = max(latencies)
        if m > self.max:
            self.max = m
        for est in self._est_tuple:
            add = est.add
            for x in latencies:
                add(x)

    def percentile(self, q: float) -> float:
        est = self._estimators.get(float(q))
        if est is None:
            raise ValueError(
                f"streaming stats track only quantiles "
                f"{sorted(self._estimators)}, not q={q}; run with "
                f"exact_stats=True for arbitrary percentiles")
        return est.value()

    def merge(self, other: "StreamingLatencyStats") -> "StreamingLatencyStats":
        """Fold another shard's counters and quantile estimators into this
        one (see ``P2Quantile.merge`` for the accuracy contract).  Both
        sides must track the same quantiles."""
        if other.quantiles() != self.quantiles():
            raise ValueError(
                f"cannot merge stats tracking {other.quantiles()} into "
                f"stats tracking {self.quantiles()}")
        self.count += other.count
        self.batched += other.batched
        self.sum += other.sum
        if other.max > self.max:
            self.max = other.max
        for q, est in self._estimators.items():
            est.merge(other._estimators[q])
        return self

    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def quantiles(self) -> List[float]:
        return sorted(self._estimators)

    @classmethod
    def merged(cls, shards: Iterable["StreamingLatencyStats"],
               quantiles: Tuple[float, ...] = (50.0, 99.0),
               kway: bool = False) -> "StreamingLatencyStats":
        """Fold shards into one fresh stats object, in the iteration
        order given.  ``merge`` is order-insensitive only within the P²
        accuracy contract (counters are exact either way), so callers
        that need reproducible percentile bits — the v2 cores, the
        multiprocess shard coordinator — must pass shards in a
        DETERMINISTIC order (shard index / cohort id), which this
        helper makes the single obvious seam for.

        ``kway=True`` folds all quantile estimators in ONE
        quantile-averaging step (``P2Quantile.merge_many``) instead of
        sequentially — tail accuracy stays at the single-estimator
        level however many shards there are, and the fold is exactly
        permutation-insensitive (weighted ``math.fsum`` mean).  The
        shard coordinator uses it; the v2 fast lane keeps the
        sequential path, whose bits its golden pins."""
        out = cls(quantiles)
        shards = list(shards)
        if kway:
            for s in shards:
                if s.quantiles() != out.quantiles():
                    raise ValueError(
                        f"cannot merge stats tracking {s.quantiles()} "
                        f"into stats tracking {out.quantiles()}")
                out.count += s.count
                out.batched += s.batched
                out.sum += s.sum
                if s.max > out.max:
                    out.max = s.max
            for q, est in out._estimators.items():
                est.merge_many([s._estimators[q] for s in shards])
            return out
        for s in shards:
            out.merge(s)
        return out


class EWMAProbe:
    """Exponentially-weighted estimate of a noisy link/device measurement."""

    def __init__(self, alpha: float = 0.3, initial: Optional[float] = None):
        self.alpha = alpha
        self.value = initial
        self.n_samples = 0

    def update(self, sample: float) -> float:
        if self.value is None:
            self.value = float(sample)
        else:
            self.value = self.alpha * float(sample) + (1 - self.alpha) * self.value
        self.n_samples += 1
        return self.value


class ClientRegistry:
    """Registry of connected clients with live telemetry."""

    def __init__(self):
        self._profiles: Dict[str, DeviceProfile] = {}
        self._rtt: Dict[str, EWMAProbe] = {}
        self._rate: Dict[str, EWMAProbe] = {}

    def register(self, profile: DeviceProfile) -> None:
        self._profiles[profile.device_id] = profile
        self._rtt[profile.device_id] = EWMAProbe(initial=profile.rtt)
        self._rate[profile.device_id] = EWMAProbe(initial=profile.r_dev)

    def report_rtt(self, device_id: str, rtt: float) -> None:
        self._rtt[device_id].update(rtt)

    def report_rate(self, device_id: str, r_dev: float) -> None:
        self._rate[device_id].update(r_dev)

    def profile(self, device_id: str) -> DeviceProfile:
        p = self._profiles[device_id]
        return dataclasses.replace(
            p, rtt=self._rtt[device_id].value, r_dev=self._rate[device_id].value)

    def all_profiles(self) -> List[DeviceProfile]:
        return [self.profile(d) for d in self._profiles]

    def __len__(self) -> int:
        return len(self._profiles)


# --------------------------------------------------------------------------
# Fleet generation (paper §5.4: N(2.25, 0.28) over 1000 devices, §5.6
# projections with upgraded fleets)
# --------------------------------------------------------------------------
def generate_fleet(n: int, mean: float, std: float, seed: int = 0,
                   rtt: float = 0.3, k_decode: float = 1.0,
                   prefix: str = "dev") -> List[DeviceProfile]:
    rng = np.random.default_rng(seed)
    rates = rng.normal(mean, std, size=n)
    rates = np.clip(rates, 0.05, None)       # no negative/zero rates
    return [
        DeviceProfile(device_id=f"{prefix}{i}", r_dev=float(r),
                      k_decode=k_decode, rtt=rtt)
        for i, r in enumerate(rates)
    ]


# --------------------------------------------------------------------------
# Arrival processes (fleet simulator): all three are implemented by
# THINNING a master homogeneous Poisson process at the peak rate.
# NESTING across rates — a lower-rate stream being a subset of a
# higher-rate one — holds ONLY for ``poisson_arrivals`` with a shared
# (seed, max_rate): then the master stream and per-point accept draws
# are identical and raising the rate only ADDS arrivals.  The
# monotonicity property tests rely on that coupling; bursty/diurnal
# streams have rate-dependent masters and are NOT nested.
# --------------------------------------------------------------------------
def _thinned_arrivals(peak_rate: float, duration: float, seed: int,
                      accept_prob) -> Iterator[float]:
    """Yield arrival times t with P(keep master point at t) =
    accept_prob(t) in [0, 1]."""
    if peak_rate <= 0:
        return                           # zero rate: empty stream
    rng = np.random.default_rng(seed)
    # bound fast-path draws: standard_exponential() * scale and random()
    # consume the bit stream exactly like exponential(scale) / uniform()
    # (bit-identical values, ~1us less per arrival at fleet rates)
    exp = rng.standard_exponential
    unif = rng.random
    scale = 1.0 / peak_rate
    t = 0.0
    while True:
        t += exp() * scale
        u = unif()                    # always drawn: keeps streams coupled
        if t >= duration:
            return
        if u <= accept_prob(t):
            yield t


def poisson_arrivals(rate: float, duration: float, seed: int = 0,
                     max_rate: Optional[float] = None) -> Iterator[float]:
    """Homogeneous Poisson arrivals at ``rate`` over [0, duration).

    ``max_rate``: thin from a master process at this rate instead of
    ``rate`` itself, so streams with equal (seed, max_rate) are nested
    across different ``rate`` values.
    """
    peak = max_rate if max_rate is not None else rate
    if rate > peak + 1e-12:
        raise ValueError(f"rate {rate} exceeds max_rate {peak}")
    frac = rate / peak if peak > 0 else 0.0
    return _thinned_arrivals(peak, duration, seed, lambda t: frac)


def _bursty_rates(rate: float, burst_factor: float,
                  on_fraction: float) -> Tuple[float, float]:
    """(high, low) phase rates of the on/off process — shared by the
    per-event and block generators so their validation and modulation
    cannot drift apart."""
    if not 0.0 < on_fraction < 1.0:
        raise ValueError("on_fraction must be in (0, 1)")
    if burst_factor * on_fraction > 1.0:
        # the off-phase rate would have to go negative to preserve the
        # mean — refuse rather than silently exceed `rate`
        raise ValueError(
            f"burst_factor * on_fraction = {burst_factor * on_fraction:.2f} "
            f"> 1: bursts alone exceed the requested mean rate")
    high = burst_factor * rate
    low = rate * (1.0 - on_fraction * burst_factor) / (1.0 - on_fraction)
    return high, low


def bursty_arrivals(rate: float, duration: float, seed: int = 0,
                    burst_factor: float = 4.0, on_fraction: float = 0.2,
                    cycle_s: float = 60.0) -> Iterator[float]:
    """On/off (flash-crowd) modulated Poisson with mean ``rate``: for the
    first ``on_fraction`` of each cycle the rate is ``burst_factor * rate``,
    the remainder runs at the complementary low rate."""
    high, low = _bursty_rates(rate, burst_factor, on_fraction)

    def lam(t):
        return high if (t % cycle_s) < on_fraction * cycle_s else low
    peak = max(high, low)
    return _thinned_arrivals(peak, duration, seed,
                             lambda t: lam(t) / peak if peak > 0 else 0.0)


def diurnal_arrivals(rate: float, duration: float, seed: int = 0,
                     period_s: float = 86400.0,
                     amplitude: float = 0.8) -> Iterator[float]:
    """Inhomogeneous Poisson with a day-night sinusoid:
    lambda(t) = rate * (1 + amplitude * sin(2 pi t / period))."""
    if not 0.0 <= amplitude <= 1.0:
        raise ValueError("amplitude must be in [0, 1]")
    peak = rate * (1.0 + amplitude)

    def prob(t):
        lam = rate * (1.0 + amplitude * math.sin(2.0 * math.pi * t / period_s))
        return lam / peak if peak > 0 else 0.0
    return _thinned_arrivals(peak, duration, seed, prob)


# --------------------------------------------------------------------------
# Block-vectorized arrival generation (v2 simulation core): same thinning
# construction, but drawn and filtered in numpy blocks.  NOT
# stream-identical to the per-event generators for the same seed — a
# block draws `block` exponentials then `block` uniforms, while the
# scalar path interleaves them — so the v2 core documents its own rng
# stream (docs/sim_core_v2.md) and pins its own baseline.
# --------------------------------------------------------------------------
def _thinned_arrival_blocks(peak_rate: float, duration: float, seed: int,
                            accept_prob, block: int = 16384
                            ) -> Iterator[np.ndarray]:
    """Yield float64 arrays of accepted arrival times (ascending across
    and within blocks; possibly empty) until ``duration`` is exceeded.
    ``accept_prob`` maps a time array to per-point keep probabilities
    (scalar or array)."""
    if peak_rate <= 0 or duration <= 0:
        return
    rng = np.random.default_rng(seed)
    scale = 1.0 / peak_rate
    t0 = 0.0
    while True:
        times = t0 + np.cumsum(rng.standard_exponential(block) * scale)
        keep = rng.random(block) <= accept_prob(times)
        if times[-1] >= duration:
            yield times[keep & (times < duration)]
            return
        yield times[keep]
        t0 = float(times[-1])


def poisson_arrival_blocks(rate: float, duration: float, seed: int = 0,
                           max_rate: Optional[float] = None,
                           block: int = 16384) -> Iterator[np.ndarray]:
    """Block form of ``poisson_arrivals`` (see rng caveat above)."""
    peak = max_rate if max_rate is not None else rate
    if rate > peak + 1e-12:
        raise ValueError(f"rate {rate} exceeds max_rate {peak}")
    frac = rate / peak if peak > 0 else 0.0
    return _thinned_arrival_blocks(peak, duration, seed,
                                   lambda t: frac, block)


def bursty_arrival_blocks(rate: float, duration: float, seed: int = 0,
                          burst_factor: float = 4.0, on_fraction: float = 0.2,
                          cycle_s: float = 60.0,
                          block: int = 16384) -> Iterator[np.ndarray]:
    """Block form of ``bursty_arrivals`` (see rng caveat above)."""
    high, low = _bursty_rates(rate, burst_factor, on_fraction)
    peak = max(high, low)

    def prob(ts):
        lam = np.where(np.mod(ts, cycle_s) < on_fraction * cycle_s, high, low)
        return lam / peak
    return _thinned_arrival_blocks(peak, duration, seed, prob, block)


def diurnal_arrival_blocks(rate: float, duration: float, seed: int = 0,
                           period_s: float = 86400.0, amplitude: float = 0.8,
                           block: int = 16384) -> Iterator[np.ndarray]:
    """Block form of ``diurnal_arrivals`` (see rng caveat above)."""
    if not 0.0 <= amplitude <= 1.0:
        raise ValueError("amplitude must be in [0, 1]")
    peak = rate * (1.0 + amplitude)

    def prob(ts):
        lam = rate * (1.0 + amplitude * np.sin(2.0 * math.pi * ts / period_s))
        return lam / peak
    return _thinned_arrival_blocks(peak, duration, seed, prob, block)


# --------------------------------------------------------------------------
# Per-request device sampling (which device does the next request come
# from?)
# --------------------------------------------------------------------------
def fleet_sampler(fleet: List[DeviceProfile], seed: int = 0,
                  mode: str = "cycle") -> Iterator[DeviceProfile]:
    """Yield one DeviceProfile per request from a fixed fleet.

    mode "cycle":   deterministic round-robin — after k*len(fleet)
                    requests the empirical device mix EQUALS the fleet
                    mix, which is what makes the simulator's steady-state
                    GPU-seconds converge tightly to the static Table-4
                    totals.
    mode "uniform": iid with replacement (the production-realistic mix).
    """
    if not fleet:
        raise ValueError("empty fleet")
    if mode == "cycle":
        # C-level round-robin (identical sequence to indexing fleet[i %
        # len(fleet)] forever, ~4x less per-arrival overhead)
        yield from itertools.cycle(fleet)
    elif mode == "uniform":
        rng = np.random.default_rng(seed)
        while True:
            yield fleet[int(rng.integers(len(fleet)))]
    else:
        raise ValueError(f"unknown sampling mode {mode!r}")


def upgrade_fleet(fleet: Iterable[DeviceProfile], fraction: float,
                  new_mean: float, new_std: float, seed: int = 1,
                  eligible=None) -> List[DeviceProfile]:
    """Paper §5.6: `fraction` of (eligible) users upgrade to a newer device
    whose rate is drawn from N(new_mean, new_std)."""
    fleet = list(fleet)
    rng = np.random.default_rng(seed)
    out = []
    for p in fleet:
        if (eligible is None or eligible(p)) and rng.random() < fraction:
            r = float(np.clip(rng.normal(new_mean, new_std), 0.05, None))
            out.append(dataclasses.replace(p, r_dev=r))
        else:
            out.append(p)
    return out
