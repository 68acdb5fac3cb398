"""Transport layer: serialization, quantized transfer, transmission model.

Replaces the paper's Python socket + ``torch.save`` stack with a
byte-exact, framework-neutral wire format:

  payload = header (manifest: json with shapes/dtypes/quant params)
          + raw little-endian buffers

and implements the paper's §7 refinements that the original leaves as
future work: fp16/int8 quantized transfer of the boundary tensors, and a
lossy (UDP-style) channel with graceful degradation (missing packets are
zero-filled — acceptable for diffusion latents, which "fail gracefully").

``TransmissionModel`` reproduces the *shape* of paper Fig 4: latency is
RTT-dominated for small tensors, bandwidth-dominated after, and grows
super-linearly once the packet count makes retransmissions likely.
"""
from __future__ import annotations

import dataclasses
import io
import json
import math
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

WIRE_VERSION = 1
HEADER_LEN_BYTES = 8


# --------------------------------------------------------------------------
# Serialization
# --------------------------------------------------------------------------
def serialize(tree: Dict[str, np.ndarray], *, compress: bool = False) -> bytes:
    """Dict of named arrays -> wire bytes.  Deterministic ordering."""
    names = sorted(tree)
    manifest = {
        "v": WIRE_VERSION,
        "compress": compress,
        "tensors": [
            {"name": n, "shape": list(tree[n].shape),
             "dtype": np.dtype(tree[n].dtype).str}
            for n in names
        ],
    }
    head = json.dumps(manifest).encode()
    buf = io.BytesIO()
    buf.write(len(head).to_bytes(HEADER_LEN_BYTES, "little"))
    buf.write(head)
    for n in names:
        raw = np.ascontiguousarray(tree[n]).tobytes()
        if compress:
            raw = zlib.compress(raw, level=1)
            buf.write(len(raw).to_bytes(HEADER_LEN_BYTES, "little"))
        buf.write(raw)
    return buf.getvalue()


def deserialize(data: bytes) -> Dict[str, np.ndarray]:
    off = HEADER_LEN_BYTES
    hlen = int.from_bytes(data[:off], "little")
    manifest = json.loads(data[off:off + hlen])
    off += hlen
    out = {}
    for spec in manifest["tensors"]:
        dt = np.dtype(spec["dtype"])
        count = int(np.prod(spec["shape"])) if spec["shape"] else 1
        if manifest.get("compress"):
            clen = int.from_bytes(data[off:off + HEADER_LEN_BYTES], "little")
            off += HEADER_LEN_BYTES
            raw = zlib.decompress(data[off:off + clen])
            off += clen
        else:
            nbytes = count * dt.itemsize
            raw = data[off:off + nbytes]
            off += nbytes
        out[spec["name"]] = np.frombuffer(raw, dt).reshape(spec["shape"]).copy()
    return out


# --------------------------------------------------------------------------
# Quantized transfer (paper §7, implemented)
# --------------------------------------------------------------------------
def quantize_fp16(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float16)


def quantize_int8(x: np.ndarray) -> Tuple[np.ndarray, float, float]:
    """Affine int8 quantization.  Returns (q, scale, zero_point)."""
    lo, hi = float(x.min()), float(x.max())
    scale = max((hi - lo) / 255.0, 1e-12)
    zp = lo
    q = np.clip(np.round((x - zp) / scale), 0, 255).astype(np.uint8)
    return q, scale, zp


def dequantize_int8(q: np.ndarray, scale: float, zp: float) -> np.ndarray:
    return q.astype(np.float32) * scale + zp


def pack_boundary(latent: np.ndarray, context: Optional[np.ndarray], *,
                  mode: str = "paper") -> bytes:
    """Pack a diffusion split payload.

    mode="paper": latent fp32 + context fp16 (paper Table 2 byte counts).
    mode="int8":  both int8-quantized (§7 refinement; ~4x smaller).
    """
    tree: Dict[str, np.ndarray] = {}
    if mode == "paper":
        tree["latent"] = latent.astype(np.float32)
        if context is not None:
            tree["context"] = context.astype(np.float16)
    elif mode == "int8":
        q, s, z = quantize_int8(latent)
        tree["latent"] = q
        tree["latent_qparams"] = np.array([s, z], np.float32)
        if context is not None:
            qc, sc, zc = quantize_int8(context)
            tree["context"] = qc
            tree["context_qparams"] = np.array([sc, zc], np.float32)
    else:
        raise ValueError(mode)
    return serialize(tree)


def unpack_boundary(data: bytes) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Decode any boundary payload (``pack_boundary`` modes and every
    ``pack_boundary_wire`` format) back to fp32 latent + context."""
    tree = _decode_tree(deserialize(data))
    return tree["latent"].astype(np.float32), tree.get("context")


# --------------------------------------------------------------------------
# Wire formats: the boundary payload encoding as a planner decision
# variable (docs/transport.md).  Each format trades bytes on the wire
# against a codec compute charge and a nominal accuracy cost; the
# planner picks the cheapest one whose accumulated error stays under the
# job's error budget.
# --------------------------------------------------------------------------
def rowwise_quantize_int8(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8: numpy reference of ``kernels/int8_quant``.

    x (T, d) -> (q (T, d) int8, scales (T, 1) f32), s = max|row|/127.
    """
    x2 = np.asarray(x, np.float32)
    s = np.maximum(np.abs(x2).max(axis=1, keepdims=True) / 127.0, 1e-12)
    q = np.clip(np.round(x2 / s), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def rowwise_dequantize_int8(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * np.asarray(scales, np.float32)


def _topk_k(size: int, rho: float) -> int:
    return max(1, int(round(rho * size)))


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """One boundary encoding.

    ``ratio`` is the planning-side bytes ratio versus the dense fp32
    payload (for ``compress`` formats it is a pinned estimate — zlib
    output is data-dependent, so only non-compressed formats have exact
    closed-form sizes).  ``error`` is the nominal per-element error in
    units of the tensor's dynamic range — the planning currency the
    error budget is spent in, not a measured distortion.
    ``codec_throughput`` is bytes of dense fp32 processed per second by
    encode+decode (inf = free cast).
    """
    name: str
    ratio: float
    error: float
    codec_throughput: float
    compress: bool = False
    rho: float = 0.0             # kept fraction (top-k sparse only)

    def codec_s(self, fp32_nbytes: float) -> float:
        if math.isinf(self.codec_throughput):
            return 0.0
        return fp32_nbytes / self.codec_throughput

    def t_wire(self, fp32_nbytes: float, bandwidth: float) -> float:
        """Transfer-time DELTA versus shipping dense fp32 (negative when
        the byte savings beat the codec charge; exactly 0.0 for fp32)."""
        return ((self.ratio - 1.0) * fp32_nbytes / bandwidth
                + self.codec_s(fp32_nbytes))


WIRE_FORMATS: Dict[str, WireFormat] = {f.name: f for f in (
    WireFormat("fp32", 1.0, 0.0, math.inf),
    WireFormat("fp16", 0.5, 4.9e-4, 8e9),
    WireFormat("int8", 0.25, 3.94e-3, 2e9),
    WireFormat("int8_zlib", 0.22, 3.94e-3, 2.5e8, compress=True),
    WireFormat("topk", 0.075, 0.25, 1e9, rho=0.05),
)}


def get_wire_format(fmt) -> WireFormat:
    if isinstance(fmt, WireFormat):
        return fmt
    try:
        return WIRE_FORMATS[fmt]
    except KeyError:
        raise ValueError(f"unknown wire format {fmt!r}") from None


@dataclasses.dataclass(frozen=True)
class WirePolicy:
    """Planner knob: which formats may be chosen, the dense fp32 size of
    the boundary payload the ratios apply to, and the error budget
    (None defers to ``JobSpec.error_budget``)."""
    formats: Tuple[str, ...] = ("fp32", "fp16", "int8", "int8_zlib", "topk")
    payload_bytes: float = 262144.0
    error_budget: Optional[float] = None

    def __post_init__(self):
        for n in self.formats:
            get_wire_format(n)

    def to_json(self) -> Dict:
        return {"formats": list(self.formats),
                "payload_bytes": self.payload_bytes,
                "error_budget": self.error_budget}

    @classmethod
    def from_json(cls, d: Dict) -> "WirePolicy":
        return cls(formats=tuple(d["formats"]),
                   payload_bytes=d["payload_bytes"],
                   error_budget=d.get("error_budget"))


def _wire_tree(tree: Dict[str, np.ndarray], fmt: WireFormat,
               rowwise=None) -> Dict[str, np.ndarray]:
    """Transform named dense tensors into the format's wire tensors."""
    out: Dict[str, np.ndarray] = {}
    if fmt.name == "fp32":
        for n, x in tree.items():
            out[n] = np.asarray(x, np.float32)
    elif fmt.name == "fp16":
        for n, x in tree.items():
            out[n] = np.asarray(x).astype(np.float16)
    elif fmt.name in ("int8", "int8_zlib"):
        quant = rowwise if rowwise is not None else rowwise_quantize_int8
        for n, x in tree.items():
            x = np.asarray(x, np.float32)
            if x.size == 0:
                out[n] = x
                continue
            rows = x.shape[0] if x.ndim >= 2 else 1
            q, s = quant(x.reshape(rows, -1))
            out[n] = np.asarray(q, np.int8).reshape(x.shape)
            out[n + "_rowscales"] = np.asarray(s, np.float32)
    elif fmt.name == "topk":
        for n, x in tree.items():
            x = np.asarray(x, np.float32)
            if x.size == 0:
                out[n] = x
                continue
            flat = x.reshape(-1)
            k = _topk_k(flat.size, fmt.rho)
            idx = np.sort(np.argpartition(np.abs(flat), -k)[-k:])
            out[n + "_topk_vals"] = flat[idx].astype(np.float16)
            out[n + "_topk_idx"] = idx.astype(np.int32)
            out[n + "_topk_shape"] = np.array(x.shape, np.int32)
    else:
        raise ValueError(fmt.name)
    return out


_WIRE_SUFFIXES = ("_rowscales", "_topk_vals", "_topk_idx", "_topk_shape",
                  "_qparams")


def _decode_tree(tree: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Reconstruct dense fp32 tensors from a wire tree (self-describing:
    each transform leaves its suffix tensors next to the base name)."""
    out: Dict[str, np.ndarray] = {}
    for n, x in tree.items():
        if n.endswith(_WIRE_SUFFIXES):
            if n.endswith("_topk_vals"):
                base = n[: -len("_topk_vals")]
                shape = tuple(int(v) for v in tree[base + "_topk_shape"])
                flat = np.zeros(int(np.prod(shape)) if shape else 1,
                                np.float32)
                flat[tree[base + "_topk_idx"]] = x.astype(np.float32)
                out[base] = flat.reshape(shape)
            continue
        if n + "_rowscales" in tree:
            rows = x.shape[0] if x.ndim >= 2 else 1
            deq = rowwise_dequantize_int8(x.reshape(rows, -1),
                                          tree[n + "_rowscales"])
            out[n] = deq.reshape(x.shape)
        elif n + "_qparams" in tree:
            s, z = tree[n + "_qparams"]
            out[n] = dequantize_int8(x, float(s), float(z))
        else:
            out[n] = np.asarray(x, np.float32)
    return out


def encode_wire(tree: Dict[str, np.ndarray], fmt,
                *, rowwise=None) -> bytes:
    """Encode named dense tensors under ``fmt``.  ``rowwise`` optionally
    injects an accelerated per-row int8 quantizer (the Pallas kernel via
    ``kernels.ops.int8_quantize``) in place of the numpy reference."""
    fmt = get_wire_format(fmt)
    return serialize(_wire_tree(tree, fmt, rowwise=rowwise),
                     compress=fmt.compress)


def decode_wire(data: bytes) -> Dict[str, np.ndarray]:
    return _decode_tree(deserialize(data))


def serialized_nbytes(specs) -> int:
    """Exact ``len(serialize(tree))`` for uncompressed trees, computed
    from (name, shape, dtype) specs alone — no tensor data needed."""
    specs = sorted(specs)
    manifest = {
        "v": WIRE_VERSION,
        "compress": False,
        "tensors": [
            {"name": n, "shape": list(shape), "dtype": np.dtype(dt).str}
            for n, shape, dt in specs
        ],
    }
    head = json.dumps(manifest).encode()
    body = sum((int(np.prod(shape)) if len(shape) else 1)
               * np.dtype(dt).itemsize for _, shape, dt in specs)
    return HEADER_LEN_BYTES + len(head) + body


def wire_shape_specs(shapes: Dict[str, Tuple[int, ...]], fmt):
    """(name, shape, dtype) specs of the wire tree for dense ``shapes``."""
    fmt = get_wire_format(fmt)
    specs = []
    for n, shape in shapes.items():
        shape = tuple(int(v) for v in shape)
        size = int(np.prod(shape)) if shape else 1
        if fmt.name == "fp32" or size == 0:
            specs.append((n, shape, np.float32))
        elif fmt.name == "fp16":
            specs.append((n, shape, np.float16))
        elif fmt.name in ("int8", "int8_zlib"):
            rows = shape[0] if len(shape) >= 2 else 1
            specs.append((n, shape, np.int8))
            specs.append((n + "_rowscales", (rows, 1), np.float32))
        elif fmt.name == "topk":
            k = _topk_k(size, fmt.rho)
            specs.append((n + "_topk_vals", (k,), np.float16))
            specs.append((n + "_topk_idx", (k,), np.int32))
            specs.append((n + "_topk_shape", (len(shape),), np.int32))
        else:
            raise ValueError(fmt.name)
    return specs


def wire_nbytes(shapes: Dict[str, Tuple[int, ...]], fmt) -> int:
    """Closed-form encoded size.  Raises for compressed formats, whose
    size is data-dependent (measure with ``len(encode_wire(...))``)."""
    fmt = get_wire_format(fmt)
    if fmt.compress:
        raise ValueError(f"{fmt.name}: size is data-dependent")
    return serialized_nbytes(wire_shape_specs(shapes, fmt))


def encoded_bytes(tree: Dict[str, np.ndarray], fmt,
                  *, rowwise=None) -> int:
    """Exact encoded size of ``tree`` under ``fmt``.  Closed-form for
    non-compressed formats (== ``len(encode_wire(...))`` by
    construction); compressed formats encode and measure."""
    fmt = get_wire_format(fmt)
    if fmt.compress:
        return len(encode_wire(tree, fmt, rowwise=rowwise))
    return serialized_nbytes(
        (n, a.shape, a.dtype)
        for n, a in _wire_tree(tree, fmt, rowwise=rowwise).items())


def pack_boundary_wire(latent: np.ndarray, context: Optional[np.ndarray],
                       fmt, *, rowwise=None) -> bytes:
    """``pack_boundary`` under an arbitrary wire format.  The payload is
    self-describing: ``unpack_boundary`` decodes any format."""
    tree: Dict[str, np.ndarray] = {"latent": latent}
    if context is not None:
        tree["context"] = context
    return encode_wire(tree, fmt, rowwise=rowwise)


# --------------------------------------------------------------------------
# Lossy channel (UDP-style) with graceful degradation
# --------------------------------------------------------------------------
def lossy_transfer(x: np.ndarray, drop_prob: float, seed: int = 0,
                   packet_elems: int = 256) -> Tuple[np.ndarray, float]:
    """Drop `packet_elems`-sized spans with prob `drop_prob`; zero-fill.

    Returns (received array, fraction of elements lost).  Diffusion latents
    tolerate this (paper §7: "generative models should fail gracefully").
    """
    flat = x.reshape(-1).copy()
    n_packets = math.ceil(flat.size / packet_elems)
    rng = np.random.default_rng(seed)
    lost = rng.random(n_packets) < drop_prob
    lost_elems = 0
    for i in np.nonzero(lost)[0]:
        a, b = i * packet_elems, min((i + 1) * packet_elems, flat.size)
        flat[a:b] = 0.0
        lost_elems += b - a
    return flat.reshape(x.shape), lost_elems / flat.size


# --------------------------------------------------------------------------
# Transmission-time model (paper Fig 4)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LinkProfile:
    name: str
    rtt: float                   # round-trip, seconds
    bandwidth: float             # bytes / second
    mtu: int = 1448              # TCP payload per packet
    loss_prob: float = 0.0       # per-packet loss probability
    retrans_penalty: float = 0.05  # seconds per retransmitted packet


# Calibrated to the paper's setups: a campus LAN and a Chicago->Iowa WAN.
LOCAL_LINK = LinkProfile("local", rtt=0.004, bandwidth=40e6, loss_prob=2e-5)
WAN_LINK = LinkProfile("gcloud-iowa", rtt=0.035, bandwidth=90e6, loss_prob=5e-6)
MOBILE_LINK = LinkProfile("mobile-5g", rtt=0.030, bandwidth=12.5e6,
                          loss_prob=1e-4)


def transmission_time(nbytes: int, link: LinkProfile) -> float:
    """Expected one-way transfer time: RTT + serialization at line rate +
    expected retransmission penalty (super-linear once packets are many)."""
    packets = math.ceil(nbytes / link.mtu)
    expected_retrans = packets * link.loss_prob
    return (link.rtt
            + nbytes / link.bandwidth
            + expected_retrans * (link.retrans_penalty + link.rtt))


def roundtrip_time(nbytes_up: int, nbytes_down: int, link: LinkProfile) -> float:
    return (transmission_time(nbytes_up, link)
            + transmission_time(nbytes_down, link))


def serde_time(nbytes: int, startup_s: float = 3e-5,
               throughput: float = 8e9) -> float:
    """Paper Fig 5: near-constant startup + memcpy-rate linear term."""
    return startup_s + nbytes / throughput
