"""Config dataclasses for every architecture the framework supports.

Every model in the zoo is described by a single frozen ``ModelConfig``.  The
same config drives:
  * parameter initialization (``models.transformer.init_params``)
  * the train/prefill/decode step functions
  * the sharding rules (``distributed.sharding``)
  * the dry-run input specs (``launch.dryrun.input_specs``)
  * the split-point registry of the paper's technique
    (``core.segmentation.layer_split_points``)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden width
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    # "tp"  = TP-within-expert (d_ff sharded over model axis; any expert count)
    # "ep"  = expert-parallel  (experts sharded over model axis; E % axis == 0)
    partitioning: str = "tp"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD / state-space duality) block hyper-params."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2                # d_inner = expand * d_model
    head_dim: int = 64             # nheads = d_inner // head_dim
    n_groups: int = 1
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RG-LRU recurrent block (RecurrentGemma / Griffin)."""
    lru_width: Optional[int] = None   # default: d_model
    d_conv: int = 4
    c_constant: float = 8.0           # the fixed "c" in a = exp(-c * softplus(L) * r)
    diag_blocks: int = 16             # block-diagonal gate projections


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB: input_specs() provides precomputed embeddings."""
    kind: str                       # "audio" | "vision"
    num_positions: int              # frames (audio) or patches (vision)
    embed_dim: int                  # embedding width fed to the backbone


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                       # dense FFN width (0 for pure-SSM)
    vocab_size: int

    head_dim: int = 0               # 0 -> d_model // num_heads
    activation: str = "swiglu"      # swiglu | gelu | relu2
    qkv_bias: bool = False
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    # Attention variant. window only used for kind == "swa" / "local".
    attention_kind: str = "full"    # full | swa
    window: int = 0

    # Heterogeneous layer pattern, repeated to cover num_layers.
    #   dense LMs: ("attn",)            mamba2: ("ssd",)
    #   recurrentgemma: ("rec", "rec", "attn")
    block_pattern: Tuple[str, ...] = ("attn",)

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None

    # Encoder-decoder: encoder_layers > 0 adds an encoder + cross attention.
    encoder_layers: int = 0
    frontend: Optional[FrontendConfig] = None

    param_dtype: str = "bfloat16"
    # Decode KV-cache storage: "bfloat16" or "int8" (per-row symmetric
    # quantization; halves the dominant decode HBM term).
    kv_cache_dtype: str = "bfloat16"
    # Max positions used to size rotary tables & sanity-check cache shapes.
    max_seq_len: int = 1 << 20

    # ---- derived -----------------------------------------------------------
    def padded_vocab(self, multiple: int = 2048) -> int:
        """Vocab rounded up so embedding/logits shard evenly over the model
        axis (MaxText-style padding; padded logit columns are masked)."""
        return ((self.vocab_size + multiple - 1) // multiple) * multiple

    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    def pattern_for_layers(self) -> Tuple[str, ...]:
        """The per-layer block kinds, block_pattern tiled over num_layers."""
        p = self.block_pattern
        reps = math.ceil(self.num_layers / len(p))
        return (p * reps)[: self.num_layers]

    def num_groups(self) -> int:
        """Number of whole pattern groups scanned over (tail is unrolled)."""
        return self.num_layers // len(self.block_pattern)

    def tail_pattern(self) -> Tuple[str, ...]:
        rem = self.num_layers % len(self.block_pattern)
        return self.block_pattern[:rem]

    def effective_kv_len(self, seq_len: int) -> int:
        """KV cache length actually materialized for decode at `seq_len`.

        Sliding-window attention only retains `window` positions; SSM blocks
        keep O(1) state so attention KV length is 0 for pure SSM models.
        """
        if all(k == "ssd" for k in self.block_pattern):
            return 0
        if self.attention_kind == "swa" and self.window:
            return min(seq_len, self.window)
        return seq_len

    def is_sub_quadratic(self) -> bool:
        """True when decode state is O(window)/O(1) — long_500k-capable."""
        kinds = set(self.pattern_for_layers())
        if kinds <= {"ssd"}:
            return True
        if self.attention_kind == "swa" and self.window:
            return True
        # hybrid: recurrent + windowed local attention
        if "rec" in kinds and self.window:
            return True
        return False

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks); used for 6ND."""
        d, hd = self.d_model, self.resolved_head_dim()
        n_q, n_kv = self.num_heads, self.num_kv_heads
        per_block = {}
        attn = d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
        if self.qkv_bias:
            attn += (n_q + 2 * n_kv) * hd
        if self.activation == "swiglu":
            ffn = 3 * d * self.d_ff
        else:
            ffn = 2 * d * self.d_ff
        per_block["attn"] = attn + ffn + 2 * d
        if self.moe is not None:
            m = self.moe
            eff = 3 if self.activation == "swiglu" else 2
            per_block["attn"] = (
                attn + d * m.num_experts
                + m.num_experts * eff * d * m.d_ff + 2 * d
            )
        if self.ssm is not None:
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            conv_dim = di + 2 * s.n_groups * s.d_state
            in_proj = d * (2 * di + 2 * s.n_groups * s.d_state + nh)
            per_block["ssd"] = (
                in_proj + conv_dim * s.d_conv + nh * 3  # A, dt_bias, D
                + di * d + d
            )
        if self.rglru is not None:
            r = self.rglru
            w = r.lru_width or d
            per_block["rec"] = (
                2 * d * w + w * r.d_conv + 3 * w  # in-projs, conv, Λ + gates(diag-ish)
                + 2 * w * w  # input/recurrence gates (w x w block-diagonal approx)
                + w * d + 2 * d
            )
        total = 0
        for kind in self.pattern_for_layers():
            total += per_block.get(kind, per_block.get("attn", 0))
        if self.encoder_layers:
            # encoder blocks (self-attn + ffn) + decoder cross-attn additions
            enc_block = attn + ffn + 2 * d
            total += self.encoder_layers * enc_block
            total += self.num_layers * (attn + d)  # cross-attn per decoder layer
        total += self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d  # lm head
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only) — for 6·N_active·D."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        eff = 3 if self.activation == "swiglu" else 2
        dead = (m.num_experts - m.top_k) * eff * self.d_model * m.d_ff
        return self.param_count() - self.num_layers * dead


# --------------------------------------------------------------------------
# Input shape-cells assigned to every LM-family architecture.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"


SHAPE_CELLS: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


def cell_by_name(name: str) -> ShapeCell:
    for c in SHAPE_CELLS:
        if c.name == name:
            return c
    raise KeyError(name)
