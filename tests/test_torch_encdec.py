"""Port parity, the encoder-decoder (seamless-m4t-medium): the parameter
tree with its encoder and cross-attention leaves, ``encode``, the
cross-attention branch of ``apply_attn_block_seq``, ``forward_hidden``
(with and without ``frontend_proj``), ``run_layer_range`` with
``enc_out``, ``build_enc_kv``, and ``prefill`` -> ``decode_step`` through
``cache["enc_kv"]``, against the reference's on
``reduced_config("seamless-m4t-medium")`` (2 encoder and 2 decoder
layers, d = 64, 8 frames of 64), a variant whose frames are 48 wide (so
the tree has ``frontend_proj``), and a variant of 3 decoder layers in a
pattern of two (so one cross-attention block sits in the tail).
Parameters are initialised in JAX and converted; tokens and frames come
from numpy.  The modality frontend of a decoder-only model (reduced
internvl2-1b, patches as wide as the model and 48 wide) is held here
too: ``embed_inputs``, ``forward_hidden``, prefill + decode after the
prefix, and the layer-split engines.  Also pinned: the reference's two
quirks that the port keeps
(its layer-split engines run the decoder without cross-attention; its
prefill projects the cross K/V twice) and where the port's attention
goes on a CUDA tensor (flash at prefill, decode attention at decode).

Tolerances as ``tests/test_torch_lm.py``: fp32 5e-5, bf16 a relative
L2 error of 3e-2 and atol 0.125 (the frameworks round bf16
intermediates at different places).
"""
import ast
import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.core.transport import LOCAL_LINK as REF_LOCAL_LINK
from repro.models import attention as ref_attn
from repro.models import transformer as ref_tr
from repro.serving import engine as ref_engine
from repro_torch.configs import reduced_config
from repro_torch import convert
from repro_torch.convert import from_jax_params
from repro_torch.core.transport import LOCAL_LINK
from repro_torch.kernels import ops
from repro_torch.models import attention
from repro_torch.models import transformer as tr
from repro_torch.serving import engine

#: the port's trees as numpy, bf16 leaves viewed as ml_dtypes' bf16
to_numpy_params = functools.partial(convert.to_numpy_params,
                                    bf16=ml_dtypes.bfloat16)

# The models here are tiny: one thread each, or the test workers that
# share a machine fight over cores inside PyTorch's thread pool.
torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
B, S = 2, 12
CHIP_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"


def _variant(cfg, name):
    if name == "proj":            # 48-wide frames: the tree has frontend_proj
        return dataclasses.replace(cfg, frontend=dataclasses.replace(
            cfg.frontend, embed_dim=48))
    if name == "tail":            # groups of two, one decoder layer as tail
        return dataclasses.replace(cfg, block_pattern=("attn", "attn"),
                                   num_layers=3)
    return cfg


VARIANTS = ("base", "proj", "tail")


@pytest.fixture(scope="module")
def models():
    """{variant: (reference cfg, reference params, port cfg, port params)},
    one JAX init per variant for the whole file."""
    out = {}
    for name in VARIANTS:
        ref_cfg = _variant(ref_reduced_config(ARCH), name)
        ref_params = ref_tr.init_params(ref_cfg, jax.random.PRNGKey(0))
        params = from_jax_params(
            jax.tree_util.tree_map(np.asarray, ref_params), "cpu")
        out[name] = (ref_cfg, ref_params, _variant(reduced_config(ARCH),
                                                   name), params)
    return out


def _model(models, name, dtype):
    ref_cfg, ref_params, cfg, params = models[name]
    if dtype == "bfloat16":
        return ref_cfg, ref_params, cfg, params
    ref_params = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32), ref_params)
    params = from_jax_params(
        jax.tree_util.tree_map(np.asarray, ref_params), "cpu")
    return (dataclasses.replace(ref_cfg, param_dtype="float32"), ref_params,
            dataclasses.replace(cfg, param_dtype="float32"), params)


def _batch(cfg, seed=1, batch=B, seq=S):
    """Tokens and fp32 frames from numpy, as numpy."""
    rng = np.random.default_rng(seed)
    f = cfg.frontend
    return {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq))
            .astype(np.int32),
            "frontend": rng.standard_normal((batch, f.num_positions,
                                             f.embed_dim)).astype(np.float32)}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=5e-5)
        return
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 3e-2, rel
    np.testing.assert_allclose(got, want, atol=0.125, rtol=0)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _chip_smoke_constants(*names):
    """Module-level constants of chip_smoke.py, read from its text."""
    found = {}
    for node in ast.parse(CHIP_SMOKE.read_text()).body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in names):
            found[node.targets[0].id] = ast.literal_eval(node.value)
    return tuple(found[n] for n in names)


def _x(cfg, dtype, shape, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


# --------------------------------------------------------------------------
# the tree
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", VARIANTS)
def test_tree_matches_the_reference(models, name):
    """The port's own initialiser draws the reference's tree on the CPU:
    the encoder's stacked blocks and final norm, the decoder blocks'
    ``xnorm``/``xwq``/``xwk``/``xwv``/``xwo``, and ``frontend_proj``
    where the frames are narrower than the model; same paths, shapes and
    dtypes, and a fan-in scale as the reference's."""
    ref_cfg, ref_params, cfg, _ = models[name]
    got = _flat(tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    want = _flat(ref_params)
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape, path
        assert got[path].device.type == "cpu"
        assert got[path].dtype == getattr(torch, str(leaf.dtype)), path
    G, E = cfg.num_groups(), cfg.encoder_layers
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim()
    assert got[("encoder", "blocks", "wq")].shape == (E, d, H, hd)
    assert ("encoder", "blocks", "xwq") not in got
    assert got[("blocks", "b0", "xwk")].shape == (G, d, H, hd)
    assert got[("blocks", "b0", "xwo")].shape == (G, H, hd, d)
    assert (("frontend_proj",) in got) == (name == "proj")
    if name == "tail":
        assert got[("tail", "t0", "xwv")].shape == (d, H, hd)
    # the same truncated normal over the same fan-in: std of ~1/sqrt(d)
    for leaf in ("xwq", "xwk", "xwv"):
        std = float(got[("blocks", "b0", leaf)].float().std())
        ref_std = float(jnp.std(ref_params["blocks"]["b0"][leaf]
                                .astype(jnp.float32)))
        assert abs(std - ref_std) < 0.2 * ref_std, leaf


def test_full_width_tree_size():
    """seamless-m4t-medium at its published width: the reference's tree
    holds 880,930,816 parameters in 1,762,115,584 bytes
    (``jax.eval_shape``; ``chip_smoke.py`` draws the port's on the card
    and checks both), while ``ModelConfig.param_count()`` says
    877,092,864 (a quirk of the reference, as for RecurrentGemma-9B and
    Mamba-2-780M)."""
    ref_cfg = ref_get_config(ARCH)
    tree = jax.eval_shape(lambda key: ref_tr.init_params(ref_cfg, key),
                          jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_leaves(tree)
    n = sum(a.size for a in leaves)
    nbytes = sum(a.size * a.dtype.itemsize for a in leaves)
    assert (n, nbytes) == _chip_smoke_constants(
        "ENCDEC_PARAMETERS", "ENCDEC_PARAMETER_BYTES") == (
        880_930_816, 1_762_115_584)
    assert ref_cfg.param_count() == 877_092_864
    assert tree["embed"].shape == (258_048, 1024)
    assert tree["encoder"]["blocks"]["wq"].shape == (12, 1024, 16, 64)
    assert tree["blocks"]["b0"]["xwq"].shape == (12, 1024, 16, 64)
    assert "frontend_proj" not in tree


@pytest.mark.parametrize("name", ["base", "proj"])
def test_convert_carries_the_encoder(models, name):
    """``from_jax_params`` and ``to_numpy_params`` carry the encoder
    subtree and the cross-attention leaves leaf for leaf, bf16 bits
    included."""
    _, ref_params, _, params = models[name]
    want = _flat(jax.tree_util.tree_map(np.asarray, ref_params))
    back = _flat(to_numpy_params(params))
    assert back.keys() == want.keys()
    assert any(p[0] == "encoder" for p in want)
    assert any(p[-1] == "xwo" for p in want)
    for path, leaf in want.items():
        assert back[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(back[path].view(np.uint8),
                                      leaf.view(np.uint8), err_msg=str(path))


# --------------------------------------------------------------------------
# the encoder and the cross-attention block
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches(models, dtype):
    ref_cfg, ref_params, cfg, params = _model(models, "base", dtype)
    f = cfg.frontend
    jx, tx = _x(cfg, dtype, (B, f.num_positions, cfg.d_model), 3)
    want = ref_tr.encode(ref_params, jx, ref_cfg, None)
    got = tr.encode(params, tx, cfg, None)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want.shape
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_block_matches(models, dtype):
    """A decoder block with ``enc_out``: self-attention, then the
    cross-attention branch (its own norm, queries from the decoder, keys
    and values from the encoder, no RoPE), then the MLP; the self
    K/V it returns for the cache too."""
    ref_cfg, ref_params, cfg, params = _model(models, "base", dtype)
    jx, tx = _x(cfg, dtype, (B, S, cfg.d_model), 4)
    je, te = _x(cfg, dtype, (B, cfg.frontend.num_positions, cfg.d_model), 5)
    bp = jax.tree_util.tree_map(lambda a: a[1], ref_params["blocks"]["b0"])
    p = tr._tree_index(params["blocks"]["b0"], 1)
    want, _, want_kv = ref_tr.apply_attn_block_seq(
        bp, jx, ref_cfg, None, positions=jnp.arange(S), enc_out=je,
        return_kv=True)
    got, aux, kv = tr.apply_attn_block_seq(
        p, tx, cfg, None, positions=torch.arange(S), enc_out=te,
        return_kv=True)
    assert aux is None
    _assert_close(got, want, dtype)
    for key in ("k", "v"):
        _assert_close(kv[key], want_kv[key], dtype)
    # the branch is there: without enc_out the block is another function
    alone, _, _ = tr.apply_attn_block_seq(p, tx, cfg, None,
                                          positions=torch.arange(S))
    assert float((alone.float() - got.float()).abs().max()) > 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["base", "proj"])
def test_forward_hidden_matches(models, name, dtype):
    """The encoder over the frames (through ``frontend_proj`` in the
    48-wide variant, whose fp32 frames meet its weights in the promoted
    type), the decoder over the tokens with cross-attention, and under
    ``return_cache`` the self K/V and ``enc_out``."""
    ref_cfg, ref_params, cfg, params = _model(models, name, dtype)
    batch = _batch(cfg, seed=6)
    want, want_aux, want_c = ref_tr.forward_hidden(
        ref_params, _jnp(batch), ref_cfg, return_cache=True)
    got, aux, caches = tr.forward_hidden(params, _torch(batch), cfg,
                                         return_cache=True)
    assert tuple(got.shape) == want.shape == (B, S, cfg.d_model)
    assert got.dtype == getattr(torch, dtype)
    _assert_close(got, want, dtype)
    np.testing.assert_array_equal(aux.numpy(), np.asarray(want_aux))
    assert set(caches) == set(want_c) == {"groups", "tail", "enc_out"}
    _assert_close(caches["enc_out"], want_c["enc_out"], dtype)
    for key in ("k", "v"):
        _assert_close(caches["groups"]["b0"][key],
                      want_c["groups"]["b0"][key], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_layer_range_with_enc_out(models, dtype):
    """The segmentation hook with ``enc_out``: the decoder split at every
    g (``[0, g)`` then ``[g, G)``) equals the whole range to the bit, and
    the whole range matches the reference's."""
    ref_cfg, ref_params, cfg, params = _model(models, "base", dtype)
    batch = _batch(cfg, seed=7)
    G = cfg.num_groups()
    enc = tr.encode(params, torch.from_numpy(batch["frontend"]).to(
        getattr(torch, dtype)), cfg, None)
    x = tr.embed_tokens(params, torch.from_numpy(batch["tokens"]), cfg)
    pos = torch.arange(S)
    whole = tr.run_layer_range(params, x, cfg, None, start_group=0,
                               stop_group=G, positions=pos, enc_out=enc,
                               kernels=ops.kernel_registry())
    for g in range(G + 1):
        y = tr.run_layer_range(params, x, cfg, None, start_group=0,
                               stop_group=g, positions=pos, enc_out=enc)
        y = tr.run_layer_range(params, y, cfg, None, start_group=g,
                               stop_group=G, positions=pos, enc_out=enc)
        assert torch.equal(y, whole), g
    want = ref_tr.run_layer_range(
        ref_params, ref_tr.embed_tokens(ref_params,
                                        jnp.asarray(batch["tokens"]),
                                        ref_cfg),
        ref_cfg, None, start_group=0, stop_group=G, positions=jnp.arange(S),
        enc_out=jnp.asarray(to_numpy_params(enc)))
    _assert_close(whole, want, dtype)


@pytest.mark.parametrize("name", ["base", "tail"])
def test_build_enc_kv_matches(models, name):
    """Per-layer cross K/V, stacked over groups like ``params["blocks"]``
    and unstacked in the tail; each group's slice is a contiguous view."""
    ref_cfg, ref_params, cfg, params = _model(models, name, "float32")
    jx, tx = _x(cfg, "float32", (B, cfg.frontend.num_positions,
                                 cfg.d_model), 8)
    want = ref_tr.build_enc_kv(ref_params, jx, ref_cfg)
    got = tr.build_enc_kv(params, tx, cfg)
    flat_w, flat_g = _flat(want), _flat(got)
    assert flat_g.keys() == flat_w.keys()
    for path, leaf in flat_w.items():
        assert tuple(flat_g[path].shape) == leaf.shape, path
        _assert_close(flat_g[path], leaf, "float32")
    G = cfg.num_groups()
    for g in range(G):
        view = tr._tree_index(got["groups"], g)["b0"]["k"]
        assert view.is_contiguous()
        assert view.data_ptr() == got["groups"]["b0"]["k"][g].data_ptr()
    assert bool(got["tail"]) == (name == "tail")


# --------------------------------------------------------------------------
# prefill + decode
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name,dtype", [("base", "float32"),
                                        ("base", "bfloat16"),
                                        ("tail", "float32")])
def test_prefill_then_decode_matches(models, name, dtype):
    """``prefill`` (the encoder, the decoder, ``build_enc_kv``,
    ``pad_kv_caches``) then 8 teacher-forced ``decode_step``s through the
    self-attention cache and the static ``enc_kv``: logits at every step,
    and the caches at the end, match the reference's."""
    ref_cfg, ref_params, cfg, params = _model(models, name, dtype)
    prompt, steps = 6, 8
    batch = _batch(cfg, seed=9, seq=prompt + steps)
    ref_b = {"tokens": jnp.asarray(batch["tokens"][:, :prompt]),
             "frontend": jnp.asarray(batch["frontend"])}
    port_b = {"tokens": torch.from_numpy(batch["tokens"][:, :prompt]),
              "frontend": torch.from_numpy(batch["frontend"])}
    want, ref_cache = ref_tr.prefill(ref_params, ref_b, ref_cfg,
                                     pad_to=prompt + steps)
    got, cache = tr.prefill(params, port_b, cfg, pad_to=prompt + steps)
    assert set(cache) == set(ref_cache) == {"groups", "tail", "enc_kv"}
    _assert_close(got[..., :cfg.vocab_size], np.asarray(
        want, np.float32)[..., :cfg.vocab_size], dtype)
    enc_kv = cache["enc_kv"]
    ref_step = jax.jit(lambda p, t, c, pos: ref_tr.decode_step(
        p, t, c, pos, ref_cfg))
    toks = batch["tokens"]
    for t in range(prompt, prompt + steps):
        want, ref_cache = ref_step(ref_params, jnp.asarray(toks[:, t:t + 1]),
                                   ref_cache, jnp.int32(t))
        got, cache = tr.decode_step(params, torch.from_numpy(
            toks[:, t:t + 1]), cache, t, cfg)
        _assert_close(got[..., :cfg.vocab_size], np.asarray(
            want, np.float32)[..., :cfg.vocab_size], dtype)
    assert cache["enc_kv"] is enc_kv
    got_flat, want_flat = _flat(cache), _flat(ref_cache)
    assert got_flat.keys() == want_flat.keys()
    for path, leaf in want_flat.items():
        _assert_close(got_flat[path], leaf, dtype)


def test_decode_reads_enc_kv_in_place(models, monkeypatch):
    """Each decoder layer's cross-attention at decode is one
    ``ops.decode_attention`` call on its group's slice of ``enc_kv``, a
    view (no copy a step), with every sequence at all S_enc rows; the
    self-attention makes the other call."""
    _, _, cfg, params = _model(models, "tail", "float32")
    batch = _batch(cfg, seed=10, seq=4)
    _, cache = tr.prefill(params, {"tokens": torch.from_numpy(
        batch["tokens"][:, :3]), "frontend": torch.from_numpy(
            batch["frontend"])}, cfg, pad_to=4)
    calls = []
    real = ops.decode_attention

    def recording(q, k, v, lengths):
        calls.append((k.data_ptr(), v.data_ptr(), lengths.tolist()))
        return real(q, k, v, lengths)
    monkeypatch.setattr(ops, "decode_attention", recording)
    tr.decode_step(params, torch.from_numpy(batch["tokens"][:, 3:4]), cache,
                   3, cfg)
    enc = cache["enc_kv"]
    S_enc = cfg.frontend.num_positions
    cross = [(enc["groups"][f"b{i}"]["k"][g].data_ptr(),
              enc["groups"][f"b{i}"]["v"][g].data_ptr(), [S_enc] * B)
             for g in range(cfg.num_groups())
             for i in range(len(cfg.block_pattern))]
    cross.append((enc["tail"]["t0"]["k"].data_ptr(),
                  enc["tail"]["t0"]["v"].data_ptr(), [S_enc] * B))
    assert calls[1::2] == cross
    assert all(c[2] == [4] * B for c in calls[0::2])


# --------------------------------------------------------------------------
# where the attention goes
# --------------------------------------------------------------------------
class _OnTheCard(torch.Tensor):
    """A CPU tensor that says it lies on the card."""

    @property
    def is_cuda(self):
        return True


def test_cross_attention_goes_to_flash_on_the_card(monkeypatch):
    """CPU tensors: ``attend`` as the reference calls it, to the bit.  A
    CUDA tensor: the flash kernel's wrapper, non-causal, no window, with
    Sq and Skv apart."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 5, 4, 16), (2, 9, 4, 16), (2, 9, 4, 16)))
    pos = torch.arange(5)
    want = attention.attend(q, k, v, q_positions=pos,
                            kv_positions=torch.arange(9), causal=False)
    assert torch.equal(attention.cross_attention(q, k, v, q_positions=pos),
                       want)
    calls = []

    def flash(q, k, v, *, causal, window):
        calls.append((tuple(q.shape), tuple(k.shape), causal, window))
        return want
    monkeypatch.setattr(ops, "flash_attention", flash)
    attention.cross_attention(q.as_subclass(_OnTheCard), k, v,
                              q_positions=pos)
    assert calls == [((2, 5, 4, 16), (2, 9, 4, 16), False, 0)]


def test_encoder_self_attention_goes_to_flash_non_causal(models,
                                                         monkeypatch):
    """On a CUDA tensor the encoder's self-attention is the flash kernel
    without the causal mask, the decoder's with it."""
    calls = []

    def self_attention(q, k, v, *, causal, window):
        calls.append(causal)
        return attention.attention_einsum(
            q, k, v, q_positions=torch.arange(q.shape[1]),
            kv_positions=torch.arange(k.shape[1]), causal=causal,
            window=window)
    monkeypatch.setattr(attention, "self_attention", self_attention)
    _, _, cfg, params = _model(models, "base", "float32")
    tr.forward_hidden(params, _torch(_batch(cfg, seed=12)), cfg)
    assert calls == [False] * cfg.encoder_layers + [True] * cfg.num_layers


# --------------------------------------------------------------------------
# quirks of the reference, kept
# --------------------------------------------------------------------------
def test_layer_split_engines_run_no_cross_attention(models):
    """The reference's ``LayerSplitEngine`` embeds a tokens-only batch and
    calls ``run_layer_range`` with no ``enc_out``, so on seamless its
    decoder runs without cross-attention (and with no encoder).  The
    port's engines do the same: their split logits match the reference
    engines' and a decoder forward without the branch, at the
    fp16-boundary tolerance, and lie far from the encoder-decoder
    forward over the same tokens."""
    ref_cfg, ref_params, cfg, params = _model(models, "base", "float32")
    batch = _batch(cfg, seed=13)
    toks = batch["tokens"]
    G = cfg.num_groups()
    ref_cloud = ref_engine.LayerSplitEngine(ref_params, ref_cfg,
                                            link=REF_LOCAL_LINK)
    ref_dev = ref_engine.LayerSplitDevice(ref_params, ref_cfg)
    cloud = engine.LayerSplitEngine(params, cfg, link=LOCAL_LINK,
                                    device="cpu")
    dev = engine.LayerSplitDevice(params, cfg, device="cpu")
    x = ref_tr.embed_tokens(ref_params, jnp.asarray(toks), ref_cfg)
    x = ref_tr.run_layer_range(ref_params, x, ref_cfg, None, start_group=0,
                               stop_group=G, positions=jnp.arange(S))
    x = ref_tr.apply_norm(ref_params["final_norm"], x)
    no_cross = np.asarray(ref_tr.unembed(ref_params, x[:, -1:], ref_cfg))
    hidden, _, _ = ref_tr.forward_hidden(ref_params, _jnp(batch), ref_cfg)
    with_cross = np.asarray(ref_tr.unembed(ref_params, hidden[:, -1:],
                                           ref_cfg))
    V = cfg.vocab_size
    for g in range(G):
        ref_payload, _ = ref_cloud.process({"tokens": toks}, g)
        payload, _ = cloud.process({"tokens": toks}, g)
        assert payload.shape == ref_payload.shape == (B, S, cfg.d_model)
        ref_got = np.asarray(ref_dev.complete(ref_payload, g), np.float32)
        got = dev.complete(payload, g).float().numpy()
        for target in (ref_got, no_cross):
            np.testing.assert_allclose(got[..., :V], target[..., :V],
                                       atol=0.15, rtol=0.1)
        assert np.abs(got[..., :V] - with_cross[..., :V]).max() > 0.3


def test_prefill_projects_the_cross_kv_twice(models, monkeypatch):
    """The reference's prefill projects each decoder layer's cross K/V
    inside the block (to attend) and again in ``build_enc_kv`` (for
    decode); the port keeps both: the K/V the blocks attend to equal
    ``enc_kv``'s to the bit, computed a second time."""
    _, _, cfg, params = _model(models, "base", "float32")
    seen, built = [], []
    real_cross, real_build = attention.cross_attention, tr.build_enc_kv

    def cross(q, k, v, *, q_positions):
        seen.append((k, v))
        return real_cross(q, k, v, q_positions=q_positions)

    def build(params, enc_out, cfg):
        built.append(len(seen))
        return real_build(params, enc_out, cfg)
    monkeypatch.setattr(attention, "cross_attention", cross)
    monkeypatch.setattr(tr, "build_enc_kv", build)
    _, cache = tr.prefill(params, _torch(_batch(cfg, seed=14)), cfg)
    G = cfg.num_groups()
    assert built == [G] and len(seen) == G
    for g, (k, v) in enumerate(seen):
        kv = cache["enc_kv"]["groups"]["b0"]
        assert torch.equal(kv["k"][g], k) and torch.equal(kv["v"][g], v)
        assert kv["k"][g].data_ptr() != k.data_ptr()

    # the reference: its blocks call attend (cross) before build_enc_kv
    ref_cfg, ref_params, _, _ = _model(models, "base", "float32")
    order = []
    real_attend, real_ref_build = ref_attn.attend, ref_tr.build_enc_kv
    monkeypatch.setattr(ref_attn, "attend", lambda *a, **kw: (
        order.append("attend"), real_attend(*a, **kw))[1])
    monkeypatch.setattr(ref_tr, "build_enc_kv", lambda *a: (
        order.append("build_enc_kv"), real_ref_build(*a))[1])
    ref_tr.prefill(ref_params, _jnp(_batch(cfg, seed=14)), ref_cfg)
    assert order[-1] == "build_enc_kv" and "attend" in order[:-1]


# --------------------------------------------------------------------------
# the modality frontend of a decoder-only model (internvl2-1b's vision
# prefix): its own init, two variants
# --------------------------------------------------------------------------
VLM = "internvl2-1b"


@pytest.fixture(scope="module")
def vlm_models():
    """{variant: fp32 (reference cfg, params, port cfg, params)} of
    reduced internvl2-1b: patches as wide as d_model (no
    ``frontend_proj``), and 48 wide (the tree has it)."""
    out = {}
    for name in ("base", "proj"):
        ref_cfg = dataclasses.replace(_variant(ref_reduced_config(VLM), name),
                                      param_dtype="float32")
        ref_params = ref_tr.init_params(ref_cfg, jax.random.PRNGKey(3))
        params = from_jax_params(
            jax.tree_util.tree_map(np.asarray, ref_params), "cpu")
        cfg = dataclasses.replace(_variant(reduced_config(VLM), name),
                                  param_dtype="float32")
        out[name] = (ref_cfg, ref_params, cfg, params)
    return out


@pytest.mark.parametrize("name", ["base", "proj"])
def test_frontend_prefix_of_decoder_only_models(vlm_models, name):
    """``embed_inputs`` prepends the patch embeddings (through
    ``frontend_proj`` when the tree has it), so ``forward_hidden`` runs
    P + S_text positions; ``prefill`` then 2 teacher-forced
    ``decode_step``s continue after the prefix.  Each matches the
    reference's at fp32 tolerance."""
    ref_cfg, ref_params, cfg, params = vlm_models[name]
    assert ("frontend_proj" in params) == (name == "proj")
    prompt, steps = 5, 2
    batch = _batch(cfg, seed=21, seq=prompt + steps)
    P = cfg.frontend.num_positions
    ref_b = {"tokens": jnp.asarray(batch["tokens"][:, :prompt]),
             "frontend": jnp.asarray(batch["frontend"])}
    port_b = {"tokens": torch.from_numpy(batch["tokens"][:, :prompt]),
              "frontend": torch.from_numpy(batch["frontend"])}
    x = tr.embed_inputs(params, port_b, cfg)
    assert x.shape == (B, P + prompt, cfg.d_model)
    _assert_close(x, ref_tr.embed_inputs(ref_params, ref_b, ref_cfg),
                  "float32")
    got, _, _ = tr.forward_hidden(params, port_b, cfg)
    want, _, _ = ref_tr.forward_hidden(ref_params, ref_b, ref_cfg)
    _assert_close(got, want, "float32")
    want, ref_cache = ref_tr.prefill(ref_params, ref_b, ref_cfg,
                                     pad_to=P + prompt + steps)
    got, cache = tr.prefill(params, port_b, cfg, pad_to=P + prompt + steps)
    V = cfg.vocab_size
    _assert_close(got[..., :V], np.asarray(want)[..., :V], "float32")
    toks = batch["tokens"]
    for t in range(prompt, prompt + steps):
        want, ref_cache = ref_tr.decode_step(
            ref_params, jnp.asarray(toks[:, t:t + 1]), ref_cache,
            jnp.int32(P + t), ref_cfg)
        got, cache = tr.decode_step(params, torch.from_numpy(
            toks[:, t:t + 1]), cache, P + t, cfg)
        _assert_close(got[..., :V], np.asarray(want)[..., :V], "float32")


def test_frontend_passes_through_the_layer_split_engines(vlm_models):
    """The cloud engine embeds the batch's patches with its tokens, as
    the reference's ``_run_fn`` does, and ships P + S_text positions; the
    device side finishes them: the last position's logits equal the
    one-machine forward's, to the wire's fp16 rounding."""
    _, _, cfg, params = vlm_models["proj"]
    batch = _batch(cfg, seed=22, seq=6)
    cloud = engine.LayerSplitEngine(params, cfg, LOCAL_LINK, device="cpu")
    device = engine.LayerSplitDevice(params, cfg, device="cpu")
    G = cfg.num_groups()
    payload, _ = cloud.process(batch, 1)
    assert payload.shape == (B, cfg.frontend.num_positions + 6, cfg.d_model)
    logits = device.complete(payload, 1)
    hidden, _, _ = tr.forward_hidden(params, _torch(batch), cfg)
    want = tr.unembed(params, hidden[:, -1:], cfg)
    assert 0 < 1 < G
    got = logits[..., :cfg.vocab_size].float()
    want = want[..., :cfg.vocab_size].float()
    rel = float((got - want).norm() / want.norm())
    assert rel < 2e-3, rel
