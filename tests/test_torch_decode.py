"""Port parity, decode: the KV caches of ``models/attention.py`` and
``prefill`` -> ``pad_kv_caches`` -> ``decode_step`` of
``models/transformer.py`` against the reference's, on reduced Qwen2-7B
(dense GQA, also with two kv heads), h2o-danube-1.8b (sliding window:
ring cache, and a linear cache past the window), RecurrentGemma-9B (RG-LRU
state, tail layers, window) and Mamba-2-780M (SSD state), and an int8
cache.  Parameters are initialised in JAX and converted; tokens come from
numpy.  The reference's ``decode_step`` is jitted (position traced) so
that the ring test's 36 steps compile once.

Tolerances as ``tests/test_torch_lm.py``: fp32 5e-5 (summation order),
bf16 a relative L2 error of 3e-2 and atol 0.125 (the frameworks round
bf16 intermediates at different places).  int8 codes and scales of the
cache helpers are bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import attention as ref_attn
from repro.models import transformer as ref_tr
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs import regnet_y_128gf, stable_diffusion_v1
from repro_torch.convert import from_jax_params, to_numpy_params
from repro_torch.models import (attention, common, diffusion, mlp, moe,
                                regnet, rglru, ssd)
from repro_torch.models import transformer as tr

# The models here are tiny: one thread each, or the test workers that
# share a machine fight over cores inside PyTorch's thread pool.
torch.set_num_threads(1)

B = 2
MODELS = {
    "qwen2-7b": {},
    "qwen2-7b-kv2": {"num_kv_heads": 2},
    "h2o-danube-1.8b": {},
    "recurrentgemma-9b": {},
    "mamba2-780m": {},
}
# (prompt length, cache length after pad_to, decode steps): the SWA
# models' prompts pass their window of 32, so decode reads a window inside
# a longer linear cache; Mamba-2's prompt is a whole number of its chunks
PLAN = {"qwen2-7b": (16, 24, 4), "qwen2-7b-kv2": (16, 24, 4),
        "h2o-danube-1.8b": (40, 48, 4), "recurrentgemma-9b": (40, 48, 4),
        "mamba2-780m": (32, 0, 3)}


def _arch(name):
    return name[:-len("-kv2")] if name.endswith("-kv2") else name


@pytest.fixture(scope="module")
def models():
    """{name: (reference cfg, reference params, port cfg, port params)},
    one JAX init per model for the whole file."""
    out = {}
    for name, change in MODELS.items():
        ref_cfg = dataclasses.replace(ref_reduced_config(_arch(name)),
                                      **change)
        cfg = dataclasses.replace(reduced_config(_arch(name)), **change)
        ref_params = ref_tr.init_params(ref_cfg, jax.random.PRNGKey(0))
        params = from_jax_params(
            jax.tree_util.tree_map(np.asarray, ref_params), "cpu")
        out[name] = (ref_cfg, ref_params, cfg, params)
    return out


def _model(models, name, dtype, **change):
    ref_cfg, ref_params, cfg, params = models[name]
    if dtype == "float32":
        ref_params = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32), ref_params)
        params = from_jax_params(
            jax.tree_util.tree_map(np.asarray, ref_params), "cpu")
        change = dict(change, param_dtype="float32")
    return (dataclasses.replace(ref_cfg, **change), ref_params,
            dataclasses.replace(cfg, **change), params)


def _tokens(cfg, n, seed=1, batch=B):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, n)).astype(np.int32)


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


def _ref_step(cfg):
    """The reference's decode_step, jitted once per config."""
    return jax.jit(lambda p, t, c, pos: ref_tr.decode_step(p, t, c, pos, cfg))


def _valid(logits, cfg):
    return np.asarray(logits, np.float32)[..., :cfg.vocab_size]


# --------------------------------------------------------------------------
# the KV-cache helpers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("quantized", [False, True])
def test_init_kv_cache_matches(quantized):
    want = ref_attn.init_kv_cache(2, 7, 3, 16, jnp.bfloat16,
                                  quantized=quantized)
    got = attention.init_kv_cache(2, 7, 3, 16, torch.bfloat16,
                                  quantized=quantized, device="cpu")
    want, got = _flat(want), _flat(to_numpy_params(got))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(got[path], np.asarray(leaf))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_is_bit_equal(dtype):
    """Codes and scales equal to the bit, zero rows and exact .5 ties
    included (both round half to even)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 9, 2, 32)).astype(np.float32) * 4
    x[0, 0] = 0.0
    x[1, 1, 0] = np.arange(32) - 15.5          # scale 16.5/127: ties
    x[1, 1, 1] = (np.arange(32) % 8) + 0.5
    x[1, 1, 1, 0] = 127.0                      # scale 1: every .5 a tie
    xj = jnp.asarray(x, getattr(jnp, dtype))
    wq, ws = ref_attn._quantize_rows(xj)
    gq, gs = attention._quantize_rows(
        torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
            getattr(torch, dtype)))
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy().view(np.int32),
                                  np.asarray(ws).view(np.int32))
    kd, vd = attention.dequantize_cache(
        {"k": gq, "v": gq, "k_scale": gs, "v_scale": gs})
    wk, _ = ref_attn.dequantize_cache(
        {"k": wq, "v": wq, "k_scale": ws, "v_scale": ws})
    np.testing.assert_array_equal(kd.numpy(), np.asarray(wk))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("ring", [False, True])
def test_cache_updates_match(quantized, ring):
    """Ten steps written at ``position`` (linear) or ``position % W``
    (ring, W = 4, so it wraps twice): the caches equal the reference's to
    the bit, and the port's dict is the one passed in, updated in place."""
    rng = np.random.default_rng(6)
    S = 4 if ring else 10
    want = ref_attn.init_kv_cache(2, S, 3, 16, jnp.float32,
                                  quantized=quantized)
    got = attention.init_kv_cache(2, S, 3, 16, torch.float32,
                                  quantized=quantized, device="cpu")
    update = "cache_update_ring" if ring else "cache_update_linear"
    for pos in range(10):
        k = rng.standard_normal((2, 1, 3, 16)).astype(np.float32)
        v = rng.standard_normal((2, 1, 3, 16)).astype(np.float32)
        want = getattr(ref_attn, update)(want, jnp.asarray(k),
                                         jnp.asarray(v), jnp.int32(pos))
        same = getattr(attention, update)(got, torch.from_numpy(k),
                                          torch.from_numpy(v), pos)
        assert same is got
    want, got = _flat(want), _flat(to_numpy_params(got))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], np.asarray(leaf))


def test_cache_write_past_the_end_raises():
    """The reference's dynamic_update_slice clamps such a write onto the
    last row; the port refuses it."""
    cache = attention.init_kv_cache(1, 4, 1, 8, torch.float32, device="cpu")
    row = torch.zeros((1, 1, 1, 8))
    with pytest.raises(ValueError, match="outside"):
        attention.cache_update_linear(cache, row, row, 4)


@pytest.mark.parametrize("window,position", [(8, 0), (8, 5), (8, 7),
                                             (8, 8), (8, 21), (5, 1000)])
def test_ring_positions_match(window, position):
    want_pos, want_ok = ref_attn.ring_positions(window, jnp.int32(position))
    pos, ok = attention.ring_positions(window, position)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))


# --------------------------------------------------------------------------
# cache trees
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_init_decode_cache_matches(models, name, kv_dtype):
    ref_cfg, _, cfg, _ = _model(models, name, "bfloat16",
                                kv_cache_dtype=kv_dtype)
    want = _flat(jax.tree_util.tree_map(
        np.asarray, ref_tr.init_decode_cache(ref_cfg, 3, 40)))
    got = _flat(to_numpy_params(tr.init_decode_cache(cfg, 3, 40,
                                                     device="cpu")))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "h2o-danube-1.8b"])
def test_prefill_and_pad_kv_caches_match(models, name):
    """The prefill cache tree padded to 48 rows: same keys, shapes and
    dtypes as the reference's, values within fp32 tolerance and zero in
    the padding."""
    ref_cfg, ref_params, cfg, params = _model(models, name, "float32")
    toks = _tokens(cfg, 40, seed=2)
    want_l, want = ref_tr.prefill(ref_params, {"tokens": jnp.asarray(toks)},
                                  ref_cfg, pad_to=48)
    got_l, got = tr.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg,
                            pad_to=48)
    _assert_close(got_l, want_l, "float32")
    want = _flat(jax.tree_util.tree_map(np.asarray, want))
    got = _flat(to_numpy_params(got))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert got[path].shape == leaf.shape and got[path].dtype == leaf.dtype
        np.testing.assert_allclose(got[path], leaf, atol=5e-5, rtol=5e-5,
                                   err_msg=str(path))
        if path[-1] in ("k", "v"):
            assert not got[path][..., 40:, :, :].any()


def test_pad_kv_caches_leaves_the_rest():
    """Only {k, v} dicts grow (stacked or not); states and a cache already
    long enough are left as they are."""
    k = torch.ones((2, 1, 3, 1, 4))
    state = {"h": torch.ones((2, 1, 5))}
    out = tr.pad_kv_caches({"groups": {"b0": {"k": k, "v": k}, "b1": state},
                            "tail": {"t0": {"k": k[0], "v": k[0]}}}, 5)
    assert out["groups"]["b0"]["k"].shape == (2, 1, 5, 1, 4)
    assert out["tail"]["t0"]["v"].shape == (1, 5, 1, 4)
    assert float(out["groups"]["b0"]["k"].sum()) == 2 * 3 * 4
    assert out["groups"]["b1"]["h"] is state["h"]
    same = tr.pad_kv_caches({"groups": {"b0": {"k": k, "v": k}}}, 2)
    assert same["groups"]["b0"]["k"] is k


def test_full_width_qwen2_tree_and_cache_shapes():
    """Qwen2-7B at its published width: the reference's tree holds
    7,626,626,560 parameters in 15,253,919,744 bytes (``chip_smoke.py``
    draws the port's on the card and checks the same two numbers), and the
    port's decode cache for 8 sequences of 4160 tokens has the reference's
    leaves: 28 layers of bf16 k and v, 1,908,408,320 bytes."""
    ref_cfg, cfg = ref_get_config("qwen2-7b"), get_config("qwen2-7b")
    tree = jax.eval_shape(lambda key: ref_tr.init_params(ref_cfg, key),
                          jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_leaves(tree)
    assert sum(a.size for a in leaves) == 7_626_626_560
    assert sum(a.size * a.dtype.itemsize for a in leaves) == 15_253_919_744
    assert tree["embed"].shape == (153_600, 3584)
    assert tree["lm_head"].shape == (3584, 153_600)
    want = _flat(jax.eval_shape(lambda: ref_tr.init_decode_cache(ref_cfg, 8,
                                                                 4160)))
    got = _flat(tr.init_decode_cache(cfg, 8, 4160, device="meta"))
    assert got.keys() == want.keys() == {("groups", "b0", "k"),
                                         ("groups", "b0", "v")}
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape == (28, 8, 4160, 4, 128)
        assert got[path].dtype == torch.bfloat16 == getattr(torch,
                                                            str(leaf.dtype))
    assert sum(t.numel() * t.element_size()
               for t in got.values()) == 1_908_408_320


def test_state_initialisers_default_to_the_gpu(monkeypatch):
    """``device=None`` means the GPU: on a host without one, each raises
    instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rg, mamba = reduced_config("recurrentgemma-9b"), reduced_config(
        "mamba2-780m")
    for call in (lambda: tr.init_decode_cache(reduced_config("qwen2-7b"), 1,
                                              8),
                 lambda: rglru.init_rglru_state(1, rg),
                 lambda: ssd.init_ssd_state(1, mamba),
                 lambda: attention.init_kv_cache(1, 8, 1, 16,
                                                 torch.bfloat16)):
        with pytest.raises(RuntimeError, match="CUDA device is required"):
            call()
    assert rglru.init_rglru_state(1, rg, device="cpu")["h"].device.type == (
        "cpu")


def _initialisers():
    """Every public initialiser below the ``init_params``, as a call
    that takes the ``device`` keyword or nothing."""
    qwen, rg, mamba = (reduced_config(a) for a in (
        "qwen2-7b", "recurrentgemma-9b", "mamba2-780m"))
    sd = stable_diffusion_v1.reduced()

    def gen():
        return torch.Generator().manual_seed(0)
    return {
        "common.init_norm": lambda **kw: common.init_norm(qwen, 16, **kw),
        "common.rope_frequencies": lambda **kw: common.rope_frequencies(
            16, 10_000.0, **kw),
        "common.dense_init": lambda **kw: common.dense_init(
            gen(), (4, 8), torch.bfloat16, **kw),
        "common.embed_init": lambda **kw: common.embed_init(
            gen(), (4, 8), torch.bfloat16, **kw),
        "mlp.init_mlp": lambda **kw: mlp.init_mlp(gen(), qwen, **kw),
        "rglru.init_rglru_block": lambda **kw: rglru.init_rglru_block(
            gen(), rg, **kw),
        "ssd.init_ssd_block": lambda **kw: ssd.init_ssd_block(gen(), mamba,
                                                              **kw),
        "moe.init_moe": lambda **kw: moe.init_moe(gen(), qwen, **kw),
        "transformer.init_attn_block": lambda **kw: tr.init_attn_block(
            gen(), qwen, **kw),
        "transformer.init_block": lambda **kw: tr.init_block(
            "rec", gen(), rg, **kw),
        "diffusion.init_ln": lambda **kw: diffusion.init_ln(8, **kw),
        "diffusion.init_gn": lambda **kw: diffusion.init_gn(8, **kw),
        "diffusion.init_text_encoder": lambda **kw:
            diffusion.init_text_encoder(sd, gen(), **kw),
        "diffusion.init_resblock": lambda **kw: diffusion.init_resblock(
            gen(), 4, 8, 16, **kw),
        "diffusion.init_xattn": lambda **kw: diffusion.init_xattn(
            gen(), 8, 16, 2, **kw),
        "diffusion.init_unet": lambda **kw: diffusion.init_unet(sd, gen(),
                                                                **kw),
        "diffusion.init_vae_decoder": lambda **kw:
            diffusion.init_vae_decoder(sd, gen(), **kw),
        "regnet.init_conv": lambda **kw: regnet.init_conv(gen(), 4, 8, 3,
                                                          **kw),
        "regnet.init_bn": lambda **kw: regnet.init_bn(8, **kw),
        "regnet.init_yblock": lambda **kw: regnet.init_yblock(
            gen(), 8, 16, 2, 8, 0.25, **kw),
        "regnet.init_params": lambda **kw: regnet.init_params(
            regnet_y_128gf.reduced(), gen(), **kw),
    }


@pytest.mark.parametrize("name", list(_initialisers()))
def test_initialisers_default_to_the_gpu(name, monkeypatch):
    """Called without a device, each initialiser asks for the GPU and
    raises on a host without one; with ``device="cpu"`` every tensor it
    returns lies on the CPU."""
    call = _initialisers()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        call()
    if name == "moe.init_moe":
        with pytest.raises(NotImplementedError):   # not ported yet (A5)
            call(device="cpu")
        return
    out = call(device="cpu")
    leaves = [out] if isinstance(out, torch.Tensor) else _leaves(out)
    assert leaves and all(t.device.type == "cpu" for t in leaves)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


# --------------------------------------------------------------------------
# prefill + decode
# --------------------------------------------------------------------------
def _decode_both(models, name, dtype, **change):
    """Prefill the prompt of PLAN[name] on both sides, then decode its
    steps teacher-forced; returns both sides' logits at each step and
    both final caches."""
    ref_cfg, ref_params, cfg, params = _model(models, name, dtype, **change)
    S, pad, steps = PLAN[name]
    toks = _tokens(cfg, S + steps)
    want_l, want_c = ref_tr.prefill(
        ref_params, {"tokens": jnp.asarray(toks[:, :S])}, ref_cfg,
        pad_to=pad)
    got_l, got_c = tr.prefill(params, {"tokens": torch.from_numpy(
        toks[:, :S])}, cfg, pad_to=pad)
    pairs = [(got_l, want_l)]
    step = _ref_step(ref_cfg)
    for t in range(steps):
        tok = toks[:, S + t:S + t + 1]
        want_l, want_c = step(ref_params, jnp.asarray(tok), want_c,
                              jnp.int32(S + t))
        # a 0-d tensor on the first step, a Python int after it
        pos = torch.tensor(S + t) if t == 0 else S + t
        got_l, same = tr.decode_step(params, torch.from_numpy(tok), got_c,
                                     pos, cfg)
        assert same is got_c
        pairs.append((got_l, want_l))
    return cfg, pairs, got_c, want_c, (params, toks)


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches(models, name, dtype):
    """Logits after the prompt and after every decode step, and the final
    caches (KV rows, RG-LRU and SSD states), against the reference's."""
    cfg, pairs, got_c, want_c, _ = _decode_both(models, name, dtype)
    for got, want in pairs:
        assert got.shape == (B, 1, cfg.padded_vocab())
        _assert_close(got[..., :cfg.vocab_size], _valid(want, cfg), dtype)
    want = _flat(jax.tree_util.tree_map(np.asarray, want_c))
    got = _flat(to_numpy_params(got_c))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert got[path].shape == leaf.shape, path
        _assert_close(got[path].astype(np.float32), leaf.astype(np.float32),
                      dtype)


@pytest.mark.parametrize("name", ["qwen2-7b", "h2o-danube-1.8b",
                                  "recurrentgemma-9b"])
def test_decode_equals_its_own_full_forward(models, name):
    """As ``tests/test_models.py:53``: prefill + decode gives the logits
    of the whole sequence's forward, fp32."""
    cfg, pairs, _, _, (params, toks) = _decode_both(models, name, "float32")
    hidden, _, _ = tr.forward_hidden(params, {"tokens": torch.from_numpy(
        toks)}, cfg)
    full = tr.unembed(params, hidden[:, -1:], cfg)
    _assert_close(pairs[-1][0], full.numpy(), "float32")


def test_int8_cache_decode_matches(models):
    """``kv_cache_dtype="int8"``: from an empty ``init_decode_cache`` every
    step's k and v rows are quantised into the cache and dequantised for
    attention.  Logits as fp32; int8 codes at most one step apart (the
    rows come from two frameworks' arithmetic) and scales within fp32
    tolerance."""
    ref_cfg, ref_params, cfg, params = _model(
        models, "qwen2-7b", "float32", kv_cache_dtype="int8")
    toks = _tokens(cfg, 6, seed=3)
    want_c = ref_tr.init_decode_cache(ref_cfg, B, 8)
    got_c = tr.init_decode_cache(cfg, B, 8, device="cpu")
    step = _ref_step(ref_cfg)
    for t in range(6):
        want_l, want_c = step(ref_params, jnp.asarray(toks[:, t:t + 1]),
                              want_c, jnp.int32(t))
        got_l, got_c = tr.decode_step(params, torch.from_numpy(
            toks[:, t:t + 1]), got_c, t, cfg)
        _assert_close(got_l[..., :cfg.vocab_size], _valid(want_l, cfg),
                      "float32")
    want = _flat(jax.tree_util.tree_map(np.asarray, want_c))
    got = _flat(to_numpy_params(got_c))
    for path, leaf in want.items():
        if path[-1] in ("k", "v"):
            assert got[path].dtype == np.int8
            assert np.abs(got[path].astype(int) - leaf).max() <= 1, path
        else:
            np.testing.assert_allclose(got[path], leaf, rtol=5e-5, atol=0)


def test_ring_cache_matches_reference_and_linear(models):
    """h2o-danube with a ring cache of its window (32 slots) from empty,
    36 steps so that it wraps: each step's logits equal the reference's
    ring decode (fp32), and the last equal the port's own decode over a
    linear cache of 36 rows, as ``tests/test_models.py:85`` means to.
    That test asks ``init_decode_cache`` for 48 rows, which caps them at
    the window (``effective_kv_len``), so it holds a ring to a ring; the
    linear cache here is a 1-row cache grown by ``pad_kv_caches``."""
    ref_cfg, ref_params, cfg, params = _model(models, "h2o-danube-1.8b",
                                              "float32")
    T = 36
    toks = _tokens(cfg, T, seed=4, batch=1)
    want_c = ref_tr.init_decode_cache(ref_cfg, 1, cfg.window)
    ring = tr.init_decode_cache(cfg, 1, cfg.window, device="cpu")
    assert tr.init_decode_cache(cfg, 1, T, device="cpu")["groups"]["b0"][
        "k"].shape[2] == cfg.window == 32
    lin = tr.pad_kv_caches(tr.init_decode_cache(cfg, 1, 1, device="cpu"), T)
    assert ring["groups"]["b0"]["k"].shape[2] == cfg.window
    assert lin["groups"]["b0"]["k"].shape[2] == T
    step = _ref_step(ref_cfg)
    for t in range(T):
        tok = toks[:, t:t + 1]
        want_l, want_c = step(ref_params, jnp.asarray(tok), want_c,
                              jnp.int32(t))
        lr, ring = tr.decode_step(params, torch.from_numpy(tok), ring, t, cfg)
        ll, lin = tr.decode_step(params, torch.from_numpy(tok), lin, t, cfg)
        _assert_close(lr[..., :cfg.vocab_size], _valid(want_l, cfg),
                      "float32")
    _assert_close(lr, ll.numpy(), "float32")


def test_prefill_ignores_an_int8_cache_dtype(models):
    """A quirk of the reference kept by the port: with
    ``kv_cache_dtype="int8"`` prefill still returns the prompt's k and v
    in the compute dtype (no scales); only ``init_decode_cache`` makes an
    int8 cache."""
    ref_cfg, ref_params, cfg, params = _model(models, "qwen2-7b", "bfloat16",
                                              kv_cache_dtype="int8")
    toks = _tokens(cfg, 16, seed=5)
    _, want = ref_tr.prefill(ref_params, {"tokens": jnp.asarray(toks)},
                             ref_cfg, pad_to=24)
    _, got = tr.prefill(params, {"tokens": torch.from_numpy(toks)}, cfg,
                        pad_to=24)
    for cache in (want["groups"]["b0"], got["groups"]["b0"]):
        assert set(cache) == {"k", "v"}
    assert want["groups"]["b0"]["k"].dtype == jnp.bfloat16
    assert got["groups"]["b0"]["k"].dtype == torch.bfloat16
    assert tr.init_decode_cache(cfg, B, 24, device="cpu")["groups"]["b0"][
        "k"].dtype == torch.int8


def test_encoder_decoder_decode_says_so():
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        tr.build_enc_kv({}, None, reduced_config("seamless-m4t-medium"))
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        tr.decode_step({}, None, {"enc_kv": {}}, 0,
                       reduced_config("seamless-m4t-medium"))
