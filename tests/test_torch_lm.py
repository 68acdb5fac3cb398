"""Port parity, the layer-split LM path as a whole: norms, RoPE, MLPs,
``forward_hidden``, ``run_layer_range`` and the layer-split engines of
the port against the reference's, on reduced RecurrentGemma-9B (pattern
rec, rec, attn: both kernels' blocks), reduced Qwen2-7B (dense GQA
with QKV bias and a padded vocabulary), reduced SmolLM-135M (the head
tied to the embedding) and reduced Nemotron-4-15B (squared ReLU,
layernorm).  Parameters are initialised in
JAX and converted; tokens come from numpy.

Tolerances.  fp32 (the tree and the config cast to fp32): 5e-5 on the
hidden state, the algorithm alone (observed at most 6e-6).  bf16 (the
configs as published): the frameworks round the bf16 intermediates at
different places (XLA keeps some in fp32), so the whole model is held to
a relative L2 error of 3e-2 and an elementwise atol of 0.125 on values
up to ~4 (observed 1.2e-2 and 0.047).  The split engines are held to the
reference's own fp16-boundary tolerance (atol 0.15, rtol 0.1).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.core.transport import LOCAL_LINK as REF_LOCAL_LINK
from repro.models import common as ref_common
from repro.models import mlp as ref_mlp
from repro.models import transformer as ref_tr
from repro.serving import engine as ref_engine
from repro_torch.configs import reduced_config
from repro_torch import convert
from repro_torch.convert import from_jax_params
from repro_torch.core.transport import LOCAL_LINK
from repro_torch.kernels import ops
from repro_torch.models import common, mlp
from repro_torch.models import transformer as tr
from repro_torch.serving import engine

#: the port's trees as numpy, bf16 leaves viewed as ml_dtypes' bf16
to_numpy_params = functools.partial(convert.to_numpy_params,
                                    bf16=ml_dtypes.bfloat16)

# The models here are tiny: one thread each, or the test workers that
# share a machine fight over cores inside PyTorch's thread pool.
torch.set_num_threads(1)

ARCHS = ["recurrentgemma-9b", "qwen2-7b", "smollm-135m", "nemotron-4-15b"]
B, S = 2, 40


@pytest.fixture(scope="module")
def models():
    """{arch: (reference cfg, reference params, port cfg, port params)},
    one JAX init per arch for the whole file."""
    out = {}
    for arch in ARCHS:
        ref_cfg = ref_reduced_config(arch)
        ref_params = ref_tr.init_params(ref_cfg, jax.random.PRNGKey(0))
        params = from_jax_params(
            jax.tree_util.tree_map(np.asarray, ref_params), "cpu")
        out[arch] = (ref_cfg, ref_params, reduced_config(arch), params)
    return out


def _model(models, arch, dtype):
    ref_cfg, ref_params, cfg, params = models[arch]
    if dtype == "bfloat16":
        return ref_cfg, ref_params, cfg, params
    ref_params = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32), ref_params)
    params = from_jax_params(
        jax.tree_util.tree_map(np.asarray, ref_params), "cpu")
    return (dataclasses.replace(ref_cfg, param_dtype="float32"), ref_params,
            dataclasses.replace(cfg, param_dtype="float32"), params)


def _tokens(cfg, seed=1, batch=B, seq=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)


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


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm_matches(dtype, norm):
    cfg = dataclasses.replace(reduced_config("qwen2-7b"), norm=norm)
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 5, 64)) * 3, getattr(jnp, dtype))
    p = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in common.init_norm(cfg, 64, "cpu").items()}
    want = ref_common.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, x)
    got = common.apply_norm(from_jax_params(p, "cpu"),
                            from_jax_params(np.asarray(x), "cpu"))
    assert got.dtype == getattr(torch, dtype)
    tol = 2e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches(dtype):
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 300, 3, 16)), getattr(jnp, dtype))
    want = ref_common.apply_rope(x, jnp.arange(300), 10000.0)
    got = common.apply_rope(from_jax_params(np.asarray(x), "cpu"),
                            torch.arange(300), 10000.0)
    tol = 1e-4 if dtype == "float32" else 2 ** -7   # angles up to 300 rad
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("activation", ["gelu", "swiglu", "relu2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mlp_matches(activation, dtype):
    cfg = dataclasses.replace(reduced_config("qwen2-7b"),
                              activation=activation, param_dtype=dtype)
    ref_p = ref_mlp.init_mlp(jax.random.PRNGKey(4), cfg)
    x = jnp.asarray(np.random.default_rng(4).standard_normal((2, 7, 64)),
                    getattr(jnp, dtype))
    want = ref_mlp.apply_mlp(ref_p, x, cfg)
    got = mlp.apply_mlp(
        from_jax_params(jax.tree_util.tree_map(np.asarray, ref_p), "cpu"),
        from_jax_params(np.asarray(x), "cpu"), cfg)
    tol = 5e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_has_the_reference_tree(models, arch):
    """Group-stacked leaves, tail, padded vocab: same keys, same shapes,
    same dtypes; the values are the port's own."""
    ref_cfg, ref_params, cfg, _ = models[arch]
    own = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = _flat(jax.tree_util.tree_map(np.asarray, ref_params))
    got = _flat(own)
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape, path
        assert str(got[path].dtype).split(".")[-1] == str(leaf.dtype), path
    lead = {v.shape[0] for k, v in got.items() if k[0] == "blocks"}
    assert lead == {cfg.num_groups()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_hidden_matches(models, arch, dtype):
    ref_cfg, ref_params, cfg, params = _model(models, arch, dtype)
    toks = _tokens(cfg)
    want, want_aux, _ = ref_tr.forward_hidden(
        ref_params, {"tokens": jnp.asarray(toks)}, ref_cfg)
    got, aux, _ = tr.forward_hidden(params, {"tokens": torch.from_numpy(toks)},
                                    cfg, kernels=ops.kernel_registry())
    assert got.shape == (B, S, cfg.d_model) and got.dtype == params[
        "embed"].dtype
    np.testing.assert_array_equal(aux.numpy(), np.asarray(want_aux))
    _assert_close(got, want, dtype)
    # the logits of the last token, padded vocabulary masked as the
    # reference masks it
    want_l = np.asarray(ref_tr.unembed(ref_params, want[:, -1:], ref_cfg),
                        np.float32)
    got_l = tr.unembed(params, got[:, -1:], cfg).float().numpy()
    pad = np.arange(cfg.padded_vocab()) >= cfg.vocab_size
    assert pad.any()            # the reduced vocabularies are padded
    np.testing.assert_array_equal(got_l[..., pad], want_l[..., pad])
    _assert_close(got_l[..., ~pad], want_l[..., ~pad], dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_on_cpu_is_the_plain_path(models, arch):
    """On CPU tensors the kernel registry runs the plain versions: the
    forward is the same to the bit with and without it."""
    _, _, cfg, params = models[arch]
    batch = {"tokens": torch.from_numpy(_tokens(cfg, seed=5))}
    a, _, _ = tr.forward_hidden(params, batch, cfg)
    b, _, _ = tr.forward_hidden(params, batch, cfg,
                                kernels=ops.kernel_registry())
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_caches_match(models, arch):
    """``return_cache``: per-group KV and RG-LRU state, stacked like the
    reference's scan output (fp32 tree)."""
    ref_cfg, ref_params, cfg, params = _model(models, arch, "float32")
    toks = _tokens(cfg, seed=6)
    _, _, want = ref_tr.forward_hidden(
        ref_params, {"tokens": jnp.asarray(toks)}, ref_cfg, return_cache=True)
    _, _, got = tr.forward_hidden(params, {"tokens": torch.from_numpy(toks)},
                                  cfg, return_cache=True)
    want = _flat(jax.tree_util.tree_map(np.asarray, want))
    got = _flat(to_numpy_params(got))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_allclose(got[path], leaf, atol=5e-5, rtol=5e-5,
                                   err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_layer_range_matches(models, arch, dtype):
    ref_cfg, ref_params, cfg, params = _model(models, arch, dtype)
    toks = _tokens(cfg, seed=8)
    x = ref_tr.embed_inputs(ref_params, {"tokens": jnp.asarray(toks)},
                            ref_cfg)
    xt = from_jax_params(np.asarray(x), "cpu")
    G = cfg.num_groups()
    for start, stop in sorted({(0, G // 2), (G // 2, G), (0, G), (G, G)}):
        want = ref_tr.run_layer_range(
            ref_params, x, ref_cfg, None, start_group=start, stop_group=stop,
            positions=jnp.arange(S))
        got = tr.run_layer_range(
            params, xt, cfg, None, start_group=start, stop_group=stop,
            positions=torch.arange(S), kernels=ops.kernel_registry())
        _assert_close(got, want, dtype)
    with pytest.raises(ValueError):
        tr.run_layer_range(params, xt, cfg, None, start_group=1,
                           stop_group=0, positions=torch.arange(S))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "seamless-m4t-medium"])
def test_unported_blocks_say_so(arch):
    """Both are ported now and initialise on the CPU: Mixture-of-Experts
    (tests/test_torch_moe.py) and the encoder-decoder
    (tests/test_torch_encdec.py), whose tree has the reference's paths,
    shapes and dtypes (``jax.eval_shape`` of its ``init_params``)."""
    cfg = reduced_config(arch)
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(t.device.type == "cpu" for t in _flat(params).values())
    if cfg.moe is not None:
        assert set(params["blocks"]["b0"]["moe"]) == {
            "router", "w_gate", "w_up", "w_down"}
        return
    ref_cfg = ref_reduced_config(arch)
    want = _flat(jax.eval_shape(lambda key: ref_tr.init_params(ref_cfg, key),
                                jax.random.PRNGKey(0)))
    got = _flat(params)
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape, path
        assert got[path].dtype == getattr(torch, str(leaf.dtype)), path
    assert ("encoder", "final_norm", "scale") in got
    assert ("blocks", "b0", "xwq") in got


# --------------------------------------------------------------------------
# the layer-split engines
# --------------------------------------------------------------------------
def _one_machine(ref_params, ref_cfg, toks, tail_twice=False):
    """The reference's last-token logits on one machine.  ``tail_twice``
    runs the tail layers again before the head, as the reference's split
    engines do at g == G (see test_split_at_G_runs_the_tail_twice)."""
    x = ref_tr.embed_inputs(ref_params, {"tokens": jnp.asarray(toks)},
                            ref_cfg)
    G, pos = ref_cfg.num_groups(), jnp.arange(toks.shape[1])
    x = ref_tr.run_layer_range(ref_params, x, ref_cfg, None, start_group=0,
                               stop_group=G, positions=pos)
    if tail_twice:
        x = ref_tr.run_layer_range(ref_params, x, ref_cfg, None,
                                   start_group=G, stop_group=G, positions=pos)
    x = ref_tr.apply_norm(ref_params["final_norm"], x)
    return np.asarray(ref_tr.unembed(ref_params, x[:, -1:], ref_cfg),
                      np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_split_matches_full_forward(models, arch):
    """Cloud [0, g) + fp16 hidden + device [g, G) + head at g in {0, G//2,
    G}: payload bytes and cache counters equal the reference engines';
    logits agree with the reference's split and with its one-machine
    forward (with the tail run twice at g == G, as the reference's
    engines do) at the reference's fp16-boundary tolerance."""
    ref_cfg, ref_params, cfg, params = models[arch]
    toks = _tokens(cfg, seed=9, batch=2, seq=16)
    ref_cloud = ref_engine.LayerSplitEngine(ref_params, ref_cfg,
                                            link=REF_LOCAL_LINK)
    ref_dev = ref_engine.LayerSplitDevice(ref_params, ref_cfg)
    cloud = engine.LayerSplitEngine(params, cfg, link=LOCAL_LINK,
                                    device="cpu")
    dev = engine.LayerSplitDevice(params, cfg, device="cpu")
    G = cfg.num_groups()
    for g in sorted({0, G // 2, G}):
        ref_payload, ref_t = ref_cloud.process({"tokens": toks}, g)
        payload, t_net = cloud.process({"tokens": toks}, g)
        assert payload.dtype == np.float16
        assert payload.shape == ref_payload.shape
        assert payload.nbytes == ref_payload.nbytes and t_net == ref_t > 0
        np.testing.assert_allclose(payload.astype(np.float32),
                                   ref_payload.astype(np.float32),
                                   atol=0.125, rtol=0)
        ref_got = np.asarray(ref_dev.complete(ref_payload, g), np.float32)
        got = dev.complete(payload, g).float().numpy()
        assert got.shape == (2, 1, cfg.padded_vocab())
        want = _one_machine(ref_params, ref_cfg, toks,
                            tail_twice=g == G and bool(cfg.tail_pattern()))
        for target in (ref_got, want):          # fp16 boundary
            np.testing.assert_allclose(got, target, atol=0.15, rtol=0.1)
    for ours, theirs in ((cloud, ref_cloud), (dev, ref_dev)):
        assert tuple(ours.stats) == engine.ENGINE_STATS_KEYS
        for key in ("executables", "cache_hits", "cache_misses", "requests",
                    "bytes_shipped"):
            assert ours.stats[key] == theirs.stats[key], key
    # the same key again is a cache hit, and costs no warm-up
    compile_s = cloud.stats["compile_seconds"]
    cloud.process({"tokens": toks}, G)
    assert cloud.stats["cache_hits"] == 1
    assert cloud.stats["compile_seconds"] == compile_s


def test_split_at_G_runs_the_tail_twice(models):
    """A quirk of the reference kept by the port: ``run_layer_range`` runs
    the tail whenever ``stop_group == G``, and at g == G both the cloud
    ([0, G)) and the device ([G, G)) call it so, so RecurrentGemma's two
    tail layers run twice.  Both packages' splits equal a one-machine
    forward with the tail run twice, and differ from the plain forward."""
    ref_cfg, ref_params, cfg, params = _model(models, "recurrentgemma-9b",
                                              "float32")
    assert cfg.tail_pattern() == ("rec", "rec")
    toks = _tokens(cfg, seed=10, batch=1, seq=12)
    G = cfg.num_groups()
    ref_split = np.asarray(ref_engine.LayerSplitDevice(ref_params, ref_cfg)
                           .complete(ref_engine.LayerSplitEngine(
                               ref_params, ref_cfg, link=REF_LOCAL_LINK)
                               .process({"tokens": toks}, G)[0], G),
                           np.float32)
    split = engine.LayerSplitDevice(params, cfg, device="cpu").complete(
        engine.LayerSplitEngine(params, cfg, link=LOCAL_LINK, device="cpu")
        .process({"tokens": toks}, G)[0], G).float().numpy()
    twice = _one_machine(ref_params, ref_cfg, toks, tail_twice=True)
    once = _one_machine(ref_params, ref_cfg, toks)
    for got in (ref_split, split):
        np.testing.assert_allclose(got, twice, atol=5e-3, rtol=5e-3)
        assert np.abs(got - once).max() > 0.1
