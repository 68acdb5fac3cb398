"""Port parity, the layer-split path on Mamba-2 (SSD blocks only):
``models/ssd.py``, the transformer's ``ssd`` branches, ``forward_hidden``
(with its ``{"ssm", "conv"}`` caches), ``run_layer_range``, the
layer-split engines, parameter conversion and segmentation, against the
reference's, on reduced Mamba-2-780M (d_model 64, 8 heads of head_dim 16,
d_state 16, chunk 32) and a 4-layer variant of it made on both sides by
``dataclasses.replace``.  Parameters are initialised in JAX and
converted; inputs come from numpy.

Tolerances.  fp32: the block to 5e-6 and the model to 5e-5, the algorithm
alone (observed 1.3e-6 and 3e-6).  bf16 (the configs as published): the
block to one bf16 step of its outputs, the model to a relative L2 error
of 3e-2 and an elementwise atol of 0.125, as ``tests/test_torch_lm.py``
holds the other LM blocks (the frameworks round bf16 intermediates at
different places).  The split engines are held to the reference's own
fp16-boundary tolerance (atol 0.15, rtol 0.1).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.core import segmentation as ref_segmentation
from repro.core.transport import LOCAL_LINK as REF_LOCAL_LINK
from repro.models import ssd as ref_ssd
from repro.models import transformer as ref_tr
from repro.serving import engine as ref_engine
from repro_torch.configs import get_config, reduced_config
from repro_torch import convert
from repro_torch.convert import from_jax_params
from repro_torch.core import segmentation
from repro_torch.core.transport import LOCAL_LINK
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd_kernel
from repro_torch.models import ssd
from repro_torch.models import transformer as tr
from repro_torch.serving import engine

#: the port's trees as numpy, bf16 leaves viewed as ml_dtypes' bf16
to_numpy_params = functools.partial(convert.to_numpy_params,
                                    bf16=ml_dtypes.bfloat16)

# The models here are tiny: one thread each, or the test workers that
# share a machine fight over cores inside PyTorch's thread pool.
torch.set_num_threads(1)

ARCH = "mamba2-780m"
LAYERS = 4
B, S = 2, 64                      # two chunks of the reduced chunk length 32


def _configs(dtype="bfloat16", layers=LAYERS):
    return (dataclasses.replace(ref_reduced_config(ARCH), num_layers=layers,
                                param_dtype=dtype),
            dataclasses.replace(reduced_config(ARCH), num_layers=layers,
                                param_dtype=dtype))


@pytest.fixture(scope="module")
def model():
    """(reference cfg, reference params, port cfg, port params) of the
    4-layer reduced model in bf16, one JAX init for the whole file."""
    ref_cfg, cfg = _configs()
    ref_params = ref_tr.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, ref_params),
                             "cpu")
    return ref_cfg, ref_params, cfg, params


def _model(model, dtype):
    ref_cfg, ref_params, cfg, params = model
    if dtype == "bfloat16":
        return model
    ref_params = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32), ref_params)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, ref_params),
                             "cpu")
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


def _same_tree(got, want):
    """Same keys, shapes and dtypes (values are each side's own)."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert tuple(got[path].shape) == tuple(leaf.shape), path
        assert str(got[path].dtype).split(".")[-1] == str(leaf.dtype), path


# --------------------------------------------------------------------------
# models/ssd.py
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def block():
    """SSD block parameters of the reduced Mamba-2, from JAX."""
    ref_cfg = ref_reduced_config(ARCH)
    ref_p = ref_ssd.init_ssd_block(jax.random.PRNGKey(3), ref_cfg)
    return ref_cfg, jax.tree_util.tree_map(np.asarray, ref_p)


def _cast_tree(tree, dtype):
    """The JAX tree in the config's dtype: low-precision leaves are cast,
    fp32 leaves (A_log, dt_bias, D, norm_scale) stay."""
    want = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return jax.tree_util.tree_map(
        lambda a: a if a.dtype == np.float32 else jnp.asarray(a, want), tree)


def test_init_ssd_block_has_the_reference_tree(block):
    """Same keys, shapes and dtypes; A_log = log(1..H) (to one ulp: the
    two frameworks' logs round apart), dt_bias the inverse softplus of a
    dt in [dt_min, dt_max], D and the norm scale ones."""
    ref_cfg, np_p = block
    cfg = reduced_config(ARCH)
    own = ssd.init_ssd_block(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    _same_tree(own, np_p)
    np.testing.assert_allclose(own["A_log"].numpy(), np_p["A_log"],
                               rtol=2 ** -23, atol=0)
    dt = torch.nn.functional.softplus(own["dt_bias"]).numpy()
    s = cfg.ssm
    assert np.all((dt > s.dt_min * (1 - 1e-5)) & (dt < s.dt_max * (1 + 1e-5)))
    assert own["D"].eq(1).all() and own["norm_scale"].eq(1).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("use_registry", [False, True])
def test_apply_ssd_block_matches(block, dtype, with_state, use_registry):
    ref_cfg, np_p = block
    rcfg = dataclasses.replace(ref_cfg, param_dtype=dtype)
    cfg = dataclasses.replace(reduced_config(ARCH), param_dtype=dtype)
    ref_p = _cast_tree(np_p, dtype)
    p = from_jax_params(jax.tree_util.tree_map(np.asarray, ref_p), "cpu")
    d, di, H, P, G, N = ssd.dims(cfg)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((B, S, d)), getattr(jnp, dtype))
    state = None
    if with_state:
        state = {"ssm": jnp.asarray(rng.standard_normal((B, H, P, N)),
                                    jnp.float32),
                 "conv": jnp.asarray(rng.standard_normal(
                     (B, cfg.ssm.d_conv - 1, di + 2 * G * N)),
                     getattr(jnp, dtype))}
    want, want_state = ref_ssd.apply_ssd_block(ref_p, x, rcfg, state=state)
    t_state = (None if state is None else
               from_jax_params(jax.tree_util.tree_map(np.asarray, state),
                               "cpu"))
    got, got_state = ssd.apply_ssd_block(
        p, from_jax_params(np.asarray(x), "cpu"), cfg, state=t_state,
        kernel_fn=ops.ssd_scan if use_registry else None)
    assert got.dtype == getattr(torch, dtype)
    tol = (dict(atol=5e-6, rtol=5e-6) if dtype == "float32"
           else dict(atol=2 ** -8, rtol=2 ** -8))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    gs = to_numpy_params(got_state)
    ws = jax.tree_util.tree_map(np.asarray, want_state)
    assert gs.keys() == ws.keys() == {"ssm", "conv"}
    assert gs["conv"].dtype == ws["conv"].dtype
    np.testing.assert_allclose(gs["ssm"], ws["ssm"], atol=2e-5, rtol=0)
    np.testing.assert_allclose(np.asarray(gs["conv"], np.float32),
                               np.asarray(ws["conv"], np.float32), **tol)


def test_block_scans_through_the_wrapper_by_default(block, monkeypatch):
    """With no ``kernel_fn`` the block calls the dispatching wrapper, so a
    CUDA tensor reaches the kernel whoever calls it."""
    calls = []

    def counting(x, dt, A, Bm, Cm, *, chunk_size, init_state=None):
        calls.append((tuple(x.shape), chunk_size))
        return ssd_kernel.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk_size,
                                          init_state)
    monkeypatch.setattr(ssd_kernel, "ssd_scan", counting)
    _, np_p = block
    cfg = reduced_config(ARCH)
    p = from_jax_params(np_p, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)).to(p["x_proj"].dtype)
    ssd.apply_ssd_block(p, x, cfg)
    _, _, H, P, _, _ = ssd.dims(cfg)
    assert calls == [((2, 32, H, P), cfg.ssm.chunk_size)]


def test_ssd_decode_step_matches_and_continues_the_scan():
    """One-token steps equal the reference's, and stepping through a
    sequence gives the chunked scan's y and final state."""
    cfg = reduced_config(ARCH)
    _, _, H, P, G, N = ssd.dims(cfg)
    rng = np.random.default_rng(11)
    b, T = 2, 8
    x = rng.standard_normal((b, T, H, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(b, T, H)).astype(np.float32)
    A = -np.arange(1, H + 1, dtype=np.float32)
    Bm = rng.standard_normal((b, T, G, N)).astype(np.float32)
    Cm = rng.standard_normal((b, T, G, N)).astype(np.float32)
    st0 = rng.standard_normal((b, H, P, N)).astype(np.float32)
    state, ref_state = torch.from_numpy(st0), jnp.asarray(st0)
    ys = []
    for t in range(T):
        args = [a[:, t] for a in (x, dt, Bm, Cm)]
        y, state = ssd.ssd_decode_step(
            state, torch.from_numpy(args[0]), torch.from_numpy(args[1]),
            torch.from_numpy(A), torch.from_numpy(args[2]),
            torch.from_numpy(args[3]))
        want_y, ref_state = ref_ssd.ssd_decode_step(
            ref_state, *map(jnp.asarray, (args[0], args[1], A, args[2],
                                          args[3])))
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=2e-5)
        np.testing.assert_allclose(state.numpy(), np.asarray(ref_state),
                                   atol=2e-5)
        ys.append(y)
    y_scan, final = ops.ssd_scan(
        *map(torch.from_numpy, (x, dt, A, Bm, Cm)), chunk_size=4,
        init_state=torch.from_numpy(st0))
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_scan.numpy(),
                               atol=2e-4)
    np.testing.assert_allclose(state.numpy(), final.numpy(), atol=2e-5)


def test_init_ssd_state_matches(block):
    ref_cfg, _ = block
    cfg = reduced_config(ARCH)
    want = ref_ssd.init_ssd_state(3, ref_cfg)
    got = ssd.init_ssd_state(3, cfg, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert not got[k].any()


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
def test_port_init_has_the_reference_tree(model):
    """Group-stacked ``{"norm1", "ssd"}`` leaves, no tail, an untied head,
    the padded vocabulary."""
    ref_cfg, ref_params, cfg, _ = model
    assert cfg.num_groups() == LAYERS and cfg.tail_pattern() == ()
    own = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _same_tree(own, jax.tree_util.tree_map(np.asarray, ref_params))
    assert {v.shape[0] for k, v in _flat(own).items()
            if k[0] == "blocks"} == {LAYERS}


def test_full_width_tree_is_the_reference_s():
    """At the published width: each SSD block of the port has the
    reference's leaves, and the reference's whole tree holds 860,045,568
    parameters in 1,720,550,400 bytes (``param_count()`` says 857,070,336,
    a quirk of the reference kept by the port's verbatim config)."""
    ref_cfg, cfg = ref_get_config(ARCH), get_config(ARCH)
    want_block = jax.eval_shape(
        lambda k: ref_tr.init_block("ssd", k, ref_cfg), jax.random.PRNGKey(0))
    own_block = tr.init_block("ssd", torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    _same_tree(own_block, want_block)
    tree = jax.eval_shape(lambda k: ref_tr.init_params(ref_cfg, k),
                          jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_leaves(tree)
    assert sum(a.size for a in leaves) == 860_045_568
    assert sum(a.size * a.dtype.itemsize for a in leaves) == 1_720_550_400
    assert cfg.param_count() == ref_cfg.param_count() == 857_070_336


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("return_cache", [False, True])
def test_forward_hidden_matches(model, dtype, return_cache):
    ref_cfg, ref_params, cfg, params = _model(model, dtype)
    toks = _tokens(cfg)
    want, want_aux, want_c = ref_tr.forward_hidden(
        ref_params, {"tokens": jnp.asarray(toks)}, ref_cfg,
        return_cache=return_cache)
    got, aux, got_c = tr.forward_hidden(
        params, {"tokens": torch.from_numpy(toks)}, cfg,
        return_cache=return_cache, kernels=ops.kernel_registry())
    assert got.shape == (B, S, cfg.d_model)
    assert got.dtype == params["embed"].dtype
    np.testing.assert_array_equal(aux.numpy(), np.asarray(want_aux))
    _assert_close(got, want, dtype)
    want_l = np.asarray(ref_tr.unembed(ref_params, want[:, -1:], ref_cfg),
                        np.float32)
    got_l = tr.unembed(params, got[:, -1:], cfg).float().numpy()
    pad = np.arange(cfg.padded_vocab()) >= cfg.vocab_size
    np.testing.assert_array_equal(got_l[..., pad], want_l[..., pad])
    _assert_close(got_l[..., ~pad], want_l[..., ~pad], dtype)
    if not return_cache:
        assert got_c is None and want_c is None
        return
    # per-group {"ssm", "conv"} state, stacked like the reference's scan
    want_c = _flat(jax.tree_util.tree_map(np.asarray, want_c))
    got_c = _flat(to_numpy_params(got_c))
    assert got_c.keys() == want_c.keys()
    assert {p[-1] for p in got_c} == {"ssm", "conv"}
    for path, leaf in want_c.items():
        assert got_c[path].shape == leaf.shape, path
        assert got_c[path].dtype == leaf.dtype, path
        _assert_close(np.asarray(got_c[path], np.float32), leaf, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_layer_range_matches(model, dtype):
    ref_cfg, ref_params, cfg, params = _model(model, dtype)
    toks = _tokens(cfg, seed=8)
    x = ref_tr.embed_inputs(ref_params, {"tokens": jnp.asarray(toks)},
                            ref_cfg)
    xt = from_jax_params(np.asarray(x), "cpu")
    G = cfg.num_groups()
    for start, stop in sorted({(0, G // 2), (G // 2, G), (0, G), (G, G),
                               (1, 3)}):
        want = ref_tr.run_layer_range(
            ref_params, x, ref_cfg, None, start_group=start, stop_group=stop,
            positions=jnp.arange(S))
        got = tr.run_layer_range(
            params, xt, cfg, None, start_group=start, stop_group=stop,
            positions=torch.arange(S), kernels=ops.kernel_registry())
        _assert_close(got, want, dtype)


def test_registry_on_cpu_is_the_plain_path(model):
    """On CPU tensors the kernel registry runs the plain versions: the
    forward is the same to the bit with and without it."""
    _, _, cfg, params = model
    batch = {"tokens": torch.from_numpy(_tokens(cfg, seed=5))}
    a, _, _ = tr.forward_hidden(params, batch, cfg)
    b, _, _ = tr.forward_hidden(params, batch, cfg,
                                kernels=ops.kernel_registry())
    assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the layer-split engines
# --------------------------------------------------------------------------
def _one_machine(ref_params, ref_cfg, toks):
    x = ref_tr.embed_inputs(ref_params, {"tokens": jnp.asarray(toks)},
                            ref_cfg)
    x = ref_tr.run_layer_range(ref_params, x, ref_cfg, None, start_group=0,
                               stop_group=ref_cfg.num_groups(),
                               positions=jnp.arange(toks.shape[1]))
    x = ref_tr.apply_norm(ref_params["final_norm"], x)
    return np.asarray(ref_tr.unembed(ref_params, x[:, -1:], ref_cfg),
                      np.float32)


def test_layer_split_matches_full_forward(model):
    """Cloud [0, g) + fp16 hidden + device [g, G) + head at g in {0, G//2,
    G}: payload bytes and cache counters equal the reference engines';
    logits agree with the reference's split and its one-machine forward
    (no tail, so nothing runs twice) at its fp16-boundary tolerance."""
    ref_cfg, ref_params, cfg, params = model
    toks = _tokens(cfg, seed=9, batch=2, seq=32)
    ref_cloud = ref_engine.LayerSplitEngine(ref_params, ref_cfg,
                                            link=REF_LOCAL_LINK)
    ref_dev = ref_engine.LayerSplitDevice(ref_params, ref_cfg)
    cloud = engine.LayerSplitEngine(params, cfg, link=LOCAL_LINK,
                                    device="cpu")
    dev = engine.LayerSplitDevice(params, cfg, device="cpu")
    G = cfg.num_groups()
    want = _one_machine(ref_params, ref_cfg, toks)
    for g in (0, G // 2, G):
        ref_payload, ref_t = ref_cloud.process({"tokens": toks}, g)
        payload, t_net = cloud.process({"tokens": toks}, g)
        assert payload.dtype == np.float16
        assert payload.shape == ref_payload.shape == (2, 32, cfg.d_model)
        assert payload.nbytes == ref_payload.nbytes == (
            segmentation.hidden_payload_bytes(cfg, 2, 32, 2))
        assert t_net == ref_t > 0
        np.testing.assert_allclose(payload.astype(np.float32),
                                   ref_payload.astype(np.float32),
                                   atol=0.125, rtol=0)
        ref_got = np.asarray(ref_dev.complete(ref_payload, g), np.float32)
        got = dev.complete(payload, g).float().numpy()
        assert got.shape == (2, 1, cfg.padded_vocab())
        for target in (ref_got, want):          # fp16 boundary
            np.testing.assert_allclose(got, target, atol=0.15, rtol=0.1)
    for ours, theirs in ((cloud, ref_cloud), (dev, ref_dev)):
        for key in ("executables", "cache_hits", "cache_misses", "requests",
                    "bytes_shipped"):
            assert ours.stats[key] == theirs.stats[key], key


# --------------------------------------------------------------------------
# conversion and segmentation
# --------------------------------------------------------------------------
def test_from_jax_params_round_trips_the_tree(model):
    """Group-stacked bf16 projections and fp32 A_log / dt_bias / D / norm
    scales cross leaf for leaf, bit for bit, and come back."""
    _, ref_params, cfg, params = model
    ref = _flat(jax.tree_util.tree_map(np.asarray, ref_params))
    back = _flat(to_numpy_params(params))
    own = _flat(params)
    assert ref.keys() == back.keys() == own.keys()
    for path, leaf in ref.items():
        assert back[path].dtype == leaf.dtype, path
        bits = np.uint16 if leaf.dtype == ml_dtypes.bfloat16 else leaf.dtype
        np.testing.assert_array_equal(back[path].view(bits), leaf.view(bits),
                                      err_msg=str(path))
    blk = ("blocks", "b0", "ssd")
    assert own[blk + ("x_proj",)].dtype == torch.bfloat16
    for name in ("A_log", "dt_bias", "D", "norm_scale"):
        assert own[blk + (name,)].dtype == torch.float32
        assert own[blk + (name,)].shape[0] == cfg.num_groups()


@pytest.mark.parametrize("batch,seq", [(1, 512), (4, 4096)])
def test_segmentation_of_the_full_width_model(batch, seq):
    """The copy of ``core/segmentation`` counts the SSM and conv state a
    streaming split ships, and its split points equal the reference's."""
    cfg, ref_cfg = get_config(ARCH), ref_get_config(ARCH)
    got = segmentation.boundary_state_bytes(cfg, batch, seq)
    assert got == ref_segmentation.boundary_state_bytes(ref_cfg, batch, seq)
    d, di = cfg.d_model, cfg.ssm.d_inner(cfg.d_model)
    H, s = cfg.ssm.n_heads(d), cfg.ssm
    state = (batch * H * s.head_dim * s.d_state * 4
             + batch * (s.d_conv - 1) * (di + 2 * s.n_groups * s.d_state) * 2)
    assert got == state
    assert segmentation.hidden_payload_bytes(cfg, 4, 4096, 2) == 50_331_648
    for streaming in (False, True):
        points = segmentation.layer_split_points(cfg, batch, seq,
                                                 streaming=streaming)
        assert ([dataclasses.asdict(p) for p in points]
                == [dataclasses.asdict(p) for p in
                    ref_segmentation.layer_split_points(
                        ref_cfg, batch, seq, streaming=streaming)])
        assert len(points) == cfg.num_groups() + 1
        assert points[1].payload_bytes == (
            segmentation.hidden_payload_bytes(cfg, batch, seq, 2)
            + (state if streaming else 0))
