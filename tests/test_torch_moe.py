"""Port parity, Mixture-of-Experts: ``models/moe.py`` piece by piece
(capacity, router, dispatch, experts, the layer) and the MoE LM as a
whole (``forward_hidden``, ``run_layer_range``, the layer-split engines,
prefill + decode) against the reference's, on reduced OLMoE-1B-7B
(expert-parallel by default) and reduced granite-MoE-3B (TP within
expert by default); on one device both are the same computation.
Parameters are initialised in JAX (one ``init_params`` per arch) and
converted; inputs come from numpy.

Tolerances.  Integers are equal to the bit: capacities, expert ids (ties
included: the lower id first, as ``jax.lax.top_k``), the keep mask and
every choice's slot in its expert's queue (read off the reference's own
dispatch buffer).  fp32: the router's gates 2e-6 and aux losses 1e-5
(relative), one layer 5e-6, the whole model 5e-5, as
``tests/test_torch_lm.py`` (summation order only).  bf16 expert FFNs:
one bf16 ulp (2**-7 relative).  The whole model runs in fp32: in bf16
the frameworks round at different places, which moves near-ties between
the k-th and the (k+1)-th expert and changes a token's output by O(1).
Decode is compared at ``capacity_factor = 16``, as the reference's own
test does (``tests/test_models.py``): the capacity depends on the number
of tokens in the call, so at the published 1.25 a decode step may drop
what the forward keeps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.core.transport import LOCAL_LINK as REF_LOCAL_LINK
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tr
from repro.serving import engine as ref_engine
from repro_torch.configs import reduced_config
from repro_torch.convert import from_jax_params
from repro_torch.core.transport import LOCAL_LINK
from repro_torch.models import moe
from repro_torch.models import transformer as tr
from repro_torch.serving import engine

# The models here are tiny: one thread each, or the test workers that
# share a machine fight over cores inside PyTorch's thread pool.
torch.set_num_threads(1)

ARCHS = ["olmoe-1b-7b", "granite-moe-3b-a800m"]
B, S = 2, 40


@pytest.fixture(scope="module")
def models():
    """{arch: (reference cfg, reference params, port cfg, port params)} in
    fp32, one JAX init per arch for the whole file."""
    out = {}
    for arch in ARCHS:
        ref_cfg = dataclasses.replace(ref_reduced_config(arch),
                                      param_dtype="float32")
        ref_params = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32),
            ref_tr.init_params(ref_cfg, jax.random.PRNGKey(0)))
        params = from_jax_params(
            jax.tree_util.tree_map(np.asarray, ref_params), "cpu")
        cfg = dataclasses.replace(reduced_config(arch), param_dtype="float32")
        out[arch] = (ref_cfg, ref_params, cfg, params)
    return out


def _with_factor(ref_cfg, cfg, factor):
    def one(c):
        return dataclasses.replace(
            c, moe=dataclasses.replace(c.moe, capacity_factor=factor))
    return one(ref_cfg), one(cfg)


def _layer0(models, arch):
    """Layer 0's MoE parameters on both sides."""
    _, ref_params, _, params = models[arch]
    ref_p = jax.tree_util.tree_map(lambda a: a[0],
                                   ref_params["blocks"]["b0"]["moe"])
    return ref_p, {k: v[0] for k, v in params["blocks"]["b0"]["moe"].items()}


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _tokens(cfg, seed=1, batch=B, seq=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


# --------------------------------------------------------------------------
# the pieces
# --------------------------------------------------------------------------
@pytest.mark.parametrize("factor", [0.5, 1.0, 1.25, 16.0])
def test_capacity_is_bit_equal(factor):
    for T in (1, 2, 7, 80, 4096, 16384):
        for k in (1, 2, 8):
            for E in (8, 40, 64):
                assert (moe._capacity(T, k, E, factor)
                        == ref_moe._capacity(T, k, E, factor))
    # the decode and prefill capacities of full-width OLMoE (64 experts,
    # top-8, 1.25)
    if factor == 1.25:
        assert [moe._capacity(T, 8, 64, factor) for T in (1, 8, 16384)] == [
            1, 2, 2560]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_has_the_reference_tree(models, arch):
    """Same keys, shapes and dtypes as the reference's ``init_moe``, for
    swiglu (w_gate, w_up) and the other activations (w_in)."""
    for act in ("swiglu", "relu2"):
        cfg = dataclasses.replace(reduced_config(arch), activation=act)
        ref_cfg = dataclasses.replace(ref_reduced_config(arch),
                                      activation=act)
        want = ref_moe.init_moe(jax.random.PRNGKey(3), ref_cfg)
        got = moe.init_moe(torch.Generator().manual_seed(3), cfg, "cpu")
        assert got.keys() == want.keys()
        for name, leaf in want.items():
            assert tuple(got[name].shape) == leaf.shape, name
            assert str(got[name].dtype).split(".")[-1] == str(leaf.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches(models, arch):
    """Ids bit-equal; gates (renormalised over the k chosen) and the aux
    losses within fp32 summation noise."""
    ref_p, p = _layer0(models, arch)
    k = models[arch][2].moe.top_k
    x = _x((80, 64), seed=11)
    want_g, want_i, want_aux = ref_moe._route(jnp.asarray(x), ref_p["router"],
                                              k)
    gates, ids, aux = moe._route(torch.from_numpy(x), p["router"], k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_i))
    _close(gates, want_g, 2e-6)
    for name in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[name]), float(want_aux[name]),
                                   rtol=1e-5)


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_route_ties_take_the_lower_id(k):
    """A router whose columns repeat in pairs (0 = 1, 2 = 3, ...) and one
    whose columns are all equal; inputs and weights are small multiples of
    1/8, so every logit is exact in both frameworks and equal columns tie
    exactly.  Ids equal the reference's to the bit, and among equals the
    lower id comes first."""
    rng = np.random.default_rng(12)
    x = rng.integers(-2, 3, (24, 16)).astype(np.float32)
    half = rng.integers(-2, 3, (16, 4)).astype(np.float32) / 8
    for router in (np.repeat(half, 2, axis=1),
                   np.repeat(half[:, :1], 8, axis=1)):
        _, want, _ = ref_moe._route(jnp.asarray(x), jnp.asarray(router), k)
        _, got, _ = moe._route(torch.from_numpy(x), torch.from_numpy(router),
                               k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        logits = x @ router
        for row, ids in zip(logits, got.numpy()):
            for a, b in zip(ids[:-1], ids[1:]):
                assert row[a] > row[b] or (row[a] == row[b] and a < b)
    assert (got.numpy() == np.arange(k)).all()   # all tie: ids 0 .. k-1


def _reference_slots(ref_p, x, gates, ids, capacity, activation,
                     monkeypatch):
    """The reference's dispatch with its experts replaced by the identity:
    the (E, C, d) buffer its scatter built, and its output.  Token t's row
    carries t + 1 in column 0, so the buffer says where each choice went."""
    seen = []

    def identity(p, buf, act):
        seen.append(np.asarray(buf))
        return buf
    monkeypatch.setattr(ref_moe, "_expert_ffn", identity)
    y = ref_moe._dispatch_compute_combine(ref_p, jnp.asarray(x),
                                          jnp.asarray(gates),
                                          jnp.asarray(ids), capacity,
                                          activation)
    monkeypatch.undo()
    (buf,) = seen
    T, k = ids.shape
    keep = np.zeros((T, k), bool)
    slot = np.full((T, k), capacity)
    for t in range(T):
        for j in range(k):
            rows = np.flatnonzero(buf[ids[t, j], :, 0] == t + 1)
            assert len(rows) <= 1
            if len(rows):
                keep[t, j], slot[t, j] = True, rows[0]
    return buf, np.asarray(y), keep.reshape(-1), slot.reshape(-1)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor", [None, 0.5])
def test_dispatch_matches(models, arch, factor, monkeypatch):
    """At the reduced config's capacity factor and at 0.5, where choices
    are dropped: each choice's keep bit and slot equal the reference's
    (read off its dispatch buffer, with the experts replaced by the
    identity on both sides); the buffers are equal to the bit; with the
    experts in place the outputs agree to fp32 tolerance; and
    ``routing_stats`` counts the reference's drops."""
    ref_cfg, _, cfg, _ = models[arch]
    if factor is not None:
        ref_cfg, cfg = _with_factor(ref_cfg, cfg, factor)
    ref_p, p = _layer0(models, arch)
    T, m = 80, cfg.moe
    x = _x((T, cfg.d_model), seed=13)
    x[:, 0] = np.arange(1, T + 1)
    gates, ids, _ = ref_moe._route(jnp.asarray(x), ref_p["router"], m.top_k)
    gates, ids = np.array(gates), np.array(ids)
    cap = moe._capacity(T, m.top_k, m.num_experts, m.capacity_factor)
    want_buf, want_y, want_keep, want_slot = _reference_slots(
        ref_p, x, gates, ids, cap, cfg.activation, monkeypatch)
    if factor == 0.5:
        assert not want_keep.all()            # drops happen here

    _, keep, slot = moe._slots(torch.from_numpy(ids).long(), cap, 0,
                               m.num_experts)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    seen = []

    def identity(p, buf, act):
        seen.append(buf.clone())
        return buf
    xt, gt, it = (torch.from_numpy(a) for a in (x, gates, ids))
    monkeypatch.setattr(moe, "_expert_ffn", identity)
    y = moe._dispatch_compute_combine(p, xt, gt, it.long(), cap,
                                      cfg.activation)
    monkeypatch.undo()
    np.testing.assert_array_equal(seen[0].numpy(), want_buf)
    _close(y, want_y, 1e-6)

    want = ref_moe._dispatch_compute_combine(
        ref_p, jnp.asarray(x), jnp.asarray(gates), jnp.asarray(ids), cap,
        cfg.activation)
    got = moe._dispatch_compute_combine(p, xt, gt, it.long(), cap,
                                        cfg.activation)
    _close(got, want, 5e-6)
    stats = moe.routing_stats(p, xt[None], cfg)
    assert stats["capacity"] == cap
    assert stats["choices"] == T * m.top_k
    assert stats["dropped"] == int((~want_keep).sum())


@pytest.mark.parametrize("offset", [0, 4])
def test_dispatch_over_a_slice_of_experts_matches(models, offset,
                                                  monkeypatch):
    """The expert-parallel bookkeeping on one device: experts [offset,
    offset + 4) of 8 held locally, choices of the others sent to the
    overflow row.  The dispatch buffers (experts replaced by the
    identity on both sides) are equal to the bit, the outputs within fp32
    tolerance."""
    ref_cfg, _, cfg, _ = models["olmoe-1b-7b"]
    ref_p, p = _layer0(models, "olmoe-1b-7b")
    experts = ("w_gate", "w_up", "w_down")
    ref_p = {k: v[offset:offset + 4] for k, v in ref_p.items()
             if k in experts}
    p = {k: v[offset:offset + 4] for k, v in p.items() if k in experts}
    T, m = 80, cfg.moe
    x = _x((T, cfg.d_model), seed=17)
    gates, ids, _ = ref_moe._route(jnp.asarray(x), models["olmoe-1b-7b"][1][
        "blocks"]["b0"]["moe"]["router"][0], m.top_k)
    cap = moe._capacity(T, m.top_k, 4, 0.5)
    kw = dict(expert_offset=offset, n_local_experts=4)
    seen = []

    def identity(p, buf, act):
        seen.append(np.array(buf))
        return buf
    xt, gt, it = (torch.from_numpy(np.array(a)) for a in (x, gates, ids))
    for mod, args in ((ref_moe, (ref_p, jnp.asarray(x), gates, ids)),
                      (moe, (p, xt, gt, it.long()))):
        monkeypatch.setattr(mod, "_expert_ffn", identity)
        mod._dispatch_compute_combine(*args, cap, cfg.activation, **kw)
        monkeypatch.undo()
    np.testing.assert_array_equal(seen[1], seen[0])
    assert 0 < (seen[0][..., 0] != 0).sum() < T * m.top_k
    want = ref_moe._dispatch_compute_combine(ref_p, jnp.asarray(x), gates,
                                             ids, cap, cfg.activation, **kw)
    got = moe._dispatch_compute_combine(p, xt, gt, it.long(), cap,
                                        cfg.activation, **kw)
    _close(got, want, 5e-6)


@pytest.mark.parametrize("activation", ["swiglu", "gelu", "relu2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ffn_matches(activation, dtype):
    ref_cfg = dataclasses.replace(ref_reduced_config("olmoe-1b-7b"),
                                  activation=activation, param_dtype=dtype)
    ref_p = ref_moe.init_moe(jax.random.PRNGKey(4), ref_cfg)
    E, f = ref_cfg.moe.num_experts, ref_cfg.moe.d_ff
    buf = jnp.asarray(_x((E, 6, ref_cfg.d_model), seed=14),
                      getattr(jnp, dtype))
    want = ref_moe._expert_ffn(ref_p, buf, activation)
    p = from_jax_params(jax.tree_util.tree_map(np.asarray, ref_p), "cpu")
    assert ("w_gate" in p) == (activation == "swiglu")
    assert tuple(p["w_down"].shape) == (E, f, ref_cfg.d_model)
    got = moe._expert_ffn(p, from_jax_params(np.asarray(buf), "cpu"),
                          activation)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, 5e-6 if dtype == "float32" else 2 ** -7)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches(models, arch):
    """The layer on (B, S, d), its aux losses too; a ``ShardCtx`` without
    a mesh is the same computation as ``LOCAL_CTX``."""
    ref_cfg, _, cfg, _ = models[arch]
    ref_p, p = _layer0(models, arch)
    x = _x((B, S, cfg.d_model), seed=15)
    want, want_aux = ref_moe.apply_moe(ref_p, jnp.asarray(x), ref_cfg)
    got, aux = moe.apply_moe(p, torch.from_numpy(x), cfg)
    _close(got, want, 5e-6)
    for name in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[name]), float(want_aux[name]),
                                   rtol=1e-5)
    again, _ = moe.apply_moe(p, torch.from_numpy(x), cfg, moe.ShardCtx())
    assert torch.equal(again, got)


def test_apply_moe_on_a_mesh_names_a10(models):
    _, _, cfg, _ = models["olmoe-1b-7b"]
    _, p = _layer0(models, "olmoe-1b-7b")
    x = torch.from_numpy(_x((1, 4, cfg.d_model), seed=16))
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        moe.apply_moe(p, x, cfg, moe.ShardCtx(mesh=object()))


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_has_the_reference_tree(models, arch):
    ref_cfg = ref_reduced_config(arch)
    want = _flat(jax.eval_shape(lambda: ref_tr.init_params(
        ref_cfg, jax.random.PRNGKey(0))))
    got = _flat(tr.init_params(reduced_config(arch),
                               torch.Generator().manual_seed(0), "cpu"))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert tuple(got[path].shape) == leaf.shape, path
        assert str(got[path].dtype).split(".")[-1] == str(leaf.dtype), path


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches(models, arch):
    """The hidden state and the aux losses summed over the layers."""
    ref_cfg, ref_params, cfg, params = models[arch]
    toks = _tokens(cfg)
    want, want_aux, _ = ref_tr.forward_hidden(
        ref_params, {"tokens": jnp.asarray(toks)}, ref_cfg)
    got, aux, _ = tr.forward_hidden(params, {"tokens": torch.from_numpy(toks)},
                                    cfg)
    _close(got, want, 5e-5)
    assert aux.shape == (2,) and bool((aux > 0).all())
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_layer_range_matches(models, arch):
    """Every split point: groups [0, g) and [g, G) for g = 0 .. G."""
    ref_cfg, ref_params, cfg, params = models[arch]
    toks = _tokens(cfg, seed=8)
    x = ref_tr.embed_inputs(ref_params, {"tokens": jnp.asarray(toks)},
                            ref_cfg)
    xt = from_jax_params(np.asarray(x), "cpu")
    G = cfg.num_groups()
    assert G >= 2
    for g in range(G + 1):
        for start, stop in ((0, g), (g, G)):
            want = ref_tr.run_layer_range(
                ref_params, x, ref_cfg, ref_moe.LOCAL_CTX, start_group=start,
                stop_group=stop, positions=jnp.arange(S))
            got = tr.run_layer_range(
                params, xt, cfg, moe.LOCAL_CTX, start_group=start,
                stop_group=stop, positions=torch.arange(S))
            _close(got, want, 5e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_split_engines_match(models, arch):
    """The engines at every split point: the cloud's fp16 payload against
    the reference cloud's, and the device side given the same payload on
    both sides, against the reference's device side and against the
    port's one-machine forward."""
    ref_cfg, ref_params, cfg, params = models[arch]
    toks = _tokens(cfg, seed=9, batch=2, seq=16)
    ref_cloud = ref_engine.LayerSplitEngine(ref_params, ref_cfg,
                                            link=REF_LOCAL_LINK)
    ref_dev = ref_engine.LayerSplitDevice(ref_params, ref_cfg)
    cloud = engine.LayerSplitEngine(params, cfg, link=LOCAL_LINK,
                                    device="cpu")
    dev = engine.LayerSplitDevice(params, cfg, device="cpu")
    hidden, _, _ = tr.forward_hidden(params, {"tokens": torch.from_numpy(
        toks)}, cfg)
    one = tr.unembed(params, hidden[:, -1:], cfg).numpy()
    for g in range(cfg.num_groups() + 1):
        ref_payload, ref_t = ref_cloud.process({"tokens": toks}, g)
        payload, t_net = cloud.process({"tokens": toks}, g)
        assert payload.dtype == np.float16 and payload.shape == (
            2, 16, cfg.d_model)
        assert payload.nbytes == ref_payload.nbytes and t_net == ref_t
        np.testing.assert_allclose(payload.astype(np.float32),
                                   ref_payload.astype(np.float32),
                                   atol=2e-3, rtol=2e-3)   # one fp16 ulp
        got = dev.complete(payload, g).numpy()
        _close(got, ref_dev.complete(payload, g), 5e-5)
        np.testing.assert_allclose(got, one, atol=0.15, rtol=0.1)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches(models, arch):
    """At capacity factor 16 (see the module's docstring): the logits
    after the prompt and after each of 4 teacher-forced steps against the
    reference's, and the last against the port's own forward over the
    whole sequence."""
    ref_cfg, ref_params, cfg, params = models[arch]
    ref_cfg, cfg = _with_factor(ref_cfg, cfg, 16.0)
    prompt, steps = 16, 4
    toks = _tokens(cfg, seed=10, seq=prompt + steps)
    want, ref_cache = ref_tr.prefill(
        ref_params, {"tokens": jnp.asarray(toks[:, :prompt])}, ref_cfg,
        pad_to=prompt + steps)
    got, cache = tr.prefill(params, {"tokens": torch.from_numpy(
        toks[:, :prompt])}, cfg, pad_to=prompt + steps)
    V = cfg.vocab_size
    _close(got[..., :V], np.asarray(want)[..., :V], 5e-5)
    for t in range(prompt, prompt + steps):
        tok = toks[:, t:t + 1]
        want, ref_cache = ref_tr.decode_step(ref_params, jnp.asarray(tok),
                                             ref_cache, jnp.int32(t),
                                             ref_cfg)
        got, cache = tr.decode_step(params, torch.from_numpy(tok), cache, t,
                                    cfg)
        _close(got[..., :V], np.asarray(want)[..., :V], 5e-5)
    hidden, _, _ = tr.forward_hidden(params, {"tokens": torch.from_numpy(
        toks)}, cfg)
    _close(got, tr.unembed(params, hidden[:, -1:], cfg), 5e-5)
