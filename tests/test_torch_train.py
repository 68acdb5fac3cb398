"""Port parity, training (ROADMAP A9): ``lm_loss``, ``train_forward`` and
its gradients, AdamW (``lr_schedule``, ``apply_updates``), the int8
gradient compression, the data pipeline and ``TrainLoop``, against the
reference's, on reduced configs in fp32.  Parameters are initialised in
JAX (one init a model for the whole file) and converted; batches come
from the data pipeline (numpy).

Tolerances: losses rtol 1e-5; gradients rtol 1e-4 and atol 2e-6 of the
largest gradient of the leaf (the port sums the same fp32 products in
another order, and recomputes each group's blocks in the backward pass
as the reference's remat does); AdamW's state 1e-6 relative after 3
steps; ``TrainLoop`` over 10 steps: losses rtol 1e-4, parameters atol
1e-4 (AdamW's normalised steps carry the gradients' rounding into the
weights at the learning rate's scale).  The batch pipeline is held to
the bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import batch_for_config as ref_batch_for_config
from repro.distributed import compression as ref_comp
from repro.models import transformer as ref_tr
from repro.train import optimizer as ref_opt
from repro.train import train_loop as ref_loop
from repro_torch.configs import reduced_config
from repro_torch.convert import from_jax_params, tree_leaves
from repro_torch.data.pipeline import DataConfig, batch_for_config
from repro_torch.distributed import compression
from repro_torch.models import transformer as tr
from repro_torch.train import optimizer, train_loop

torch.set_num_threads(1)

ARCHS = ("smollm-135m", "mamba2-780m", "recurrentgemma-9b", "olmoe-1b-7b",
         "internvl2-1b")
SEQ, BATCH = 32, 2


@pytest.fixture(scope="module")
def models():
    """{arch: (reference cfg, params, port cfg, params)}, fp32."""
    out = {}
    for arch in ARCHS:
        ref_cfg = dataclasses.replace(ref_reduced_config(arch),
                                      param_dtype="float32")
        ref_params = jax.jit(lambda key: ref_tr.init_params(ref_cfg, key))(
            jax.random.PRNGKey(1))
        params = from_jax_params(
            jax.tree_util.tree_map(np.asarray, ref_params), "cpu")
        cfg = dataclasses.replace(reduced_config(arch), param_dtype="float32")
        out[arch] = (ref_cfg, ref_params, cfg, params)
    return out


def _batch(cfg, step=0, seq=SEQ):
    return batch_for_config(cfg, DataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=seq, global_batch=BATCH),
                            step)


def _np(tree):
    return [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(tree)]


def _close_leaves(got, want, rtol, atol_share):
    got = [t.detach().float().numpy() for t in tree_leaves(got)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=atol_share * np.abs(w).max() + 1e-30)


def test_lm_loss_masks_the_padded_vocab(models):
    """``lm_loss`` in chunks (3 of 12 positions and a remainder), the
    padded vocabulary masked out of the lse, the z-term kept, a mask with
    zeros: equal to the reference's; and the padded columns get no
    gradient."""
    ref_cfg, ref_params, cfg, params = models["smollm-135m"]
    assert cfg.padded_vocab() != cfg.vocab_size
    rng = np.random.default_rng(2)
    h = rng.standard_normal((BATCH, 14, cfg.d_model)).astype(np.float32)
    t = rng.integers(0, cfg.vocab_size, (BATCH, 14)).astype(np.int32)
    m = (rng.random((BATCH, 14)) > 0.2).astype(np.int32)
    want = jax.jit(lambda p, *a: ref_tr.lm_loss(p, *a, ref_cfg, chunk=4))(
        ref_params, jnp.asarray(h), jnp.asarray(t), jnp.asarray(m))
    ht = torch.from_numpy(h).requires_grad_()
    got = tr.lm_loss(params, ht, torch.from_numpy(t), torch.from_numpy(m),
                     cfg, chunk=4)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    emb = params["embed"].detach().requires_grad_()
    loss = tr.lm_loss(dict(params, embed=emb), ht, torch.from_numpy(t),
                      torch.from_numpy(m), cfg)
    loss.backward()
    assert float(emb.grad[cfg.vocab_size:].abs().max()) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_gradients_match(models, arch):
    """The loss, its metrics (the MoE aux terms) and every leaf's
    gradient against ``jax.value_and_grad(train_forward)``; the internvl2
    batch carries its patch prefix."""
    ref_cfg, ref_params, cfg, params = models[arch]
    batch = _batch(cfg)
    assert ("frontend" in batch) == (arch == "internvl2-1b")
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: ref_tr.train_forward(p, b, ref_cfg), has_aux=True))(
            ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    (got, got_m), grads = train_loop.value_and_grad(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=1e-5, atol=1e-7)
    _close_leaves(grads, _np(want_g), 1e-4, 2e-6)


def test_lr_schedule_matches():
    cfg = optimizer.AdamWConfig(peak_lr=1.0, warmup_steps=10,
                                total_steps=100, min_lr_ratio=0.1)
    ref = ref_opt.AdamWConfig(peak_lr=1.0, warmup_steps=10, total_steps=100,
                              min_lr_ratio=0.1)
    for s in (0, 3, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(
            float(optimizer.lr_schedule(cfg, torch.tensor(s).int())),
            float(ref_opt.lr_schedule(ref, jnp.int32(s))), rtol=1e-6)


def test_apply_updates_three_steps(models):
    """Three AdamW steps with clipping, warmup and decay of the ndim >= 2
    leaves only: the params, masters, m, v, lr and grad norm against the
    reference's, from the same gradients."""
    ref_cfg, ref_params, cfg, params = models["smollm-135m"]
    hp = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5)
    rng = np.random.default_rng(4)
    state, ref_state = (optimizer.init_opt_state(params),
                        ref_opt.init_opt_state(ref_params))
    ref_apply = jax.jit(ref_opt.apply_updates, static_argnums=0)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            ref_params)
        ref_params, ref_state, want = ref_apply(
            ref_opt.AdamWConfig(**hp), ref_params,
            jax.tree_util.tree_map(jnp.asarray, g), ref_state)
        params, state, got = optimizer.apply_updates(
            optimizer.AdamWConfig(**hp), params, from_jax_params(g, "cpu"),
            state)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-6)
    assert int(state["step"]) == int(ref_state["step"]) == 3
    _close_leaves(params, _np(ref_params), 1e-6, 1e-6)
    for k in ("master", "m", "v"):
        _close_leaves(state[k], _np(ref_state[k]), 1e-6, 1e-6)


def test_compression_matches():
    """``compress_tree_int8`` (leaves, their order, the mean MSE) and four
    steps of ``ErrorFeedback``: the codes round half to even on both
    sides, and the scales agree within one ulp."""
    rng = np.random.default_rng(6)
    tree = {"b": rng.standard_normal((5, 7)).astype(np.float32) * 3,
            "a": {"w": rng.standard_normal((64,)).astype(np.float32),
                  "s": np.float32(0.5)},
            # exact halves of the scale: ties to even
            "h": (np.arange(-6, 7, dtype=np.float32) + 0.5) / 127 * 6.5}
    want, want_err = ref_comp.compress_tree_int8(
        jax.tree_util.tree_map(jnp.asarray, tree))
    got, err = compression.compress_tree_int8(
        from_jax_params(tree, "cpu"))
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=2.4e-7,
                                   atol=np.abs(w).max() * 1.2e-7)
    np.testing.assert_allclose(float(err), float(want_err), rtol=1e-5)
    shapes = {"y": (16,), "x": (4, 8)}
    res = compression.ErrorFeedback.init(
        {k: torch.zeros(s) for k, s in shapes.items()})
    ref_res = ref_comp.ErrorFeedback.init(
        {k: jnp.zeros(s) for k, s in shapes.items()})
    for _ in range(4):
        g = {k: rng.standard_normal(s).astype(np.float32) * 1e-3
             for k, s in shapes.items()}
        comp, res = compression.ErrorFeedback.apply(
            from_jax_params(g, "cpu"), res)
        ref_c, ref_res = ref_comp.ErrorFeedback.apply(
            jax.tree_util.tree_map(jnp.asarray, g), ref_res)
        for a, b in ((comp, ref_c), (res, ref_res)):
            for x, y in zip(tree_leaves(a), jax.tree_util.tree_leaves(b)):
                y = np.asarray(y)
                np.testing.assert_allclose(x.numpy(), y, rtol=1e-6,
                                           atol=np.abs(y).max() * 1e-6)


@pytest.mark.parametrize("arch", ["smollm-135m", "internvl2-1b",
                                  "seamless-m4t-medium"])
def test_batch_for_config_is_bit_equal(arch):
    cfg, ref_cfg = reduced_config(arch), ref_reduced_config(arch)
    for step in (0, 5):
        got = batch_for_config(cfg, DataConfig(cfg.vocab_size, 40, 4, seed=3),
                               step)
        want = ref_batch_for_config(
            ref_cfg, RefDataConfig(cfg.vocab_size, 40, 4, seed=3), step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def _loops(models, monkeypatch, ckpt_dir, ref_dir):
    ref_cfg, ref_params, cfg, _ = models["smollm-135m"]
    # the port draws its weights from torch; the test hands it the
    # reference's tree instead
    tree = jax.tree_util.tree_map(np.asarray, ref_params)
    monkeypatch.setattr(tr, "init_params",
                        lambda c, gen, dev: from_jax_params(tree, dev))
    monkeypatch.setattr(ref_tr, "init_params", lambda c, key: ref_params)
    hp = dict(peak_lr=3e-3, warmup_steps=3, total_steps=20)
    dc = dict(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH)
    loop = train_loop.TrainLoop(cfg, DataConfig(**dc), train_loop.TrainConfig(
        optimizer=optimizer.AdamWConfig(**hp), checkpoint_dir=ckpt_dir,
        checkpoint_every=5, log_every=1), device="cpu")
    ref = ref_loop.TrainLoop(
        ref_cfg, RefDataConfig(**dc), ref_loop.TrainConfig(
            optimizer=ref_opt.AdamWConfig(**hp), checkpoint_dir=ref_dir,
            checkpoint_every=5, log_every=1))
    return loop, ref


def test_train_loop_matches_the_reference_and_resumes(models, monkeypatch,
                                                      tmp_path):
    """Ten steps of ``TrainLoop.run`` beside the reference's (the same
    batches, the same initial tree): every step's loss and the final
    parameters agree; then a new loop resumes from the checkpoint of
    step 10 and its 2 steps continue the reference's own resumed run."""
    loop, ref = _loops(models, monkeypatch, str(tmp_path / "port"),
                       str(tmp_path / "ref"))
    params, state, hist = loop.run(10)
    ref_params, _, ref_hist = ref.run(10)
    assert [h["step"] for h in hist] == [h["step"] for h in ref_hist]
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in ref_hist], rtol=1e-4)
    assert hist[-1]["loss"] < hist[0]["loss"]
    for g, w in zip(tree_leaves(params), _np(ref_params)):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4)
    assert int(state["step"]) == 10
    _, _, more = loop.run(2)
    _, _, ref_more = ref.run(2)
    assert [h["step"] for h in more] == [10, 11]
    np.testing.assert_allclose([h["loss"] for h in more],
                               [h["loss"] for h in ref_more], rtol=1e-4)
