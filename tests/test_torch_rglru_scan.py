"""Port parity: the RG-LRU scan and the RG-LRU block.  The scan kernel's
wrapper (its plain PyTorch version on the CPU) against the reference's
Pallas kernel in interpret mode and its associative-scan oracle, and
``models/rglru.py`` against the reference's, on the same numpy inputs and
parameters initialised in JAX.

Tolerances: the scan 2e-5 absolute with a in [0.8, 0.999], as
``tests/test_kernels.py`` holds the Pallas kernel (the Pallas kernel
steps sequentially, the oracles associate in a tree).  The block in fp32
5e-6; in bf16 one bf16 step (2^-8 relative) of the outputs, from
roundings the two frameworks place differently.
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
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro.models import rglru as ref_rglru
from repro_torch.configs import reduced_config
from repro_torch import convert
from repro_torch.convert import from_jax_params
from repro_torch.kernels import _build, ops
from repro_torch.kernels import rglru_scan as lru
from repro_torch.models import rglru

#: the port's trees as numpy, bf16 leaves viewed as ml_dtypes' bf16
to_numpy_params = functools.partial(convert.to_numpy_params,
                                    bf16=ml_dtypes.bfloat16)

# The models here are tiny: one thread each, or the test workers that
# share a machine fight over cores inside PyTorch's thread pool.
torch.set_num_threads(1)

ATOL = 2e-5
ARCH = "recurrentgemma-9b"


def _inputs(B, S, W, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.8, 0.999, size=(B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    return a, b, h0


def _sequential_f64(a, b, h0):
    h = np.zeros(a.shape, np.float64)
    prev = h0.astype(np.float64) if h0 is not None else 0.0
    for t in range(a.shape[1]):
        prev = a[:, t].astype(np.float64) * prev + b[:, t]
        h[:, t] = prev
    return h


# the reference's kernel grid (tests/test_kernels.py) and odd lengths,
# which take the other branch of the associative scan's recursion
@pytest.mark.parametrize("B,S,W", [(2, 128, 256), (1, 512, 128), (3, 96, 200),
                                   (2, 37, 16), (1, 1, 8)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_scan_matches_reference(B, S, W, with_h0):
    a, b, h0 = _inputs(B, S, W)
    h0 = h0 if with_h0 else None
    t = [None if x is None else torch.from_numpy(x) for x in (a, b, h0)]
    got = ops.rglru_scan(*t).numpy()
    j = [None if x is None else jnp.asarray(x) for x in (a, b, h0)]
    assert got.dtype == np.float32 and got.shape == (B, S, W)
    np.testing.assert_allclose(got, np.asarray(ref_ops.rglru_scan(*j)),
                               atol=ATOL, err_msg="pallas")
    np.testing.assert_allclose(got, np.asarray(ref_oracle.rglru_scan_ref(*j)),
                               atol=ATOL, err_msg="oracle")
    np.testing.assert_allclose(got, _sequential_f64(a, b, h0), atol=ATOL,
                               err_msg="float64 loop")


def test_cpu_tensors_never_touch_the_kernel(monkeypatch):
    def no_library():
        raise AssertionError("the CUDA library was asked for on the CPU")
    monkeypatch.setattr(_build, "load_library", no_library)
    before = lru.launch_count
    a, b, _ = _inputs(1, 16, 8)
    ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert lru.launch_count == before


def test_registry_routes_rglru_through_the_wrapper():
    assert ops.kernel_registry()["rglru"] is ops.rglru_scan


# --------------------------------------------------------------------------
# models/rglru.py
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def block():
    """RG-LRU block parameters of the reduced RecurrentGemma, from JAX."""
    ref_cfg = ref_reduced_config(ARCH)
    ref_p = ref_rglru.init_rglru_block(jax.random.PRNGKey(3), ref_cfg)
    return ref_cfg, jax.tree_util.tree_map(np.asarray, ref_p)


def _cfgs(ref_cfg, dtype):
    return (dataclasses.replace(ref_cfg, param_dtype=dtype),
            dataclasses.replace(reduced_config(ARCH), param_dtype=dtype))


def _cast_tree(tree, dtype):
    """The JAX tree in the config's dtype: low-precision leaves are cast,
    fp32 leaves (Lambda, gate biases) stay."""
    want = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return jax.tree_util.tree_map(
        lambda a: a if a.dtype == np.float32 else jnp.asarray(a, want), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("use_registry", [False, True])
def test_apply_rglru_block_matches(block, dtype, with_state, use_registry):
    ref_cfg, np_p = block
    rcfg, cfg = _cfgs(ref_cfg, dtype)
    ref_p = _cast_tree(np_p, dtype)
    p = from_jax_params(jax.tree_util.tree_map(np.asarray, ref_p), "cpu")
    B, S, d = 2, 24, cfg.d_model
    W = cfg.rglru.lru_width
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((B, S, d)), getattr(jnp, dtype))
    state = None
    if with_state:
        state = {"h": jnp.asarray(rng.standard_normal((B, W)), jnp.float32),
                 "conv": jnp.asarray(rng.standard_normal(
                     (B, cfg.rglru.d_conv - 1, W)), getattr(jnp, dtype))}
    want, want_state = ref_rglru.apply_rglru_block(ref_p, x, rcfg,
                                                   state=state)
    t_state = (None if state is None else
               from_jax_params(jax.tree_util.tree_map(np.asarray, state),
                               "cpu"))
    got, got_state = rglru.apply_rglru_block(
        p, from_jax_params(np.asarray(x), "cpu"), cfg, state=t_state,
        kernel_fn=ops.rglru_scan if use_registry else None)
    assert got.dtype == getattr(torch, dtype)
    tol = (dict(atol=5e-6, rtol=5e-6) if dtype == "float32"
           else dict(atol=2 ** -8, rtol=2 ** -8))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    gs, ws = to_numpy_params(got_state), jax.tree_util.tree_map(np.asarray,
                                                                want_state)
    np.testing.assert_allclose(gs["h"], ws["h"], atol=5e-5 if dtype ==
                               "float32" else 2e-2)
    np.testing.assert_array_equal(np.asarray(gs["conv"], np.float32),
                                  np.asarray(ws["conv"], np.float32))


def test_block_scans_through_the_wrapper_by_default(block, monkeypatch):
    """With no ``kernel_fn`` the block calls the dispatching wrapper, so a
    CUDA tensor reaches the kernel whoever calls it."""
    calls = []

    def counting(a, b, h0=None):
        calls.append(tuple(a.shape))
        return lru.rglru_scan_ref(a, b, h0)
    monkeypatch.setattr(lru, "rglru_scan", counting)
    _, np_p = block
    cfg = reduced_config(ARCH)
    p = from_jax_params(np_p, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)).to(p["w_rec_in"].dtype)
    rglru.apply_rglru_block(p, x, cfg)
    assert calls == [(2, 8, cfg.rglru.lru_width)]


def test_init_rglru_state_matches(block):
    ref_cfg, _ = block
    cfg = reduced_config(ARCH)
    want = ref_rglru.init_rglru_state(3, ref_cfg)
    got = rglru.init_rglru_state(3, cfg, device="cpu")
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert not got[k].any()


def test_port_init_has_the_reference_block_tree(block):
    """Same keys, shapes and dtypes; Lambda in the reference's range."""
    ref_cfg, np_p = block
    cfg = reduced_config(ARCH)
    own = rglru.init_rglru_block(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    assert own.keys() == np_p.keys()
    for k, leaf in np_p.items():
        assert tuple(own[k].shape) == leaf.shape, k
        assert str(own[k].dtype).split(".")[-1] == str(leaf.dtype), k
    a = np.exp(-cfg.rglru.c_constant * np.log1p(np.exp(own["lam"].numpy())))
    assert np.all((a > 0.9 - 1e-6) & (a < 0.999 + 1e-6))
