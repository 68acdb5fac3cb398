"""Port parity: RegNet-Y, the paper's image-classification model, and its
segmentation at the split points of paper Table 1.

Parameters are initialised by the reference and converted (the
reference draws each block from its own ``fold_in`` key, which the
port's generator cannot reproduce); inputs are drawn with numpy and
handed to both sides.  Both sides compute in fp32 and differ in
summation order only; each tolerance is stated with the largest
difference seen when the test was written.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import regnet_y_128gf as ref_configs
from repro.models import regnet as ref_regnet
from repro_torch.configs import regnet_y_128gf as configs
from repro_torch.convert import from_jax_params, tree_map
from repro_torch.models import regnet

# The models here are tiny: one thread each, or the test workers that
# share a machine fight over cores inside PyTorch's thread pool.
torch.set_num_threads(1)

B = 2
#: paper Table 1's activation bytes at batch 1, 384x384 (fp32)
TABLE1_BYTES = {"stem": 4_718_592, "block1": 19_464_192,
                "block2": 9_732_096, "block3": 6_690_816,
                "block4": 4_257_792, "avgpool": 29_568}
#: largest seen: 2.4e-7 on blocks and segments (values of order 1),
#: 1.6e-8 on the reduced model's logits (of order 0.1)
ATOL, RTOL = 1e-5, 1e-5


def _to_torch(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def world():
    ref_cfg = ref_configs.reduced()
    cfg = configs.reduced()
    ref_params = ref_regnet.init_params(ref_cfg, jax.random.PRNGKey(0))
    images = np.random.default_rng(0).standard_normal(
        (B, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
    return dict(cfg=cfg, ref_cfg=ref_cfg, ref_params=ref_params,
                params=_to_torch(ref_params), images=images)


# c_in, c_out, stride, group width: without and with the projection
# shortcut, at 2 and at 11 groups (RegNet-Y-128GF's stages have 2, 4, 11
# and 28)
BLOCKS = [(16, 16, 1, 8), (8, 16, 2, 8), (44, 44, 1, 4), (24, 44, 2, 4)]


@pytest.mark.parametrize("c_in,c_out,stride,gw", BLOCKS)
def test_yblock_is_the_reference_s(c_in, c_out, stride, gw):
    ref_p = ref_regnet.init_yblock(jax.random.PRNGKey(c_in + c_out), c_in,
                                   c_out, stride, gw, 0.25)
    assert ("proj" in ref_p) == (stride != 1 or c_in != c_out)
    x = np.random.default_rng(c_out).standard_normal(
        (B, c_in, 12, 12)).astype(np.float32)
    groups = c_out // gw
    want = ref_regnet.apply_yblock(ref_p, x, stride, groups)
    with torch.inference_mode():
        got = regnet.apply_yblock(_to_torch(ref_p), torch.from_numpy(x),
                                  stride, groups)
    assert tuple(got.shape) == want.shape
    _close(got, want)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves(v, f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _leaves(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


ORDER = ("input",) + regnet.SPLIT_POINTS + ("logits",)


@pytest.mark.parametrize("start,stop", list(zip(ORDER, ORDER[1:])))
def test_each_segment_is_the_reference_s(world, start, stop):
    cfg, ref_cfg = world["cfg"], world["ref_cfg"]
    x = np.array(ref_regnet.run_from(world["ref_params"], ref_cfg,
                                     world["images"], "input", start)
                 if start != "input" else world["images"])
    want = ref_regnet.run_from(world["ref_params"], ref_cfg, x, start, stop)
    with torch.inference_mode():
        got = regnet.run_from(world["params"], cfg, torch.from_numpy(x),
                              start, stop)
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_forward_and_split_are_the_reference_s(world):
    cfg, ref_cfg = world["cfg"], world["ref_cfg"]
    want = ref_regnet.forward(world["ref_params"], ref_cfg, world["images"])
    with torch.inference_mode():
        images = torch.from_numpy(world["images"])
        got = regnet.forward(world["params"], cfg, images)
        assert tuple(got.shape) == (B, cfg.num_classes)
        _close(got, want)
        for point in regnet.SPLIT_POINTS:
            act = regnet.run_from(world["params"], cfg, images, "input",
                                  point)
            split = regnet.run_from(world["params"], cfg, act, point,
                                    "logits")
            torch.testing.assert_close(split, got, atol=0.0, rtol=0.0)


@pytest.mark.parametrize("full", [False, True])
def test_split_activations_are_the_reference_s(full):
    cfg = configs.CONFIG if full else configs.reduced()
    ref_cfg = ref_configs.CONFIG if full else ref_configs.reduced()
    got = regnet.split_activations(cfg)
    assert got == ref_regnet.split_activations(ref_cfg)
    if full:
        assert {name: nbytes for name, _, nbytes in got} == TABLE1_BYTES


def test_full_width_parameters_are_the_reference_s():
    """RegNet-Y-128GF's parameter tree on the ``meta`` device, leaf for
    leaf against the reference's ``jax.eval_shape``: 644,733,224 fp32
    numbers, nothing allocated."""
    ref = jax.eval_shape(lambda: ref_regnet.init_params(
        ref_configs.CONFIG, jax.random.PRNGKey(0)))
    own = regnet.init_params(configs.CONFIG, torch.Generator(), "meta")
    shapes = tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), own)
    want = jax.tree_util.tree_map(
        lambda s: (tuple(s.shape), str(s.dtype)), ref)
    assert shapes == want
    leaves = _leaves(own)
    assert all(t.device.type == "meta" for t in leaves.values())
    assert sum(t.numel() for t in leaves.values()) == 644_733_224
