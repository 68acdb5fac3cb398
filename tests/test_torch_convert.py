"""Port parity: parameter trees cross between the packages leaf for leaf."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import stable_diffusion_v1
from repro.models import diffusion as ref_diffusion
from repro_torch import convert
from repro_torch.models import diffusion

# The models here are tiny: one thread each, or the test workers that
# share a machine fight over cores inside PyTorch's thread pool.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref_tree():
    params = ref_diffusion.init_params(stable_diffusion_v1.reduced(),
                                       jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _paths(tree, prefix=()):
    """{path: leaf} with None leaves kept."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, prefix + (i,)))
        return out
    return {prefix: tree}


def test_round_trip_is_leaf_exact(ref_tree):
    tree = convert.from_jax_params(ref_tree, "cpu")
    back = convert.to_numpy_params(tree)
    a, b, t = _paths(ref_tree), _paths(back), _paths(tree)
    assert a.keys() == b.keys() == t.keys()
    for path, leaf in a.items():
        if leaf is None:
            assert b[path] is None and t[path] is None
            continue
        assert isinstance(t[path], torch.Tensor)
        assert b[path].dtype == leaf.dtype and b[path].shape == leaf.shape
        np.testing.assert_array_equal(b[path], leaf, err_msg=str(path))


def test_none_leaf_is_kept(ref_tree):
    tree = convert.from_jax_params(ref_tree, "cpu")
    assert ref_tree["vae"]["stages"][-1]["up"] is None
    assert tree["vae"]["stages"][-1]["up"] is None
    assert tree["vae"]["stages"][0]["up"] is not None


def test_converted_leaves_do_not_alias_the_source(ref_tree):
    src = {"w": np.ones((2, 3), np.float32)}
    tree = convert.from_jax_params(src, "cpu")
    tree["w"].zero_()
    assert src["w"].sum() == 6


def test_dtype_cast_and_bf16_bits():
    import ml_dtypes
    src = {"a": np.arange(6, dtype=np.float32).reshape(2, 3) / 7,
           "b": [None, (np.arange(4, dtype=np.float32) / 3).astype(
               ml_dtypes.bfloat16)]}
    tree = convert.from_jax_params(src, "cpu")
    assert tree["b"][1].dtype == torch.bfloat16
    back = convert.to_numpy_params(tree, bf16=ml_dtypes.bfloat16)
    assert back["b"][1].dtype == src["b"][1].dtype
    np.testing.assert_array_equal(back["b"][1].view(np.uint16),
                                  src["b"][1].view(np.uint16))
    # without a bf16 dtype of the caller's, the bits themselves
    bits = convert.to_numpy_params(tree)["b"][1]
    assert bits.dtype == np.uint16
    np.testing.assert_array_equal(bits, src["b"][1].view(np.uint16))
    half = convert.from_jax_params(src, "cpu", dtype=torch.float16)
    assert half["a"].dtype == half["b"][1].dtype == torch.float16


def test_device_none_needs_a_gpu(ref_tree):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        convert.from_jax_params({"w": np.zeros(1, np.float32)})


def test_port_init_has_the_reference_tree(ref_tree):
    """Same keys, same shapes, same dtypes; values are the port's own."""
    cfg = stable_diffusion_v1.reduced()
    own = diffusion.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    a, b = _paths(ref_tree), _paths(own)
    assert a.keys() == b.keys()
    for path, leaf in a.items():
        if leaf is None:
            assert b[path] is None
        else:
            assert tuple(b[path].shape) == leaf.shape, path
            assert b[path].dtype == torch.float32


def test_module_holder_follows_the_tree(ref_tree):
    cfg = stable_diffusion_v1.reduced()
    tree = convert.from_jax_params(ref_tree, "cpu")
    model = diffusion.DiffusionModel(tree, cfg)
    n_leaves = sum(v is not None for v in _paths(ref_tree).values())
    assert len(model.state_dict()) == n_leaves
    rebuilt = _paths(model.double().params)
    for path, leaf in _paths(tree).items():
        if leaf is None:
            assert rebuilt[path] is None
        else:
            assert rebuilt[path].dtype == torch.float64
            assert torch.equal(rebuilt[path].float(), leaf)


@pytest.fixture(scope="module")
def lm_tree():
    """The reduced RecurrentGemma-9B tree: group-stacked bf16 blocks, an
    unstacked tail, fp32 Lambda / gate biases / norms, padded vocab."""
    from repro.configs import reduced_config
    from repro.models import transformer as ref_tr
    cfg = reduced_config("recurrentgemma-9b")
    params = ref_tr.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def test_lm_tree_round_trip_is_bit_exact(lm_tree):
    import ml_dtypes
    cfg, ref = lm_tree
    tree = convert.from_jax_params(ref, "cpu")
    back = convert.to_numpy_params(tree, bf16=ml_dtypes.bfloat16)
    a, b, t = _paths(ref), _paths(back), _paths(tree)
    assert a.keys() == b.keys() == t.keys()
    G = cfg.num_groups()
    kinds = set()
    for path, leaf in a.items():
        assert b[path].dtype == leaf.dtype and b[path].shape == leaf.shape
        bits = np.uint16 if leaf.dtype == ml_dtypes.bfloat16 else leaf.dtype
        np.testing.assert_array_equal(b[path].view(bits), leaf.view(bits),
                                      err_msg=str(path))
        if path[0] == "blocks":
            assert t[path].shape[0] == G, path
        kinds.add((path[0], str(t[path].dtype)))
    assert ("blocks", "torch.bfloat16") in kinds
    assert ("blocks", "torch.float32") in kinds          # lam, ba, bx, norms
    assert {"embed", "lm_head", "tail", "final_norm"} <= {p[0] for p in a}
    assert t[("blocks", "b0", "rglru", "lam")].dtype == torch.float32
    assert t[("lm_head",)].dtype == torch.bfloat16
