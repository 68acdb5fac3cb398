"""Port parity, the sharding spec rules (``repro_torch/distributed/
sharding.py`` against ``repro/distributed/sharding.py``).

The rules read only ``mesh.shape``, so everything here runs in the
pytest process without a world: the reference's specs come from its
rules on ``jax.eval_shape`` trees and a mesh stand-in, the port's from
its own rules on its ``meta`` trees and a ``launch.mesh.Mesh`` of the
same shape.  Every spec is held to the reference's ``PartitionSpec`` as a
tuple, to the bit, leaf for leaf (the path strings too).  The bodies of
``_divisible``, ``param_spec`` and ``zero1_spec`` are the reference's
text.  ``local_shard`` is held to blocks cut by hand; the attention guard
of ``models/transformer.py`` (dense tensor parallelism is not ported) is
held to the local forward where the weights are whole.
"""
import ast
import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RefP

from repro.configs import ARCH_IDS, get_config as ref_get_config
from repro.distributed import sharding as ref_shd
from repro.models import transformer as ref_tr
from repro.train.optimizer import init_opt_state as ref_init_opt_state
from repro_torch.configs import get_config, reduced_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe
from repro_torch.models import transformer as tr
from repro_torch.train.optimizer import init_opt_state

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"16x16": (16, 16), "2x2": (2, 2)}
COPIED = ("_divisible", "param_spec", "zero1_spec")


class _RefMesh:
    """What the reference's rules read of a mesh (as
    ``tests/test_sharding.py``'s stand-in)."""

    def __init__(self, shape, axes=("data", "model")):
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes


def _ref_flat(specs):
    return {jax.tree_util.keystr(path): tuple(s)
            for path, s in jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda x: isinstance(x, RefP))}


def _flat(specs):
    out = {}
    shd.tree_map_with_path(lambda path, s: out.__setitem__(path, tuple(s)),
                           specs)
    return out


def _assert_same_specs(got, want):
    got, want = _flat(got), _ref_flat(want)
    assert sorted(got) == sorted(want)
    assert got == want


_SHAPES = {}


def _shapes(arch):
    """(reference's eval_shape tree, the port's meta tree), once per
    architecture and test worker."""
    if arch not in _SHAPES:
        _SHAPES[arch] = (
            jax.eval_shape(lambda: ref_tr.init_params(
                ref_get_config(arch), jax.random.PRNGKey(0))),
            dryrun.param_shapes(get_config(arch)))
    return _SHAPES[arch]


def _function_text(path, name):
    text = path.read_text()
    lines = text.splitlines(keepends=True)
    node = next(n for n in ast.parse(text).body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    return "".join(lines[node.lineno - 1:node.end_lineno])


@pytest.mark.parametrize("name", COPIED)
def test_rule_bodies_are_the_reference_s_text(name):
    assert (_function_text(ROOT / "src/repro_torch/distributed/sharding.py",
                           name)
            == _function_text(ROOT / "src/repro/distributed/sharding.py",
                              name))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference_s(arch, mesh):
    ref_tree, tree = _shapes(arch)
    shape = MESHES[mesh]
    _assert_same_specs(
        shd.param_specs(tree, get_config(arch), Mesh(shape, ("data",
                                                            "model"))),
        ref_shd.param_specs(ref_tree, ref_get_config(arch),
                            _RefMesh(shape)))


@pytest.mark.parametrize("arch", ["qwen2-7b", "olmoe-1b-7b", "mamba2-780m"])
def test_opt_state_specs_equal_the_reference_s(arch):
    ref_tree, tree = _shapes(arch)
    mesh, ref_mesh = Mesh((16, 16), ("data", "model")), _RefMesh((16, 16))
    want = ref_shd.opt_state_specs(
        jax.eval_shape(ref_init_opt_state, ref_tree),
        ref_shd.param_specs(ref_tree, ref_get_config(arch), ref_mesh),
        ref_mesh, ("data",))
    got = shd.opt_state_specs(init_opt_state(tree),
                              shd.param_specs(tree, get_config(arch), mesh),
                              mesh, ("data",))
    assert got.keys() == want.keys()
    for key in want:
        _assert_same_specs(got[key], want[key])


def test_cache_specs_equal_the_reference_s():
    arch, mesh = "qwen2-7b", Mesh((16, 16), ("data", "model"))
    want = ref_shd.cache_specs(
        jax.eval_shape(lambda: ref_tr.init_decode_cache(
            ref_get_config(arch), 128, 4096)),
        ref_get_config(arch), _RefMesh((16, 16)), ("data",))
    got = shd.cache_specs(tr.init_decode_cache(get_config(arch), 128, 4096,
                                               device="meta"),
                          get_config(arch), mesh, ("data",))
    _assert_same_specs(got, want)


@pytest.mark.parametrize("batch", [8, 4, 1])
@pytest.mark.parametrize("axes,shape", [
    (("data",), (4, 2)), (("pod", "data"), (2, 2, 2)), (None, None)])
def test_batch_specs_equal_the_reference_s(batch, axes, shape):
    """With a mesh (one data axis, or pod x data) and without; a batch of
    1 is one the data axes do not divide."""
    data_axes = axes or ("data",)
    batch_tree = {"tokens": np.zeros((batch, 16), np.int32),
                  "frontend": np.zeros((batch, 4, 8), np.float32),
                  "mask": np.zeros((batch, 16), np.int32)}
    names = (data_axes + ("model",)) if shape else None
    mesh = Mesh(shape, names) if shape else None
    ref_mesh = _RefMesh(shape, names) if shape else None
    _assert_same_specs(shd.batch_specs(batch_tree, data_axes, mesh),
                       ref_shd.batch_specs(batch_tree, data_axes, ref_mesh))


def test_spec_type_reads_as_jax_s():
    for entries in [(), (None, "model"), (("pod", "data"), None, "model"),
                    (("data",), None)]:
        assert tuple(shd.P(*entries)) == tuple(RefP(*entries))
        assert repr(shd.P(*entries)) == repr(RefP(*entries))


@pytest.mark.parametrize("mesh", [None, (2, 2), (2, 2, 2)])
def test_make_ctx_is_the_reference_s(mesh):
    names = ("data", "model") if mesh and len(mesh) == 2 else (
        "pod", "data", "model")
    got = shd.make_ctx(Mesh(mesh, names) if mesh else None)
    want = ref_shd.make_ctx(_RefMesh(mesh, names) if mesh else None)
    assert (got.data_axes, got.model_axis) == (want.data_axes,
                                              want.model_axis)
    assert (got.mesh is None) == (want.mesh is None)


def test_named_and_moe_only_specs():
    """``named`` puts every spec on the mesh; ``moe_only_specs`` keeps the
    MoE leaves' specs and leaves every other leaf whole."""
    _, tree = _shapes("olmoe-1b-7b")
    cfg, mesh = get_config("olmoe-1b-7b"), Mesh((1, 4), ("data", "model"))
    full, only = _flat(shd.param_specs(tree, cfg, mesh)), _flat(
        shd.moe_only_specs(tree, cfg, mesh))
    assert full.keys() == only.keys()
    cut = [k for k, s in only.items() if any(e is not None for e in s)]
    assert cut and all("['moe']" in k for k in cut)
    for k in full:
        assert only[k] == (full[k] if "['moe']" in k
                           else (None,) * len(full[k]))
    named = shd.named(mesh, shd.moe_only_specs(tree, cfg, mesh))
    leaf = named["blocks"]["b0"]["moe"]["w_gate"]
    assert leaf.mesh is mesh and tuple(leaf.spec) == (None, "model", None,
                                                      None)


def _blocks_by_hand(a, mesh_shape, spec):
    """Rank r's block of numpy ``a``: each entry's axes numbered row major
    over their coordinates, the first axis outermost."""
    coords = list(np.ndindex(*mesh_shape))
    names = ("data", "model")
    out = []
    for rank in range(len(coords)):
        block = a
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            n, index = 1, 0
            for ax in axes:
                size = mesh_shape[names.index(ax)]
                index = index * size + coords[rank][names.index(ax)]
                n *= size
            rows = block.shape[dim] // n
            block = np.take(block, range(index * rows, (index + 1) * rows),
                            axis=dim)
        out.append(block)
    return out


@pytest.mark.parametrize("spec", [
    ("data", "model"), (("data", "model"), None), (("model", "data"), None),
    (None, ("data", "model")), ("model",), (None, None, "data")])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4)])
def test_local_shard_cuts_each_rank_s_block(spec, mesh_shape):
    a = np.arange(8 * 8 * 4).reshape(8, 8, 4)
    mesh = Mesh(mesh_shape, ("data", "model"))
    want = _blocks_by_hand(a, mesh_shape, spec)
    for rank in range(mesh.size):
        got = shd.local_shard(torch.from_numpy(a), shd.P(*spec), mesh,
                              rank=rank)
        np.testing.assert_array_equal(got.numpy(), want[rank])


@pytest.mark.parametrize("shape,spec", [
    ((6, 4), (("data", "model"), None)), ((4,), (None, "model")),
    ((4, 3), (None, "model"))])
def test_local_shard_raises_where_the_spec_does_not_fit(shape, spec):
    with pytest.raises(ValueError):
        shd.local_shard(torch.zeros(shape), shd.P(*spec),
                        Mesh((2, 2), ("data", "model")), rank=0)


def _dense_block(arch):
    """Layer 0's parameters of the reduced, fp32 ``arch``."""
    cfg = dataclasses.replace(reduced_config(arch), param_dtype="float32")
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, tr._tree_index(params["blocks"], 0)["b0"]


@pytest.mark.parametrize("cut", [None, "wq", "mlp"])
def test_attention_guard_refuses_dense_blocks_under_a_mesh(cut):
    """Under a model axis of 2, whole weights run as on one device (no
    collective: the dense block ignores the mesh); a head slice of ``wq``
    or a width slice of the MLP raises and names dense tensor
    parallelism."""
    cfg, p = _dense_block("qwen2-7b")
    mesh = Mesh((1, 2), ("data", "model"))
    ctx = moe.ShardCtx(mesh=mesh, data_axes=("data",), model_axis="model")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    pos = torch.arange(8)
    if cut == "wq":
        p["wq"] = shd.local_shard(p["wq"], shd.P(None, "model"), mesh, 0)
    elif cut == "mlp":
        p["mlp"]["wo"] = shd.local_shard(p["mlp"]["wo"], shd.P("model"),
                                         mesh, 0)
    if cut is None:
        got, _, _ = tr.apply_attn_block_seq(p, x, cfg, ctx, positions=pos)
        want, _, _ = tr.apply_attn_block_seq(p, x, cfg, moe.LOCAL_CTX,
                                             positions=pos)
        assert torch.equal(got, want)
    else:
        with pytest.raises(NotImplementedError,
                           match="dense tensor parallelism.*A10.2"):
            tr.apply_attn_block_seq(p, x, cfg, ctx, positions=pos)


@pytest.mark.parametrize("arch,kind,cut", [
    ("recurrentgemma-9b", "rec", None),
    ("recurrentgemma-9b", "rec", ("rglru", "w_out", ("model",))),
    ("recurrentgemma-9b", "rec", ("mlp", "wo", ("model",))),
    ("mamba2-780m", "ssd", None),
    ("mamba2-780m", "ssd", ("ssd", "x_proj", (None, "model"))),
    ("mamba2-780m", "ssd", ("ssd", "norm_scale", ("model",))),
])
def test_recurrent_blocks_refuse_dense_blocks_under_a_mesh(arch, kind, cut):
    """The RG-LRU and SSD blocks, as attention: whole weights under a
    model axis of 2 run as on one device, and a leaf cut by its
    ``param_specs`` rule raises and names dense tensor parallelism."""
    cfg, p = _dense_block(arch)
    mesh = Mesh((1, 2), ("data", "model"))
    ctx = moe.ShardCtx(mesh=mesh, data_axes=("data",), model_axis="model")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    pos = torch.arange(8)
    if cut is None:
        got, _, _ = tr.apply_block_seq(kind, p, x, cfg, ctx, positions=pos)
        want, _, _ = tr.apply_block_seq(kind, p, x, cfg, moe.LOCAL_CTX,
                                        positions=pos)
        assert torch.equal(got, want)
    else:
        sub, leaf, spec = cut
        p[sub][leaf] = shd.local_shard(p[sub][leaf], shd.P(*spec), mesh, 0)
        with pytest.raises(NotImplementedError,
                           match="dense tensor parallelism.*A10.2"):
            tr.apply_block_seq(kind, p, x, cfg, ctx, positions=pos)
