"""Port parity, dense tensor parallelism: ``prefill`` and ``decode_step``
over a (data, model) mesh, each rank on its ``param_specs`` blocks,
against the reference's GSPMD ``build_prefill_step`` /
``build_decode_step``.

One world of 4 ``gloo`` ranks (fresh processes, rendezvous by a file
under ``tmp_path``) runs every case through ``launch/dryrun.py``'s step
builders: each rank cuts its blocks of the whole tree by
``checkpoint.reshard`` and its rows of the tokens by ``batch_specs``,
prefills 8 tokens and decodes 3 more, teacher-forced, in fp32.  One JAX
subprocess with 4 fake host devices runs the reference's jitted steps
under ``named(mesh, param_specs(...))`` on the same parameters (the
port's init, handed over as numpy) and tokens (numpy).  The cases:

  * reduced Qwen2-7B on (1, 4) and (2, 2): QKV biases, the query heads
    cut and its one kv head whole (every rank selects the kv heads its
    global query heads read), vocabulary 512 of a padded 2048, so ranks
    1-3 of (1, 4) hold padding only;
  * reduced smollm-135m on (1, 4): tied embeddings;
  * reduced OLMoE-1B-7B on (1, 4): heads and kv heads cut, the MoE layer
    in ``ep``;
  * reduced Qwen2-7B with 6 query heads on 3 kv heads, on (2, 2) (a
    rank's 3 query heads straddle kv groups: kv heads 0, 0, 1 and 1, 2,
    2) and on (1, 4) (the heads do not divide: attention whole on every
    rank, the MLP cut);
  * reduced RecurrentGemma-9B on (1, 4) and (2, 2): the RG-LRU by
    channels (16 or 32 of 64, in 4 or 8 gate blocks), its MLP by
    ``d_ff``, the attention block's 4 query heads on 1 kv head; one group
    and a tail of two RG-LRU blocks;
  * reduced Mamba-2-780M on (1, 4) and (2, 2): the SSD by ``d_inner`` in
    whole heads (2 or 4 of 8, 16 wide), B, C and dt whole, the gated
    norm's sum of squares summed over the axis;
  * reduced seamless-m4t-medium (2 encoder and 2 decoder layers over 8
    frames, seeded numpy, cut into rows like the tokens by
    ``batch_specs``): 4 heads on 4 on (1, 4) and (2, 2), the encoder's
    blocks, the decoder's self- and cross-attention, ``enc_kv`` and the
    MLPs cut; 4 on 2 on (1, 4), the query heads cut while the kv heads
    and ``enc_kv`` stay whole on every rank; 6 on 3 on (1, 4), attention
    and cross-attention whole on every rank, only the MLPs cut.  The
    reference's cache is placed again on its ``cache_specs`` before each
    step: GSPMD hands back a passed-through ``enc_kv`` in another
    layout than the one its jitted step asks for.

The gathered logits and caches are held to the reference's within rtol
and atol 1e-4 (the sums over the model axis in another order than
XLA's), every model rank's logits to each other's and every rank's
logits and cache to ``chip_smoke.tp_as_ranks`` (one process, the ranks
as threads computing their partials from their own blocks and summing
them in the same order) to the bit.  A rank's SSD ``conv`` state is [its
x channels | B | C]: the ranks' x channels are put together in rank
order and B | C, the same on every model rank, appended.  Then the
refusals, without a world.  The top-level imports stay free of jax: the
ranks import this file.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import keystr, tree_leaves_with_path, tree_map
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.world import run_world
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models import attention
from repro_torch.models import transformer as tr
from repro_torch.train import checkpoint

pytestmark = pytest.mark.multidevice

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
WORLD_TIMEOUT_S = 240
#: (case, reduced arch, its head counts if changed, mesh)
CASES = (("qwen2_1x4", "qwen2-7b", None, (1, 4)),
         ("qwen2_2x2", "qwen2-7b", None, (2, 2)),
         ("smollm_1x4", "smollm-135m", None, (1, 4)),
         ("olmoe_1x4", "olmoe-1b-7b", None, (1, 4)),
         ("straddle_2x2", "qwen2-7b", (6, 3), (2, 2)),
         ("whole_heads_1x4", "qwen2-7b", (6, 3), (1, 4)),
         ("rgemma_1x4", "recurrentgemma-9b", None, (1, 4)),
         ("rgemma_2x2", "recurrentgemma-9b", None, (2, 2)),
         ("mamba_1x4", "mamba2-780m", None, (1, 4)),
         ("mamba_2x2", "mamba2-780m", None, (2, 2)),
         ("seamless_1x4", "seamless-m4t-medium", None, (1, 4)),
         ("seamless_2x2", "seamless-m4t-medium", None, (2, 2)),
         ("seamless_gqa_1x4", "seamless-m4t-medium", (4, 2), (1, 4)),
         ("seamless_whole_heads_1x4", "seamless-m4t-medium", (6, 3),
          (1, 4)))
B, PROMPT, STEPS = 2, 8, 3
TOL = dict(rtol=1e-4, atol=1e-4)

REFERENCE = """
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from repro.configs import reduced_config
from repro.distributed import sharding as shd
from repro.jax_compat import make_mesh
from repro.launch.dryrun import build_decode_step, build_prefill_step
from repro.models import transformer as tr

out = sys.argv[1]
cases = json.load(open(os.path.join(out, "cases.json")))
data = dict(np.load(os.path.join(out, "inputs.npz")))
B, P, T = cases["batch"], cases["prompt"], cases["steps"]


def nest(flat):
    tree = {}
    for path, leaf in flat.items():
        keys = path.split("/")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = jnp.asarray(leaf)
    return tree


def flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v, np.float32)


for name, arch, heads, shape in cases["cases"]:
    cfg = dataclasses.replace(reduced_config(arch), param_dtype="float32")
    if heads:
        cfg = dataclasses.replace(cfg, num_heads=heads[0],
                                  num_kv_heads=heads[1])
    params = nest({k.split("|", 1)[1]: v for k, v in data.items()
                   if k.startswith(name + "|")})
    tokens = jnp.asarray(data["tokens"])
    mesh = make_mesh(tuple(shape), ("data", "model"))
    named_params = shd.named(mesh, shd.param_specs(params, cfg, mesh))
    with mesh:
        prefill, _ = build_prefill_step(cfg, mesh)
        batch = {"tokens": tokens[:, :P]}
        if cfg.encoder_layers:
            batch["frontend"] = jnp.asarray(data["frames"])
        logits, cache = jax.jit(prefill, in_shardings=(
            named_params, shd.named(mesh, shd.batch_specs(
                batch, ("data",), mesh))))(params, batch)
        cache = tr.pad_kv_caches(cache, P + T)
        decode, _ = build_decode_step(cfg, mesh)
        cache_named = shd.named(mesh, shd.cache_specs(cache, cfg, mesh,
                                                      ("data",)))
        step = jax.jit(decode, in_shardings=(named_params, None, cache_named,
                                             None))
        out_logits = [logits]
        for t in range(P, P + T):
            cache = jax.device_put(cache, cache_named)
            logits, cache = step(params, tokens[:, t:t + 1], cache,
                                 jnp.int32(t))
            out_logits.append(logits)
    np.savez(os.path.join(out, f"ref|{name}.npz"),
             logits=np.stack([np.asarray(l, np.float32)
                              for l in out_logits]),
             **{"cache|" + k: v for k, v in flat(cache)})
"""


def _cfg(arch, heads=None):
    cfg = dataclasses.replace(reduced_config(arch), param_dtype="float32")
    if heads:
        cfg = dataclasses.replace(cfg, num_heads=heads[0],
                                  num_kv_heads=heads[1])
    return cfg


def _case(name):
    return next(c for c in CASES if c[0] == name)


def _params(index, arch, heads):
    return tr.init_params(_cfg(arch, heads),
                          torch.Generator().manual_seed(index), "cpu")


def _tokens():
    return torch.from_numpy(np.random.default_rng(7).integers(
        0, reduced_config("qwen2-7b").vocab_size,
        (B, PROMPT + STEPS)).astype(np.int32))


def _frames():
    """The encoder-decoder's frames, (B, frames, width) of the reduced
    seamless-m4t-medium's audio frontend."""
    f = reduced_config("seamless-m4t-medium").frontend
    return torch.from_numpy(np.random.default_rng(8).standard_normal(
        (B, f.num_positions, f.embed_dim)).astype(np.float32))


def _batch(cfg, tokens, frames, mesh=None):
    """The prompt's batch of ``cfg`` (with the frames where it has an
    encoder), or a rank's rows of it under ``batch_specs``."""
    batch = {"tokens": tokens[:, :PROMPT]}
    if cfg.encoder_layers:
        batch["frontend"] = frames
    if mesh is None:
        return batch
    return shd.tree_map_with_path(
        lambda path, t, s: shd.local_shard(t, s, mesh), batch,
        shd.batch_specs(batch, ("data",), mesh))


def _flat(tree):
    """{"a/b/c": leaf} of a nested dict (the path the subprocess uses)."""
    return {keystr(path).replace("']['", "/").strip("[']"): leaf
            for path, leaf in tree_leaves_with_path(tree)}


def _tp_case(mesh, name, params, tokens, frames):
    """One rank of ``mesh`` on a case: its blocks and rows (of the tokens,
    and of the frames where the model has an encoder), prefill, then the
    teacher-forced decode steps, through the step builders.  Returns its
    logits at each step and its final cache, as numpy."""
    _, arch, heads, _ = _case(name)
    cfg = _cfg(arch, heads)
    own = checkpoint.reshard(params, shd.named(
        mesh, shd.param_specs(params, cfg, mesh)), device="cpu")
    toks = shd.local_shard(tokens, shd.P(("data",), None), mesh)
    prefill, ctx = dryrun.build_prefill_step(cfg, mesh)
    decode, _ = dryrun.build_decode_step(cfg, mesh)
    assert ctx.model_size == mesh.shape["model"]
    batch = _batch(cfg, tokens, frames, mesh)
    assert torch.equal(batch["tokens"], toks[:, :PROMPT])
    logits, cache = prefill(own, batch)
    cache = tr.pad_kv_caches(cache, PROMPT + STEPS)
    out = [logits]
    for t in range(PROMPT, PROMPT + STEPS):
        logits, cache = decode(own, toks[:, t:t + 1], cache, t)
        out.append(logits)
    return {"logits": torch.stack(out).numpy(),
            **{"cache|" + k: v.numpy() for k, v in _flat(cache).items()}}


def _rank_tp(rank, world_size, trees, tokens, frames, out):
    """One rank: every case on its mesh of the world's 4 ranks."""
    with torch.inference_mode():
        for name, _, _, shape in CASES:
            got = _tp_case(Mesh(shape, ("data", "model")), name,
                           trees[name], tokens, frames)
            np.savez(os.path.join(out, f"{name}|r{rank}.npz"), **got)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """``load(name, rank)`` a rank's saved arrays, ``load(name)`` the
    reference's, ``load(name, rank, as_ranks=True)`` the one process's
    computing as that rank."""
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    trees = {name: _params(i, arch, heads)
             for i, (name, arch, heads, _) in enumerate(CASES)}
    tokens, frames = _tokens(), _frames()
    data = {"tokens": tokens.numpy(), "frames": frames.numpy()}
    for name, tree in trees.items():
        data.update({f"{name}|{k}": v.numpy()
                     for k, v in _flat(tree).items()})
    np.savez(tmp / "inputs.npz", **data)
    (tmp / "cases.json").write_text(json.dumps({
        "cases": CASES, "batch": B, "prompt": PROMPT, "steps": STEPS}))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        (tmp / "ranks").mkdir()
        run_world(_rank_tp, WORLD, (trees, tokens, frames, str(tmp)),
                  workdir=tmp / "ranks", timeout=WORLD_TIMEOUT_S)
        # the yardstick, while the reference still compiles: one thread a
        # rank, one torch thread each, as the ranks run
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            as_ranks = {name: _chip_smoke().tp_as_ranks(
                _tp_case, shape, name, trees[name], tokens, frames)
                for name, _, _, shape in CASES}
        finally:
            torch.set_num_threads(threads)
        _, err = jax_proc.communicate(timeout=WORLD_TIMEOUT_S)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, err[-3000:]

    def load(name, rank=None, as_rank=False):
        if as_rank:
            return as_ranks[name][rank]
        if rank is None:
            return dict(np.load(tmp / f"ref|{name}.npz"))
        return dict(np.load(tmp / f"{name}|r{rank}.npz"))
    return load


def _coords(shape, rank):
    return np.unravel_index(rank, shape)


def _assert_same(parts):
    for other in parts[1:]:
        np.testing.assert_array_equal(other, parts[0])
    return parts[0]


def _gathered_cache(results, name, shape, cfg):
    """The ranks' caches put together: rows over the data axis; over the
    model axis, where the rules cut them, kv heads (of the self-attention
    cache and of ``enc_kv``, both keyed by their block), RG-LRU channels
    (``h`` and ``conv``) and SSD heads (``ssm``), and an SSD's ``conv`` as the
    ranks' x channels in rank order with B | C appended (the same on
    every model rank, and that is asserted); a leaf not cut is the same
    on every model rank, and that is asserted."""
    D, M = shape
    kinds = {**{f"b{i}": k for i, k in enumerate(cfg.block_pattern)},
             **{f"t{i}": k for i, k in enumerate(cfg.tail_pattern())}}
    ranks = [results(name, r) for r in range(WORLD)]
    out = {}
    for key in (k for k in ranks[0] if k.startswith("cache|")):
        block, leaf = key.split("/")[-2:]
        kind = kinds[block]
        # (batch axis, model axis, whether the rules cut it)
        if leaf in ("k", "v"):
            axes = (-4, -2, cfg.num_kv_heads % M == 0)
        elif leaf == "ssm":
            axes = (-4, -3, cfg.ssm.n_heads(cfg.d_model) % M == 0)
        elif kind == "rec":
            w = cfg.rglru.lru_width or cfg.d_model
            axes = ((-2 if leaf == "h" else -3), -1, w % M == 0)
        else:                                   # the SSD's conv
            axes = (-3, -1, cfg.ssm.d_inner(cfg.d_model) % M == 0)
        batch_axis, model_axis, cut = axes
        rows = []
        for d in range(D):
            mine = [ranks[r][key] for r in range(WORLD)
                    if _coords(shape, r)[0] == d]
            if not cut:
                rows.append(_assert_same(mine))
            elif kind == "ssd" and leaf == "conv":
                di_r = cfg.ssm.d_inner(cfg.d_model) // M
                bc = _assert_same([m[..., di_r:] for m in mine])
                rows.append(np.concatenate(
                    [m[..., :di_r] for m in mine] + [bc], axis=-1))
            else:
                rows.append(np.concatenate(mine, axis=model_axis))
        out[key] = np.concatenate(rows, axis=batch_axis)
    return out


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_ranks_match_the_reference_s_gspmd_steps(results, name):
    """Each rank's logits (gathered whole over the vocabulary) are its
    rows of the reference's, at prefill and every decode step; the
    caches put together are the reference's; padded vocabulary columns
    are -1e30 on every rank, real ones finite."""
    _, arch, heads, shape = _case(name)
    cfg = _cfg(arch, heads)
    want = results(name)
    D = shape[0]
    rows = B // D
    for rank in range(WORLD):
        got = results(name, rank)["logits"]
        d = _coords(shape, rank)[0]
        assert got.shape == (STEPS + 1, rows, 1, cfg.padded_vocab())
        np.testing.assert_allclose(
            got, want["logits"][:, d * rows:(d + 1) * rows], **TOL)
        assert (got[..., cfg.vocab_size:] == -1e30).all()
        assert np.isfinite(got[..., :cfg.vocab_size]).all()
    cache = _gathered_cache(results, name, shape, cfg)
    assert cache.keys() == {k for k in want if k.startswith("cache|")}
    for key, leaf in cache.items():
        np.testing.assert_allclose(leaf, want[key], err_msg=key, **TOL)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_ranks_equal_one_process_computing_as_the_ranks(results, name):
    """Every rank's logits and cache are the bits of ``tp_as_ranks``'s
    thread for that rank, and a data shard's model ranks return the same
    logits."""
    shape = _case(name)[3]
    for rank in range(WORLD):
        got, want = results(name, rank), results(name, rank, as_rank=True)
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        first = next(r for r in range(WORLD)
                     if _coords(shape, r)[0] == _coords(shape, rank)[0])
        np.testing.assert_array_equal(got["logits"],
                                      results(name, first)["logits"])


def _full_width_shapes(arch, M):
    """Some leaves' shapes on a rank of a model axis of ``M``."""
    b0, b1, b2 = "['blocks']['b0']", "['blocks']['b1']", "['blocks']['b2']"
    if arch == "qwen2-7b":
        return {b0 + "['wq']": (28, 3584, 28 // M, 128),
                b0 + "['wk']": (28, 3584, 4 // M, 128),
                b0 + "['mlp']['wo']": (28, 18944 // M, 3584),
                "['embed']": (153600 // M, 3584),
                "['lm_head']": (3584, 153600 // M)}
    if arch == "recurrentgemma-9b":
        t1 = "['tail']['t1']"
        return {b0 + "['rglru']['w_rec_in']": (12, 4096, 4096 // M),
                b1 + "['rglru']['wa']": (12, 16 // M, 256, 256),
                b1 + "['rglru']['lam']": (12, 4096 // M),
                t1 + "['rglru']['w_out']": (4096 // M, 4096),
                t1 + "['mlp']['wo']": (12288 // M, 4096),
                b2 + "['wq']": (12, 4096, 16 // M, 256),
                b2 + "['wk']": (12, 4096, 1, 256),
                "['embed']": (256000 // M, 4096)}
    if arch == "seamless-m4t-medium":
        enc = "['encoder']['blocks']"
        return {enc + "['wq']": (12, 1024, 16 // M, 64),
                enc + "['wo']": (12, 16 // M, 64, 1024),
                enc + "['mlp']['wi']": (12, 1024, 4096 // M),
                enc + "['norm1']['scale']": (12, 1024),
                b0 + "['xwq']": (12, 1024, 16 // M, 64),
                b0 + "['xwv']": (12, 1024, 16 // M, 64),
                b0 + "['xwo']": (12, 16 // M, 64, 1024),
                b0 + "['xnorm']['scale']": (12, 1024),
                b0 + "['mlp']['wo']": (12, 4096 // M, 1024),
                "['embed']": (258048 // M, 1024),
                "['lm_head']": (1024, 258048 // M)}
    ssd = b0 + "['ssd']"
    return {ssd + "['x_proj']": (48, 1536, 3072 // M),
            ssd + "['norm_scale']": (48, 3072 // M),
            ssd + "['out_proj']": (48, 3072 // M, 1536),
            ssd + "['b_proj']": (48, 1536, 128),
            ssd + "['dt_proj']": (48, 1536, 48),
            ssd + "['A_log']": (48, 48),
            "['embed']": (51200 // M, 1536)}


@pytest.mark.parametrize("arch,shape", [
    pytest.param("qwen2-7b", (1, 4), id="shape0"),
    pytest.param("qwen2-7b", (2, 2), id="shape1"),
    pytest.param("recurrentgemma-9b", (1, 4), id="recurrentgemma-9b-1x4"),
    pytest.param("recurrentgemma-9b", (2, 2), id="recurrentgemma-9b-2x2"),
    pytest.param("mamba2-780m", (1, 4), id="mamba2-780m-1x4"),
    pytest.param("mamba2-780m", (2, 2), id="mamba2-780m-2x2"),
    pytest.param("seamless-m4t-medium", (1, 4), id="seamless-m4t-medium-1x4"),
    pytest.param("seamless-m4t-medium", (2, 2),
                 id="seamless-m4t-medium-2x2")])
def test_local_shapes_are_local_shard_s_at_full_width(arch, shape):
    """``sharding.local_shapes`` of a full-width model (on ``meta``) is the
    shape ``local_shard`` cuts for every rank.  Qwen2-7B: on (1, 4) a rank
    holds 7 query heads on 1 kv head of 128, 4736 of ``d_ff`` and 38,400
    vocabulary rows, on (2, 2) 14 on 2, 9472 and 76,800.
    RecurrentGemma-9B: 1024 or 2048 LRU channels in 4 or 8 gate blocks,
    3072 or 6144 of ``d_ff``, 4 or 8 query heads on the whole kv head,
    64,000 or 128,000 vocabulary rows.  Mamba-2-780M: 768 or 1536 of
    ``d_inner`` (12 or 24 heads of 64), B, C and dt whole.
    seamless-m4t-medium: 4 or 8 of 16 heads in the encoder's blocks and
    in the decoder's self- and cross-attention, 1024 or 2048 of ``d_ff``,
    the norms whole, 64,512 or 129,024 vocabulary rows; on (1, 4) a rank
    holds 220,327,936 of the 880,930,816 parameters."""
    cfg = get_config(arch)
    mesh = Mesh(shape, ("data", "model"))
    params = dryrun.param_shapes(cfg)
    specs = shd.param_specs(params, cfg, mesh)
    local = shd.local_shapes(cfg, mesh)
    for rank in range(mesh.size):
        cut = _cut(params, cfg, mesh, rank, specs)
        assert {keystr(path): tuple(t.shape)
                for path, t in tree_leaves_with_path(cut)} == local
    for key, want in _full_width_shapes(arch, shape[1]).items():
        assert local[key] == want, key
    if arch == "seamless-m4t-medium" and shape == (1, 4):
        assert sum(t.numel() for _, t in tree_leaves_with_path(params)) == (
            880_930_816)
        assert sum(int(np.prod(s)) for s in local.values()) == 220_327_936


@pytest.mark.parametrize("q_first,n_q,group,owners,view", [
    (0, 7, 7, [0] * 7, True), (14, 14, 7, [2] * 7 + [3] * 7, True),
    (1, 1, 4, [0], True),
    (0, 3, 2, [0, 0, 1], False), (3, 3, 2, [1, 2, 2], False),
    (2, 4, 2, [1, 1, 2, 2], True)])
def test_kv_heads_for_global_query_heads(q_first, n_q, group, owners, view):
    """The kv heads a run of global query heads reads (``owners``, one a
    query head), laid out for the local pairing: a view of a run of heads
    where it holds, one copied kv head a query head where the heads
    straddle groups unevenly."""
    k = torch.arange(2 * 3 * 8 * 4.0).reshape(2, 3, 8, 4)
    got_k, got_v = attention.kv_heads_for(k, -k, q_first, n_q, group)
    if view:
        assert got_k.untyped_storage().data_ptr() == (
            k.untyped_storage().data_ptr())
        assert torch.equal(got_k, k[:, :, owners[0]:owners[-1] + 1])
        n_kv = got_k.shape[2]
        assert [owners[0] + j // (n_q // n_kv) for j in range(n_q)] == owners
    else:
        assert got_k.shape[2] == n_q
        assert torch.equal(got_k, k[:, :, owners])
    assert torch.equal(got_v, -got_k)


# --------------------------------------------------------------------------
# What stays refused (no world: every check runs before a collective)
# --------------------------------------------------------------------------
def _cut(params, cfg, mesh, rank=0, specs=None):
    """Rank ``rank``'s blocks of ``params`` under ``specs`` (default
    ``param_specs``), as views."""
    specs = specs or shd.param_specs(params, cfg, mesh)
    return shd.tree_map_with_path(
        lambda path, t, s: shd.local_shard(t, s, mesh, rank), params, specs)


def _mesh_ctx(shape=(1, 4)):
    mesh = Mesh(shape, ("data", "model"))
    return mesh, shd.make_ctx(mesh)


#: (arch, its SSD's n_groups if changed, model axis, what the refusal
#: names): the cuts by ``param_specs`` that no rank computes alone
REFUSED_CUTS = {
    # 64 LRU channels, 2 a rank, in 16 gate blocks of 4 kept whole
    "recurrentgemma-9b": (None, 32, "gate block.*no rank can compute.*"
                                    "ROADMAP A10.2c\\)"),
    # 8 of d_inner a rank, half a head of 16
    "mamba2-780m": (None, 16, "not a whole number of heads of 16.*"
                              "ROADMAP A10.2c\\)"),
    "mamba2-n_groups-2": (2, 2, "n_groups 2.*ROADMAP A10.2c\\)")}


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-780m"])
def test_recurrent_and_cross_attention_trees_cut_raise(arch):
    """A tree cut by ``param_specs`` so that no rank can compute its
    blocks alone raises before anything runs and names its reason, at
    prefill and at decode: an RG-LRU cut by channel with its gate blocks
    whole, and an SSD cut below a head; the same tree whole is not
    refused for it.  (A cross-attention block cut by ``param_specs``
    computes: ``test_a_cut_cross_attention_or_encoder_block_sums_its_
    partials``.)"""
    _refused_cut_raises(arch)


def test_a_cut_ssd_with_two_groups_raises():
    """An SSD with ``n_groups`` 2 cut by ``param_specs``: a rank's heads
    would read their own B/C groups, which is not built; it raises at
    prefill and decode, naming ``n_groups``."""
    _refused_cut_raises("mamba2-n_groups-2")


def _refused_cut_raises(case):
    groups, M, match = REFUSED_CUTS[case]
    cfg = _cfg(case if groups is None else "mamba2-780m")
    if groups:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, n_groups=groups))
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh, ctx = _mesh_ctx((1, M))
    cut = _cut(params, cfg, mesh)
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    cache = tr.init_decode_cache(cfg, 1, 8, "cpu")
    with torch.no_grad():
        with pytest.raises(NotImplementedError, match=match):
            tr.prefill(cut, batch, cfg, ctx)
        with pytest.raises(NotImplementedError, match=match):
            tr.decode_step(cut, batch["tokens"][:, :1], cache, 0, cfg, ctx)
        tr._check_tree(params, cfg, ctx)


def test_a_cache_in_the_cache_specs_layout_of_the_ssd_conv_raises():
    """A rank's SSD ``conv`` state is [its x channels | B | C], as its
    prefill returns it.  The ``cache_specs`` block of the whole [x | B |
    C] (40 columns of 160 on (1, 4), against the rank's 32 + 32) makes
    ``decode_step`` raise before anything runs, naming the rank's layout,
    and not inside a split of the wrong sizes."""
    cfg = _cfg("mamba2-780m")
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh, ctx = _mesh_ctx((1, 4))
    whole = tr.init_decode_cache(cfg, 1, 8, "cpu")
    specs = shd.cache_specs(whole, cfg, mesh, ("data",))
    mine = shd.tree_map_with_path(
        lambda path, t, s: shd.local_shard(t, s, mesh, 0), whole, specs)
    assert mine["groups"]["b0"]["conv"].shape[-1] == 40
    token = torch.zeros((1, 1), dtype=torch.int32)
    with torch.no_grad():
        with pytest.raises(ValueError,
                           match=r"\[its 32 x channels \| B \| C \(32\)\]"
                                 r".*ROADMAP C"):
            tr.decode_step(_cut(params, cfg, mesh), token, mine, 0, cfg,
                           ctx)


def _first_block(params, cfg, kind, stack="blocks"):
    """The first stacked ``kind`` block of ``params``' decoder, or of its
    encoder with ``stack`` "encoder"."""
    blocks = (params["encoder"]["blocks"] if stack == "encoder"
              else params["blocks"][f"b{cfg.block_pattern.index(kind)}"])
    return tree_map(lambda t: t[0], blocks)


def _cut_block_case(mesh, cfg, kind, params, x, enc_out=None,
                    stack="blocks"):
    """Rank ``mesh``'s blocks of the first stacked ``kind`` block of
    ``params`` (``_first_block``), through ``apply_block_seq`` on the
    whole ``x`` (and ``enc_out``; an encoder block non-causal)."""
    own = checkpoint.reshard(params, shd.named(
        mesh, shd.param_specs(params, cfg, mesh)), device="cpu")
    return _block(_first_block(own, cfg, kind, stack), x, cfg, kind,
                  shd.make_ctx(mesh), enc_out, stack)


def _block(p, x, cfg, kind, ctx, enc_out=None, stack="blocks"):
    if stack == "encoder":
        return tr.apply_attn_block_seq(p, x, cfg, ctx,
                                       positions=torch.arange(x.shape[1]),
                                       causal=False)[0]
    return tr.apply_block_seq(kind, p, x, cfg, ctx,
                              positions=torch.arange(x.shape[1]),
                              enc_out=enc_out)[0]


@pytest.mark.parametrize("kind", ["rec", "ssd"])
def test_a_cut_recurrent_block_sums_its_partials(kind):
    """An RG-LRU block (its MLP cut by ``d_ff`` too) and an SSD block cut
    over a model axis of 4, each rank a thread of this process
    (``tp_as_ranks``): every rank's block output is the whole block's
    within 1e-5 in fp32, so the RG-LRU's ``w_out``, its MLP, the SSD's
    ``out_proj`` and its gated norm's squares are each summed over the
    axis."""
    cfg = _cfg("recurrentgemma-9b" if kind == "rec" else "mamba2-780m")
    params = tr.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    i = cfg.block_pattern.index(kind)
    with torch.no_grad():
        want = tr.apply_block_seq(
            kind, tree_map(lambda t: t[0], params["blocks"][f"b{i}"]), x,
            cfg, None, positions=torch.arange(8))[0]
    got = _chip_smoke().tp_as_ranks(_cut_block_case, (1, 4), cfg, kind,
                                    params, x)
    for rank, y in enumerate(got):
        np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"rank {rank}")


@pytest.mark.parametrize("arch,kind", [
    ("qwen2-7b", "attn"), ("recurrentgemma-9b", "rec"),
    ("recurrentgemma-9b", "attn"), ("mamba2-780m", "ssd"),
    ("seamless-m4t-medium", "attn")])
def test_a_cut_block_in_bf16_rounds_each_sum_once(arch, kind):
    """In bf16, a cut block's partial products leave the matmul in fp32
    (``common.matmul_f32``) and are rounded once after the sum, as the
    whole block rounds its products once: every rank's block output (the
    ranks as threads, (1, 4)) is the whole block's but for at most 1 % of
    its elements, each within one bf16 ulp.  Summing the partials
    rounded to bf16 instead moves 40 % of a cut MLP's outputs.
    seamless-m4t-medium's decoder block attends to an encoder's output
    too: three sums, cross-attention's ``xwo`` the second."""
    cfg = reduced_config(arch)
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)).bfloat16()
    enc_out = (torch.from_numpy(rng.standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)).bfloat16()
        if cfg.encoder_layers else None)
    with torch.no_grad():
        want = _block(_first_block(params, cfg, kind), x, cfg, kind, None,
                      enc_out).float()
    for y in _chip_smoke().tp_as_ranks(_cut_block_case, (1, 4), cfg, kind,
                                       params, x, enc_out):
        assert y.dtype == torch.bfloat16
        moved = (y.float() != want)
        assert moved.float().mean() <= 0.01
        np.testing.assert_allclose(y.float().numpy(), want.numpy(),
                                   rtol=2 ** -7, atol=0)


def test_matmul_f32_keeps_the_products_unrounded():
    """``common.matmul_f32`` of bf16 operands on the CPU is their fp32
    product, not rounded to bf16."""
    from repro_torch.models.common import matmul_f32
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((2, 5, 48))).bfloat16()
    w = torch.from_numpy(rng.standard_normal((48, 7))).bfloat16()
    got = matmul_f32(a, w)
    assert got.dtype == torch.float32 and got.shape == (2, 5, 7)
    assert torch.equal(got, a.float() @ w.float())
    assert not torch.equal(got, (a @ w).float())


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-780m",
                                  "seamless-m4t-medium"])
def test_decode_layer_range_composes_to_decode_step(arch):
    """``decode_layer_range`` over [0, 1) and then [1, G) (the tail with
    the last group; reduced RecurrentGemma has one group, so [0, G)) gives
    ``decode_step``'s logits and cache to the bit, and a range outside
    [0, G] raises; seamless-m4t-medium's groups read their ``enc_kv``."""
    cfg = _cfg(arch)
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = _tokens()
    G = cfg.num_groups()
    with torch.no_grad():
        _, cache = tr.prefill(params, _batch(cfg, tokens, _frames()), cfg)
        cache = tr.pad_kv_caches(cache, PROMPT + 1)
        other = tree_map(torch.clone, cache)
        want, _ = tr.decode_step(params, tokens[:, PROMPT:PROMPT + 1], cache,
                                 PROMPT, cfg)
        x = tr.embed_tokens(params, tokens[:, PROMPT:PROMPT + 1], cfg)
        for start, stop in ((0, 1), (1, G)) if G > 1 else ((0, G),):
            x = tr.decode_layer_range(params, x, other, PROMPT, cfg,
                                      start_group=start, stop_group=stop)
        got = _chip_smoke().tp_head(params, x, cfg)
        with pytest.raises(ValueError, match="outside"):
            tr.decode_layer_range(params, x, other, PROMPT, cfg,
                                  start_group=0, stop_group=G + 1)
    assert torch.equal(got, want)
    for key, leaf in _flat(cache).items():
        assert torch.equal(_flat(other)[key], leaf), key


def _forced_case(mesh, arch, params, xs, cache, position, heads=None):
    """A rank's decode step of every group, each fed the one process's
    input ``xs[g]`` (its rows) and the one process's ``cache`` cut by
    ``chip_smoke.rank_cache``; returns each group's output."""
    cfg = _cfg(arch, heads)
    own = checkpoint.reshard(params, shd.named(
        mesh, shd.param_specs(params, cfg, mesh)), device="cpu")
    mine = _chip_smoke().rank_cache(cache, cfg, mesh)
    rows = shd.local_shard(xs, shd.P(None, ("data",)), mesh)
    return [tr.decode_layer_range(own, rows[g], mine, position, cfg,
                                  shd.make_ctx(mesh), start_group=g,
                                  stop_group=g + 1)
            for g in range(cfg.num_groups())]


@pytest.mark.parametrize("arch,shape,heads", [
    ("recurrentgemma-9b", (1, 4), None), ("mamba2-780m", (1, 4), None),
    ("mamba2-780m", (2, 2), None), ("seamless-m4t-medium", (2, 2), None),
    ("seamless-m4t-medium", (1, 4), (4, 2))])
def test_rank_cache_feeds_a_rank_s_decode(arch, shape, heads):
    """``chip_smoke.rank_cache`` cuts the one process's decode cache to a
    rank's layout (kv heads, ``enc_kv``'s too, RG-LRU channels, SSD heads,
    an SSD's ``conv`` as [its x channels | B | C]): each rank's decode
    step of a group, fed the one process's input and that cache, is the
    one process's step within 1e-5 in fp32 (the ranks as threads).
    seamless-m4t-medium with 4 heads on 2 over (1, 4): the kv heads and
    ``enc_kv`` whole on every rank, each rank's one query head reading
    its own."""
    cfg = _cfg(arch, heads)
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = _tokens()
    G = cfg.num_groups()
    with torch.no_grad():
        _, cache = tr.prefill(params, _batch(cfg, tokens, _frames()), cfg)
        cache = tr.pad_kv_caches(cache, PROMPT + 1)
        start = tree_map(torch.clone, cache)
        xs = [tr.embed_tokens(params, tokens[:, PROMPT:PROMPT + 1], cfg)]
        for g in range(G):
            xs.append(tr.decode_layer_range(params, xs[-1], cache, PROMPT,
                                            cfg, start_group=g,
                                            stop_group=g + 1))
        xs = torch.stack(xs)
    got = _chip_smoke().tp_as_ranks(_forced_case, shape, arch, params, xs,
                                    start, PROMPT, heads)
    rows = B // shape[0]
    for rank, ys in enumerate(got):
        d = _coords(shape, rank)[0]
        for g, y in enumerate(ys):
            np.testing.assert_allclose(
                y.numpy(), xs[g + 1, d * rows:(d + 1) * rows].numpy(),
                rtol=1e-5, atol=1e-5, err_msg=f"rank {rank}, group {g}")


@pytest.mark.parametrize("stack,heads", [
    ("blocks", None), ("encoder", None), ("blocks", (4, 2))])
def test_a_cut_cross_attention_or_encoder_block_sums_its_partials(stack,
                                                                   heads):
    """A decoder block of reduced seamless-m4t-medium attending to an
    encoder's output, and an encoder block (non-causal), cut over a model
    axis of 4, each rank a thread of this process (``tp_as_ranks``):
    every rank's block output is the whole block's within 1e-5 in fp32,
    so the self-attention's ``wo``, cross-attention's ``xwo`` and the
    MLP are each summed over the axis.  With 4 query heads on 2 kv heads
    the rank's one query head reads its kv head of the whole ``enc_out``
    (``_rank_kv``)."""
    cfg = _cfg("seamless-m4t-medium", heads)
    params = tr.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    enc_out = torch.from_numpy(rng.standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        want = _block(_first_block(params, cfg, "attn", stack), x, cfg,
                      "attn", None, enc_out, stack)
        alone = _block(_first_block(params, cfg, "attn", stack), x, cfg,
                       "attn", None, None, stack)
    if stack == "blocks":       # the cross-attention branch ran
        assert not torch.allclose(want, alone, atol=1e-3)
    got = _chip_smoke().tp_as_ranks(_cut_block_case, (1, 4), cfg, "attn",
                                    params, x, enc_out, stack)
    for rank, y in enumerate(got):
        np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"rank {rank}")


def _part_cut_case(mesh, cfg, params, tokens, frames, part):
    """A rank's prefill and one decode step on a tree of which only
    ``part`` ("encoder": the encoder's stack; "decoder": everything
    else) is cut by ``param_specs``, the rest whole."""
    specs = shd.tree_map_with_path(
        lambda path, s: (s if ("['encoder']" in path) == (part == "encoder")
                         else shd.P(*[None] * len(s))),
        shd.param_specs(params, cfg, mesh))
    own = checkpoint.reshard(params, shd.named(mesh, specs), device="cpu")
    ctx = shd.make_ctx(mesh)
    logits, cache = tr.prefill(own, _batch(cfg, tokens, frames), cfg, ctx,
                               pad_to=PROMPT + 1)
    step, _ = tr.decode_step(own, tokens[:, PROMPT:PROMPT + 1], cache,
                             PROMPT, cfg, ctx)
    return torch.stack([logits, step])


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_a_cut_encoder_or_decoder_alone_gives_the_whole_tree_s_logits(part):
    """The encoder and the decoder are each whole or cut independently:
    a cut encoder under whole decoder blocks, embedding and head, and
    whole encoder blocks under a cut decoder, give the whole tree's
    prefill and decode logits within 1e-5 in fp32 on every rank of (1,
    4) (the ranks as threads); ``_check_tree`` accepts either."""
    cfg = _cfg("seamless-m4t-medium")
    params = tr.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    tokens, frames = _tokens(), _frames()
    with torch.no_grad():
        logits, cache = tr.prefill(params, _batch(cfg, tokens, frames), cfg,
                                   pad_to=PROMPT + 1)
        step, _ = tr.decode_step(params, tokens[:, PROMPT:PROMPT + 1], cache,
                                 PROMPT, cfg)
    want = torch.stack([logits, step])[..., :cfg.vocab_size]
    for rank, got in enumerate(_chip_smoke().tp_as_ranks(
            _part_cut_case, (1, 4), cfg, params, tokens, frames, part)):
        np.testing.assert_allclose(got[..., :cfg.vocab_size].numpy(),
                                   want.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=f"rank {rank}")


def test_a_cross_block_cut_in_some_leaves_only_raises():
    """A decoder block of reduced seamless-m4t-medium with ``xwq`` cut by
    ``param_specs`` and ``xwo`` whole, and an encoder with ``wq`` cut and
    ``wo`` whole: prefill and decode raise before anything runs, naming
    dense tensor parallelism and A10.2c (and the encoder for the
    second)."""
    cfg = _cfg("seamless-m4t-medium")
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh, ctx = _mesh_ctx()
    cut = _cut(params, cfg, mesh)
    cross = {**cut, "blocks": {"b0": {**cut["blocks"]["b0"],
                                      "xwo": params["blocks"]["b0"]["xwo"]}}}
    enc = {**cut, "encoder": {**cut["encoder"], "blocks": {
        **cut["encoder"]["blocks"],
        "wo": params["encoder"]["blocks"]["wo"]}}}
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    batch = {"tokens": tokens, "frontend": torch.zeros(
        (1, cfg.frontend.num_positions, cfg.frontend.embed_dim))}
    cache = tr.init_decode_cache(cfg, 1, 8, "cpu")
    with torch.no_grad():
        for tree, match in ((cross, "xwq.* while \\['xwo'\\] are.*dense "
                                    "tensor parallelism.*ROADMAP A10.2c\\)"),
                            (enc, "encoder attn block.* while \\['wo'\\] "
                                  "are.*dense tensor parallelism.*ROADMAP "
                                  "A10.2c\\)")):
            with pytest.raises(NotImplementedError, match=match):
                tr.prefill(tree, batch, cfg, ctx)
            with pytest.raises(NotImplementedError, match=match):
                tr.decode_step(tree, tokens[:, :1], cache, 0, cfg, ctx)
        tr._check_tree(cut, cfg, ctx)


def test_a_tree_cut_in_some_leaves_only_raises():
    """``wq`` cut with ``wo`` whole in a stacked tree: prefill raises
    before anything runs, naming dense tensor parallelism and A10.2c; so
    does an ``embed`` cut to a block that is not this rank's."""
    cfg = _cfg("qwen2-7b")
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh, ctx = _mesh_ctx()
    cut = _cut(params, cfg, mesh)
    mixed = {**cut, "blocks": {"b0": {**cut["blocks"]["b0"],
                                      "wo": params["blocks"]["b0"]["wo"]}}}
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with torch.no_grad():
        with pytest.raises(NotImplementedError,
                           match="dense tensor parallelism.*ROADMAP A10.2c"):
            tr.prefill(mixed, batch, cfg, ctx)
        odd = {**params, "embed": params["embed"][:100]}
        with pytest.raises(NotImplementedError, match="embed.*A10.2c"):
            tr.prefill(odd, batch, cfg, ctx)


def test_autograd_through_a_dense_sum_raises(monkeypatch):
    """Training under dense tensor parallelism is ported for
    self-attention blocks, the dense MLP and the vocabulary
    (A10.2c-train; ``tests/test_torch_train_tensor_parallel.py``).  A cut
    RG-LRU block (reduced RecurrentGemma-9B), a cut SSD block (reduced
    Mamba-2-780M) and a cut cross-attention block (reduced
    seamless-m4t-medium) under autograd raise naming A10.2c-train-rec,
    and a cut attention block with a Mixture-of-Experts layer (reduced
    OLMoE) naming A10.2b-moe, each before any collective (here, with no
    process group, one would raise otherwise; every collective is made
    to fail loudly); the loss over a vocabulary cut by columns raises
    without a model axis in its ctx."""
    def no_collective(*args, **kwargs):
        raise AssertionError("a collective was reached")
    for name in ("psum", "replicated", "ring_all_gather"):
        monkeypatch.setattr(coll, name, no_collective)
    mesh, ctx = _mesh_ctx()
    for arch, kind, match in (
            ("recurrentgemma-9b", "rec", "rec block.*A10.2c-train-rec"),
            ("mamba2-780m", "ssd", "ssd block.*A10.2c-train-rec"),
            ("seamless-m4t-medium", "attn",
             "encoder-decoder.*A10.2c-train-rec"),
            ("olmoe-1b-7b", "attn", "Mixture-of-Experts.*A10.2b-moe")):
        cfg = _cfg(arch)
        params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        block = tree_map(lambda t: t.clone().requires_grad_(True),
                         _first_block(_cut(params, cfg, mesh), cfg, kind))
        x = torch.zeros((1, 4, cfg.d_model))
        enc_out = (torch.zeros((1, 8, cfg.d_model))
                   if cfg.encoder_layers else None)
        with pytest.raises(NotImplementedError, match=match):
            tr.apply_block_seq(kind, block, x, cfg, ctx,
                               positions=torch.arange(4), enc_out=enc_out)
    cfg = _cfg("olmoe-1b-7b")
    cut = _cut(tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
               cfg, mesh)
    with pytest.raises(ValueError, match="model axis"):
        tr.lm_loss(cut, torch.zeros((1, 4, cfg.d_model)),
                   torch.zeros((1, 4), dtype=torch.int32),
                   torch.ones((1, 4)), cfg)
