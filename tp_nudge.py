"""How far one bf16 ulp in a prompt moves the logits, against how far the
tensor-parallel ranks sit from one process.

For full-width Mamba-2-780M, RecurrentGemma-9B and Qwen2-7B on one card:
the one process's bf16 prefill of 2 x 2048 tokens group by group, again
with one bf16 ulp added to channel 0 of row 0's first embedded token,
again with row 0 alone, and once more with the ranks of a (1, 4) mesh as
threads (``chip_smoke.tp_as_ranks``) on their ``param_specs`` blocks.
Prints one JSON line a model: each group's relative L2 from the one
process, and the logits' per row.  Run: ``python3 tp_nudge.py``."""
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def study(arch, n, nbytes):
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr
    from repro_torch.models.common import apply_norm
    from repro_torch.train import checkpoint
    cfg, params, _ = c.init_full_width(arch, n, nbytes)
    G, V = cfg.num_groups(), cfg.vocab_size
    kernels = ops.kernel_registry()
    tokens = torch.from_numpy(np.random.default_rng(c.SEED + 5).integers(
        0, V, (c.TP_BATCH, c.TP_PROMPT)).astype(np.int32)).cuda()
    pos = torch.arange(c.TP_PROMPT, device="cuda")

    def chain(p, x, ctx):
        xs = [x]
        for g in range(G):
            xs.append(tr.run_layer_range(p, xs[-1], cfg, ctx, start_group=g,
                                         stop_group=g + 1, positions=pos,
                                         kernels=kernels))
        h = apply_norm(p["final_norm"], xs[-1][:, -1:])
        return xs, tr.gather_vocab(tr.unembed(p, h, cfg, ctx), cfg, ctx)

    x0 = tr.embed_tokens(params, tokens, cfg)
    xs, logits = chain(params, x0, None)
    nudged = x0.clone()
    nudged.view(torch.int16)[0, 0, 0] += 1        # one bf16 ulp
    xs_n, logits_n = chain(params, nudged, None)
    one_row = chain(params, x0[:1], None)[1]
    out = {"arch": arch,
           "nudge_group_rel_l2": [rel(a, b) for a, b in zip(xs_n, xs)],
           "nudge_logits_rel_l2": [rel(logits_n[i, :, :V], logits[i, :, :V])
                                   for i in range(c.TP_BATCH)],
           "batch1_vs_batch2_logits_rel_l2": rel(one_row[0, :, :V],
                                                 logits[0, :, :V])}
    del xs_n, one_row

    def target(mesh):
        own = checkpoint.reshard(params, shd.named(
            mesh, shd.param_specs(params, cfg, mesh)), device="cuda")
        ctx = shd.make_ctx(mesh)
        ys, lg = chain(own, tr.embed_tokens(own, tokens, cfg, ctx), ctx)
        return [rel(a, b) for a, b in zip(ys, xs)], [
            rel(lg[i, :, :V], logits[i, :, :V]) for i in range(c.TP_BATCH)]
    ranks = c.tp_as_ranks(target, (1, 4))
    out["tp_1x4_group_rel_l2"], out["tp_1x4_logits_rel_l2"] = ranks[0]
    print(json.dumps(out), flush=True)
    del params, xs, logits
    gc.collect()
    torch.cuda.empty_cache()


if __name__ == "__main__":
    import repro_torch  # noqa: F401
    with torch.inference_mode():
        smi = c.phase_env()
        c.phase_build()
        study(c.SSD_ARCH, c.SSD_PARAMETERS, c.SSD_PARAMETER_BYTES)
        study(c.LM_ARCH, c.LM_PARAMETERS, c.LM_PARAMETER_BYTES)
        study(c.DECODE_ARCH, c.DECODE_PARAMETERS, c.DECODE_PARAMETER_BYTES)
    print(smi, flush=True)
