"""Training launcher: `python -m repro_torch.launch.train --arch smollm-135m`.

It trains the reduced config (`--full`: the registry config) for
`--steps` steps through `TrainLoop`, printing the logged steps and a
summary in the reference launcher's format.  With `--ckpt-dir` it writes
a checkpoint every 100 steps and a second run resumes from the newest.
It runs on the GPU unless `--device cpu` is given; without a GPU it
stops with an error.

`--data-parallel N` and `--model-parallel M` train on a mesh of N data
ranks by M model ranks: the launcher starts the N x M processes itself
(`distributed/world.py::run_world`, `gloo`, a rendezvous directory under
a fresh temporary directory that it removes, a time limit of
WORLD_TIMEOUT_S), each builds `make_host_mesh(N, M)` and its ctx and runs
`TrainLoop` on `--device` (with `cuda`, every rank on the one visible
card, the kernels' library built once before the ranks start).  Over
data ranks each rank takes its rows of the global batch, the gradients
are summed over the ranks in fp32, and the optimizer state is cut by
ZeRO-1; over model ranks each rank holds its `param_specs` blocks of the
parameters and runs under dense tensor parallelism; over both, each rank
takes its rows and its model blocks, the gradients of the blocks are
summed over the data ranks that share its model index, and ZeRO-1 cuts
the blocks' state over them (`train/train_loop.py`).  The lines printed
are rank 0's history, the summary ending `on mesh {'data': N, 'model':
M}`.

These raise before any rank starts, each naming its ROADMAP item: a
Mixture-of-Experts model over any mesh (A10.2b-moe); over a model axis
above 1, whatever the data axis, an RG-LRU, SSD or encoder-decoder model
(A10.2c-train-rec) and `--ckpt-dir` (A10.2c-train-ckpt).
"""
import argparse
import tempfile
from typing import Callable, Optional, Sequence

from repro_torch.compat import resolve_device
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.world import run_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import TrainConfig, TrainLoop

#: a world of ranks not done after this many seconds is killed (a hung
#: collective raises in its rank after ``world.COLLECTIVE_TIMEOUT_S``)
WORLD_TIMEOUT_S = 24 * 3600


def _train_rank(rank: int, world_size: int, cfg, dc, tc, mesh_shape,
                device: str, steps: int, rank_report: Optional[Callable],
                on_step: Optional[Callable]):
    """One rank of a mesh: (its history, ``rank_report``'s)."""
    ctx = sharding.make_ctx(make_host_mesh(*mesh_shape))
    loop = TrainLoop(cfg, dc, tc, ctx=ctx, device=device)
    params, opt_state, hist = loop.run(steps, on_step=on_step)
    report = (None if rank_report is None
              else rank_report(rank, loop, params, opt_state))
    return hist, report


def _refuse(cfg, mesh: dict, ckpt_dir) -> None:
    """The meshes and models the ranks cannot train, before any starts."""
    D, M = mesh["data"], mesh["model"]
    if D * M > 1 and cfg.moe is not None:
        raise NotImplementedError(
            f"mesh {mesh}: Mixture-of-Experts training over a mesh is "
            "ROADMAP A10.2b-moe")
    if M > 1 and (set(cfg.pattern_for_layers()) != {"attn"}
                  or cfg.encoder_layers):
        raise NotImplementedError(
            f"mesh {mesh}: training {cfg.name}'s RG-LRU, SSD or "
            "encoder-decoder blocks over a model axis is ROADMAP "
            "A10.2c-train-rec")
    if M > 1 and ckpt_dir:
        raise NotImplementedError(
            f"mesh {mesh}: a checkpoint over a model axis is ROADMAP "
            "A10.2c-train-ckpt")


def main(argv: Optional[Sequence[str]] = None, *,
         rank_report: Optional[Callable] = None,
         on_step: Optional[Callable] = None):
    """Parses ``argv`` (default: the command line), trains, prints, and
    returns the loop's history (the logged steps' metric dicts; rank 0's
    on a mesh).  With ``rank_report``, a module-level function
    ``rank_report(rank, loop, params, opt_state)`` called in each rank
    (in this process on one device) after the last step, it returns
    (history, [each rank's report]).  ``on_step``, a module-level
    function, is ``TrainLoop.run``'s hook, called in each rank after each
    step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (required)")
    args = ap.parse_args(argv)

    mesh = {"data": args.data_parallel, "model": args.model_parallel}
    cfg = get_config(args.arch) if args.full else reduced_config(args.arch)
    _refuse(cfg, mesh, args.ckpt_dir)
    dev = resolve_device(args.device)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch)
    tc = TrainConfig(
        optimizer=AdamWConfig(peak_lr=args.lr, warmup_steps=20,
                              total_steps=args.steps),
        checkpoint_dir=args.ckpt_dir, checkpoint_every=100, log_every=10)
    ranks = args.data_parallel * args.model_parallel
    if ranks == 1:
        loop = TrainLoop(cfg, dc, tc, device=dev)
        params, opt_state, hist = loop.run(args.steps, on_step=on_step)
        reports = (None if rank_report is None
                   else [rank_report(0, loop, params, opt_state)])
    else:
        if dev.type == "cuda":
            from repro_torch.kernels import _build
            _build.build_library()     # once, before the ranks load it
        with tempfile.TemporaryDirectory(prefix="train_world_") as workdir:
            results = run_world(
                _train_rank, ranks,
                (cfg, dc, tc, (args.data_parallel, args.model_parallel),
                 str(dev), args.steps, rank_report, on_step),
                workdir=workdir, timeout=WORLD_TIMEOUT_S)
        hist = results[0][0]
        reports = [r for _, r in results]
    for h in hist:
        print(f"step {h['step']:5d} loss {h['loss']:.4f} "
              f"gnorm {h['grad_norm']:.3f} lr {h['lr']:.2e}")
    print(f"\n{cfg.name}: loss {hist[0]['loss']:.3f} -> "
          f"{hist[-1]['loss']:.3f} over {args.steps} steps on "
          f"mesh {mesh}")
    return hist if rank_report is None else (hist, reports)


if __name__ == "__main__":
    main()
