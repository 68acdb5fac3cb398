"""Training launcher: `python -m repro_torch.launch.train --arch smollm-135m`.

It trains the reduced config (`--full`: the registry config) for
`--steps` steps through `TrainLoop`, printing the logged steps and a
summary in the reference launcher's format.  With `--ckpt-dir` it writes
a checkpoint every 100 steps and a second run resumes from the newest.
It runs on the GPU unless `--device cpu` is given; without a GPU it
stops with an error.  It trains on one device: `--data-parallel` or
`--model-parallel` above 1 raise (a mesh is ROADMAP A10).
"""
import argparse
from typing import Optional, Sequence

from repro_torch.compat import resolve_device
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import TrainConfig, TrainLoop


def main(argv: Optional[Sequence[str]] = None):
    """Parses ``argv`` (default: the command line), trains, prints, and
    returns the loop's history (the logged steps' metric dicts)."""
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
    if mesh != {"data": 1, "model": 1}:
        raise NotImplementedError(
            f"mesh {mesh}: this launcher trains on one device; data and "
            "model parallelism are ROADMAP A10")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else reduced_config(args.arch)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch)
    tc = TrainConfig(
        optimizer=AdamWConfig(peak_lr=args.lr, warmup_steps=20,
                              total_steps=args.steps),
        checkpoint_dir=args.ckpt_dir, checkpoint_every=100, log_every=10)
    loop = TrainLoop(cfg, dc, tc, device=dev)
    _, _, hist = loop.run(args.steps)
    for h in hist:
        print(f"step {h['step']:5d} loss {h['loss']:.4f} "
              f"gnorm {h['grad_norm']:.3f} lr {h['lr']:.2e}")
    print(f"\n{cfg.name}: loss {hist[0]['loss']:.3f} -> "
          f"{hist[-1]['loss']:.3f} over {args.steps} steps on "
          f"mesh {mesh}")
    return hist


if __name__ == "__main__":
    main()
