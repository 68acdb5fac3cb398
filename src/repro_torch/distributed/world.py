"""A world of ranks on one host, each a fresh interpreter.

``run_world(target, world_size, args, workdir=..., timeout=...)`` starts
``world_size`` processes by the ``spawn`` start method (never ``fork``:
the caller may hold threads and a CUDA context), joins each to a
``gloo`` process group (the backend that runs several ranks on one GPU,
or on the CPU) through a rendezvous file in ``workdir``, calls
``target(rank, world_size, *args)`` in every rank and returns what each
rank returned, in rank order.

``args`` travel by ``torch.multiprocessing``'s pickler: a CUDA tensor goes
as a CUDA IPC handle (the rank maps the caller's memory; the caller keeps
it alive until ``run_world`` returns, and should call
``torch.cuda.ipc_collect()`` then), a CPU tensor through shared memory.
Each rank drops its references to ``args`` when ``target`` returns.
``target`` is pickled by its import path, so it is a module-level
function of a module the ranks can import.

Each rank runs with ``OMP_NUM_THREADS=1`` and one PyTorch thread, its
``gloo`` pairs on the loopback interface unless ``GLOO_SOCKET_IFNAME``
says otherwise (the world is one host), writes its stderr to
``workdir/rank<r>.stderr``, and destroys its process group whatever
``target`` does.  If a rank exits non-zero, or the world is not done
after ``timeout`` seconds, the other ranks are killed and
``RuntimeError`` is raised with the tail of every rank's stderr.

Not ``torch.multiprocessing.start_processes``: it writes its error files
to the system's temporary directory, not to ``workdir``, leaves them
there when a rank raises, and waits 30 s after SIGTERM before it kills a
rank that does not stop.
"""
from __future__ import annotations

import contextlib
import datetime
import gc
import multiprocessing.connection
import os
import pickle
import time
from pathlib import Path
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing

#: how long a collective of a rank waits for its peers before it raises
COLLECTIVE_TIMEOUT_S = 120
STDERR_TAIL_BYTES = 4000


def _rank_main(target, rank: int, world_size: int, workdir: str,
               args: List[Any]) -> None:
    with open(os.path.join(workdir, f"rank{rank}.stderr"), "w") as err:
        os.dup2(err.fileno(), 2)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        result = target(rank, world_size, *args)
    finally:
        # drop the rank's references to what the caller shared before the
        # interpreter exits (the process object keeps its arguments to the
        # end): a CUDA block sent by IPC stays held by the caller until
        # every rank has released it
        args.clear()
        gc.collect()
        dist.destroy_process_group()
    path = os.path.join(workdir, f"rank{rank}.result")
    with open(path + ".part", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".part", path)


@contextlib.contextmanager
def _environ(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _tails(workdir: Path, world_size: int) -> str:
    out = []
    for r in range(world_size):
        path = workdir / f"rank{r}.stderr"
        text = path.read_bytes()[-STDERR_TAIL_BYTES:].decode(
            errors="replace") if path.exists() else "(no stderr file)"
        out.append(f"--- rank {r} stderr (tail) ---\n{text}")
    return "\n".join(out)


def run_world(target: Callable, world_size: int, args: Sequence[Any] = (),
              *, workdir, timeout: float) -> List[Any]:
    """Run ``target(rank, world_size, *args)`` in ``world_size`` fresh
    processes joined in one process group; the ranks' return values in
    rank order.  ``workdir`` must be an empty directory of the caller's
    (the rendezvous file, each rank's stderr and result go there)."""
    workdir = Path(workdir)
    if any(workdir.iterdir()):
        raise ValueError(f"{workdir} is not empty")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(target, r, world_size, str(workdir),
                               list(args)))
             for r in range(world_size)]
    failure = None
    try:
        with _environ(OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME=os.environ.get(
                "GLOO_SOCKET_IFNAME", "lo")):
            for p in procs:
                p.start()
        deadline = time.monotonic() + timeout
        while failure is None:
            codes = [p.exitcode for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failure = f"rank {bad[0][0]} exited with code {bad[0][1]}"
            elif all(c == 0 for c in codes):
                break
            elif time.monotonic() > deadline:
                failure = f"the world was not done after {timeout} s"
            else:
                multiprocessing.connection.wait(
                    [p.sentinel for p in procs if p.exitcode is None],
                    timeout=min(1.0, max(0.0, deadline - time.monotonic())))
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(30)
    if failure is not None:
        raise RuntimeError(f"run_world({getattr(target, '__name__', target)},"
                           f" {world_size}): {failure}; the other ranks "
                           f"were killed\n{_tails(workdir, world_size)}")
    results = []
    for r in range(world_size):
        with open(workdir / f"rank{r}.result", "rb") as f:
            results.append(pickle.load(f))
    return results
