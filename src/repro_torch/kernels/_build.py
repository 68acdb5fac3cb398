"""Build and load the hand-written CUDA kernels (``csrc/*.cu``, which may
include the headers ``csrc/*.cuh``).

Each source is compiled by its own ``nvcc`` (all started together), the
objects are linked into ``build/repro_torch/libkernels.so`` under the
repository root, and the library is loaded with ``ctypes`` — plain C
entry points, no PyTorch headers, so the build takes seconds.  The build
runs at first use and is keyed by a hash of the sources, the headers and
the flags: an unchanged tree loads the library it finds.  A failed build
or a failed load raises; nothing here gives way to a plain PyTorch
version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
LIB_NAME = "libkernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildResult:
    """What ``build_library`` did: where the library is, whether nvcc ran
    (or the library on disk was current), how long it took, and the
    compiler's output (ptxas' resource report included)."""
    path: Path
    compiled: bool
    seconds: float
    sources: List[str]
    log: str


def sources() -> List[Path]:
    """The translation units: each is handed to its own nvcc."""
    return sorted(CSRC.glob("*.cu"))


def headers() -> List[Path]:
    """What a source may include: hashed with the sources, never compiled
    on its own."""
    return sorted(CSRC.glob("*.cuh"))


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in (os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
                 shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "repro_torch.kernels: nvcc not found (CUDA_HOME, PATH, "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _source_hash(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _run(cmd: List[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"kernel build failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build_library() -> BuildResult:
    """Compile ``csrc/*.cu`` into ``libkernels.so`` unless the library on
    disk was built from these very sources."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".hash")
    digest = _source_hash(srcs + headers())
    names = [p.name for p in srcs]
    t0 = time.perf_counter()
    if lib.is_file() and stamp.is_file() and stamp.read_text() == digest:
        return BuildResult(lib, False, time.perf_counter() - t0, names, "")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f".{os.getpid()}"
    objs = [BUILD_DIR / (p.stem + tag + ".o") for p in srcs]
    tmp_lib = BUILD_DIR / (LIB_NAME + tag)
    try:
        with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
            logs = list(pool.map(
                lambda so: _run([nvcc, *NVCC_FLAGS, "-c", str(so[0]),
                                 "-o", str(so[1])]),
                zip(srcs, objs)))
        logs.append(_run([nvcc, "-shared", "-o", str(tmp_lib),
                          *map(str, objs)]))
        os.replace(tmp_lib, lib)      # atomic: no reader sees half a file
        stamp.write_text(digest)
    finally:
        for leftover in (*objs, tmp_lib):
            leftover.unlink(missing_ok=True)
    return BuildResult(lib, True, time.perf_counter() - t0, names,
                       "".join(logs))


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built at first use, with the C
    signatures declared (pointers and the stream are ``c_void_p``: an
    undeclared pointer would be cut to 32 bits)."""
    lib = ctypes.CDLL(str(build_library().path))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    # x pointers, rows, widths, code and scale offsets (arrays of n_seg),
    # n_seg, out, stream
    llp = ctypes.POINTER(ll)
    lib.repro_int8_quantize_group.argtypes = [
        ctypes.POINTER(vp), llp, llp, llp, llp, ctypes.c_int, vp, vp]
    lib.repro_int8_quantize_group.restype = ctypes.c_int
    # rows, widest row, stream
    lib.repro_int8_empty_launch.argtypes = [ll, ll, vp]
    lib.repro_int8_empty_launch.restype = ctypes.c_int
    # q, k, v, o, lse (or None), BHq, BHkv, Sq, Skv, d, kv_len, causal,
    # window, scale, dtype, stream
    lib.repro_flash_attention.argtypes = [
        vp, vp, vp, vp, vp, ll, ll, ll, ll, ll, ll, ctypes.c_int, ll,
        ctypes.c_float, ctypes.c_int, vp]
    lib.repro_flash_attention.restype = ctypes.c_int
    # d, dtype -> smem bytes, blocks an SM, threads a block (out)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.repro_flash_attention_occupancy.argtypes = [ll, ctypes.c_int, ip,
                                                    ip, ip]
    lib.repro_flash_attention_occupancy.restype = ctypes.c_int
    # a, b, h0 (or None), h, B, S, W, stream
    lib.repro_rglru_scan.argtypes = [vp, vp, vp, vp, ll, ll, ll, vp]
    lib.repro_rglru_scan.restype = ctypes.c_int
    # x, dt, A, Bm, Cm, init_state (or None), y, final, states and decay
    # scratch (or None for one chunk), b, S, H, P, G, N, Q, stream
    lib.repro_ssd_scan.argtypes = [vp] * 10 + [ll] * 7 + [vp]
    lib.repro_ssd_scan.restype = ctypes.c_int
    # q, k, v, lengths, o, part_acc, part_ml, B, Hq, Hkv, Skv, d, k strides
    # (batch, seq, head), v strides, chunk, n_splits, scale, dtype, stream
    lib.repro_decode_attention.argtypes = (
        [vp] * 7 + [ll] * 13 + [ctypes.c_float, ctypes.c_int, vp])
    lib.repro_decode_attention.restype = ctypes.c_int
    # d -> smem bytes, blocks an SM, threads a block (out), bf16 kernel
    lib.repro_decode_attention_occupancy.argtypes = [ll, ip, ip, ip]
    lib.repro_decode_attention_occupancy.restype = ctypes.c_int
    return lib


def refuse_grad(what: str, *tensors) -> None:
    """Raise where autograd would follow the inputs of a kernel that has
    no backward: a result filled through ``ctypes`` carries no
    ``grad_fn``, so a loss taken through it would get no gradient,
    without a word.  Decode attention and the int8 quantiser are never
    differentiated (training runs flash attention and the scans, whose
    wrappers are ``torch.autograd.Function``s); the decode wrapper calls
    this before it launches on CUDA tensors."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward (it "
                           "serves decode, which is never differentiated); "
                           "call it under torch.no_grad() or "
                           "torch.inference_mode(), or on inputs that do "
                           "not require grad")


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel launch returned a CUDA error code."""
    if code != 0:
        name = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({code}: {name})")
