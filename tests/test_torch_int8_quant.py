"""Port parity: the int8 boundary quantiser's plain PyTorch version
against the reference's Pallas kernel (interpret mode on the CPU), its
jnp oracle and the numpy transport reference — all on the same numpy
inputs.  Integer codes must be equal; scales agree to rtol 1e-6 (observed:
bit-equal on every case here)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transport as ref_transport
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro_torch.kernels import _build, int8_quant, ops

# The models here are tiny: one thread each, or the test workers that
# share a machine fight over cores inside PyTorch's thread pool.
torch.set_num_threads(1)

SHAPES = [(100, 333), (256, 64), (7, 1024),       # the reference's test grid
          (509, 256), (1, 8), (130, 64),          # ragged
          (4, 4096), (2, 59136)]                  # serving path, full width


def _input(T, d, seed=0):
    return np.random.default_rng(seed).standard_normal((T, d)).astype(
        np.float32) * 3.0


def _references(x):
    return {
        "pallas": ref_ops.int8_quantize(jnp.asarray(x)),
        "oracle": ref_oracle.int8_quantize_ref(jnp.asarray(x)),
        "numpy": ref_transport.rowwise_quantize_int8(x),
    }


def _assert_matches_references(x):
    q, s = ops.int8_quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == x.shape and tuple(s.shape) == (x.shape[0], 1)
    for name, (qr, sr) in _references(x).items():
        np.testing.assert_array_equal(q.numpy(), np.asarray(qr), err_msg=name)
        np.testing.assert_allclose(s.numpy(), np.asarray(sr), rtol=1e-6,
                                   err_msg=name)
    return q, s


@pytest.mark.parametrize("T,d", SHAPES)
def test_int8_quantize_matches_reference(T, d):
    x = _input(T, d)
    q, s = _assert_matches_references(x)
    # round-trip error bounded by half a step per row
    back = ops.int8_dequantize(q, s).numpy()
    assert np.all(np.abs(back - x) <= s.numpy() / 2 + 1e-6)


def test_all_zero_row():
    x = _input(5, 64)
    x[2] = 0.0
    q, s = _assert_matches_references(x)
    assert float(s[2]) == pytest.approx(1e-12) and not q[2].any()


def test_exact_ties_round_to_even():
    # max |row| == 127 makes the scale exactly 1, so k + 0.5 stays a tie
    row = np.arange(-125, 125, dtype=np.float32) + 0.5
    row[0] = 127.0
    x = np.stack([row, -row])
    q, s = _assert_matches_references(x)
    assert s.numpy().tolist() == [[1.0], [1.0]]
    want = np.clip(np.round(row), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(q[0].numpy(), want)
    assert q[0, 1].item() == -124 and q[0, 2].item() == -122   # -123.5, -122.5


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_half_inputs_are_quantized_in_fp32(dtype):
    x = torch.from_numpy(_input(9, 40)).to(dtype)
    q, s = ops.int8_quantize(x)
    qr, sr = ref_transport.rowwise_quantize_int8(x.float().numpy())
    np.testing.assert_array_equal(q.numpy(), qr)
    np.testing.assert_array_equal(s.numpy(), sr)


class _FakeCudaTensor:
    """What the wrapper looks at before it launches, with is_cuda true."""
    is_cuda = True
    dtype = torch.float32
    shape = (4, 16)
    device = torch.device("cuda", 0)

    def dim(self):
        return 2

    def is_contiguous(self):
        return True


def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch):
    def no_library():
        raise RuntimeError("no kernel library")

    def no_plain(x):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(_build, "load_library", no_library)
    monkeypatch.setattr(int8_quant, "int8_quantize_ref", no_plain)
    before = int8_quant.launch_count
    with pytest.raises(RuntimeError, match="no kernel library"):
        int8_quant.int8_quantize(_FakeCudaTensor())
    assert int8_quant.launch_count == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library()


@pytest.mark.parametrize("bad", [
    torch.zeros(3, dtype=torch.float32),                 # not 2-D
    torch.zeros((2, 3), dtype=torch.int32),              # not float
])
def test_wrapper_validates_cuda_inputs(monkeypatch, bad):
    fake = _FakeCudaTensor()
    fake.dtype, fake.shape = bad.dtype, tuple(bad.shape)
    fake.dim = bad.dim
    monkeypatch.setattr(_build, "load_library",
                        lambda: pytest.fail("loaded before validation"))
    with pytest.raises((ValueError, TypeError)):
        int8_quant.int8_quantize(fake)


# -- the build helper's control flow, with a stand-in compiler --------------
_FAKE_NVCC = """#!/bin/sh
# stand-in compiler: writes its output file, fails on sources named bad*,
# and logs each call's arguments beside itself
echo "$@" >> "$(dirname "$0")/calls.log"
out=""; prev=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  case "$a" in */bad*.cu) echo "error: bad source" >&2; exit 1;; esac
  prev="$a"
done
echo "ptxas info    : Used 32 registers" >&2
echo built > "$out"
"""


@pytest.fixture
def fake_toolchain(monkeypatch, tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a")
    (csrc / "b.cu").write_text("// b")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    return csrc, tmp_path / "build"


def test_build_is_keyed_by_the_sources(fake_toolchain):
    csrc, build = fake_toolchain
    first = _build.build_library()
    assert first.compiled and first.sources == ["a.cu", "b.cu"]
    assert first.path == build / _build.LIB_NAME and first.path.is_file()
    assert first.log.count("registers") == 3        # two compiles, one link
    assert sorted(p.name for p in build.iterdir()) == [
        _build.LIB_NAME, _build.LIB_NAME + ".hash"]  # objects cleaned up
    assert not _build.build_library().compiled       # unchanged: reused
    (csrc / "a.cu").write_text("// a, edited")
    assert _build.build_library().compiled           # edited: rebuilt


def test_a_header_is_hashed_but_never_compiled_alone(fake_toolchain):
    """A change to a header (``*.cuh``) alone rebuilds the library, and
    nvcc is only ever handed the ``*.cu`` sources."""
    csrc, build = fake_toolchain
    (csrc / "common.cuh").write_text("// shared helpers")
    first = _build.build_library()
    assert first.compiled and first.sources == ["a.cu", "b.cu"]
    assert not _build.build_library().compiled       # unchanged: reused
    (csrc / "common.cuh").write_text("// shared helpers, edited")
    assert _build.build_library().compiled           # header edited: rebuilt
    (csrc / "other.cuh").write_text("// a new header")
    assert _build.build_library().compiled           # header added: rebuilt
    calls = (csrc.parent / "calls.log").read_text().splitlines()
    assert len(calls) == 9                     # three builds: 2 compiles + link
    assert not any(".cuh" in call for call in calls)
    compiled = [a for call in calls for a in call.split()
                if a.endswith(".cu")]
    assert sorted(compiled) == sorted([str(csrc / "a.cu"),
                                       str(csrc / "b.cu")] * 3)


def test_failed_build_raises_and_leaves_no_library(fake_toolchain):
    csrc, build = fake_toolchain
    (csrc / "bad.cu").write_text("// does not compile")
    with pytest.raises(RuntimeError, match="kernel build failed"):
        _build.build_library()
    assert not (build / _build.LIB_NAME).exists()
    assert not list(build.glob("*.o"))
