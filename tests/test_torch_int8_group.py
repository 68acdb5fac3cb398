"""The grouped int8 boundary quantiser: its plain version against the
reference's Pallas kernel (interpret mode on the CPU) and the numpy
transport reference, segment by segment; a numpy transcription of how
the CUDA kernel cuts a row across the blocks of a thread-block cluster;
and the engine's int8 payloads, which one grouped call makes, against
``pack_boundary_wire`` with the numpy quantiser.  Codes must be equal
everywhere, scales bit-equal to numpy's IEEE quotient and within one unit
in the last place of the Pallas kernel's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transport as ref_transport
from repro.kernels import int8_quant as ref_int8
from repro_torch.configs import stable_diffusion_v1 as configs
from repro_torch.core import cost_model, telemetry, transport
from repro_torch.kernels import _build, int8_quant
from repro_torch.models import diffusion as dif
from repro_torch.serving import engine

# The models here are tiny: one thread each, or the test workers that
# share a machine fight over cores inside PyTorch's thread pool.
torch.set_num_threads(1)

# mixes of the shapes of tests/test_torch_int8_quant.py
MIXES = [
    [(4, 4096), (2, 59136)],                      # one request's boundary
    [(12, 4096), (6, 59136)],                     # a group of three
    [(28, 4096)],                                 # an end group (latent only)
    [(100, 333), (1, 8), (7, 1024)],              # ragged
    [(509, 256), (256, 64), (130, 64), (4, 4096), (1, 8), (2, 59136)],
]

# The CUDA kernel's constants (csrc/int8_quant.cu): floats a block keeps
# in registers (kVec float4 x kThreads), the largest cluster.
KEEP = 8 * 256 * 4
MAX_CLUSTER = 8


def _input(T, d, seed=0):
    return np.random.default_rng(seed).standard_normal((T, d)).astype(
        np.float32) * 3.0


def _group(shapes, seed=0):
    return [_input(T, d, seed + k) for k, (T, d) in enumerate(shapes)]


@pytest.mark.parametrize("shapes", MIXES)
def test_layout_is_aligned_and_disjoint(shapes):
    s_offs, q_offs, nbytes = int8_quant.group_layout(shapes)
    spans = sorted([(so, so + 4 * T) for so, (T, _) in zip(s_offs, shapes)]
                   + [(qo, qo + T * d) for qo, (T, d) in zip(q_offs, shapes)])
    assert spans[0][0] == 0 and spans[-1][1] == nbytes
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert all(so % 4 == 0 for so in s_offs)
    assert all(qo % 16 == 0 for qo in q_offs)


@pytest.mark.parametrize("shapes", MIXES)
def test_plain_group_matches_pallas_and_numpy(shapes):
    xs = _group(shapes)
    buf = int8_quant.int8_quantize_group([torch.from_numpy(x) for x in xs])
    assert buf.dtype == torch.uint8
    assert buf.numel() == int8_quant.group_layout(shapes)[2]
    for x, (q, s) in zip(xs, int8_quant.split_group(buf, shapes)):
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert tuple(q.shape) == x.shape and tuple(s.shape) == (x.shape[0], 1)
        q_np, s_np = ref_transport.rowwise_quantize_int8(x)
        np.testing.assert_array_equal(q.numpy(), q_np)
        np.testing.assert_array_equal(s.numpy(), s_np)
        q_pl, s_pl = ref_int8.int8_quantize(jnp.asarray(x), interpret=True)
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_pl))
        # XLA does not divide by 127 as IEEE does: the Pallas kernel's
        # scale can sit one unit in the last place from the quotient
        ulp = np.abs(s.numpy().view(np.int32).astype(np.int64)
                     - np.asarray(s_pl).view(np.int32))
        assert ulp.max() <= 1
    # the host's copy of the buffer reads the same through numpy views
    for (q, s), (qn, sn) in zip(int8_quant.split_group(buf, shapes),
                                int8_quant.split_group(buf.numpy(), shapes)):
        np.testing.assert_array_equal(q.numpy(), qn)
        np.testing.assert_array_equal(s.numpy(), sn)


def _block_slices(d, csize, vec):
    """The elements each block of a row's cluster reads, cut as the kernel
    cuts them: float4 groups where the row starts on 16 bytes (its d % 4
    last floats then go to the last block), single floats otherwise."""
    n = d // 4 if vec else d
    per = -(-n // csize)
    out = []
    for rank in range(csize):
        lo = min(n, rank * per)
        hi = min(n, lo + per)
        idx = np.arange(4 * lo, 4 * hi) if vec else np.arange(lo, hi)
        if vec and rank == csize - 1:
            idx = np.concatenate([idx, np.arange(4 * n, d)])
        out.append(idx)
    return out


@pytest.mark.parametrize("vec", [True, False], ids=["float4", "scalar"])
@pytest.mark.parametrize("csize", range(1, MAX_CLUSTER + 1))
@pytest.mark.parametrize("d", [8, 333, 4096, 59136])
def test_cluster_split_takes_every_element_once(d, csize, vec):
    """Every element is in exactly one block's slice, and quantising each
    slice with the max of the blocks' partial maxima gives the plain
    version's codes and scale, bit for bit."""
    slices = _block_slices(d, csize, vec)
    seen = np.zeros(d, np.int64)
    for idx in slices:
        np.add.at(seen, idx, 1)
    assert (seen == 1).all()
    x = _input(1, d, seed=d + csize)[0]
    x[-1] = 50.0            # the max sits at the row's end
    partial = [np.abs(x[idx]).max() if idx.size else np.float32(0.0)
               for idx in slices]
    s = np.maximum(np.float32(max(partial)) / np.float32(127.0),
                   np.float32(1e-12))
    q = np.empty(d, np.int8)
    for idx in slices:
        q[idx] = np.clip(np.round(x[idx] / s), -127, 127).astype(np.int8)
    q_ref, s_ref = int8_quant.int8_quantize_ref(torch.from_numpy(x[None]))
    np.testing.assert_array_equal(q, q_ref.numpy()[0])
    assert s.tobytes() == s_ref.numpy()[0, 0].tobytes()


@pytest.mark.parametrize("d,cluster", [(8, 1), (4096, 1), (8192, 1),
                                       (8193, 2), (59136, 8), (65536, 8)])
def test_the_cluster_keeps_the_widest_row_in_registers(d, cluster):
    """The kernel's cluster size: the fewest blocks whose float4 slices of
    the widest row fit in their registers, at most 8."""
    got = min(max(-(-d // KEEP), 1), MAX_CLUSTER)
    assert got == cluster
    assert max(idx.size for idx in _block_slices(d, got, True)) <= KEEP


# -- the engine: one grouped call, one copy, the same bytes ----------------
@pytest.fixture(scope="module")
def diffusion():
    cfg = configs.reduced()
    params = dif.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, params


def _engine(diffusion, wire):
    cfg, params = diffusion
    cost = cost_model.CostParams(r_cloud=10.0, n_total=cfg.n_total_iterations,
                                 n_step=cfg.split_stride, t_lim=5.0,
                                 k_decode=1.0)
    return engine.DiffusionSplitEngine(params, cfg, cost,
                                       link=transport.LOCAL_LINK, wire=wire,
                                       device="cpu")


def _requests(cfg, n):
    rng = np.random.default_rng(1)
    return [engine.Request(
        f"r{i}", telemetry.DeviceProfile(f"d{i}", 5.0),
        rng.integers(0, cfg.text_vocab, (1, cfg.text_len), dtype=np.int32),
        np.zeros((1, cfg.text_len), np.int32)) for i in range(n)]


def _latent(cfg, n):
    return np.random.default_rng(2).standard_normal(
        (n, cfg.latent_channels, cfg.latent_size, cfg.latent_size)).astype(
            np.float32)


@pytest.mark.parametrize("end", [False, True], ids=["mid", "end"])
@pytest.mark.parametrize("wire", ["int8", "int8_zlib"])
def test_int8_payloads_equal_pack_boundary_wire(diffusion, wire, end):
    """Each payload of a group is byte for byte what the numpy quantiser
    makes of the same fp32 boundary, which an fp32-wire engine ships
    exactly; a mid group ships the context, an end group does not."""
    cfg, _ = diffusion
    n_cloud = cfg.n_total_iterations if end else 4
    reqs = _requests(cfg, 3)
    got = _engine(diffusion, wire).process_group(
        reqs, n_cloud, latent=_latent(cfg, 3))
    dense = _engine(diffusion, "fp32").process_group(
        reqs, n_cloud, latent=_latent(cfg, 3))
    for g, dn in zip(got, dense):
        lat, ctx = transport.unpack_boundary(dn.payload)
        assert (ctx is None) == end
        want = ref_transport.pack_boundary_wire(
            lat, ctx, wire, rowwise=ref_transport.rowwise_quantize_int8)
        assert g.payload == want


def test_int8_group_is_one_call_one_copy_and_no_fp32_download(
        diffusion, monkeypatch):
    """``process_group`` on the int8 wire calls the grouped quantiser once
    a group and copies one uint8 buffer to the host; no float tensor is
    brought to the host.  A GPU engine runs these very lines: only the
    wrapper's branch (the kernel) and the pinned staging buffer differ."""
    cfg, _ = diffusion
    calls, copies, downloads = [], [], []
    grouped = int8_quant.int8_quantize_group

    def counting(segments):
        calls.append([tuple(x.shape) for x in segments])
        return grouped(segments)

    def spy(name):
        real = getattr(torch.Tensor, name)

        def method(self, *args, **kwargs):
            if self.dtype.is_floating_point:
                downloads.append((name, tuple(self.shape)))
            return real(self, *args, **kwargs)
        return method

    real_copy = torch.Tensor.copy_

    def copy_(self, src, *args, **kwargs):
        if self.dtype == src.dtype == torch.uint8:
            copies.append((self.device.type, src.device.type, self.numel()))
        return real_copy(self, src, *args, **kwargs)

    monkeypatch.setattr(int8_quant, "int8_quantize_group", counting)
    for name in ("cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, spy(name))
    monkeypatch.setattr(torch.Tensor, "copy_", copy_)
    eng = _engine(diffusion, "int8")
    C, S = cfg.latent_channels, cfg.latent_size
    L, W = cfg.text_len, cfg.text_width
    for B, n_cloud, segs in (
            (3, 4, [(3 * C, S * S), (6, L * W)]),
            (2, cfg.n_total_iterations, [(2 * C, S * S)])):
        calls.clear()
        copies.clear()
        eng.process_group(_requests(cfg, B), n_cloud, latent=_latent(cfg, B))
        assert calls == [segs]
        assert copies == [("cpu", "cpu",
                           int8_quant.group_layout(segs)[2])]
    assert downloads == []


# -- the wrapper's device dispatch -----------------------------------------
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


def test_cuda_group_never_reaches_the_plain_version(monkeypatch):
    def no_library():
        raise RuntimeError("no kernel library")

    def no_plain(segments):
        raise AssertionError("plain version called for a CUDA group")

    monkeypatch.setattr(_build, "load_library", no_library)
    monkeypatch.setattr(int8_quant, "int8_quantize_group_ref", no_plain)
    before = int8_quant.launch_count
    with pytest.raises(RuntimeError, match="no kernel library"):
        int8_quant.int8_quantize_group([_FakeCudaTensor(), _FakeCudaTensor()])
    assert int8_quant.launch_count == before


@pytest.mark.parametrize("segments", [
    [],                                                    # nothing to do
    [_FakeCudaTensor()] * (int8_quant.MAX_SEGMENTS + 1),   # too many
    [_FakeCudaTensor(), torch.zeros((2, 3))],              # two devices
])
def test_group_wrapper_refuses_before_it_loads(monkeypatch, segments):
    monkeypatch.setattr(_build, "load_library",
                        lambda: pytest.fail("loaded before validation"))
    with pytest.raises(ValueError):
        int8_quant.int8_quantize_group(segments)
