"""Port parity, the slice as a whole: the same requests and the same
starting latent through the reference's split-serving engine and the
port's, for the legacy payload and two wire formats."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import stable_diffusion_v1 as ref_configs
from repro.core import cost_model as ref_cost
from repro.core import telemetry as ref_telemetry
from repro.core import transport as ref_transport
from repro.models import diffusion as ref_dif
from repro.serving import engine as ref_engine
from repro_torch.configs import stable_diffusion_v1 as configs
from repro_torch.convert import from_jax_params
from repro_torch.core import cost_model, telemetry, transport
from repro_torch.launch import serve
from repro_torch.serving import engine

# The models here are tiny: one thread each, or the test workers that
# share a machine fight over cores inside PyTorch's thread pool.
torch.set_num_threads(1)

SEED = 0
COUNTERS = ("executables", "cache_hits", "cache_misses", "requests",
            "bytes_shipped")


@pytest.fixture(scope="module")
def models():
    ref_cfg = ref_configs.reduced()
    ref_params = ref_dif.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = from_jax_params(
        jax.tree_util.tree_map(np.asarray, ref_params), "cpu")
    return ref_cfg, ref_params, configs.reduced(), params


def _requests(mod_engine, mod_telemetry, cfg, n=3):
    fleet = mod_telemetry.generate_fleet(n, 2.25, 0.8, seed=SEED,
                                         rtt=0.004)
    rng = np.random.default_rng(SEED)
    reqs = []
    for d in fleet:
        cond = rng.integers(0, cfg.text_vocab, (1, cfg.text_len),
                            dtype=np.int32)
        reqs.append(mod_engine.Request(
            d.device_id, d, cond, np.zeros((1, cfg.text_len), np.int32)))
    return reqs


def _latent(cfg, batch):
    """The very array the reference engine draws for this seed and batch."""
    return np.asarray(jax.random.normal(
        jax.random.PRNGKey(SEED),
        (batch, cfg.latent_channels, cfg.latent_size, cfg.latent_size)))


def _serve_port(eng, reqs, cfg):
    """``serve`` with the reference's starting latent handed in."""
    groups = {}
    for r in reqs:
        groups.setdefault(eng.assign(r.device), []).append(r)
    out = {}
    for n_cloud, members in sorted(groups.items()):
        for res in eng.process_group(members, n_cloud, SEED,
                                     latent=_latent(cfg, len(members))):
            out[res.request_id] = res
    return out


@pytest.mark.parametrize("wire,ctx_atol", [(None, 1e-3), ("fp16", 1e-3),
                                           ("int8", 2e-2)])
def test_engines_agree(models, wire, ctx_atol):
    ref_cfg, ref_params, cfg, params = models
    kw = dict(r_cloud=40.0, n_total=cfg.n_total_iterations,
              n_step=cfg.split_stride, t_lim=3.0, k_decode=1.0)
    ref_eng = ref_engine.DiffusionSplitEngine(
        ref_params, ref_cfg, ref_cost.CostParams(**kw),
        link=ref_transport.LOCAL_LINK, wire=wire)
    eng = engine.DiffusionSplitEngine(
        params, cfg, cost_model.CostParams(**kw),
        link=transport.LOCAL_LINK, wire=wire, device="cpu")
    ref_reqs = _requests(ref_engine, ref_telemetry, ref_cfg)
    reqs = _requests(engine, telemetry, cfg)
    # twice, so that the second round hits the executable cache
    for _ in range(2):
        want = ref_eng.serve(ref_reqs, seed=SEED)
        got = _serve_port(eng, reqs, cfg)
    assert got.keys() == want.keys()
    assert len({r.n_cloud for r in got.values()}) >= 2
    for rid, w in want.items():
        g = got[rid]
        assert g.n_cloud == w.n_cloud
        assert len(g.payload) == len(w.payload)
        assert g.transfer_seconds == w.transfer_seconds
        lat, ctx = transport.unpack_boundary(g.payload)
        ref_lat, ref_ctx = ref_transport.unpack_boundary(w.payload)
        # The two engines' fp32 latents differ in their last bits
        # (observed 3e-4 on values up to 60), so a value that sits on a
        # rounding boundary of the wire format may land one step apart:
        # one fp16 step is 2**-10 of the value, one int8 code is the
        # row's max / 127.
        scale = float(np.abs(ref_lat).max())
        lat_tol = {None: dict(atol=1e-3),
                   "fp16": dict(atol=1e-3, rtol=2.0 ** -10),
                   "int8": dict(atol=1.001 * scale / 127 + 1e-3)}[wire]
        np.testing.assert_allclose(lat, ref_lat, **lat_tol)
        # contexts are O(1): observed 1.7e-6 before encoding
        np.testing.assert_allclose(np.asarray(ctx, np.float32),
                                   np.asarray(ref_ctx, np.float32),
                                   atol=ctx_atol)
    assert engine.ENGINE_STATS_KEYS == ref_engine.ENGINE_STATS_KEYS
    assert tuple(eng.stats) == tuple(ref_eng.stats)
    for key in COUNTERS:
        assert eng.stats[key] == ref_eng.stats[key], key
    assert eng.stats["cache_hits"] == eng.stats["cache_misses"] >= 2

    ref_sim = ref_engine.DiffusionDeviceSim(ref_params, ref_cfg)
    sim = engine.DiffusionDeviceSim(params, cfg, device="cpu")
    one_per_group = {r.n_cloud: rid for rid, r in want.items()}
    for rid in one_per_group.values():
        ref_img = np.asarray(ref_sim.complete(want[rid]))
        img = sim.complete(got[rid]).numpy()
        assert img.shape == ref_img.shape
        # observed 4e-4 (int8: the payloads differ by one code)
        np.testing.assert_allclose(img, ref_img, atol=2e-3)
    for key in ("executables", "cache_hits", "cache_misses", "requests"):
        assert sim.stats[key] == ref_sim.stats[key], key


def test_split_does_not_change_the_output(models):
    """Cloud [0,n) + device [n,N) + VAE == all on one machine (fp32 wire)."""
    _, _, cfg, params = models
    from repro_torch.models import diffusion as dif
    cost = cost_model.CostParams(r_cloud=10.0, n_total=cfg.n_total_iterations,
                                 n_step=cfg.split_stride, t_lim=5.0,
                                 k_decode=1.0)
    eng = engine.DiffusionSplitEngine(params, cfg, cost,
                                      link=transport.LOCAL_LINK, wire="fp32",
                                      device="cpu")
    sim = engine.DiffusionDeviceSim(params, cfg, device="cpu")
    toks = np.zeros((1, cfg.text_len), np.int32)
    req = engine.Request("r", telemetry.DeviceProfile("d", 5.0), toks, toks)
    images = [sim.complete(eng.process_group([req], n, seed=3)[0])
              for n in (0, 4, cfg.n_total_iterations)]
    with torch.inference_mode():
        t = torch.from_numpy(toks)
        ctx2 = dif.encode_prompt(params, cfg, t, t)
        lat = torch.randn((1, cfg.latent_channels, cfg.latent_size,
                           cfg.latent_size),
                          generator=torch.Generator().manual_seed(3))
        mono = dif.apply_vae_decoder(params["vae"], cfg, dif.denoise_range(
            params, cfg, lat, ctx2, 0, cfg.n_total_iterations))
    for img in images:
        np.testing.assert_allclose(img.numpy(), mono.numpy(), atol=1e-4)


def test_injected_latent_is_checked(models):
    _, _, cfg, params = models
    cost = cost_model.CostParams(r_cloud=10.0, n_total=cfg.n_total_iterations,
                                 n_step=cfg.split_stride, t_lim=5.0)
    eng = engine.DiffusionSplitEngine(params, cfg, cost, device="cpu")
    toks = np.zeros((1, cfg.text_len), np.int32)
    req = engine.Request("r", telemetry.DeviceProfile("d", 5.0), toks, toks)
    with pytest.raises(ValueError, match="latent shape"):
        eng.process_group([req], 2, latent=np.zeros((2, 4, 8, 8), np.float32))
    assert eng.process_group([], 2) == []


def test_entry_points_need_a_gpu_unless_told_cpu(models):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves to it")
    _, _, cfg, params = models
    cost = cost_model.CostParams(r_cloud=10.0, n_total=cfg.n_total_iterations,
                                 n_step=cfg.split_stride, t_lim=5.0)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        engine.DiffusionSplitEngine(params, cfg, cost)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        engine.DiffusionDeviceSim(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        serve.main(["--requests", "1"])


@pytest.mark.parametrize("extra", [[], ["--wire", "int8", "--wan"],
                                   ["--int8-transport"]])
def test_launcher_runs_on_the_cpu(capsys, extra):
    serve.main(["--requests", "4", "--device", "cpu", *extra])
    out = capsys.readouterr().out
    assert "engine stats" in out and "dev3" in out
