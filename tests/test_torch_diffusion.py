"""Port parity: the diffusion model.  Parameters are initialised by the
reference and converted; inputs are drawn with numpy and handed to both
sides.  Both sides compute in fp32 and differ in summation order only;
each tolerance is stated with the largest difference seen when the test
was written (values of order 1 unless noted)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import stable_diffusion_v1 as ref_configs
from repro.models import diffusion as ref_dif
from repro.models import regnet as ref_regnet
from repro_torch.configs import stable_diffusion_v1 as configs
from repro_torch.convert import from_jax_params
from repro_torch.models import diffusion as dif
from repro_torch.models import regnet

# The models here are tiny: one thread each, or the test workers that
# share a machine fight over cores inside PyTorch's thread pool.
torch.set_num_threads(1)

B = 2


@pytest.fixture(scope="module")
def world():
    cfg = configs.reduced()
    ref_cfg = ref_configs.reduced()
    ref_params = ref_dif.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = from_jax_params(
        jax.tree_util.tree_map(np.asarray, ref_params), "cpu")
    rng = np.random.default_rng(0)
    cond = rng.integers(0, cfg.text_vocab, (B, cfg.text_len)).astype(np.int32)
    uncond = rng.integers(0, cfg.text_vocab,
                          (B, cfg.text_len)).astype(np.int32)
    latent = rng.standard_normal(
        (B, cfg.latent_channels, cfg.latent_size, cfg.latent_size)
    ).astype(np.float32)
    ref_ctx2 = ref_dif.encode_prompt(ref_params, ref_cfg, jnp.asarray(cond),
                                     jnp.asarray(uncond))
    with torch.inference_mode():
        ctx2 = dif.encode_prompt(params, cfg, torch.from_numpy(cond),
                                 torch.from_numpy(uncond))
    return dict(cfg=cfg, ref_cfg=ref_cfg, params=params,
                ref_params=ref_params, cond=cond, uncond=uncond,
                latent=latent, ctx2=ctx2, ref_ctx2=ref_ctx2)


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


def test_configs_are_the_same():
    import dataclasses
    assert dataclasses.asdict(configs.CONFIG) == dataclasses.asdict(
        ref_configs.CONFIG)
    assert dataclasses.asdict(configs.reduced()) == dataclasses.asdict(
        ref_configs.reduced())


def test_encode_prompt(world):
    assert tuple(world["ctx2"].shape) == (2, B, world["cfg"].text_len,
                                          world["cfg"].text_width)
    # observed 1.7e-6
    _close(world["ctx2"], world["ref_ctx2"], atol=2e-5, rtol=1e-5)


def test_apply_unet(world):
    t = np.full((B,), 555, np.int32)
    want = ref_dif.apply_unet(world["ref_params"]["unet"], world["ref_cfg"],
                              jnp.asarray(world["latent"]), jnp.asarray(t),
                              world["ref_ctx2"][1])
    with torch.inference_mode():
        got = dif.apply_unet(world["params"]["unet"], world["cfg"],
                             torch.from_numpy(world["latent"]),
                             torch.from_numpy(t), world["ctx2"][1])
    _close(got, want, atol=2e-5, rtol=1e-5)        # observed 1.9e-6


@pytest.mark.parametrize("step", [0, 3, 9])
def test_denoise_step(world, step):
    """Step 9 is the last one: a_prev is 1 there."""
    want = ref_dif.denoise_step(world["ref_params"], world["ref_cfg"],
                                jnp.asarray(world["latent"]),
                                world["ref_ctx2"], step)
    with torch.inference_mode():
        got = dif.denoise_step(world["params"], world["cfg"],
                               torch.from_numpy(world["latent"]),
                               world["ctx2"], step)
    # observed 1.5e-5 on values up to 9 (guidance 7.5 scales the noise)
    _close(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("start,stop", [(0, 0), (0, 2), (0, 4), (0, 10),
                                        (4, 10)])
def test_denoise_range(world, start, stop):
    want = ref_dif.denoise_range(world["ref_params"], world["ref_cfg"],
                                 jnp.asarray(world["latent"]),
                                 world["ref_ctx2"], start, stop)
    with torch.inference_mode():
        got = dif.denoise_range(world["params"], world["cfg"],
                                torch.from_numpy(world["latent"]),
                                world["ctx2"], start, stop)
    # the error compounds over steps with guidance 7.5: observed 2.9e-4
    # after ten steps, on values up to 120
    _close(got, want, atol=5e-4)


def test_apply_vae_decoder(world):
    want = ref_dif.apply_vae_decoder(world["ref_params"]["vae"],
                                     world["ref_cfg"],
                                     jnp.asarray(world["latent"]))
    with torch.inference_mode():
        got = dif.apply_vae_decoder(world["params"]["vae"], world["cfg"],
                                    torch.from_numpy(world["latent"]))
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, atol=1e-4)                   # observed 1.1e-6


@pytest.mark.parametrize("cfg_name", ["reduced", "full"])
def test_ddim_alphas(cfg_name):
    cfg = configs.reduced() if cfg_name == "reduced" else configs.CONFIG
    want_a, want_i = ref_dif.ddim_alphas(cfg)
    got_a, got_i = dif.ddim_alphas(cfg)
    assert got_i.dtype == np.int32 and got_a.dtype == np.float32
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    # The reference's fp32 scan over 1000 factors carries its own rounding:
    # it lies 1.1e-6 (relative) from the product taken in float64, which
    # is what the port rounds to fp32.
    np.testing.assert_allclose(got_a, np.asarray(want_a), rtol=2e-6)


@pytest.mark.parametrize("n", [2, 7, 10, 20, 50, 100])
def test_schedule_indices_for_other_step_counts(n):
    """The truncated indices hang on fp32 rounding (n=10 gives 665, not
    666): equal to the reference's for every count, not just the config's."""
    import dataclasses
    cfg = dataclasses.replace(configs.reduced(), n_total_iterations=n)
    np.testing.assert_array_equal(dif.ddim_alphas(cfg)[1],
                                  np.asarray(ref_dif.ddim_alphas(cfg)[1]))


def test_split_payload():
    for cfg, ref_cfg in ((configs.reduced(), ref_configs.reduced()),
                         (configs.CONFIG, ref_configs.CONFIG)):
        for batch in (1, 3):
            assert dif.split_payload(cfg, batch) == ref_dif.split_payload(
                ref_cfg, batch)
    table2 = dict(dif.split_payload(configs.CONFIG))
    assert table2["denoising0"] == 236_544           # context fp16
    assert table2["denoising50"] == 65_536           # latent fp32
    assert table2["denoising25"] == 236_544 + 65_536


def test_generate_runs_and_is_seeded(world):
    cfg, params = world["cfg"], world["params"]
    cond = torch.from_numpy(world["cond"][:1])
    uncond = torch.from_numpy(world["uncond"][:1])
    a = dif.generate(params, cfg, cond, uncond,
                     torch.Generator().manual_seed(3))
    b = dif.generate(params, cfg, cond, uncond,
                     torch.Generator().manual_seed(3))
    assert a.shape[:2] == (1, 3) and bool(torch.isfinite(a).all())
    assert torch.equal(a, b) and float(a.abs().max()) <= 1.0


# -- pins for the places where the two frameworks' defaults differ ---------
@pytest.mark.parametrize("size,stride,k", [(8, 2, 3), (7, 2, 3), (9, 2, 3),
                                           (8, 1, 3), (7, 1, 1), (6, 2, 1)])
def test_conv2d_same_padding(size, stride, k):
    """stride 2 on an even input pads low 0 / high 1."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, size, size + 2)).astype(np.float32)
    w = rng.standard_normal((5, 3, k, k)).astype(np.float32)
    want = ref_regnet.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride)
    got = regnet.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                        stride=stride)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, atol=1e-5)                   # observed 1.9e-6


@pytest.mark.parametrize("channels", [48, 20, 7, 64])
def test_group_norm_picks_the_same_groups(channels):
    """48 -> 24 groups, 20 -> 20, 7 -> 7, 64 -> 32."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, channels, 4, 5)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(channels).astype(np.float32)
    bias = rng.standard_normal(channels).astype(np.float32)
    want = ref_dif.gn({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                      jnp.asarray(x))
    got = dif.gn({"scale": torch.from_numpy(scale),
                  "bias": torch.from_numpy(bias)}, torch.from_numpy(x))
    _close(got, want, atol=1e-5)                   # observed 9.5e-7


def test_layer_norm_and_gelu_and_timestep_embedding():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32) * 2
    p = {"scale": rng.standard_normal(24).astype(np.float32),
         "bias": rng.standard_normal(24).astype(np.float32)}
    _close(dif.ln({k: torch.from_numpy(v) for k, v in p.items()},
                  torch.from_numpy(x)),
           ref_dif.ln({k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(x)), atol=1e-5)
    _close(dif.gelu(torch.from_numpy(x)), jax.nn.gelu(jnp.asarray(x)),
           atol=1e-6)
    t = np.array([999, 665, 0], np.int32)
    _close(dif._timestep_embedding(torch.from_numpy(t), 32),
           ref_dif._timestep_embedding(jnp.asarray(t), 32), atol=2e-4)


def test_nearest_resize_doubles_each_pixel():
    x = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    want = jax.image.resize(jnp.asarray(x), (2, 3, 8, 10), "nearest")
    got = dif.upsample2x(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_causal_attention_matches(world):
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 6, 16)).astype(np.float32)
               for _ in range(3))
    for causal in (False, True):
        want = ref_dif._mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            4, causal=causal)
        got = dif._mha(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), 4, causal=causal)
        _close(got, want, atol=1e-5)
