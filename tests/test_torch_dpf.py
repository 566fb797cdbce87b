"""Port parity for the sampling slice as a whole: dpfx_torch's DPF against
the JAX package's DPF (flax modules + the Pallas fused inverse in interpret
mode) on the same numpy-seeded weights, noise and inputs (f32 at 1e-5)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dpfx.config import config_from_dict as jax_config  # noqa: E402
from dpfx.models import DPF as JaxDPF  # noqa: E402
from dpfx.ops import fused_sampler as jfs  # noqa: E402
from dpfx_torch.compat import params_from_flax, params_to_flax, randomize_  # noqa: E402
from dpfx_torch.config import config_from_dict  # noqa: E402
from dpfx_torch.models import DPF  # noqa: E402
from dpfx_torch.sampling import make_decoder, make_sampler  # noqa: E402

CFG = {"experiment": "gen", "model": {
    "dz": 16,
    "point_flow": {"n_layers": 4, "hidden": 32, "n_hidden": 2, "scale_cap": 3.0},
    "latent_flow": {"n_layers": 4, "hidden": 32, "n_hidden": 2, "scale_cap": 3.0},
    "encoder": {"point_widths": [32, 64], "head_widths": [32]}}}


def _cfg(**point_flow):
    d = {**CFG, "model": {**CFG["model"], "point_flow": {**CFG["model"]["point_flow"], **point_flow}}}
    return d


@pytest.fixture(scope="module")
def pair():
    model = randomize_(DPF(config_from_dict(CFG)), seed=0, scale=0.15).eval()
    params = jax.tree.map(jnp.asarray, params_to_flax(model.state_dict()))
    return model, JaxDPF(jax_config(CFG)), params


def _blobs(b, n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(b, 1, 3))
    return (centers + 0.3 * rng.normal(size=(b, n, 3))).astype(np.float32)


def _jax_point_inverse(jmodel, params, u, z, dtype=jnp.float32):
    sp = jfs.stack_point_flow_params(params, jmodel.config.model.point_flow.scale_cap)
    return np.asarray(jfs.fused_point_flow_inverse(sp, jnp.asarray(u), jnp.asarray(z),
                                                   tile=128, dtype=dtype))


@pytest.mark.parametrize("temperature,latent_temperature", [(1.0, 1.0), (0.8, 1.1)])
def test_sample_matches_jax(pair, temperature, latent_temperature):
    model, jmodel, params = pair
    rng = np.random.default_rng(1)
    eps = rng.normal(size=(3, 16)).astype(np.float32)
    u = rng.normal(size=(3, 150, 3)).astype(np.float32)
    x = model.sample(3, 150, eps=torch.from_numpy(eps), u=torch.from_numpy(u),
                     temperature=temperature, latent_temperature=latent_temperature)
    z, _ = jmodel.apply(params, jnp.asarray(eps * latent_temperature),
                        method=lambda m, e: m.latent_flow.inverse(e))
    ref = _jax_point_inverse(jmodel, params, u * temperature, z)
    assert x.shape == (3, 150, 3)
    np.testing.assert_allclose(x.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_encode_matches_jax_with_logvar_clip(pair):
    model, jmodel, params = pair
    x = _blobs(4, 64, seed=2)
    # push some logvar entries past +-10 so the clip is exercised
    big = {k: v for k, v in model.state_dict().items()}
    bias = big["encoder.gauss.bias"].clone()
    bias[16:20] = 30.0
    bias[20:24] = -30.0
    big["encoder.gauss.bias"] = bias
    m2 = DPF(config_from_dict(CFG))
    m2.load_state_dict(big)
    p2 = jax.tree.map(jnp.asarray, params_to_flax(big))
    with torch.no_grad():
        mu, lv = m2.encode(torch.from_numpy(x))
    mu_j, lv_j = jmodel.apply(p2, jnp.asarray(x), method=lambda m, a: m.encode(a))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lv.numpy(), np.asarray(lv_j), atol=1e-5, rtol=1e-5)
    assert float(lv.max()) == 10.0 and float(lv.min()) == -10.0


def test_reconstruct_matches_jax(pair):
    model, jmodel, params = pair
    x = _blobs(2, 96, seed=3)
    u = np.random.default_rng(4).normal(size=(2, 96, 3)).astype(np.float32)
    rec = model.reconstruct(torch.from_numpy(x), u=torch.from_numpy(u), use_mean=True)
    mu, _ = jmodel.apply(params, jnp.asarray(x), method=lambda m, a: m.encode(a))
    ref = _jax_point_inverse(jmodel, params, u, mu)
    np.testing.assert_allclose(rec.numpy(), ref, atol=1e-5, rtol=1e-5)
    # the flax module path agrees too (f32: same math, other layout)
    ref_flax, _ = jmodel.apply(params, jnp.asarray(u), mu,
                               method=lambda m, a, b: m.point_flow.inverse(a, b))
    np.testing.assert_allclose(rec.numpy(), np.asarray(ref_flax), atol=1e-5, rtol=1e-5)


def test_elbo_matches_jax(pair):
    model, jmodel, params = pair
    x = _blobs(2, 48, seed=5)
    eps = np.random.default_rng(6).normal(size=(2, 16)).astype(np.float32)
    with torch.no_grad():
        t = model.elbo_terms(torch.from_numpy(x), torch.from_numpy(eps))
        lp = model.log_prob(torch.from_numpy(x), torch.from_numpy(eps))
    j = jmodel.apply(params, jnp.asarray(x), jax.random.PRNGKey(0), eps=jnp.asarray(eps),
                     method=jmodel.elbo_terms)
    for k in ("recon_ll", "logp_z", "logq", "z"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(j["recon_ll"] + j["logp_z"] - j["logq"]),
                               atol=1e-4, rtol=1e-5)


def test_bridge_roundtrip_from_flax_init():
    """A real flax init tree -> the port's state dict (loads strictly) ->
    back to the identical tree."""
    jmodel = JaxDPF(jax_config(CFG))
    rng = jax.random.PRNGKey(0)
    tree = jax.tree.map(np.asarray, jmodel.init(rng, jnp.zeros((2, 16, 3)), rng))
    sd = params_from_flax(tree)
    DPF(config_from_dict(CFG)).load_state_dict(sd, strict=True)
    back = params_to_flax(sd)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_bf16_sample_close_to_jax():
    """bf16 point flow (the flagship's compute dtype): the port's plain
    version against the Pallas kernel in interpret mode; both round operands
    to bf16 and sum in f32. Stated tolerance: max abs 2e-2, 99% within 2e-3."""
    cfg = _cfg(compute_dtype="bfloat16")
    model = randomize_(DPF(config_from_dict(cfg)), seed=3, scale=0.15)
    params = jax.tree.map(jnp.asarray, params_to_flax(model.state_dict()))
    jmodel = JaxDPF(jax_config(cfg))
    rng = np.random.default_rng(7)
    eps = rng.normal(size=(2, 16)).astype(np.float32)
    u = rng.normal(size=(2, 128, 3)).astype(np.float32)
    x = model.sample(2, 128, eps=torch.from_numpy(eps), u=torch.from_numpy(u)).numpy()
    z, _ = jmodel.apply(params, jnp.asarray(eps), method=lambda m, e: m.latent_flow.inverse(e))
    err = np.abs(x - _jax_point_inverse(jmodel, params, u, z, jnp.bfloat16))
    assert err.max() < 2e-2 and np.quantile(err, 0.99) < 2e-3, (err.max(), np.quantile(err, 0.99))


def test_samplers_on_cpu(pair):
    model, _, _ = pair
    sampler = make_sampler(model, 3, 70, temperature=0.9, latent_temperature=1.1)
    a, b = sampler(5), sampler(5)
    assert a.shape == (3, 70, 3) and torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, sampler(6))
    dec = make_decoder(model, 40)
    assert dec(torch.zeros(2, 16), 0).shape == (2, 40, 3)


def test_actnorm_takes_the_module_path():
    cfg = _cfg(use_actnorm=True)
    model = randomize_(DPF(config_from_dict(cfg)), seed=4, scale=0.15)
    params = jax.tree.map(jnp.asarray, params_to_flax(model.state_dict()))
    jmodel = JaxDPF(jax_config(cfg))
    rng = np.random.default_rng(8)
    z = rng.normal(size=(2, 16)).astype(np.float32)
    u = rng.normal(size=(2, 50, 3)).astype(np.float32)
    x = model.decode(torch.from_numpy(z), 50, u=torch.from_numpy(u))
    ref, _ = jmodel.apply(params, jnp.asarray(u), jnp.asarray(z),
                          method=lambda m, a, b: m.point_flow.inverse(a, b))
    np.testing.assert_allclose(x.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    assert make_sampler(model, 2, 30)(0).shape == (2, 30, 3)
