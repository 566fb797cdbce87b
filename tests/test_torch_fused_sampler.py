"""Port parity: the plain version of dpfx_torch.ops.fused_sampler against
the JAX package's Pallas kernels, run in interpret mode on the CPU, on the
same numpy-seeded weights, noise and latents."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dpfx.config import config_from_dict as jax_config_from_dict  # noqa: E402
from dpfx.models import DPF as JaxDPF  # noqa: E402
from dpfx.ops import fused_sampler as jfs  # noqa: E402
from dpfx_torch.compat import params_to_flax, randomize_  # noqa: E402
from dpfx_torch.config import config_from_dict  # noqa: E402
from dpfx_torch.models import DPF  # noqa: E402
from dpfx_torch.ops import fused_sampler as tfs  # noqa: E402


def tiny(n_hidden=2, activation="relu"):
    return {"experiment": "gen", "model": {
        "dz": 16,
        "point_flow": {"n_layers": 4, "hidden": 32, "n_hidden": n_hidden,
                       "activation": activation, "scale_cap": 3.0},
        "latent_flow": {"n_layers": 4, "hidden": 32, "n_hidden": 2},
        "encoder": {"point_widths": [32, 64], "head_widths": [32]}}}


def _models(n_hidden=2, activation="relu", seed=0):
    model = randomize_(DPF(config_from_dict(tiny(n_hidden, activation))), seed, 0.15)
    params = params_to_flax(model.state_dict())
    jparams = {"params": {k: {kk: vv for kk, vv in v.items()} for k, v in params["params"].items()}}
    return model, jparams


def _stack(model):
    """The stacked point-flow weights outside autograd, as the samplers take them."""
    with torch.no_grad():
        return tfs.stack_point_flow_params(model.point_flow)


def _inputs(b, n, dz=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n, 3)).astype(np.float32),
            rng.normal(size=(b, dz)).astype(np.float32))


@pytest.mark.parametrize("n_hidden", [1, 2, 3])
def test_stack_matches_jax(n_hidden):
    """The port stacks unpadded [K, H, 3] / [K, 6, H] blocks where the
    Pallas kernel pads to 8 rows; the shared entries are equal and the
    JAX padding is zero."""
    model, params = _models(n_hidden)
    sp = _stack(model)
    jp = jfs.stack_point_flow_params(params, 3.0)
    eq = lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    eq(sp.wx, jp.wx[..., :3])
    eq(sp.wz, jp.wz)
    eq(sp.bx, jp.bx)
    eq(sp.wh, jp.wh)
    eq(sp.bh, jp.bh[..., 0])
    eq(sp.wout, jp.wout[:, :6])
    eq(sp.bout, jp.bout[:, :6, 0])
    eq(sp.masks, jp.masks[:, :3, 0])
    assert not np.asarray(jp.wx[..., 3:]).any() and not np.asarray(jp.wout[:, 6:]).any()
    assert sp.scale_cap == jp.scale_cap


def _jax_inverse(params, u, z, dtype, activation="relu", tile=128):
    jp = jfs.stack_point_flow_params(params, 3.0)
    return np.asarray(jfs.fused_point_flow_inverse(
        jp, jnp.asarray(u), jnp.asarray(z), tile=tile, dtype=dtype, activation=activation))


@pytest.mark.parametrize("n_hidden,activation", [
    (2, "relu"), (1, "relu"), (3, "gelu"), (2, "tanh"), (2, "leaky_relu")])
def test_inverse_matches_pallas_f32(n_hidden, activation):
    model, params = _models(n_hidden, activation, seed=n_hidden)
    u, z = _inputs(3, 128, seed=1)
    sp = _stack(model)
    x = tfs.fused_point_flow_inverse(sp, torch.from_numpy(u), torch.from_numpy(z),
                                     dtype=torch.float32, activation=activation)
    ref = _jax_inverse(params, u, z, jnp.float32, activation)
    np.testing.assert_allclose(x.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_inverse_matches_pallas_bf16():
    """Both sides round operands to bf16 and sum in f32, so they differ only
    by summation order; a flipped bf16 rounding moves a value by one bf16
    ulp (~4e-3 relative) and 4 layers carry it on. Stated tolerance:
    max abs 2e-2 and 99% of coordinates within 2e-3."""
    model, params = _models(2, "relu", seed=5)
    u, z = _inputs(2, 256, seed=2)
    sp = _stack(model)
    x = tfs.fused_point_flow_inverse(sp, torch.from_numpy(u), torch.from_numpy(z),
                                     dtype=torch.bfloat16).numpy()
    ref = _jax_inverse(params, u, z, jnp.bfloat16)
    err = np.abs(x - ref)
    assert err.max() < 2e-2, err.max()
    assert np.quantile(err, 0.99) < 2e-3, np.quantile(err, 0.99)


def test_ragged_n_and_prefix_invariance():
    """N=200 is not a multiple of any tile: the JAX kernel pads to 256; the
    port's points are independent of how many others share the call."""
    model, params = _models(2, "relu", seed=7)
    u, z = _inputs(2, 200, seed=3)
    sp = _stack(model)
    tu, tz = torch.from_numpy(u), torch.from_numpy(z)
    x = tfs.fused_point_flow_inverse(sp, tu, tz, dtype=torch.float32).numpy()
    np.testing.assert_allclose(x, _jax_inverse(params, u, z, jnp.float32), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(x, _jax_inverse(params, u, z, jnp.float32, tile=256),
                               atol=1e-5, rtol=1e-5)
    head = tfs.fused_point_flow_inverse(sp, tu[:, :77], tz, dtype=torch.float32).numpy()
    np.testing.assert_allclose(head, x[:, :77], atol=1e-6, rtol=1e-6)


def test_transposed_eight_rows_pass_through():
    """ut [B, 8, N] as the JAX package lays it out: rows 3-7 pass through."""
    model, params = _models(2, "relu", seed=8)
    u, z = _inputs(2, 128, seed=4)
    rng = np.random.default_rng(9)
    ut = np.zeros((2, 8, 128), np.float32)
    ut[:, :3] = u.transpose(0, 2, 1)
    ut[:, 3:] = rng.normal(size=(2, 5, 128))
    sp = _stack(model)
    out = tfs.fused_inverse_transposed(sp, torch.from_numpy(ut), torch.from_numpy(z),
                                       dtype=torch.float32).numpy()
    ref = _jax_inverse(params, u, z, jnp.float32)
    np.testing.assert_allclose(out[:, :3].transpose(0, 2, 1), ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(out[:, 3:], ut[:, 3:])


def test_cpu_path_launches_no_kernel():
    model, _ = _models()
    sp = _stack(model)
    tfs.reset_launch_counts()
    u, z = _inputs(1, 16)
    tfs.fused_point_flow_inverse(sp, torch.from_numpy(u), torch.from_numpy(z))
    tfs.fused_sample_points(sp, torch.from_numpy(z), 3, 16)
    assert tfs.launches == {"fused_inverse": 0, "fused_sample": 0, "fused_sample_int8": 0}


@pytest.mark.parametrize("tau", [1.0, 1.1])
def test_sample_points_noise_and_seed(tau):
    """CPU path of the sampler: u ~ tau N(0, I3) from the seed, then the
    plain inverse of exactly that u; the same seed gives the same clouds."""
    model, _ = _models(seed=11)
    sp = _stack(model)
    z = torch.from_numpy(_inputs(4, 1, seed=5)[1])
    x, u = tfs.fused_sample_points(sp, z, 123, 4096, dtype=torch.float32, noise_scale=tau,
                                   return_noise=True)
    assert x.shape == u.shape == (4, 4096, 3)
    assert abs(float(u.mean())) < 0.02
    assert abs(float(u.var()) / tau**2 - 1.0) < 0.03
    again = tfs.fused_sample_points(sp, z, 123, 4096, dtype=torch.float32, noise_scale=tau)
    torch.testing.assert_close(x, again, rtol=0, atol=0)
    ref = tfs.fused_point_flow_inverse(sp, u, z, dtype=torch.float32)
    torch.testing.assert_close(x, ref, rtol=1e-6, atol=1e-6)


def test_kernel_argument_checks():
    model, _ = _models()
    sp = _stack(model)
    with pytest.raises(ValueError, match="hidden"):
        tfs._check_kernel_args(sp._replace(wx=torch.zeros(4, 48, 3)), torch.zeros(1, 4, 48),
                               torch.bfloat16, "relu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfs._check_kernel_args(sp, torch.zeros(1, 4, 32), torch.bfloat16, "relu")
    assert tfs.smem_bytes(128, torch.bfloat16) <= tfs.SMEM_LIMIT
    assert tfs.smem_bytes(256, torch.float32) > tfs.SMEM_LIMIT


def test_jax_side_config_is_the_same_yaml_schema():
    """The port's copy of the config schema reads the same dicts."""
    d = tiny()
    a, b = config_from_dict(d), jax_config_from_dict(d)
    assert a.model.point_flow.__dict__ == b.model.point_flow.__dict__
    assert JaxDPF(b).config.model.dz == a.model.dz
