"""The point flow's forward followed by its inverse recovers the cloud, in
the port's plain versions (dpfx_torch.ops.fused_train.fused_forward_plain,
then dpfx_torch.ops.fused_sampler.fused_inverse_transposed_plain) and in
dpfx's (the fused training forward and the fused inverse, Pallas kernels in
interpret mode on the CPU), on the same numpy-seeded weights, clouds and
latents, at K=4, H=32.

Both directions compute each layer's conditioner from the passthrough
coordinates, which the forward leaves untouched, so they see the same
(s, t) and x comes back up to the f32 rounding of the affine update:
median error <= 1e-5. In bf16 a coordinate that the inverse recovers a few
ulps off can round to the other side of a bf16 boundary at a later layer's
input and carry a bf16-sized difference on; the largest error is held to
the sampler's bf16 limit (chip_smoke.py's TOL_BF16_MAX, 5e-2). f32 has no
such step: every error is within 1e-4 (TOL_F32)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dpfx.ops import fused_sampler as jfs  # noqa: E402
from dpfx.ops import fused_train as jft  # noqa: E402
from dpfx_torch.compat import params_to_flax, randomize_  # noqa: E402
from dpfx_torch.config import config_from_dict  # noqa: E402
from dpfx_torch.models import DPF  # noqa: E402
from dpfx_torch.ops import fused_sampler as tfs  # noqa: E402
from dpfx_torch.ops import fused_train as tft  # noqa: E402

K, H, DZ, CAP = 4, 32, 16, 3.0
TOL_MEDIAN, TOL_BF16_MAX, TOL_F32 = 1e-5, 5e-2, 1e-4


def tiny(n_hidden):
    return {"experiment": "gen", "model": {
        "dz": DZ,
        "point_flow": {"n_layers": K, "hidden": H, "n_hidden": n_hidden, "scale_cap": CAP},
        "latent_flow": {"n_layers": 4, "hidden": 32, "n_hidden": 2},
        "encoder": {"point_widths": [32, 64], "head_widths": [32]}}}


def setup(n_hidden, n, b=3, seed=0):
    # the modules' own init draws from torch's global generator: seed it
    torch.manual_seed(seed)
    model = randomize_(DPF(config_from_dict(tiny(n_hidden))), seed, 0.15)
    with torch.no_grad():
        sp = tfs.stack_point_flow_params(model.point_flow)
    params = jax_params(model)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 3)).astype(np.float32)
    z = rng.normal(size=(b, DZ)).astype(np.float32)
    return sp, params, x, z


def jax_params(model):
    params = params_to_flax(model.state_dict())
    return {"params": {k: dict(v) for k, v in params["params"].items()}}


def port_round_trip(sp, x, z, dtype):
    xt = torch.from_numpy(x).transpose(1, 2).contiguous()
    hz = tfs.z_projection(sp, torch.from_numpy(z))
    u, _ = tft.fused_forward_plain(sp.wx, sp.wh, sp.bh, sp.wout, sp.bout, sp.masks, sp.scale_cap,
                                   xt, hz, dtype)
    back = tfs.fused_inverse_transposed_plain(sp, u, hz, dtype)
    return back.transpose(1, 2).numpy()


def dpfx_round_trip(params, x, z, n_hidden, dtype):
    b, n, _ = x.shape
    w = jft.stack_point_flow_params_jnp(params, K)
    hz = (jnp.einsum("bd,kdh->bkh", jnp.asarray(z), w["wz"]) + w["bx"])[..., None]
    tile = 128
    n_pad = -(-n // tile) * tile
    xt = jnp.zeros((b, 8, n_pad), jnp.float32).at[:, :3, :n].set(jnp.swapaxes(jnp.asarray(x), 1, 2))
    static = (K, H, n_hidden - 1, CAP, jnp.dtype(dtype).name, n, tile)
    u, _ = jft._fused_forward(static, {k: w[k] for k in ("wx", "wh", "bh", "wout", "bout")}, xt, hz)
    jp = jfs.stack_point_flow_params(params, CAP)
    return np.asarray(jfs.fused_point_flow_inverse(jp, jnp.swapaxes(u[:, :3, :n], 1, 2),
                                                   jnp.asarray(z), tile=tile, dtype=dtype))


def held(back, x, dtype):
    e = np.abs(back - x)
    assert np.isfinite(back).all()
    assert float(np.median(e)) <= TOL_MEDIAN, float(np.median(e))
    assert float(e.max()) <= (TOL_F32 if dtype == "float32" else TOL_BF16_MAX), float(e.max())


@pytest.mark.parametrize("n_hidden,n", [(2, 200), (1, 130), (3, 77)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_round_trip_recovers_the_cloud(n_hidden, n, dtype):
    sp, params, x, z = setup(n_hidden, n)
    tdt = getattr(torch, dtype)
    port = port_round_trip(sp, x, z, tdt)
    held(port, x, dtype)
    ref = dpfx_round_trip(params, x, z, n_hidden, getattr(jnp, dtype))
    held(ref, x, dtype)
    # the two round trips agree with each other as each agrees with x
    held(port, ref, dtype)
