"""The int8 mode of the port's fused sampler (dpfx_torch.ops.fused_sampler
``quantize_flow_params``, ``dequantize``, ``fused_sample_points(quantized=)``)
against dpfx's on the CPU, on the same numpy-seeded weights.

dpfx's interpret path ignores ``quantized`` (it runs the plain inverse), so
the parity surface is the inverse on the host-dequantized stacks with an
explicit u: the card's int8 kernel equals, bit for bit, its compute-dtype
mode on those stacks (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: the int8 values and the scales are equal (the same f32
division and round half to even); the inverse on the dequantized stacks as
tests/test_torch_fused_sampler.py holds the unquantized one: f32 rtol and
atol 1e-5, bf16 max abs 2e-2 with 99% of coordinates within 2e-3."""

import importlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dpfx_torch.compat import params_to_flax, randomize_  # noqa: E402
from dpfx_torch.config import config_from_dict  # noqa: E402
from dpfx_torch.models import DPF  # noqa: E402
from dpfx_torch.ops import fused_sampler as tfs  # noqa: E402

jfs = importlib.import_module("dpfx.ops.fused_sampler")


def tiny(n_hidden=2):
    return {"experiment": "gen", "model": {
        "dz": 16,
        "point_flow": {"n_layers": 4, "hidden": 32, "n_hidden": n_hidden, "scale_cap": 3.0},
        "latent_flow": {"n_layers": 4, "hidden": 32, "n_hidden": 2},
        "encoder": {"point_widths": [32, 64], "head_widths": [32]}}}


def _both(n_hidden=2, seed=0):
    """The stacked weights of one random model in both packages."""
    torch.manual_seed(seed)        # the modules' own init
    model = randomize_(DPF(config_from_dict(tiny(n_hidden))), seed, 0.15)
    with torch.no_grad():
        sp = tfs.stack_point_flow_params(model.point_flow)
    return sp, jfs.stack_point_flow_params(params_to_flax(model.state_dict()), 3.0)


def _jax_dequantized(jq):
    """dpfx's int8 stacks times their scales, in f32 (its kernel's
    ``wq.astype(f32) * scale`` before the cast to the compute dtype)."""
    s = np.asarray(jq.scales)
    deq = lambda w, c: jnp.asarray(np.asarray(w).astype(np.float32)
                                   * s[:, c].reshape(-1, *([1] * (w.ndim - 1))))
    return jq.sp._replace(wx=deq(jq.sp.wx, 0), wh=deq(jq.sp.wh, 1), wout=deq(jq.sp.wout, 2))


@pytest.mark.parametrize("n_hidden", [1, 2, 3])
def test_quantize_matches_dpfx(n_hidden):
    """Equal int8 values (the port's stacks are dpfx's without its zero
    padding of wx to 8 columns and wout to 8 rows) and equal scales."""
    sp, jp = _both(n_hidden, seed=n_hidden)
    q, jq = tfs.quantize_flow_params(sp), jfs.quantize_flow_params(jp)
    eq = lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert q.sp.wx.dtype == q.sp.wh.dtype == q.sp.wout.dtype == torch.int8
    eq(q.sp.wx, jq.sp.wx[..., :3])
    eq(q.sp.wh, jq.sp.wh)
    eq(q.sp.wout, jq.sp.wout[:, :6])
    eq(q.scales, jq.scales)
    assert not np.asarray(jq.sp.wx[..., 3:]).any() and not np.asarray(jq.sp.wout[:, 6:]).any()
    for name in ("wz", "bx", "bh", "bout", "masks"):
        assert torch.equal(getattr(q.sp, name), getattr(sp, name))
    if n_hidden == 1:
        assert bool((q.scales[:, 1] == 1.0).all())
    assert int(q.sp.wx.abs().max()) == 127 and int(q.sp.wout.abs().max()) == 127


def test_dequantize_is_q_times_scale():
    sp, _ = _both(2, seed=4)
    q = tfs.quantize_flow_params(sp)
    dq = tfs.dequantize(q)
    for name, c in (("wx", 0), ("wh", 1), ("wout", 2)):
        w = getattr(dq, name)
        assert w.dtype == torch.float32 and w.is_contiguous()
        ref = getattr(q.sp, name).float() * q.scales[:, c].view(-1, *([1] * (w.dim() - 1)))
        assert torch.equal(w, ref)
        # the quantization error is at most half a step of its tensor's scale
        step = q.scales[:, c].view(-1, *([1] * (w.dim() - 1)))
        assert bool(((w - getattr(sp, name)).abs() <= 0.5 * step * (1 + 1e-6)).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantized_inverse_matches_pallas(dtype):
    """The plain inverse on the port's dequantized stacks against dpfx's
    Pallas inverse (interpret mode) on dpfx's, with one explicit u."""
    sp, jp = _both(2, seed=6)
    q, jq = tfs.quantize_flow_params(sp), jfs.quantize_flow_params(jp)
    dq = tfs.dequantize(q)
    dsp = sp._replace(wx=dq.wx, wh=dq.wh, wout=dq.wout)
    rng = np.random.default_rng(7)
    u = rng.normal(size=(3, 160, 3)).astype(np.float32)
    z = rng.normal(size=(3, 16)).astype(np.float32)
    x = tfs.fused_point_flow_inverse(dsp, torch.from_numpy(u), torch.from_numpy(z),
                                     dtype=getattr(torch, dtype)).numpy()
    ref = np.asarray(jfs.fused_point_flow_inverse(_jax_dequantized(jq), jnp.asarray(u),
                                                  jnp.asarray(z), tile=128,
                                                  dtype=getattr(jnp, dtype)))
    if dtype == "float32":
        np.testing.assert_allclose(x, ref, rtol=1e-5, atol=1e-5)
    else:
        err = np.abs(x - ref)
        assert err.max() < 2e-2 and np.quantile(err, 0.99) < 2e-3, (err.max(), np.quantile(err, 0.99))


def test_sample_points_quantized_cpu_path():
    """On the CPU, fused_sample_points(quantized=q) is the plain sampler on
    the dequantized stacks (same seed, same noise) and launches nothing;
    its clouds part from the unquantized ones exactly as far as dpfx's do
    on the same weights and noise (its int8 stacks against its own, the
    Pallas inverse in interpret mode). A random flow at scale 0.15 is far
    from a trained one: on many such draws the int8 error exceeds 2% in
    both packages (dpfx documents ~0.3% for its flagship)."""
    sp, jp = _both(2, seed=8)
    q = tfs.quantize_flow_params(sp)
    dq = tfs.dequantize(q)
    z = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 16)).astype(np.float32))
    tfs.reset_launch_counts()
    x, u = tfs.fused_sample_points(sp, z, 5, 256, dtype=torch.float32, quantized=q,
                                   return_noise=True)
    xd, ud = tfs.fused_sample_points(sp._replace(wx=dq.wx, wh=dq.wh, wout=dq.wout), z, 5, 256,
                                     dtype=torch.float32, return_noise=True)
    assert torch.equal(x, xd) and torch.equal(u, ud)
    assert tfs.launches == {"fused_inverse": 0, "fused_sample": 0, "fused_sample_int8": 0}
    full = tfs.fused_sample_points(sp, z, 5, 256, dtype=torch.float32)
    rms = float((x - full).pow(2).mean().sqrt() / full.pow(2).mean().sqrt())
    uj, zj = jnp.asarray(u.numpy()), jnp.asarray(z.numpy())
    xj = np.asarray(jfs.fused_point_flow_inverse(_jax_dequantized(jfs.quantize_flow_params(jp)),
                                                 uj, zj, tile=128, dtype=jnp.float32))
    fj = np.asarray(jfs.fused_point_flow_inverse(jp, uj, zj, tile=128, dtype=jnp.float32))
    ref = float(np.sqrt(((xj - fj) ** 2).mean() / (fj ** 2).mean()))
    # the coordinates agree to ~1e-5 (test_dequantized_inverse_matches_pallas);
    # their difference is a few percent of them, so its RMS to ~1e-3
    assert 0 < rms and abs(rms - ref) <= 1e-3 * ref, (rms, ref)


def test_quantized_argument_checks():
    """The kernel path refuses int8 stacks that do not match sp."""
    sp, _ = _both(2, seed=10)
    q = tfs.quantize_flow_params(sp)
    tfs._check_quantized(sp, q)
    with pytest.raises(ValueError, match="int8"):
        tfs._check_quantized(sp, q._replace(sp=q.sp._replace(wx=q.sp.wx.float())))
    with pytest.raises(ValueError, match="shape"):
        tfs._check_quantized(sp, q._replace(sp=q.sp._replace(wout=q.sp.wout[:, :3].contiguous())))
    with pytest.raises(ValueError, match="scales"):
        tfs._check_quantized(sp, q._replace(scales=q.scales[:, :3].contiguous()))
