"""The bf16 latent-flow kernels' cluster split, on the CPU: the plan that
the wrapper and the launch share (cluster, group, gradient slices, shared
memory), the plain backward with its weight gradients summed per group of
samples and then across groups in order (the kernel's slices and their
reduction), and the log-det summed per rank slice and then in rank order
(the kernel's order), each against the JAX package's Pallas kernels in
interpret mode. Also the sampler's cached bf16 weights."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dpfx.config import config_from_dict as jax_config_from_dict  # noqa: E402
from dpfx.ops import fused_latent as jfl  # noqa: E402
from dpfx_torch import sampling  # noqa: E402
from dpfx_torch.compat import params_to_flax  # noqa: E402
from dpfx_torch.config import config_from_dict  # noqa: E402
from dpfx_torch.models import DPF  # noqa: E402
from dpfx_torch.ops import fused_latent as tfl  # noqa: E402

FLAGSHIP = dict(dz=128, hidden=256, n_hidden_m1=1)


def _raw(dz=32, n_layers=3, hidden=32, n_hidden=2, dtype="float32"):
    return {"experiment": "gen", "name": "t", "model": {
        "dz": dz,
        "point_flow": {"n_layers": 2, "hidden": 32, "n_hidden": 2, "scale_cap": 3.0},
        "latent_flow": {"n_layers": n_layers, "hidden": hidden, "n_hidden": n_hidden,
                        "compute_dtype": dtype, "scale_cap": 3.0},
        "encoder": {"point_widths": [32, 64], "head_widths": [32]}}}


def _setup(seed=0, scale=0.1, **over):
    """A port model off the identity (numpy-seeded noise on every weight),
    the same tree for JAX, and both packages' latent-flow configs."""
    raw = _raw(**over)
    model = DPF(config_from_dict(raw))
    rng = np.random.default_rng(seed)
    model.load_state_dict({k: v + torch.from_numpy(scale * rng.normal(size=tuple(v.shape))
                                                    .astype(np.float32))
                           for k, v in model.state_dict().items()})
    params = jax.tree.map(jnp.asarray, params_to_flax(model.state_dict()))
    return model, params, jax_config_from_dict(raw).model.latent_flow


def _jax_stacked(params, jcfg, dz):
    w = jfl.stack_latent_params_jnp(params, jcfg.n_layers, dz)
    static = jfl._static(jcfg, dz, w["win"].shape[1], jcfg.n_hidden - 1)
    return w, static


# ---------------------------------------------------------------- the plan

@pytest.mark.parametrize("b,clusters,slices", [(1, 1, 0), (64, 1, 0), (65, 2, 2), (130, 3, 3)])
def test_plan_at_the_flagship_widths_in_groups_of_64(b, clusters, slices):
    """Clusters of 16 CTAs on groups of 64 samples: the backward writes the
    gradients itself at B <= 64 (no slices, no reduction) and one slice per
    cluster above."""
    bwd = tfl.cluster_plan(b, **FLAGSHIP, backward=True, group=64)
    fwd = tfl.cluster_plan(b, **FLAGSHIP, backward=False, group=64)
    assert (bwd.cluster, bwd.group, bwd.clusters, bwd.slices) == (16, 64, clusters, slices)
    assert (fwd.cluster, fwd.group, fwd.clusters, fwd.slices) == (16, 64, clusters, 0)
    assert bwd.smem <= tfl.SMEM_LIMIT and fwd.smem <= tfl.SMEM_LIMIT


@pytest.mark.parametrize("b,clusters,slices", [(1, 1, 0), (16, 1, 0), (17, 2, 2), (64, 4, 4),
                                               (65, 5, 5), (130, 8, 8)])
def test_default_plan_at_the_flagship_widths(b, clusters, slices):
    """The default plan (the fastest measured): clusters of 16 CTAs on
    groups of 16 samples; the backward's slices capped at MAX_BWD_CLUSTERS."""
    bwd = tfl.cluster_plan(b, **FLAGSHIP, backward=True)
    fwd = tfl.cluster_plan(b, **FLAGSHIP, backward=False)
    assert (tfl.CLUSTER, tfl.GROUP) == (16, 16)
    assert (bwd.cluster, bwd.group, bwd.clusters, bwd.slices) == (16, 16, clusters, slices)
    assert (fwd.cluster, fwd.group, fwd.slices) == (16, 16, 0)
    assert fwd.clusters == -(-b // 16)


def test_plan_shared_memory_is_the_kernel_header_carve_up():
    """The byte counts csrc/fused_latent.cu's header states for the flagship."""
    assert tfl.cluster_smem_bytes(128, 256, 1, 64, 16, backward=False) == 139264
    assert tfl.cluster_smem_bytes(128, 256, 1, 64, 16, backward=True) == 228992
    # the backward on clusters of 8 fits only at groups of 32
    with pytest.raises(ValueError, match="shared memory"):
        tfl.cluster_plan(64, **FLAGSHIP, backward=True, cluster=8, group=64)
    p = tfl.cluster_plan(64, **FLAGSHIP, backward=True, cluster=8, group=32)
    assert (p.cluster, p.group, p.clusters, p.slices) == (8, 32, 2, 2)


def test_plan_caps_the_backward_slices():
    """Past MAX_BWD_CLUSTERS groups each cluster walks several groups into
    its one slice; the forward launches a cluster per group."""
    p = tfl.cluster_plan(64 * 20, **FLAGSHIP, backward=True, group=64)
    assert p.clusters == p.slices == tfl.MAX_BWD_CLUSTERS
    assert tfl.cluster_plan(64 * 20, **FLAGSHIP, backward=False, group=64).clusters == 20


@pytest.mark.parametrize("dz,hidden,want", [(32, 32, 4), (64, 48, 2), (48, 64, 2),
                                            (128, 256, 16), (256, 512, 16)])
def test_plan_takes_the_largest_cluster_that_splits(dz, hidden, want):
    """Each rank owns a multiple of 8 of dz and of hidden."""
    assert tfl.cluster_plan(8, dz, hidden, 1, backward=False).cluster == want


@pytest.mark.parametrize("dz,hidden,cluster,group,match", [
    (24, 32, None, None, "multiples of 16"),
    (32, 40, None, None, "multiples of 16"),
    (64, 256, 16, None, "multiples of 128"),
    (128, 48, 8, None, "multiples of 64"),
    (128, 256, 3, None, "cluster of 3"),
    (128, 256, 16, 40, "multiple of 16"),
    (128, 2048, None, None, "shared memory"),
    (128, 4096, None, None, "up to 2048"),
])
def test_plan_refuses_what_the_split_cannot_take(dz, hidden, cluster, group, match):
    with pytest.raises(ValueError, match=match):
        tfl.cluster_plan(64, dz, hidden, 1, backward=True, cluster=cluster, group=group)


def test_kernel_wrappers_check_the_plan_before_any_launch():
    """A plan for another batch, or a plan with the f32 kernels, raises in
    the wrapper's checks (before the device or the library is touched)."""
    w = {k: torch.zeros(s) for k, s in (("win", (2, 32, 32)), ("bin", (2, 32, 1)),
                                        ("wh", (2, 1, 32, 32)), ("bh", (2, 1, 32, 1)),
                                        ("ws", (2, 32, 32)), ("bs", (2, 32, 1)),
                                        ("wt", (2, 32, 32)), ("bt", (2, 32, 1)))}
    masks = tfl.latent_masks(2, 32, torch.device("cpu"))
    z = torch.zeros(70, 32)
    wrong = tfl.cluster_plan(64, 32, 32, 1, backward=False)
    tfl.reset_launch_counts()
    with pytest.raises(ValueError, match="not the plan"):
        tfl.latent_forward_kernel(w, masks, 3.0, z, torch.bfloat16, plan=wrong)
    with pytest.raises(ValueError, match="bf16"):
        tfl.latent_inverse_kernel(w, masks, 3.0, z, torch.float32, plan=wrong)
    assert sum(tfl.launches.values()) == 0


# ---------------------------------------------------------------- the grouped backward

@pytest.mark.parametrize("b", [64, 65, 130])
def test_grouped_plain_backward_matches_pallas(b):
    """latent_backward_plain with the weight gradients summed per group of
    64 samples, then across the groups in order, against dpfx's
    _lat_bwd_kernel in interpret mode (B padded to 128 lanes there, one grid
    step adding into the next), at the tiny widths of
    tests/test_torch_fused_latent.py with its tolerances (rtol 5e-4, atol
    5e-5); dz is per sample and does not depend on the grouping."""
    model, params, jcfg = _setup(n_layers=3, hidden=32, n_hidden=2)
    dz = 32
    rng = np.random.default_rng(b)
    z = rng.normal(size=(b, dz)).astype(np.float32)
    du = rng.normal(size=(b, dz)).astype(np.float32)
    dld = rng.normal(size=(b,)).astype(np.float32)
    wj, static = _jax_stacked(params, jcfg, dz)
    zt = jfl._pad_cols(jnp.asarray(z.T))
    ut, _ = jfl._fwd_call(static, wj, zt)
    b_pad = ut.shape[1]
    dut = jfl._pad_cols(jnp.asarray(du.T))
    dldp = jnp.pad(jnp.asarray(dld), (0, b_pad - b))
    gj, dzt = jfl._bwd_call(static, wj, ut, dut, dldp)

    w = tfl.stack_latent_params(model.latent_flow)
    w = {k: v.detach() for k, v in w.items()}
    masks = tfl.latent_masks(3, dz, torch.device("cpu"))
    u = torch.from_numpy(np.asarray(ut)[:, :b].T.copy())
    got_z, got_w = tfl.latent_backward_plain(w, masks, 3.0, u, torch.from_numpy(du),
                                             torch.from_numpy(dld), torch.float32, group=64)
    one_z, one_w = tfl.latent_backward_plain(w, masks, 3.0, u, torch.from_numpy(du),
                                             torch.from_numpy(dld), torch.float32)
    np.testing.assert_allclose(got_z.numpy(), np.asarray(dzt)[:, :b].T, rtol=5e-4, atol=5e-5)
    # per sample either way (torch's products may round a lone row otherwise)
    torch.testing.assert_close(got_z, one_z, rtol=1e-5, atol=1e-6)
    for name in tfl.KEYS:
        ref = np.asarray(gj[name])
        if ref.size:
            np.testing.assert_allclose(got_w[name].numpy(), ref, rtol=5e-4, atol=5e-5,
                                       err_msg=name)
        # the grouping moves only the order of the f32 sum over samples
        # (seen: 2e-7 of the norm at B=130)
        diff = float((got_w[name] - one_w[name]).norm())
        assert diff <= 1e-6 * float(one_w[name].norm()) + 1e-12, (name, diff)


# ---------------------------------------------------------------- the log-det order

@pytest.mark.parametrize("ranks", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_log_det_in_rank_order_matches_pallas(ranks, dtype):
    """The log-det summed per rank slice of the features (each slice's
    running sum over the layers) and then in rank order, against dpfx's
    _lat_fwd_kernel in interpret mode: f32 within 2e-5, bf16 within 1e-3
    (tests/test_torch_fused_latent.py's brackets); u does not depend on
    the order."""
    model, params, jcfg = _setup(n_layers=5, hidden=48, n_hidden=2, dtype=dtype)
    dz, b = 32, 9
    z = np.random.default_rng(6).normal(size=(b, dz)).astype(np.float32)
    wj, static = _jax_stacked(params, jcfg, dz)
    ut, ldj = jfl._fwd_call(static, wj, jfl._pad_cols(jnp.asarray(z.T)))
    w = {k: v.detach() for k, v in tfl.stack_latent_params(model.latent_flow).items()}
    masks = tfl.latent_masks(5, dz, torch.device("cpu"))
    dt = getattr(torch, dtype)
    u, ld = tfl.latent_forward_plain(w, masks, 3.0, torch.from_numpy(z), dt, ranks=ranks)
    u1, ld1 = tfl.latent_forward_plain(w, masks, 3.0, torch.from_numpy(z), dt)
    tol = 2e-5 if dtype == "float32" else 1e-3
    np.testing.assert_allclose(ld.numpy(), np.asarray(ldj)[:b], rtol=tol, atol=tol)
    np.testing.assert_allclose(u.numpy(), np.asarray(ut)[:, :b].T, rtol=tol, atol=tol)
    assert torch.equal(u, u1)
    torch.testing.assert_close(ld, ld1, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- the sampler's cached weights

def test_cast_weights_give_the_same_inverse():
    """The sampler keeps the matrices cast to bf16 once: the inverse on the
    cast stack is the inverse on the f32 stack (whose matrices each call
    would cast) bit for bit; biases stay f32."""
    model, _, _ = _setup(n_layers=4, hidden=32, n_hidden=2, dtype="bfloat16")
    lf = model.config.model.latent_flow
    with torch.no_grad():
        stacked = tfl.stack_latent_params(model.latent_flow)
    cast = tfl.cast_latent_weights(stacked, torch.bfloat16)
    assert all(cast[k].dtype == torch.bfloat16 for k in tfl.MATRICES)
    assert all(cast[k] is stacked[k] for k in tfl.KEYS if k not in tfl.MATRICES)
    eps = torch.from_numpy(np.random.default_rng(3).normal(size=(7, 32)).astype(np.float32))
    assert torch.equal(tfl.fused_latent_inverse(cast, eps, lf),
                       tfl.fused_latent_inverse(stacked, eps, lf))


def test_sampler_caches_the_cast_weights(monkeypatch):
    """make_sampler under DPFX_SAMPLE_FUSED_LATENT=1 casts once, when it is
    made, and its clouds equal those of a sampler that casts on every call."""
    model, _, _ = _setup(n_layers=4, hidden=32, n_hidden=2, dtype="bfloat16")
    monkeypatch.setenv("DPFX_SAMPLE_FUSED_LATENT", "1")
    seen = []
    real = sampling.fused_latent_inverse
    monkeypatch.setattr(sampling, "fused_latent_inverse",
                        lambda st, eps, cfg: seen.append(st["win"].dtype) or real(st, eps, cfg))
    cached = sampling.make_sampler(model, 3, 40)(5)
    monkeypatch.setattr(sampling, "cast_latent_weights", lambda w, dtype: w)
    uncached = sampling.make_sampler(model, 3, 40)(5)
    assert seen == [torch.bfloat16, torch.float32]
    assert torch.equal(cached, uncached)
