"""The port's kernels (fused sampler, fused train forward/backward, fused
encoder forward/backward, fused latent flow forward/backward/inverse,
Chamfer, approxmatch EMD) against their plain versions on the card, at
small shapes. Marked ``gpu``: each test skips
without a CUDA device. On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest

(``--noconftest``: the suite's conftest sets JAX up, and the port needs no JAX.)
"""

import pytest

torch = pytest.importorskip("torch")

from dpfx_torch.compat import randomize_  # noqa: E402
from dpfx_torch.models import CouplingFlow  # noqa: E402
from dpfx_torch.ops import fused_sampler as fs  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sp(hidden, n_hidden, activation, dev, k=6, seed=0):
    # scale 0.02: at 0.1 the random H=256 inverse is unstable (|x| reaches
    # 300-3000), and one flipped bf16 rounding, carried on, exceeds any
    # absolute tolerance; at 0.02 the clouds stay O(1)-O(10)
    torch.manual_seed(seed)        # the module's own init
    flow = CouplingFlow(3, k, hidden, n_hidden, cond_dim=16, scale_cap=3.0, activation=activation)
    with torch.no_grad():
        return fs.stack_point_flow_params(randomize_(flow, seed, 0.02).to(dev))


@pytest.mark.parametrize("hidden,n_hidden,activation,n", [
    (32, 2, "relu", 200), (64, 1, "gelu", 128), (128, 3, "tanh", 300), (256, 2, "leaky_relu", 77)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_inverse_matches_plain(cuda, hidden, n_hidden, activation, n, dtype):
    dt = getattr(torch, dtype)
    if fs.smem_bytes(hidden, dt) > fs.SMEM_LIMIT:
        with pytest.raises(ValueError, match="shared"):
            fs._check_kernel_args(_sp(hidden, n_hidden, activation, cuda),
                                  torch.zeros(1, 6, hidden, device=cuda), dt, activation)
        return
    sp = _sp(hidden, n_hidden, activation, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    ut = torch.randn((3, 8, n), generator=g, device=cuda)
    z = torch.randn((3, 16), generator=g, device=cuda)
    fs.reset_launch_counts()
    x = fs.fused_inverse_transposed(sp, ut, z, dtype=dt, activation=activation)
    ref = fs.fused_inverse_transposed_plain(sp, ut, fs.z_projection(sp, z), dt, activation)
    torch.cuda.synchronize()
    assert fs.launches["fused_inverse"] == 1
    # f32: both sides sum in IEEE f32 in other orders; bf16: a flipped
    # rounding of one hidden unit moves a coordinate by ~1e-3
    tol = 1e-4 if dt == torch.float32 else 5e-2
    torch.testing.assert_close(x, ref, atol=tol, rtol=tol)
    torch.testing.assert_close(x[:, 3:], ut[:, 3:], atol=0, rtol=0)


def test_smem_mirror_matches_kernel(cuda):
    """The wrapper's shared-memory check mirrors the kernel's carve-up."""
    lib = fs._lib()
    for h in fs.KERNEL_HIDDEN:
        for dt, bf16 in ((torch.float32, 0), (torch.bfloat16, 1)):
            assert fs.smem_bytes(h, dt) == lib.dpfx_fused_sampler_smem_bytes(h, bf16)


def test_fused_sample_draws_then_inverts(cuda):
    sp = _sp(64, 2, "relu", cuda)
    z = torch.randn((4, 16), device=cuda)
    x, u = fs.fused_sample_points(sp, z, 7, 3000, dtype=torch.float32, noise_scale=1.1,
                                  return_noise=True)
    ref = fs.fused_point_flow_inverse(sp, u, z, dtype=torch.float32)
    torch.testing.assert_close(x, ref, atol=1e-4, rtol=1e-4)
    assert abs(float(u.mean())) < 0.03 and abs(float(u.var()) / 1.21 - 1) < 0.05
    torch.testing.assert_close(fs.fused_sample_points(sp, z, 7, 3000, dtype=torch.float32,
                                                      noise_scale=1.1), x, atol=0, rtol=0)
    # the stream is keyed by (seed, cloud, point): a prefix draws the same noise
    _, u_head = fs.fused_sample_points(sp, z, 7, 1000, dtype=torch.float32, noise_scale=1.1,
                                       return_noise=True)
    torch.testing.assert_close(u_head, u[:, :1000], atol=0, rtol=0)


# ---------------------------------------------------------------- training kernels

def _flow_weights(hidden, n_hidden, dev, k=5, seed=0):
    flow = CouplingFlow(3, k, hidden, n_hidden, cond_dim=16, scale_cap=3.0)
    with torch.no_grad():
        return fs.stack_point_flow_params(randomize_(flow, seed, 0.1).to(dev))


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-12))


@pytest.mark.parametrize("hidden,n_hidden,n", [(32, 2, 200), (64, 1, 128), (128, 2, 300),
                                               (64, 3, 77)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_train_kernels_match_plain(cuda, hidden, n_hidden, n, dtype):
    from dpfx_torch.ops import fused_train as ft
    from dpfx_torch.ops.fused_sampler import z_projection

    dt = getattr(torch, dtype)
    sp = _flow_weights(hidden, n_hidden, cuda)
    w = (sp.wx, sp.wh, sp.bh, sp.wout, sp.bout, sp.masks, sp.scale_cap)
    g = torch.Generator(device=cuda).manual_seed(1)
    xt = torch.randn((3, 3, n), generator=g, device=cuda)
    hz = z_projection(sp, torch.randn((3, 16), generator=g, device=cuda))
    ft.reset_launch_counts()
    u, ld = ft.fused_forward_kernel(*w, xt, hz, dt)
    u_p, ld_p = ft.fused_forward_plain(*w, xt, hz, dt)
    du = torch.randn(u.shape, generator=g, device=cuda)
    dld = torch.randn(ld.shape, generator=g, device=cuda)
    got = ft.fused_backward_kernel(*w, u_p, hz, du, dld, dt)
    again = ft.fused_backward_kernel(*w, u_p, hz, du, dld, dt)
    ref = ft.fused_backward_plain(*w, u_p, hz, du, dld, dt)
    torch.cuda.synchronize()
    assert ft.launches == {"fused_train_fwd": 1, "fused_train_bwd": 2}
    # f32: IEEE sums in other orders; bf16: a flipped rounding of one hidden
    # unit moves a value by ~1e-3 and the layers carry it on
    f32 = dt == torch.float32
    torch.testing.assert_close(u, u_p, atol=1e-4 if f32 else 5e-2, rtol=1e-4 if f32 else 2e-2)
    torch.testing.assert_close(ld, ld_p, atol=1e-3 if f32 else 1e-1, rtol=1e-4 if f32 else 2e-2)
    tol = 1e-4 if f32 else 2e-2
    for name, a, b, c in zip(["dx", "dhz", "dwx", "dwh", "dbh", "dwout", "dbout"], got, ref,
                             again):
        assert torch.equal(a, c), f"{name} is not bit-identical from run to run"
        if b.numel():
            assert _rel(a, b) <= tol, f"{name}: {_rel(a, b)}"


@pytest.mark.parametrize("widths,n", [((32, 64), 200), ((32, 32, 64, 128), 256),
                                      ((16, 128), 77)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_encoder_kernels_match_plain(cuda, widths, n, dtype):
    from dpfx_torch.models import PointNetEncoder
    from dpfx_torch.ops import fused_encoder as fe

    dt = getattr(torch, dtype)
    enc = randomize_(PointNetEncoder(16, widths, (32,)), 0, 0.1).to(cuda)
    with torch.no_grad():
        getattr(enc, f"point_{len(widths) - 1}").bias[3] = -100.0      # a dead feature
    ws, bs = [w.detach() for w in fe.encoder_point_weights(enc)[0]], \
        [b.detach() for b in fe.encoder_point_weights(enc)[1]]
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((3, n, 3), generator=g, device=cuda)
    x[0, n // 2:] = x[0, : n - n // 2].clone()                          # ties
    fe.reset_launch_counts()
    pooled, cnt = fe.pool_forward_kernel(ws, bs, x, dt)
    pooled_p, cnt_p = fe.pool_forward_plain(ws, bs, x, dt)
    dg = torch.randn(pooled.shape, generator=g, device=cuda)
    # each backward takes its own forward's pool: the tie mask compares the
    # recomputed activations with it bit for bit
    got = fe.pool_backward_kernel(ws, bs, x, pooled, cnt, dg, dt)
    again = fe.pool_backward_kernel(ws, bs, x, pooled, cnt, dg, dt)
    ref = fe.pool_backward_plain(ws, bs, x, pooled_p, cnt_p, dg, dt)
    torch.cuda.synchronize()
    assert fe.launches == {"fused_encoder_fwd": 1, "fused_encoder_bwd": 2}
    tol = 1e-5 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(pooled, pooled_p, atol=tol, rtol=tol)
    if dt == torch.float32:
        torch.testing.assert_close(cnt, cnt_p, atol=0, rtol=0)
    flat = lambda r: [r[0]] + list(r[1]) + list(r[2])
    for i, (a, b, c) in enumerate(zip(flat(got), flat(ref), flat(again))):
        assert torch.equal(a, c), f"tensor {i} is not bit-identical from run to run"
        assert _rel(a, b) <= (1e-4 if dt == torch.float32 else 2e-2), f"tensor {i}: {_rel(a, b)}"


def test_training_smem_fits_flagship(cuda):
    from dpfx_torch.ops import fused_encoder as fe
    from dpfx_torch.ops import fused_train as ft

    for dt in (torch.float32, torch.bfloat16):
        for backward in (False, True):
            assert 0 < ft.smem_bytes(128, 1, dt, backward) <= fs.SMEM_LIMIT
        assert 0 < fe.smem_bytes((3, 128, 128, 256, 512), dt) <= fs.SMEM_LIMIT


def test_train_step_on_card_skips_a_nonfinite_batch(cuda):
    """A fused train step on the card launches all four training kernels, and
    a batch holding an inf is skipped: params, moments and the optimizer's
    count keep their values, the step counter advances."""
    from dpfx_torch.config import config_from_dict
    from dpfx_torch.models import DPF
    from dpfx_torch.ops import fused_encoder as fe
    from dpfx_torch.ops import fused_train as ft
    from dpfx_torch.train import init_params_, init_state, make_optimizer, make_train_step

    cfg = config_from_dict({"experiment": "gen", "model": {
        "dz": 16,
        "point_flow": {"n_layers": 4, "hidden": 32, "n_hidden": 2, "compute_dtype": "bfloat16"},
        "latent_flow": {"n_layers": 4, "hidden": 32, "n_hidden": 2},
        "encoder": {"point_widths": [32, 64], "head_widths": [32], "compute_dtype": "bfloat16"}},
        "train": {"fused_point_flow": True, "fused_encoder": True, "grad_clip": 1.0}})
    model = randomize_(init_params_(DPF(cfg), 0), 0, 0.05).to(cuda)
    tx = make_optimizer(cfg.train)
    state = init_state(model, tx)
    step = make_train_step(model, tx, cfg)
    ft.reset_launch_counts()
    fe.reset_launch_counts()
    x = torch.randn((4, 256, 3), device=cuda)
    state, m = step(state, {"x": x})
    assert float(m["nonfinite_skipped"]) == 0.0 and bool(torch.isfinite(m["loss"]))
    assert all(v == 1 for v in {**ft.launches, **fe.launches}.values())
    params, mu, nu = (t.clone() for t in (state.params, state.opt_state.mu, state.opt_state.nu))
    bad = x.clone()
    bad[1, 5, 0] = float("inf")
    state, m = step(state, {"x": bad})
    assert float(m["nonfinite_skipped"]) == 1.0 and state.step == 2
    assert state.opt_state.count == 1
    for a, b in ((state.params, params), (state.opt_state.mu, mu), (state.opt_state.nu, nu)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- latent-flow kernels

def _latent_weights(dz, hidden, n_hidden, k, dev, seed=0):
    torch.manual_seed(seed)        # the module's own init
    flow = CouplingFlow(dz, k, hidden, n_hidden, scale_cap=3.0)
    with torch.no_grad():
        from dpfx_torch.ops import fused_latent as fl

        return fl.stack_latent_params(randomize_(flow, seed, 0.05).to(dev))


@pytest.mark.parametrize("dz,hidden,n_hidden,b", [(32, 32, 2, 5), (128, 256, 2, 64),
                                                  (64, 48, 1, 130), (48, 64, 3, 17)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_latent_kernels_match_plain(cuda, dz, hidden, n_hidden, b, dtype):
    """Forward (u, log-det), inverse and backward (dz and every weight
    gradient) against the plain versions; the backward bit-identical from
    run to run. B=130 is a ragged last tile over nine blocks."""
    from dpfx_torch.ops import fused_latent as fl

    dt = getattr(torch, dtype)
    k = 5
    w = _latent_weights(dz, hidden, n_hidden, k, cuda)
    masks = fl.latent_masks(k, dz, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    z = torch.randn((b, dz), generator=g, device=cuda)
    fl.reset_launch_counts()
    u, ld = fl.latent_forward_kernel(w, masks, 3.0, z, dt)
    u_p, ld_p = fl.latent_forward_plain(w, masks, 3.0, z, dt)
    zi = fl.latent_inverse_kernel(w, masks, 3.0, z, dt)
    zi_p = fl.latent_inverse_plain(w, masks, 3.0, z, dt)
    du = torch.randn(u.shape, generator=g, device=cuda)
    dld = torch.randn(ld.shape, generator=g, device=cuda)
    got = fl.latent_backward_kernel(w, masks, 3.0, u_p, du, dld, dt)
    again = fl.latent_backward_kernel(w, masks, 3.0, u_p, du, dld, dt)
    ref = fl.latent_backward_plain(w, masks, 3.0, u_p, du, dld, dt)
    torch.cuda.synchronize()
    assert fl.launches == {"fused_latent_fwd": 1, "fused_latent_bwd": 2, "fused_latent_inv": 1}
    # f32: IEEE sums in other orders; bf16: a flipped rounding of one hidden
    # unit moves a value by ~1e-3 and the layers carry it on
    f32 = dt == torch.float32
    tol = 1e-4 if f32 else 2e-2
    torch.testing.assert_close(u, u_p, atol=tol, rtol=tol)
    torch.testing.assert_close(zi, zi_p, atol=tol, rtol=tol)
    assert _rel(ld, ld_p) <= tol
    flat = lambda r: [r[0]] + [r[1][n] for n in fl.KEYS]
    for name, a, r, c in zip(("dz",) + fl.KEYS, flat(got), flat(ref), flat(again)):
        assert torch.equal(a, c), f"{name} is not bit-identical from run to run"
        if r.numel():
            assert _rel(a, r) <= tol, f"{name}: {_rel(a, r)}"


def test_fused_latent_kernel_conditions(cuda):
    """Shapes the kernels are not built for raise before any launch; the
    flagship latent flow fits a block's shared memory."""
    from dpfx_torch.ops import fused_latent as fl

    for dt in (torch.float32, torch.bfloat16):
        for backward in (False, True):
            assert 0 < fl.smem_bytes(128, 256, 1, dt, backward) <= fs.SMEM_LIMIT
    w = _latent_weights(24, 32, 2, 3, cuda)
    fl.reset_launch_counts()
    with pytest.raises(ValueError, match="multiples of 16"):
        fl.latent_forward_kernel(w, fl.latent_masks(3, 24, cuda), 3.0,
                                 torch.zeros((4, 24), device=cuda), torch.bfloat16)
    w = _latent_weights(32, 1024, 2, 2, cuda)      # f32 backward: ~260 KB
    with pytest.raises(ValueError, match="shared memory"):
        fl.latent_backward_kernel(w, fl.latent_masks(2, 32, cuda), 3.0,
                                  *(torch.zeros(s, device=cuda) for s in ((4, 32), (4, 32), (4,))),
                                  torch.float32)
    assert sum(fl.launches.values()) == 0


def test_train_step_on_card_with_fused_latent(cuda):
    """A train step with train.fused_latent_flow on the card launches the
    latent forward and backward once each and matches the module path's
    loss and grad norm (f32)."""
    from dpfx_torch.config import config_from_dict
    from dpfx_torch.models import DPF
    from dpfx_torch.ops import fused_latent as fl
    from dpfx_torch.train import init_params_, init_state, make_optimizer, make_train_step

    raw = {"experiment": "gen", "model": {
        "dz": 32,
        "point_flow": {"n_layers": 4, "hidden": 32, "n_hidden": 2},
        "latent_flow": {"n_layers": 4, "hidden": 64, "n_hidden": 2},
        "encoder": {"point_widths": [32, 64], "head_widths": [32]}},
        "train": {"grad_clip": 1.0}}
    import copy

    model = randomize_(init_params_(DPF(config_from_dict(raw)), 0), 0, 0.05).to(cuda)
    x = torch.randn((4, 256, 3), device=cuda)
    eps = torch.randn((4, 32), device=cuda)
    out = []
    for fused in (True, False):
        cfg = config_from_dict({**raw, "train": {**raw["train"], "fused_latent_flow": fused}})
        m_ = copy.deepcopy(model)       # the step updates its model's parameters in place
        tx = make_optimizer(cfg.train)
        fl.reset_launch_counts()
        _, m = make_train_step(m_, tx, cfg)(init_state(m_, tx), {"x": x, "eps": eps})
        out.append((float(m["loss"]), float(m["grad_norm"]), dict(fl.launches)))
    (lf, gf, nf), (lm, gm, nm) = out
    assert nf == {"fused_latent_fwd": 1, "fused_latent_bwd": 1, "fused_latent_inv": 0}
    assert sum(nm.values()) == 0
    assert abs(lf - lm) <= 1e-4 * abs(lm) and abs(gf - gm) <= 1e-3 * abs(gm)


# ---------------------------------------------------------------- evaluation kernels

def _eval_clouds(cuda, s, n, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn((s, n, 3), generator=g, device=cuda) * 0.5


def _pair_rel(a, b, floor):
    return float(((a.double() - b.double()).abs() / b.double().abs().clamp_min(floor)).max())


@pytest.mark.parametrize("n,m", [(256, 256), (200, 317), (37, 101)])
def test_chamfer_kernels_match_plain(cuda, n, m):
    """nnd_fwd and cd_pairwise (exact, fast) against their plain versions:
    the distances are the same expression rounded op by op, so only the
    order of the sums of minima differs (limit 1e-5, dpfx's own)."""
    from dpfx_torch.ops import chamfer as cdk

    xs, ys = _eval_clouds(cuda, 4, n, 1), _eval_clouds(cuda, 3, m, 2)
    cdk.reset_launch_counts()
    dl, dr = cdk.nn_distances(xs[:3], ys)
    pdl, _, pdr, _ = cdk.nn_distances_plain(xs[:3], ys)
    torch.testing.assert_close(dl, pdl, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(dr, pdr, rtol=1e-5, atol=1e-7)
    for prec in ("exact", "fast"):
        got = cdk.chamfer_pairwise(xs, ys, prec)
        assert torch.equal(got, cdk.chamfer_pairwise(xs, ys, prec)), "not bit-identical"
        assert _pair_rel(got, cdk.chamfer_pairwise_plain(xs, ys, prec), 1e-7) <= 1e-5
    torch.cuda.synchronize()
    assert cdk.launches == {"nnd_fwd": 1, "cd_pairwise": 4}


def test_chamfer_symmetric_mirror_is_exact(cuda):
    """The triangle mode computes the pairs j >= i and mirrors them: equal,
    bit for bit, to the full matrix and to its own transpose."""
    from dpfx_torch.ops import chamfer as cdk

    xs = _eval_clouds(cuda, 9, 300, 3)
    sym = cdk.chamfer_pairwise(xs, xs, symmetric=True)
    assert torch.equal(sym, cdk.chamfer_pairwise(xs, xs))
    assert torch.equal(sym, sym.t())
    assert float(sym.diagonal().abs().max()) <= 1e-5
    with pytest.raises(ValueError, match="self-comparison"):
        cdk.chamfer_pairwise(xs, xs[:, :200], symmetric=True)


@pytest.mark.parametrize("n,m", [(256, 256), (200, 317)])
def test_emd_kernels_match_plain(cuda, n, m):
    """emd_batched (exact) and emd_pairwise (fast, exact) against their plain
    versions. approxmatch carries rounding through its recursion, so the
    median pair is held to dpfx's 1e-4 and the largest to 5e-3 (see
    chip_smoke.py's TOL_EMD_* for the measurement)."""
    from dpfx_torch.ops import emd as emdk

    xs, ys = _eval_clouds(cuda, 4, n, 4), _eval_clouds(cuda, 4, m, 5)
    emdk.reset_launch_counts()

    def held(a, b):
        e = (a.double() - b.double()).abs() / b.double().abs().clamp_min(1e-5)
        return float(e.median()) <= 1e-4 and float(e.max()) <= 5e-3

    a = emdk.emd_nograd(xs, ys)
    assert torch.equal(a, emdk.emd_nograd(xs, ys)), "not bit-identical"
    assert held(a, emdk.emd_plain(xs, ys))
    for prec in ("fast", "exact"):
        got = emdk.emd_pairwise(xs, ys, precision=prec)
        assert torch.equal(got, emdk.emd_pairwise(xs, ys, precision=prec)), "not bit-identical"
        assert held(got, emdk.emd_pairwise_plain(xs, ys, precision=prec))
    torch.cuda.synchronize()
    assert emdk.launches == {"emd_batched": 2, "emd_pairwise": 4}
    same = emdk.emd_nograd(xs[:, :64], xs[:, :64])
    assert float(same.max()) < 1e-3


def test_eval_kernel_conditions(cuda):
    """The kernels' shared memory fits up to MAX_POINTS, sizes beyond it
    raise before any launch, and gradients are refused."""
    from dpfx_torch.ops import chamfer as cdk
    from dpfx_torch.ops import emd as emdk

    for n, m in ((1, 1), (2048, 2048), (2000, 4096), (4096, 4096)):
        assert 0 < cdk.smem_bytes(n, m) < emdk.smem_bytes(n, m) <= cdk.SMEM_LIMIT
    big = torch.zeros((1, cdk.MAX_POINTS + 1, 3), device=cuda)
    small = torch.zeros((1, 8, 3), device=cuda)
    cdk.reset_launch_counts()
    emdk.reset_launch_counts()
    with pytest.raises(ValueError, match="points per cloud"):
        cdk.chamfer_pairwise(big, small)
    with pytest.raises(ValueError, match="points per cloud"):
        emdk.emd_nograd(small, big)
    assert sum(cdk.launches.values()) + sum(emdk.launches.values()) == 0
    with pytest.raises(NotImplementedError, match="Queue 2 #8"):
        cdk.nn_distances(small.clone().requires_grad_(True), small)
    # the largest clouds the kernels take (EMD: 224 KB of shared memory)
    x, y = _eval_clouds(cuda, 1, cdk.MAX_POINTS, 6), _eval_clouds(cuda, 1, cdk.MAX_POINTS, 7)
    assert _pair_rel(cdk.chamfer(x, y), cdk.chamfer_plain(x, y), 1e-7) <= 1e-5
    assert _pair_rel(emdk.emd_nograd(x, y), emdk.emd_plain(x, y), 1e-5) <= 5e-3
