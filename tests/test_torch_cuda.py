"""The port's kernels (fused sampler with its int8 mode, fused train
forward/backward, fused encoder forward/backward, fused latent flow
forward/backward/inverse, Chamfer with its backward, approxmatch EMD with
its gradient mode and its thread-block clusters, the probe tools' backward and dual-issue kernels)
against their plain versions on the card, at small shapes and at 2048
points; the captured train step, and the trainer loop on it (resume after
a capture, the recovery's recapture, evaluation against the CPU). Marked ``gpu``: each test skips
without a CUDA device. On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest

(``--noconftest``: the suite's conftest sets JAX up, and the port needs no JAX.)
"""

import pytest

torch = pytest.importorskip("torch")

from dpfx_torch.compat import randomize_  # noqa: E402
from dpfx_torch.models import CouplingFlow  # noqa: E402
from dpfx_torch.ops import fused_sampler as fs  # noqa: E402
from dpfx_torch.ops import fused_train as ft  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sp(hidden, n_hidden, activation, dev, k=6, seed=0, scale=0.02):
    # scale 0.02: at 0.1 the random H=256 inverse is unstable (|x| reaches
    # 300-3000), and one flipped bf16 rounding, carried on, exceeds any
    # absolute tolerance; at 0.02 the clouds stay O(1)-O(10)
    torch.manual_seed(seed)        # the module's own init
    flow = CouplingFlow(3, k, hidden, n_hidden, cond_dim=16, scale_cap=3.0, activation=activation)
    with torch.no_grad():
        return fs.stack_point_flow_params(randomize_(flow, seed, scale).to(dev))


# (256, 3) and (128, 7) stage one Wh at a time in bf16 (a layer's stack
# does not fit two stages, or one)
INVERSE_SHAPES = [(32, 2, "relu", 200), (64, 1, "gelu", 128), (128, 3, "tanh", 300),
                  (256, 2, "leaky_relu", 77), (256, 3, "relu", 130), (128, 7, "gelu", 131)]


@pytest.mark.parametrize("hidden,n_hidden,activation,n", INVERSE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_inverse_matches_plain(cuda, hidden, n_hidden, activation, n, dtype):
    dt = getattr(torch, dtype)
    if fs.smem_bytes(hidden, dt, n_hidden - 1) > fs.SMEM_LIMIT:
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
    """The wrapper's shared-memory check mirrors the kernel's carve-up, at
    every width, conditioner depth and mode (bf16: one or two stages, the
    int8 mode's raw bytes)."""
    lib = fs._lib()
    for h in fs.KERNEL_HIDDEN:
        for nh1 in range(10):
            for dt, bf16 in ((torch.float32, 0), (torch.bfloat16, 1)):
                for int8 in (False, True):
                    assert fs.smem_bytes(h, dt, nh1, int8) == \
                        lib.dpfx_fused_sampler_smem_bytes(h, nh1, bf16, int(int8)), (h, nh1, dt, int8)
    # the flagship conditioner (H=128, n_hidden=2) keeps two blocks per SM
    assert 2 * fs.smem_bytes(128, torch.bfloat16, 1, True) <= 228 * 1024 - 2 * 1024


@pytest.mark.parametrize("hidden,n_hidden,n,b", [(32, 3, 200, 3), (128, 2, 300, 2)])
def test_rows_inverse_round_trips_the_training_forward(cuda, hidden, n_hidden, n, b):
    """fused_train's bf16 forward, then the sampler's bf16 inverse with the
    same hz: both run the same row code on the same passthrough
    coordinates, so x comes back up to the f32 rounding of the affine
    update (median <= 1e-5); a coordinate recovered a few ulps off may round
    to the other side of a bf16 boundary at a later layer (max <= 5e-2)."""
    sp = _sp(hidden, n_hidden, "relu", cuda, k=8)
    g = torch.Generator(device=cuda).manual_seed(2)
    xt = torch.randn((b, 3, n), generator=g, device=cuda)
    z = torch.randn((b, 16), generator=g, device=cuda)
    u, _ = ft.fused_forward_kernel(sp.wx, sp.wh, sp.bh, sp.wout, sp.bout, sp.masks, sp.scale_cap,
                                   xt, fs.z_projection(sp, z), torch.bfloat16)
    back = fs.fused_inverse_transposed(sp, u, z, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    e = (back - xt).abs()
    assert float((u - xt).abs().max()) > 0.1           # the flow moved the points
    assert float(e.median()) <= 1e-5 and float(e.max()) <= 5e-2


# the cluster inverse's shapes (H, n_hidden), each at C=3 and C=8 rows: a
# ragged N, N below a tile, one cloud; a padded width (192 -> 256)
CLUSTER_INVERSE_CASES = [(128, 3, 300, 3), (128, 4, 130, 2), (256, 2, 2000, 1), (256, 3, 77, 2),
                         (192, 2, 200, 2), (256, 4, 300, 2)]


def _cluster_sp(hidden, n_hidden, dev, k=4, seed=0):
    # seeded noise at 0.02 scaled by sqrt(128 / H), as the cluster layout's
    # training tests take it
    return _sp(hidden, n_hidden, "relu", dev, k, seed,
               0.02 * (128 / max(fs.kernel_hidden(hidden), 128)) ** 0.5)


@pytest.fixture
def every_cluster_shape(monkeypatch):
    """The cluster inverse at every shape it is built for, ROWS_KEPT's too
    (the route keeps rows_kernel there only because it timed faster)."""
    monkeypatch.setattr(fs, "ROWS_KEPT", ())


@pytest.mark.parametrize("c", [3, 8])
@pytest.mark.parametrize("hidden,n_hidden,n,b", CLUSTER_INVERSE_CASES)
def test_cluster_inverse_matches_plain(cuda, every_cluster_shape, hidden, n_hidden, n, b, c):
    """The cluster inverse at K=4 against the plain version by phase 2's
    bf16 limits (max 5e-2, p99.9 2e-3), bit-identical from run to run, rows
    3.. of a C=8 input passed through, each launch counted on its layout."""
    sp = _cluster_sp(hidden, n_hidden, cuda, seed=hidden + n_hidden + c)
    g = torch.Generator(device=cuda).manual_seed(hidden + n)
    ut = torch.randn((b, c, n), generator=g, device=cuda)
    z = torch.randn((b, 16), generator=g, device=cuda)
    fs.reset_launch_counts()
    x = fs.fused_inverse_transposed(sp, ut, z, dtype=torch.bfloat16)
    x2 = fs.fused_inverse_transposed(sp, ut, z, dtype=torch.bfloat16)
    ref = fs.fused_inverse_transposed_plain(sp, ut, fs.z_projection(sp, z), torch.bfloat16)
    torch.cuda.synchronize()
    assert fs.launches["fused_inverse"] == 2 and fs.layout_launches == {"rows": 0, "cluster": 2,
                                                                        "f32": 0}
    assert torch.equal(x, x2), "the cluster inverse is not bit-identical from run to run"
    e = (x[:, :3] - ref[:, :3]).abs().flatten()
    assert float((x[:, :3] - ut[:, :3]).abs().max()) > 0.05      # the flow moved the points
    assert float(e.max()) <= 5e-2 and float(torch.quantile(e, 0.999)) <= 2e-3, float(e.max())
    assert torch.equal(x[:, 3:], ut[:, 3:])


@pytest.mark.parametrize("hidden,n_hidden", [(128, 3), (128, 4), (256, 2), (256, 3), (256, 4)])
def test_cluster_inverse_round_trips_the_cluster_forward(cuda, every_cluster_shape, hidden,
                                                         n_hidden):
    """fused_train's cluster forward, then the sampler's cluster inverse
    with the same hz: both run cl_st_partials on the same passthrough
    coordinates, so x comes back up to the f32 rounding of the affine update
    (median <= 1e-5; max <= 5e-2, as test_rows_inverse_round_trips_the_training_forward)."""
    sp = _cluster_sp(hidden, n_hidden, cuda, k=8, seed=n_hidden)
    h, nh1 = sp.wx.shape[1], sp.wh.shape[1]
    assert ft._layout(h, nh1, torch.bfloat16, False) == "cluster"
    g = torch.Generator(device=cuda).manual_seed(2)
    xt = torch.randn((2, 3, 1000), generator=g, device=cuda)
    z = torch.randn((2, 16), generator=g, device=cuda)
    u, _ = ft.fused_forward_kernel(sp.wx, sp.wh, sp.bh, sp.wout, sp.bout, sp.masks, sp.scale_cap,
                                   xt, fs.z_projection(sp, z), torch.bfloat16)
    back = fs.fused_inverse_transposed(sp, u, z, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    e = (back - xt).abs()
    assert float((u - xt).abs().max()) > 0.1
    assert float(e.median()) <= 1e-5 and float(e.max()) <= 5e-2


def test_cluster_inverse_noise_is_philox_noise_plain(cuda):
    """The cluster inverse draws philox_noise_plain's stream (1e-6: logf
    and cosf a few ulps from torch's), the clouds are its inverse of that
    noise bit for bit, and a prefix of the points draws the same noise."""
    sp = _cluster_sp(256, 2, cuda, seed=5)
    assert fs.inverse_layout(256, 1, torch.bfloat16) == "cluster"
    z = torch.randn((3, 16), generator=torch.Generator(device=cuda).manual_seed(4), device=cuda)
    fs.reset_launch_counts()
    x, u = fs.fused_sample_points(sp, z, 2**40 + 7, 2000, noise_scale=1.1, return_noise=True)
    _, u_head = fs.fused_sample_points(sp, z, 2**40 + 7, 300, noise_scale=1.1, return_noise=True)
    back = fs.fused_point_flow_inverse(sp, u, z)
    torch.cuda.synchronize()
    assert fs.layout_launches["cluster"] == 3 and fs.launches["fused_sample"] == 2
    assert float((u - fs.philox_noise_plain(2**40 + 7, 3, 2000, 1.1, device=cuda)).abs().max()) <= 1e-6
    assert torch.equal(u_head, u[:, :300])
    assert torch.equal(x, back)


def test_cluster_inverse_plan_is_the_forwards(cuda):
    """The cluster inverse runs on the forward's plan (its shared memory is
    the library's cluster forward's and the mirror's), the card holds at
    least one of its clusters at every shape it is built for, and the
    route takes it exactly at uses_cluster's bf16 shapes that it is built
    for (CLUSTER_INVERSE) but ROWS_KEPT, and the library builds exactly
    relu with bf16 weights and CLUSTER_CASES' cases at each shape
    (dpfx_fused_sampler_cluster_built)."""
    from _torch_cluster_plan import cluster_plan

    lib = fs._cluster_lib()
    for h, nh1 in fs.CLUSTER_INVERSE:
        need = lib.dpfx_fused_sampler_cluster_smem_bytes(h, nh1)
        assert need == ft._cluster_lib().dpfx_fused_train_cluster_smem_bytes(h, nh1, 0)
        assert need == cluster_plan(h, nh1, False)[2] <= fs.SMEM_LIMIT
        assert fs._cluster_grid(h, nh1, cuda.index or 0) >= 1
    for h in fs.KERNEL_HIDDEN:
        for nh1 in range(6):
            want = (ft.uses_cluster(h, nh1, torch.bfloat16) and (h, nh1) not in fs.ROWS_KEPT
                    and (h, nh1) in fs.CLUSTER_INVERSE)
            assert fs.inverse_layout(h, nh1, torch.bfloat16) == ("cluster" if want else "rows")
            # the library builds exactly the cases the route's tables name
            for act, code in fs.ACT_CODES.items():
                for int8 in (False, True):
                    cases = fs.CLUSTER_CASES.get((h, nh1), ((), ()))
                    built = (h, nh1) in fs.CLUSTER_INVERSE and (
                        act in cases[int8] or (act == "relu" and not int8))
                    assert lib.dpfx_fused_sampler_cluster_built(h, nh1, code, int(int8)) == \
                        int(built), (h, nh1, act, int8)
                    if fs.inverse_layout(h, nh1, torch.bfloat16, act, int8) == "cluster":
                        assert built, (h, nh1, act, int8)


# the cluster inverse's other cases (fused_sampler.CLUSTER_CASES): at H=256
# with n_hidden 2 and 4 each other activation (one runtime instance) and
# the int8 mode with relu and with gelu; at H=128 the runtime instance with
# bf16 weights (n_hidden 3 and 4) and int8 ones (n_hidden 3), int8 relu
# (n_hidden 4)
OTHER_CASES = ([(256, nh, act, int8) for nh in (2, 4)
                for act, int8 in (("gelu", False), ("tanh", False), ("leaky_relu", False),
                                  ("relu", True), ("gelu", True))]
               + [(128, 3, "gelu", False), (128, 4, "tanh", False), (128, 3, "leaky_relu", True),
                  (128, 4, "relu", True)])


@pytest.mark.parametrize("hidden,n_hidden,activation,int8", OTHER_CASES)
def test_cluster_inverse_activations_and_int8_match_plain(cuda, every_cluster_shape, hidden,
                                                          n_hidden, activation, int8):
    """The cluster inverse with an activation other than relu, or with int8
    weights, at K=4, B=2, a ragged N: on the cluster layout, against the
    plain version (on the dequantized stacks for int8) by phase 2's bf16
    limits (max 5e-2, p99.9 2e-3), bit-identical from run to run, and the
    int8 mode equal, bit for bit, noise included, to the bf16 mode on the
    host-dequantized stacks on the same layout (the same plan and sum
    order; relu with bf16 weights taken onto the cluster at ROWS_KEPT)."""
    sp = _cluster_sp(hidden, n_hidden, cuda, seed=n_hidden + len(activation))
    assert fs.inverse_layout(hidden, n_hidden - 1, torch.bfloat16, activation, int8) == "cluster"
    q = fs.quantize_flow_params(sp) if int8 else None
    spd = sp
    if int8:
        dq = fs.dequantize(q)
        spd = sp._replace(wx=dq.wx, wh=dq.wh, wout=dq.wout)
    z = torch.randn((2, 16), generator=torch.Generator(device=cuda).manual_seed(9), device=cuda)
    kw = dict(dtype=torch.bfloat16, activation=activation, return_noise=True)
    fs.reset_launch_counts()
    x, u = fs.fused_sample_points(sp, z, 33, 777, quantized=q, **kw)
    x2, u2 = fs.fused_sample_points(sp, z, 33, 777, quantized=q, **kw)
    ref = fs.fused_inverse_transposed_plain(spd, u.transpose(1, 2).contiguous(),
                                            fs.z_projection(sp, z), torch.bfloat16,
                                            activation).transpose(1, 2)
    torch.cuda.synchronize()
    assert fs.layout_launches == {"rows": 0, "cluster": 2, "f32": 0}
    assert torch.equal(x, x2) and torch.equal(u, u2), "not bit-identical from run to run"
    e = (x - ref).abs().flatten()
    assert float((x - u).abs().max()) > 0.02                   # the flow moved the points
    assert float(e.max()) <= 5e-2 and float(torch.quantile(e, 0.999)) <= 2e-3, float(e.max())
    if int8:
        xd, ud = fs.fused_sample_points(spd, z, 33, 777, **kw)
        torch.cuda.synchronize()
        assert fs.layout_launches["cluster"] == 3
        assert torch.equal(x, xd) and torch.equal(u, ud)


def test_f32_sampler_h256_held_to_f64(cuda):
    """The streamed f32 inverse at H=256 (n_hidden 2 and 4), K=8, against
    the plain version run in f64 by phase 3f's rule for an f32 forward: its
    max abs error within 1e-4 or 4x the f32 plain version's own; launched
    on the f32 layout."""
    for n_hidden in (2, 4):
        sp = _cluster_sp(256, n_hidden, cuda, k=8, seed=n_hidden)
        g = torch.Generator(device=cuda).manual_seed(n_hidden)
        ut = torch.randn((2, 3, 1000), generator=g, device=cuda)
        z = torch.randn((2, 16), generator=g, device=cuda)
        hz = fs.z_projection(sp, z)
        fs.reset_launch_counts()
        x = fs.fused_inverse_transposed(sp, ut, z, dtype=torch.float32)
        xp = fs.fused_inverse_transposed_plain(sp, ut, hz, torch.float32)
        sp64 = sp._replace(**{kk: v.double() for kk, v in sp._asdict().items() if torch.is_tensor(v)})
        x64 = fs.fused_inverse_transposed_plain(sp64, ut.double(), hz.double(), torch.float64)
        torch.cuda.synchronize()
        assert fs.layout_launches["f32"] == 1
        kern, drift = float((x.double() - x64).abs().max()), float((xp.double() - x64).abs().max())
        assert kern <= max(1e-4, 4 * drift), (n_hidden, kern, drift)


def test_fused_sample_noise_is_philox_noise_plain(cuda):
    """The kernel's base noise is philox_noise_plain's stream: the integer
    rounds are exact, logf and cosf a few ulps apart at most."""
    sp = _sp(32, 2, "relu", cuda)
    z = torch.randn((5, 16), device=cuda)
    for seed, n, tau in ((7, 3000, 1.1), (2**40 + 3, 129, 1.0)):
        _, u = fs.fused_sample_points(sp, z, seed, n, noise_scale=tau, return_noise=True)
        torch.cuda.synchronize()
        assert float((u.cpu() - fs.philox_noise_plain(seed, 5, n, tau)).abs().max()) <= 1e-6
        assert float((u - fs.philox_noise_plain(seed, 5, n, tau, device=cuda)).abs().max()) <= 1e-6


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

def _flow_weights(hidden, n_hidden, dev, k=5, seed=0, scale=0.1):
    # the module's own init under a generator of its own, seeded: a case's
    # weights do not depend on the tests that ran before it
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        flow = CouplingFlow(3, k, hidden, n_hidden, cond_dim=16, scale_cap=3.0)
    with torch.no_grad():
        return fs.stack_point_flow_params(randomize_(flow, seed, scale).to(dev))


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-12))


def _gates_within_rounding(w64, u64, hz64):
    """(layer k, level j, cloud, unit, point) of every relu gate of the
    backward's recompute, on the layer inputs rebuilt from u in f64, whose
    pre-activation lies within f32 rounding of 0: |pre| at most n 2^-24
    sum |terms| over its n terms (chip_smoke.py's flippable_gates rule); an
    f32 order may put such a gate on either side."""
    wx, wh, bh, wout, bout, masks, cap = w64
    y, gates = u64, []

    def near(k, j, pre, mag, n):
        idx = ((mag > 0) & (pre.abs() <= n * 2.0 ** -24 * mag)).nonzero().tolist()
        gates.extend((k, j, *i) for i in idx)
        return torch.relu(pre)

    for k in reversed(range(wx.shape[0])):
        h = near(k, 0, torch.einsum("hc,bcn->bhn", wx[k], y) + hz64[:, k, :, None],
                 torch.einsum("hc,bcn->bhn", wx[k].abs(), y.abs()) + hz64[:, k, :, None].abs(), 4)
        for j in range(wh.shape[1]):
            h = near(k, j + 1, torch.einsum("oi,bin->bon", wh[k, j], h) + bh[k, j][:, None],
                     torch.einsum("oi,bin->bon", wh[k, j].abs(), h) + bh[k, j].abs()[:, None],
                     wh.shape[-1] + 1)
        st = torch.einsum("rh,bhn->brn", wout[k], h) + bout[k][:, None]
        s = cap * torch.tanh(st[:, :3] / cap)
        y = torch.where(masks[k][:, None] > 0, y, (y - st[:, 3:]) * torch.exp(-s))
    return gates


def _plain64(w64, u, hz, du, dld, gate=None):
    """The plain backward in f64 from u; with ``gate`` (k, j, cloud, unit,
    point) that relu gate of layer k's level j on its other side (a value
    within rounding of 0 either way)."""
    chain = ft._hidden_chain

    def flipped(wx, wh, bh, hz_, k, x, dtype):
        hs = chain(wx, wh, bh, hz_, k, x, dtype)
        if gate is not None and k == gate[0]:
            h = hs[gate[1]].clone()
            h[gate[2:]] = 0.0 if h[gate[2:]] > 0 else 1e-300
            hs[gate[1]] = h
        return hs

    ft._hidden_chain = flipped
    try:
        return ft.fused_backward_plain(*w64, u.double(), hz.double(), du.double(), dld.double(),
                                       torch.float64)
    finally:
        ft._hidden_chain = chain


def _assert_f64_held(w, u, hz, du, dld, got, plain, tol=1e-4):
    """An f32 backward's outputs ``got`` against the f64 run of the plain
    backward from u by chip_smoke.py's f64_held rule: per output, the
    relative norm error within ``tol`` or 4x the f32 plain version's
    (``plain``) own drift from the f64 run, whichever is larger. A relu
    gate within f32 rounding of 0 may fall on either side in an f32 order,
    and one such flip moves the gradients in a step far above rounding
    (PERF.md). The flow acts on each point alone, so a gate that the
    kernel's recompute put on the other side moves dx at its own point
    only: where the f64 run misses the limits, the f64 run with one gate
    within rounding of 0 at the point where the kernel's dx parts most from
    the f64 run's, put on its other side, must meet the same limits."""
    w64 = tuple(t.double() if torch.is_tensor(t) else t for t in w)
    names = ["dx", "dhz", "dwx", "dwh", "dbh", "dwout", "dbout"]
    rel64 = lambda a, b: float((a.double() - b).norm() / b.norm().clamp_min(1e-300))  # noqa: E731
    ref64 = _plain64(w64, u, hz, du, dld)
    limits = [max(tol, 4 * rel64(r, r64)) if r64.numel() else 0.0 for r, r64 in zip(plain, ref64)]

    def misses(ref):
        return {nm: (rel64(a, r), lim) for nm, a, r, lim in zip(names, got, ref, limits)
                if r.numel() and rel64(a, r) > lim}

    bad = misses(ref64)
    if not bad:
        return
    err = (got[0].double() - ref64[0]).norm(dim=1)          # [B, N]: dx's error a point
    cloud, point = divmod(int(err.argmax()), err.shape[1])
    gates = [gt for gt in _gates_within_rounding(w64, u.double(), hz.double())
             if (gt[2], gt[4]) == (cloud, point)]
    for gate in gates:
        if not misses(_plain64(w64, u, hz, du, dld, gate)):
            return
    raise AssertionError(f"(error, limit) against the f64 run {bad}, and no single flip of the "
                         f"{len(gates)} relu gates within f32 rounding of 0 at the point where "
                         f"dx parts most from it (cloud {cloud}, point {point}) meets the limits")


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
    # f32: IEEE sums in other orders, held to the f64 run by chip_smoke.py's
    # f64_held rule; bf16: a flipped rounding of one hidden unit moves a
    # value by ~1e-3 and the layers carry it on
    f32 = dt == torch.float32
    torch.testing.assert_close(u, u_p, atol=1e-4 if f32 else 5e-2, rtol=1e-4 if f32 else 2e-2)
    torch.testing.assert_close(ld, ld_p, atol=1e-3 if f32 else 1e-1, rtol=1e-4 if f32 else 2e-2)
    for name, a, b, c in zip(["dx", "dhz", "dwx", "dwh", "dbh", "dwout", "dbout"], got, ref,
                             again):
        assert torch.equal(a, c), f"{name} is not bit-identical from run to run"
        if b.numel() and not f32:
            assert _rel(a, b) <= 2e-2, f"{name}: {_rel(a, b)}"
    if f32:
        _assert_f64_held(w, u_p, hz, du, dld, got, ref)


# the bf16 kernels' shapes: every H, n_hidden - 1 from 0 to the backward's
# limit (8, 3, 1, 0 at H = 32, 64, 128, 256), ragged N (130, 200, 2000), N
# below one tile (77), one cloud; scale 0.02 at H=256 (see _sp)
BF16_SHAPES = [(32, 1, 130, 3), (32, 9, 200, 2), (64, 2, 77, 1), (64, 4, 2000, 2),
               (128, 1, 200, 3), (128, 2, 2000, 1), (128, 2, 130, 4), (256, 1, 200, 2)]


@pytest.mark.parametrize("hidden,n_hidden,n,b", BF16_SHAPES)
def test_fused_train_bf16_shapes_match_plain(cuda, hidden, n_hidden, n, b):
    from dpfx_torch.ops import fused_train as ft
    from dpfx_torch.ops.fused_sampler import z_projection

    dt = torch.bfloat16
    sp = _flow_weights(hidden, n_hidden, cuda, scale=0.02 if hidden == 256 else 0.1)
    w = (sp.wx, sp.wh, sp.bh, sp.wout, sp.bout, sp.masks, sp.scale_cap)
    g = torch.Generator(device=cuda).manual_seed(2)
    xt = torch.randn((b, 3, n), generator=g, device=cuda)
    hz = z_projection(sp, torch.randn((b, 16), generator=g, device=cuda))
    u, ld = ft.fused_forward_kernel(*w, xt, hz, dt)
    u_p, ld_p = ft.fused_forward_plain(*w, xt, hz, dt)
    du = torch.randn(u.shape, generator=g, device=cuda)
    dld = torch.randn(ld.shape, generator=g, device=cuda)
    got = ft.fused_backward_kernel(*w, u_p, hz, du, dld, dt)
    again = ft.fused_backward_kernel(*w, u_p, hz, du, dld, dt)
    ref = ft.fused_backward_plain(*w, u_p, hz, du, dld, dt)
    torch.cuda.synchronize()
    # a flipped bf16 rounding of one hidden unit moves a value by ~1e-3 and
    # the layers carry it on (the limits of test_fused_train_kernels_match_plain)
    torch.testing.assert_close(u, u_p, atol=5e-2, rtol=2e-2)
    torch.testing.assert_close(ld, ld_p, atol=1e-1, rtol=2e-2)
    for name, a, r, c in zip(["dx", "dhz", "dwx", "dwh", "dbh", "dwout", "dbout"], got, ref,
                             again):
        assert torch.equal(a, c), f"{name} is not bit-identical from run to run"
        assert bool(torch.isfinite(a).all()), name
        if r.numel():
            assert _rel(a, r) <= 2e-2, f"{name}: {_rel(a, r)}"


@pytest.mark.parametrize("hidden,n_hidden,n", [(32, 3, 200), (128, 2, 2000), (128, 2, 77),
                                               (64, 1, 130)])
def test_fused_train_bf16_backward_rebuilds_the_forward_input(cuda, hidden, n_hidden, n):
    """The backward recomputes each layer's conditioner with the forward's
    own device code, so its (s, t) are the forward's bit for bit. With the
    first K-1 couplings the identity (Wout, bout zero) and the coordinates
    that the last coupling transforms set to 0, the forward gives
    u = 0 * exp(s) + t = t exactly, and the input that the backward
    rebuilds of layer K-1, (u - t') / exp(s'), is exactly the forward's
    input if and only if t' = t."""
    from dpfx_torch.ops import fused_train as ft
    from dpfx_torch.ops.fused_sampler import z_projection

    dt = torch.bfloat16
    sp = _flow_weights(hidden, n_hidden, cuda, k=4)
    wout, bout = sp.wout.clone(), sp.bout.clone()
    wout[:-1] = 0.0
    bout[:-1] = 0.0
    w = (sp.wx, sp.wh, sp.bh, wout, bout, sp.masks, sp.scale_cap)
    g = torch.Generator(device=cuda).manual_seed(3)
    xt = torch.randn((2, 3, n), generator=g, device=cuda)
    xt[:, sp.masks[-1] == 0] = 0.0
    hz = z_projection(sp, torch.randn((2, 16), generator=g, device=cuda))
    u, _ = ft.fused_forward_kernel(*w, xt, hz, dt)
    moved = u[:, sp.masks[-1] == 0]
    assert float(moved.abs().min()) > 0.0, "the last coupling must move every point"
    rebuilt, *_ = ft._backward_call(*w, u, hz, torch.zeros_like(u), torch.zeros(2, device=cuda),
                                    dt)
    torch.cuda.synchronize()
    assert torch.equal(rebuilt, xt)


@pytest.mark.parametrize("hidden,n_hidden,n", [(128, 4, 200), (256, 2, 130), (256, 3, 130)])
def test_fused_train_bf16_forward_with_one_weight_stage_matches_plain(cuda, hidden, n_hidden, n):
    """Forwards whose shared memory holds one layer's weights and not two
    (the cluster layout at H=128 with n_hidden 4 and at H=256 with
    n_hidden 3), so they load each layer's stage between two barriers
    instead of one layer ahead; and H=256 with n_hidden 2, which had one
    stage before the cluster layout and has two in it."""
    from dpfx_torch.ops import fused_train as ft
    from dpfx_torch.ops.fused_sampler import z_projection

    dt = torch.bfloat16
    sp = _flow_weights(hidden, n_hidden, cuda, k=4, scale=0.02 if hidden == 256 else 0.1)
    w = (sp.wx, sp.wh, sp.bh, sp.wout, sp.bout, sp.masks, sp.scale_cap)
    g = torch.Generator(device=cuda).manual_seed(4)
    xt = torch.randn((2, 3, n), generator=g, device=cuda)
    hz = z_projection(sp, torch.randn((2, 16), generator=g, device=cuda))
    u, ld = ft.fused_forward_kernel(*w, xt, hz, dt)
    u_p, ld_p = ft.fused_forward_plain(*w, xt, hz, dt)
    torch.cuda.synchronize()
    torch.testing.assert_close(u, u_p, atol=5e-2, rtol=2e-2)
    torch.testing.assert_close(ld, ld_p, atol=1e-1, rtol=2e-2)


# (128, 3) and (256, 2) raised here until a layout past the mma one took
# them: they are cases of test_fused_train_stream_layout_matches_plain now;
# bf16 H=128 past n_hidden 4 has no layout (the training predicate stops at 4)
@pytest.mark.parametrize("hidden,n_hidden", [(32, 10), (64, 5), (128, 5)])
def test_fused_train_bf16_backward_beyond_its_shared_memory_raises(cuda, hidden, n_hidden):
    from dpfx_torch.ops import fused_train as ft

    sp = _flow_weights(hidden, n_hidden, cuda, k=2)
    w = (sp.wx, sp.wh, sp.bh, sp.wout, sp.bout, sp.masks, sp.scale_cap)
    u = torch.zeros((1, 3, 64), device=cuda)
    hz = torch.zeros((1, 2, hidden), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ft.fused_backward_kernel(*w, u, hz, u, torch.zeros(1, device=cuda), torch.bfloat16)


# the shapes past the mma or block-wide layout of the forward or the
# backward (fused_train.overflows_block: the cluster layout in bf16, the f32
# layout in f32), one shape the parent layouts still take at H=256 (bf16,
# n_hidden 1: f32 overflows), and padded widths (48 -> 64, 96 -> 128: the
# parent layouts; 192 -> 256: the cluster or f32 layout); ragged N, N below
# a tile, one cloud
STREAM_CASES = [(128, 3, 300, 3), (128, 4, 130, 2), (256, 1, 200, 2), (256, 2, 2000, 1),
                (256, 3, 77, 2), (256, 4, 300, 1), (48, 3, 200, 2), (96, 2, 130, 2),
                (192, 2, 200, 2)]


@pytest.mark.parametrize("hidden,n_hidden,n,b", STREAM_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_train_stream_layout_matches_plain(cuda, hidden, n_hidden, n, b, dtype):
    """Forward (u, log-det) and backward (every gradient) on the layout the
    wrapper picks, against the plain versions at the limits of
    test_fused_train_kernels_match_plain (the f32 backward against the
    plain version run in f64); the backward bit-identical from run to run.
    The layout is the cluster (bf16) or f32 one exactly where the others
    overflow."""
    from dpfx_torch.ops import fused_train as ft
    from dpfx_torch.ops.fused_sampler import z_projection

    dt = getattr(torch, dtype)
    sp = _flow_weights(hidden, n_hidden, cuda, k=4, scale=0.02 if hidden > 128 else 0.1)
    h, nh1 = sp.wx.shape[1], sp.wh.shape[1]
    assert h == fs.kernel_hidden(hidden)
    overflow = (h == 128 and nh1 >= 2) or (h == 256 and (nh1 >= 1 or dt == torch.float32))
    assert ft.overflows_block(h, nh1, dt) == overflow
    w = (sp.wx, sp.wh, sp.bh, sp.wout, sp.bout, sp.masks, sp.scale_cap)
    g = torch.Generator(device=cuda).manual_seed(5)
    xt = torch.randn((b, 3, n), generator=g, device=cuda)
    hz = z_projection(sp, torch.randn((b, 16), generator=g, device=cuda))
    ft.reset_launch_counts()
    u, ld = ft.fused_forward_kernel(*w, xt, hz, dt)
    u_p, ld_p = ft.fused_forward_plain(*w, xt, hz, dt)
    du = torch.randn(u.shape, generator=g, device=cuda)
    dld = torch.randn(ld.shape, generator=g, device=cuda)
    got = ft.fused_backward_kernel(*w, u_p, hz, du, dld, dt)
    again = ft.fused_backward_kernel(*w, u_p, hz, du, dld, dt)
    f32 = dt == torch.float32
    ref = ft.fused_backward_plain(*w, u_p, hz, du, dld, dt)
    torch.cuda.synchronize()
    assert ft.launches == {"fused_train_fwd": 1, "fused_train_bwd": 2}
    torch.testing.assert_close(u, u_p, atol=1e-4 if f32 else 5e-2, rtol=1e-4 if f32 else 2e-2)
    torch.testing.assert_close(ld, ld_p, atol=1e-3 if f32 else 1e-1, rtol=1e-4 if f32 else 2e-2)
    for name, a, r, c in zip(["dx", "dhz", "dwx", "dwh", "dbh", "dwout", "dbout"], got, ref,
                             again):
        assert torch.equal(a, c), f"{name} is not bit-identical from run to run"
        assert bool(torch.isfinite(a).all()), name
        if r.numel() and not f32:
            assert _rel(a, r) <= 2e-2, f"{name}: {_rel(a, r)}"
    if f32:
        # on some weights the plain version's own f32 sums part from its
        # f64 run by ~1e-3 of a gradient's norm where the kernel's stay
        # within ~5e-6 of it, so the f32 kernel is held to the f64 run by
        # chip_smoke.py's f64_held rule
        _assert_f64_held(w, u_p, hz, du, dld, got, ref)


@pytest.mark.parametrize("hidden,n_hidden,dtype", [(256, 2, "bfloat16"), (128, 3, "bfloat16"),
                                                   (256, 4, "bfloat16"), (256, 1, "float32")])
def test_fused_train_stream_backward_rebuilds_the_forward_input(cuda, hidden, n_hidden, dtype):
    """The layout past the mma and block-wide ones (the cluster layout in
    bf16, on the ring at H=256 with n_hidden 4; the f32 layout in f32): its
    forward and its backward's
    recompute run the same device code with per-element sums that do not
    depend on the tile, so the rebuilt input is the forward's bit for bit
    (the construction of test_fused_train_bf16_backward_rebuilds_the_forward_input)."""
    from dpfx_torch.ops import fused_train as ft
    from dpfx_torch.ops.fused_sampler import z_projection

    dt = getattr(torch, dtype)
    sp = _flow_weights(hidden, n_hidden, cuda, k=4, scale=0.02)
    assert ft.overflows_block(sp.wx.shape[1], sp.wh.shape[1], dt)
    wout, bout = sp.wout.clone(), sp.bout.clone()
    wout[:-1] = 0.0
    bout[:-1] = 0.0
    w = (sp.wx, sp.wh, sp.bh, wout, bout, sp.masks, sp.scale_cap)
    g = torch.Generator(device=cuda).manual_seed(6)
    xt = torch.randn((2, 3, 300), generator=g, device=cuda)
    xt[:, sp.masks[-1] == 0] = 0.0
    hz = z_projection(sp, torch.randn((2, 16), generator=g, device=cuda))
    u, _ = ft.fused_forward_kernel(*w, xt, hz, dt)
    assert float(u[:, sp.masks[-1] == 0].abs().min()) > 0.0, "the last coupling moves every point"
    rebuilt, *_ = ft._backward_call(*w, u, hz, torch.zeros_like(u), torch.zeros(2, device=cuda), dt)
    torch.cuda.synchronize()
    assert torch.equal(rebuilt, xt)


# the f32 layout's shapes (csrc/flow_f32.cuh: H=256 with n_hidden 1-4,
# H=128 with n_hidden 1-4, the padded 192 -> 256), ragged N, N below a tile
# and one cloud
F32_CASES = [(256, 1, 200, 2), (256, 2, 2000, 1), (256, 3, 300, 2), (256, 4, 64, 2),
             (128, 1, 129, 2), (128, 2, 300, 3), (128, 3, 77, 2), (128, 4, 130, 1),
             (192, 2, 100, 2)]


@pytest.mark.parametrize("hidden,n_hidden,n,b", F32_CASES)
def test_fused_train_f32_layout_matches_plain(cuda, hidden, n_hidden, n, b):
    """fwd_f32 and bwd_f32 at K=4: u and the log-det against the plain
    version at test_fused_train_kernels_match_plain's f32 limits, every
    gradient against the f64 run by chip_smoke.py's f64_held rule; forward
    and backward bit-identical from run to run; every launch counted on the
    f32 layout."""
    f32 = torch.float32
    sp = _flow_weights(hidden, n_hidden, cuda, k=4, seed=hidden + n_hidden,
                       scale=0.02 * (128 / max(hidden, 128)) ** 0.5)
    h, nh1 = sp.wx.shape[1], sp.wh.shape[1]
    lay = "f32"
    assert ft._layout(h, nh1, f32, False) == ft._layout(h, nh1, f32, True) == lay
    w = (sp.wx, sp.wh, sp.bh, sp.wout, sp.bout, sp.masks, sp.scale_cap)
    g = torch.Generator(device=cuda).manual_seed(12)
    xt = torch.randn((b, 3, n), generator=g, device=cuda)
    hz = fs.z_projection(sp, torch.randn((b, 16), generator=g, device=cuda))
    ft.reset_launch_counts()
    u, ld = ft.fused_forward_kernel(*w, xt, hz, f32)
    u2, ld2 = ft.fused_forward_kernel(*w, xt, hz, f32)
    u_p, ld_p = ft.fused_forward_plain(*w, xt, hz, f32)
    du = torch.randn(u.shape, generator=g, device=cuda)
    dld = torch.randn(ld.shape, generator=g, device=cuda)
    got = ft.fused_backward_kernel(*w, u_p, hz, du, dld, f32)
    again = ft.fused_backward_kernel(*w, u_p, hz, du, dld, f32)
    ref = ft.fused_backward_plain(*w, u_p, hz, du, dld, f32)
    torch.cuda.synchronize()
    assert ft.layout_launches[f"{lay}_fwd"] == 2 and ft.layout_launches[f"{lay}_bwd"] == 2
    assert sum(ft.layout_launches.values()) == 4
    assert torch.equal(u, u2) and torch.equal(ld, ld2), "the forward is not bit-identical"
    torch.testing.assert_close(u, u_p, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ld, ld_p, atol=1e-3, rtol=1e-4)
    for name, a, c in zip(["dx", "dhz", "dwx", "dwh", "dbh", "dwout", "dbout"], got, again):
        assert torch.equal(a, c), f"{name} is not bit-identical from run to run"
        assert bool(torch.isfinite(a).all()), name
    _assert_f64_held(w, u_p, hz, du, dld, got, ref)


@pytest.mark.parametrize("hidden,n_hidden", [(256, 2), (256, 4), (128, 2), (128, 3)])
def test_fused_train_f32_backward_rebuilds_the_forward_input(cuda, hidden, n_hidden):
    """The f32 layout's backward recomputes each conditioner on the
    forward's device code (first_layer_f32, chunk_fma, st_f32's (s, t)
    code), whose
    per-element sums do not depend on the tile (128 points forward, 32-128
    backward), so the rebuilt input is the forward's bit for bit (the
    construction of test_fused_train_stream_backward_rebuilds_the_forward_input)."""
    f32 = torch.float32
    sp = _flow_weights(hidden, n_hidden, cuda, k=4, seed=3, scale=0.02)
    assert ft._layout(sp.wx.shape[1], sp.wh.shape[1], f32, True) == "f32"
    wout, bout = sp.wout.clone(), sp.bout.clone()
    wout[:-1] = 0.0
    bout[:-1] = 0.0
    w = (sp.wx, sp.wh, sp.bh, wout, bout, sp.masks, sp.scale_cap)
    g = torch.Generator(device=cuda).manual_seed(6)
    xt = torch.randn((2, 3, 300), generator=g, device=cuda)
    xt[:, sp.masks[-1] == 0] = 0.0
    hz = fs.z_projection(sp, torch.randn((2, 16), generator=g, device=cuda))
    u, _ = ft.fused_forward_kernel(*w, xt, hz, f32)
    assert float(u[:, sp.masks[-1] == 0].abs().min()) > 0.0, "the last coupling moves every point"
    rebuilt, *_ = ft._backward_call(*w, u, hz, torch.zeros_like(u), torch.zeros(2, device=cuda),
                                    f32)
    torch.cuda.synchronize()
    assert torch.equal(rebuilt, xt)


@pytest.mark.parametrize("hidden,n_hidden", [(256, 2), (256, 3), (128, 2)])
def test_f32_forward_round_trips_through_the_f32_sampler(cuda, hidden, n_hidden):
    """fwd_f32 walks flow_f32.cuh's layers forwards and the sampler's
    f32_kernel backwards on the same device code: on the same hz they
    compute the same (s, t) bits, and x comes back up to the f32 rounding
    of the affine update (median 1e-6, max 1e-4 at K=8)."""
    f32 = torch.float32
    sp = _flow_weights(hidden, n_hidden, cuda, k=8, seed=4, scale=0.02 * (128 / hidden) ** 0.5)
    g = torch.Generator(device=cuda).manual_seed(4)
    xt = torch.randn((2, 3, 500), generator=g, device=cuda)
    z = torch.randn((2, 16), generator=g, device=cuda)
    u, _ = ft.fused_forward_kernel(sp.wx, sp.wh, sp.bh, sp.wout, sp.bout, sp.masks, sp.scale_cap,
                                   xt, fs.z_projection(sp, z), f32)
    fs.reset_launch_counts()
    back = fs.fused_inverse_transposed(sp, u, z, dtype=f32)
    torch.cuda.synchronize()
    assert fs.layout_launches["f32"] == 1
    e = (back - xt).abs().flatten()
    assert float(e.median()) <= 1e-6 and float(e.max()) <= 1e-4, (float(e.median()), float(e.max()))


def test_f32_plan_mirror_matches_kernel(cuda):
    """The CPU tests' copy of the f32 layout's carve-ups
    (tests/_torch_f32_plan.py) is the library's F32Smem and F32BwdSmem: bytes
    and points a block or tile, forward and backward, and each layer's
    partial row, at every depth of both widths; and the mirror's domain is
    ``uses_f32``, whose shapes the route sends to the f32 layout, at every
    kernel width and depth 1-6."""
    from _torch_f32_plan import f32_bwd_plan, f32_domain, f32_fwd_smem, f32_part_row

    lib = ft._f32_lib()
    for h in (128, 256):
        for nh1 in range(4):
            t, need = f32_bwd_plan(h, nh1)
            assert lib.dpfx_fused_train_f32_smem_bytes(h, nh1, 1) == need, (h, nh1)
            assert lib.dpfx_fused_train_f32_tile_points(h, nh1, 1) == t, (h, nh1)
            assert lib.dpfx_fused_train_f32_smem_bytes(h, nh1, 0) == f32_fwd_smem(h), (h, nh1)
            assert lib.dpfx_fused_train_f32_tile_points(h, nh1, 0) == 128
            assert lib.dpfx_fused_train_f32_part_row(h, nh1) == f32_part_row(h, nh1), (h, nh1)
    for h in fs.KERNEL_HIDDEN:
        for nh1 in range(6):
            assert ft.uses_f32(h, nh1, torch.float32) == f32_domain(h, nh1), (h, nh1)
            if f32_domain(h, nh1):
                assert ft._layout(h, nh1, torch.float32, True) == "f32", (h, nh1)


def test_stream_smem_mirror_matches_kernel(cuda):
    """The stream layout is retired: the library has none of its entry
    points, and every shape it took (bf16 past the mma layout at the wide
    widths) has a cluster plan whose bytes, points per tile and partial row
    are the mirror's, at 64 points or more a tile."""
    from _torch_cluster_plan import cluster_part_row, cluster_plan

    from dpfx_torch.ops import fused_train as ft

    lib = ft._cluster_lib()
    assert not any(hasattr(lib, f"dpfx_fused_train_stream_{e}")
                   for e in ("fwd", "bwd", "smem_bytes", "tile_points"))
    for h in ft.WIDE_HIDDEN:
        for nh1 in range(ft.MAX_N_HIDDEN):
            if not ft.overflows_block(h, nh1, torch.bfloat16):
                continue
            assert ft._layout(h, nh1, torch.bfloat16, True) == "cluster", (h, nh1)
            assert lib.dpfx_fused_train_cluster_part_row(h, nh1) == cluster_part_row(h, nh1)
            for bwd in (False, True):
                t, _, need = cluster_plan(h, nh1, bwd)
                assert t >= 64 and need <= ft.SMEM_LIMIT, (h, nh1, bwd)
                assert lib.dpfx_fused_train_cluster_tile_points(h, nh1, int(bwd)) == t


def test_cluster_plan_mirror_matches_kernel(cuda):
    """The CPU tests' copy of the cluster layout's plan
    (tests/_torch_cluster_plan.py) is the library's ClusterPlan: its bytes
    and points per tile, forward and backward, at every depth of both
    widths (the shapes it does not take included: their sizes are what
    keeps them off it), and each partial row of the shapes it takes; and
    the mirror's domain is ``uses_cluster`` at every kernel width and depth
    1-6 in both dtypes."""
    from _torch_cluster_plan import cluster_domain, cluster_part_row, cluster_plan

    from dpfx_torch.ops import fused_train as ft

    lib = ft._cluster_lib()
    for h in (128, 256):
        for nh1 in range(1, 5):
            for bwd in (False, True):
                t, _, need = cluster_plan(h, nh1, bwd)
                assert lib.dpfx_fused_train_cluster_smem_bytes(h, nh1, int(bwd)) == need, (h, nh1)
                assert lib.dpfx_fused_train_cluster_tile_points(h, nh1, int(bwd)) == t, (h, nh1)
            if cluster_domain(h, nh1, torch.bfloat16):
                assert lib.dpfx_fused_train_cluster_part_row(h, nh1) == cluster_part_row(h, nh1)
    for h in (32, 64, 128, 256):
        for nh1 in range(6):
            for dt in (torch.float32, torch.bfloat16):
                assert ft.uses_cluster(h, nh1, dt) == cluster_domain(h, nh1, dt), (h, nh1, dt)


# the cluster layout's shapes (H, n_hidden), padded widths among them
# (192 -> 256, 96 -> 128), ragged N and N below a tile; and the walks
# (H=256 with n_hidden 3-4, H=128 with n_hidden 4) with more tiles than the
# grid has clusters, so that dWh adds into the slices across tiles
CLUSTER_CASES = [(128, 3, 300, 3), (128, 4, 130, 2), (256, 2, 2000, 1), (256, 3, 77, 2),
                 (192, 2, 200, 2), (96, 4, 64, 2), (256, 4, 300, 1), (256, 3, 2000, 2),
                 (256, 4, 2000, 2), (128, 4, 2048, 5)]


@pytest.mark.parametrize("hidden,n_hidden,n,b", CLUSTER_CASES)
def test_fused_train_cluster_matches_plain(cuda, hidden, n_hidden, n, b):
    """The cluster layout's forward and backward at K=4 against the plain
    versions at the bf16 limits of test_fused_train_kernels_match_plain
    (on the ring dWh summed tile by tile in the cluster's slice); forward and
    backward bit-identical from run to run; each launch counted once."""
    from dpfx_torch.ops import fused_train as ft
    from dpfx_torch.ops.fused_sampler import z_projection

    dt = torch.bfloat16
    sp = _flow_weights(hidden, n_hidden, cuda, k=4, scale=0.02 * (128 / max(hidden, 128)) ** 0.5)
    h, nh1 = sp.wx.shape[1], sp.wh.shape[1]
    assert ft.uses_cluster(h, nh1, dt) and ft._layout(h, nh1, dt, True) == "cluster"
    w = (sp.wx, sp.wh, sp.bh, sp.wout, sp.bout, sp.masks, sp.scale_cap)
    g = torch.Generator(device=cuda).manual_seed(9)
    xt = torch.randn((b, 3, n), generator=g, device=cuda)
    hz = z_projection(sp, torch.randn((b, 16), generator=g, device=cuda))
    ft.reset_launch_counts()
    u, ld = ft.fused_forward_kernel(*w, xt, hz, dt)
    u2, ld2 = ft.fused_forward_kernel(*w, xt, hz, dt)
    u_p, ld_p = ft.fused_forward_plain(*w, xt, hz, dt)
    du = torch.randn(u.shape, generator=g, device=cuda)
    dld = torch.randn(ld.shape, generator=g, device=cuda)
    got = ft.fused_backward_kernel(*w, u_p, hz, du, dld, dt)
    again = ft.fused_backward_kernel(*w, u_p, hz, du, dld, dt)
    ref = ft.fused_backward_plain(*w, u_p, hz, du, dld, dt)
    torch.cuda.synchronize()
    assert ft.launches == {"fused_train_fwd": 2, "fused_train_bwd": 2}
    assert ft.layout_launches["cluster_fwd"] == 2 and ft.layout_launches["cluster_bwd"] == 2
    assert sum(ft.layout_launches.values()) == 4
    assert torch.equal(u, u2) and torch.equal(ld, ld2), "the forward is not bit-identical"
    torch.testing.assert_close(u, u_p, atol=5e-2, rtol=2e-2)
    torch.testing.assert_close(ld, ld_p, atol=1e-1, rtol=2e-2)
    for name, a, r, c in zip(["dx", "dhz", "dwx", "dwh", "dbh", "dwout", "dbout"], got, ref,
                             again):
        assert torch.equal(a, c), f"{name} is not bit-identical from run to run"
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, r) <= 2e-2, f"{name}: {_rel(a, r)}"


def test_layout_depths_match_the_library(cuda):
    """fused_train.LAYOUT_N_HIDDEN, which lets the predicate take n_hidden
    past 4, is the deepest conditioner whose mma (bf16) or block-wide (f32)
    layouts fit the forward and the backward at each kernel width, by the
    library's smem_bytes."""
    from dpfx_torch.ops import fused_train as ft

    for dname, table in ft.LAYOUT_N_HIDDEN.items():
        dt = getattr(torch, dname)
        for h, deepest in table.items():
            fits = [nh for nh in range(1, 24) if not ft.overflows_block(h, nh - 1, dt)]
            assert fits == list(range(1, deepest + 1)), (dname, h, fits)


@pytest.mark.parametrize("hidden,n_hidden", [(32, 17), (64, 5)])
def test_fused_train_f32_deep_conditioners_match_plain(cuda, hidden, n_hidden):
    """n_hidden past 4 on the block-wide f32 layouts, which the predicate
    takes: forward and backward against the plain versions at
    test_fused_train_kernels_match_plain's f32 limits, the backward
    bit-identical from run to run."""
    from dpfx_torch.ops import fused_train as ft
    from dpfx_torch.ops.fused_sampler import z_projection

    dt = torch.float32
    sp = _flow_weights(hidden, n_hidden, cuda, k=4)
    assert not ft.overflows_block(hidden, n_hidden - 1, dt)
    w = (sp.wx, sp.wh, sp.bh, sp.wout, sp.bout, sp.masks, sp.scale_cap)
    g = torch.Generator(device=cuda).manual_seed(8)
    xt = torch.randn((2, 3, 200), generator=g, device=cuda)
    hz = z_projection(sp, torch.randn((2, 16), generator=g, device=cuda))
    u, ld = ft.fused_forward_kernel(*w, xt, hz, dt)
    u_p, ld_p = ft.fused_forward_plain(*w, xt, hz, dt)
    du = torch.randn(u.shape, generator=g, device=cuda)
    dld = torch.randn(ld.shape, generator=g, device=cuda)
    got = ft.fused_backward_kernel(*w, u_p, hz, du, dld, dt)
    again = ft.fused_backward_kernel(*w, u_p, hz, du, dld, dt)
    ref = ft.fused_backward_plain(*w, u_p, hz, du, dld, dt)
    torch.cuda.synchronize()
    torch.testing.assert_close(u, u_p, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ld, ld_p, atol=1e-3, rtol=1e-4)
    for name, a, c in zip(["dx", "dhz", "dwx", "dwh", "dbh", "dwout", "dbout"], got, again):
        assert torch.equal(a, c), f"{name} is not bit-identical from run to run"
    _assert_f64_held(w, u_p, hz, du, dld, got, ref)


@pytest.mark.parametrize("hidden,n_hidden", [(48, 1), (96, 2), (192, 3), (256, 4), (256, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_inverse_padded_widths_match_plain(cuda, hidden, n_hidden, dtype):
    """The sampler's inverse on stacks padded up to the kernel's widths, and
    f32 at H=256 (Wh streamed in chunks of 32 input columns), against the
    plain version at test_fused_inverse_matches_plain's limits; twice
    bit-identical; the int8 mode equals the dequantized stacks bit for bit
    (both on the route's layout, the same for both modes: the cluster
    inverse at (192, 3) and (256, 4) in bf16)."""
    dt = getattr(torch, dtype)
    sp = _sp(hidden, n_hidden, "relu", cuda)
    assert sp.wx.shape[1] == fs.kernel_hidden(hidden)
    g = torch.Generator(device=cuda).manual_seed(7)
    ut = torch.randn((3, 3, 300), generator=g, device=cuda)
    z = torch.randn((3, 16), generator=g, device=cuda)
    x = fs.fused_inverse_transposed(sp, ut, z, dtype=dt)
    again = fs.fused_inverse_transposed(sp, ut, z, dtype=dt)
    ref = fs.fused_inverse_transposed_plain(sp, ut, fs.z_projection(sp, z), dt, "relu")
    q = fs.quantize_flow_params(sp)
    dq = fs.dequantize(q)
    xq = fs.fused_sample_points(sp, z, 3, 300, dtype=dt, quantized=q)
    xd = fs.fused_sample_points(sp._replace(wx=dq.wx, wh=dq.wh, wout=dq.wout), z, 3, 300, dtype=dt)
    assert fs.inverse_layout(sp.wx.shape[1], sp.wh.shape[1], dt, int8=True) == \
        fs.inverse_layout(sp.wx.shape[1], sp.wh.shape[1], dt)
    torch.cuda.synchronize()
    tol = 1e-4 if dt == torch.float32 else 5e-2
    torch.testing.assert_close(x, ref, atol=tol, rtol=tol)
    assert torch.equal(x, again) and torch.equal(xq, xd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_latent_public_entries_take_dz24(cuda, dtype):
    """dz=24 (padded to 32), hidden 40 (to 48): fused_latent_log_prob with
    its gradients and fused_latent_inverse on the card against the same
    calls on the CPU (the plain versions on the same padded stacks). Below
    the public entries the kernels keep their contract on multiples of 16
    (test_fused_latent_kernel_conditions)."""
    from dpfx_torch.config import config_from_dict
    from dpfx_torch.models import DPF
    from dpfx_torch.ops import fused_latent as fl

    raw = {"experiment": "gen", "model": {
        "dz": 24, "point_flow": {"n_layers": 2, "hidden": 32, "n_hidden": 2},
        "latent_flow": {"n_layers": 5, "hidden": 40, "n_hidden": 2, "compute_dtype": dtype},
        "encoder": {"point_widths": [32, 64], "head_widths": [32]}}}
    torch.manual_seed(8)
    cpu_model = randomize_(DPF(config_from_dict(raw)), 8, 0.05)
    lcfg = cpu_model.config.model.latent_flow
    assert fl.fused_latent_supported(lcfg, 24)
    z = torch.randn((70, 24), generator=torch.Generator().manual_seed(9))
    wts = torch.linspace(0.5, 1.5, 70)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        model = cpu_model.to(dev)
        model.zero_grad()
        zz = z.to(dev).detach().clone().requires_grad_(True)
        fl.reset_launch_counts()
        lp = fl.fused_latent_log_prob(model, zz, lcfg)
        (lp * wts.to(dev)).sum().backward()
        with torch.no_grad():
            inv = fl.fused_latent_inverse(fl.stack_latent_params(model.latent_flow), z.to(dev), lcfg)
        grads = [p.grad.detach().cpu() for n_, p in model.named_parameters()
                 if n_.startswith("latent_flow.")]
        out[dev.type] = [lp.detach().cpu(), zz.grad.cpu(), inv.cpu()] + grads
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert fl.launches == {"fused_latent_fwd": 1, "fused_latent_bwd": 1,
                                   "fused_latent_inv": 1}
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert out["cuda"][2].shape == (70, 24)
    for i, (a, r) in enumerate(zip(out["cuda"], out["cpu"])):
        assert _rel(a, r) <= tol, (i, _rel(a, r))


def test_latent_f32_smem_mirror_matches_kernel(cuda):
    """fused_latent.f32_smem_bytes (the predicate's mirror) is the library's
    f32 Smem."""
    from dpfx_torch.ops import fused_latent as fl

    for d, h, nh1 in ((32, 48, 1), (128, 256, 1), (128, 512, 2), (64, 1024, 1), (256, 64, 3)):
        for bwd in (False, True):
            assert fl.f32_smem_bytes(d, h, nh1, bwd) == \
                fl._lib().dpfx_fused_latent_smem_bytes(d, h, nh1, int(bwd)), (d, h, nh1, bwd)


@pytest.mark.parametrize("widths", [(24, 40), (120, 200), (8,), (40, 24, 72)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_encoder_padded_widths_match_cpu(cuda, widths, dtype):
    """Point widths off the multiples of 16: the fused posterior and its
    gradients on the card (the kernels on layers padded to multiples of
    16) against the same call on the CPU (the plain versions), at the
    limits of test_fused_encoder_kernels_match_plain's relative errors."""
    from dpfx_torch.models import PointNetEncoder
    from dpfx_torch.ops import fused_encoder as fe

    dt = getattr(torch, dtype)
    torch.manual_seed(10)
    enc = randomize_(PointNetEncoder(16, widths, (32,), dt), 10, 0.1)
    x = torch.randn((3, 300, 3), generator=torch.Generator().manual_seed(11))
    x[0, 150:] = x[0, :150]
    out = {}
    for dev in (torch.device("cpu"), cuda):
        e = enc.to(dev)
        e.zero_grad()
        xx = x.to(dev).detach().clone().requires_grad_(True)
        fe.reset_launch_counts()
        mu, lv = fe.fused_pointnet_posterior(e, xx)
        (mu.sum() + 0.5 * lv.sum()).backward()
        out[dev.type] = [mu.detach().cpu(), lv.detach().cpu(), xx.grad.cpu()] + [
            p.grad.detach().cpu() for n_, p in e.named_parameters() if n_.startswith("point_")]
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert fe.launches == {"fused_encoder_fwd": 1, "fused_encoder_bwd": 1}
    tol = 1e-5 if dtype == "float32" else 2e-2
    for i, (a, r) in enumerate(zip(out["cuda"], out["cpu"])):
        assert _rel(a, r) <= tol, (i, _rel(a, r))


def test_encoder_smem_mirror_matches_kernel(cuda):
    """fused_encoder.smem_mirror (the predicate's) is the library's
    smem_bytes: the block-wide layout, and in bf16 the rows design where it
    fits."""
    from dpfx_torch.ops import fused_encoder as fe

    for widths in ((3, 128, 128, 256, 512), (3, 32, 64), (3, 32, 320, 64), (3, 64),
                   (3, 16, 32, 16, 32, 16, 32, 16, 48), (3, 128, 208), (3, 512, 1024)):
        for dt in (torch.float32, torch.bfloat16):
            assert fe.smem_mirror(widths, dt) == fe.smem_bytes(widths, dt), (widths, dt)


@pytest.mark.parametrize("widths,n", [((32, 64), 200), ((32, 32, 64, 128), 256),
                                      ((16, 128), 77), ((32, 320, 64), 130), ((64,), 130),
                                      ((16, 32, 16, 32, 16, 32, 16, 48), 150)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cloud", ["ties", "identical", "dead"])
def test_fused_encoder_kernels_match_plain(cuda, widths, n, dtype, cloud):
    """Clouds: duplicated points (max-pool ties) and a dead feature; cloud 0
    one point repeated (every row critical); every feature dead (no row
    critical). Widths from one point layer to eight; the 320-wide layer
    takes the block-wide kernels in bf16."""
    from dpfx_torch.models import PointNetEncoder
    from dpfx_torch.ops import fused_encoder as fe

    dt = getattr(torch, dtype)
    torch.manual_seed(0)            # the module's own init
    enc = randomize_(PointNetEncoder(16, widths, (32,)), 0, 0.1).to(cuda)
    last = getattr(enc, f"point_{len(widths) - 1}")
    with torch.no_grad():
        last.bias[3] = -100.0                                           # a dead feature
        if cloud == "dead":
            last.bias.fill_(-100.0)
    ws, bs = [w.detach() for w in fe.encoder_point_weights(enc)[0]], \
        [b.detach() for b in fe.encoder_point_weights(enc)[1]]
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((3, n, 3), generator=g, device=cuda)
    if cloud == "identical":
        x[0] = x[0, :1].clone()
    else:
        x[0, n // 2:] = x[0, : n - n // 2].clone()                      # ties
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
    assert float(pooled[:, 3].abs().max()) == 0.0 and float(got[2][-1][3].abs()) == 0.0
    if cloud == "identical":
        live = pooled[0] > 0
        assert bool((cnt[0][live] == n).all())
    flat = lambda r: [r[0]] + list(r[1]) + list(r[2])
    for i, (a, b, c) in enumerate(zip(flat(got), flat(ref), flat(again))):
        assert torch.equal(a, c), f"tensor {i} is not bit-identical from run to run"
        assert _rel(a, b) <= (1e-4 if dt == torch.float32 else 2e-2), f"tensor {i}: {_rel(a, b)}"
        if cloud == "dead":
            assert float(a.abs().max()) == 0.0, f"tensor {i} is not 0 with every feature dead"


def test_fused_encoder_backward_makes_no_host_sync(cuda):
    """The backward keeps the number of critical rows on the card: under
    sync debug mode "error" a host sync would raise."""
    from dpfx_torch.models import PointNetEncoder
    from dpfx_torch.ops import fused_encoder as fe

    torch.manual_seed(0)            # the module's own init
    enc = randomize_(PointNetEncoder(16, (32, 64), (32,)), 0, 0.1).to(cuda)
    ws, bs = [w.detach() for w in fe.encoder_point_weights(enc)[0]], \
        [b.detach() for b in fe.encoder_point_weights(enc)[1]]
    x = torch.randn((4, 300, 3), generator=torch.Generator(device=cuda).manual_seed(2),
                    device=cuda)
    for dt in (torch.bfloat16, torch.float32):
        pooled, cnt = fe.pool_forward_kernel(ws, bs, x, dt)
        dg = torch.ones_like(pooled)
        fe.pool_backward_kernel(ws, bs, x, pooled, cnt, dg, dt)     # builds and loads the library
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fe.pool_backward_kernel(ws, bs, x, pooled, cnt, dg, dt)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


def test_training_smem_fits_flagship(cuda):
    from dpfx_torch.ops import fused_encoder as fe
    from dpfx_torch.ops import fused_train as ft

    for dt in (torch.float32, torch.bfloat16):
        for backward in (False, True):
            assert 0 < ft.smem_bytes(128, 1, dt, backward) <= fs.SMEM_LIMIT
        assert 0 < fe.smem_bytes((3, 128, 128, 256, 512), dt) <= fs.SMEM_LIMIT


@pytest.mark.parametrize("bad_value", [float("inf"), float("nan")])
def test_train_step_on_card_skips_a_nonfinite_batch(cuda, bad_value):
    """A fused train step on the card launches all four training kernels, and
    a batch holding an inf or a NaN point is skipped: params, moments and the
    optimizer's count keep their values, the step counter advances."""
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
    bad[1, 5, 0] = bad_value
    state, m = step(state, {"x": bad})
    assert float(m["nonfinite_skipped"]) == 1.0 and state.step == 2
    assert state.opt_state.count == 1
    for a, b in ((state.params, params), (state.opt_state.mu, mu), (state.opt_state.nu, nu)):
        assert torch.equal(a, b)
    # the same inside replays of the captured step: a good call, then one on
    # the bad batch (skipped), then a good one again (finite)
    from dpfx_torch.train import make_multi_step

    multi = make_multi_step(model, tx, cfg)
    state, m = multi(state, {"x": x[None]})
    assert float(m["nonfinite_skipped"][0]) == 0.0 and state.opt_state.count == 2
    params, mu, nu = (t.clone() for t in (state.params, state.opt_state.mu, state.opt_state.nu))
    state, m = multi(state, {"x": bad[None]})
    assert float(m["nonfinite_skipped"][0]) == 1.0 and state.step == 4 == state.host_step
    assert state.opt_state.count == 2
    for a, b in ((state.params, params), (state.opt_state.mu, mu), (state.opt_state.nu, nu)):
        assert torch.equal(a, b)
    state, m = multi(state, {"x": x[None]})
    assert float(m["nonfinite_skipped"][0]) == 0.0 and bool(torch.isfinite(m["loss"]).all())
    assert state.opt_state.count == 3 and state.step == 5


# ---------------------------------------------------------------- latent-flow kernels

def _latent_weights(dz, hidden, n_hidden, k, dev, seed=0):
    torch.manual_seed(seed)        # the module's own init
    flow = CouplingFlow(dz, k, hidden, n_hidden, scale_cap=3.0)
    with torch.no_grad():
        from dpfx_torch.ops import fused_latent as fl

        return fl.stack_latent_params(randomize_(flow, seed, 0.05).to(dev))


@pytest.mark.parametrize("dz,hidden,n_hidden,b,cluster,dtype", [
    *((*shape, None, dtype) for shape in ((32, 32, 2, 5), (128, 256, 2, 64), (64, 48, 1, 130),
                                          (48, 64, 3, 17))
      for dtype in ("float32", "bfloat16")),
    *((128, 256, 2, b, c, "bfloat16") for b in (8, 64, 65, 130) for c in (8, 16))])
def test_fused_latent_kernels_match_plain(cuda, dz, hidden, n_hidden, b, cluster, dtype):
    """Forward (u, log-det), inverse and backward (dz and every weight
    gradient) against the plain versions; the backward bit-identical from
    run to run. f32: B=130 is a ragged last tile over nine blocks. bf16 on
    clusters (the default plan, or clusters of 8 or 16): B=65 and 130 are
    two and three groups of 64 (the backward's groups of 32 on clusters of
    8), the last ragged, with one gradient slice per cluster."""
    from dpfx_torch.ops import fused_latent as fl

    dt = getattr(torch, dtype)
    k = 5
    w = _latent_weights(dz, hidden, n_hidden, k, cuda)
    masks = fl.latent_masks(k, dz, cuda)
    pf = pb = None
    if cluster is not None:
        pf = fl.cluster_plan(b, dz, hidden, n_hidden - 1, False, cluster)
        pb = fl.cluster_plan(b, dz, hidden, n_hidden - 1, True, cluster)
        assert pf.cluster == pb.cluster == cluster
    g = torch.Generator(device=cuda).manual_seed(1)
    z = torch.randn((b, dz), generator=g, device=cuda)
    fl.reset_launch_counts()
    u, ld = fl.latent_forward_kernel(w, masks, 3.0, z, dt, plan=pf)
    u_p, ld_p = fl.latent_forward_plain(w, masks, 3.0, z, dt)
    zi = fl.latent_inverse_kernel(w, masks, 3.0, z, dt, plan=pf)
    zi_p = fl.latent_inverse_plain(w, masks, 3.0, z, dt)
    du = torch.randn(u.shape, generator=g, device=cuda)
    dld = torch.randn(ld.shape, generator=g, device=cuda)
    got = fl.latent_backward_kernel(w, masks, 3.0, u_p, du, dld, dt, plan=pb)
    again = fl.latent_backward_kernel(w, masks, 3.0, u_p, du, dld, dt, plan=pb)
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


def test_fused_latent_cluster_smem_is_the_plan(cuda):
    """The plan's shared memory (fused_latent.cluster_smem_bytes) is the
    kernel library's CLay, byte for byte."""
    from dpfx_torch.ops import fused_latent as fl

    lib = fl._lib()
    for d, h, nh1 in ((128, 256, 1), (32, 32, 1), (64, 48, 0), (48, 64, 2)):
        for bwd in (False, True):
            for c in (1, 2, 4, 8, 16):
                if d % (8 * c) or h % (8 * c):
                    continue
                for g in (16, 32, 64):
                    assert (fl.cluster_smem_bytes(d, h, nh1, g, c, bwd)
                            == lib.dpfx_fused_latent_cluster_smem_bytes(d, h, nh1, g, c, int(bwd)))


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


def _replay_model(cuda, fused_latent, seed=0):
    """A small bf16 model on every training kernel (the latent flow fused or
    not) under the annealed jitter and a clipped, warmed-up schedule, with
    its optimizer and state."""
    from dpfx_torch.config import config_from_dict
    from dpfx_torch.models import DPF
    from dpfx_torch.train import init_params_, init_state, make_optimizer

    cfg = config_from_dict({"experiment": "gen", "model": {
        "dz": 32,
        "point_flow": {"n_layers": 4, "hidden": 32, "n_hidden": 2, "compute_dtype": "bfloat16"},
        "latent_flow": {"n_layers": 4, "hidden": 64, "n_hidden": 2, "compute_dtype": "bfloat16"},
        "encoder": {"point_widths": [32, 64], "head_widths": [32], "compute_dtype": "bfloat16"}},
        "data": {"n_points": 256},
        "train": {"batch_size": 4, "fused_point_flow": True, "fused_encoder": True,
                  "fused_latent_flow": fused_latent, "grad_clip": 1.0, "lr_warmup_steps": 2,
                  "steps": 20, "augment_noise": 0.05, "augment_noise_final": 0.01,
                  "augment_noise_anneal_steps": 6}})
    model = randomize_(init_params_(DPF(cfg), seed), seed, 0.05).to(cuda)
    tx = make_optimizer(cfg.train)
    return cfg, model, tx, init_state(model, tx)


def _same_state(a, b):
    return all(torch.equal(u, v) for u, v in (
        (a.params, b.params), (a.opt_state.mu, b.opt_state.mu), (a.opt_state.nu, b.opt_state.nu),
        (a.opt_state.count, b.opt_state.count), (a.step, b.step)))


@pytest.mark.parametrize("fused_latent", [False, True])
def test_replays_equal_eager_steps(cuda, fused_latent):
    """K replays of the captured step equal K eager steps bit for bit on
    supplied eps and xnoise (params, moments, count, step and every metric),
    over two calls (K=5, then a tail of 2 on the same graph); the launch
    counts are the warm-up's eager steps plus one step's launches per
    replay."""
    from dpfx_torch.ops import fused_encoder as fe
    from dpfx_torch.ops import fused_latent as fl
    from dpfx_torch.ops import fused_train as ft
    from dpfx_torch.train import make_multi_step, make_train_step
    from dpfx_torch.train.trainer import _WARMUP

    g = torch.Generator(device=cuda).manual_seed(3)
    k = 7
    batches = {"x": torch.randn((k, 4, 256, 3), generator=g, device=cuda),
               "eps": torch.randn((k, 4, 32), generator=g, device=cuda),
               "xnoise": torch.randn((k, 4, 256, 3), generator=g, device=cuda)}
    cfg, model, tx, eager = _replay_model(cuda, fused_latent)
    step = make_train_step(model, tx, cfg)
    ms = []
    for i in range(k):
        eager, m = step(eager, {key: v[i] for key, v in batches.items()})
        ms.append(m)
    cfg, model, tx, state = _replay_model(cuda, fused_latent)
    multi = make_multi_step(model, tx, cfg)
    for mod in (ft, fe, fl):
        mod.reset_launch_counts()
    state, m1 = multi(state, {key: v[:5] for key, v in batches.items()})
    state, m2 = multi(state, {key: v[5:] for key, v in batches.items()})
    torch.cuda.synchronize()
    assert _same_state(state, eager) and state.host_step == eager.host_step == k
    for key in ms[0]:
        assert torch.equal(torch.cat([m1[key], m2[key]]), torch.stack([m[key] for m in ms])), key
    counted = {**ft.launches, **fe.launches, **fl.launches}
    for key in ("fused_train_fwd", "fused_train_bwd", "fused_encoder_fwd", "fused_encoder_bwd"):
        assert counted[key] == _WARMUP + k, (key, counted)
    lat = _WARMUP + k if fused_latent else 0
    assert counted["fused_latent_fwd"] == counted["fused_latent_bwd"] == lat
    assert counted["fused_latent_inv"] == 0


@pytest.mark.parametrize("fused_latent", [False, True])
def test_resident_call_equals_eager_steps_on_its_draws(cuda, fused_latent):
    """A resident call (draw, gather, replays) equals eager steps on the
    batches and noise its draw chose, bit for bit."""
    from dpfx_torch.train import (gather_resident, make_resident_multi_step, make_train_step,
                                  resident_draw)

    data = torch.randn((20, 300, 3), generator=torch.Generator(device=cuda).manual_seed(4),
                       device=cuda)
    cfg, model, tx, eager = _replay_model(cuda, fused_latent, seed=1)
    ci, pi, eps, xn = resident_draw(cfg, 0, 6, 20, 300, cuda)
    x = gather_resident(data, ci, pi)
    assert x.shape == (6, 4, 256, 3)
    step = make_train_step(model, tx, cfg)
    for i in range(6):
        eager, _ = step(eager, {"x": x[i], "eps": eps[i], "xnoise": xn[i]})
    cfg, model, tx, state = _replay_model(cuda, fused_latent, seed=1)
    resident = make_resident_multi_step(model, tx, cfg)
    state, m = resident(state, data, 4)
    state, m = resident(state, data, 2)
    torch.cuda.synchronize()
    assert _same_state(state, eager) and m["loss"].shape == (2,)


def test_capture_then_reallocated_parameters_raise(cuda):
    """A graph reads the storage it was captured on: after the flat buffer
    is rebuilt (init_state flattens the parameters again), a call raises,
    with the new state and with the old one; a new multi-step captures on
    the new storage, and refuses batches of another shape."""
    from dpfx_torch.train import init_state, make_multi_step

    cfg, model, tx, state = _replay_model(cuda, False)
    multi = make_multi_step(model, tx, cfg)
    x = torch.randn((2, 4, 256, 3), device=cuda)
    state, _ = multi(state, {"x": x})
    new = init_state(model, tx)
    for st in (new, state):
        with pytest.raises(RuntimeError, match="moved to other storage"):
            multi(st, {"x": x})
    # a new multi-step captures on the new storage; other shapes are refused
    fresh = make_multi_step(model, tx, cfg)
    new, m = fresh(new, {"x": x})
    assert bool(torch.isfinite(m["loss"]).all())
    with pytest.raises(ValueError, match="captured on"):
        fresh(new, {"x": x[:, :, :128].contiguous()})


# ---------------------------------------------------------------- the trainer loop

def _loop_trainer(device, ckpt_dir, fused_latent=False, log_fn=None, **train):
    """A Trainer on tests/_torch_train_cases.py's card_loop model, its
    weights moved off the identity (seeded)."""
    from _torch_train_cases import card_loop
    from dpfx_torch.config import config_from_dict
    from dpfx_torch.train import Trainer

    raw = card_loop(fused_latent, ckpt_dir=str(ckpt_dir), **train)
    tr = Trainer(config_from_dict(raw), device=device, log_fn=log_fn or (lambda s: None))
    randomize_(tr.model, 1, 0.05)
    return tr


@pytest.mark.parametrize("fused_latent", [False, True])
def test_resume_after_a_capture_equals_the_uninterrupted_run(cuda, tmp_path, fused_latent):
    """A resident run of 12 steps in calls of 4 (one capture), against one
    stopped at 8 and a new Trainer that restores step 8 into its storage and
    captures again for the last 4: params, moments, count and step equal
    bit for bit."""
    from dpfx_torch.data import SyntheticDataset, preload_clouds

    clouds = preload_clouds(SyntheticDataset(size=20, n_stored=300, split="train"))
    kw = dict(steps=12, steps_per_call=4, log_every=4, ckpt_every=100)
    whole = _loop_trainer(cuda, tmp_path / "a", fused_latent, **kw)
    whole.fit_resident(clouds)
    _loop_trainer(cuda, tmp_path / "b", fused_latent, **kw).fit_resident(clouds, steps=8)
    resumed = _loop_trainer(cuda, tmp_path / "b", fused_latent, **kw)
    flat = resumed.state.params.data_ptr()
    assert resumed.maybe_resume() == 8
    resumed.fit_resident(clouds)
    torch.cuda.synchronize()
    assert resumed.multi_step.graph is not None and resumed.state.params.data_ptr() == flat
    assert _same_state(resumed.state, whole.state) and resumed.state.host_step == 12


def test_fit_auto_captures_the_step_again_after_a_recovery(cuda, tmp_path, monkeypatch):
    """Host batches holding an inf from step 21 on, calls of 2: the run
    aborts at step 26, restores step 20 (the checkpoint at 24 fell in the
    skipped phase), halves lr and captures the step again with it, the old
    graph released; no storage check fires and the run ends at step 40 with
    finite params."""
    from _torch_train_cases import poisoned_batches
    from dpfx_torch.train import trainer as tm

    captured = []
    capture = tm.MultiStep._capture

    def counting(self, *a):
        captured.append(self)
        return capture(self, *a)

    monkeypatch.setattr(tm.MultiStep, "_capture", counting)
    logs, calls = [], []
    tr = _loop_trainer(cuda, tmp_path, log_fn=logs.append, steps=40, steps_per_call=2,
                       log_every=2, ckpt_every=4, abort_after_skipped_windows=3,
                       recover_on_divergence=True)
    first = tr.multi_step
    state = tr.fit_auto(poisoned_batches(calls, 4, 256, 20))
    torch.cuda.synchronize()
    assert len(calls) == 2 and state.host_step == int(state.step) == 40
    assert any("restored step 20" in line for line in logs), logs
    assert tr.cfg.train.lr == pytest.approx(0.5e-3)
    assert captured == [first, tr.multi_step] and first.graph is None
    assert bool(torch.isfinite(state.params).all())


@pytest.mark.parametrize("fused_latent", [False, True])
def test_evaluate_on_card_matches_cpu(cuda, tmp_path, fused_latent):
    """Trainer.evaluate through the fused forwards on the card against the
    same call on the CPU (plain versions), on the same weights, batches (the
    last ragged) and eps: every mean and median within 2e-2 (the fused
    step's bracket); the forwards launch once a batch, no backward."""
    import numpy as np

    from dpfx_torch.ops import fused_encoder as fe
    from dpfx_torch.ops import fused_latent as fl

    trs = [_loop_trainer(d, tmp_path / d, fused_latent) for d in ("cuda", "cpu")]
    assert torch.equal(trs[0].state.params.cpu(), trs[1].state.params)
    rng = np.random.default_rng(2)
    batches = [{"x": rng.normal(size=(b, 256, 3)).astype(np.float32),
                "eps": rng.normal(size=(b, 32)).astype(np.float32)} for b in (8, 8, 5)]
    for mod in (ft, fe, fl):
        mod.reset_launch_counts()
    on_card = trs[0].evaluate(iter(batches))
    counted = {**ft.launches, **fe.launches, **fl.launches}
    on_cpu = trs[1].evaluate(iter(batches))
    assert on_card.keys() == on_cpu.keys()
    for k, v in on_cpu.items():
        assert abs(on_card[k] - v) <= 2e-2 * abs(v), (k, on_card[k], v)
    assert counted["fused_train_fwd"] == counted["fused_encoder_fwd"] == 3
    assert counted["fused_latent_fwd"] == (3 if fused_latent else 0)
    assert counted["fused_train_bwd"] == counted["fused_encoder_bwd"] == 0
    assert counted["fused_latent_bwd"] == 0


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
    # one distance per element, the clamp after the minimum: the minima are
    # the plain version's bit for bit
    assert torch.equal(dl, pdl) and torch.equal(dr, pdr)
    ii, jj = torch.meshgrid(torch.arange(4), torch.arange(3), indexing="ij")
    for prec in ("exact", "fast"):
        got = cdk.chamfer_pairwise(xs, ys, prec)
        assert torch.equal(got, cdk.chamfer_pairwise(xs, ys, prec)), "not bit-identical"
        assert _pair_rel(got, cdk.chamfer_pairwise_plain(xs, ys, prec), 1e-7) <= 1e-5
        # the plain version of the kernel's algebra and order: equal bit for
        # bit (its minima are nn_distances_plain's, fast mode's the rounded
        # matrix's: tests/test_torch_chamfer_onepass.py)
        _, _, one = cdk.onepass_plain(xs[ii.flatten()], ys[jj.flatten()], fast=prec == "fast")
        assert torch.equal(got.flatten(), one), prec
    torch.cuda.synchronize()
    assert cdk.launches == {"nnd_fwd": 1, "nnd_bwd": 0, "cd_pairwise": 4}


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


@pytest.mark.parametrize("b,n,m", [(4, 200, 317), (3, 37, 101), (4, 600, 700), (64, 130, 70),
                                   (32, 2048, 2048)])
def test_chamfer_cluster_matches_one_cta(cuda, b, n, m):
    """Few pairs split their tiles over a cluster of CTAs, combined through
    distributed shared memory; the same pairs among 2 x 132 or more run on
    one CTA each. Minima are exact in any order and the sums keep their
    order: the two are equal bit for bit, dl, dr and CD."""
    from dpfx_torch.ops import chamfer as cdk

    xs, ys = _eval_clouds(cuda, b, n, 41), _eval_clouds(cuda, b, m, 42)
    reps = -(-2 * 132 // b)
    c = cdk.cluster_size(b, n, m)
    assert cdk.cluster_size(b * reps, n, m) == 1
    assert c > 1 or (n <= 256 and m <= 256), "a pair of one tile runs on one CTA"
    cdk.reset_launch_counts()
    dl, dr = cdk.nn_distances(xs, ys)
    ml, mr = cdk.nn_distances(xs.repeat(reps, 1, 1), ys.repeat(reps, 1, 1))
    assert cdk.clusters["nnd_fwd"] == {c, 1}
    assert torch.equal(dl, ml[:b]) and torch.equal(dr, mr[:b])
    pdl, _, pdr, _ = cdk.nn_distances_plain(xs, ys)
    assert torch.equal(dl, pdl) and torch.equal(dr, pdr)
    few = cdk.chamfer_pairwise(xs[:2], ys[:2])
    many = cdk.chamfer_pairwise(xs[:2].repeat(66, 1, 1), ys[:2])[:2]
    assert torch.equal(few, many)
    torch.cuda.synchronize()
    assert [cdk.cluster_size(p, 2048, 2048) for p in (1, 33, 34, 263, 264)] == [4, 4, 2, 2, 1]


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
    assert emdk.launches == {"emd_batched": 2, "emd_batched_grad": 0, "emd_pairwise": 4}
    same = emdk.emd_nograd(xs[:, :64], xs[:, :64])
    assert float(same.max()) < 1e-3


def test_eval_kernel_conditions(cuda):
    """The kernels' shared memory fits up to MAX_POINTS, sizes beyond it
    raise before any launch, nn_distances is differentiable and the
    functions without a gradient in dpfx refuse one."""
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
    xg = _eval_clouds(cuda, 1, 8, 8).requires_grad_(True)
    cdk.chamfer(xg, small).sum().backward()
    assert cdk.launches["nnd_fwd"] == cdk.launches["nnd_bwd"] == 1
    assert bool(torch.isfinite(xg.grad).all()) and bool(xg.grad.abs().sum() > 0)
    with pytest.raises(NotImplementedError, match="chamfer_pairwise has no gradient"):
        cdk.chamfer_pairwise(xg, small)
    with pytest.raises(NotImplementedError, match="use emd for gradients"):
        emdk.emd_nograd(xg, small)
    # the largest clouds the kernels take (EMD: 224 KB of shared memory)
    x, y = _eval_clouds(cuda, 1, cdk.MAX_POINTS, 6), _eval_clouds(cuda, 1, cdk.MAX_POINTS, 7)
    assert _pair_rel(cdk.chamfer(x, y), cdk.chamfer_plain(x, y), 1e-7) <= 1e-5
    assert _pair_rel(emdk.emd_nograd(x, y), emdk.emd_plain(x, y), 1e-5) <= 5e-3


def _grad_err(a, b):
    """Largest per-point |a_i - b_i| / (|b_i| + mean |b|) of [B, N, 3] gradients."""
    na, nb = (a - b).double().norm(dim=-1), b.double().norm(dim=-1)
    return float((na / (nb + nb.mean(-1, keepdim=True))).max())


@pytest.mark.parametrize("b,n,m", [(3, 256, 256), (3, 200, 317), (2, 2048, 2048), (1, 2048, 2048),
                                   (8, 2048, 2048), (33, 2048, 2048), (64, 2048, 2048),
                                   (65, 2048, 2048), (130, 2048, 2048), (8, 2000, 2048),
                                   (1, 4096, 4096)])
def test_nnd_bwd_matches_plain(cuda, b, n, m):
    """nnd_bwd against nn_distances_backward_plain on the forward's own
    minima: the same masks, sums in other orders (limit 1e-5 per point,
    chip_smoke.py's TOL_CD_GRAD), bit-identical from run to run, to the
    three-pass kernel and to onepass_bwd_plain (every path adds the three
    passes' nonzero terms in their order); through autograd as chamfer's
    backward; with every point of a cloud duplicated (each mask holds two,
    the gradients of y = x vanish; the three passes), and with one tie per
    pair (the fix-up)."""
    from dpfx_torch.ops import chamfer as cdk

    xs, ys = _eval_clouds(cuda, b, n, 21), _eval_clouds(cuda, b, m, 22)
    g = torch.Generator(device=cuda).manual_seed(23)
    cdk.reset_launch_counts()
    dl, dr = cdk.nnd_forward(xs, ys)
    gl = torch.randn(dl.shape, generator=g, device=cuda)
    gr = torch.randn(dr.shape, generator=g, device=cuda)
    gx, gy = cdk.nnd_backward(xs, ys, dl, dr, gl, gr)
    paths = cdk.last_paths
    again = cdk.nnd_backward(xs, ys, dl, dr, gl, gr)
    px, py = cdk.nn_distances_backward_plain(xs, ys, dl, dr, gl, gr)
    assert torch.equal(gx, again[0]) and torch.equal(gy, again[1]), "not bit-identical"
    assert max(_grad_err(gx, px), _grad_err(gy, py)) <= 1e-5
    tx, ty = cdk.nnd_backward(xs, ys, dl, dr, gl, gr, three_pass=True)
    assert torch.equal(gx, tx) and torch.equal(gy, ty), "not the three passes' bits"
    ox, oy, op = cdk.onepass_bwd_plain(xs, ys, dl, dr, gl, gr)
    assert torch.equal(paths, op) and torch.equal(gx, ox) and torch.equal(gy, oy)
    assert cdk.clusters["nnd_bwd"] == {cdk.cluster_size(b, n, m)}
    xg, yg = xs.clone().requires_grad_(True), ys.clone().requires_grad_(True)
    cdk.chamfer(xg, yg).sum().backward()
    ex, ey = cdk.nn_distances_backward_plain(xs, ys, dl, dr, torch.full_like(dl, 1.0 / n),
                                             torch.full_like(dr, 1.0 / m))
    assert max(_grad_err(xg.grad, ex), _grad_err(yg.grad, ey)) <= 1e-5
    dup = torch.cat([xs[:, : n // 2], xs[:, : n // 2]], 1)
    dl, dr = cdk.nnd_forward(dup, dup)
    tx, ty = cdk.nnd_backward(dup, dup, dl, dr, gl[:, : dup.shape[1]], gr[:, : dup.shape[1]])
    assert bool((cdk.last_paths == cdk.PATH_THREE).all())
    assert float(tx.abs().max()) <= 1e-5 and float(ty.abs().max()) <= 1e-5
    # row 0 at distance 0 from two copies in y: its count is 2
    yt = ys.clone()
    yt[:, 0] = yt[:, -1] = xs[:, 0]
    dl, dr = cdk.nnd_forward(xs, yt)
    fx, fy = cdk.nnd_backward(xs, yt, dl, dr, gl, gr)
    assert bool((cdk.last_paths == cdk.PATH_FIX).all())
    tx, ty = cdk.nnd_backward(xs, yt, dl, dr, gl, gr, three_pass=True)
    assert torch.equal(fx, tx) and torch.equal(fy, ty)
    px, py = cdk.nn_distances_backward_plain(xs, yt, dl, dr, gl, gr)
    assert max(_grad_err(fx, px), _grad_err(fy, py)) <= 1e-5
    torch.cuda.synchronize()
    assert cdk.launches == {"nnd_fwd": 4, "nnd_bwd": 5, "cd_pairwise": 0}
    assert cdk.reference_launches == {"nnd_bwd3": 2}


def _exact_and_f32_bound(x, y, dl, dr, gl, gr):
    """(gx, gy) in f64 on the f32 masks (the forward's distances against
    dl, dr), and for each coordinate the worst-case error of any order of
    f32 sums of the backward's terms: gamma_k sum |terms|, k the point's
    terms plus the 5 operations that combine its sums, gamma_k = k u / (1 -
    k u), u = 2^-24 (Higham, recursive summation)."""
    from dpfx_torch.ops import chamfer as cdk

    outs = []
    for s in range(0, x.shape[0], 16):
        xc, yc = x[s:s + 16], y[s:s + 16]
        d = cdk.sqdist_matrix(xc, yc)
        ml = (d <= dl[s:s + 16, :, None]).double()
        mr = (d <= dr[s:s + 16, None, :]).double()
        xc, yc, glc, grc = xc.double(), yc.double(), gl[s:s + 16].double(), gr[s:s + 16].double()
        wl = glc[..., None] * ml / ml.sum(-1, keepdim=True).clamp_min(1.0)
        wr = grc[:, None, :] * mr / mr.sum(-2, keepdim=True).clamp_min(1.0)
        gx = 2 * glc[..., None] * xc - 2 * (wl @ yc) + 2 * xc * wr.sum(-1, keepdim=True) - 2 * (wr @ yc)
        gy = 2 * yc * (grc + wl.sum(-2))[..., None] - 2 * (wl.mT @ xc) - 2 * (wr.mT @ xc)
        ax, ay, al, ar = xc.abs(), yc.abs(), wl.abs(), wr.abs()
        tx = 2 * glc.abs()[..., None] * ax + 2 * (al @ ay) + 2 * ax * ar.sum(-1, keepdim=True) + 2 * (ar @ ay)
        ty = 2 * ay * (grc.abs() + al.sum(-2))[..., None] + 2 * (al.mT @ ax) + 2 * (ar.mT @ ax)
        u = 2.0 ** -24
        kx = ((ml + mr).sum(-1) + 5)[..., None] * u
        ky = ((ml + mr).sum(-2) + 5)[..., None] * u
        outs.append((gx, gy, kx / (1 - kx) * tx, ky / (1 - ky) * ty))
    return tuple(torch.cat(parts) for parts in zip(*outs))


@pytest.mark.parametrize("case", ["hubs", "copies"])
def test_nnd_bwd_long_lists_and_many_fixed_points(cuda, case):
    """nnd_bwd at B=64 x 2048 on the inputs of tests/_torch_bwd_cases.py,
    which reach what generic clouds miss (tests/test_torch_nnd_bwd_onepass.py
    pins that they do): a tight cloud against a spread one (inverse lists
    of 9 to 32 members, sorted by a warp, and of more than 32, sent to the
    fix-up), and 300 copies of x_0 in y (the fix-up, on more than 256
    points). Bit for bit the three-pass kernel and onepass_bwd_plain, the
    same paths as onepass_bwd_plain, bit-identical run to run; it and
    nn_distances_backward_plain within the worst-case f32 rounding of the
    exact value (f64 on the same masks). The hubs also within TOL_CD_GRAD
    of nn_distances_backward_plain per point; the copies are not held to
    it: x_0's terms from its copies cancel exactly (sum_j gr_j (x_0 - y_j)
    with y_j = x_0), so each order of f32 sums leaves its own residue of
    size u sum_j |gr_j| |x_0|, above 1e-5 of the point's scale in both the
    kernel's order and the plain version's."""
    from _torch_bwd_cases import copies_clouds, hub_clouds

    from dpfx_torch.ops import chamfer as cdk

    x, y = (hub_clouds if case == "hubs" else copies_clouds)(64, 2048)
    xs, ys = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)
    cdk.reset_launch_counts()
    dl, dr = cdk.nnd_forward(xs, ys)
    g = torch.Generator(device=cuda).manual_seed(5)
    gl = torch.randn(dl.shape, generator=g, device=cuda)
    gr = torch.randn(dr.shape, generator=g, device=cuda)
    gx, gy = cdk.nnd_backward(xs, ys, dl, dr, gl, gr)
    paths = cdk.last_paths
    again = cdk.nnd_backward(xs, ys, dl, dr, gl, gr)
    tx, ty = cdk.nnd_backward(xs, ys, dl, dr, gl, gr, three_pass=True)
    ox, oy, op = cdk.onepass_bwd_plain(xs, ys, dl, dr, gl, gr)
    px, py = cdk.nn_distances_backward_plain(xs, ys, dl, dr, gl, gr)
    torch.cuda.synchronize()
    assert torch.equal(gx, again[0]) and torch.equal(gy, again[1]), "not bit-identical"
    assert torch.equal(gx, tx) and torch.equal(gy, ty), "not the three passes' bits"
    assert torch.equal(paths, op) and torch.equal(gx, ox) and torch.equal(gy, oy)
    want = cdk.PATH_LISTS if case == "hubs" else cdk.PATH_FIX
    assert bool((paths == want).all()), paths.tolist()
    ex, ey, bx, by = _exact_and_f32_bound(xs, ys, dl, dr, gl, gr)
    for a, b in ((gx, px), (gy, py)):
        e, bound = (ex, bx) if a is gx else (ey, by)
        assert bool(((a.double() - e).abs() <= bound).all())
        assert bool(((b.double() - e).abs() <= bound).all())
    if case == "hubs":
        assert max(_grad_err(gx, px), _grad_err(gy, py)) <= 1e-5
    assert cdk.launches == {"nnd_fwd": 1, "nnd_bwd": 2, "cd_pairwise": 0}


@pytest.mark.parametrize("b,n,m", [(4, 256, 256), (4, 200, 317), (2, 2048, 2048)])
def test_emd_grad_mode_matches_plain(cuda, b, n, m):
    """The EMD gradient mode: its cost equals emd_nograd's bit for bit; gx
    and gy per pair by the relative norm, bit-identical from run to run;
    emd's backward scales them by the cotangent.

    On random Gaussian pairs approxmatch's plan is chaotic in f32: an f64
    run of emd_grads_plain shows the f32 plain version itself parting from
    it by up to median 3.5e-3, max 2.8e-2 on these pairs, and the kernel
    by as much (median 3.5e-3, max 2.8e-2; against the f32 plain version
    median 8.2e-4, max 3.6e-3; NVIDIA H100 80GB HBM3, 700 W).
    So the kernel is held to the f64 run at 4x the f32 plain version's
    own drift (seen: up to 1.2x), and to the f32 plain version at median
    1e-2, max 5e-2, about twice that drift. Near-coincident points, whose
    plan is a matching, read 7.0e-8 and are held at median 1e-5, max 1e-4
    (chip_smoke.py's TOL_EMD_GRAD_*); weighing by sqrt of the expanded
    distance, as the Pallas body does, reads ~1e5 there."""
    from dpfx_torch.ops import emd as emdk

    def rel(a, r):
        return (a - r).double().flatten(1).norm(dim=1) / r.double().flatten(1).norm(dim=1)

    xs, ys = _eval_clouds(cuda, b, n, 24), _eval_clouds(cuda, b, m, 25)
    emdk.reset_launch_counts()
    cost, gx, gy = emdk.emd_with_grads(xs, ys)
    again = emdk.emd_with_grads(xs, ys)
    assert torch.equal(cost, emdk.emd_nograd(xs, ys))
    assert all(torch.equal(a, c) for a, c in zip((cost, gx, gy), again)), "not bit-identical"
    _, px, py = emdk.emd_grads_plain(xs, ys)
    _, qx, qy = emdk.emd_grads_plain(xs.double(), ys.double())
    for tag, a, r, q in (("gx", gx, px, qx), ("gy", gy, py, qy)):
        e = rel(a, r)
        k64, p64 = rel(a, q), rel(r, q)
        print(f"{tag} {b}x{n}x{m}: against plain f32 median {float(e.median()):.2e} max "
              f"{float(e.max()):.2e}; against f64 kernel median {float(k64.median()):.2e} max "
              f"{float(k64.max()):.2e}, plain f32 median {float(p64.median()):.2e} max "
              f"{float(p64.max()):.2e}")
        assert float(e.median()) <= 1e-2 and float(e.max()) <= 5e-2, e
        assert float(k64.median()) <= 4 * float(p64.median()) + 1e-6, (k64, p64)
        assert float(k64.max()) <= 4 * float(p64.max()) + 1e-6, (k64, p64)
    # pairs of points ~1e-4 apart, where the expanded distance cancels: the
    # gradient weighs by the coordinates' own difference, as the plain one
    near = ys + 1e-4 * torch.randn(ys.shape, generator=torch.Generator(device=cuda).manual_seed(29),
                                   device=cuda)
    _, nx, ny = emdk.emd_with_grads(near, ys)
    _, qx, qy = emdk.emd_grads_plain(near, ys)
    for a, r in ((nx, qx), (ny, qy)):
        e = rel(a, r)
        print(f"near-coincident: median {float(e.median()):.2e} max {float(e.max()):.2e}")
        assert float(e.median()) <= 1e-5 and float(e.max()) <= 1e-4, e
    w = torch.arange(1, b + 1, device=cuda, dtype=torch.float32)
    xg = xs.clone().requires_grad_(True)
    (emdk.emd(xg, ys) * w).sum().backward()
    assert torch.equal(xg.grad, w[:, None, None] * gx)
    torch.cuda.synchronize()
    assert emdk.launches == {"emd_batched": 1, "emd_batched_grad": 4, "emd_pairwise": 0}


def _emd_held(a, b):
    """chip_smoke.py's EMD limits: median pair 1e-4, largest 5e-3 (relative)."""
    e = (a.double() - b.double()).abs() / b.double().abs().clamp_min(1e-5)
    return float(e.median()) <= 1e-4 and float(e.max()) <= 5e-3


@pytest.mark.parametrize("b,n,m", [(4, 256, 256), (4, 200, 317), (3, 37, 101), (64, 130, 70)])
def test_emd_cluster_matches_one_cta(cuda, b, n, m):
    """A launch of few pairs runs each pair on a thread-block cluster; the
    same pairs among 2 x 132 or more run on one CTA each. The two sum in
    other orders, so they are held to each other by the EMD limits (seen:
    max 4e-5), each within them of the plain version, every mode; ragged
    N and M that the cluster size does not divide (200 and 317 rows in
    units of 16 over 4 CTAs, 37 over 2); under the split the gradient
    mode's cost equals emd_nograd's bit for bit."""
    from dpfx_torch.ops import emd as emdk

    xs, ys = _eval_clouds(cuda, b, n, 31), _eval_clouds(cuda, b, m, 32)
    c = emdk.cluster_size(b, n, m)
    reps = -(-2 * 132 // b)
    assert c > 1 and emdk.cluster_size(b * reps, n, m) == 1
    emdk.reset_launch_counts()
    few = emdk.emd_nograd(xs, ys)
    many = emdk.emd_nograd(xs.repeat(reps, 1, 1), ys.repeat(reps, 1, 1))
    assert emdk.clusters["emd_batched"] == {c, 1}
    assert torch.equal(many[:b], many[b:2 * b])
    assert _emd_held(few, many[:b]) and _emd_held(few, emdk.emd_plain(xs, ys))
    cost, _, _ = emdk.emd_with_grads(xs, ys)
    assert torch.equal(cost, few), "the gradient mode's cost under a cluster split"
    assert emdk.cluster_size(4, n, m) > 1 and emdk.cluster_size(4 * 66, n, m) == 1
    for prec in ("fast", "exact"):
        small = emdk.emd_pairwise(xs[:2], ys[:2], precision=prec)
        big = emdk.emd_pairwise(xs[:2].repeat(66, 1, 1), ys[:2], precision=prec)[:2]
        assert _emd_held(small, big), prec
        assert _emd_held(small, emdk.emd_pairwise_plain(xs[:2], ys[:2], precision=prec)), prec
    torch.cuda.synchronize()


def test_emd_cluster_threshold(cuda):
    """2 x 132 pairs run one CTA each, one pair fewer runs clusters of 2; 33
    pairs (4 x 33 = 132 CTAs) clusters of 4, 34 of 2; at most one CTA per 16
    points of the smaller cloud. The pairs below the threshold agree with
    the same pairs at it, and the gradient mode's cost with emd_nograd's."""
    from dpfx_torch.ops import emd as emdk

    n = 64
    assert [emdk.cluster_size(p, n, n) for p in (1, 33, 34, 263, 264, 8192)] == [4, 4, 2, 2, 1, 1]
    assert emdk.cluster_size(8, 40, 2048) == 2 and emdk.cluster_size(8, 16, 16) == 1
    xs, ys = _eval_clouds(cuda, 264, n, 33), _eval_clouds(cuda, 264, n, 34)
    emdk.reset_launch_counts()
    at = emdk.emd_nograd(xs, ys)
    assert emdk.clusters["emd_batched"] == {1}
    below = emdk.emd_nograd(xs[:263], ys[:263])
    assert emdk.clusters["emd_batched"] == {1, 2}
    assert _emd_held(below, at[:263]) and _emd_held(at, emdk.emd_plain(xs, ys))
    for p in (263, 264):
        cost, _, _ = emdk.emd_with_grads(xs[:p], ys[:p])
        assert torch.equal(cost, below if p == 263 else at)
    torch.cuda.synchronize()


@pytest.mark.parametrize("hidden,n_hidden,n", [(32, 2, 200), (64, 1, 128), (128, 2, 300),
                                               (256, 3, 77)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_sampler_equals_dequantized(cuda, hidden, n_hidden, n, dtype):
    """The int8 mode equals, bit for bit, the compute-dtype mode on the
    host-dequantized stacks with the same seed (noise included), both on
    the route's layout, the same for both modes (bf16 at (256, 3): the
    cluster inverse)."""
    dt = getattr(torch, dtype)
    if fs.smem_bytes(hidden, dt, n_hidden - 1, True) > fs.SMEM_LIMIT:
        pytest.skip(f"hidden={hidden} in {dtype} does not fit the kernel's shared memory")
    sp = _sp(hidden, n_hidden, "relu", cuda)
    q = fs.quantize_flow_params(sp)
    dq = fs.dequantize(q)
    z = torch.randn((3, 16), generator=torch.Generator(device=cuda).manual_seed(26), device=cuda)
    fs.reset_launch_counts()
    x, u = fs.fused_sample_points(sp, z, 27, n, dtype=dt, quantized=q, return_noise=True)
    assert fs.inverse_layout(hidden, n_hidden - 1, dt, int8=True) == \
        fs.inverse_layout(hidden, n_hidden - 1, dt)
    xd, ud = fs.fused_sample_points(sp._replace(wx=dq.wx, wh=dq.wh, wout=dq.wout), z, 27, n,
                                    dtype=dt, return_noise=True)
    torch.cuda.synchronize()
    assert torch.equal(x, xd) and torch.equal(u, ud)
    assert fs.launches == {"fused_inverse": 0, "fused_sample": 1, "fused_sample_int8": 1}


def test_gradient_and_int8_mode_conditions(cuda):
    """The new modes' limits raise ValueError before any launch."""
    from dpfx_torch.ops import chamfer as cdk
    from dpfx_torch.ops import emd as emdk

    small = _eval_clouds(cuda, 2, 8, 28)
    big = torch.zeros((2, cdk.MAX_POINTS + 1, 3), device=cuda)
    vec = torch.zeros((2, 8), device=cuda)
    cdk.reset_launch_counts()
    emdk.reset_launch_counts()
    fs.reset_launch_counts()
    with pytest.raises(ValueError, match="points per cloud"):
        cdk.nnd_backward(big, small, vec, vec, vec, vec)
    with pytest.raises(ValueError, match="nnd_backward shapes"):
        cdk.nnd_backward(small, small, vec[:, :4], vec, vec, vec)
    with pytest.raises(ValueError, match="equal batches"):
        emdk.emd_with_grads(small, small[:1])
    sp = _sp(32, 2, "relu", cuda)
    q = fs.quantize_flow_params(sp)
    z = torch.zeros((1, 16), device=cuda)
    with pytest.raises(ValueError, match="int8"):
        fs.fused_sample_points(sp, z, 1, 16, quantized=q._replace(sp=q.sp._replace(wh=sp.wh)))
    with pytest.raises(ValueError, match="scales"):
        fs.fused_sample_points(sp, z, 1, 16, quantized=q._replace(scales=q.scales.cpu()))
    assert sum(cdk.launches.values()) + sum(emdk.launches.values()) + sum(fs.launches.values()) == 0
    # the backward's shared memory at the largest clouds
    assert cdk.bwd_smem_bytes(cdk.MAX_POINTS, cdk.MAX_POINTS) <= cdk.SMEM_LIMIT


def _probe_inputs(dev, b, n, k=3, seed=0):
    """The probe tool's weight scales at K=3 (the kernels' width H=128)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)
    w = {"wx": 0.3 * rn(k, 128, 8), "wh": 0.1 * rn(k, 1, 128, 128), "bh": 0.1 * rn(k, 1, 128, 1),
         "wout": 0.05 * rn(k, 8, 128), "bout": 0.01 * rn(k, 8, 1)}
    return w, rn(b, 8, n), 0.1 * rn(b, k, 128, 1), rn(b, 8, n), rn(b)


def _probe_errors(got, ref):
    return [_rel(a, r) if r.abs().max() > 0 else float(a.abs().max()) for a, r in zip(got, ref)]


_PROBE_FORMS = [("bfloat16", 128, m, r) for m in ("full", "nowg", "walk") for r in (False, True)]
_PROBE_FORMS += [("float32", 32, "full", True)]
_PROBE_FORMS += [("float32", 32, m, False) for m in ("full", "nowg", "walk")]


@pytest.mark.parametrize("dtype,tile,mode,rolled", _PROBE_FORMS)
def test_probe_bwd_kernel_matches_plain(cuda, dtype, tile, mode, rolled):
    """The probe backward against probe_bwd_plain at N=300 (a partial last
    tile) with the log-det mask at 290: every output within 1e-5 of its
    norm in f32 (IEEE sums in other orders), 2e-2 in bf16 (a flipped
    rounding of one hidden unit, carried on), the parts nowg and walk
    leave out exactly zero, and bit-identical from run to run."""
    from dpfx_torch.tools import bench_fused_bwd as bfb

    dt = getattr(torch, dtype)
    w, u, hz, du, dld = _probe_inputs(cuda, 2, 300)
    bfb.reset_launch_counts()
    got = bfb.probe_bwd_kernel(w, u, hz, du, dld, mode=mode, n_points=290, dtype=dt,
                               rolled=rolled, tile=tile)
    again = bfb.probe_bwd_kernel(w, u, hz, du, dld, mode=mode, n_points=290, dtype=dt,
                                 rolled=rolled, tile=tile)
    ref = bfb.probe_bwd_plain(w, u, hz, du, dld, mode=mode, n_points=290, dtype=dt)
    torch.cuda.synchronize()
    assert bfb.launches[f"probe_bwd_{mode}{'_rolled' if rolled else ''}"] == 2
    assert all(torch.equal(a, c) for a, c in zip(got, again)), "not bit-identical"
    errs = _probe_errors(got, ref)
    assert max(errs) <= (1e-5 if dt == torch.float32 else 2e-2), errs


@pytest.mark.parametrize("dtype,stripes,rolled", [("bfloat16", s, r) for s in (2, 4) for r in
                                                   (False, True)]
                         + [("float32", s, False) for s in (2, 4)])
def test_ilv_bwd_kernel_matches_plain(cuda, dtype, stripes, rolled):
    """The interleaved kernel against the plain full backward at N=300 (a
    partial last tile of every group size) with the log-det mask at 290,
    limits as the probe kernel's."""
    from dpfx_torch.tools import bench_fused_bwd as bfb

    dt = getattr(torch, dtype)
    w, u, hz, du, dld = _probe_inputs(cuda, 3, 300, seed=1)
    got = bfb.ilv_bwd_kernel(w, u, hz, du, dld, stripes=stripes, rolled=rolled, n_points=290,
                             dtype=dt)
    again = bfb.ilv_bwd_kernel(w, u, hz, du, dld, stripes=stripes, rolled=rolled, n_points=290,
                               dtype=dt)
    ref = bfb.probe_bwd_plain(w, u, hz, du, dld, mode="full", n_points=290, dtype=dt)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again)), "not bit-identical"
    errs = _probe_errors(got, ref)
    assert max(errs) <= (1e-5 if dt == torch.float32 else 2e-2), errs


def test_padded_probe_matches_production_kernel(cuda):
    """On zero-padded production inputs the probe's full kernel computes the
    production backward's function: f32 kernels within 1e-5 of each other
    per output; in bf16 the probe runs the production backward's own body
    (flow_bwd_rows.cuh), so every output is the production kernel's bit
    for bit."""
    from dpfx_torch.ops import fused_train as ft
    from dpfx_torch.tools import bench_fused_bwd as bfb

    w, u, hz, du, dld = _probe_inputs(cuda, 2, 256, seed=2)
    w["wx"][:, :, :3] *= bfb.masks8(3, cuda)[:, :3, 0][:, None, :]
    w["wx"][:, :, 3:] = 0
    w["wout"][:, 6:] = 0
    w["bout"][:, 6:] = 0
    u[:, 3:] = 0
    du[:, 3:] = 0
    got = bfb.probe_bwd_kernel(w, u, hz, du, dld, mode="full", n_points=256, dtype=torch.float32)
    p = bfb.production_slice(w, u, hz, du)
    ref = ft.fused_backward_kernel(p["wx"], p["wh"], p["bh"], p["wout"], p["bout"], p["masks"],
                                   bfb.CAP, p["u"], p["hz"], p["du"], dld, torch.float32)
    torch.cuda.synchronize()
    pairs = [(got[0][:, :3], ref[0]), (got[1][..., 0], ref[1]), (got[2][..., :3], ref[2]),
             (got[3], ref[3]), (got[4][..., 0], ref[4]), (got[5][:, :6], ref[5]),
             (got[6][:, :6, 0], ref[6])]
    for name, (a, b) in zip(["dx", "dhz", "dwx", "dwh", "dbh", "dwout", "dbout"], pairs):
        assert _rel(a, b) <= 1e-5, f"{name}: {_rel(a, b)}"
    got = bfb.probe_bwd_kernel(w, u, hz, du, dld, mode="full", n_points=256, dtype=torch.bfloat16)
    ref = ft.fused_backward_kernel(p["wx"], p["wh"], p["bh"], p["wout"], p["bout"], p["masks"],
                                   bfb.CAP, p["u"], p["hz"], p["du"], dld, torch.bfloat16)
    torch.cuda.synchronize()
    cut = [got[0][:, :3], got[1][..., 0], got[2][..., :3], got[3], got[4][..., 0], got[5][:, :6],
           got[6][:, :6, 0]]
    for name, a, b in zip(["dx", "dhz", "dwx", "dwh", "dbh", "dwout", "dbout"], cut, ref):
        assert torch.equal(a, b), f"bf16 {name}: {_rel(a, b)}"


def test_probe_kernel_conditions(cuda):
    """Shapes, tiles and stripes the kernels are not built for raise
    ValueError before any launch."""
    from dpfx_torch.tools import bench_fused_bwd as bfb

    w, u, hz, du, dld = _probe_inputs(cuda, 2, 256)
    bfb.reset_launch_counts()
    kw = dict(mode="full", n_points=256)
    with pytest.raises(ValueError, match="built for"):
        bfb.probe_bwd_kernel(w, u, hz, du, dld, tile=256, **kw)
    with pytest.raises(ValueError, match="built for"):
        bfb.probe_bwd_kernel(w, u, hz, du, dld, tile=64, dtype=torch.float32, **kw)
    with pytest.raises(ValueError, match="built for"):
        bfb.probe_bwd_kernel(w, u, hz, du, dld, tile=64, rolled=True, **kw)
    with pytest.raises(ValueError, match="built for"):
        bfb.probe_bwd_kernel(w, u, hz, du, dld, tile=64, **kw)   # the first design's tile
    with pytest.raises(ValueError, match="stripes"):
        bfb.ilv_bwd_kernel(w, u, hz, du, dld, stripes=3)
    with pytest.raises(ValueError, match="built for"):
        bfb.ilv_bwd_kernel(w, u, hz, du, dld, stripes=2, rolled=True, dtype=torch.float32)
    with pytest.raises(ValueError, match="stripes"):
        bfb.ilv_bwd_kernel(w, u[..., :254], hz, du[..., :254], dld, stripes=4,
                           dtype=torch.float32)
    with pytest.raises(ValueError, match="built for wx"):
        bfb.probe_bwd_kernel({**w, "wx": w["wx"][:, :64]}, u, hz, du, dld, **kw)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bfb.probe_bwd_kernel(w, u, hz.cpu(), du, dld, **kw)
    with pytest.raises(ValueError, match="shared"):
        bfb.probe_bwd_kernel({**w, "wh": w["wh"].repeat(1, 2, 1, 1),
                              "bh": w["bh"].repeat(1, 2, 1, 1)}, u, hz, du, dld, **kw)
    assert not any(bfb.launches.values())


def test_probe_smem_mirror_matches_the_library(cuda):
    """bench_fused_bwd.smem_bytes (Python) equals the library's
    dpfx_probe_bwd_smem_bytes for every built form, and at n_hidden-1 = 2."""
    from dpfx_torch.tools import bench_fused_bwd as bfb

    forms = [(dt, t, 1) for dt in bfb.BUILT for (t, _, _) in bfb.BUILT[dt]]
    forms += [(dt, bfb.ILV_TILE[dt], s) for dt in bfb.ILV_BUILT for (s, _) in bfb.ILV_BUILT[dt]]
    for dt, tile, stripes in forms:
        for nh1 in (1, 2):
            lib = bfb._lib().dpfx_probe_bwd_smem_bytes(128, nh1, int(dt == torch.bfloat16), tile,
                                                        stripes)
            assert bfb.smem_bytes(128, nh1, dt, tile, stripes) == lib, (dt, tile, stripes, nh1)


@pytest.mark.parametrize("groups", [1, 16])
@pytest.mark.parametrize("mode", ["A", "B", "C"])
def test_dual_issue_kernel_matches_plain(cuda, mode, groups):
    """The dual-issue kernel against dual_issue_plain at G = 1 and 16: v
    within 1e-6 (expf on both sides, a contracting chain); x (bf16 products,
    f32 sums in other orders, one bf16 ulp moved now and then and carried
    on) every entry within 2% of the largest, 99% within 0.4%;
    bit-identical from run to run."""
    from dpfx_torch.tools import probe_dual_issue as pdi

    g = torch.Generator(device=cuda).manual_seed(4)
    w = (0.05 * torch.randn((3, 128, 128), generator=g, device=cuda)).to(torch.bfloat16)
    x = torch.randn((groups, 128, 256), generator=g, device=cuda)
    v = torch.randn((groups, 8, 256), generator=g, device=cuda)
    mxu, vpu = pdi.MODES[mode]
    pdi.reset_launch_counts()
    ox, ov = pdi.dual_issue_kernel(w, x, v, do_mxu=mxu, do_vpu=vpu)
    again = pdi.dual_issue_kernel(w, x, v, do_mxu=mxu, do_vpu=vpu)
    px, pv = pdi.dual_issue_plain(w, x, v, do_mxu=mxu, do_vpu=vpu)
    torch.cuda.synchronize()
    assert pdi.launches[f"dual_issue_{mode}"] == 2
    assert torch.equal(ox, again[0]) and torch.equal(ov, again[1])
    assert float((ov - pv).abs().max()) <= 1e-6
    err = (ox - px).abs().flatten() / px.abs().max()
    assert float(err.max()) <= 2e-2 and float(torch.quantile(err, 0.99)) <= 4e-3
    with pytest.raises(ValueError, match="multiple"):
        pdi.dual_issue_kernel(w, x[..., :200], v[..., :200], do_mxu=mxu, do_vpu=vpu)


def test_chain_time_ms_on_the_card(cuda):
    """chain_time_ms chains the calls through the carry and times them on
    CUDA events: a positive time, and a non-finite closing value raises."""
    from dpfx_torch.utils.profiling import chain_time_ms

    x = torch.ones((256, 256), device=cuda)
    step = lambda c, i: (c @ x * (1.0 / 256), (c @ x)[0, 0])
    assert chain_time_ms(step, x, reps=5) > 0
    with pytest.raises(AssertionError, match="non-finite"):
        chain_time_ms(lambda c, i: (c, c[0, 0] * float("inf")), x, reps=2)
