"""The sampler's cluster inverse (``inv_cluster`` in
``dpfx_torch/ops/csrc/flow_cluster.cuh``) and its streamed f32 layout on
the CPU: the route (``fused_sampler.inverse_layout``: the cluster inverse
exactly at the training kernels' bf16 cluster shapes that it is built for;
at H=256 for every activation and the int8 mode, at H=128 for relu with
weights in bf16), the inverse's plan through the Python mirror
(``tests/_torch_cluster_plan.py``, which the card tests hold to the
library), the f32 kernel's shared memory (``smem_bytes`` against the
carve of ``F32Smem``), and at each cluster shape the port's plain inverse
(what the card holds the kernel to) against dpfx's fused inverse in
interpret mode on the same numpy-seeded weights, with the other
activations at H=256 too; the int8 plain path against the plain path on
the dequantized stacks."""

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dpfx.ops import fused_sampler as jfs  # noqa: E402
from dpfx_torch.compat import params_to_flax, randomize_  # noqa: E402
from dpfx_torch.config import config_from_dict  # noqa: E402
from dpfx_torch.models import DPF  # noqa: E402
from dpfx_torch.ops import fused_sampler as tfs  # noqa: E402
from dpfx_torch.ops import fused_train as tft  # noqa: E402
from dpfx_torch.ops._build import SMEM_LIMIT  # noqa: E402
from _torch_cluster_plan import (cluster_domain, cluster_group, cluster_plan,  # noqa: E402
                                 inverse_plan)

SAMPLER_SRC = Path(tfs.__file__).parent / "csrc" / "fused_sampler.cu"
# the cluster inverse's shapes (kernel H, n_hidden - 1)
CLUSTER_SHAPES = [(128, 2), (128, 3), (256, 1), (256, 2), (256, 3)]
OTHER_ACTS = ("gelu", "tanh", "leaky_relu")


@pytest.fixture
def mirror_route(monkeypatch):
    """``uses_cluster`` by the plan's mirror (the library needs nvcc; the
    card test holds the mirror to the library)."""
    monkeypatch.setattr(tft, "uses_cluster", cluster_domain)


@pytest.mark.parametrize("hidden", tfs.KERNEL_HIDDEN)
def test_route_takes_the_cluster_inverse_at_the_cluster_shapes(mirror_route, hidden):
    """bf16: the cluster inverse exactly where the training kernels take
    their cluster layout and it is built, for relu with bf16 weights but
    at ROWS_KEPT, for the other cases those of CLUSTER_CASES; rows_kernel
    elsewhere; never in f32. At H=256 with n_hidden 2-4 every activation,
    with bf16 and with int8 weights, takes it."""
    bf = torch.bfloat16
    for nh1 in range(6):
        shape = (hidden, nh1)
        here = cluster_domain(hidden, nh1, bf) and shape in tfs.CLUSTER_INVERSE
        acts, int8_acts = tfs.CLUSTER_CASES.get(shape, ((), ()))
        assert tfs.inverse_layout(hidden, nh1, bf) == \
            ("cluster" if here and shape not in tfs.ROWS_KEPT else "rows"), nh1
        for act in ("relu",) + OTHER_ACTS:
            assert tfs.inverse_layout(hidden, nh1, torch.float32, act) == "f32"
            assert tfs.inverse_layout(hidden, nh1, torch.float32, act, int8=True) == "f32"
            assert tfs.inverse_layout(hidden, nh1, bf, act, int8=True) == \
                ("cluster" if here and act in int8_acts else "rows"), (nh1, act)
            if act != "relu":
                assert tfs.inverse_layout(hidden, nh1, bf, act) == \
                    ("cluster" if here and act in acts else "rows"), (nh1, act)
            if hidden == 256 and 1 <= nh1 <= 3:
                assert tfs.inverse_layout(hidden, nh1, bf, act) == "cluster"
                assert tfs.inverse_layout(hidden, nh1, bf, act, int8=True) == "cluster"
    taken = [(hidden, nh1) for nh1 in range(6) if tfs.inverse_layout(hidden, nh1, bf) == "cluster"]
    assert set(taken) <= set(CLUSTER_SHAPES)


def test_h256_n_hidden_4_samples_on_inv_cluster(mirror_route):
    """H=256 with n_hidden 4 trains on the cluster layout, whose forward
    stages whole layers (T=64, one stage, 3 tiles a group), so the inverse
    runs on that plan: the bf16 sampler takes inv_cluster there for every
    activation and the int8 mode. The route's shapes are exactly the
    instances csrc/fused_sampler.cu dispatches."""
    assert cluster_domain(256, 3, torch.bfloat16)
    assert tfs.inverse_layout(256, 3, torch.bfloat16) == "cluster"
    assert tfs.inverse_layout(256, 2, torch.bfloat16) == "cluster"
    src = SAMPLER_SRC.read_text()
    built = re.findall(r"if \(H == (\d+) && NH1 == (\d+)\)",
                       src.split("#define DPFX_DISPATCH_INVERSE")[1]
                       .split("return (int)(NONE)")[0])
    assert [(int(h), int(n)) for h, n in built] == list(tfs.CLUSTER_INVERSE) == CLUSTER_SHAPES
    assert sorted(tfs.CLUSTER_CASES) == CLUSTER_SHAPES


def test_cluster_cases_are_the_librarys():
    """CLUSTER_CASES is what csrc/fused_sampler.cu builds: the other
    activations with bf16 weights at every shape (one runtime instance),
    int8 relu where int8_relu_case holds, int8 with the other activations
    where int8_other_case holds (the predicates read from the source)."""
    src = SAMPLER_SRC.read_text()
    preds = {}
    for name in ("int8_relu_case", "int8_other_case"):
        m = re.search(r"constexpr bool %s = ([^;]+);" % name, src)
        assert m, name
        preds[name] = m.group(1).replace("||", "or").replace("&&", "and")
    for (h, nh1), (acts, int8_acts) in tfs.CLUSTER_CASES.items():
        env = {"H": h, "NH1": nh1}
        assert tuple(acts) == OTHER_ACTS, (h, nh1)
        assert ("relu" in int8_acts) == eval(preds["int8_relu_case"], {}, env), (h, nh1)
        other = [a in int8_acts for a in OTHER_ACTS]
        assert all(other) == any(other) == eval(preds["int8_other_case"], {}, env), (h, nh1)


def test_rows_kept_are_cluster_shapes():
    """The shapes that stay on rows_kernel are shapes of the cluster layout
    (anything else is rows_kernel's anyway)."""
    assert set(tfs.ROWS_KEPT) <= set(CLUSTER_SHAPES)


@pytest.mark.parametrize("shape", CLUSTER_SHAPES)
def test_inverse_plan_fits_and_is_the_forwards(shape):
    """The inverse runs on the forward's plan, which fits a block at every
    routed shape; a carve of its own (no log-det row or sums, 2,176 B less
    at T=128) would pick the same tile, tiles a group and stages, so
    sharing the plan costs no shape a larger tile, a larger group or a
    second stage (H=256 with n_hidden 4: T=64, 3 tiles, one stage)."""
    t, nst, need = cluster_plan(*shape, False)
    assert need <= SMEM_LIMIT and cluster_domain(*shape, torch.bfloat16)
    ti, gi, nsti, needi = inverse_plan(*shape)
    assert (ti, gi, nsti) == (t, cluster_group(*shape), nst) and needi < need


def _f32_carve(h):
    """F32Smem(H) of csrc/fused_sampler.cu, written out: the 128 points in
    rows of H + 1, their x [3][128] and (s, t) [6][128], then nbuf chunk
    buffers (KC columns of Wh in rows of KC + 1, then bh [H]) and nbuf
    small sets (Wx [H][3], hz [H], Wout [6][H], bout [8]), each part
    rounded up to 128 B."""
    r = lambda n: (n + 127) // 128 * 128  # noqa: E731
    kc = h if h <= 128 else 32
    nbuf = 2 if h >= 128 else 1
    parts = [r(128 * (h + 1) * 4), r(3 * 128 * 4), r(6 * 128 * 4)]
    parts += nbuf * [r(h * (kc + 1) * 4) + r(h * 4)]
    parts += nbuf * [r(3 * h * 4) + r(h * 4) + r(6 * h * 4) + r(8 * 4)]
    return sum(parts)


@pytest.mark.parametrize("hidden", tfs.KERNEL_HIDDEN)
def test_f32_smem_is_the_carve_and_fits(hidden):
    """smem_bytes in f32 is F32Smem's size at every width and depth, and a
    block holds it; at H=256 two chunk buffers of 64 columns would not fit
    beside the points, two of 32 do."""
    for nh1 in range(5):
        for int8 in (False, True):
            assert tfs.smem_bytes(hidden, torch.float32, nh1, int8) == _f32_carve(hidden)
    assert _f32_carve(hidden) <= SMEM_LIMIT
    if hidden == 256:
        r = lambda n: (n + 127) // 128 * 128  # noqa: E731
        assert _f32_carve(256) + 2 * (r(256 * 65 * 4) - r(256 * 33 * 4)) > SMEM_LIMIT
        assert _f32_carve(256) == 226560


def test_f32_chunk_width_in_the_source():
    """The chunk width and the streamed widths that smem_bytes mirrors are
    the kernel's (its f32 device code is in flow_f32.cuh, which the sampler
    includes)."""
    header = SAMPLER_SRC.parent / "flow_f32.cuh"
    assert '#include "flow_f32.cuh"' in SAMPLER_SRC.read_text()
    text = SAMPLER_SRC.read_text() + header.read_text()
    assert "constexpr int f32_kc(int H) { return H <= 128 ? H : 32; }" in text
    assert "constexpr bool f32_pipe(int H) { return H >= 128; }" in text
    assert "ld = H + 1;" in text and "wbh = round128(H * (f32_kc(H) + 1) * 4);" in text
    assert "226,560 B" in " ".join(text.replace("//", " ").split())


def _models(hidden, n_hidden, seed):
    raw = {"experiment": "gen", "model": {
        "dz": 16,
        "point_flow": {"n_layers": 2, "hidden": hidden, "n_hidden": n_hidden,
                       "compute_dtype": "bfloat16", "scale_cap": 3.0},
        "latent_flow": {"n_layers": 2, "hidden": 32, "n_hidden": 2},
        "encoder": {"point_widths": [32, 64], "head_widths": [32]}}}
    torch.manual_seed(seed)
    model = randomize_(DPF(config_from_dict(raw)), seed, 0.02 * (128 / hidden) ** 0.5)
    params = params_to_flax(model.state_dict())
    return model, {"params": dict(params["params"])}


@pytest.mark.parametrize("hidden,n_hidden", [(128, 3), (128, 4), (256, 2), (256, 3), (256, 4)])
def test_cluster_shapes_plain_inverse_matches_jax_bf16(hidden, n_hidden):
    """At each cluster shape, bf16, K=2, B=2, N=128: the port's plain
    inverse (what the card holds inv_cluster to) against dpfx's
    fused_point_flow_inverse (Pallas in interpret mode), at the bf16 value
    limit of test_cluster_shapes_plain_match_jax_bf16 (1e-3 relative, here
    of the norm: coordinates near 0 have no relative error to speak of);
    rows 3-7 of a C=8 input pass through."""
    model, params = _models(hidden, n_hidden, seed=hidden + n_hidden)
    with torch.no_grad():
        sp = tfs.stack_point_flow_params(model.point_flow)
    assert cluster_domain(sp.wx.shape[1], sp.wh.shape[1], torch.bfloat16)
    rng = np.random.default_rng(n_hidden)
    u = rng.normal(size=(2, 128, 3)).astype(np.float32)
    z = rng.normal(size=(2, 16)).astype(np.float32)
    x = tfs.fused_point_flow_inverse(sp, torch.from_numpy(u), torch.from_numpy(z),
                                     dtype=torch.bfloat16).numpy()
    jp = jfs.stack_point_flow_params(params, 3.0)
    ref = np.asarray(jfs.fused_point_flow_inverse(jp, jnp.asarray(u), jnp.asarray(z),
                                                  dtype=jnp.bfloat16))
    assert np.abs(x - u).max() > 0.1            # the flow moved the points
    assert np.linalg.norm(x - ref) <= 1e-3 * np.linalg.norm(ref), np.abs(x - ref).max()
    ut = np.concatenate([u.transpose(0, 2, 1), rng.normal(size=(2, 5, 128)).astype(np.float32)], 1)
    out = tfs.fused_inverse_transposed(sp, torch.from_numpy(ut), torch.from_numpy(z),
                                       dtype=torch.bfloat16).numpy()
    np.testing.assert_array_equal(out[:, :3].transpose(0, 2, 1), x)
    np.testing.assert_array_equal(out[:, 3:], ut[:, 3:])


@pytest.mark.parametrize("n_hidden", [2, 4])
@pytest.mark.parametrize("activation", OTHER_ACTS)
def test_h256_other_activations_plain_inverse_matches_jax_bf16(mirror_route, activation,
                                                               n_hidden):
    """At H=256 with n_hidden 2 and 4 (inv_cluster<256, 1> and <256, 3>),
    bf16, K=2, B=2, N=128: the port's plain inverse with gelu, tanh and
    leaky_relu, what the card holds the cluster inverse's runtime
    activation to, against dpfx's fused_point_flow_inverse (Pallas in
    interpret mode) with the same activation on the same numpy-seeded
    weights, at test_cluster_shapes_plain_inverse_matches_jax_bf16's limit
    (1e-3 of the norm); the route takes the cluster inverse there."""
    assert tfs.inverse_layout(256, n_hidden - 1, torch.bfloat16, activation) == "cluster"
    model, params = _models(256, n_hidden, seed=7 * n_hidden + len(activation))
    with torch.no_grad():
        sp = tfs.stack_point_flow_params(model.point_flow)
    rng = np.random.default_rng(10 + n_hidden)
    u = rng.normal(size=(2, 128, 3)).astype(np.float32)
    z = rng.normal(size=(2, 16)).astype(np.float32)
    x = tfs.fused_point_flow_inverse(sp, torch.from_numpy(u), torch.from_numpy(z),
                                     dtype=torch.bfloat16, activation=activation).numpy()
    jp = jfs.stack_point_flow_params(params, 3.0)
    ref = np.asarray(jfs.fused_point_flow_inverse(jp, jnp.asarray(u), jnp.asarray(z),
                                                  dtype=jnp.bfloat16, activation=activation))
    relu = tfs.fused_point_flow_inverse(sp, torch.from_numpy(u), torch.from_numpy(z),
                                        dtype=torch.bfloat16).numpy()
    assert np.abs(x - u).max() > 0.02           # the flow moved the points
    assert np.abs(x - relu).max() > 1e-4        # ... otherwise than relu does
    assert np.linalg.norm(x - ref) <= 1e-3 * np.linalg.norm(ref), np.abs(x - ref).max()


@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_h256_n_hidden_4_int8_plain_is_the_dequantized_plain(mirror_route, activation):
    """The int8 mode at H=256 with n_hidden 4 (the cluster inverse's route
    on the card): on the CPU its plain path is the plain path on
    ``dequantize``'s stacks, bit for bit, noise included, which is what
    the card holds the int8 kernel to; the quantization moves the clouds."""
    assert tfs.inverse_layout(256, 3, torch.bfloat16, activation, int8=True) == "cluster"
    model, _ = _models(256, 4, seed=13)
    with torch.no_grad():
        sp = tfs.stack_point_flow_params(model.point_flow)
    q = tfs.quantize_flow_params(sp)
    dq = tfs.dequantize(q)
    assert q.sp.wh.dtype == torch.int8 and q.sp.wh.shape == sp.wh.shape == (2, 3, 256, 256)
    z = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 16)).astype(np.float32))
    kw = dict(dtype=torch.bfloat16, activation=activation, return_noise=True)
    x8, u8 = tfs.fused_sample_points(sp, z, 21, 128, quantized=q, **kw)
    xd, ud = tfs.fused_sample_points(sp._replace(wx=dq.wx, wh=dq.wh, wout=dq.wout), z, 21, 128,
                                     **kw)
    xb, _ = tfs.fused_sample_points(sp, z, 21, 128, **kw)
    assert torch.equal(x8, xd) and torch.equal(u8, ud)
    assert not torch.equal(x8, xb) and float((x8 - xb).abs().max()) < 0.1


def test_layout_counts_reset_and_stay_zero_on_the_cpu():
    """``layout_launches`` names the three layouts; ``reset_launch_counts``
    zeroes it with ``launches``, and the plain versions count nothing."""
    assert set(tfs.layout_launches) == {"rows", "cluster", "f32"}
    tfs.layout_launches["cluster"] = 2
    tfs.launches["fused_sample"] = 1
    tfs.reset_launch_counts()
    assert not any(tfs.layout_launches.values()) and not any(tfs.launches.values())
    model, _ = _models(256, 2, seed=1)
    with torch.no_grad():
        sp = tfs.stack_point_flow_params(model.point_flow)
    tfs.fused_sample_points(sp, torch.zeros(2, 16), 3, 64)
    assert not any(tfs.layout_launches.values()) and not any(tfs.launches.values())
