"""The point flow's f32 training layout (``csrc/flow_f32.cuh``: the f32
sampler's register-tiled device code, fused_train.cu's fwd_f32 and
bwd_f32) on the CPU: its domain (every f32 shape past the block-wide
layout, and the block-wide shapes at H=128), the bf16
routes unchanged, its shared-memory plans through the Python mirror
(``tests/_torch_f32_plan.py``, which the card tests hold to the library)
against the numbers in the header, and, at each of its shapes, the port's
plain f32 forward and backward (what the card holds the kernels to)
against dpfx's fused training kernels in interpret mode on the same
numpy-seeded weights."""

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dpfx.config import config_from_dict as jax_config_from_dict  # noqa: E402
from dpfx.ops import fused_train as jft  # noqa: E402
from dpfx_torch.compat import params_to_flax, randomize_  # noqa: E402
from dpfx_torch.config import config_from_dict  # noqa: E402
from dpfx_torch.models import DPF  # noqa: E402
from dpfx_torch.ops import fused_sampler as tfs  # noqa: E402
from dpfx_torch.ops import fused_train as tft  # noqa: E402
from dpfx_torch.ops._build import SMEM_LIMIT  # noqa: E402
from _torch_cluster_plan import cluster_domain  # noqa: E402
from _torch_f32_plan import (f32_bwd_carve, f32_bwd_plan, f32_domain,  # noqa: E402
                             f32_fwd_smem, f32_part_row)

HEADER = Path(tft.__file__).parent / "csrc" / "flow_f32.cuh"
F32 = torch.float32
# the f32 layout's shapes (kernel H, n_hidden - 1)
SHAPES = [(h, nh1) for h in (128, 256) for nh1 in range(4)]


class _Lib:
    """Stands in for the kernel library's shared-memory queries with the
    Python mirrors (no library is built on the CPU)."""

    @staticmethod
    def dpfx_fused_train_f32_smem_bytes(h, nh1, backward):
        return f32_bwd_plan(h, nh1)[1] if backward else f32_fwd_smem(h)


@pytest.fixture
def mirrored(monkeypatch):
    """fused_train's layout choice on the mirrors: the mma and block-wide
    layouts' depths (LAYOUT_N_HIDDEN, which a card test holds to the
    library), the cluster plan's domain and the f32 layout's bytes."""
    def overflows_block(h, nh1, dtype):
        return nh1 + 1 > tft.LAYOUT_N_HIDDEN[str(dtype).split(".")[-1]][h]

    monkeypatch.setattr(tft, "overflows_block", overflows_block)
    monkeypatch.setattr(tft, "uses_cluster", cluster_domain)
    monkeypatch.setattr(tft, "_f32_lib", lambda: _Lib)
    return tft


def test_every_f32_shape_past_the_block_wide_layout_takes_the_f32_layout(mirrored):
    """In f32 the shapes the block-wide layout cannot hold (H=256 with
    n_hidden 1-4, H=128 with n_hidden 3-4) take the f32 layout; at H=128
    with n_hidden 1-2, where both fit, the f32 layout too (it timed faster);
    H = 32 and 64 and depths past 4 never; the mirror's domain is
    ``uses_f32``."""
    deepest = tft.LAYOUT_N_HIDDEN["float32"]
    past = [(h, nh - 1) for h in sorted(deepest) for nh in range(1, tft.MAX_N_HIDDEN + 1)
            if nh > deepest[h]]
    assert past == [(128, 2), (128, 3), (256, 0), (256, 1), (256, 2), (256, 3)]
    for h in tfs.KERNEL_HIDDEN:
        for nh1 in range(6):
            assert tft.uses_f32(h, nh1, F32) == f32_domain(h, nh1), (h, nh1)
            assert not tft.uses_f32(h, nh1, torch.bfloat16)
            if nh1 + 1 > tft.MAX_N_HIDDEN and nh1 + 1 > deepest[h]:
                continue   # outside the predicate's domain
            for backward in (False, True):
                got = tft._layout(h, nh1, F32, backward)
                if (h, nh1) in past or (h in (128, 256) and nh1 < tft.MAX_N_HIDDEN):
                    assert got == "f32", (h, nh1)
                else:
                    assert got == "parent", (h, nh1)


def test_bf16_routes_are_unchanged(mirrored):
    """bf16 takes the mma layout where it fits, else the cluster layout,
    whose domain is every bf16 shape the mma layout overflows (H=256 with
    n_hidden 4 among them); the f32 layout takes none of them."""
    deepest = tft.LAYOUT_N_HIDDEN["bfloat16"]
    for h in tfs.KERNEL_HIDDEN:
        for nh in range(1, tft.MAX_N_HIDDEN + 1):
            want = "parent" if nh <= deepest[h] else "cluster"
            assert want == "parent" or cluster_domain(h, nh - 1, torch.bfloat16), (h, nh)
            for backward in (False, True):
                assert tft._layout(h, nh - 1, torch.bfloat16, backward) == want, (h, nh)
    assert tft._layout(256, 3, torch.bfloat16, True) == "cluster"


@pytest.mark.parametrize("shape", SHAPES)
def test_f32_plan_fits(shape):
    """Each shape of the layout fits a block forward (the sampler's 128
    points and its log-det row) and backward, at the largest tile of 128
    (64 at H=256), 64, 32 that fits; each layer's partial row is padded to
    a multiple of 4 floats (16-byte dWh rows)."""
    h, nh1 = shape
    t, need = f32_bwd_plan(h, nh1)
    assert need <= SMEM_LIMIT and t in ((64, 32) if h == 256 else (128, 64))
    assert f32_fwd_smem(h) <= SMEM_LIMIT
    assert f32_fwd_smem(h) == f32_fwd_smem(h, logdet=False) + 512
    row = f32_part_row(h, nh1)
    assert row % 4 == 0 and 0 <= row - (3 * h + nh1 * h * h + nh1 * h + 6 * h + 6) < 4
    if t < (64 if h == 256 else 128):
        assert f32_bwd_carve(h, nh1, 2 * t) > SMEM_LIMIT, "the plan is the largest tile that fits"


def test_f32_plan_keeps_the_stream_layouts_tile_at_h256_n_hidden_2():
    """At H=256 with n_hidden 2 the backward takes 64 points a tile (the
    tile of the stream layout that the f32 layout replaced, so the two
    summed every gradient in the same order), and the forward the sampler's 128
    (227,072 B, the sampler's 226,560 and the log-det row)."""
    assert f32_bwd_plan(256, 1) == (64, 228608)
    assert f32_bwd_carve(256, 1, 128) > SMEM_LIMIT
    assert f32_fwd_smem(256) == 227072 and f32_fwd_smem(256, logdet=False) == 226560


def test_sampler_mirror_is_the_walks_carve():
    """fused_sampler.smem_bytes (the sampler wrapper's f32 mirror) is the
    128-point walk's F32Smem without the log-det row at every width."""
    for h in tfs.KERNEL_HIDDEN:
        assert tfs.smem_bytes(h, F32) == f32_fwd_smem(h, logdet=False), h


def test_plan_numbers_in_the_header():
    """The bytes flow_f32.cuh's header states are the mirror's."""
    text = " ".join(HEADER.read_text().replace("//", " ").split())
    num = lambda s: int(s.replace(",", ""))  # noqa: E731
    for h in (256, 128):
        m = re.search(rf"H={h}: n_hidden 1-2 T=(\d+) \(([\d,]+) and ([\d,]+) B\), 3-4 T=(\d+) "
                      rf"\(([\d,]+) and ([\d,]+) B\)", text)
        assert m, h
        t12, a, b, t34, c, d = m.groups()
        assert (int(t12), num(a)) == f32_bwd_plan(h, 0) and (int(t12), num(b)) == f32_bwd_plan(h, 1)
        assert (int(t34), num(c)) == f32_bwd_plan(h, 2) and (int(t34), num(d)) == f32_bwd_plan(h, 3)
    m = re.search(r"The forward's block: ([\d,]+) B at H=128, ([\d,]+) B at H=256", text)
    assert (num(m.group(1)), num(m.group(2))) == (f32_fwd_smem(128), f32_fwd_smem(256))
    assert "226,560 B" in text and "227,072 B" in text


def _block(text: str, start: int) -> str:
    """The braces-balanced block that opens at the first ``{`` from start."""
    i = text.index("{", start)
    depth = 0
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[i:j + 1]
    raise AssertionError("unbalanced braces")


def test_walks_st_code_is_st_f32():
    """f32_walk keeps the (s, t) code in place (nvcc scheduled the sampler
    slower when it called st_f32) while the backward's recompute calls
    st_f32: the two bodies, up to the names of the thread index and the
    tile's points, are one text, so the forward, the inverse and the
    recompute give the same bits."""
    text = HEADER.read_text()
    body = _block(text, text.index("__device__ __forceinline__ void st_f32("))
    walk = _block(text, text.index("// st = Wout . h + bout: st_f32's code, written in place"))
    norm = lambda b: " ".join(  # noqa: E731
        re.sub(r"\bTILE\b", "T", b.replace("threadIdx.x", "tid")).split())
    assert "part[r] = fmaf(wos[r * H + kk], hv, part[r])" in body
    assert norm(body) == norm(walk)


def _setup(hidden, n_hidden, n, n_layers, seed=0):
    raw = {"experiment": "ae", "model": {
        "dz": 16,
        "point_flow": {"n_layers": n_layers, "hidden": hidden, "n_hidden": n_hidden,
                       "compute_dtype": "float32", "scale_cap": 3.0},
        "latent_flow": {"n_layers": 2, "hidden": 32, "n_hidden": 2},
        "encoder": {"point_widths": [32, 64], "head_widths": [32]}}}
    torch.manual_seed(seed)
    model = randomize_(DPF(config_from_dict(raw)), seed, 0.02 * (128 / hidden) ** 0.5)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, n, 3)).astype(np.float32)
    z = rng.normal(size=(2, 16)).astype(np.float32)
    return model, jax_config_from_dict(raw).model.point_flow, x, z


def _leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree["params"]["point_flow"])[0]
    return {"/".join(str(getattr(q, "key", q)) for q in path): np.asarray(v) for path, v in flat}


@pytest.mark.parametrize("hidden,n_hidden,n,n_layers", [
    (256, 1, 130, 3), (256, 2, 40, 2), (256, 3, 77, 2), (256, 4, 40, 2),
    (128, 1, 130, 4), (128, 2, 77, 3), (128, 3, 40, 3), (128, 4, 64, 2)])
def test_f32_shapes_plain_match_jax(hidden, n_hidden, n, n_layers):
    """At each shape of the f32 layout: the log-likelihood through the
    port's fused training path (its plain versions here, what the card
    holds fwd_f32 and bwd_f32 to) and every gradient, against dpfx's
    fused_point_flow_recon_ll (Pallas in interpret mode), at the f32 limits
    of test_torch_fused_train (1e-4 on the value and dx; 1e-4 of each
    gradient's norm)."""
    model, jcfg, x, z = _setup(hidden, n_hidden, n, n_layers)
    sp = tft.stack_point_flow_params(model.point_flow)
    assert tft.uses_f32(sp.wx.shape[1], sp.wh.shape[1], F32)
    params = jax.tree.map(jnp.asarray, params_to_flax(model.state_dict()))
    f = lambda p, xx, zz: jft.fused_point_flow_recon_ll(p, xx, zz, jcfg)  # noqa: E731
    ll_j = np.asarray(f(params, x, z))
    gp, gx, gz = jax.grad(lambda p, xx, zz: f(p, xx, zz).sum(), argnums=(0, 1, 2))(
        params, jnp.asarray(x), jnp.asarray(z))
    xt, zt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(z).requires_grad_(True)
    ll_t = tft.fused_point_flow_recon_ll(model, xt, zt, model.config.model.point_flow)
    ll_t.sum().backward()
    np.testing.assert_allclose(ll_t.detach().numpy(), ll_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-4)
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    lj, lt = _leaves(gp), _leaves(params_to_flax(grads))
    assert lj.keys() == lt.keys()
    pairs = [("z", np.asarray(gz), zt.grad.numpy())] + [(k, lj[k], lt[k]) for k in lj]
    for name, a, b in pairs:
        assert np.linalg.norm(b - a) <= 1e-4 * np.linalg.norm(a) + 1e-6, name
