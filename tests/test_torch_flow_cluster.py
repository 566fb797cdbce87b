"""The point flow's cluster layout (``csrc/flow_cluster.cuh``) on the CPU:
its domain (every bf16 shape the mma layout overflows), its shared-memory
plan through the Python mirror
(``tests/_torch_cluster_plan.py``, which the card tests hold to the
library), and, at each of its shapes, the port's plain forward and backward
(what the card holds the cluster kernels to) against dpfx's fused
training kernels in interpret mode on the same numpy-seeded weights."""

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
from dpfx_torch.ops import fused_train as tft  # noqa: E402
from dpfx_torch.ops._build import SMEM_LIMIT  # noqa: E402
from _torch_cluster_plan import (cluster_carve, cluster_domain, cluster_group,  # noqa: E402
                                 cluster_part_row, cluster_plan, cluster_ring)

HEADER = Path(tft.__file__).parent / "csrc" / "flow_cluster.cuh"


def _overflowing_bf16_shapes():
    """(H, n_hidden - 1) of the bf16 shapes the predicate accepts at n_hidden
    <= MAX_N_HIDDEN that the mma layout cannot hold (LAYOUT_N_HIDDEN)."""
    deepest = tft.LAYOUT_N_HIDDEN["bfloat16"]
    return [(h, nh - 1) for h in sorted(deepest)
            for nh in range(1, tft.MAX_N_HIDDEN + 1) if nh > deepest[h]]


def test_cluster_domain_is_every_bf16_overflow_but_one():
    """The cluster layout (its domain by the plan's mirror, which the card
    tests hold to ``uses_cluster``) takes every bf16 shape that leaves the
    mma layout (H=128 with n_hidden 3-4, H=256 with n_hidden 2-4), and
    nothing in f32, nothing the mma layout holds and nothing past n_hidden
    4."""
    over = _overflowing_bf16_shapes()
    assert over == [(128, 2), (128, 3), (256, 1), (256, 2), (256, 3)]
    assert [s for s in over if cluster_domain(*s, torch.bfloat16)] == over
    assert not any(cluster_domain(*s, torch.float32) for s in over)
    assert not cluster_domain(128, 1, torch.bfloat16)
    assert not cluster_domain(128, 4, torch.bfloat16)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("shape", [(128, 2), (128, 3), (256, 1), (256, 2), (256, 3)])
def test_cluster_plan_fits(shape, backward):
    """Each shape of the domain has a plan within a block's shared memory,
    at a tile of 16-point rows whose column groups split the rank's 64
    columns evenly; the forward keeps 128-point tiles where two of them fit
    with one weight stage, the deep H=256 pairs 64-point tiles (the
    forward at n_hidden 4 with 3 tiles a group); the ring streams the
    backward's slabs only where whole-layer stages would cost the tile
    (dWh then spills into the slice), never the forward's, and the ring's
    partial row is a multiple of 4 floats."""
    t, nst, need = cluster_plan(*shape, backward)
    ring = cluster_ring(*shape, backward)
    assert need <= SMEM_LIMIT and nst in (1, 2)
    assert t in (128, 64, 32) and 64 % (128 // t) == 0
    if (not backward and shape[0] == 128) or shape == (256, 1):
        assert t == 128
    if shape[0] == 256 and shape[1] >= 2:
        assert t == 64
    if shape == (128, 3) and backward:
        assert t == 128 and ring
    # the plan is the largest tile that fits, on whole-layer stages where
    # they fit at that tile (the forward with as few as 2 tiles a group)
    if t < 128:
        assert cluster_carve(*shape, backward, 2 * t, 1, False, 4 if backward else 2) > SMEM_LIMIT
        assert not backward or cluster_carve(*shape, True, 2 * t, 1, True) > SMEM_LIMIT
    assert ring == (backward and cluster_carve(*shape, backward, t, 1) > SMEM_LIMIT)
    g = cluster_group(*shape)
    assert g == (3 if shape == (256, 3) else 4)
    assert backward or g == 4 or cluster_carve(*shape, False, t, 1, False, g + 1) > SMEM_LIMIT
    h, nh1 = shape
    plain = 3 * h + nh1 * h * h + nh1 * h + 6 * h + 6
    assert cluster_part_row(h, nh1) - plain == (-plain % 4 if cluster_ring(h, nh1, True) else 0)


def test_h256_n_hidden_4_stays_on_the_stream_layout():
    """H=256 with n_hidden 4 (the last shape the retired stream layout
    took) is the cluster layout's at 64-point tiles: the backward with Wh
    streamed through the ring, where whole-layer stages would need 280,576
    B even at 32-point tiles; the forward on one whole stage with 3 tiles a
    group, where 4 do not fit."""
    assert cluster_domain(256, 3, torch.bfloat16)
    for backward in (False, True):
        t, _, need = cluster_plan(256, 3, backward)
        assert t == 64 and need <= SMEM_LIMIT and cluster_ring(256, 3, backward) == backward
    assert cluster_carve(256, 3, True, 32, 1) == 280576 > SMEM_LIMIT
    assert cluster_group(256, 3) == 3 and cluster_carve(256, 3, False, 64, 1) > SMEM_LIMIT


def test_plan_numbers_in_the_header():
    """The bytes flow_cluster.cuh's header states are the plan's."""
    text = " ".join(HEADER.read_text().replace("//", " ").split())
    fwd, bwd = (int(m.replace(",", "")) for m in re.findall(
        r"forward T=128 with two stages \(([\d,]+) B\), backward T=128 with one \(([\d,]+) "
        r"B\)", text)[0])
    assert (fwd, bwd) == (cluster_plan(256, 1, False)[2], cluster_plan(256, 1, True)[2])
    ring = [int(m.replace(",", "")) for m in re.findall(
        r"H=256 n_hidden 3 backward T=64 \(([\d,]+) B\), n_hidden 4 backward T=64 \(([\d,]+) "
        r"B\), H=128 n_hidden 4 backward T=128 \(([\d,]+) B\); whole-layer stages would need "
        r"([\d,]+) B at T=32 for the n_hidden 4 backward\. The n_hidden 4 forward: T=64, one "
        r"whole stage, (\d) tiles a group \(([\d,]+) B\)", text)[0]]
    assert ring == [cluster_plan(256, 2, True)[2], cluster_plan(256, 3, True)[2],
                    cluster_plan(128, 3, True)[2], cluster_carve(256, 3, True, 32, 1),
                    cluster_group(256, 3), cluster_plan(256, 3, False)[2]]


def _setup(hidden, n_hidden, seed=0):
    raw = {"experiment": "ae", "model": {
        "dz": 16,
        "point_flow": {"n_layers": 2, "hidden": hidden, "n_hidden": n_hidden,
                       "compute_dtype": "bfloat16", "scale_cap": 3.0},
        "latent_flow": {"n_layers": 2, "hidden": 32, "n_hidden": 2},
        "encoder": {"point_widths": [32, 64], "head_widths": [32]}}}
    torch.manual_seed(seed)
    model = randomize_(DPF(config_from_dict(raw)), seed, 0.02 * (128 / hidden) ** 0.5)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 40, 3)).astype(np.float32)
    z = rng.normal(size=(2, 16)).astype(np.float32)
    return model, jax_config_from_dict(raw).model.point_flow, x, z


def _leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree["params"]["point_flow"])[0]
    return {"/".join(str(getattr(q, "key", q)) for q in path): np.asarray(v) for path, v in flat}


@pytest.mark.parametrize("hidden,n_hidden", [(128, 3), (128, 4), (256, 2), (256, 3), (256, 4)])
def test_cluster_shapes_plain_match_jax_bf16(hidden, n_hidden):
    """At each cluster shape, bf16: the log-likelihood through the port's
    fused training path (its plain versions here) and every gradient,
    against dpfx's fused_point_flow_recon_ll (Pallas in interpret mode), at
    the bf16 limits of test_torch_fused_train (1e-3 relative on the value,
    2% of each gradient's norm)."""
    model, jcfg, x, z = _setup(hidden, n_hidden)
    sp = tft.stack_point_flow_params(model.point_flow)
    assert cluster_domain(sp.wx.shape[1], sp.wh.shape[1], torch.bfloat16)
    params = jax.tree.map(jnp.asarray, params_to_flax(model.state_dict()))
    f = lambda p, xx, zz: jft.fused_point_flow_recon_ll(p, xx, zz, jcfg)  # noqa: E731
    ll_j = np.asarray(f(params, x, z))
    gp, gx, gz = jax.grad(lambda p, xx, zz: f(p, xx, zz).sum(), argnums=(0, 1, 2))(
        params, jnp.asarray(x), jnp.asarray(z))
    xt, zt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(z).requires_grad_(True)
    ll_t = tft.fused_point_flow_recon_ll(model, xt, zt, model.config.model.point_flow)
    ll_t.sum().backward()
    np.testing.assert_allclose(ll_t.detach().numpy(), ll_j, rtol=1e-3)
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    lj, lt = _leaves(gp), _leaves(params_to_flax(grads))
    assert lj.keys() == lt.keys()
    pairs = [("x", np.asarray(gx), xt.grad.numpy()), ("z", np.asarray(gz), zt.grad.numpy())]
    for name, a, b in pairs + [(k, lj[k], lt[k]) for k in lj]:
        assert np.linalg.norm(b - a) <= 2e-2 * np.linalg.norm(a) + 1e-6, name


def test_launch_counts_by_layout():
    """``layout_launches`` counts the wrappers' launches by the layout that
    ran them, beside ``launches``; ``reset_launch_counts`` zeroes both, and
    the plain versions (a CPU tensor) count nothing."""
    assert set(tft.layout_launches) == {f"{lay}_{d}" for lay in ("parent", "cluster", "f32")
                                        for d in ("fwd", "bwd")}
    tft.launches["fused_train_fwd"] = 3
    tft.layout_launches["cluster_bwd"] = 2
    tft.reset_launch_counts()
    assert not any(tft.launches.values()) and not any(tft.layout_launches.values())
    model, _, x, z = _setup(256, 2)
    tft.fused_point_flow_recon_ll(model, torch.from_numpy(x), torch.from_numpy(z),
                                  model.config.model.point_flow).sum()
    assert not any(tft.launches.values()) and not any(tft.layout_launches.values())
