"""The port's reference-layout converter (dpfx_torch.compat.convert and
python -m dpfx_torch.convert_checkpoint) against dpfx's: a torch-mirror
state dict (dpfx.compat.torch_mirror.DPFMirror, the reference's naming)
of a generation model and of SVR with the conv and the mixer image
encoders converts to dpfx's flax tree leaf for leaf and to
params_from_flax of it exactly; the example rules file; strictness; the
nested layouts; the CLI into generate --weights."""

from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from dpfx.compat import convert_state_dict as jax_convert  # noqa: E402
from dpfx.compat.torch_mirror import DPFMirror  # noqa: E402
from dpfx.config import load_config as jax_load_config  # noqa: E402
from dpfx_torch import convert_checkpoint, generate  # noqa: E402
from dpfx_torch.compat import (DEFAULT_RULES, convert_state_dict, flatten_tree,  # noqa: E402
                               load_rules_file, load_torch_checkpoint, params_from_flax)
from dpfx_torch.config import load_config  # noqa: E402
from dpfx_torch.models import DPF  # noqa: E402
from dpfx_torch.sampling import make_sampler  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GEN = str(ROOT / "configs" / "smoke_gen_synthetic.yaml")
SVR = str(ROOT / "configs" / "smoke_svr_synthetic.yaml")
RULES = str(ROOT / "configs" / "convert_rules_example.yaml")
CASES = {"gen": (GEN, []), "svr_mixer": (SVR, []),
         "svr_conv": (SVR, ["model.image_encoder.arch=conv"])}


def _mirror(case, seed=0):
    path, over = CASES[case]
    mirror = DPFMirror(jax_load_config(path, overrides=over))
    mirror.randomize_(seed)
    return mirror, load_config(path, overrides=over)


@pytest.fixture(scope="module", params=list(CASES))
def converted(request, tmp_path_factory):
    mirror, cfg = _mirror(request.param)
    sd = mirror.state_dict()
    pt = tmp_path_factory.mktemp("ckpt") / "ref.pt"
    torch.save(sd, pt)
    return request.param, mirror, cfg, sd, str(pt)


def test_tree_equals_dpfx_leaf_for_leaf(converted):
    _, _, _, sd, _ = converted
    ours, ref = flatten_tree(convert_state_dict(sd)), flatten_tree(jax_convert(sd))
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        assert ours[k].dtype == np.float32 and ours[k].shape == v.shape, k
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


def test_state_dict_equals_params_from_flax_of_dpfx(converted):
    """Exactly, key for key; an SVR checkpoint's PointNet encoder (which
    the port's SVR model has none of) is checked and left out."""
    case, mirror, cfg, sd, pt = converted
    ours = load_torch_checkpoint(pt, cfg)
    ref = params_from_flax(jax_convert(sd)["params"])
    if case != "gen":
        assert any(k.startswith("encoder.") for k in ref)
        ref = {k: v for k, v in ref.items() if not k.startswith("encoder.")}
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        assert torch.equal(ours[k], v), k
    DPF(cfg).load_state_dict(ours, strict=True)
    # conv kernels OIHW -> HWIO -> OIHW and norm weights come back as they were
    msd = mirror.state_dict()
    for k, v in ours.items():
        if k.startswith("image_encoder.") and (v.ndim == 4 or v.ndim == 1 and "weight" in k):
            assert torch.equal(v, msd[k]), k
    if case == "svr_conv":
        w = msd["image_encoder.Conv_0.weight"]
        assert not torch.equal(w, w.transpose(2, 3))     # an asymmetric 3x3 kernel


def test_posterior_equals_the_mirror(converted):
    case, mirror, cfg, _, pt = converted
    model = DPF(cfg)
    model.load_state_dict(load_torch_checkpoint(pt, cfg), strict=True)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        if case == "gen":
            x = torch.from_numpy(rng.normal(size=(2, 64, 3)).astype(np.float32))
            ours, ref = model.posterior(x), mirror.encoder(x)
        else:
            s = cfg.model.image_encoder.image_size
            img = torch.from_numpy(rng.uniform(size=(2, s, s, 3)).astype(np.float32))
            ours, ref = model.posterior(None, img), mirror.image_encoder(img)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_example_rules_file_reproduces_the_defaults(converted):
    _, _, cfg, sd, pt = converted
    rules = load_rules_file(RULES)
    assert [r[0] for r in rules] == [r[0] for r in DEFAULT_RULES]
    a = load_torch_checkpoint(pt, cfg, rules)
    b = load_torch_checkpoint(pt, cfg)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_strict_unmatched_keys_raise(tmp_path):
    mirror, cfg = _mirror("gen")
    sd = {**mirror.state_dict(), "mystery.weight": torch.zeros(3)}
    with pytest.raises(KeyError, match="mystery.weight"):
        convert_state_dict(sd)
    assert "mystery" not in convert_state_dict(sd, strict=False)["params"]
    pt = tmp_path / "x.pt"
    torch.save(sd, pt)
    with pytest.raises(KeyError):
        load_torch_checkpoint(str(pt), cfg)
    assert DPF(cfg).load_state_dict(load_torch_checkpoint(str(pt), cfg, strict=False))


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_mismatch_against_the_config_raises(tmp_path, fault):
    mirror, cfg = _mirror("gen")
    sd = mirror.state_dict()
    if fault == "missing":
        sd.pop("point_flow.couplings.0.cond_net.in_x.bias")
        cfg_check, match = cfg, "missing: point_flow.coupling_0.cond_net.in_x.bias"
    else:
        cfg_check = load_config(GEN, overrides=["model.point_flow.hidden=48"])
        match = "shape mismatch at point_flow.coupling_0.cond_net.in_x.weight"
    pt = tmp_path / "x.pt"
    torch.save(sd, pt)
    with pytest.raises(ValueError, match=match):
        load_torch_checkpoint(str(pt), cfg_check)


@pytest.mark.parametrize("wrap", ["state_dict", "model", "model_state", "net"])
def test_nested_layouts_unwrap(tmp_path, wrap):
    mirror, cfg = _mirror("gen")
    pt = tmp_path / "wrapped.pt"
    torch.save({wrap: mirror.state_dict(), "epoch": 3}, pt)
    ref = params_from_flax(jax_convert(mirror.state_dict())["params"])
    ours = load_torch_checkpoint(str(pt), cfg)
    assert ours.keys() == ref.keys() and all(torch.equal(ours[k], ref[k]) for k in ref)


def test_cli_into_generate(tmp_path, capsys):
    mirror, cfg = _mirror("gen", seed=4)
    pt, out = tmp_path / "ref ckpt.pt", tmp_path / "w.pt"
    torch.save({"state_dict": mirror.state_dict()}, pt)
    assert convert_checkpoint.main([str(pt), GEN, "--out", str(out), "--rules", RULES]) == 0
    text = capsys.readouterr().out
    assert "verified against the config" in text
    assert f"python -m dpfx_torch.generate {GEN} --weights {out}" in text
    samples = tmp_path / "s.npy"
    assert generate.main([GEN, "--device", "cpu", "--weights", str(out), "--n-clouds", "3",
                          "--n-points", "64", "--out", str(samples), "--seed", "5"]) == 0
    model = DPF(cfg)
    model.load_state_dict(params_from_flax(jax_convert(mirror.state_dict())["params"]))
    ref = make_sampler(model.eval(), 3, 64)(5).numpy()
    np.testing.assert_array_equal(np.load(samples), ref)
    other = tmp_path / "other.yaml"
    other.write_text(Path(GEN).read_text().replace("hidden: 64, n_hidden: 2}\n  latent",
                                                    "hidden: 48, n_hidden: 2}\n  latent"))
    assert load_config(str(other)).model.point_flow.hidden == 48
    with pytest.raises(ValueError, match="shape mismatch"):
        convert_checkpoint.main([str(pt), str(other), "--out", str(out)])
