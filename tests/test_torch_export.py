"""export_checkpoint_torch.py: a dpfx params-only orbax checkpoint (written
by dpfx.compat.save_as_orbax) exported to the flattened .npz that
dpfx_torch.checkpoint reads; the port's ELBO on the exported weights
equals dpfx's on the restored checkpoint within 1e-5 (f32), for a
generation model and for SVR."""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dpfx.compat import save_as_orbax  # noqa: E402
from dpfx.config import load_config as jax_load_config  # noqa: E402
from dpfx.models import DPF as JaxDPF  # noqa: E402
from dpfx.train.trainer import CheckpointManager  # noqa: E402
from dpfx_torch.checkpoint import restore_for_eval  # noqa: E402
from dpfx_torch.compat import params_to_flax, randomize_  # noqa: E402
from dpfx_torch.config import load_config  # noqa: E402
from dpfx_torch.models import DPF  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {"gen": ROOT / "configs" / "smoke_gen_synthetic.yaml",
           "svr": ROOT / "configs" / "smoke_svr_synthetic.yaml"}


def _script():
    spec = importlib.util.spec_from_file_location("export_checkpoint_torch",
                                                  ROOT / "export_checkpoint_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_script_imports_no_torch():
    import ast

    tree = ast.parse((ROOT / "export_checkpoint_torch.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not any(m.split(".")[0] == "torch" for m in names)


@pytest.mark.parametrize("case", ["gen", "svr"])
def test_exported_weights_give_dpfx_elbo(tmp_path, case, capsys):
    path = str(CONFIGS[case])
    over = [f"train.ckpt_dir={tmp_path / 'runs'}"]
    cfg, jcfg = load_config(path, overrides=over), jax_load_config(path, overrides=over)
    source = randomize_(DPF(cfg), seed=2, scale=0.05)
    save_as_orbax(params_to_flax(source.state_dict()), str(tmp_path / "runs" / jcfg.name), step=7)
    out = tmp_path / "w.npz"
    assert _script().main([path, *over, "--out", str(out)]) == 0
    assert f"exported step 7 of {jcfg.name}" in capsys.readouterr().out
    model = restore_for_eval(cfg, str(out), "cpu")
    for k, v in source.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k

    # dpfx's model on the params it restores from the checkpoint (its own
    # restore_for_eval, as the script's, but without a second model init)
    jmodel = JaxDPF(jcfg)
    jparams = CheckpointManager(str(tmp_path / "runs" / jcfg.name)).restore_params(None, 7)
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(3, 1, 3)) + 0.4 * rng.normal(size=(3, 96, 3))).astype(np.float32)
    eps = rng.normal(size=(3, cfg.model.dz)).astype(np.float32)
    img = None
    if case == "svr":
        s = cfg.model.image_encoder.image_size
        img = rng.uniform(size=(3, s, s, 3)).astype(np.float32)
    with torch.no_grad():
        ours = model.elbo_terms(torch.from_numpy(x), torch.from_numpy(eps),
                                image=None if img is None else torch.from_numpy(img))
    ref = jax.jit(lambda p, *a: jmodel.apply(p, *a, method=jmodel.elbo_terms))(
        jparams, jnp.asarray(x), jax.random.PRNGKey(0), None if img is None else jnp.asarray(img),
        jnp.asarray(eps))
    elbo = lambda t: np.asarray(t["recon_ll"] + t["logp_z"] - t["logq"])  # noqa: E731
    for k in ("recon_ll", "logp_z", "logq"):
        np.testing.assert_allclose(np.asarray(ours[k]), np.asarray(ref[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(elbo({k: ours[k].numpy() for k in ours}), elbo(ref), rtol=1e-5)


def test_step_and_missing_checkpoint(tmp_path):
    path = str(CONFIGS["gen"])
    over = [f"train.ckpt_dir={tmp_path / 'runs'}"]
    cfg, jcfg = load_config(path, overrides=over), jax_load_config(path, overrides=over)
    run = str(tmp_path / "runs" / jcfg.name)
    models = {step: randomize_(DPF(cfg), seed=step) for step in (3, 9)}
    for step, m in models.items():
        save_as_orbax(params_to_flax(m.state_dict()), run, step)
    out = tmp_path / "w3"           # the script adds .npz
    assert _script().main([path, *over, "--step", "3", "--out", str(out)]) == 0
    got = restore_for_eval(cfg, str(out) + ".npz", "cpu").state_dict()
    assert all(torch.equal(got[k], v) for k, v in models[3].state_dict().items())
    with pytest.raises(FileNotFoundError):
        _script().main([path, f"train.ckpt_dir={tmp_path / 'none'}", "--out", str(out)])
