"""Configs that the training tests of the port share (no JAX: the card
tests import this too): the tiny generative model of
tests/test_torch_train.py, and its tanh variant under an annealed jitter
and a clipped, warmed-up schedule, which the trajectory tests use (tanh has
no relu gate for a near-zero pre-activation to open in one package and not
in the other)."""


def tiny(**train):
    return {"experiment": "gen", "name": "t", "model": {
        "dz": 16,
        "point_flow": {"n_layers": 4, "hidden": 32, "n_hidden": 2, "scale_cap": 3.0},
        "latent_flow": {"n_layers": 4, "hidden": 32, "n_hidden": 2},
        "encoder": {"point_widths": [32, 64], "head_widths": [32]}},
        "data": {"dataset": "synthetic", "n_points": 64, "synthetic_size": 32},
        "train": {"batch_size": 4, "steps": 5, "lr": 1e-3, "flat_optimizer": False, **train}}


def tanh_jitter(**train):
    raw = tiny(**{"grad_clip": 1.0, "lr_warmup_steps": 1, "lr": 3e-3, "augment_noise": 0.05,
                  "augment_noise_final": 0.01, "augment_noise_anneal_steps": 4, **train})
    for part in ("point_flow", "latent_flow", "encoder"):
        raw["model"][part]["activation"] = "tanh"
    return raw
