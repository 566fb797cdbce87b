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


def card_loop(fused_latent=False, **train):
    """A small bf16 model on every training kernel (the latent flow fused or
    not), for the trainer loop on the card: resume after a capture, the
    recovery's recapture, evaluation against the CPU."""
    return {"experiment": "gen", "name": "loop", "model": {
        "dz": 32,
        "point_flow": {"n_layers": 4, "hidden": 32, "n_hidden": 2, "compute_dtype": "bfloat16"},
        "latent_flow": {"n_layers": 4, "hidden": 64, "n_hidden": 2, "compute_dtype": "bfloat16"},
        "encoder": {"point_widths": [32, 64], "head_widths": [32], "compute_dtype": "bfloat16"}},
        "data": {"dataset": "synthetic", "n_points": 256, "synthetic_size": 32},
        "train": {"batch_size": 4, "fused_point_flow": True, "fused_encoder": True,
                  "fused_latent_flow": fused_latent, "grad_clip": 1.0, "lr_warmup_steps": 2,
                  "augment_noise": 0.02, **train}}


def poisoned_batches(calls, b, n, poison_after, seed=0):
    """make_batches for fit_auto: each call appends to ``calls`` and returns
    an endless stream of [b, n, 3] N(0, 1) batches; the first stream carries
    an inf from batch ``poison_after + 1`` on, later streams are clean."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def make_batches():
        calls.append(1)
        first = len(calls) == 1

        def gen():
            k = 0
            while True:
                k += 1
                x = rng.normal(size=(b, n, 3)).astype(np.float32)
                if first and k > poison_after:
                    x[0, 0, 0] = np.inf
                yield {"x": x}

        return gen()

    return make_batches
