"""Training: the ELBO loss, the optimizer, the train step, K steps per call
on a captured step, the device-resident draw, the validation step,
full-state checkpoints and the loop (evaluation, resume, recovery).
``python -m dpfx_torch.train CONFIG`` runs it from a YAML config."""

from dpfx_torch.train.loss import elbo_loss
from dpfx_torch.train.trainer import (
    CheckpointManager,
    MultiStep,
    OptState,
    Optimizer,
    TrainDivergedError,
    Trainer,
    TrainState,
    gather_resident,
    init_params_,
    init_state,
    make_eval_step,
    make_multi_step,
    make_optimizer,
    make_resident_multi_step,
    make_schedule,
    make_train_step,
    resident_draw,
)

__all__ = ["CheckpointManager", "MultiStep", "OptState", "Optimizer", "TrainDivergedError",
           "Trainer", "TrainState", "elbo_loss", "gather_resident", "init_params_", "init_state",
           "make_eval_step", "make_multi_step", "make_optimizer", "make_resident_multi_step",
           "make_schedule", "make_train_step", "resident_draw"]
