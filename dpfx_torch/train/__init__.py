"""Training: the ELBO loss, the optimizer, the train step and the loop.
``python -m dpfx_torch.train CONFIG`` runs it from a YAML config."""

from dpfx_torch.train.loss import elbo_loss
from dpfx_torch.train.trainer import (
    OptState,
    Optimizer,
    TrainDivergedError,
    Trainer,
    TrainState,
    init_params_,
    init_state,
    make_optimizer,
    make_schedule,
    make_train_step,
)

__all__ = ["OptState", "Optimizer", "TrainDivergedError", "Trainer", "TrainState",
           "elbo_loss", "init_params_", "init_state", "make_optimizer", "make_schedule",
           "make_train_step"]
