"""Training substrate of the port: optimizers, train step, checkpointing, fault tolerance."""

from repro_torch.training.checkpoint import AsyncCheckpointer, latest_step, restore, save
from repro_torch.training.optim import OptConfig, make_optimizer
from repro_torch.training.train_step import init_state, make_train_step
from repro_torch.training.watchdog import (
    FailureInjector,
    InjectedFailure,
    StepTimer,
    StragglerWatchdog,
)

__all__ = [
    "AsyncCheckpointer",
    "FailureInjector",
    "InjectedFailure",
    "OptConfig",
    "StepTimer",
    "StragglerWatchdog",
    "init_state",
    "latest_step",
    "make_optimizer",
    "make_train_step",
    "restore",
    "save",
]
