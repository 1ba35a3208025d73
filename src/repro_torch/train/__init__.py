"""Training of the port (`repro.train`): the sharding rules, the loss and
the train step.  The models import `sharding` (`constrain`), and the train
step imports the models and the optimizer, so `train_step`'s names load
on first use."""
from .sharding import (ShardingPlan, batch_pspec, constrain, make_plan, resolve_specs,
                       set_activation_plan, use_plan)

_TRAIN_STEP = ("loss_and_grads", "loss_fn", "make_train_step")

__all__ = ["ShardingPlan", "batch_pspec", "constrain", "make_plan", "resolve_specs",
           "set_activation_plan", "use_plan", *_TRAIN_STEP]


def __getattr__(name):
    if name in _TRAIN_STEP:
        from . import train_step

        return getattr(train_step, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
