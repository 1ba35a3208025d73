"""Training of the port (`repro.train`): loss and train step."""
from .train_step import loss_and_grads, loss_fn, make_train_step

__all__ = ["loss_and_grads", "loss_fn", "make_train_step"]
