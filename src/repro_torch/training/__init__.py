from .optimizer import OptCfg, OptState, init_opt_state, apply_updates, schedule
from .train_step import Batch, cross_entropy, loss_fn, make_train_step, make_eval_step
from . import checkpoint

__all__ = [
    "OptCfg", "OptState", "init_opt_state", "apply_updates", "schedule",
    "Batch", "cross_entropy", "loss_fn", "make_train_step", "make_eval_step",
    "checkpoint",
]
