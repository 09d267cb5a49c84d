"""Training substrate on PyTorch: AdamW, train step, remat,
microbatching."""
from .optimizer import (AdamWConfig, abstract_opt_state, adamw_update,
                        init_opt_state, opt_state_shardings)
from .train_step import (make_eval_step, make_grad_fn, make_loss_fn,
                         make_train_step)

__all__ = ["AdamWConfig", "init_opt_state", "abstract_opt_state",
           "adamw_update", "opt_state_shardings", "make_train_step",
           "make_loss_fn", "make_grad_fn", "make_eval_step"]
