"""SCM training (dualmessagepassing_tpu/train/): losses, samplers,
schedules and the driver. The names below are exported as the JAX
package's train/__init__.py exports them, except TrainState: the model
and the optimizer hold the training state here, and
scm_driver.SCMOptimizer (exported) is the optimizer's half of it."""

from .losses import bp_criterion, eval_criterion, scm_loss
from .samplers import BucketSampler, CurriculumSampler
from .schedules import anneal_fn, cyclical_fn, lr_schedule, scalar_schedule
from .scm_driver import (SCMOptimizer, dp_replicate_state, evaluate_epoch,
                         make_eval_step, make_optimizer, make_train_step,
                         train_epoch)

__all__ = ["BucketSampler", "CurriculumSampler", "SCMOptimizer",
           "anneal_fn", "bp_criterion", "cyclical_fn", "dp_replicate_state",
           "eval_criterion", "evaluate_epoch", "lr_schedule",
           "make_eval_step", "make_optimizer", "make_train_step",
           "scalar_schedule", "scm_loss", "train_epoch"]
