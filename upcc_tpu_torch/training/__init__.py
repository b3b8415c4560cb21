"""Training: losses, the training step and the trainer.  ``TrainStep``
holds what the JAX package's ``TrainState`` and ``make_train_step``
return."""

from .loss import Loss
from .train_step import TrainStep, make_optimizer
from .trainer import Training
