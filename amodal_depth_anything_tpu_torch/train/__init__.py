"""Trainer registry (reference `src/trainer/__init__.py:21-22`)."""

from .state import (Optimizer, TrainState, create_train_state,
                    make_optimizer)
from .depthfm_trainer import DepthFMAmodalTrainer, DepthFMTrainer
from .trainer import DiscriminativeTrainer, TrainerConfig

TRAINER_REGISTRY = {
    "DiscriminativeTrainer": DiscriminativeTrainer,
    "DepthFMAmodalTrainer": DepthFMAmodalTrainer,
    "DepthFMTrainer": DepthFMTrainer,
}
# trainers of the JAX package that this port does not have yet
UNPORTED_TRAINERS = ("InvisibleStitchTrainer", "AmodalSynthDriveTrainer")


def get_trainer_cls(name: str):
    if name in UNPORTED_TRAINERS:
        raise NotImplementedError(f"trainer {name!r} is not ported yet")
    if name not in TRAINER_REGISTRY:
        raise ValueError(
            f"unknown trainer {name!r}; available: {sorted(TRAINER_REGISTRY)}")
    return TRAINER_REGISTRY[name]


__all__ = ["TrainState", "Optimizer", "create_train_state", "make_optimizer",
           "DiscriminativeTrainer", "DepthFMAmodalTrainer", "DepthFMTrainer",
           "TrainerConfig", "get_trainer_cls",
           "TRAINER_REGISTRY"]
