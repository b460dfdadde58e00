"""Trainer registry (reference `src/trainer/__init__.py:21-22`)."""

from .state import (Optimizer, TrainState, create_train_state,
                    make_optimizer)
from .amodalsynthdrive_trainer import AmodalSynthDriveTrainer
from .depthfm_trainer import DepthFMAmodalTrainer, DepthFMTrainer
from .invisible_stitch_trainer import InvisibleStitchTrainer
from .trainer import DiscriminativeTrainer, TrainerConfig

TRAINER_REGISTRY = {
    "DiscriminativeTrainer": DiscriminativeTrainer,
    "InvisibleStitchTrainer": InvisibleStitchTrainer,
    "AmodalSynthDriveTrainer": AmodalSynthDriveTrainer,
    "DepthFMAmodalTrainer": DepthFMAmodalTrainer,
    "DepthFMTrainer": DepthFMTrainer,
}


def get_trainer_cls(name: str):
    if name not in TRAINER_REGISTRY:
        raise ValueError(
            f"unknown trainer {name!r}; available: {sorted(TRAINER_REGISTRY)}")
    return TRAINER_REGISTRY[name]


__all__ = ["TrainState", "Optimizer", "create_train_state", "make_optimizer",
           "DiscriminativeTrainer", "AmodalSynthDriveTrainer",
           "InvisibleStitchTrainer", "DepthFMAmodalTrainer", "DepthFMTrainer",
           "TrainerConfig", "get_trainer_cls",
           "TRAINER_REGISTRY"]
