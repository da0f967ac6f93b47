from sepreformer_torch.engine.lr_control import LRController
from sepreformer_torch.engine.train import (
    TrainState,
    apply_gradients,
    compute_losses,
    create_train_state,
    eval_step,
    make_optimizer,
    train_step,
)

__all__ = [
    "LRController", "TrainState", "apply_gradients", "compute_losses",
    "create_train_state", "eval_step", "make_optimizer", "train_step",
]
