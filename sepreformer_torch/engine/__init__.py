from sepreformer_torch.engine.checkpoint import (
    latest_epoch,
    load_checkpoint,
    save_checkpoint,
)
from sepreformer_torch.engine.engine import Engine, apply_cmvn
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
    "Engine", "LRController", "TrainState", "apply_cmvn", "apply_gradients",
    "compute_losses", "create_train_state", "eval_step", "latest_epoch",
    "load_checkpoint", "make_optimizer", "save_checkpoint", "train_step",
]
