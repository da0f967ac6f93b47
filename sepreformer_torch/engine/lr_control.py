"""Host-driven learning-rate control: warmup x plateau.

Reference semantics:
- ``WarmupConstantSchedule`` (utils/implements/schedulers.py:19-26): linear
  0 -> 1 over ``warmup_steps`` optimizer iterations, stepped per-iteration
  during epoch 1 only (engine.py:61), then frozen.
- ``ReduceLROnPlateau(mode=min, factor, patience, min_lr)`` stepped on the
  validation loss only after ``start_scheduling`` epochs (engine.py:201);
  torch defaults threshold=1e-4 (relative), cooldown=0.

The resulting LR is a plain float handed to each train step, and the
decision is made on one host value.  The port's own copy of the JAX
package's ``engine/lr_control.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass
class LRController:
    base_lr: float
    warmup_steps: int
    plateau_factor: float
    plateau_patience: int
    min_lr: float
    threshold: float = 1e-4

    warmup_count: int = 0
    plateau_scale: float = 1.0
    best: float = float("inf")
    num_bad_epochs: int = 0

    def warmup_step(self) -> None:
        """Called once per iteration during epoch 1."""
        if self.warmup_count < self.warmup_steps:
            self.warmup_count += 1

    @property
    def warmup_factor(self) -> float:
        if self.warmup_steps <= 0:
            return 1.0
        return min(1.0, self.warmup_count / self.warmup_steps)

    def plateau_step(self, valid_loss: float) -> None:
        """torch ReduceLROnPlateau(mode=min, threshold_mode=rel)."""
        if valid_loss < self.best * (1.0 - self.threshold) or (
            self.best == float("inf")
        ):
            self.best = valid_loss
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.plateau_patience:
            # torch clamps the decayed LR at min_lr, not the warmup ramp
            self.plateau_scale = max(
                self.plateau_scale * self.plateau_factor,
                self.min_lr / self.base_lr,
            )
            self.num_bad_epochs = 0

    @property
    def lr(self) -> float:
        return self.base_lr * self.warmup_factor * self.plateau_scale

    def state_dict(self) -> Dict:
        return {
            "warmup_count": self.warmup_count,
            "plateau_scale": self.plateau_scale,
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
        }

    def load_state_dict(self, d: Dict) -> None:
        self.warmup_count = int(d.get("warmup_count", self.warmup_count))
        self.plateau_scale = float(d.get("plateau_scale", self.plateau_scale))
        self.best = float(d.get("best", self.best))
        self.num_bad_epochs = int(d.get("num_bad_epochs", self.num_bad_epochs))
