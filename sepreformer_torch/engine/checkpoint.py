"""Checkpoint save and resume with the reference's latest-epoch rule.

The reference saves ``epoch.NNNN.pth`` dicts {epoch, model_state_dict,
optimizer_state_dict, ...} and resumes from the highest epoch found
(utils/util_engine.py:12-47, 96-106); the JAX package's
``engine/checkpoint.py`` keeps that rule with Orbax.  Here the files are
the reference's: ``torch.save`` of the model's state_dict (the reference
names), the optimizer's state (``mu``, ``nu`` and ``step`` per parameter
for AdamW), the train state's step count and ``extra`` (the LR
controller's state and the losses), read back with ``weights_only``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

_EPOCH_RE = re.compile(r"^epoch\.(\d+)\.pth$")


def checkpoint_path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"epoch.{epoch:04d}.pth")


def save_checkpoint(ckpt_dir: str, epoch: int, state,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``state`` (a ``TrainState``) and ``extra`` as
    ``ckpt_dir/epoch.NNNN.pth``; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, epoch)
    payload = {
        "epoch": epoch,
        "model_state_dict": state.model.state_dict(),
        "optimizer_state_dict": state.optimizer.state_dict(),
        "step": state.step,
        "extra": dict(extra or {}),
    }
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    epochs = [int(m.group(1)) for name in os.listdir(ckpt_dir)
              if (m := _EPOCH_RE.match(name))]
    return max(epochs) if epochs else None


def load_checkpoint(ckpt_dir: str, state, epoch: Optional[int] = None
                    ) -> Optional[Tuple[Any, Dict[str, Any], int]]:
    """Load the latest (or the given) epoch into ``state`` in place.
    Returns (state, extra, epoch), or None when there is no checkpoint."""
    ep = epoch if epoch is not None else latest_epoch(ckpt_dir)
    if ep is None:
        return None
    device = next(state.model.parameters()).device
    payload = torch.load(checkpoint_path(ckpt_dir, ep), map_location=device,
                         weights_only=True)
    state.model.load_state_dict(payload["model_state_dict"])
    state.optimizer.load_state_dict(payload["optimizer_state_dict"])
    state.step = int(payload.get("step", 0))
    return state, dict(payload.get("extra", {})), ep
