"""Checkpoints: {global_step, model state_dict, optimizer state_dict} in
torch's format, one file per save, `model_{step}.pt` and `model_best.pt`.

Counterpart of `ddsp_svc_tpu/train/checkpoint.py`, with the same resume
policy (the highest numbered checkpoint, else the best one). The JAX
package's msgpack `.ckpt` files are a different format and are not read
here; the distinct suffix keeps the two apart in one experiment directory.
Writes are atomic (a temporary file, then a rename).
"""
from __future__ import annotations

import os
import re
from typing import Optional

import torch


def save_checkpoint(path: str, step: int, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "global_step": int(step),
        "model": model.state_dict(),
        "optimizer": optimizer.state_dict() if optimizer is not None else {},
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, model: torch.nn.Module,
                       optimizer: Optional[torch.optim.Optimizer] = None
                       ) -> int:
    """Load the model (and the optimizer, when given and saved) in place;
    returns the checkpoint's global step."""
    device = next(model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(payload["model"])
    if optimizer is not None and payload["optimizer"]:
        optimizer.load_state_dict(payload["optimizer"])
    return int(payload["global_step"])


def latest_checkpoint(expdir: str) -> Optional[str]:
    """The newest `model_{step}.pt` in expdir, else `model_best.pt`, else
    None."""
    if not os.path.isdir(expdir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(expdir)
             if (m := re.fullmatch(r"model_(\d+)\.pt", name))]
    if steps:
        return os.path.join(expdir, f"model_{max(steps)}.pt")
    best = os.path.join(expdir, "model_best.pt")
    return best if os.path.isfile(best) else None
