"""Training and validation steps.

Counterpart of `ddsp_svc_tpu/train/step.py` (single-step form): forward with
infer=False, the random-scale spectral loss, backward, and an AdamW step
matching `optax.adamw` (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay).
PyTorch runs eagerly, so a step is a plain function over a TrainState that
holds the model and its optimizer; the optimizer updates the parameters in
place. Each step's randomness (the noise excitation and the loss's scale
draw) is seeded from (train seed, step count), as the JAX step folds the step
into its key, so a resumed run draws what an uninterrupted one would.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

BATCH_KEYS = ("audio", "f0", "volume", "units", "spk_id")


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    seed: int = 0


def create_optimizer(model: torch.nn.Module, lr: float,
                     weight_decay: float = 0.0) -> torch.optim.AdamW:
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def step_seed(seed: int, step: int, stream: int) -> int:
    """A 63-bit seed for one random stream of one step."""
    return int(np.random.SeedSequence([seed, step, stream]).generate_state(
        1, np.uint64)[0] >> 1)


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The numpy batch of the data loaders as tensors on `device`."""
    out = {k: torch.as_tensor(np.asarray(batch[k]), dtype=torch.float32,
                              device=device)
           for k in BATCH_KEYS if k != "spk_id"}
    out["spk_id"] = torch.as_tensor(np.asarray(batch["spk_id"]),
                                    dtype=torch.int64, device=device)
    return out


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], rss,
               noise: Optional[torch.Tensor] = None,
               loss_idx: Optional[Sequence[int]] = None) -> torch.Tensor:
    """One optimizer step on a device batch; returns the loss (a 0-d tensor
    on the device, not synchronised). `noise` and `loss_idx` pin the step's
    randomness (tests); otherwise both are drawn from the step's seeds."""
    model = state.model
    device = batch["audio"].device
    gen_noise = torch.Generator(device=device).manual_seed(
        step_seed(state.seed, state.step, 0))
    gen_loss = torch.Generator().manual_seed(
        step_seed(state.seed, state.step, 1))
    model.train()
    signal, _, _ = model(batch["units"], batch["f0"], batch["volume"],
                         batch["spk_id"], infer=False, noise=noise,
                         generator=gen_noise)
    loss = rss(signal, batch["audio"], generator=gen_loss, idx=loss_idx)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return loss.detach()


def warm_up_buckets(state: TrainState, batch: Dict[str, torch.Tensor],
                    rss) -> None:
    """Steps whose pinned scales cover every loss bucket once, so that no
    cuFFT plan is made inside a later timed or traced step."""
    idx = list(range(len(rss.buckets)))
    for i in range(0, len(idx), rss.n_scale):
        train_step(state, batch, rss, loss_idx=idx[i:i + rss.n_scale])


@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: Dict[str, torch.Tensor], rss,
              generator: Optional[torch.Generator] = None):
    """Validation forward (infer=True) and the all-bucket loss:
    (signal, loss)."""
    model.eval()
    signal, _, _ = model(batch["units"], batch["f0"], batch["volume"],
                         batch["spk_id"], infer=True, generator=generator)
    return signal, rss.mss(signal, batch["audio"])
