"""Training and validation steps.

Counterpart of `ddsp_svc_tpu/train/step.py`: forward with infer=False, the
random-scale spectral loss, backward, and an AdamW step matching
`optax.adamw` (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay).
PyTorch runs eagerly, so a step is a plain function over a TrainState that
holds the model and its optimizer; the optimizer updates the parameters in
place. Each step's randomness (the noise excitation and the loss's scale
draw) is seeded from (train seed, step count), as the JAX step folds the step
into its key, so a resumed run, a K-step dispatch and K single steps all
draw the same numbers.

The noise is drawn before the forward and passed in (`noise=`), never
inside it: under `remat` (`torch.utils.checkpoint`, the counterpart of
`jax.checkpoint`) the forward runs again in the backward, and a draw from
the step's explicit generator there would give other noise (checkpoint
restores only the default generators), so the gradient would belong to
another forward. `train_steps` runs K steps over K staged microbatches
(`make_train_step_multi`); with a DevicePool each step gathers its crops on
the device first (`make_train_step_pool*`). On the card those K steps are
replays of a captured CUDA graph (`train/graphed.py`); `train_steps` is the
CPU's form.

With a mesh (`parallel/`; `mesh=`), a step is data- and tensor-parallel:
the batch is this rank's rows of the global batch (`parallel.shard_batch`),
the noise is drawn for the whole batch from the step's seed and sliced to
those rows (every rank makes the same draw), the loss buckets are drawn on
the host from the same seed, and the gradients and the loss, views of one
flat buffer (`parallel.sharding.GradBuffer`), are averaged over 'data' in
one all-reduce before AdamW. The tensor-parallel collectives run inside
the sharded layers; under remat their recompute calls them again, in the
same order on every rank.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.sharding import GradBuffer, batch_rows

BATCH_KEYS = ("audio", "f0", "volume", "units", "spk_id")


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    seed: int = 0
    grads: Optional[GradBuffer] = None  # made by the first mesh step


def create_optimizer(model: torch.nn.Module, lr: float,
                     weight_decay: float = 0.0) -> torch.optim.AdamW:
    """AdamW over the model's parameters. On the card it is `capturable`
    (its step counts on the device), so that the eager step and the CUDA
    graph of the step (train/graphed.py) run the same update."""
    capturable = next(model.parameters()).is_cuda
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay,
                             capturable=capturable)


def step_seed(seed: int, step: int, stream: int) -> int:
    """A 63-bit seed for one random stream of one step."""
    return int(np.random.SeedSequence([seed, step, stream]).generate_state(
        1, np.uint64)[0] >> 1)


def noise_generator(state: TrainState, device) -> torch.Generator:
    """The generator of the step's noise excitation (stream 0)."""
    return torch.Generator(device=device).manual_seed(
        step_seed(state.seed, state.step, 0))


def draw_loss_idx(state: TrainState, rss) -> list:
    """The step's loss buckets (stream 1), drawn on the host."""
    return rss.draw(torch.Generator().manual_seed(
        step_seed(state.seed, state.step, 1)))


def draw_noise(model: torch.nn.Module, f0: torch.Tensor,
               generator: torch.Generator,
               out: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """The forward's uniform(-1, 1) noise excitation, (B, F * block) fp32:
    the one draw the synthesizers make from their generator
    (`models/synths.py::_uniform_noise`), made before the forward. out: a
    buffer to draw into (the graphed step's static input). mesh: f0 holds
    this rank's rows; the whole batch's noise is drawn and its rows
    returned (out, if given, is the whole batch's buffer)."""
    b, f = f0.shape[:2]
    if mesh is not None:
        b *= mesh.size("data")
    shape = (b, f * model.block_size)
    if out is None:
        noise = torch.rand(shape, generator=generator, dtype=torch.float32,
                           device=f0.device) * 2 - 1
        return noise if mesh is None else noise[batch_rows(mesh, b)]
    torch.rand(shape, generator=generator, out=out)
    return out.mul_(2).sub_(1)


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The numpy batch of the data loaders as tensors on `device`."""
    out = {k: torch.as_tensor(np.asarray(batch[k]), dtype=torch.float32,
                              device=device)
           for k in BATCH_KEYS if k != "spk_id"}
    out["spk_id"] = torch.as_tensor(np.asarray(batch["spk_id"]),
                                    dtype=torch.int64, device=device)
    return out


def stage(items: Sequence[Dict], device) -> Dict[str, torch.Tensor]:
    """K host items (loader batches restricted to BATCH_KEYS, or
    DevicePool.sample index dicts) as (K, ...) tensors on `device`: one
    host-to-device copy per key. Floating arrays become float32; integer
    arrays keep their dtype."""
    out = {}
    for k in items[0]:
        a = np.stack([np.asarray(it[k]) for it in items])
        out[k] = torch.as_tensor(
            a, dtype=torch.float32 if a.dtype.kind == "f" else None,
            device=device)
    return out


def _signal(model, units, f0, volume, spk_id, noise):
    return model(units, f0, volume, spk_id, infer=False, noise=noise)[0]


def forward_signal(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
                   noise: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """The training forward to the signal. remat: its activations are
    recomputed in the backward (non-reentrant checkpoint). The forward
    draws nothing (the noise comes in), so no generator state needs
    keeping for the recompute."""
    args = (batch["units"], batch["f0"], batch["volume"], batch["spk_id"],
            noise)
    if remat:
        return checkpoint(functools.partial(_signal, model), *args,
                          use_reentrant=False, preserve_rng_state=False)
    return _signal(model, *args)


def grad_buffer(state: TrainState) -> GradBuffer:
    """The state's flat gradient buffer (made at the first call)."""
    if state.grads is None:
        state.grads = GradBuffer(state.model.parameters())
    return state.grads


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], rss,
               noise: Optional[torch.Tensor] = None,
               loss_idx: Optional[Sequence[int]] = None,
               remat: bool = False, mesh=None) -> torch.Tensor:
    """One optimizer step on a device batch; returns the loss (a 0-d tensor
    on the device, not synchronised). `noise` and `loss_idx` pin the step's
    randomness (tests); otherwise both are drawn from the step's seeds.
    mesh: batch is this rank's rows, `noise` (if given) the whole batch's;
    the returned loss is the whole batch's."""
    model = state.model
    if noise is None:
        noise = draw_noise(model, batch["f0"],
                           noise_generator(state, batch["f0"].device),
                           mesh=mesh)
    elif mesh is not None:
        noise = noise[batch_rows(mesh, noise.shape[0])]
    if loss_idx is None:
        loss_idx = draw_loss_idx(state, rss)
    model.train()
    signal = forward_signal(model, batch, noise, remat)
    loss = rss(signal, batch["audio"], idx=loss_idx)
    if mesh is None:
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    else:
        grads = grad_buffer(state)
        grads.attach()
        loss.backward()
        loss = grads.reduce(mesh, loss)[0].clone()
    state.optimizer.step()
    state.step += 1
    return loss.detach()


def train_steps(state: TrainState, staged: Dict[str, torch.Tensor], rss,
                pool=None, remat: bool = False, mesh=None) -> torch.Tensor:
    """K steps over K staged microbatches ((K, ...) tensors, `stage`), or
    with a DevicePool over K staged index dicts, each step gathering its
    crops on the device: the losses, (K,). Step k draws what the k-th of K
    single steps would."""
    losses = []
    for k in range(next(iter(staged.values())).shape[0]):
        item = {name: v[k] for name, v in staged.items()}
        batch = pool.gather(item) if pool is not None else item
        losses.append(train_step(state, batch, rss, remat=remat,
                                 mesh=mesh))
    return torch.stack(losses)


def warm_up_buckets(state: TrainState, batch: Dict[str, torch.Tensor],
                    rss, mesh=None) -> None:
    """Steps whose pinned scales cover every loss bucket once, so that no
    cuFFT plan is made inside a later timed or traced step."""
    idx = list(range(len(rss.buckets)))
    for i in range(0, len(idx), rss.n_scale):
        train_step(state, batch, rss, loss_idx=idx[i:i + rss.n_scale],
                   mesh=mesh)


@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: Dict[str, torch.Tensor], rss,
              generator: Optional[torch.Generator] = None):
    """Validation forward (infer=True) and the all-bucket loss:
    (signal, loss)."""
    model.eval()
    signal, _, _ = model(batch["units"], batch["f0"], batch["volume"],
                         batch["spk_id"], infer=True, generator=generator)
    return signal, rss.mss(signal, batch["audio"])
