"""The training loop and validation.

Counterpart of `ddsp_svc_tpu/train/solver.py` for one device: interval
logging (`interval_log`), validation and checkpoints (`interval_val`,
best-loss tracking), and a validation pass that reports the all-bucket
spectral loss, the real-time factor, and a cross-speaker conversion with
per-speaker mean-log-f0 transposition:
    f0_vc = exp(tgt_lfo * log(f0) / src_lfo),  tgt = (src + 1) % n_spk (1-based).
The train options, as JAX runs them:
  steps_per_dispatch K  K microbatches staged to the device in one copy per
                        key and run as K steps (on the card, replays of the
                        captured step, train/graphed.py); log, validation
                        and max_steps are checked at dispatch boundaries;
                        a partial last dispatch is drained at the end;
  data_on_device        the training set in device memory
                        (data/device_pool.py): only each step's crop
                        indices cross, drawn by a per-epoch
                        random.Random(f"{seed}:{epoch}:pool"); on the card
                        also graphed, at any K;
  remat                 the forward recomputed in the backward;
  async_save            checkpoints written by a worker thread
                        (train/checkpoint.py::AsyncCheckpointer).
Validation stays eager.

On a mesh (`train(..., mesh=)`, `parallel/`), as the JAX loop runs under
its batch_transform: every rank iterates the same seeded loader (or makes
the same pool draws) and takes its rows of each global batch
(`parallel.shard_batch`; the pool's index arrays likewise, the pool itself
replicated on every rank); each step averages the gradients over 'data'
(train/step.py); every rank runs validation (a tensor-parallel forward's
collectives pair up across ranks) and takes the ranks' mean loss; rank 0
alone writes logs and checkpoints, which hold the gathered single-device
state (train/checkpoint.py).
"""
from __future__ import annotations

import os
import random
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.device_pool import DevicePool
from ..parallel.sharding import shard_batch
from .graphed import GraphedTrainSteps
from .saver import Saver
from .step import (BATCH_KEYS, TrainState, batch_to_device, eval_step, stage,
                   train_steps)


def test(args, model: torch.nn.Module, rss, dataset_valid,
         saver: Saver) -> float:
    """Validation over every file of dataset_valid at its own length;
    returns the mean loss."""
    device = next(model.parameters()).device
    lfo_path = os.path.join(args.data.train_path, "f0_stats.npy")
    lfo_stats = (np.load(lfo_path, allow_pickle=True).item()
                 if os.path.isfile(lfo_path) else None)
    test_loss = 0.0
    rtf_all = []
    num = len(dataset_valid)
    rng_item = random.Random(0)
    for bidx in range(num):
        data = dataset_valid.get_item(bidx, rng_item)
        name = data["name"]
        batch = batch_to_device({k: data[k][None] for k in
                                 ("audio", "f0", "volume", "units", "spk_id")},
                                device)
        true_len = batch["audio"].shape[1]
        gen = torch.Generator(device=device).manual_seed(42)
        st = time.time()
        signal, loss = eval_step(model, batch, rss, gen)
        signal = signal[:, :true_len].cpu().numpy()  # waits for the device
        run_time = time.time() - st
        song_time = true_len / args.data.sampling_rate
        rtf = run_time / song_time
        saver.log_info(f"{bidx}/{num} - {name} RTF: {rtf:.4f} | "
                       f"{run_time:.3f} / {song_time:.3f}")
        rtf_all.append(rtf)
        test_loss += float(loss)
        audio_logs = {f"{name}/gt.wav": data["audio"],
                      f"{name}/pred.wav": signal[0]}

        if lfo_stats is not None and args.model.n_spk and args.model.n_spk > 1:
            src_spk = int(data["spk_id"][0])
            tgt_spk = (src_spk + 1) % args.model.n_spk
            tgt_spk = 1 if tgt_spk == 0 else tgt_spk
            if str(src_spk) in lfo_stats and str(tgt_spk) in lfo_stats:
                src_lfo = float(lfo_stats[str(src_spk)])
                tgt_lfo = float(lfo_stats[str(tgt_spk)])
                vc = dict(batch)
                vc["f0"] = torch.exp(tgt_lfo * torch.log(
                    batch["f0"].clamp_min(1e-8)) / src_lfo)
                vc["spk_id"] = torch.full_like(batch["spk_id"], tgt_spk)
                gen = torch.Generator(device=device).manual_seed(43)
                vc_sig, _ = eval_step(model, vc, rss, gen)
                audio_logs[f"{name}/vc_{src_spk}_to_{tgt_spk}.wav"] = (
                    vc_sig[0, :true_len].cpu().numpy())
        saver.log_audio(audio_logs)

    test_loss /= max(num, 1)
    saver.log_info(f" [test_loss] test_loss: {test_loss}")
    saver.log_info(f" Real Time Factor: "
                   f"{np.mean(rtf_all) if rtf_all else float('nan')}")
    return test_loss


def train(args, initial_global_step: int, state: TrainState, rss,
          loader_train, dataset_valid, max_steps: Optional[int] = None,
          mesh=None):
    """The epoch x batch loop; returns (state, saver) after max_steps steps
    (or all epochs). mesh: a `parallel.Mesh` whose 'data' axis divides
    train.batch_size; the state already cut to this rank
    (`parallel.shard_train_state`)."""
    if mesh is not None and int(args.train.batch_size) % mesh.size("data"):
        raise ValueError(
            f"batch_size {args.train.batch_size} must divide by the "
            f"data-parallel axis ({mesh.size('data')})")
    saver = Saver(args, initial_global_step=initial_global_step, mesh=mesh)
    device = next(state.model.parameters()).device
    k_dispatch = int(args.train.steps_per_dispatch or 1)
    remat = bool(args.train.remat)
    pool = None
    if args.train.data_on_device:
        ds = getattr(loader_train, "dataset", None)
        if ds is None:  # a PrefetchIterator wraps the BatchIterator
            ds = loader_train.inner.dataset
        pool = DevicePool(ds, int(args.data.block_size), device)
        saver.log_info(f" [pool] {len(pool)} files, {pool.nbytes() / 1e6:.0f}"
                       " MB staged in device memory")
    graphed = device.type == "cuda" and (k_dispatch > 1 or pool is not None)
    steps = None  # GraphedTrainSteps, captured at the first dispatch

    def dispatch(items) -> torch.Tensor:
        nonlocal steps
        staged = stage(items, device)
        if not graphed:
            return train_steps(state, staged, rss, pool=pool, remat=remat,
                               mesh=mesh)
        if steps is None:
            t0 = time.time()
            steps = GraphedTrainSteps(state, rss, staged, pool=pool,
                                      remat=remat, mesh=mesh)
            saver.log_info(f" [graph] the step captured in "
                           f"{time.time() - t0:.2f} s")
        return steps(staged)

    def pool_epoch(epoch_idx):
        """The epoch's file shuffle and crop indices, drawn on the host
        (the JAX pool's seeded draws)."""
        rng_l = random.Random(f"{args.train.seed}:{epoch_idx}:pool")
        order = list(range(len(pool)))
        rng_l.shuffle(order)
        bsz = int(args.train.batch_size)
        for b in range(max(1, len(pool) // bsz)):
            yield pool.sample([order[(b * bsz + i) % len(order)]
                               for i in range(bsz)], rng_l)

    best_loss = np.inf
    num_batches = (max(1, len(pool) // int(args.train.batch_size))
                   if pool is not None else len(loader_train))
    micro: list = []  # the pending microbatches of a K-step dispatch
    saver.log_info("======= start training =======")
    for epoch in range(args.train.epochs):
        epoch_iter = (pool_epoch(epoch) if pool is not None
                      else loader_train.epoch(epoch))
        for batch_idx, data in enumerate(epoch_iter):
            data = data if pool is not None else {k: data[k]
                                                  for k in BATCH_KEYS}
            micro.append(data if mesh is None else shard_batch(data, mesh))
            if len(micro) < k_dispatch:
                continue
            loss = dispatch(micro)[-1]
            for _ in micro:
                saver.global_step_increment()
            micro = []

            if saver.global_step % args.train.interval_log == 0:
                loss_val = float(loss)
                saver.log_info(
                    "epoch: {} | {:3d}/{:3d} | {} | batch/s: {:.2f} | loss: "
                    "{:.3f} | time: {} | step: {}".format(
                        epoch, batch_idx, num_batches, args.env.expdir,
                        args.train.interval_log
                        / max(saver.get_interval_time(), 1e-9),
                        loss_val, saver.get_total_time(), saver.global_step))
                saver.log_value({"train/loss": loss_val})

            if saver.global_step % args.train.interval_val == 0:
                test_loss = test(args, state.model, rss, dataset_valid, saver)
                if mesh is not None:  # one decision on every rank
                    agreed = torch.tensor([test_loss], dtype=torch.float64,
                                          device=device)
                    dist.all_reduce(agreed)
                    test_loss = agreed.item() / dist.get_world_size()
                saver.log_info(f" --- <validation> --- \nloss: {test_loss:.3f}. ")
                saver.log_value({"validation/loss": test_loss})
                saver.save_model(state.model, state.optimizer,
                                 postfix=f"{saver.global_step}")
                if test_loss < best_loss:
                    saver.log_info(" [V] best model updated.")
                    saver.save_model(state.model, state.optimizer,
                                     postfix="best")
                    best_loss = test_loss

            if (max_steps is not None
                    and saver.global_step >= initial_global_step + max_steps):
                saver.finish()
                return state, saver
    if micro:
        # the epochs ended inside a K-step dispatch: its microbatches still
        # train, as single steps (the same seeds as in a full dispatch)
        dispatch(micro)
        for _ in micro:
            saver.global_step_increment()
        saver.log_info(
            f"drained {len(micro)} pending microbatches at end of training")
    saver.finish()
    return state, saver
