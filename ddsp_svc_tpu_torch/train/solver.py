"""The training loop and validation.

Counterpart of `ddsp_svc_tpu/train/solver.py` for one device, one step per
iteration: interval logging (`interval_log`), validation and checkpoints
(`interval_val`, best-loss tracking), and a validation pass that reports the
all-bucket spectral loss, the real-time factor, and a cross-speaker
conversion with per-speaker mean-log-f0 transposition:
    f0_vc = exp(tgt_lfo * log(f0) / src_lfo),  tgt = (src + 1) % n_spk (1-based).
`train.steps_per_dispatch` > 1, `train.data_on_device`, `train.remat` and
`train.async_save` are not ported yet and raise.
"""
from __future__ import annotations

import os
import random
import time
from typing import Optional

import numpy as np
import torch

from .saver import Saver
from .step import TrainState, batch_to_device, eval_step, train_step

UNPORTED_OPTIONS = ("data_on_device", "remat", "async_save")


def _check_options(args) -> None:
    if int(args.train.steps_per_dispatch or 1) > 1:
        raise NotImplementedError(
            "train.steps_per_dispatch > 1 is not ported yet")
    for name in UNPORTED_OPTIONS:
        if getattr(args.train, name):
            raise NotImplementedError(f"train.{name} is not ported yet")


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
          loader_train, dataset_valid, max_steps: Optional[int] = None):
    """The epoch x batch loop; returns (state, saver) after max_steps steps
    (or all epochs)."""
    _check_options(args)
    saver = Saver(args, initial_global_step=initial_global_step)
    device = next(state.model.parameters()).device
    best_loss = np.inf
    num_batches = len(loader_train)
    saver.log_info("======= start training =======")
    for epoch in range(args.train.epochs):
        for batch_idx, data in enumerate(loader_train.epoch(epoch)):
            saver.global_step_increment()
            loss = train_step(state, batch_to_device(data, device), rss)

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
                return state, saver
    return state, saver
