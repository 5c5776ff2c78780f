"""Experiment logging: the text log, scalar values, audio, interval timers,
the global step and checkpoints.

Counterpart of `ddsp_svc_tpu/train/saver.py`. `log_info` prints and appends
to `log_info.txt`; `log_value` appends one JSON line per call to
`log_values.jsonl` (no TensorBoard); `log_audio` writes wav files under
`audio/`; `save_model` writes `model_{postfix}.pt`, through a writer thread
under `train.async_save` (`finish` drains it). The config is dumped as
`config.yaml` beside the checkpoints. On a mesh (`mesh=`) rank 0 alone
writes the logs, the audio and the checkpoints; every rank calls
save_model, since gathering a tensor-parallel model is collective.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.wavio import write_wav
from ..utils.config import save_config
from .checkpoint import AsyncCheckpointer, host_payload, write_payload


class Saver:
    def __init__(self, args, initial_global_step: int = 0, mesh=None):
        self.expdir = args.env.expdir
        self.sample_rate = args.data.sampling_rate
        self.global_step = initial_global_step
        self.init_time = time.time()
        self.last_time = time.time()
        self.writer = mesh is None or dist.get_rank() == 0
        self._async_ckpt = (AsyncCheckpointer() if args.train.async_save
                            and self.writer else None)
        self.path_log_info = os.path.join(self.expdir, "log_info.txt")
        self.path_log_values = os.path.join(self.expdir, "log_values.jsonl")
        if self.writer:
            os.makedirs(self.expdir, exist_ok=True)
            save_config(os.path.join(self.expdir, "config.yaml"), args)

    def log_info(self, msg: str) -> None:
        if not self.writer:
            return
        print(msg, flush=True)
        with open(self.path_log_info, "a") as f:
            f.write(msg + "\n")

    def log_value(self, values: Dict[str, float]) -> None:
        if not self.writer:
            return
        with open(self.path_log_values, "a") as f:
            f.write(json.dumps({"step": self.global_step,
                                **{k: float(v) for k, v in values.items()}})
                    + "\n")

    def log_audio(self, audios: Dict[str, np.ndarray]) -> None:
        if not self.writer:
            return
        audio_dir = os.path.join(self.expdir, "audio")
        os.makedirs(audio_dir, exist_ok=True)
        for name, audio in audios.items():
            path = os.path.join(audio_dir,
                                f"{self.global_step}_{name.replace('/', '_')}")
            if not path.endswith(".wav"):
                path += ".wav"
            write_wav(path, np.asarray(audio).reshape(-1), self.sample_rate)

    def get_interval_time(self) -> float:
        """Seconds since the last call (or since the start)."""
        now = time.time()
        dt = now - self.last_time
        self.last_time = now
        return dt

    def get_total_time(self) -> str:
        """Time since the start as HH:MM:SS."""
        total = time.time() - self.init_time
        return str(int(total // 3600)).zfill(2) + time.strftime(
            ":%M:%S", time.gmtime(total))

    def global_step_increment(self) -> None:
        self.global_step += 1

    def save_model(self, model: torch.nn.Module,
                   optimizer: Optional[torch.optim.Optimizer],
                   postfix: str) -> str:
        path = os.path.join(self.expdir, f"model_{postfix}.pt")
        self.log_info(f" [*] model checkpoint saved: {path}")
        sharded = any(getattr(m, "tp", None) is not None
                      for m in model.modules())
        if not (self.writer or sharded):
            return path
        payload = host_payload(self.global_step, model, optimizer)
        if not self.writer:
            return path
        if self._async_ckpt is not None:
            self._async_ckpt.put(path, payload)
        else:
            write_payload(path, payload)
        return path

    def finish(self) -> None:
        """Drain the pending asynchronous checkpoint writes (the end of
        training); a failed write raises here."""
        if self._async_ckpt is not None:
            ckpt, self._async_ckpt = self._async_ckpt, None
            ckpt.close()
