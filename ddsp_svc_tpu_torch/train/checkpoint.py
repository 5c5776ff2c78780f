"""Checkpoints: {global_step, model state_dict, optimizer state_dict} in
torch's format, one file per save, `model_{step}.pt` and `model_best.pt`.

Counterpart of `ddsp_svc_tpu/train/checkpoint.py`, with the same resume
policy (the highest numbered checkpoint, else the best one) and the same
asynchronous writer (`AsyncCheckpointer`, train.async_save). The JAX
package's msgpack `.ckpt` files are a different format and are not read
here; the distinct suffix keeps the two apart in one experiment directory.
Writes are atomic (a temporary file, then a rename). A model sharded over
a mesh's 'model' axis is saved whole: `host_payload` gathers the
single-device state dict and optimizer state from the ranks' slices
(collective: every rank calls it), so a run saved under one mesh resumes
on one device and under any other mesh (restore, then
`parallel.shard_train_state`).
"""
from __future__ import annotations

import os
import queue
import re
import threading
from typing import Optional

import torch

from ..parallel.sharding import full_state_dicts


def _host_copy(obj):
    """A copy in host memory of every tensor in a (nested) state dict: the
    optimizer updates the parameters and its state in place on the next
    step, so a checkpoint must not hold references to them. Tensors on the
    card go to pinned buffers without blocking, then one wait."""
    pending = []

    def copy(x):
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(copy(v) for v in x)
        if not torch.is_tensor(x):
            return x
        x = x.detach()
        if x.device.type == "cpu":
            return x.clone()
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        out.copy_(x, non_blocking=True)
        pending.append(x.device)
        return out

    out = copy(obj)
    for dev in set(pending):
        torch.cuda.synchronize(dev)
    return out


def host_payload(step: int, model: torch.nn.Module,
                 optimizer: Optional[torch.optim.Optimizer] = None) -> dict:
    """The checkpoint's payload, copied to the host on the caller's
    thread; a model sharded over 'model' gathered whole first."""
    model_sd, opt_sd = full_state_dicts(model, optimizer)
    return _host_copy({"global_step": int(step), "model": model_sd,
                       "optimizer": opt_sd})


def write_payload(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, step: int, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    write_payload(path, host_payload(step, model, optimizer))


class AsyncCheckpointer:
    """Checkpoint writes overlapped with training. `save` copies the state
    to host memory on the caller's thread (the next step updates it in
    place), then a worker thread serialises and writes the file (atomic
    rename). At most `max_pending` writes queue before `save` blocks. A
    worker's error re-raises on the next `save` or on `wait`; `close`
    drains the queue and ends the worker."""

    def __init__(self, max_pending: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker,
                                        name="ckpt-writer", daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                write_payload(*item)
            except Exception as e:  # surfaced on the next save() / wait()
                self._err = e
            finally:
                self._q.task_done()

    def _check(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async checkpoint write failed") from err

    def save(self, path: str, step: int, model: torch.nn.Module,
             optimizer: Optional[torch.optim.Optimizer] = None) -> None:
        self.put(path, host_payload(step, model, optimizer))

    def put(self, path: str, payload: dict) -> None:
        """Queue a host payload (`host_payload`) for writing."""
        self._check()
        self._q.put((path, payload))

    def wait(self) -> None:
        self._q.join()
        self._check()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._q.put(None)
            self._thread.join()


def restore_checkpoint(path: str, model: torch.nn.Module,
                       optimizer: Optional[torch.optim.Optimizer] = None
                       ) -> int:
    """Load the model (and the optimizer, when given and saved) in place;
    returns the checkpoint's global step. The optimizer keeps its own
    `capturable` flag (train/step.py::create_optimizer sets it on the
    card), so a file restores the same on either device."""
    device = next(model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(payload["model"])
    if optimizer is not None and payload["optimizer"]:
        flags = [g["capturable"] for g in optimizer.param_groups]
        optimizer.load_state_dict(payload["optimizer"])
        for g, flag in zip(optimizer.param_groups, flags):
            g["capturable"] = flag
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
