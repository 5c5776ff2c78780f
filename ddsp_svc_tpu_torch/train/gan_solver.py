"""The config-driven enhancer GAN fine-tuning loop.

Counterpart of `ddsp_svc_tpu/train/gan_solver.py`: `train_gan(args)`
fine-tunes the NSF-HiFiGAN enhancer on the preprocessed dataset's
ground-truth audio and f0 with alternating D/G steps (train/gan.py),
validates by mel L1, checkpoints G + D + both optimizers with resume from
the newest checkpoint, and exports an enhancer checkpoint that
`infer/enhancer.py::NsfHifiGAN` (and the JAX package's) loads. The config
block is the JAX package's (`train.gan`: expdir, lr, mel_weight, fm_weight,
batch_size, crop_frames, interval_log, interval_val, max_steps, h,
data_on_device, data_parallel).

`train.gan.data_parallel: true` (or `train_gan(..., mesh=)`) runs the D and
G steps data-parallel over the ranks of the joined process group, one
process a rank (the port's form of JAX's "all local devices";
`parallel.init_distributed` first, e.g. the entry's --num-processes): each
rank draws the same global batch (or clip-pool starts) from the seeded
generator and takes its rows, the gradients are averaged over the ranks
(train/gan.py), and rank 0 alone validates, writes checkpoints and exports.

Files under the GAN expdir:
    gan_{step}.pt                  {global_step, generator, discriminators
                                    {mpd, msd}, g_opt, d_opt}
    enhancer/model_{step}.pt       {"generator": state_dict}, plain weights
    enhancer/model_best.pt         the same, at the best validation
    enhancer/config.json           h
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data.wavio import load_audio
from ..nn.layers import lecun_init_
from ..nn.nsf_hifigan import generator_from_h
from ..parallel.mesh import make_mesh
from ..parallel.sharding import batch_rows
from ..utils.device import resolve_device
from .gan import GanState, GanTrainer, mel_of


def _resolve_h(args) -> dict:
    """train.gan.h, else the config.json beside enhancer.ckpt."""
    gan_cfg = args.train.gan
    if gan_cfg and gan_cfg.h:
        return dict(gan_cfg.h)
    ckpt = args.enhancer.ckpt
    if not ckpt:
        raise ValueError(
            " [x] train.gan.h or enhancer.ckpt (with sibling config.json) "
            "required for GAN fine-tuning")
    with open(os.path.join(os.path.dirname(ckpt), "config.json")) as f:
        return json.load(f)


class GanDataset:
    """Ground-truth (audio, f0) clips on the enhancer's frame grid: the
    preprocessed layout (`audio/{spk}/*.wav`, `f0/{spk}/*.npy` at the data
    hop), f0 re-gridded to the enhancer's hop by np.interp, as the JAX
    package does, so that a numpy generator gives its crops bit for bit."""

    def __init__(self, path: str, h: dict, data_sr: int, data_hop: int):
        self.h = h
        self.clips: List[Tuple[np.ndarray, np.ndarray]] = []
        hop, sr = int(h["hop_size"]), int(h["sampling_rate"])
        audio_dir = os.path.join(path, "audio")
        for root, _, files in os.walk(audio_dir):
            for name in sorted(files):
                if not name.endswith(".wav"):
                    continue
                wav_path = os.path.join(root, name)
                rel = os.path.relpath(wav_path, audio_dir)
                f0_path = os.path.join(path, "f0",
                                       os.path.splitext(rel)[0] + ".npy")
                if not os.path.isfile(f0_path):
                    continue
                audio, _ = load_audio(wav_path, sr=sr, mono=True)
                f0 = np.load(f0_path).astype(np.float32)
                n_frames = len(audio) // hop + 1
                src_t = np.arange(len(f0)) * (data_hop / data_sr)
                dst_t = np.arange(n_frames) * (hop / sr)
                f0_grid = np.interp(dst_t, src_t, f0).astype(np.float32)
                self.clips.append((audio.astype(np.float32), f0_grid))
        if not self.clips:
            raise ValueError(f" [x] no (audio, f0) pairs under {path}")

    def sample_batch(self, rng: np.random.Generator, batch_size: int,
                     crop_frames: int) -> Dict[str, np.ndarray]:
        """{"audio": (B, crop_frames * hop), "f0": (B, crop_frames)}: per
        item a clip and a start frame drawn from rng; short clips padded
        (audio with zeros, f0 with its last value)."""
        hop = int(self.h["hop_size"])
        t = crop_frames * hop
        audio_b, f0_b = [], []
        for _ in range(batch_size):
            audio, f0 = self.clips[rng.integers(len(self.clips))]
            max_start = max(0, len(audio) // hop - crop_frames - 1)
            k = int(rng.integers(max_start + 1))
            a = audio[k * hop: k * hop + t]
            audio_b.append(np.pad(a, (0, t - len(a))))
            f0_b.append(f0[k: k + crop_frames] if len(f0) >= k + crop_frames
                        else np.pad(f0[k:], (0, crop_frames - len(f0[k:])),
                                    mode="edge"))
        return {"audio": np.stack(audio_b), "f0": np.stack(f0_b)}


class ClipPool:
    """Every training clip in device memory (train.gan.data_on_device):
    audio as float16 (as the JAX pool stores it) and f0, concatenated
    frame-aligned (each clip's audio cut or zero-padded to its f0 frames x
    hop). A batch crosses from the host as its (B,) start frames; the crops
    are gathered and their mel computed on the device."""

    def __init__(self, dataset: GanDataset, crop_frames: int, device):
        self.h = dataset.h
        self.hop = int(self.h["hop_size"])
        audio_parts, f0_parts, base, kmax = [], [], [], []
        fb = 0
        for audio, f0 in dataset.clips:
            nf = len(f0)
            a = np.zeros(nf * self.hop, np.float32)
            a[: min(len(audio), nf * self.hop)] = audio[: nf * self.hop]
            audio_parts.append(a.astype(np.float16))
            f0_parts.append(f0)
            base.append(fb)
            kmax.append(max(0, len(audio) // self.hop - crop_frames - 1))
            fb += nf
        self.audio = torch.as_tensor(np.concatenate(audio_parts),
                                     device=device)
        self.f0 = torch.as_tensor(np.concatenate(f0_parts), device=device)
        self.clip_base = np.asarray(base, np.int64)
        self.clip_max_start = np.asarray(kmax, np.int64)
        self.audio_bytes = sum(a.nbytes for a in audio_parts)
        self._frames = torch.arange(crop_frames, device=device)
        self._samples = torch.arange(crop_frames * self.hop, device=device)

    def starts(self, rng: np.random.Generator, batch_size: int) -> np.ndarray:
        """The batch's start frames in the pool, drawn as the JAX pool draws
        them."""
        clips = rng.integers(len(self.clip_base), size=batch_size)
        ks = np.asarray([rng.integers(self.clip_max_start[c] + 1)
                         for c in clips])
        return self.clip_base[clips] + ks

    def gather(self, starts: np.ndarray) -> Dict[str, torch.Tensor]:
        """The crops at `starts` with their mel, (B, F, M)."""
        s = torch.as_tensor(starts, device=self.f0.device)[:, None]
        audio = self.audio[s * self.hop + self._samples].float()
        return {"audio": audio, "f0": self.f0[s + self._frames],
                "mel": mel_of(self.h, audio).transpose(1, 2)}


def save_gan_checkpoint(path: str, state: GanState) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "global_step": int(state.step),
        "generator": state.generator.state_dict(),
        "discriminators": {"mpd": state.mpd.state_dict(),
                           "msd": state.msd.state_dict()},
        "g_opt": state.g_opt.state_dict(),
        "d_opt": state.d_opt.state_dict(),
    }
    _save_atomic(payload, path)


def restore_gan_checkpoint(path: str, state: GanState) -> None:
    """Load a gan_{step}.pt into the state in place."""
    device = next(state.generator.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    state.generator.load_state_dict(payload["generator"])
    state.mpd.load_state_dict(payload["discriminators"]["mpd"])
    state.msd.load_state_dict(payload["discriminators"]["msd"])
    state.g_opt.load_state_dict(payload["g_opt"])
    state.d_opt.load_state_dict(payload["d_opt"])
    state.step = int(payload["global_step"])


def latest_gan_checkpoint(expdir: str) -> Optional[str]:
    """The newest gan_{step}.pt in expdir, else None."""
    if not os.path.isdir(expdir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(expdir)
             if (m := re.fullmatch(r"gan_(\d+)\.pt", name))]
    if not steps:
        return None
    return os.path.join(expdir, f"gan_{max(steps)}.pt")


def _save_atomic(obj, path: str) -> None:
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def _export(expdir: str, h: dict, generator: torch.nn.Module, step: int,
            best: bool) -> None:
    """enhancer/model_{step}.pt (and model_best.pt) with config.json."""
    enh_dir = os.path.join(expdir, "enhancer")
    os.makedirs(enh_dir, exist_ok=True)
    with open(os.path.join(enh_dir, "config.json"), "w") as f:
        json.dump(h, f, indent=2)
    blob = {"generator": {k: v.detach().cpu() for k, v in
                          generator.state_dict().items()}}
    _save_atomic(blob, os.path.join(enh_dir, f"model_{step}.pt"))
    if best:
        _save_atomic(blob, os.path.join(enh_dir, "model_best.pt"))


def train_gan(args, max_steps: Optional[int] = None, device=None,
              rand_hook: Optional[Callable[[int, str], np.ndarray]] = None,
              mesh=None) -> Tuple[GanState, str]:
    """Run the fine-tuning loop; returns (state, expdir). device: CUDA
    unless given. rand_hook(step, "d" or "g") -> (B, 9) optionally injects
    each step's rand_ini (step: the D steps taken before it; the whole
    batch's on a mesh). mesh: a `parallel.Mesh` to run data-parallel over
    its 'data' axis; made from the joined process group when the config
    sets train.gan.data_parallel (which raises if none is joined)."""
    gan_cfg = args.train.gan
    device = resolve_device(device)
    if mesh is None and gan_cfg and gan_cfg.data_parallel:
        if not dist.is_initialized():
            raise RuntimeError(
                "train.gan.data_parallel runs one process a rank: join the "
                "process group first (parallel.init_distributed; the "
                "entry's --num-processes, --coordinator, --process-id)")
        mesh = make_mesh(device=device)
    if mesh is not None:
        device = mesh.device
    writer = mesh is None or dist.get_rank() == 0
    h = _resolve_h(args)
    expdir = (gan_cfg and gan_cfg.expdir) or os.path.join(
        args.env.expdir or "exp", "gan")
    lr = float((gan_cfg and gan_cfg.lr) or 2e-4)
    mel_weight = float((gan_cfg and gan_cfg.mel_weight) or 45.0)
    fm_weight = float((gan_cfg and gan_cfg.fm_weight) or 2.0)
    batch_size = int((gan_cfg and gan_cfg.batch_size) or 8)
    crop_frames = int((gan_cfg and gan_cfg.crop_frames) or 32)
    interval_log = int((gan_cfg and gan_cfg.interval_log) or 10)
    interval_val = int((gan_cfg and gan_cfg.interval_val) or 200)
    if max_steps is None:
        max_steps = int((gan_cfg and gan_cfg.max_steps) or 10000)
    seed = int(args.train.seed or 0)

    generator = generator_from_h(h)
    if args.enhancer.ckpt and not (gan_cfg and gan_cfg.h):
        # warm start from the pretrained enhancer
        from ..infer.enhancer import NsfHifiGAN

        pre = NsfHifiGAN(args.enhancer.ckpt, device="cpu")
        generator.load_state_dict(pre.model.state_dict())
    else:
        lecun_init_(generator, torch.Generator().manual_seed(seed))
    trainer = GanTrainer(h, lr=lr, mel_weight=mel_weight,
                         fm_weight=fm_weight, mesh=mesh)
    state = trainer.create_state(generator.to(device), seed=seed)

    data_sr, data_hop = int(args.data.sampling_rate), int(args.data.block_size)
    train_set = GanDataset(args.data.train_path, h, data_sr, data_hop)
    valid_set = GanDataset(args.data.valid_path, h, data_sr, data_hop)
    rng = np.random.default_rng(seed)
    # the JAX loop draws one example batch to build its state: drawn here
    # too, so that each step's crops are the JAX loop's
    train_set.sample_batch(rng, batch_size, crop_frames)

    say = print if writer else (lambda *a, **k: None)
    resume = latest_gan_checkpoint(expdir)
    if resume:
        say(f" [*] restoring GAN checkpoint: {resume}")
        restore_gan_checkpoint(resume, state)

    pool = None
    if (gan_cfg and gan_cfg.data_on_device) or args.train.data_on_device:
        pool = ClipPool(train_set, crop_frames, device)
        say(f" [pool] {len(train_set.clips)} clips, "
            f"{pool.audio_bytes / 1e6:.0f} MB audio staged in device memory")

    # this rank's rows of every global batch (the data axis divides it)
    rows = slice(None) if mesh is None else batch_rows(mesh, batch_size)

    def to_device(batch_np, rows=slice(None)) -> Dict[str, torch.Tensor]:
        batch = {k: torch.as_tensor(v[rows], device=device)
                 for k, v in batch_np.items()}
        batch["mel"] = mel_of(h, batch["audio"]).transpose(1, 2)
        return batch

    with torch.no_grad():
        val = to_device(valid_set.sample_batch(np.random.default_rng(7),
                                               batch_size, crop_frames))
    best_val = np.inf

    def hook(phase: str):
        if rand_hook is None:
            return None
        return torch.as_tensor(np.asarray(rand_hook(state.step, phase),
                                          np.float32), device=device)

    t0 = time.time()
    start = state.step
    for _ in range(start, max_steps):
        with torch.no_grad():
            batch = (pool.gather(pool.starts(rng, batch_size)[rows])
                     if pool else to_device(train_set.sample_batch(
                         rng, batch_size, crop_frames), rows))
        logs = trainer.step_d(state, batch, hook("d"))
        logs.update(trainer.step_g(state, batch, hook("g")))
        n = state.step
        if n % interval_log == 0:
            sps = (n - start) / max(time.time() - t0, 1e-9)
            msg = " | ".join(f"{k}: {float(v):.4f}" for k, v in logs.items())
            say(f"gan step {n}/{max_steps} | {msg} | {sps:.2f} it/s",
                flush=True)
        if writer and (n % interval_val == 0 or n >= max_steps):
            v = validate(state.generator, h, val)
            print(f" --- <gan validation> --- mel-L1: {v:.4f}", flush=True)
            save_gan_checkpoint(os.path.join(expdir, f"gan_{n}.pt"), state)
            _export(expdir, h, state.generator, n, best=v < best_val)
            if v < best_val:
                best_val = v
                print(" [V] best enhancer updated.")
    return state, expdir


@torch.no_grad()
def validate(generator: torch.nn.Module, h: dict,
             batch: Dict[str, torch.Tensor]) -> float:
    """Mel L1 of the generator's output (rand_ini zeros) against the
    batch's mel."""
    mel = batch["mel"]
    y = generator(mel, batch["f0"], torch.zeros((mel.shape[0], 9),
                                                device=mel.device))
    m = mel_of(h, y).transpose(1, 2)
    return float((m - mel[:, :m.shape[1]]).abs().mean())
