"""Model factory: config -> Sins, CombSub or CombSubFast, loading a
checkpoint, and the bucketed segment synths.

Counterpart of `ddsp_svc_tpu/models/factory.py` (`build_model`,
`load_model`, and `make_jitted_synth(..., mask_padding=True)`, called with
one segment or, from the batched path, with a (B,) `valid` vector).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..nn.layers import lecun_init_
from ..utils.config import DotDict, load_config
from ..utils.convert import jax_synth_to_torch
from ..utils.flax_msgpack import read_flax_checkpoint
from ..utils.device import resolve_device
from .synths import CombSub, CombSubFast, Sins


def build_model(args: DotDict, device=None, seed: int = 0) -> nn.Module:
    """The synthesizer of `model.type` (Sins, CombSub or CombSubFast) from a
    yaml config, weights drawn from `seed`, on `device` (CUDA unless the
    caller asks for the CPU). model.bf16 runs the PCmer in bf16 (and
    CombSubFast's spectral chain in its kernels' bf16-operand form); the
    parameters stay fp32. model.fused_spectral / model.fused_attention other
    than unset or true raise ValueError: JAX's switches to its XLA chain
    (false) or interpret mode ("force"), where the port runs its kernels on
    every path on the card and has no such switch."""
    for key in ("fused_spectral", "fused_attention"):
        value = args.model.get(key)
        if value is not None and value is not True:
            raise ValueError(
                f"model.{key}: {value!r} is not supported: the port runs its "
                "hand-written kernels on every path on the card (their plain "
                "versions run only on the CPU), so it has no switch to the "
                "plain chain or to interpret mode; leave the key unset or "
                "true")
    device = resolve_device(device)
    mtype = args.model.type
    common = dict(sampling_rate=args.data.sampling_rate,
                  block_size=args.data.block_size,
                  n_unit=args.data.encoder_out_channels,
                  n_spk=args.model.n_spk, causal=bool(args.model.c),
                  bf16=bool(args.model.bf16))
    if mtype == "Sins":
        model = Sins(n_harmonics=args.model.n_harmonics,
                     n_mag_allpass=args.model.n_mag_allpass,
                     n_mag_noise=args.model.n_mag_noise, **common)
    elif mtype == "CombSub":
        model = CombSub(n_mag_allpass=args.model.n_mag_allpass,
                        n_mag_harmonic=args.model.n_mag_harmonic,
                        n_mag_noise=args.model.n_mag_noise, **common)
    elif mtype == "CombSubFast":
        model = CombSubFast(frame_norm=bool(args.model.frame_norm), **common)
    else:
        raise ValueError(f" [x] Unknown Model: {mtype}")
    lecun_init_(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def load_model(model_path: str, device=None) -> Tuple[nn.Module, DotDict]:
    """(model, args) from a checkpoint and the `config.yaml` beside it, on
    `device` (CUDA unless the caller asks for the CPU). Reads three kinds:
    the port's `model_{step}.pt` and a reference-format torch `.pt`
    ({global_step, model, optimizer}, or a bare state dict: the port's
    modules carry the reference's names; entries the port has no use for
    are ignored), and the JAX package's flax-msgpack `.ckpt`, its variables
    mapped by `jax_synth_to_torch`."""
    device = resolve_device(device)
    args = load_config(os.path.join(os.path.dirname(model_path),
                                    "config.yaml"))
    model = build_model(args, device=device)
    if model_path.endswith((".ckpt", ".msgpack")):
        sd = jax_synth_to_torch(read_flax_checkpoint(model_path)[1])
    else:
        sd = torch.load(model_path, map_location="cpu", weights_only=True)
        if isinstance(sd.get("model"), dict):
            sd = sd["model"]
    own = model.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"{model_path} lacks {missing[:4]}"
                       f"{' ...' if len(missing) > 4 else ''}")
    model.load_state_dict({k: sd[k] for k in own})
    return model, args


MIN_BUCKET_FRAMES = 32


def bucket_frames(n: int) -> int:
    """The frame bucket of an n-frame segment: max(32, next_pow2(n))."""
    return max(MIN_BUCKET_FRAMES, 1 << (int(n) - 1).bit_length())


def make_bucketed_synth(model: nn.Module,
                        spk_mix_dict: Optional[Dict[int, float]] = None,
                        mesh=None, mesh_axis: str = "data"):
    """Segment synth with power-of-two frame buckets.

    Segments are padded to max(32, next_pow2(n)) frames: f0 by edge
    replication, units, volume and noise with zeros, and the true length is
    passed as `valid_frames` (only when there is padding), so the padded
    forward equals an exact-length one on the first n frames.

    Returns run(units (1, F, C), f0 (1, F, 1), volume (1, F), spk_id (1, 1),
    noise=None, generator=None) -> signal (1, F*block) on the model's
    device. The arrays are numpy; noise optionally injects the uniform(-1, 1)
    excitation (1, F*block), otherwise it is drawn from `generator`.

    mesh (a `parallel.Mesh` on the model's device): each segment's frames
    sharded over `mesh_axis` (`parallel.make_time_parallel_forward`), the
    make_jitted_synth(mesh=) counterpart. The axis size is a power of two
    and the bucket at least that size; the padding stays masked. Every rank
    calls run with the same segment and returns the whole signal; the noise
    is drawn over the bucket before the forward, as the unsharded model
    draws it, so `generator` (or `noise`) must be the same on every rank.
    """
    block = int(model.block_size)
    device = next(model.parameters()).device
    min_frames, sharded = MIN_BUCKET_FRAMES, None
    if mesh is not None:
        from ..parallel.timeparallel import make_time_parallel_forward

        size = mesh.size(mesh_axis)
        if size & (size - 1):
            raise ValueError(f"mesh axis '{mesh_axis}' size {size} must be "
                             "a power of two to match the frame buckets")
        min_frames = max(min_frames, size)
        sharded = make_time_parallel_forward(model, mesh, axis=mesh_axis,
                                             spk_mix_dict=spk_mix_dict)

    @torch.no_grad()
    def run(units, f0, volume, spk_id, noise=None, generator=None):
        n = units.shape[1]
        pad = max(min_frames, bucket_frames(n)) - n
        if pad:
            units = np.pad(units, ((0, 0), (0, pad), (0, 0)))
            f0 = np.pad(f0, ((0, 0), (0, pad), (0, 0)), mode="edge")
            volume = np.pad(volume, ((0, 0), (0, pad)))
            if noise is not None:
                noise = np.pad(noise, ((0, 0), (0, pad * block)))

        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        inputs = (dev(units), dev(f0), dev(volume), dev(spk_id, torch.int64))
        noise = None if noise is None else dev(noise)
        valid = n if pad else None
        if sharded is None:
            signal, _, _ = model(*inputs, spk_mix_dict=spk_mix_dict,
                                 infer=True, noise=noise, valid_frames=valid,
                                 generator=generator)
        else:
            if noise is None:
                if generator is None:
                    raise ValueError("a time-parallel synth draws its noise "
                                     "from a generator seeded alike on every "
                                     "rank: pass generator= or noise=")
                noise = torch.rand((len(units), (n + pad) * block),
                                   generator=generator, device=device) * 2 - 1
            signal = sharded(*inputs, noise, valid_frames=valid)
        return signal[:, :n * block]

    return run


def make_batched_synth(model: nn.Module,
                       spk_mix_dict: Optional[Dict[int, float]] = None):
    """Synth of a batch of segments padded to one bucket, each with its own
    true length (the batched offline path).

    Returns run(units (B, F, C), f0 (B, F, 1), volume (B, F), spk_id (B, 1),
    valid (B,), noise (B, F*block)) -> signal (B, F*block) on the model's
    device. The arrays are numpy, already padded by the caller (f0 by edge
    replication, the rest with zeros); `valid` goes to the model as a (B,)
    `valid_frames` tensor, so row i's first valid[i] frames equal an
    exact-length forward of item i. The rest of each row is masked output
    for the caller to crop.
    """
    device = next(model.parameters()).device

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    @torch.no_grad()
    def run(units, f0, volume, spk_id, valid, noise):
        signal, _, _ = model(
            dev(units), dev(f0), dev(volume), dev(spk_id, torch.int64),
            spk_mix_dict=spk_mix_dict, infer=True, noise=dev(noise),
            valid_frames=dev(valid, torch.int64))
        return signal

    return run
