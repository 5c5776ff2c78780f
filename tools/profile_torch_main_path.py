#!/usr/bin/env python3
"""Where the PyTorch port's main path spends its time on the card.

Runs offline conversion (`convert_features`: the synthesizer of --config,
CombSubFast from configs/combsub.yaml by default, + the 44.1 kHz
NSF-HiFiGAN, weights from seeds) on three segments of 200, 384 and 512
frames, warms up, then traces one run with torch.profiler (and, with
--train, one training step of the fp32 and of the model.bf16 model at the
config's batch, 24 x 2 s) and prints:
  - wall time of the traced run, device busy time (sum of kernel times),
    and the device's idle share of the wall time;
  - device time by group (the hand-written kernels, convolutions, GEMMs,
    FFTs, everything else) and the top kernels by device time.
Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 tools/profile_torch_main_path.py [--config configs/sins.yaml]
                                             [--batch-frames 0] [--train]
                                             [--enhancer] [--top 25]

--batch-frames N additionally profiles one batched forward of 16 items of N
frames (bench.py's shapes are 512). --enhancer profiles the enhancer alone:
`enhance` on the three segments in each of its forms (default,
fused_inject=False, fused_stage=True) and `enhance_batch` at chip_smoke.py's
16 mixed lengths in one 512-frame bucket. TF32 is off, as in chip_smoke.py.
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (BATCH_FRAMES, ENHANCER_FORMS, H_NSF,  # noqa: E402
                        SEGMENT_FRAMES)  # (the main path's shapes)

GROUPS = (
    ("kernel: performer_attention", ("favor_",)),
    ("kernel: combsub_spectral_bwd", ("combsub_spectral_bwd",)),
    ("kernel: combsub_spectral", ("combsub_spectral",)),
    ("kernel: dft_magnitude", ("dft_magnitude",)),
    ("kernel: harmonic_source", ("harmonic_source",)),
    ("kernel: fused_resblocks_inject", ("resblocks_kernel",)),
    ("kernel: fused_resblock_chain", ("resblock_chain_kernel",)),
    ("kernel: fused_stage", ("fused_stage_kernel",)),
    ("kernel: oscillator_bank", ("oscillator_bank",)),
    ("kernel: ltv_fir_convolve", ("ltv_fir_convolve",)),
    ("convolutions (cuDNN)", ("conv", "cudnn", "implicit", "winograd",
                              "dgrad", "wgrad", "xmma", "sm90_")),
    ("GEMM (cuBLAS)", ("gemm", "cutlass", "ampere_", "sgemm")),
    ("FFT (cuFFT)", ("fft", "regular_fft", "vector_fft")),
    ("optimizer (AdamW)", ("multi_tensor", "adam")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for label, keys in GROUPS:
        if any(k in low for k in keys):
            return label
    return "other (elementwise, reductions, copies)"


def profile(torch, fn, top: int, label: str) -> None:
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for ev in prof.events():
        # user annotations (Optimizer.step#AdamW.step) span kernels listed
        # on their own: counting them too would count that time twice
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            t = ev.time_range.elapsed_us()
            n, c = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (n + t, c + 1)
    busy = sum(t for t, _ in by_name.values()) / 1e3
    print(f"[{label}] wall {wall * 1e3:.2f} ms, device busy {busy:.2f} ms, "
          f"idle share {1 - busy / (wall * 1e3):.3f}, "
          f"{sum(c for _, c in by_name.values())} kernel launches")
    groups = {}
    for name, (t, c) in by_name.items():
        g = groups.setdefault(group_of(name), [0.0, 0])
        g[0] += t / 1e3
        g[1] += c
    for g, (t, c) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"[{label}]   {t:9.3f} ms {100 * t / busy:5.1f}%  {c:5d} launches  {g}")
    print(f"[{label}] top kernels by device time:")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[{label}]   {t / 1e3:9.3f} ms {c:5d}x  {name[:110]}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=os.path.join("configs",
                                                     "combsub.yaml"))
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--batch-frames", type=int, default=0)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--enhancer", action="store_true")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("FAIL: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    from ddsp_svc_tpu_torch.infer.enhancer import Enhancer
    from ddsp_svc_tpu_torch.infer.offline import convert_features
    from ddsp_svc_tpu_torch.models.factory import build_model
    from ddsp_svc_tpu_torch.utils.config import load_config

    args = load_config(os.path.join(ROOT, a.config))
    print(f"config {a.config}: {args.model.type}")
    model = build_model(args, device="cuda", seed=0)
    enhancer = Enhancer("nsf-hifigan", None, h=H_NSF, seed=1, device="cuda")
    n_unit = args.data.encoder_out_channels
    rng = np.random.default_rng(0)
    segments, pos = [], 0
    for n in SEGMENT_FRAMES:
        pos += 20
        segments.append((pos, rng.standard_normal((1, n, n_unit)).astype(np.float32)))
        pos += n
    total = pos + 20
    f0 = (220 + 90 * np.sin(np.linspace(0, 6 * np.pi, total)))[None, :, None]
    volume = (0.05 + 0.3 * rng.random((1, total))).astype(np.float32)

    def run():
        convert_features(model, segments, f0.astype(np.float32), volume,
                         enhancer=enhancer)

    profile(torch, run, a.top, "main path B=1")
    if a.batch_frames:
        b, n = 16, a.batch_frames
        g = torch.Generator(device="cuda").manual_seed(3)
        units = torch.randn((b, n, n_unit), generator=g, device="cuda")
        f0b = 110 + 300 * torch.rand((b, n, 1), generator=g, device="cuda")
        vol = torch.rand((b, n), generator=g, device="cuda")
        spk = torch.ones((b, 1), dtype=torch.int64, device="cuda")

        @torch.no_grad()
        def batched():
            signal, _, _ = model(units, f0b, vol, spk, generator=g)
            enhancer.enhancer(signal, f0b[..., 0], generator=g)

        profile(torch, batched, a.top, f"batched B={b} x {n}")
    if a.train:
        profile_training(torch, args, a.top)
    if a.enhancer:
        profile_enhancer(torch, a.top)


def profile_enhancer(torch, top: int) -> None:
    """The enhancer alone at H_NSF: enhance B=1 on three segments of
    random audio (200, 384, 512 frames) in each form, and enhance_batch of
    16 items in one 512-frame bucket in the two forms it can run."""
    from ddsp_svc_tpu_torch.infer.enhancer import Enhancer

    hop, sr = H_NSF["hop_size"], H_NSF["sampling_rate"]
    rng = np.random.default_rng(2)
    segs = [(0.1 * rng.standard_normal(n * hop)).astype(np.float32)
            for n in SEGMENT_FRAMES]
    items = [(0.1 * rng.standard_normal(n * hop)).astype(np.float32)
             for n in BATCH_FRAMES]
    ri = np.zeros((len(BATCH_FRAMES), 9), np.float32)
    for label, forms, _ in ENHANCER_FORMS:
        enh = Enhancer("nsf-hifigan", None, h=H_NSF, seed=1, device="cuda",
                       generator_overrides=forms)
        audio = [torch.as_tensor(x, device="cuda")[None] for x in segs]

        def run():
            for x in audio:
                n = x.shape[-1] // hop
                enh.enhance(x, sr, np.full((1, n, 1), 220.0, np.float32), hop,
                            rand_ini=ri[:1])

        profile(torch, run, top, f"enhancer {label} B=1")
        if not forms.get("fused_stage"):
            profile(torch, lambda: enh.enhance_batch(
                items, sr, [np.full((1, n, 1), 220.0, np.float32)
                            for n in BATCH_FRAMES], hop, rand_ini=ri,
                pad_to=max(BATCH_FRAMES) * hop), top,
                f"enhance_batch {label} B={len(BATCH_FRAMES)}")


def profile_training(torch, args, top: int) -> None:
    """One training step at the config's batch and crop (random batch on the
    device, the RSS scales drawn per step), fp32 and model.bf16, after steps
    that made every bucket's cuFFT plans."""
    from ddsp_svc_tpu_torch.models.factory import build_model
    from ddsp_svc_tpu_torch.models.losses import RSSLoss
    from ddsp_svc_tpu_torch.train.step import (
        TrainState, create_optimizer, train_step, warm_up_buckets)

    b = int(args.train.batch_size)
    frames = int(args.data.duration * args.data.sampling_rate
                 / args.data.block_size)
    g = torch.Generator(device="cuda").manual_seed(5)
    batch = dict(
        units=torch.randn((b, frames, args.data.encoder_out_channels),
                          generator=g, device="cuda"),
        f0=110 + 300 * torch.rand((b, frames, 1), generator=g, device="cuda"),
        volume=0.05 + 0.3 * torch.rand((b, frames), generator=g, device="cuda"),
        spk_id=torch.ones((b, 1), dtype=torch.int64, device="cuda"),
        audio=0.3 * torch.randn((b, frames * args.data.block_size),
                                generator=g, device="cuda"))
    rss = RSSLoss(int(args.loss.fft_min), int(args.loss.fft_max),
                  int(args.loss.n_scale))
    for bf16 in (False, True):
        args["model"]["bf16"] = bf16
        model = build_model(args, device="cuda", seed=0)
        state = TrainState(0, model, create_optimizer(model, 1e-4))
        warm_up_buckets(state, batch, rss)
        profile(torch, lambda: train_step(state, batch, rss), top,
                f"train step {'bf16' if bf16 else 'fp32'} B={b} x {frames}")


if __name__ == "__main__":
    main()
