#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (`ddsp_svc_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. card: name and power limit (nvidia-smi), TF32 switched off for the
     comparisons below;
  2. build: every CUDA kernel from the checkout's sources (nvcc, sm_90a);
  3. kernels: each hand-written kernel against its plain PyTorch version at
     the main path's shapes, with error, time, plain time and bound;
  4. main path: offline conversion (`convert_features`) with CombSubFast
     from configs/combsub.yaml and the 44.1 kHz NSF-HiFiGAN at full width,
     weights from a seed, on three segments (200, 384, 512 frames); the
     kernels' launch counts over that run; the same run on the plain
     versions; audio-seconds per second at batch 1 and batched.
The last two lines are the kernels JSON and {"ok": true, "device": ...}.
Any failed check exits non-zero before them. Without a GPU it fails.
"""
import json
import math
import os
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_FP32_FLOPS = 67e12   # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3

# the 44.1 kHz community NSF-HiFiGAN geometry (bench.py's H_NSF)
H_NSF = {
    "sampling_rate": 44100,
    "num_mels": 128,
    "n_fft": 2048,
    "win_size": 2048,
    "hop_size": 512,
    "fmin": 40,
    "fmax": 16000,
    "upsample_rates": [8, 8, 2, 2, 2],
    "upsample_kernel_sizes": [16, 16, 4, 4, 4],
    "upsample_initial_channel": 512,
    "resblock": "1",
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
}
SEGMENT_FRAMES = (200, 384, 512)
TRIO_STAGES = ((64, 4), (32, 2), (16, 1))  # (C, source-conv stride)
TPU_KERNELS = "ddsp_svc_tpu/ops/pallas_kernels.py"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, inputs, iters: int = 20) -> float:
    """Median of `iters` CUDA-event timings, cycling through the input
    sets, after a warm-up."""
    for args in inputs[:2]:
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for i in range(iters):
        args = inputs[i % len(inputs)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, name, kern, plain, inputs, tol_abs, tol_rel_max,
            tol_rtol=0.0, select=lambda y: y):
    """Kernel vs plain on every input set: max |err| <= tol_abs + tol_rtol
    |ref| + tol_rel_max * max|ref|. Returns (max_abs_err, ms, plain_ms)."""
    err = 0.0
    for args in inputs:
        ref = select(plain(*args))
        got = select(kern(*args))
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"{name}: non-finite kernel output")
        diff = (got - ref).abs()
        limit = tol_abs + tol_rtol * ref.abs() + tol_rel_max * ref.abs().max()
        if (diff > limit).any():
            fail(f"{name}: max |err| {diff.max().item():.3e} over tolerance")
        err = max(err, diff.max().item())
    return err, time_ms(torch, kern, inputs), time_ms(torch, plain, inputs)


def kernel_phase(torch, K, gen):
    """Each kernel against its plain version at the main path's shapes.
    Returns {name: row} for the kernels JSON line (launches filled later)."""
    dev = "cuda"
    rows = {}

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift)

    # 1. FAVOR+ attention, one PCmer layer at a 512-frame bucket holding a
    # 384-frame segment (the masked form)
    b, h, t, d, m, valid = 1, 8, 512, 64, 266, 384
    from ddsp_svc_tpu_torch.nn.pcmer import gaussian_orthogonal_random_matrix
    proj = torch.from_numpy(gaussian_orthogonal_random_matrix(m, d, 0)).to(dev)
    inputs = [(randn(b, h, t, d), randn(b, h, t, d), randn(b, h, t, d), proj,
               valid) for _ in range(3)]
    err, ms, pms = compare(
        torch, "performer_attention", K.performer_attention,
        K.performer_attention_plain, inputs, 0.0, 2e-5,
        select=lambda y: y[:, :, :valid])
    flops = b * h * (2 * m * d * (2 * t + 2 * valid) + 4 * m * t)
    nbytes = 4 * (b * h * d * (t + 2 * valid + t) + m * d)
    rows["performer_attention"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/performer_attention.cu",
        replaces=f"{TPU_KERNELS}:516", max_abs_err=err, ms=ms, plain_ms=pms,
        bound=bound(nbytes, flops), library_ms=None,
        tol="2e-5 x max|ref| (the JAX package's kernel test)")

    # 2. CombSubFast spectral chain, 513 frame rows of n_fft 1024
    r, n = 513, 1024
    bins = n // 2 + 1
    inputs = [(randn(r, n), randn(r, n), randn(r, bins, scale=0.3),
               randn(r, bins), randn(r, bins, scale=0.3, shift=-3.0), n)
              for _ in range(3)]
    err, ms, pms = compare(torch, "combsub_spectral", K.combsub_spectral,
                           K.combsub_spectral_plain, inputs, 0.0, 2e-5)
    flops = r * (2 * 5 * n * math.log2(n) + 30 * bins)
    nbytes = 4 * (r * (3 * n + 3 * bins) + n)
    rows["combsub_spectral"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/combsub_spectral.cu",
        replaces=f"{TPU_KERNELS}:703", max_abs_err=err, ms=ms, plain_ms=pms,
        bound=bound(nbytes, flops), library_ms=None,
        tol="2e-5 x max|ref| (the JAX package's kernel test)")

    # 3. harmonic source at 512 mel frames x upp 512
    from ddsp_svc_tpu_torch.nn.nsf_hifigan import _source_phase
    f_mel, upp, sr = 512, 512, 44100
    inputs = []
    for _ in range(3):
        f0 = 100 + 400 * torch.rand((1, f_mel), generator=gen, device=dev)
        ri = torch.rand((1, 9), generator=gen, device=dev)
        ri[:, 0] = 0
        start, rad = _source_phase(f0, upp, sr, ri, 8)
        inputs.append((start.contiguous(), rad.contiguous(), randn(9, scale=0.3),
                       randn(1, scale=0.05), upp))
    err, ms, pms = compare(torch, "harmonic_source", K.harmonic_source,
                           K.harmonic_source_plain, inputs, 2e-5, 0.0)
    flops = f_mel * upp * (9 * 8 + 3)
    nbytes = 4 * (f_mel * 18 + 10 + f_mel * upp)
    rows["harmonic_source"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/harmonic_source.cu",
        replaces=f"{TPU_KERNELS}:138", max_abs_err=err, ms=ms, plain_ms=pms,
        bound=bound(nbytes, flops), library_ms=None,
        tol="atol 2e-5 (the JAX package's kernel test)")

    # 4. resblock trio with the source injection, the three narrow stages
    # of a 512-frame segment; then the trio alone (fused_resblocks form)
    # and the per-row valid form at the C = 64 stage
    t_final = f_mel * upp
    errs, ms_sum, pms_sum, flops, nbytes = [], 0.0, 0.0, 0.0, 0.0

    def trio_inputs(c, s, inject=True, valid=None):
        t_s = t_final // s
        ws = [randn(3, 2, c, c, k, scale=(2.0 / (k * c)) ** 0.5)
              for k in (3, 7, 11)]
        bs = [randn(3, 2, c, scale=0.01) for _ in range(3)]
        ksrc = 2 * s if s > 1 else 1
        har = randn(1, t_final, 1, scale=0.1) if inject else None
        return (randn(1, t_s, c), har, randn(c, 1, ksrc, scale=0.2),
                randn(c, scale=0.05), ws, bs, s, (1, 3, 5), valid)

    for c, s in TRIO_STAGES:
        inputs = [trio_inputs(c, s) for _ in range(2)]
        e, ms, pms = compare(torch, f"fused_resblocks_inject C={c}",
                             K.fused_resblocks_inject,
                             K.resblocks_inject_plain, inputs, 1e-4, 0.0,
                             tol_rtol=1e-4)
        say(f"kernel fused_resblocks_inject C={c} T={t_final // s}: max|err| "
            f"{e:.3e} (atol 1e-4, rtol 1e-4), {ms:.3f} ms, plain {pms:.3f} ms")
        errs.append(e)
        ms_sum += ms
        pms_sum += pms
        t_s = t_final // s
        ksrc = 2 * s if s > 1 else 1
        flops += 2 * c * c * 6 * (3 + 7 + 11) * t_s + 2 * c * ksrc * t_s
        nbytes += 4 * (2 * c * t_s + t_final + 6 * c * c * 21 + 18 * c)
    rows["fused_resblocks_inject"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/resblocks.cu",
        replaces=f"{TPU_KERNELS}:1373", max_abs_err=max(errs), ms=ms_sum,
        plain_ms=pms_sum, bound=bound(nbytes, flops), library_ms=None,
        tol="atol 1e-4 + rtol 1e-4 (the JAX package's kernel test)")
    for label, kw in (("fused_resblocks (no injection)", dict(inject=False)),
                      ("fused_resblocks_inject valid=40000",
                       dict(valid=40000))):
        inputs = [trio_inputs(64, 4, **kw)]
        e, ms, pms = compare(torch, label, K.fused_resblocks_inject,
                             K.resblocks_inject_plain, inputs, 1e-4, 0.0,
                             tol_rtol=1e-4)
        say(f"kernel {label} C=64: max|err| {e:.3e} (atol 1e-4, rtol 1e-4), "
            f"{ms:.3f} ms, plain {pms:.3f} ms")
    return rows


@contextmanager
def plain_kernels(K):
    """Route the port's modules through the plain versions (the reference
    run of the main path on the card)."""
    from ddsp_svc_tpu_torch.models import synths
    from ddsp_svc_tpu_torch.nn import nsf_hifigan, pcmer
    swaps = [(pcmer, "performer_attention", K.performer_attention_plain),
             (synths, "combsub_spectral", K.combsub_spectral_plain),
             (nsf_hifigan, "harmonic_source", K.harmonic_source_plain),
             (nsf_hifigan, "fused_resblocks_inject",
              K.resblocks_inject_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def main_path_phase(torch, K):
    from ddsp_svc_tpu_torch.infer.enhancer import Enhancer
    from ddsp_svc_tpu_torch.infer.offline import convert_features
    from ddsp_svc_tpu_torch.models.factory import build_model
    from ddsp_svc_tpu_torch.utils.config import load_config

    args = load_config(os.path.join(ROOT, "configs", "combsub.yaml"))
    model = build_model(args, device="cuda", seed=0)
    enhancer = Enhancer("nsf-hifigan", None, h=H_NSF, seed=1, device="cuda")
    bs, sr = args.data.block_size, args.data.sampling_rate
    n_unit = args.data.encoder_out_channels
    say(f"main path: CombSubFast {sr} Hz block {bs} n_unit {n_unit} "
        f"n_spk {args.model.n_spk} fp32, NSF-HiFiGAN initial channel "
        f"{H_NSF['upsample_initial_channel']}, {len(H_NSF['upsample_rates'])}"
        f" stages, {H_NSF['num_mels']} mels; weights from seeds 0/1")

    rng = np.random.default_rng(0)
    starts, segments = [], []
    pos = 0
    for n in SEGMENT_FRAMES:
        pos += 20
        starts.append(pos)
        segments.append((pos, rng.standard_normal((1, n, n_unit)).astype(np.float32)))
        pos += n
    total = pos + 20
    tt = np.arange(total) / total
    f0 = (220 + 90 * np.sin(2 * np.pi * 3 * tt))[None, :, None].astype(np.float32)
    volume = (0.05 + 0.3 * rng.random((1, total))).astype(np.float32)
    noises = [(rng.random((1, n * bs)) * 2 - 1).astype(np.float32)
              for n in SEGMENT_FRAMES]
    rand_inis = []
    for _ in SEGMENT_FRAMES:
        ri = rng.random((1, 9)).astype(np.float32)
        ri[:, 0] = 0
        rand_inis.append(ri)

    def run():
        out, sr_o = convert_features(
            model, segments, f0, volume, spk_id=1, enhancer=enhancer,
            noise_hook=lambda i, shape: noises[i],
            enhancer_rand_hook=lambda i: rand_inis[i])
        torch.cuda.synchronize()
        return out, sr_o

    K.reset_launch_counts()
    t0 = time.perf_counter()
    audio, sr_o = run()
    first_s = time.perf_counter() - t0
    launches = K.launch_counts()
    say(f"main path launches: {json.dumps(launches)}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"{name} was not launched on the main path")
    rms = float(np.sqrt(np.mean(audio ** 2)))
    expect = round(starts[-1] * bs * sr_o / sr) + SEGMENT_FRAMES[-1] * bs
    if audio.shape != (expect,) or not np.isfinite(audio).all() or rms <= 0:
        fail(f"main path audio: shape {audio.shape} (expected ({expect},)), "
             f"finite {np.isfinite(audio).all()}, rms {rms}")
    with plain_kernels(K):
        ref, _ = run()
    err = float(np.abs(audio - ref).max())
    scale = float(np.abs(ref).max())
    say(f"main path audio: {audio.shape[0]} samples at {sr_o} Hz, rms "
        f"{rms:.4f}; kernels vs plain versions on the card: max|err| "
        f"{err:.3e} = {err / scale:.3e} x max|ref| (tolerance 1e-3 x max|ref|)")
    if not err <= 1e-3 * scale:
        fail("main path audio disagrees with the plain versions")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    seg_audio_s = sum(SEGMENT_FRAMES) * bs / sr
    say(f"main path B=1: {sum(SEGMENT_FRAMES)} frames ({seg_audio_s:.3f} "
        f"audio-s) in {np.median(times) * 1e3:.1f} ms median of 3 "
        f"(first run {first_s * 1e3:.1f} ms): "
        f"{seg_audio_s / np.median(times):.1f} audio-s/s")

    # one batched forward at bench.py's shapes: 512 frames per item
    batch, n_frames = 16, 512
    g = torch.Generator(device="cuda").manual_seed(3)
    units = torch.randn((batch, n_frames, n_unit), generator=g, device="cuda")
    f0b = 110 + 300 * torch.rand((batch, n_frames, 1), generator=g, device="cuda")
    vol = torch.rand((batch, n_frames), generator=g, device="cuda")
    spk = torch.ones((batch, 1), dtype=torch.int64, device="cuda")
    nsf = enhancer.enhancer

    @torch.no_grad()
    def batched(i):
        signal, _, _ = model(units + 0.01 * i, f0b, vol, spk, infer=True,
                             generator=g)
        out, _ = nsf(signal, f0b[..., 0], generator=g)
        return out

    out = batched(0)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        fail("batched forward output is not finite")
    times = []
    for i in range(1, 4):
        t0 = time.perf_counter()
        batched(i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    say(f"batched forward B={batch} x {n_frames} frames: {dt * 1e3:.1f} ms "
        f"median of 3: {batch * n_frames * bs / sr / dt:.1f} audio-s/s")
    return launches


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke test runs only on the card")
    if not os.path.isdir(os.path.join(ROOT, "ddsp_svc_tpu_torch")):
        fail("ddsp_svc_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, ROOT)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    say(smi[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"torch {torch.__version__} CUDA {torch.version.cuda}; "
        "TF32 off for matmuls and cuDNN convs (fp32 comparisons)")

    from ddsp_svc_tpu_torch.ops import build
    from ddsp_svc_tpu_torch.ops import kernels as K
    secs = build.build()
    say(f"build: {len(build.SOURCES)} CUDA sources (nvcc sm_90a) in "
        f"{secs:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = kernel_phase(torch, K, gen)
    for name, row in rows.items():
        t_b, by = row["bound"]
        say(f"kernel {name}: max|err| {row['max_abs_err']:.3e} ({row['tol']}), "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
            f"{t_b:.4f} ms ({by})")
    launches = main_path_phase(torch, K)

    report = []
    for name, row in rows.items():
        t_b, by = row["bound"]
        report.append({
            "name": name, "route": row["route"], "source": row["source"],
            "replaces": row["replaces"], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": t_b, "bound_by": by,
            "library_ms": row["library_ms"],
        })
    say(json.dumps({"kernels": report}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
