#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (`ddsp_svc_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. card: name and power limit (nvidia-smi), TF32 switched off for the
     comparisons below;
  2. build: every CUDA kernel from the checkout's sources (nvcc, sm_90a)
     and the native NCCF f0 library (g++, the JAX package's flags);
  3. kernels: each hand-written kernel against its plain PyTorch version at
     the main path's shapes, with error, time (one call at a time, and
     device_ms: calls back to back), plain time and bound (#1 also at B =
     16, and split into its moments and apply entries, against the single
     launch and each against its plain version; #3 and #8, the sine banks, also against float64, within twice the
     fp32 plain version's own error, with their registers, spills and
     shared memory, #8 at each of its two shapes; #6, #7 and #9 also per
     row, on rows of unequal scale, against float64, #7 with its registers,
     spills and shared memory; #4, #5, #10 and #11, all
     on the tensor-core conv core, with their registers, spills and shared
     memory; #10's three chains beside #5 and the cuDNN chain, #11 beside
     the cuDNN ConvTranspose followed by #4); the bf16-input forms of #4
     (the three narrow stages, har fp32, and C = 64 with bf16 har), #5 (C
     = 64) and #6 (the 16 RSS sizes and the staged mel's 430 x 2048), each
     against its plain version on the same bf16 inputs (the trio within
     one bf16 ulp), its library call beside it (the bf16 cuDNN chain; cuFFT
     on the upcast frames); the keyshift/speed mel and HubertDiscrete on
     the card against their CPU runs; the bf16-operand forms (mxu_bf16:
     #1 and its split on bf16 q, k, v, #2, #7, the trio #4/#5 on fp32 and
     bf16 stages, #10, #11), each against its plain form (the same bf16
     rounding points: max|err| 2^-8 x max|ref|, 2^-7 on a bf16 output,
     rel RMS 1e-3, 2e-3 for the conv core) and float64 (the plain form in
     float64 with the same roundings, within the same bounds), with the
     library call beside each (the
     bf16 cuDNN chain for the conv core);
  4a. the slice's path (the bf16-operand forms): configs/combsub.yaml's
     CombSubFast with model.bf16 and the H_NSF enhancer with
     generator_overrides {"fused_mxu_bf16": True} (its default,
     fused_inject=False and fused_stage=True forms) converting the offline
     path's three segments: #1's, #2's and the conv core's forms counted,
     no fp32 form, the audio against the same run on the plain forms (rel
     RMS 5e-2, the JAX package's bf16 bound) and beside the fp32 run;
  4. the CLI path: `python -m ddsp_svc_tpu_torch.infer`'s main on a 13 s
     44.1 kHz wav of three sung phrases (wav in, checkpoint in, wav out) at
     configs/combsub.yaml's full width: a `model_0.pt` from a seed, a
     HuBERT-soft checkpoint in the bshall layout and an NSF-HiFiGAN
     checkpoint (H_NSF) written from seeds; CREPE f0 (`-pe crepe -e true`),
     run fp32, with the enhancer staged bf16 at 128 channels, and fp32 on the
     plain versions; each run's launches (#1/#2/#3/#4 at 3/1/1/3 a segment),
     output (44.1 kHz, within a block of the input, finite, RMS > 0), the
     kernel run against the plain one (1e-3 x max|ref|) and staged against
     fp32 (rel RMS 2e-2); the parselmouth, dio and harvest f0 on the card
     against their CPU runs; the stage walls (f0 per family, CREPE's network
     and host decode apart, units, synth + enhance, write) and the total as
     audio-s/s, each beside the card's name and power limit;
  4b. the batch path: the CLI's directory mode (`-i DIR -o OUT --batch 16
     -pe crepe -eak 0`) on six sung 44.1 kHz wavs of 3..13 s (12 segments
     in the 64..512-frame buckets) with the CLI phase's checkpoints: every
     output written, finite, of its input's length; `run_inference_batch`
     with injected noise and rotations, fp32 and staged bf16, against
     `run_inference` file by file (fp32 1e-4 x max|ref|; staged rel RMS
     2e-2); #1-#4 (#6 staged) launched as the bucket plan says; each
     stage's wall and the first and warm audio-s/s;
  4c. the preprocess path: `python -m ddsp_svc_tpu_torch.preprocess`'s main
     on 2 speakers x 3 clips x 4 s (and a validation clip each) with f0
     parselmouth on the native NCCF library and HuBERT-soft on the card:
     the store's files, f0_stats.npy against the clips' pitch, the units
     against the CPU's plain path (1e-4 x max|ref|), the stage walls and
     files/s, then one trainer step that reads the store;
  4d. enhancer GAN fine-tuning (`python -m ddsp_svc_tpu_torch.train_gan`)
     at H_NSF's full width warm-started from the CLI phase's NSF-HiFiGAN,
     batch 8 x 32-frame crops of a 2 x 3 x 4 s store: one D and one G step
     on the kernels against the plain versions (each loss term 1e-4
     relative, every gradient through grads_agree; #3/#4 at 1/3 a step);
     ms per D, G and D + G step, it/s, peak memory and a warm G step's
     device time by part (torch.profiler); the entry's 4 steps, a resume to
     6 and 2 steps on the device clip pool (checkpoints, exports,
     config.json, #3/#4 at 1/3 a generator forward); the exported
     model_best.pt converting the CLI phase's wav through the CLI (#3/#4 at
     1/3 a segment); the G step's three worst gradient leaves against the
     plain versions and a float64 step, with #3 and #4 each alone on its
     plain version;
  4e. streaming, with the CLI phase's checkpoints: a 10.8 s sung 44.1 kHz
     wav through `python -m ddsp_svc_tpu_torch.stream`'s session at
     gui.py's defaults (SOLA: 0.9 s windows of 78 frames in the 128-frame
     bucket, enhancer on, fp32, noise and SineGen phases injected) at
     pipeline_depth 0, at depth 1 (bit for bit depth 0's blocks, one
     late) and on the plain versions (each window within 1e-3 x max|ref|,
     the spliced blocks where the SOLA shifts agree); #1/#2/#3/#4 at
     3/1/1/3 a window; the block walls (p50/p95/max against 300 ms); the
     stream at adaptive key 0 through the eager core and through
     SvcCore(fused_window=True) (one CUDA graph per window shape), cuDNN
     deterministic: each fused window within 1e-6 x max|ref| of the eager
     one, #1-#4 counted 3/1/1/3 at each replay, both cores' block walls,
     one window's launch calls and idle share, the capture's time; a warm
     window's stages; then a causal + frame_norm model_0.pt from a seed
     through IncrementalSession (26 frames a block, dio): its replay
     through the engine (atol 2e-5), the engine against the batch forward
     on 64 frames (1e-3 x max|ref|; #2 once, #1 never), the block walls
     and the CUDA launches a frame (torch.profiler);
  4f. serving, with the CLI phase's checkpoints: model_0.pt exported by
     `python -m ddsp_svc_tpu_torch.export`'s `export_synth` at 512 frames
     on the card, loaded by torch.export.load: its graph's ddsp_svc op
     nodes (3 performer_attention, 1 combsub_spectral), a replay's
     launches (3/1), the artifact against the eager model on the kernels
     (1e-6 x max|ref|) and on the plain versions (1e-3 x max|ref|); the
     same for Sins (configs/sins.yaml; #1 with #8 and #9) and CombSub
     (configs/combsub-old.yaml; #1 with #9) from seeds at full width;
     `serve`'s handler in-process on 127.0.0.1:0 (ExportedSynth over the
     CombSubFast artifact): the 13 s wav posted to /convert (first and
     warm) and /voiceChangeModel?fPitchChange=2, GET /healthz, each
     response finite, RMS > 0, as long as its frames and within PCM16
     quantization of ExportedSynth.convert called directly, #1/#2 at 3/1
     a window (3 windows at a step of 504 frames); `api`'s handler
     in-process: the 13 s wav with enhance=true&pe=dio&sampleRate=16000
     and with enhance=false, each against a fresh SvcCore.infer at the
     same step resampled the same way (PCM16 quantization), and against
     the plain versions (1e-3 x max|ref|), #1-#4 launches a request; the
     web panel's handler: genconfig, one /stream run of the 10.8 s wav
     (block stats, the wav written) and one infer job (the port's CLI as
     a subprocess on the card, exited 0, its wav written); walls and
     audio-s/s beside the card's name and power limit;
  4g. time-parallel conversion (`ddsp_svc_tpu_torch/parallel/`), with the
     CLI phase's checkpoints on its 13 s wav (dio f0, HuBERT-soft units;
     1121 frames in the 2048 bucket): ranks spawned on cuda:0, world size
     1 over NCCL, then 2 over Gloo (NCCL refuses two ranks on one card),
     each running make_bucketed_synth(mesh=) (noise injected),
     Enhancer(mesh=).enhance fp32 and staged bf16 at 128 on the unsharded
     synth's output, and SvcCore(mesh=).infer; every rank's whole output
     against the unsharded run on the kernels (synth and SvcCore 1e-4 x
     max|ref|, enhancer fp32 1e-5 x max|ref|, staged rel RMS 2e-2); #1's
     moments and apply, #2, #3 and #4 launched on every rank, the single
     #1 never; a model.bf16 synth on the same weights sharded against
     unsharded (rel RMS 5e-2; the split's and #2's bf16-operand forms on
     every rank); the walls of each run and of the unsharded one;
  4h. training on a mesh (`parallel/sharding.py`, `train_step(mesh=)`):
     configs/combsub.yaml's CombSubFast at full width, batch 24 x 172
     frames of a synthetic store, ranks spawned on cuda:0 (world size 1
     over NCCL, then 2 over Gloo), cuDNN deterministic: data-parallel and
     tensor-parallel (1 x 2) steps, fp32 and DP bf16 (#2, #7), each one
     step from the same weights, batch, noise and loss scales as a
     single-process eager step here (loss rtol 2e-4; parameters' 99th
     percentile of |diff| over all entries < 1e-4, max < 4e-3 x lr /
     1e-3), then timed steps with the idle share; the graphed K = 4
     dispatch under DP Gloo 2 against 4 eager DP steps; a DP GAN D + G
     step at H_NSF (#3, #4) against the single-process one (losses 1e-4
     relative, generator atol 1e-5 + rtol 1e-4); a causal + frame_norm
     CombSubFast time-sharded on 1024 frames against its unsharded
     forward (1e-5 x max|ref|); each rank's launches (#6 on every step)
     and peak memory;
  5. offline paths: conversion (`convert_features`) with each synthesizer
     at the full width of its config (CombSubFast from configs/combsub.yaml,
     Sins from configs/sins.yaml, CombSub from configs/combsub-old.yaml) and
     the 44.1 kHz NSF-HiFiGAN, weights from seeds, on three segments (200,
     384, 512 frames); the kernels' launch counts over each run; the same
     run on the plain versions; audio-seconds per second at batch 1 (and,
     for CombSubFast, batched);
  6. enhancer forms (after the CombSubFast offline path, on its three
     segments' audio and f0): the default form (#3, #4), fused_inject=False
     (#3, #5) and fused_stage=True (#3, #11) at H_NSF's full width, each
     against the same run on the plain versions, with its launch counts and
     B=1 wall; Enhancer.enhance_batch at B = 16 on a 512-frame bucket of
     mixed lengths (default and fused_inject=False), each item against its
     own enhance call with the tail past it exactly 0; one enhance with
     adaptive key 2 (44.1 <-> 49.5 kHz); H_NSF staged at 64 (the C = 64
     stage on #4's bf16-input form; with fused_inject=False on #5's) and in
     full bf16 (the three narrow stages), each mel on #6's bf16-input
     form: launches a segment, rel RMS to the fp32 forward (2e-2) and to
     the same form on the plain versions (2e-3, or twice the plain form's
     spread on a one-ulp move of the audio), with #3 and #4 each alone on
     its plain version, and the walls;
  7. training paths: the port's trainer (`python -m ddsp_svc_tpu_torch.train`
     main) on a synthetic dataset in the AudioDataset layout at each
     config's full width (batch 24, 2-s crops, RSS loss 256..2048 x 4
     scales): fp32 steps with a validation pass and a checkpoint; for
     CombSubFast also a resume from it, then model.bf16 steps with a
     validation pass and a bf16 validation forward on the kernels against
     the plain versions; the entry with the four train options together
     (steps_per_dispatch 4, data_on_device, remat, async_save; fp32, and
     bf16 for CombSubFast), each asynchronous checkpoint against a
     synchronous one of the same state, with the training thread's ms in
     save_model for both; each run's launch counts; the graphed step
     (train/graphed.py) against the eager one from the same weights and
     data with cuDNN deterministic (and the spread of two default eager
     runs beside it): for CombSubFast fp32 and bf16 8 steps as two K = 4
     dispatches on the loader's batches and on the device pool, for Sins
     and CombSub one dispatch, each loss within 1e-5 relative and every
     parameter within 1e-4 x max|param|, the replays' launch counts equal
     to the eager steps' (#6 8 a step; #2/#7, #8, #9 through the replays);
     for CombSubFast ms a step eager, graphed and graphed on the pool
     (median of 5 dispatches, the capture apart), CUDA launch API calls a
     step and the idle share (torch.profiler), a remat step's gradients
     against the plain step's and the peak memory with and without remat;
     one fp32 step (and for CombSubFast one bf16 step) on the kernels
     against the same on the plain versions (loss and every parameter
     gradient); ms per step.
The last two lines are the kernels JSON and {"ok": true, "device": ...}.
Any failed check exits non-zero before them. Without a GPU it fails.
"""
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_FP32_FLOPS = 67e12   # H100 SXM, fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM, TF32 on the tensor cores, dense
PEAK_BF16_FLOPS = 989e12  # H100 SXM, bf16 on the tensor cores, dense
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
# the training path: RSS bucket indices pinned for the kernel-vs-plain step
# (375, 853, 1331, 2047), and the numbers of steps of each training run
PINNED_LOSS_IDX = (1, 5, 9, 15)
FP32_STEPS, BF16_STEPS, TIMED_STEPS = 3, 3, 5
TRAIN_CROP_SAMPLES = 172 * 512  # 2 s at 44.1 kHz, block 512
TRIO_STAGES = ((64, 4), (32, 2), (16, 1))  # (C, source-conv stride)
TRIO_K = (3, 7, 11)
TPU_KERNELS = "ddsp_svc_tpu/ops/pallas_kernels.py"
TRIO_ROUTE = "tensor cores: mma.sync tf32, 3xTF32, fp32 re-accumulation"
MXU_ROUTE = ("tensor cores: mma.sync.m16n8k16 bf16, fp32 accumulation and "
             "re-accumulation")
# the bf16-operand forms (mxu_bf16=True) of the kernels a model.bf16
# CombSubFast runs: what each fp32 form's count becomes under model.bf16
MXU_FORMS = {"performer_attention": "performer_attention_mxu_bf16",
             "performer_attention_moments":
                 "performer_attention_moments_mxu_bf16",
             "performer_attention_apply": "performer_attention_apply_mxu_bf16",
             "combsub_spectral": "combsub_spectral_mxu_bf16",
             "combsub_spectral_bwd": "combsub_spectral_bwd_mxu_bf16"}
# a form's kernel against its plain form (the same bf16 rounding points):
# max |err| <= 2^-8 x max|ref| (2^-7 on a bf16 output, whose rounding may
# flip by one ulp) and rel RMS <= 1e-3; the conv core's 18-conv chains
# cascade flipped roundings to up to 9.5e-4 (tests/test_torch_cuda.py), so
# its rel RMS gate is 2e-3
MXU_MAX, MXU_BF16_OUT_MAX, MXU_REL_RMS, MXU_CONV_REL_RMS = (
    2.0 ** -8, 2.0 ** -7, 1e-3, 2e-3)


def bf16_names(names, bf16: bool = True) -> tuple:
    """The kernels' names as a model.bf16 run counts them (MXU_FORMS)."""
    return tuple(MXU_FORMS.get(n, n) if bf16 else n for n in names)
# each synthesizer's config and the kernels its offline path runs (the
# enhancer's harmonic source and trio included); its training path runs the
# same synth kernels, dft_magnitude in the loss, and the attention kernel in
# the validation forward. The last field, full: the default model
# (CombSubFast) adds the batched offline forward and, in training, a resume
# and the model.bf16 runs
ENHANCER_KERNELS = ("harmonic_source", "fused_resblocks_inject")
# the enhancer's forms (generator_overrides) and the kernels each runs
ENHANCER_FORMS = (("default", {}, ENHANCER_KERNELS),
                  ("fused_inject=False", {"fused_inject": False},
                   ("harmonic_source", "fused_resblocks")),
                  ("fused_stage=True", {"fused_stage": True},
                   ("harmonic_source", "fused_stage")))
# the bf16-input trio on the enhancer: (label, NsfHifiGAN keywords, the
# launches of one segment's enhance); staged at 64 only the C = 64 stage is
# bf16 (its trio #4's bf16-input form, or with fused_inject=False #5's),
# the full-bf16 Generator's three narrow stages are; every mel takes #6's
# bf16-input form
ENHANCER_BF16 = (
    ("staged bf16 (64)", {"bf16_min_channels": 64},
     {"fused_resblocks_inject_bf16": 1, "fused_resblocks_inject": 2,
      "dft_magnitude_bf16": 1, "harmonic_source": 1}),
    ("full bf16", {"dtype": "bfloat16"},
     {"fused_resblocks_inject_bf16": 3, "fused_resblocks_inject": 0,
      "dft_magnitude_bf16": 1, "harmonic_source": 1}),
    ("staged bf16 (64), fused_inject=False",
     {"bf16_min_channels": 64, "generator_overrides": {"fused_inject": False}},
     {"fused_resblocks_bf16": 1, "fused_resblocks": 2,
      "dft_magnitude_bf16": 1, "harmonic_source": 1}))
# enhance_batch: 16 items of these lengths in one 512-frame bucket
BATCH_FRAMES = (512, 384, 300, 200, 511, 450, 128, 333, 256, 500, 64, 400,
                280, 350, 199, 417)
SYNTHS = (("CombSubFast", "combsub.yaml",
           ("performer_attention", "combsub_spectral"), True),
          ("Sins", "sins.yaml",
           ("performer_attention", "oscillator_bank", "ltv_fir_convolve"),
           False),
          ("CombSub", "combsub-old.yaml",
           ("performer_attention", "ltv_fir_convolve"), False))


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


def device_ms(torch, fn, inputs, calls: int = 20, turns: int = 5) -> float:
    """Median over `turns` of (`calls` calls back to back between one pair
    of CUDA events, cycling through the input sets) / `calls`: the device's
    time per call as long as the host keeps ahead of it (else the host's)."""
    for args in inputs[:2]:
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(turns):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(calls):
            fn(*inputs[i % len(inputs)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def bound(n_bytes: float, n_ops: float, peak: float = PEAK_FP32_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_3xtf32(n_bytes: float, fp32_flops: float):
    """The bound of fp32 products run in 3xTF32 on the tensor cores: three
    TF32 products for each fp32 one, at the TF32 peak."""
    return bound(n_bytes, 3 * fp32_flops, PEAK_TF32_FLOPS)


def compare(torch, name, kern, plain, inputs, tol_abs, tol_rel_max,
            tol_rtol=0.0, select=lambda y: y):
    """Kernel vs plain on every input set: max |err| <= tol_abs + tol_rtol
    |ref| + tol_rel_max * max|ref|, for each output of a kernel that returns
    several (each against its own max|ref|). Returns (max_abs_err, ms,
    plain_ms, device_ms)."""
    err = 0.0
    for args in inputs:
        refs, gots = plain(*args), kern(*args)
        torch.cuda.synchronize()
        if not isinstance(refs, tuple):
            refs, gots = (refs,), (gots,)
        for ref, got in zip(refs, gots):
            ref, got = select(ref), select(got)
            if not torch.isfinite(got).all():
                fail(f"{name}: non-finite kernel output")
            diff = (got - ref).abs()
            limit = (tol_abs + tol_rtol * ref.abs()
                     + tol_rel_max * ref.abs().max())
            if (diff > limit).any():
                fail(f"{name}: max |err| {diff.max().item():.3e} over "
                     "tolerance")
            err = max(err, diff.max().item())
    return (err, time_ms(torch, kern, inputs), time_ms(torch, plain, inputs),
            device_ms(torch, kern, inputs))


def errors_vs_float64(torch, kern, plain, args):
    """max |out - ref| / max |ref| of the kernel and of the fp32 plain
    version, ref the plain version in float64 on the card."""
    ref = plain(*[[a.double() for a in v] if isinstance(v, list)
                  else v.double() if torch.is_tensor(v) else v for v in args])
    scale = ref.abs().max()
    return tuple(((fn(*args).double() - ref).abs().max() / scale).item()
                 for fn in (kern, plain))


def float64_gate(torch, name, kern, plain, args):
    """errors_vs_float64 of a kernel whose plain version is its float64
    yardstick's own formula: the kernel's error may be at most twice the
    fp32 plain version's, + 1e-7 (all relative to max |f64|)."""
    e64, p64 = errors_vs_float64(torch, kern, plain, args)
    if not e64 <= 2 * p64 + 1e-7:
        fail(f"{name}: {e64:.3e} x max|ref| against float64, over 2 x the "
             f"plain's {p64:.3e} + 1e-7")
    return e64, p64


def kernel_phase(torch, K, gen):
    """Each kernel against its plain version at the main path's shapes.
    Returns {name: row} for the kernels JSON line (launches filled later)."""
    dev = "cuda"
    rows = {}

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift)

    def build_info(info):
        return (f"{info['registers']} registers, {info['spill_bytes']} bytes "
                f"spilled, {info['smem_bytes']} bytes of shared memory")

    # 1. FAVOR+ attention, one PCmer layer at a 512-frame bucket holding a
    # 384-frame segment (the masked form)
    b, h, t, d, m, valid = 1, 8, 512, 64, 266, 384
    from ddsp_svc_tpu_torch.nn.pcmer import gaussian_orthogonal_random_matrix
    proj = torch.from_numpy(gaussian_orthogonal_random_matrix(m, d, 0)).to(dev)
    inputs = [(randn(b, h, t, d), randn(b, h, t, d), randn(b, h, t, d), proj,
               valid) for _ in range(3)]
    err, ms, pms, dms = compare(
        torch, "performer_attention", K.performer_attention,
        K.performer_attention_plain, inputs, 0.0, 2e-5,
        select=lambda y: y[:, :, :valid])

    def attention_bound(b, t, valid):
        flops = b * h * (2 * m * d * (2 * t + 2 * valid) + 4 * m * t)
        nbytes = 4 * (b * h * d * (t + 2 * valid + t) + m * d)
        return bound(nbytes, flops)

    info = K.attention_kernel_info(t)
    say(f"kernel performer_attention T={t}: clusters of {info['cluster']} "
        f"CTAs; {build_info(info)}")
    # the batched offline forward's shape: 16 items of 512 frames
    inputs16 = [(randn(16, h, t, d), randn(16, h, t, d), randn(16, h, t, d),
                 proj, None) for _ in range(2)]
    e16, ms16, pms16, dms16 = compare(
        torch, "performer_attention B=16", K.performer_attention,
        K.performer_attention_plain, inputs16, 0.0, 2e-5)
    say(f"kernel performer_attention B=16 T={t}: max|err| {e16:.3e}, "
        f"{ms16:.4f} ms, device_ms {dms16:.4f}, plain {pms16:.4f} ms, bound "
        f"{attention_bound(16, t, t)[0]:.4f} ms")
    rows["performer_attention"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/performer_attention.cu",
        replaces=f"{TPU_KERNELS}:516", max_abs_err=err, ms=ms, plain_ms=pms,
        device_ms=dms, bound=attention_bound(b, t, valid), library_ms=None,
        tol="2e-5 x max|ref| (the JAX package's kernel test); B = 1, T = 512 "
            "with 384 valid frames")

    # 1b. #1 split at the key reduction (the time-parallel PCmer's entries),
    # at the same shapes: the moments over [0, 384) then the apply against
    # the single launch, and each entry against its plain version with a key
    # range inside the span ([96, 352)) and over the valid keys
    def split(q, k, v, proj, valid):
        return K.performer_attention_apply(
            q, proj, *K.performer_attention_moments(k, v, proj, 0, valid))

    worst = 0.0
    for q_, k_, v_, proj_, valid_ in inputs:
        ref = K.performer_attention(q_, k_, v_, proj_, valid_)[:, :, :valid_]
        got = split(q_, k_, v_, proj_, valid_)[:, :, :valid_]
        torch.cuda.synchronize()
        diff = (got - ref).abs().max().item()
        if not diff <= 2e-5 * ref.abs().max().item():
            fail(f"performer_attention moments + apply: max|err| {diff:.3e} "
                 "against the single launch, over 2e-5 x max|ref|")
        worst = max(worst, diff)
    ranges = [(k_, v_, proj_, lo, hi) for (_, k_, v_, proj_, _), (lo, hi) in
              zip(inputs, ((0, valid), (96, 352), (0, valid)))]
    err_m, ms_m, pms_m, dms_m = compare(
        torch, "performer_attention_moments", K.performer_attention_moments,
        K.performer_attention_moments_plain, ranges, 0.0, 2e-5)
    moments = [K.performer_attention_moments(*r_) for r_ in ranges]
    applies = [(q_, proj_, *mo) for (q_, _, _, proj_, _), mo in
               zip(inputs, moments)]
    err_a, ms_a, pms_a, dms_a = compare(
        torch, "performer_attention_apply", K.performer_attention_apply,
        K.performer_attention_apply_plain, applies, 0.0, 2e-5)
    for which in ("moments", "apply"):
        say(f"kernel performer_attention_{which} T={t}: "
            f"{build_info(K.attention_kernel_info(t, which))}")
    say(f"kernel performer_attention moments + apply B={b} T={t} valid "
        f"{valid}: max|err| {worst:.3e} against the single launch (2e-5 x "
        f"max|ref|; the same tiles and sums, designed bit for bit)")
    m_flops = b * h * (4 * m * d * valid + 2 * m * valid)
    m_bytes = 4 * (b * h * (2 * valid * d + m * d + m) + m * d)
    a_flops = b * h * (4 * m * d * t + 4 * m * t)
    a_bytes = 4 * (b * h * (2 * t * d + m * d + m) + m * d)
    for name, e_, ms_, pms_, dms_, bnd, what in (
            ("performer_attention_moments", err_m, ms_m, pms_m, dms_m,
             bound(m_bytes, m_flops), "key ranges [0, 384) and [96, 352)"),
            ("performer_attention_apply", err_a, ms_a, pms_a, dms_a,
             bound(a_bytes, a_flops), "T = 512 queries")):
        rows[name] = dict(
            route="cuda", source="ddsp_svc_tpu_torch/csrc/performer_attention.cu",
            replaces=f"{TPU_KERNELS}:516", max_abs_err=e_, ms=ms_,
            plain_ms=pms_, device_ms=dms_, bound=bnd, library_ms=None,
            tol=f"2e-5 x max|ref| of each output; B = 1, H = 8, {what}")

    # 2. CombSubFast spectral chain, 513 frame rows of n_fft 1024
    r, n = 513, 1024
    bins = n // 2 + 1
    inputs = [(randn(r, n), randn(r, n), randn(r, bins, scale=0.3),
               randn(r, bins), randn(r, bins, scale=0.3, shift=-3.0), n)
              for _ in range(3)]
    err, ms, pms, dms = compare(torch, "combsub_spectral", K.combsub_spectral,
                                K.combsub_spectral_plain, inputs, 0.0, 2e-5)
    flops = r * (2 * 5 * n * math.log2(n) + 30 * bins)
    nbytes = 4 * (r * (3 * n + 3 * bins) + n)
    rows["combsub_spectral"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/combsub_spectral.cu",
        replaces=f"{TPU_KERNELS}:703", max_abs_err=err, ms=ms, plain_ms=pms,
        device_ms=dms, bound=bound(nbytes, flops), library_ms=None,
        tol="2e-5 x max|ref| (the JAX package's kernel test)")

    # 3. harmonic source at 512 mel frames x upp 512, also against float64
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
    err, ms, pms, dms = compare(torch, "harmonic_source", K.harmonic_source,
                                K.harmonic_source_plain, inputs, 2e-5, 0.0)
    e64, p64 = float64_gate(torch, "harmonic_source", K.harmonic_source,
                            K.harmonic_source_plain, inputs[0])
    flops = f_mel * upp * (9 * 8 + 3)
    nbytes = 4 * (f_mel * 18 + 10 + f_mel * upp)
    say(f"kernel harmonic_source {f_mel} frames x upp {upp} "
        f"({build_info(K.harmonic_source_kernel_info())}): max|err| "
        f"{err:.3e} (atol 2e-5); against float64 {e64:.3e} x max|ref| (at "
        f"most 2 x the plain's + 1e-7), the fp32 plain {p64:.3e}; {ms:.4f} "
        f"ms, device_ms {dms:.4f}, plain {pms:.4f} ms")
    rows["harmonic_source"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/harmonic_source.cu",
        replaces=f"{TPU_KERNELS}:138", max_abs_err=err, ms=ms, plain_ms=pms,
        device_ms=dms, bound=bound(nbytes, flops), library_ms=None,
        tol="atol 2e-5 (the JAX package's kernel test)")

    # 4. resblock trio with the source injection, the three narrow stages
    # of a 512-frame segment; then the trio alone (fused_resblocks form)
    # and the per-row valid form at the C = 64 stage. The kernel runs every
    # conv on the tensor cores; its bound counts the three TF32 products of
    # each fp32 one at the TF32 peak (the fp32 CUDA-core bound beside it).
    # The library time is the plain version: the fp32 cuDNN conv chain
    t_final = f_mel * upp
    errs, ms_sum, pms_sum, dms_sum, flops, nbytes = [], 0.0, 0.0, 0.0, 0.0, 0.0

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
        e, ms, pms, dms = compare(torch, f"fused_resblocks_inject C={c}",
                             K.fused_resblocks_inject,
                             K.resblocks_inject_plain, inputs, 1e-4, 0.0,
                             tol_rtol=1e-4)
        if not e <= 2e-5:
            fail(f"fused_resblocks_inject C={c}: max|err| {e:.3e} over 2e-5")
        say(f"kernel fused_resblocks_inject C={c} T={t_final // s} "
            f"({TRIO_ROUTE}; {build_info(K.trio_kernel_info(c))}): max|err| "
            f"{e:.3e} (atol 1e-4, "
            f"rtol 1e-4; at most 2e-5), {ms:.3f} ms, device_ms {dms:.3f}, "
            f"plain (fp32 cuDNN chain) {pms:.3f} ms")
        errs.append(e)
        ms_sum += ms
        pms_sum += pms
        dms_sum += dms
        t_s = t_final // s
        ksrc = 2 * s if s > 1 else 1
        flops += 2 * c * c * 6 * (3 + 7 + 11) * t_s + 2 * c * ksrc * t_s
        nbytes += 4 * (2 * c * t_s + t_final + 6 * c * c * 21 + 18 * c)
    say(f"kernel fused_resblocks_inject: bound "
        f"{bound_3xtf32(nbytes, flops)[0]:.4f} ms in 3xTF32, {bound(nbytes, flops)[0]:.4f} ms in fp32 on the CUDA "
        "cores")
    rows["fused_resblocks_inject"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/resblocks.cu",
        replaces=f"{TPU_KERNELS}:1373", max_abs_err=max(errs), ms=ms_sum,
        plain_ms=pms_sum, device_ms=dms_sum, bound=bound_3xtf32(nbytes, flops),
        library_ms=pms_sum,
        tol="atol 1e-4 + rtol 1e-4 (the JAX package's kernel test), max|err| "
            "at most 2e-5; library: the fp32 cuDNN conv chain (the plain "
            "version)")
    try:  # a width the kernel has no instance for raises, never falls back
        K.fused_resblocks(randn(1, 100, 24), [randn(3, 2, 24, 24, k)
                                              for k in TRIO_K],
                          [randn(3, 2, 24)] * 3)
    except ValueError as exc:
        say(f"kernel fused_resblocks at C=24 on the card raises: {exc}")
    else:
        fail("fused_resblocks took C = 24")
    trio_c64 = {}
    for label, kw in (("fused_resblocks (no injection)", dict(inject=False)),
                      ("fused_resblocks_inject valid=40000",
                       dict(valid=40000))):
        inputs = [trio_inputs(64, 4, **kw)]
        if "inject" in kw:  # the fused_resblocks wrapper (#5)
            def kern(x, har, ncw, ncb, ws, bs, s, dils, valid):
                return K.fused_resblocks(x, ws, bs, dils, valid)
        else:
            kern = K.fused_resblocks_inject
        e, ms, pms, dms = compare(torch, label, kern, K.resblocks_inject_plain,
                                  inputs, 1e-4, 0.0, tol_rtol=1e-4)
        if not e <= 2e-5:
            fail(f"{label}: max|err| {e:.3e} over 2e-5")
        if "valid" in kw:
            tail = kern(*inputs[0])[:, 40000:]
            if tail.any():
                fail(f"{label}: output past the valid length is not 0")
        # counted as #4's stage at C = 64, without the injection conv's input
        # (or, for the valid form, as the full stage)
        c, t_s = 64, t_final // 4
        flops = 2 * c * c * 6 * (3 + 7 + 11) * t_s
        nbytes = 4 * (2 * c * t_s + 6 * c * c * 21 + 18 * c)
        if "inject" not in kw:
            flops += 2 * c * 8 * t_s
            nbytes += 4 * t_final
        t_b, by = bound_3xtf32(nbytes, flops)
        say(f"kernel {label} C=64 ({TRIO_ROUTE}): max|err| {e:.3e} (atol "
            f"1e-4, rtol 1e-4; at most 2e-5), {ms:.3f} ms, device_ms "
            f"{dms:.3f}, plain (fp32 cuDNN "
            f"chain) {pms:.3f} ms, bound {t_b:.4f} ms ({by}) in 3xTF32, "
            f"{bound(nbytes, flops)[0]:.4f} ms in fp32"
            + ("; tail past 40000 exactly 0" if "valid" in kw else ""))
        if "inject" in kw:
            trio_c64 = dict(ms=ms, err=e, plain_ms=pms)
            rows["fused_resblocks"] = dict(
                route="cuda", source="ddsp_svc_tpu_torch/csrc/resblocks.cu",
                replaces=f"{TPU_KERNELS}:1315", max_abs_err=e, ms=ms,
                plain_ms=pms, device_ms=dms, bound=(t_b, by), library_ms=pms,
                tol="atol 1e-4 + rtol 1e-4 (the JAX package's kernel test), "
                    "max|err| at most 2e-5; the C = 64 stage without the "
                    "injection; library: the fp32 cuDNN conv chain (the "
                    "plain version)")

    # 6. DFT magnitude of the RSS loss at every bucket size, at the frame rows
    # of one training batch (24 crops of 88064 samples, hop = n_fft), with
    # the route the kernel takes (a power-of-two FFT, or Bluestein at FFT
    # length M, around the half-length split for even n); the bound counts
    # an FFT of the same size (2.5 n log2 n per real row)
    from ddsp_svc_tpu_torch.models.losses import default_buckets

    err = ms_sum = pms_sum = dms_sum = lms_sum = flops = nbytes = 0.0

    def library_mag(x, n):
        return torch.abs(torch.fft.rfft(x, n))

    for n in default_buckets(256, 2048):
        rows_n = 24 * ((TRAIN_CROP_SAMPLES - n) // n + 1)
        win = torch.hann_window(n, periodic=True, device=dev)
        inputs = [(randn(rows_n, n, scale=0.1) * win, n) for _ in range(2)]
        e, ms, pms, dms = compare(torch, f"dft_magnitude n={n}",
                                  K.dft_magnitude, K.dft_magnitude_plain,
                                  inputs, 2e-3, 0.0)
        lms = time_ms(torch, library_mag, inputs)
        bins = n // 2 + 1
        f_n = rows_n * (2.5 * n * math.log2(n) + 4 * bins)
        b_n = 4 * rows_n * (n + bins)
        l, m = K.dft_plan(n)
        route = (f"power of two, {l}-point FFT" if m == l else
                 f"Bluestein of {l} at M={m}"
                 + (", split" if 2 * l == n else ""))
        say(f"kernel dft_magnitude n={n} rows={rows_n} ({route}): max|err| "
            f"{e:.3e}, {ms:.4f} ms, device_ms {dms:.4f}, plain {pms:.4f} ms, "
            f"library {lms:.4f} ms, bound {bound(b_n, f_n)[0]:.4f} ms")
        err, ms_sum, pms_sum, lms_sum = (max(err, e), ms_sum + ms,
                                         pms_sum + pms, lms_sum + lms)
        dms_sum += dms
        flops += f_n
        nbytes += b_n
    # the staged-bf16 CLI run's mel: the reflect-padded frames of the CLI
    # wav's longest segment (5 s) at H_NSF's n_fft and hop, Hann-windowed
    n, hop = H_NSF["n_fft"], H_NSF["hop_size"]
    pad = (n - hop) // 2 + max((n - hop + 1) // 2, hop)
    rows_n = (int(5.0 * H_NSF["sampling_rate"]) + pad - n) // hop + 1
    win = torch.hann_window(n, periodic=True, device=dev)
    inputs = [(randn(rows_n, n, scale=0.1) * win, n) for _ in range(2)]
    e, ms, pms, dms = compare(torch, f"dft_magnitude mel n={n}",
                              K.dft_magnitude, K.dft_magnitude_plain,
                              inputs, 2e-3, 0.0)
    bins = n // 2 + 1
    say(f"kernel dft_magnitude at the staged mel's shape, n={n} rows="
        f"{rows_n}: max|err| {e:.3e}, {ms:.4f} ms, device_ms {dms:.4f}, "
        f"plain {pms:.4f} ms, library "
        f"{time_ms(torch, library_mag, inputs):.4f} ms, bound "
        f"{bound(4 * rows_n * (n + bins), rows_n * (2.5 * n * math.log2(n) + 4 * bins))[0]:.4f} ms")
    err = max(err, e)
    # rows of unequal scale (10^u, u uniform in [-4, 0]), as silent frames
    # sit beside loud ones in the loss: each row against the plain version
    # in float64 on the CPU, within 1e-4 of its own max; the plain version
    # on the card (cuFFT) beside it
    for n in (853, 2047):
        scale = 10.0 ** (-4 * torch.rand((301, 1), generator=gen, device=dev))
        x = randn(301, n) * scale
        ref = K.dft_magnitude_plain(x.double().cpu(), n)
        worst = {label: ((fn(x, n).double().cpu() - ref).abs().amax(1)
                         / ref.amax(1)).max().item()
                 for label, fn in (("kernel", K.dft_magnitude),
                                   ("plain (cuFFT)", K.dft_magnitude_plain))}
        say(f"kernel dft_magnitude n={n}, 301 rows scaled by 10^[-4, 0], "
            f"worst row vs float64 / its own max: kernel "
            f"{worst['kernel']:.3e} (tolerance 1e-4), plain (cuFFT) "
            f"{worst['plain (cuFFT)']:.3e}")
        if not worst["kernel"] <= 1e-4:
            fail(f"dft_magnitude n={n}: a row of small scale disagrees")
    rows["dft_magnitude"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/dft_magnitude.cu",
        replaces=f"{TPU_KERNELS}:241", max_abs_err=err, ms=ms_sum,
        plain_ms=pms_sum, device_ms=dms_sum, bound=bound(nbytes, flops),
        library_ms=lms_sum,
        tol="atol 2e-3 (the JAX package's kernel test), also at the staged "
            "mel's shape; times are the sum of one call at each of the 16 "
            "bucket sizes")

    # 7. the spectral chain's adjoint at the training batch: 24 x 173 frame
    # rows of n_fft 1024, all five gradients
    r, n = 24 * 173, 1024
    bins = n // 2 + 1
    inputs = [(randn(r, n, scale=1e-3), randn(r, n), randn(r, n),
               randn(r, bins, scale=0.3), randn(r, bins),
               randn(r, bins, scale=0.3, shift=-3.0), n) for _ in range(2)]
    err, ms, pms, dms = compare(torch, "combsub_spectral_bwd",
                                K.combsub_spectral_bwd,
                                K.combsub_spectral_bwd_plain, inputs, 0.0, 2e-5)
    flops = r * (5 * 2.5 * n * math.log2(n) + 40 * bins)
    nbytes = 4 * (r * (5 * n + 6 * bins) + n)
    say(f"kernel combsub_spectral_bwd {r} x {n} "
        f"({build_info(K.combsub_bwd_kernel_info(n))}): max|err| {err:.3e} "
        f"(2e-5 x max|ref| per gradient), {ms:.4f} ms, device_ms {dms:.4f}, "
        f"plain {pms:.4f} ms, bound {bound(nbytes, flops)[0]:.4f} ms")
    # rows whose g, tooth and noise are each scaled by their own 10^u, u
    # uniform in [-4, 0], the last 101 with noise at 1e-3 of tooth's scale:
    # each row of each gradient against the plain adjoint in float64 on the
    # CPU, within 2e-5 of its own max; the plain version on the card
    # (cuFFT) beside it
    def scale():
        return 10.0 ** (-4 * torch.rand((301, 1), generator=gen, device=dev))

    s_tooth, s_noise = scale(), scale()
    s_noise[200:] = 1e-3 * s_tooth[200:]
    args = (randn(301, n) * scale(), randn(301, n) * s_tooth,
            randn(301, n) * s_noise, randn(301, bins, scale=0.3),
            randn(301, bins), randn(301, bins, scale=0.3, shift=-3.0), n)
    refs = K.combsub_spectral_bwd_plain(
        *(a.double().cpu() if torch.is_tensor(a) else a for a in args))
    worst = {}
    for label, fn in (("kernel", K.combsub_spectral_bwd),
                      ("plain (cuFFT)", K.combsub_spectral_bwd_plain)):
        worst[label] = [((got.double().cpu() - ref).abs().amax(1)
                         / ref.abs().amax(1)).max().item()
                        for got, ref in zip(fn(*args), refs)]
    say(f"kernel combsub_spectral_bwd n={n}, 301 rows, g, tooth, noise "
        f"scaled by 10^[-4, 0] (101 with noise 1e-3 x tooth), worst row vs "
        f"float64 / its own max, d_tooth d_noise d_hm d_hp d_nm: kernel "
        + " ".join(f"{e:.3e}" for e in worst["kernel"]) + " (tolerance "
        "2e-5), plain (cuFFT) "
        + " ".join(f"{e:.3e}" for e in worst["plain (cuFFT)"]))
    if not max(worst["kernel"]) <= 2e-5:
        fail("combsub_spectral_bwd: a row of small scale disagrees")
    rows["combsub_spectral_bwd"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/combsub_spectral_bwd.cu",
        replaces=f"{TPU_KERNELS}:781", max_abs_err=err, ms=ms, plain_ms=pms,
        device_ms=dms, bound=bound(nbytes, flops), library_ms=None,
        tol="2e-5 x max|ref| per gradient (the JAX package's kernel test)")

    # 8. the Sins oscillator bank, 128 harmonics at block 512, amplitudes
    # <= 0.1 (the JAX package's kernel test), at the offline 512-frame bucket
    # (1 x 512 frames) and a training batch (24 x 172 frames), also against
    # float64. The bound counts 9 fp32 operations per (sample, harmonic) at
    # the FMA-counted peak: the lerp (2), the harmonic multiple (1), the
    # wrap (3), the sine (1), the sum (2)
    bs, n_h = 512, 128
    err = rel = ms_sum = pms_sum = dms_sum = flops = nbytes = 0.0
    for b, f in ((1, 512), (24, 172)):
        inputs = [((torch.rand((b, f * bs), generator=gen, device=dev) * 2
                    - 1) * math.pi,
                   torch.rand((b, f, n_h), generator=gen, device=dev) * 0.1,
                   bs) for _ in range(2)]
        scale = max(K.oscillator_bank_plain(*a).abs().max().item()
                    for a in inputs)
        e, ms, pms, dms = compare(torch, f"oscillator_bank {b}x{f}",
                                  K.oscillator_bank, K.oscillator_bank_plain,
                                  inputs, 2e-3, 0.0)
        e64, p64 = float64_gate(torch, f"oscillator_bank {b}x{f}",
                                K.oscillator_bank, K.oscillator_bank_plain,
                                inputs[0])
        err, rel = max(err, e), max(rel, e / scale)
        ms_sum, pms_sum, dms_sum = ms_sum + ms, pms_sum + pms, dms_sum + dms
        terms = b * f * bs * n_h
        f_n, b_n = 9 * terms, 4 * (2 * b * f * bs + b * f * n_h)
        flops += f_n
        nbytes += b_n
        say(f"kernel oscillator_bank {b} x {f} frames x {n_h} harmonics "
            f"({build_info(K.oscillator_bank_kernel_info(n_h))}): max|err| "
            f"{e:.3e} (rel {e / scale:.2e}); against float64 {e64:.3e} x "
            f"max|ref| (at most 2 x the plain's + 1e-7), the fp32 plain "
            f"{p64:.3e}; {ms:.4f} ms, device_ms {dms:.4f}, plain {pms:.4f} "
            f"ms, bound {bound(b_n, f_n)[0]:.4f} ms (max|ref| {scale:.3f})")
    rows["oscillator_bank"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/oscillator_bank.cu",
        replaces=f"{TPU_KERNELS}:49", max_abs_err=err, ms=ms_sum,
        plain_ms=pms_sum, device_ms=dms_sum, bound=bound(nbytes, flops),
        library_ms=None,
        tol=f"atol 2e-3 at amplitudes <= 0.1 (the JAX package's kernel "
            f"test), relative {rel:.2e}; times are the sum of the offline "
            f"and the training shape")

    # 9. the LTV-FIR convolution of frequency_filter: frames of 1024 with
    # impulse responses of 510 (all-pass and noise filters) and 1022
    # (CombSub's harmonic filter), n_fft 2048, at the offline rows (one
    # 512-frame bucket + 1) and a training batch's (24 x 173); the library
    # time is the three-call cuFFT chain irfft(rfft(a) * rfft(h)). The bound
    # counts three real FFTs of n_fft (2.5 n log2 n each), as #6's does
    def library_conv(a, h, n):
        return torch.fft.irfft(torch.fft.rfft(a, n) * torch.fft.rfft(h, n), n)

    n_fft, frame = 2048, 1024
    err = ms_sum = pms_sum = dms_sum = lms_sum = flops = nbytes = 0.0
    for r in (513, 24 * 173):
        for ir in (510, 1022):
            inputs = [(randn(r, frame), randn(r, ir, scale=0.02), n_fft)
                      for _ in range(2)]
            e, ms, pms, dms = compare(torch, f"ltv_fir_convolve {r}x{ir}",
                                      K.ltv_fir_convolve,
                                      K.ltv_fir_convolve_plain, inputs, 0.0,
                                      2e-4)
            lms = time_ms(torch, library_conv, inputs)
            f_n = r * (3 * 2.5 * n_fft * math.log2(n_fft)
                       + 6 * (n_fft // 2 + 1))
            b_n = 4 * r * (frame + ir + n_fft)
            say(f"kernel ltv_fir_convolve rows={r} ir={ir}: max|err| {e:.3e}, "
                f"{ms:.4f} ms, device_ms {dms:.4f}, plain {pms:.4f} ms, "
                f"three-call cuFFT chain {lms:.4f} ms, bound "
                f"{bound(b_n, f_n)[0]:.4f} ms")
            err, ms_sum, pms_sum, lms_sum = (max(err, e), ms_sum + ms,
                                             pms_sum + pms, lms_sum + lms)
            dms_sum += dms
            flops += f_n
            nbytes += b_n
    # the gradients through the autograd Function against autograd of the
    # plain version, at the training rows
    a, h, g = randn(4152, frame), randn(4152, 1022, scale=0.02), \
        randn(4152, n_fft)
    grads = []
    for fn in (K.ltv_fir_convolve, K.ltv_fir_convolve_plain):
        xs = [a.clone().requires_grad_(), h.clone().requires_grad_()]
        (fn(*xs, n_fft) * g).sum().backward()
        grads.append([x.grad for x in xs])
    for name, gk, gp in zip(("a", "h"), *grads):
        e = ((gk - gp).abs().max() / gp.abs().max()).item()
        say(f"kernel ltv_fir_convolve gradient of {name} at 4152 rows: "
            f"{e:.3e} x max|ref| (tolerance 2e-4)")
        if not e <= 2e-4:
            fail(f"ltv_fir_convolve: gradient of {name} disagrees")
    # a and h rows scaled independently by 10^[-3, 0] at the training rows:
    # each row against float64 on the CPU within 2e-4 of its own max
    def scaled(*shape):
        return randn(*shape) * 10.0 ** (-3 * torch.rand(
            (shape[0], 1), generator=gen, device=dev))

    a, h = scaled(4152, frame), scaled(4152, 1022)
    ref = K.ltv_fir_convolve_plain(a.double().cpu(), h.double().cpu(), n_fft)
    worst = {label: ((fn(a, h, n_fft).double().cpu() - ref).abs().amax(1)
                     / ref.abs().amax(1)).max().item()
             for label, fn in (("kernel", K.ltv_fir_convolve),
                               ("plain (cuFFT)", K.ltv_fir_convolve_plain))}
    say(f"kernel ltv_fir_convolve 4152 rows, a and h scaled by 10^[-3, 0], "
        f"worst row vs float64 / its own max: kernel {worst['kernel']:.3e} "
        f"(tolerance 2e-4), plain (cuFFT) {worst['plain (cuFFT)']:.3e}")
    if not worst["kernel"] <= 2e-4:
        fail("ltv_fir_convolve: a row of small scale disagrees")
    rows["ltv_fir_convolve"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/ltv_fir_convolve.cu",
        replaces=f"{TPU_KERNELS}:399", max_abs_err=err, ms=ms_sum,
        plain_ms=pms_sum, device_ms=dms_sum, bound=bound(nbytes, flops),
        library_ms=lms_sum,
        tol="2e-4 x max|ref| (the JAX package's kernel test); times are the "
            "sum over the offline and training rows at ir 510 and 1022; "
            "library: the three-call cuFFT chain")

    # 10. one resblock chain (no path runs it; the JAX package's neither):
    # the C = 64 stage of a 512-frame segment, T = 65536, at each k, on the
    # trio's tensor-core conv core (resblock_mma.cuh), bound as #4. The sum
    # of its three chains is the trio's conv work without the mean, beside
    # #5 and the fp32 cuDNN chains from this call
    c, t_s = 64, t_final // 4
    err = ms_sum = pms_sum = dms_sum = flops = nbytes = 0.0
    for k in TRIO_K:
        inputs = [(randn(1, t_s, c), randn(3, 2, c, c, k,
                                           scale=(2.0 / (k * c)) ** 0.5),
                   randn(3, 2, c, scale=0.01), k) for _ in range(2)]
        e, ms, pms, dms = compare(torch, f"fused_resblock_chain k={k}",
                                  K.fused_resblock_chain,
                                  K.resblock_chain_plain, inputs, 1e-4, 0.0,
                                  tol_rtol=1e-4)
        e64, p64 = errors_vs_float64(torch, K.fused_resblock_chain,
                                     K.resblock_chain_plain, inputs[0])
        if not e64 <= 4e-6:
            fail(f"fused_resblock_chain k={k}: {e64:.3e} x max|ref| against "
                 "float64, over 4e-6")
        f_k = 2 * c * c * 6 * k * t_s
        b_k = 4 * (2 * c * t_s + 6 * c * c * k + 6 * c)
        say(f"kernel fused_resblock_chain C={c} T={t_s} k={k} ({TRIO_ROUTE}; "
            f"{build_info(K.chain_kernel_info(c, k))}): max|err| {e:.3e} "
            f"(atol 1e-4, rtol 1e-4; the trio's 2e-5 as a target); against "
            f"float64 {e64:.3e} x max|ref| (at most 4e-6), the fp32 cuDNN "
            f"chain {p64:.3e}; {ms:.3f} ms, device_ms {dms:.3f}, plain "
            f"(fp32 cuDNN chain) {pms:.3f} ms, bound "
            f"{bound_3xtf32(b_k, f_k)[0]:.4f} ms in 3xTF32, "
            f"{bound(b_k, f_k)[0]:.4f} ms in fp32")
        err, ms_sum, pms_sum = max(err, e), ms_sum + ms, pms_sum + pms
        dms_sum += dms
        flops += f_k
        nbytes += b_k
    say(f"fused_resblock_chain at C=64 T={t_s}, this call: k = 3 + 7 + 11 "
        f"{ms_sum:.3f} ms, max|err| {err:.3e}; / #5 (the trio, "
        f"{trio_c64['ms']:.3f} ms) {ms_sum / trio_c64['ms']:.3f}; / its fp32 "
        f"cuDNN chains ({pms_sum:.3f} ms) {ms_sum / pms_sum:.3f}; #5's fp32 "
        f"cuDNN chain {trio_c64['plain_ms']:.3f} ms")
    rows["fused_resblock_chain"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/resblock_chain.cu",
        replaces=f"{TPU_KERNELS}:1415", max_abs_err=err, ms=ms_sum,
        plain_ms=pms_sum, device_ms=dms_sum, bound=bound_3xtf32(nbytes, flops),
        library_ms=pms_sum,
        tol="atol 1e-4 + rtol 1e-4 (the JAX package's kernel test), max|err| "
            "at most 2e-5; times are the sum of k = 3, 7, 11 at C = 64, T = "
            "65536; conv core ddsp_svc_tpu_torch/csrc/resblock_mma.cuh; "
            "library: the fp32 cuDNN conv chain (the plain version)")

    # 11. the fused stage: H_NSF's three narrow stages (u = 2) of a 512-frame
    # segment, from x_pre (1, T / 2, 2C), on the tensor-core conv core, bound
    # as #4; its library time is the same stage as the cuDNN ConvTranspose
    # followed by #4
    def stage_inputs(c, s):
        t_out = t_final // s
        ws = [randn(3, 2, c, c, k, scale=(2.0 / (k * c)) ** 0.5)
              for k in TRIO_K]
        bs = [randn(3, 2, c, scale=0.01) for _ in range(3)]
        ksrc = 2 * s if s > 1 else 1
        return (randn(1, t_out // 2, 2 * c), randn(1, t_final, 1, scale=0.1),
                randn(2 * c, c, 4, scale=(1.0 / (2 * c * 4)) ** 0.5),
                randn(c, scale=0.05), randn(c, 1, ksrc, scale=0.2),
                randn(c, scale=0.05), ws, bs, 2, s)

    def unfused_stage(x_pre, har, uw, ub, nw, nb, ws, bs, u, s):
        x_up = torch.nn.functional.conv_transpose1d(
            torch.nn.functional.leaky_relu(x_pre.transpose(1, 2), 0.1), uw, ub,
            stride=u, padding=u // 2).transpose(1, 2)
        return K.fused_resblocks_inject(x_up, har, nw, nb, ws, bs, s)

    err = ms_sum = pms_sum = dms_sum = ums_sum = flops = nbytes = 0.0
    for c, s in TRIO_STAGES:
        inputs = [stage_inputs(c, s) for _ in range(2)]
        e, ms, pms, dms = compare(torch, f"fused_stage C={c}", K.fused_stage,
                                  K.stage_plain, inputs, 2e-4, 0.0,
                                  tol_rtol=2e-4)
        if not e <= 2e-5:
            fail(f"fused_stage C={c}: max|err| {e:.3e} over 2e-5")
        e64, p64 = errors_vs_float64(torch, K.fused_stage, K.stage_plain,
                                     inputs[0])
        if not e64 <= 4e-6:
            fail(f"fused_stage C={c}: {e64:.3e} x max|ref| against float64, "
                 "over 4e-6")
        ums = time_ms(torch, unfused_stage, inputs)
        t_out, ksrc = t_final // s, (2 * s if s > 1 else 1)
        f_c = (2 * c * c * 6 * 21 * t_out + 2 * 2 * c * c * 2 * t_out
               + 2 * c * ksrc * t_out)
        b_c = 4 * (2 * c * t_out // 2 + t_final + c * t_out
                   + 6 * c * c * 21 + 8 * c * c + 20 * c + c * ksrc)
        say(f"kernel fused_stage C={c} T_out={t_out} ({TRIO_ROUTE}; "
            f"{build_info(K.stage_kernel_info(c))}): max|err| {e:.3e} (atol "
            f"2e-4, rtol 2e-4; at most 2e-5); against float64 {e64:.3e} x "
            f"max|ref| (at most 4e-6), the fp32 plain {p64:.3e}; {ms:.3f} ms, "
            f"device_ms {dms:.3f}, plain {pms:.3f} ms,"
            f" library (cuDNN ConvTranspose + fused_resblocks_inject) "
            f"{ums:.3f} ms, bound {bound_3xtf32(b_c, f_c)[0]:.4f} ms in "
            f"3xTF32, {bound(b_c, f_c)[0]:.4f} ms in fp32")
        err, ms_sum, pms_sum = max(err, e), ms_sum + ms, pms_sum + pms
        dms_sum += dms
        ums_sum += ums
        flops += f_c
        nbytes += b_c
    rows["fused_stage"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/fused_stage.cu",
        replaces=f"{TPU_KERNELS}:1694", max_abs_err=err, ms=ms_sum,
        plain_ms=pms_sum, device_ms=dms_sum, bound=bound_3xtf32(nbytes, flops),
        library_ms=ums_sum,
        tol="atol 2e-4 + rtol 2e-4 (the JAX package's kernel test), max|err| "
            "at most 2e-5; times are the sum of the three narrow stages (C = "
            "64, 32, 16); conv core ddsp_svc_tpu_torch/csrc/resblock_mma.cuh; "
            "library: the cuDNN ConvTranspose followed by #4")

    # the backward of #4, #10 and #11 (autograd Functions re-running the
    # plain versions) at the C = 64 stage against autograd of the plain
    # versions, with a random cotangent
    def grads(fn, tensors, statics, up):
        xs = [[x.clone().requires_grad_() for x in a] if isinstance(a, list)
              else a.clone().requires_grad_() for a in tensors]
        (fn(*xs, *statics) * up).sum().backward()
        return [x.grad.double() for a in xs
                for x in (a if isinstance(a, list) else [a])]

    trio = trio_inputs(64, 4)
    chain = (randn(1, t_s, 64), randn(3, 2, 64, 64, 7, scale=(2 / 448) ** 0.5),
             randn(3, 2, 64, scale=0.01))
    stage = stage_inputs(64, 4)
    up = randn(1, t_s, 64)
    for name, kern, plain, tensors, statics in (
            ("fused_resblocks_inject", K.fused_resblocks_inject,
             K.resblocks_inject_plain, list(trio[:6]), (4,)),
            ("fused_resblock_chain", K.fused_resblock_chain,
             K.resblock_chain_plain, list(chain), (7,)),
            ("fused_stage", K.fused_stage, K.stage_plain, list(stage[:8]),
             (2, 4))):
        worst_rel, worst_cos = 0.0, 1.0
        for gk, gp in zip(grads(kern, tensors, statics, up),
                          grads(plain, tensors, statics, up)):
            rel = ((gk - gp).norm() / gp.norm()).item()
            cos = ((gk * gp).sum() / (gk.norm() * gp.norm())).item()
            worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
        say(f"kernel {name} backward at C=64 T={t_s}, kernel vs autograd of "
            f"the plain version: worst gradient rel {worst_rel:.3e} (< 2e-2),"
            f" cos {worst_cos:.7f} (> 1 - 1e-4)")
        if not (worst_rel < 2e-2 and worst_cos > 1 - 1e-4):
            fail(f"{name}: backward disagrees with autograd of the plain "
                 "version")
    return rows


# one bf16 ulp: a bf16-input form and its plain version upcast exactly and
# compute in fp32, so only the output's rounding to bf16 may flip
BF16_ULP = (2e-5, 2.0 ** -7)  # (atol, rtol)


def cudnn_bf16_trio(torch, K, x, har, ncw, ncb, ws, bs, s, dils,
                    valid=None):
    """A stage's trio as the Generator ran a bf16 stage on cuDNN: x cast to
    bf16, the injection conv and the 18 convs in bf16 on weights cast per
    call (the library yardstick of the bf16 forms)."""
    bf16 = torch.bfloat16
    xc = x.transpose(1, 2).to(bf16)
    if har is not None:
        xc = xc + K.noise_conv_cf(har.transpose(1, 2).to(bf16), ncw.to(bf16),
                                  ncb.to(bf16), s, xc.shape[-1])
    acc = sum(K.resblock1_cf(xc, w.to(bf16), b.to(bf16), w.shape[-1], dils)
              for w, b in zip(ws, bs))
    return (acc / len(ws)).transpose(1, 2)


def to_f64(torch, args) -> list:
    """A kernel's arguments with every tensor (and tensor list) in float64."""
    return [[x.double() for x in a] if isinstance(a, list)
            else a.double() if torch.is_tensor(a) and a.is_floating_point()
            else a for a in args]


def mxu_compare(torch, name, kern, plain, inputs, rel_rms=MXU_REL_RMS,
                select=lambda y: y):
    """A bf16-operand form's kernel against its plain form on every input
    set, each output apart: max |err| <= MXU_MAX x max|ref| (MXU_BF16_OUT_MAX
    on a bf16 output) and rel RMS <= rel_rms; on the first set, each fp32
    output against float64 (the plain form evaluated in float64, with the
    same bf16 roundings) within the same bounds. Not "twice the fp32 plain
    form's error": a flipped bf16 rounding of a dominant term moves an
    output by up to 2^-8 of itself, so either fp32 side's largest error
    against float64 is a draw of a few flips (tests/test_torch_cuda.py's
    card test of #1 read the kernel at 2.2e-3 x max|ref|, the plain form at
    3.6e-4). Returns (max_abs_err, ms, plain_ms, device_ms, worst rel RMS,
    kernel and plain errors against float64 / max|f64|)."""
    err = worst = 0.0
    for args in inputs:
        refs, gots = plain(*args), kern(*args)
        torch.cuda.synchronize()
        if not isinstance(refs, tuple):
            refs, gots = (refs,), (gots,)
        for ref, got in zip(refs, gots):
            limit = MXU_BF16_OUT_MAX if got.dtype == torch.bfloat16 \
                else MXU_MAX
            ref, got = select(ref).float(), select(got).float()
            if not torch.isfinite(got).all():
                fail(f"{name}: non-finite kernel output")
            diff = (got - ref).abs().max().item()
            rel = ((got - ref).pow(2).mean() / ref.pow(2).mean()).sqrt().item()
            if not (diff <= limit * ref.abs().max().item() and rel <= rel_rms):
                fail(f"{name}: max|err| {diff:.3e}, rel RMS {rel:.3e} against "
                     f"its plain form, over {limit:g} x max|ref| or {rel_rms}")
            err, worst = max(err, diff), max(worst, rel)
    args = inputs[0]
    refs, gots, f64s = plain(*args), kern(*args), plain(*to_f64(torch, args))
    if not isinstance(refs, tuple):
        refs, gots, f64s = (refs,), (gots,), (f64s,)
    e64 = p64 = None  # None: every output bf16 (rounded once more)
    for ref, got, f64 in zip(refs, gots, f64s):
        if got.dtype == torch.bfloat16:
            continue
        ref, got, f64 = select(ref), select(got), select(f64)
        scale = f64.abs().max().item()
        d = got.double() - f64
        e_k = d.abs().max().item() / scale
        e_p = (ref.double() - f64).abs().max().item() / scale
        rel = (d.pow(2).mean() / f64.pow(2).mean()).sqrt().item()
        if not (e_k <= MXU_MAX and rel <= rel_rms):
            fail(f"{name}: {e_k:.3e} x max|ref|, rel RMS {rel:.3e} against "
                 f"float64, over {MXU_MAX:g} or {rel_rms}")
        e64, p64 = max(e64 or 0.0, e_k), max(p64 or 0.0, e_p)
    return (err, time_ms(torch, kern, inputs), time_ms(torch, plain, inputs),
            device_ms(torch, kern, inputs), worst, e64, p64)


def mxu_forms_phase(torch, K, gen) -> dict:
    """The bf16-operand forms (JAX's mxu_bf16=True) against their plain
    forms at the main path's shapes (mxu_compare): #1 and its split on the
    bf16 q, k, v a model.bf16 PCmer gives (B = 1, T = 512, 384 valid), #2
    at the offline rows and #7 at the training rows, the trio (#4) at a
    512-frame segment's three narrow fp32 stages (and C = 64 on bf16 x and
    har), #5 at C = 64, #10's three chains and #11's three stages. The
    bounds count the products at the bf16 tensor-core rate; the conv core's
    library time is the bf16 cuDNN chain (the stage's: the fp32 cuDNN
    ConvTranspose, then that chain). Returns {name: row}."""
    dev, bf16 = "cuda", torch.bfloat16
    rows = {}

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + shift

    def build_info(info):
        return (f"{info['registers']} registers, {info['spill_bytes']} bytes "
                f"spilled, {info['smem_bytes']} bytes of shared memory")

    def report(name, label, res, bnd, lms, extra=""):
        e, ms, pms, dms, rel, e64, p64 = res
        f64 = ("not held (a bf16 output)" if e64 is None else
               f"{e64:.3e} x max|ref|, the plain form {p64:.3e}")
        say(f"kernel {label}{extra}: max|err| {e:.3e}, rel RMS {rel:.3e} "
            f"against the plain form; against float64 {f64}; {ms:.4f} ms, "
            f"device_ms {dms:.4f}, "
            f"plain {pms:.4f} ms, library "
            + ("none" if lms is None else f"{lms:.4f} ms")
            + f", bound {bnd[0]:.4f} ms ({bnd[1]})")

    # 1. one PCmer layer's attention at a 512-frame bucket holding a
    # 384-frame segment, bf16 q, k, v; then the split at the same shapes
    b, h, t, d, m, valid = 1, 8, 512, 64, 266, 384
    from ddsp_svc_tpu_torch.nn.pcmer import gaussian_orthogonal_random_matrix
    proj = torch.from_numpy(gaussian_orthogonal_random_matrix(m, d, 0)).to(dev)
    inputs = [(randn(b, h, t, d).to(bf16), randn(b, h, t, d).to(bf16),
               randn(b, h, t, d).to(bf16), proj, valid) for _ in range(3)]
    plain = functools.partial(K.performer_attention_plain, mxu_bf16=True)
    res = mxu_compare(torch, "performer_attention_mxu_bf16",
                      K.performer_attention_mxu_bf16, plain, inputs,
                      select=lambda y: y[:, :, :valid])
    flops = b * h * (2 * m * d * (2 * t + 2 * valid) + 4 * m * t)
    bnd = bound(2 * b * h * d * (t + 2 * valid) + 4 * (b * h * t * d + m * d),
                flops, PEAK_BF16_FLOPS)
    info = K.attention_kernel_info(t, mxu_bf16=True, in_bf16=True)
    report("performer_attention_mxu_bf16", "performer_attention_mxu_bf16",
           res, bnd, None, f" T={t} valid {valid}, bf16 q, k, v (clusters of "
           f"{info['cluster']} CTAs; {build_info(info)}; the products on the "
           "CUDA cores, exact on bf16 operands)")
    rows["performer_attention_mxu_bf16"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/performer_attention.cu",
        replaces=f"{TPU_KERNELS}:516", max_abs_err=res[0], ms=res[1],
        plain_ms=res[2], device_ms=res[3], bound=bnd, library_ms=None,
        tol="2^-8 x max|ref| and rel RMS 1e-3 against the plain form (the "
            "same bf16 roundings) and against float64; B = 1, T = 512, 384 "
            "valid, bf16 q, k, v")
    ranges = [(k_, v_, proj_, lo, hi) for (_, k_, v_, proj_, _), (lo, hi) in
              zip(inputs, ((0, valid), (96, 352), (0, valid)))]
    res_m = mxu_compare(
        torch, "performer_attention_moments_mxu_bf16",
        K.performer_attention_moments_mxu_bf16,
        functools.partial(K.performer_attention_moments_plain, mxu_bf16=True),
        ranges)
    applies = [(q_, proj_, *K.performer_attention_moments_mxu_bf16(*r_))
               for (q_, _, _, proj_, _), r_ in zip(inputs, ranges)]
    res_a = mxu_compare(
        torch, "performer_attention_apply_mxu_bf16",
        K.performer_attention_apply_mxu_bf16,
        functools.partial(K.performer_attention_apply_plain, mxu_bf16=True),
        applies)
    for q_, k_, v_, proj_, valid_ in inputs:
        ref = K.performer_attention_mxu_bf16(q_, k_, v_, proj_, valid_)
        got = K.performer_attention_apply_mxu_bf16(
            q_, proj_, *K.performer_attention_moments_mxu_bf16(
                k_, v_, proj_, 0, valid_))
        diff = (got - ref)[:, :, :valid_].abs().max().item()
        if not diff <= 1e-5 * ref[:, :, :valid_].abs().max().item():
            fail(f"performer_attention moments + apply (bf16 operands): "
                 f"max|err| {diff:.3e} against the single launch")
    m_flops = b * h * (4 * m * d * valid + 2 * m * valid)
    a_flops = b * h * (4 * m * d * t + 4 * m * t)
    for name, r_, bnd_ in (
            ("performer_attention_moments_mxu_bf16", res_m,
             bound(2 * b * h * 2 * valid * d + 4 * (b * h * (m * d + m)
                                                    + m * d), m_flops,
                   PEAK_BF16_FLOPS)),
            ("performer_attention_apply_mxu_bf16", res_a,
             bound(2 * b * h * t * d + 4 * (b * h * (t * d + m * d + m)
                                            + m * d), a_flops,
                   PEAK_BF16_FLOPS))):
        report(name, name, r_, bnd_, None, f" T={t}")
        rows[name] = dict(
            route="cuda",
            source="ddsp_svc_tpu_torch/csrc/performer_attention.cu",
            replaces=f"{TPU_KERNELS}:516", max_abs_err=r_[0], ms=r_[1],
            plain_ms=r_[2], device_ms=r_[3], bound=bnd_, library_ms=None,
            tol="2^-8 x max|ref| and rel RMS 1e-3 of each output against the"
                " plain form; bf16 k, v (key ranges [0, 384), [96, 352)) and "
                "q; the split within 1e-5 x max|ref| of the single launch")

    # 2. the spectral chain at the offline rows (513 x 1024) and 7. its
    # adjoint at the training rows (24 x 173 x 1024); the transforms stay
    # fp32, so each holds the fp32 forms' 2e-5 x max|ref|
    r, n = 513, 1024
    bins = n // 2 + 1
    win = K.combsub_window(n, dev)
    inputs = [(randn(r, n) * win, randn(r, n) * win,
               randn(r, bins, scale=0.3), randn(r, bins),
               randn(r, bins, scale=0.3, shift=-3.0), n) for _ in range(3)]
    err, ms, pms, dms = compare(
        torch, "combsub_spectral_mxu_bf16", K.combsub_spectral_mxu_bf16,
        functools.partial(K.combsub_spectral_plain, mxu_bf16=True), inputs,
        0.0, 2e-5)
    bnd = bound(4 * (r * (3 * n + 3 * bins) + n),
                r * (2 * 5 * n * math.log2(n) + 30 * bins))
    say(f"kernel combsub_spectral_mxu_bf16 {r} x {n}: max|err| {err:.3e} "
        f"(2e-5 x max|ref|), {ms:.4f} ms, device_ms {dms:.4f}, plain "
        f"{pms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
    rows["combsub_spectral_mxu_bf16"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/combsub_spectral.cu",
        replaces=f"{TPU_KERNELS}:703", max_abs_err=err, ms=ms, plain_ms=pms,
        device_ms=dms, bound=bnd, library_ms=None,
        tol="2e-5 x max|ref| against the plain form (the frames rounded to "
            "bf16 on both; the transforms fp32)")
    r = 24 * 173
    inputs = [(randn(r, n, scale=1e-3), randn(r, n) * win, randn(r, n) * win,
               randn(r, bins, scale=0.3), randn(r, bins),
               randn(r, bins, scale=0.3, shift=-3.0), n) for _ in range(2)]
    err, ms, pms, dms = compare(
        torch, "combsub_spectral_bwd_mxu_bf16",
        K.combsub_spectral_bwd_mxu_bf16,
        functools.partial(K.combsub_spectral_bwd_plain, mxu_bf16=True),
        inputs, 0.0, 2e-5)
    bnd = bound(4 * (r * (5 * n + 6 * bins) + n),
                r * (5 * 2.5 * n * math.log2(n) + 40 * bins))
    say(f"kernel combsub_spectral_bwd_mxu_bf16 {r} x {n}: max|err| {err:.3e}"
        f" (2e-5 x max|ref| per gradient), {ms:.4f} ms, device_ms {dms:.4f},"
        f" plain {pms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
    rows["combsub_spectral_bwd_mxu_bf16"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/combsub_spectral_bwd.cu",
        replaces=f"{TPU_KERNELS}:781", max_abs_err=err, ms=ms, plain_ms=pms,
        device_ms=dms, bound=bnd, library_ms=None,
        tol="2e-5 x max|ref| per gradient against the plain form (g * window"
            " and the frames rounded to bf16 on both)")

    # 4, 5. the trio at a 512-frame segment's narrow stages
    t_final = 512 * H_NSF["hop_size"]

    def trio_inputs(c, s, inject=True, x_dtype=torch.float32,
                    har_dtype=torch.float32):
        t_s = t_final // s
        ws = [randn(3, 2, c, c, k, scale=(2.0 / (k * c)) ** 0.5)
              for k in TRIO_K]
        bs = [randn(3, 2, c, scale=0.01) for _ in range(3)]
        ksrc = 2 * s if s > 1 else 1
        har = (randn(1, t_final, 1, scale=0.1).to(har_dtype) if inject
               else None)
        return (randn(1, t_s, c).to(x_dtype), har,
                randn(c, 1, ksrc, scale=0.2), randn(c, scale=0.05), ws, bs,
                s, (1, 3, 5), None)

    def trio_work(c, s, inject=True):
        t_s, ksrc = t_final // s, (2 * s if s > 1 else 1)
        flops = 2 * c * c * 6 * 21 * t_s
        nbytes = 4 * (2 * c * t_s + 6 * c * c * 21 + 18 * c)
        if inject:
            flops += 2 * c * ksrc * t_s
            nbytes += 4 * (t_final + c * ksrc + c)
        return nbytes, flops

    def library(x, har, ncw, ncb, ws, bs, s, dils, valid):
        return cudnn_bf16_trio(torch, K, x, har, ncw, ncb, ws, bs, s, dils)

    plain_trio = functools.partial(K.resblocks_inject_plain, mxu_bf16=True)
    for name, cases in (
            ("fused_resblocks_inject_mxu_bf16",
             [(c, s, True, torch.float32, torch.float32)
              for c, s in TRIO_STAGES] + [(64, 4, True, bf16, bf16)]),
            ("fused_resblocks_mxu_bf16",
             [(64, 4, False, torch.float32, torch.float32)])):
        err = ms_sum = pms_sum = dms_sum = lms_sum = n_b = n_f = 0.0
        for c, s, inject, x_dt, har_dt in cases:
            inputs = [trio_inputs(c, s, inject, x_dt, har_dt)
                      for _ in range(2)]
            kern = (K.fused_resblocks_inject_mxu_bf16 if inject else
                    (lambda x, har, ncw, ncb, ws, bs, s, dils, valid:
                     K.fused_resblocks_mxu_bf16(x, ws, bs, dils, valid)))
            label = f"{name} C={c}" + (" x and har bf16" if x_dt is bf16
                                       else "")
            res = mxu_compare(torch, label, kern, plain_trio, inputs,
                              MXU_CONV_REL_RMS)
            lms = time_ms(torch, library, inputs)
            info = K.trio_kernel_info(c, bf16=x_dt is bf16,
                                      har_bf16=har_dt is bf16, mxu_bf16=True)
            b_n, f_n = trio_work(c, s, inject)
            report(name, label, res, bound(b_n, f_n, PEAK_BF16_FLOPS), lms,
                   f" T={t_final // s} ({MXU_ROUTE}; {build_info(info)}; "
                   "library the bf16 cuDNN chain)")
            err = max(err, res[0])
            if x_dt is torch.float32:
                ms_sum, pms_sum, dms_sum = (ms_sum + res[1], pms_sum + res[2],
                                            dms_sum + res[3])
                lms_sum += lms
                n_b, n_f = n_b + b_n, n_f + f_n
        rows[name] = dict(
            route="cuda", source="ddsp_svc_tpu_torch/csrc/resblocks.cu",
            replaces=f"{TPU_KERNELS}:" + ("1373" if "inject" in name
                                         else "1315"),
            max_abs_err=err, ms=ms_sum, plain_ms=pms_sum, device_ms=dms_sum,
            bound=bound(n_b, n_f, PEAK_BF16_FLOPS), library_ms=lms_sum,
            tol="2^-8 x max|ref| (2^-7 on bf16 x) and rel RMS 2e-3 against "
                "the plain form and (fp32 x) float64; "
                + ("times are the sum of the three narrow fp32 stages (C = 64,"
                   " 32, 16)" if "inject" in name else "the C = 64 stage "
                   "without the injection") + "; library: the bf16 cuDNN "
                "conv chain")

    # 10. the three chains at the C = 64 stage
    c, t_s = 64, t_final // 4
    err = ms_sum = pms_sum = dms_sum = lms_sum = n_b = n_f = 0.0
    for k in TRIO_K:
        inputs = [(randn(1, t_s, c), randn(3, 2, c, c, k,
                                           scale=(2.0 / (k * c)) ** 0.5),
                   randn(3, 2, c, scale=0.01), k) for _ in range(2)]
        res = mxu_compare(
            torch, f"fused_resblock_chain_mxu_bf16 k={k}",
            K.fused_resblock_chain_mxu_bf16,
            functools.partial(K.resblock_chain_plain, mxu_bf16=True), inputs,
            MXU_CONV_REL_RMS)
        lms = time_ms(torch, lambda x, w, b_, k_: K.resblock1_cf(
            x.transpose(1, 2).to(bf16), w.to(bf16), b_.to(bf16), k_,
            (1, 3, 5)), inputs)
        f_k = 2 * c * c * 6 * k * t_s
        b_k = 4 * (2 * c * t_s + 6 * c * c * k + 6 * c)
        report("fused_resblock_chain_mxu_bf16",
               f"fused_resblock_chain_mxu_bf16 k={k}", res,
               bound(b_k, f_k, PEAK_BF16_FLOPS), lms,
               f" C={c} T={t_s} ({MXU_ROUTE}; "
               f"{build_info(K.chain_kernel_info(c, k, mxu_bf16=True))})")
        err = max(err, res[0])
        ms_sum, pms_sum, dms_sum = (ms_sum + res[1], pms_sum + res[2],
                                    dms_sum + res[3])
        lms_sum += lms
        n_b, n_f = n_b + b_k, n_f + f_k
    rows["fused_resblock_chain_mxu_bf16"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/resblock_chain.cu",
        replaces=f"{TPU_KERNELS}:1415", max_abs_err=err, ms=ms_sum,
        plain_ms=pms_sum, device_ms=dms_sum,
        bound=bound(n_b, n_f, PEAK_BF16_FLOPS), library_ms=lms_sum,
        tol="2^-8 x max|ref| and rel RMS 2e-3 against the plain form and "
            "float64; times are the sum of k = 3,"
            " 7, 11 at C = 64, T = 65536 (on no path); library: the bf16 "
            "cuDNN chain")

    # 11. the fused stage at the three narrow stages (u = 2)
    def stage_inputs(c, s):
        t_out = t_final // s
        ws = [randn(3, 2, c, c, k, scale=(2.0 / (k * c)) ** 0.5)
              for k in TRIO_K]
        bs = [randn(3, 2, c, scale=0.01) for _ in range(3)]
        ksrc = 2 * s if s > 1 else 1
        return (randn(1, t_out // 2, 2 * c), randn(1, t_final, 1, scale=0.1),
                randn(2 * c, c, 4, scale=(1.0 / (2 * c * 4)) ** 0.5),
                randn(c, scale=0.05), randn(c, 1, ksrc, scale=0.2),
                randn(c, scale=0.05), ws, bs, 2, s)

    def library_stage(x_pre, har, uw, ub, nw, nb, ws, bs, u, s):
        x_up = torch.nn.functional.conv_transpose1d(
            torch.nn.functional.leaky_relu(x_pre.transpose(1, 2), 0.1), uw, ub,
            stride=u, padding=u // 2).transpose(1, 2)
        return cudnn_bf16_trio(torch, K, x_up, har, nw, nb, ws, bs, s,
                               (1, 3, 5))

    err = ms_sum = pms_sum = dms_sum = lms_sum = n_b = n_f = 0.0
    for c, s in TRIO_STAGES:
        inputs = [stage_inputs(c, s) for _ in range(2)]
        res = mxu_compare(torch, f"fused_stage_mxu_bf16 C={c}",
                          K.fused_stage_mxu_bf16,
                          functools.partial(K.stage_plain, mxu_bf16=True),
                          inputs, MXU_CONV_REL_RMS)
        lms = time_ms(torch, library_stage, inputs)
        t_out, ksrc = t_final // s, (2 * s if s > 1 else 1)
        f_c = (2 * c * c * 6 * 21 * t_out + 2 * 2 * c * c * 2 * t_out
               + 2 * c * ksrc * t_out)
        b_c = 4 * (2 * c * t_out // 2 + t_final + c * t_out
                   + 6 * c * c * 21 + 8 * c * c + 20 * c + c * ksrc)
        report("fused_stage_mxu_bf16", f"fused_stage_mxu_bf16 C={c}", res,
               bound(b_c, f_c, PEAK_BF16_FLOPS), lms,
               f" T_out={t_out} ({MXU_ROUTE}, the transposed conv in 3xTF32; "
               f"{build_info(K.stage_kernel_info(c, mxu_bf16=True))}; library"
               " the cuDNN ConvTranspose, then the bf16 cuDNN chain)")
        err = max(err, res[0])
        ms_sum, pms_sum, dms_sum = (ms_sum + res[1], pms_sum + res[2],
                                    dms_sum + res[3])
        lms_sum += lms
        n_b, n_f = n_b + b_c, n_f + f_c
    rows["fused_stage_mxu_bf16"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/fused_stage.cu",
        replaces=f"{TPU_KERNELS}:1694", max_abs_err=err, ms=ms_sum,
        plain_ms=pms_sum, device_ms=dms_sum,
        bound=bound(n_b, n_f, PEAK_BF16_FLOPS), library_ms=lms_sum,
        tol="2^-8 x max|ref| and rel RMS 2e-3 against the plain form and "
            "float64; times are the sum of the "
            "three narrow stages (C = 64, 32, 16); library: the cuDNN "
            "ConvTranspose, then the bf16 cuDNN chain")
    return rows


def bf16_forms_phase(torch, K, gen) -> dict:
    """The bf16-input forms against their plain versions on the same bf16
    inputs, at the main path's shapes: the trio with the injection (#4) at
    a 512-frame segment's narrow stages (x bf16, har fp32 as the staged
    Generator gives it; bf16 har at C = 64 as the full-bf16 one does), the
    trio alone (#5) at C = 64, and #6 at the 16 RSS sizes and the staged
    mel's 430 x 2048. The trio's bound counts bf16 bytes for x and out; its
    library time is the bf16 cuDNN conv chain the Generator ran there
    before; #6's is cuFFT on the upcast frames. Returns {name: row}."""
    from ddsp_svc_tpu_torch.models.losses import default_buckets

    dev, bf16 = "cuda", torch.bfloat16
    rows = {}

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def build_info(info):
        return (f"{info['registers']} registers, {info['spill_bytes']} bytes "
                f"spilled, {info['smem_bytes']} bytes of shared memory")

    def cudnn_bf16(*args):
        return cudnn_bf16_trio(torch, K, *args)

    t_final = 512 * H_NSF["hop_size"]

    def trio_inputs(c, s, inject=True, har_dtype=torch.float32):
        t_s = t_final // s
        ws = [randn(3, 2, c, c, k, scale=(2.0 / (k * c)) ** 0.5)
              for k in TRIO_K]
        bs = [randn(3, 2, c, scale=0.01) for _ in range(3)]
        ksrc = 2 * s if s > 1 else 1
        har = (randn(1, t_final, 1, scale=0.1).to(har_dtype) if inject
               else None)
        return (randn(1, t_s, c).to(bf16), har, randn(c, 1, ksrc, scale=0.2),
                randn(c, scale=0.05), ws, bs, s, (1, 3, 5), None)

    def trio_bytes_flops(c, s, inject, har_bytes=4):
        t_s = t_final // s
        ksrc = 2 * s if s > 1 else 1
        flops = 2 * c * c * 6 * (3 + 7 + 11) * t_s
        n_b = 2 * 2 * c * t_s + 4 * (6 * c * c * 21 + 18 * c)
        if inject:
            flops += 2 * c * ksrc * t_s
            n_b += har_bytes * t_final
        return n_b, flops

    atol, rtol = BF16_ULP
    tol = (f"one bf16 ulp (atol {atol:g} + rtol 2^-7) against the plain "
           "version on the same bf16 inputs")
    for name, cases in (
            ("fused_resblocks_inject_bf16",
             [(c, s, True, torch.float32) for c, s in TRIO_STAGES]
             + [(64, 4, True, bf16)]),
            ("fused_resblocks_bf16", [(64, 4, False, torch.float32)])):
        err = ms_sum = pms_sum = dms_sum = lms_sum = n_bytes = flops = 0.0
        timed = [cs for cs in cases if cs[3] is torch.float32]
        for c, s, inject, har_dtype in cases:
            inputs = [trio_inputs(c, s, inject, har_dtype) for _ in range(2)]
            kern = (K.fused_resblocks_inject_bf16 if inject else
                    (lambda x, har, ncw, ncb, ws, bs, s, dils, valid:
                     K.fused_resblocks_bf16(x, ws, bs, dils, valid)))
            label = f"{name} C={c}" + (" har bf16" if har_dtype is bf16
                                       else "")
            e, ms, pms, dms = compare(
                torch, label, kern, K.resblocks_inject_plain, inputs, atol,
                0.0, tol_rtol=rtol, select=lambda y: y.float())
            lms = time_ms(torch, cudnn_bf16, inputs)
            info = K.trio_kernel_info(c, bf16=True,
                                      har_bf16=har_dtype is bf16)
            b_n, f_n = trio_bytes_flops(c, s, inject,
                                        2 if har_dtype is bf16 else 4)
            say(f"kernel {label} T={t_final // s} ({TRIO_ROUTE}; "
                f"{build_info(info)}): max|err| {e:.3e} ({tol}), {ms:.3f} "
                f"ms, device_ms {dms:.3f}, plain (fp32 cuDNN chain on the "
                f"upcast) {pms:.3f} ms, library (bf16 cuDNN chain) {lms:.3f} "
                f"ms, bound {bound_3xtf32(b_n, f_n)[0]:.4f} ms in 3xTF32")
            err = max(err, e)
            if (c, s, inject, har_dtype) in timed:
                ms_sum += ms
                pms_sum += pms
                dms_sum += dms
                lms_sum += lms
                n_bytes += b_n
                flops += f_n
        rows[name] = dict(
            route="cuda", source="ddsp_svc_tpu_torch/csrc/resblocks.cu",
            replaces=f"{TPU_KERNELS}:" + ("1373" if "inject" in name
                                         else "1315"),
            max_abs_err=err, ms=ms_sum, plain_ms=pms_sum, device_ms=dms_sum,
            bound=bound_3xtf32(n_bytes, flops), library_ms=lms_sum,
            tol=tol + ("; times are the sum of the three narrow stages (C = "
                       "64, 32, 16), har fp32" if "inject" in name else
                       "; the C = 64 stage without the injection")
            + "; library: the bf16 cuDNN conv chain")

    # 6. the bf16-input form at the 16 RSS sizes (a training batch's rows)
    # and at the staged mel's 430 x 2048
    err = ms_sum = pms_sum = dms_sum = lms_sum = flops = n_bytes = 0.0

    def library_mag(x, n):
        return torch.abs(torch.fft.rfft(x.float(), n))

    n, hop = H_NSF["n_fft"], H_NSF["hop_size"]
    pad = (n - hop) // 2 + max((n - hop + 1) // 2, hop)
    mel_rows = (int(5.0 * H_NSF["sampling_rate"]) + pad - n) // hop + 1
    sizes = [(m, 24 * ((TRAIN_CROP_SAMPLES - m) // m + 1))
             for m in default_buckets(256, 2048)] + [(n, mel_rows)]
    for i, (m, rows_m) in enumerate(sizes):
        win = torch.hann_window(m, periodic=True, device=dev)
        inputs = [((randn(rows_m, m, scale=0.1) * win).to(bf16), m)
                  for _ in range(2)]
        e, ms, pms, dms = compare(torch, f"dft_magnitude_bf16 n={m}",
                                  K.dft_magnitude_bf16, K.dft_magnitude_plain,
                                  inputs, 2e-3, 0.0)
        lms = time_ms(torch, library_mag, inputs)
        bins = m // 2 + 1
        f_m = rows_m * (2.5 * m * math.log2(m) + 4 * bins)
        b_m = rows_m * (2 * m + 4 * bins)
        mel = i == len(sizes) - 1
        say(f"kernel dft_magnitude_bf16 n={m} rows={rows_m}"
            + (" (the staged mel)" if mel else "")
            + f": max|err| {e:.3e} (atol 2e-3), {ms:.4f} ms, device_ms "
            f"{dms:.4f}, plain {pms:.4f} ms, library (cuFFT on the upcast) "
            f"{lms:.4f} ms, bound {bound(b_m, f_m)[0]:.4f} ms")
        err = max(err, e)
        if not mel:
            ms_sum, pms_sum, dms_sum, lms_sum = (ms_sum + ms, pms_sum + pms,
                                                 dms_sum + dms, lms_sum + lms)
            flops += f_m
            n_bytes += b_m
    rows["dft_magnitude_bf16"] = dict(
        route="cuda", source="ddsp_svc_tpu_torch/csrc/dft_magnitude.cu",
        replaces=f"{TPU_KERNELS}:241", max_abs_err=err, ms=ms_sum,
        plain_ms=pms_sum, device_ms=dms_sum, bound=bound(n_bytes, flops),
        library_ms=lms_sum,
        tol="atol 2e-3 (the JAX package's kernel test) against the plain "
            "version on the same bf16 frames, also at the staged mel's shape;"
            " times are the sum of one call at each of the 16 bucket sizes; "
            "library: cuFFT on the upcast frames")
    return rows


def keyshift_units_phase(torch, card: str) -> None:
    """The keyshift/speed mel at H_NSF's geometry and HubertDiscrete
    (HuBERT's layer 7 from a seed, 100 centres drawn near its features) on
    the card, each against its own run on the CPU: the mel of 1 s of noise
    (0.2 RMS, as tests/test_torch_ops.py's) within atol 2e-4 (the fp32
    mel's bound); on 2 s of a sung wav, whose quiet bands a log magnifies,
    the card and the CPU each against the mel in float64 (the card at most
    twice the CPU's error + 2e-4); the ids equal wherever the CPU's nearest
    centre beats the second by more than 1e-5 relative."""
    from ddsp_svc_tpu_torch.nn.hubert import (HubertDiscrete, HubertSoft,
                                              init_hubert_)
    from ddsp_svc_tpu_torch.ops.spectral import log_mel_spectrogram

    sr = H_NSF["sampling_rate"]
    noise = torch.from_numpy((np.random.default_rng(7).standard_normal(
        (1, sr)) * 0.2).astype(np.float32))
    sung = torch.from_numpy(sung_wav(sr, seed=4, phrases=(2.0,)))[None]
    geo = tuple(H_NSF[k] for k in ("sampling_rate", "n_fft", "hop_size",
                                   "win_size", "num_mels", "fmin", "fmax"))
    for keyshift, speed in ((2, 1.0), (-3, 1.0), (0, 1.25)):
        def mel(x):
            return log_mel_spectrogram(x, *geo, keyshift=keyshift,
                                       speed=speed)

        err = (mel(noise.cuda()).cpu() - mel(noise)).abs().max().item()
        t0 = time.perf_counter()
        got = mel(sung.cuda())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ref = mel(sung.double())
        e_card = (got.cpu().double() - ref).abs().max().item()
        e_cpu = (mel(sung).double() - ref).abs().max().item()
        say(f"keyshift mel keyshift={keyshift} speed={speed}: on noise the "
            f"card vs the CPU max|err| {err:.3e} (atol 2e-4); on the sung "
            f"wav {tuple(got.shape)}, against float64 the card {e_card:.3e}, "
            f"the CPU {e_cpu:.3e} (card <= 2 x CPU + 2e-4), {ms:.1f} ms")
        if not (err <= 2e-4 and e_card <= 2 * e_cpu + 2e-4):
            fail(f"the keyshift mel ({keyshift}, {speed}) disagrees")
    model = init_hubert_(HubertSoft(output_layer=7, proj_dim=None),
                         torch.Generator().manual_seed(3))
    wav = sung_wav(16000, seed=5, phrases=(4.0,))[None]
    with torch.no_grad():
        feats = model(torch.from_numpy(wav))[0]
    centers = feats[::2][:100] + 0.3 * torch.randn(
        (100, 768), generator=torch.Generator().manual_seed(4))
    cpu = HubertDiscrete(model, centers.numpy(), device="cpu").units(wav)[0]
    card_units = HubertDiscrete(model, centers.numpy(), device="cuda")
    t0 = time.perf_counter()
    ids = card_units.units(wav)[0].cpu()
    ms = (time.perf_counter() - t0) * 1e3
    d = ((feats[:, None] - centers[None]) ** 2).sum(-1).sort(1).values
    clear = (d[:, 1] - d[:, 0]) > 1e-5 * d[:, 0]
    same = bool(torch.equal(ids[clear], cpu[clear]))
    say(f"{card}: HubertDiscrete on the card ({len(ids)} frames of 4 s, 100 "
        f"centres): {ms:.1f} ms; ids equal to the CPU's on the "
        f"{int(clear.sum())} frames with a clear nearest centre: {same} "
        f"({int((ids == cpu).sum())} of {len(ids)} equal in all)")
    if not (same and clear.float().mean() > 0.9):
        fail("HubertDiscrete on the card disagrees with the CPU")


@contextmanager
def plain_kernels(K):
    """Route the port's modules through the plain versions (the reference
    run of the main path on the card)."""
    from ddsp_svc_tpu_torch.models import synths
    from ddsp_svc_tpu_torch.nn import nsf_hifigan, pcmer
    from ddsp_svc_tpu_torch.ops import fft_filter, spectral
    swaps = [(pcmer, "performer_attention", K.performer_attention_plain),
             (pcmer, "performer_attention_moments",
              K.performer_attention_moments_plain),
             (pcmer, "performer_attention_apply",
              K.performer_attention_apply_plain),
             (synths, "combsub_spectral", K.combsub_spectral_plain),
             (synths, "oscillator_bank", K.oscillator_bank_plain),
             (fft_filter, "ltv_fir_convolve", K.ltv_fir_convolve_plain),
             (spectral, "dft_magnitude", K.dft_magnitude_plain),
             (spectral, "dft_magnitude_bf16", K.dft_magnitude_plain),
             (nsf_hifigan, "harmonic_source", K.harmonic_source_plain),
             (nsf_hifigan, "fused_resblocks_inject",
              K.resblocks_inject_plain),
             (nsf_hifigan, "fused_resblocks",
              lambda x, ws, bs, dils, valid=None, mxu_bf16=False:
              K.resblocks_inject_plain(x, None, None, None, ws, bs, 1, dils,
                                       valid, mxu_bf16)),
             (nsf_hifigan, "fused_stage", K.stage_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def bf16_path_launches(K, label: str, expect) -> dict:
    """path_launches of a model.bf16 run: each kernel of `expect` counted
    on its bf16-operand form (bf16_names), and no fp32 form of those
    launched."""
    launches = path_launches(K, label, bf16_names(expect))
    for name in MXU_FORMS:
        if launches[name]:
            fail(f"{label} launched {name}'s fp32 form, not its "
                 "bf16-operand form")
    return launches


def path_launches(K, label: str, expect) -> dict:
    """Read the launch counts of the run just made and fail if a kernel that
    this path runs was launched no time."""
    launches = K.launch_counts()
    say(f"{label} launches: {json.dumps(launches)}")
    for name in expect:
        if launches[name] <= 0:
            fail(f"{name} was not launched on the {label}")
    return launches


def offline_inputs(n_unit: int, bs: int):
    """The offline path's inputs from seed 0: three segments of
    SEGMENT_FRAMES frames 20 frames apart (their starts and units), the
    whole f0 and volume, and each segment's noise and SineGen rotations."""
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
    return starts, segments, f0, volume, noises, rand_inis


# the slice's path: the enhancer's forms under fused_mxu_bf16 and the
# conv-core form each runs (besides #3)
MXU_ENHANCER_FORMS = (("default", {}, "fused_resblocks_inject_mxu_bf16"),
                      ("fused_inject=False", {"fused_inject": False},
                       "fused_resblocks_mxu_bf16"),
                      ("fused_stage=True", {"fused_stage": True},
                       "fused_stage_mxu_bf16"))


def mxu_path_phase(torch, K, card: str) -> dict:
    """The slice's main path, on the bf16-operand forms: configs/combsub.yaml
    (CombSubFast at its published widths, n_spk 100) with model.bf16 and the
    NSF-HiFiGAN at H_NSF with generator_overrides {"fused_mxu_bf16": True},
    weights from seeds 0/1, converting the offline path's three segments
    through convert_features once per enhancer form (default,
    fused_inject=False, fused_stage=True): each run's counts from 0, #1's
    and #2's forms and that form's conv-core form launched, #3 too, and no
    fp32 form of #1, #2, #4, #5 or #11; the audio finite and of its length,
    against the same run on the plain forms (rel RMS 5e-2, the JAX
    package's bf16 bound: both round the same operands, and fp32 sum-order
    differences flip bf16 roundings through the PCmer) and beside the fp32
    model with the fp32 enhancer. Returns the runs' launches, summed."""
    from ddsp_svc_tpu_torch.infer.enhancer import Enhancer
    from ddsp_svc_tpu_torch.infer.offline import convert_features
    from ddsp_svc_tpu_torch.models.factory import build_model
    from ddsp_svc_tpu_torch.utils.config import DotDict, load_config

    args = load_config(os.path.join(ROOT, "configs", "combsub.yaml"))
    args16 = DotDict(json.loads(json.dumps(args)))
    args16["model"]["bf16"] = True
    model16 = build_model(args16, device="cuda", seed=0)
    bs, sr = args.data.block_size, args.data.sampling_rate
    starts, segments, f0, volume, noises, rand_inis = offline_inputs(
        args.data.encoder_out_channels, bs)

    def run(model, enhancer):
        out, sr_o = convert_features(
            model, segments, f0, volume, spk_id=1, enhancer=enhancer,
            noise_hook=lambda i, shape: noises[i],
            enhancer_rand_hook=lambda i: rand_inis[i])
        torch.cuda.synchronize()
        return out, sr_o

    def rel_rms(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))

    ref32, _ = run(build_model(args, device="cuda", seed=0),
                   Enhancer("nsf-hifigan", None, h=H_NSF, seed=1,
                            device="cuda"))
    total = {}
    for label, forms, conv_form in MXU_ENHANCER_FORMS:
        enhancer = Enhancer("nsf-hifigan", None, h=H_NSF, seed=1,
                            device="cuda", generator_overrides=dict(
                                forms, fused_mxu_bf16=True))
        run(model16, enhancer)  # warm-up
        path = f"slice path (model.bf16, fused_mxu_bf16, {label})"
        K.reset_launch_counts()
        t0 = time.perf_counter()
        audio, sr_o = run(model16, enhancer)
        wall = time.perf_counter() - t0
        counts = bf16_path_launches(
            K, path, ("performer_attention", "combsub_spectral",
                      "harmonic_source", conv_form))
        for name in ("fused_resblocks_inject", "fused_resblocks",
                     "fused_stage"):
            if counts[name]:
                fail(f"{path} launched {name}'s fp32 form")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        length = round(starts[-1] * bs * sr_o / sr) + SEGMENT_FRAMES[-1] * bs
        if audio.shape != (length,) or not np.isfinite(audio).all():
            fail(f"{path} audio: shape {audio.shape} (expected ({length},)) "
                 "or non-finite")
        with plain_kernels(K):
            ref, _ = run(model16, enhancer)
        to_plain, to_fp32 = rel_rms(audio, ref), rel_rms(audio, ref32)
        seg_s = sum(SEGMENT_FRAMES) * bs / sr
        say(f"{card}: {path}: {audio.shape[0]} samples at {sr_o} Hz; against"
            f" the plain forms rel RMS {to_plain:.3e} (tolerance 5e-2), "
            f"against the fp32 model and enhancer {to_fp32:.3e}; B=1 "
            f"{wall * 1e3:.1f} ms for {seg_s:.3f} audio-s "
            f"({seg_s / wall:.1f} audio-s/s)")
        if not to_plain <= 5e-2:
            fail(f"{path} disagrees with the plain forms")
    return total


def main_path_phase(torch, K, synth: str, config: str, expect,
                    batched: bool, segments_out=None):
    """The offline path of one synthesizer; returns its run's launch
    counts. segments_out: a list that receives each segment's enhancer
    input of the first run (audio, rate, f0, hop, rand_ini)."""
    from ddsp_svc_tpu_torch.infer.enhancer import Enhancer
    from ddsp_svc_tpu_torch.infer.offline import convert_features
    from ddsp_svc_tpu_torch.models.factory import build_model
    from ddsp_svc_tpu_torch.utils.config import load_config

    args = load_config(os.path.join(ROOT, "configs", config))
    model = build_model(args, device="cuda", seed=0)
    enhancer = Enhancer("nsf-hifigan", None, h=H_NSF, seed=1, device="cuda")
    bs, sr = args.data.block_size, args.data.sampling_rate
    n_unit = args.data.encoder_out_channels
    label = f"offline path ({synth})"
    say(f"{label}: {synth} {sr} Hz block {bs} n_unit {n_unit} "
        f"n_spk {args.model.n_spk} fp32, NSF-HiFiGAN initial channel "
        f"{H_NSF['upsample_initial_channel']}, {len(H_NSF['upsample_rates'])}"
        f" stages, {H_NSF['num_mels']} mels; weights from seeds 0/1")

    starts, segments, f0, volume, noises, rand_inis = offline_inputs(n_unit,
                                                                     bs)

    def run():
        out, sr_o = convert_features(
            model, segments, f0, volume, spk_id=1, enhancer=enhancer,
            noise_hook=lambda i, shape: noises[i],
            enhancer_rand_hook=lambda i: rand_inis[i])
        torch.cuda.synchronize()
        return out, sr_o

    if segments_out is not None:
        enhance = enhancer.enhance

        def recording(audio, sr_in, f0_seg, hop, **kw):
            segments_out.append((audio.clone(), sr_in, f0_seg, hop,
                                 kw["rand_ini"]))
            return enhance(audio, sr_in, f0_seg, hop, **kw)

        enhancer.enhance = recording
    K.reset_launch_counts()
    t0 = time.perf_counter()
    audio, sr_o = run()
    first_s = time.perf_counter() - t0
    if segments_out is not None:
        enhancer.enhance = enhance
    launches = path_launches(K, label, tuple(expect) + ENHANCER_KERNELS)
    rms = float(np.sqrt(np.mean(audio ** 2)))
    length = round(starts[-1] * bs * sr_o / sr) + SEGMENT_FRAMES[-1] * bs
    if audio.shape != (length,) or not np.isfinite(audio).all() or rms <= 0:
        fail(f"{label} audio: shape {audio.shape} (expected ({length},)), "
             f"finite {np.isfinite(audio).all()}, rms {rms}")
    with plain_kernels(K):
        ref, _ = run()
    err = float(np.abs(audio - ref).max())
    scale = float(np.abs(ref).max())
    say(f"{label} audio: {audio.shape[0]} samples at {sr_o} Hz, rms "
        f"{rms:.4f}; kernels vs plain versions on the card: max|err| "
        f"{err:.3e} = {err / scale:.3e} x max|ref| (tolerance 1e-3 x max|ref|)")
    if not err <= 1e-3 * scale:
        fail(f"{label} audio disagrees with the plain versions")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    seg_audio_s = sum(SEGMENT_FRAMES) * bs / sr
    say(f"{label} B=1: {sum(SEGMENT_FRAMES)} frames ({seg_audio_s:.3f} "
        f"audio-s) in {np.median(times) * 1e3:.1f} ms median of 3 "
        f"(first run {first_s * 1e3:.1f} ms): "
        f"{seg_audio_s / np.median(times):.1f} audio-s/s")
    if not batched:
        return launches

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
    say(f"{label} batched forward B={batch} x {n_frames} frames: "
        f"{dt * 1e3:.1f} ms "
        f"median of 3: {batch * n_frames * bs / sr / dt:.1f} audio-s/s")
    return launches


def enhancer_phase(torch, K, segments, card: str) -> dict:
    """The enhancer in each form on the offline path's segments, batched
    enhance and the adaptive key; returns the summed launch counts."""
    from ddsp_svc_tpu_torch.infer.enhancer import Enhancer

    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    seg_audio_s = sum(a.shape[-1] for a, *_ in segments) / H_NSF["sampling_rate"]
    for label, forms, expect in ENHANCER_FORMS:
        enh = Enhancer("nsf-hifigan", None, h=H_NSF, seed=1, device="cuda",
                       generator_overrides=forms)

        def run():
            outs = [enh.enhance(a, sr, f0, hop, rand_ini=ri)[0]
                    for a, sr, f0, hop, ri in segments]
            torch.cuda.synchronize()
            return outs

        K.reset_launch_counts()
        outs = run()
        counts = path_launches(K, f"enhancer ({label})", expect)
        add(counts)
        if forms.get("fused_stage") and (
                counts["fused_stage"] != 3 * len(segments)
                or counts["fused_resblocks_inject"] + counts["fused_resblocks"]):
            fail(f"the {label} form did not run its three narrow stages on "
                 "the fused stage kernel")
        with plain_kernels(K):
            refs = run()
        err = max(((o - r).abs().max() / r.abs().max()).item()
                  for o, r in zip(outs, refs))
        if not (all(torch.isfinite(o).all() for o in outs) and err <= 1e-3):
            fail(f"enhancer ({label}) audio disagrees with the plain versions")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        dt = float(np.median(times))
        say(f"enhancer ({label}) B=1 on {len(segments)} segments "
            f"({seg_audio_s:.3f} audio-s): kernels vs plain versions max|err| "
            f"{err:.3e} x max|ref| (tolerance 1e-3); {dt * 1e3:.1f} ms median "
            f"of 3: {seg_audio_s / dt:.1f} audio-s/s")
        if label == "default":
            fp32_outs = outs

    # the trio's bf16-input form: H_NSF staged at 64 and in full bf16 on the
    # kernels, against the fp32 forward (rel RMS 2e-2, the JAX package's
    # staged bound) and against the same form on the plain versions (rel
    # RMS 2e-3, or where more twice the plain form's own spread: its
    # distance from itself on the audio moved by one fp32 ulp, since a bf16
    # Generator turns any fp32 difference into flipped bf16 roundings
    # downstream), each with its launches a segment; then #3 and #4 swapped
    # apart, to show which kernel the difference comes from
    from ddsp_svc_tpu_torch.infer.enhancer import NsfHifiGAN

    def rel_rms(a, b):
        return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()

    for label, kw, per_seg in ENHANCER_BF16:
        enh = Enhancer("nsf-hifigan", None, h=H_NSF, seed=1, device="cuda")
        enh.enhancer = NsfHifiGAN(None, h=H_NSF, seed=1, device="cuda", **{
            k: getattr(torch, v) if k == "dtype" else v
            for k, v in kw.items()})

        def run():
            outs = [enh.enhance(a, sr, f0, hop, rand_ini=ri)[0]
                    for a, sr, f0, hop, ri in segments]
            torch.cuda.synchronize()
            return outs

        K.reset_launch_counts()
        outs = run()
        counts = path_launches(K, f"enhancer ({label})",
                               [k for k, v in per_seg.items() if v])
        add(counts)
        for name, per in per_seg.items():
            if counts[name] != per * len(segments):
                fail(f"enhancer ({label}) launched {name} {counts[name]} "
                     f"times, expected {per} a segment")
        with plain_kernels(K):
            refs = run()
            moved = [enh.enhance(torch.nextafter(a, a + 1), sr, f0, hop,
                                 rand_ini=ri)[0]
                     for a, sr, f0, hop, ri in segments]
        from ddsp_svc_tpu_torch.nn import nsf_hifigan
        split_runs = {}
        for name, pair in (("#3 plain", (nsf_hifigan, "harmonic_source",
                                         K.harmonic_source_plain)),
                           ("#4 plain", (nsf_hifigan, "fused_resblocks_inject",
                                         K.resblocks_inject_plain))):
            with swapped([pair]):
                split_runs[name] = max(rel_rms(o, r) for o, r in
                                       zip(run(), refs))
        to_fp32 = max(rel_rms(o, r) for o, r in zip(outs, fp32_outs))
        to_plain = max(rel_rms(o, r) for o, r in zip(outs, refs))
        spread = max(rel_rms(m, r) for m, r in zip(moved, refs))
        if not (all(torch.isfinite(o).all() for o in outs)
                and to_fp32 < 2e-2 and to_plain < max(2e-3, 2 * spread)):
            fail(f"enhancer ({label}): rel RMS {to_fp32:.3e} to fp32, "
                 f"{to_plain:.3e} to the plain versions (their own spread "
                 f"{spread:.3e})")
        walls = {}
        for name, ctx in (("kernels", nullcontext()),
                          ("plain", plain_kernels(K))):
            times = []
            with ctx:
                for _ in range(3):
                    t0 = time.perf_counter()
                    run()
                    times.append(time.perf_counter() - t0)
            walls[name] = float(np.median(times))
        say(f"enhancer ({label}) B=1 on {len(segments)} segments "
            f"({seg_audio_s:.3f} audio-s): vs fp32 worst rel RMS "
            f"{to_fp32:.3e} (< 2e-2), vs the same form on the plain versions "
            f"{to_plain:.3e} (< 2e-3, or 2 x the plain form's spread on a "
            f"one-ulp move of the audio, {spread:.3e}); with #3 alone on its "
            f"plain version {split_runs['#3 plain']:.3e}, #4 alone "
            f"{split_runs['#4 plain']:.3e}; {walls['kernels'] * 1e3:.1f} ms median "
            f"of 3 ({seg_audio_s / walls['kernels']:.1f} audio-s/s), plain "
            f"versions {walls['plain'] * 1e3:.1f} ms; {card}")

    # enhance_batch: 16 segments of mixed lengths in one 512-frame bucket at
    # the enhancer's own rate, each against its own enhance call
    rng = np.random.default_rng(4)
    hop, sr = H_NSF["hop_size"], H_NSF["sampling_rate"]
    audios, f0s = [], []
    for n in BATCH_FRAMES:
        tt = np.arange(n * hop) / sr
        f0_hz = 150 + 200 * rng.random()
        audios.append((0.3 * np.sin(2 * np.pi * f0_hz * tt)
                       + 0.02 * rng.standard_normal(n * hop)).astype(np.float32))
        f0s.append(np.full((1, n, 1), f0_hz, np.float32))
    ris = rng.random((len(BATCH_FRAMES), 9)).astype(np.float32)
    ris[:, 0] = 0
    b_audio_s = sum(BATCH_FRAMES) * hop / sr
    for label, forms, expect in ENHANCER_FORMS[:2]:
        enh = Enhancer("nsf-hifigan", None, h=H_NSF, seed=1, device="cuda",
                       generator_overrides=forms)
        raw = []
        forward_batch = enh.enhancer._forward_batch

        def recording(*a):
            raw.append((forward_batch(*a), a[3]))
            return raw[-1][0]

        enh.enhancer._forward_batch = recording
        K.reset_launch_counts()
        outs, _ = enh.enhance_batch(audios, sr, f0s, hop, rand_ini=ris,
                                    pad_to=max(BATCH_FRAMES) * hop)
        torch.cuda.synchronize()
        add(path_launches(K, f"enhance_batch ({label})", expect))
        out, n_mel = raw[0]
        upp = out.shape[-1] // max(BATCH_FRAMES)
        worst = 0.0
        for i, n in enumerate(n_mel.tolist()):
            if out[i, n * upp:].any():
                fail(f"enhance_batch ({label}): item {i}'s tail is not 0")
            single, _ = enh.enhance(torch.as_tensor(audios[i], device="cuda")[None],
                                    sr, f0s[i], hop, rand_ini=ris[i:i + 1])
            if single.shape != outs[i].shape:
                fail(f"enhance_batch ({label}): item {i} has shape "
                     f"{tuple(outs[i].shape)}, its enhance {tuple(single.shape)}")
            worst = max(worst, ((outs[i] - single).abs().max()
                                / single.abs().max()).item())
        if not worst <= 1e-4:
            fail(f"enhance_batch ({label}) disagrees with enhance: {worst:.3e}")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            enh.enhance_batch(audios, sr, f0s, hop, rand_ini=ris,
                              pad_to=max(BATCH_FRAMES) * hop)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        dt = float(np.median(times))
        say(f"enhance_batch ({label}) B={len(BATCH_FRAMES)} x {max(BATCH_FRAMES)}"
            f"-frame bucket ({b_audio_s:.3f} audio-s): each item vs its own "
            f"enhance max|err| {worst:.3e} x max|ref| (tolerance 1e-4), tails "
            f"0; {dt * 1e3:.1f} ms median of 3: {b_audio_s / dt:.1f} audio-s/s")

    # the adaptive key 2: 44100 -> 49500 Hz and back, on the longest segment;
    # the expected length follows the resampler's ceil and the mel's frames
    a, sr_in, f0, hop_in, ri = max(segments, key=lambda seg: seg[0].shape[-1])
    enh = Enhancer("nsf-hifigan", None, h=H_NSF, seed=1, device="cuda")
    out, _ = enh.enhance(a, sr_in, f0, hop_in, adaptive_key=2, rand_ini=ri)
    rate = 100 * round(sr * 2 ** (2 / 12) / 100)
    res = math.ceil(a.shape[-1] * rate / sr_in)
    win = H_NSF["win_size"]
    pads = (win - hop) // 2 + max((win - hop + 1) // 2, hop)
    n_mel = (res + pads - H_NSF["n_fft"]) // hop + 1
    length = math.ceil(n_mel * hop * sr / rate)
    if out.shape != (1, length) or not torch.isfinite(out).all():
        fail(f"enhance(adaptive_key=2): shape {tuple(out.shape)} (expected "
             f"(1, {length})), finite {bool(torch.isfinite(out).all())}")
    say(f"enhance adaptive_key=2 ({sr_in} -> {rate} -> {sr} Hz): "
        f"{a.shape[-1]} samples -> {out.shape[-1]}, finite, rms "
        f"{out.pow(2).mean().sqrt().item():.4f}")
    return total


def write_dataset(root: str, n_spk: int, files_per_spk: int, seconds: float,
                  sr: int, block: int, n_unit: int, seed: int) -> None:
    """A synthetic feature store in the AudioDataset layout: per speaker a
    few voiced clips (harmonic tone with vibrato plus breath noise), random
    units (F, n_unit), f0 and volume per frame, and the speakers' mean
    log-f0 (f0_stats.npy) for the validation's transposition."""
    from ddsp_svc_tpu_torch.data.wavio import write_wav

    rng = np.random.default_rng(seed)
    t = int(seconds * sr)
    n_frames = t // block + 1
    stats = {}
    for spk in range(1, n_spk + 1):
        for sub in ("audio", "units", "f0", "volume"):
            os.makedirs(os.path.join(root, sub, str(spk)), exist_ok=True)
        base = 110.0 * spk
        stats[str(spk)] = float(np.log(base))
        for i in range(files_per_spk):
            tt = np.arange(t) / sr
            f0 = base * (1 + 0.03 * np.sin(2 * np.pi * (4 + i) * tt))
            phase = 2 * np.pi * np.cumsum(f0) / sr
            audio = sum(0.2 / h * np.sin(h * phase) for h in range(1, 6))
            audio = audio + 0.01 * rng.standard_normal(t)
            name = f"s{spk}_{i}"
            write_wav(os.path.join(root, "audio", str(spk), name + ".wav"),
                      audio.astype(np.float32), sr)
            np.save(os.path.join(root, "units", str(spk), name + ".0.npy"),
                    rng.standard_normal((n_frames, n_unit)).astype(np.float32))
            np.save(os.path.join(root, "f0", str(spk), name + ".npy"),
                    f0[::block][:n_frames].astype(np.float32))
            np.save(os.path.join(root, "volume", str(spk), name + ".npy"),
                    np.full((n_frames,), 0.15, np.float32))
    np.save(os.path.join(root, "f0_stats.npy"), stats, allow_pickle=True)


@contextmanager
def swapped(pairs):
    """Route (module, name) to fn for each (module, name, fn) of pairs."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in pairs]
    for mod, name, fn in pairs:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def g_step_leaves(torch, K, G, fresh, batch, rand_ini, generator_from_h, h,
                  warm) -> None:
    """Which generator leaf the GAN G step on the kernels reads worst
    against the plain versions, and which kernel moves it: the step with
    #3 on its plain version and #4 on the kernel, and the other way round,
    each leaf's gradient against the plain run's and against a float64 G
    step (the plain versions in float64 on the card; the kernels take fp32
    only), from the same state, batch and rand_ini. Prints the three worst
    leaves of each run."""
    from ddsp_svc_tpu_torch.nn import nsf_hifigan

    src = (nsf_hifigan, "harmonic_source", K.harmonic_source_plain)
    trio = (nsf_hifigan, "fused_resblocks_inject", K.resblocks_inject_plain)
    grads = {}
    for label, ctx in (("kernels", nullcontext()),
                       ("#3 plain, #4 kernel", swapped([src])),
                       ("#3 kernel, #4 plain", swapped([trio])),
                       ("plain", plain_kernels(K))):
        with ctx:
            trainer, st = fresh()
            trainer.step_g(st, batch, rand_ini)
        grads[label] = {n: p.grad.double()
                        for n, p in st.generator.named_parameters()}
        del trainer, st
    g64 = generator_from_h(h)
    g64.load_state_dict(warm)
    trainer = G.GanTrainer(h)
    st = trainer.create_state(g64.double().to("cuda"), seed=0)
    st.mpd.double()
    st.msd.double()
    with plain_kernels(K):
        trainer.step_g(st, {k: v.double() for k, v in batch.items()},
                       rand_ini.double())
    grads["float64"] = {n: p.grad for n, p in st.generator.named_parameters()}
    del trainer, st

    def rel(a, b):
        return ((a - b).norm() / (b.norm() + 1e-30)).item()

    for label in ("kernels", "#3 plain, #4 kernel", "#3 kernel, #4 plain",
                  "plain"):
        for ref in (("plain", "float64") if label != "plain"
                    else ("float64",)):
            worst = sorted(((rel(g, grads[ref][n]), n)
                            for n, g in grads[label].items()), reverse=True)
            say(f"GAN G step, {label} vs {ref}: worst leaves "
                + ", ".join(f"{n} {r:.3e}" for r, n in worst[:3]))


def grads_agree(label, model_k, model_p, tol_rel: float, tol_cos: float):
    """Every parameter gradient of the kernel run against the plain run:
    relative L2 distance and cosine; a missing one fails by name. Returns
    the worst of each."""
    worst_rel, worst_cos = 0.0, 1.0
    plain = dict(model_p.named_parameters())
    for name, p in model_k.named_parameters():
        if p.grad is None or plain[name].grad is None:
            fail(f"{label}: no gradient of {name} (kernels "
                 f"{p.grad is not None}, plain versions "
                 f"{plain[name].grad is not None})")
        g, r = p.grad.double(), plain[name].grad.double()
        nr = r.norm().item()
        rel = (g - r).norm().item() / (nr + 1e-12)
        cos = 1.0 if nr < 1e-10 else (
            (g * r).sum().item() / (g.norm().item() * nr + 1e-30))
        if not (rel < tol_rel and cos > tol_cos):
            fail(f"{label}: gradient of {name} disagrees with the plain "
                 f"versions: rel {rel:.3e} (< {tol_rel}), cos {cos:.7f} "
                 f"(> {tol_cos})")
        worst_rel, worst_cos = max(worst_rel, rel), min(worst_cos, cos)
    return worst_rel, worst_cos


def train_phase(torch, K, synth: str, config: str, expect,
                full: bool) -> dict:
    """The training path of one synthesizer at its config's full width;
    returns the summed launch counts of its trainer runs. full (the default
    model, CombSubFast) adds a resume, a model.bf16 run, a bf16 validation
    forward and a bf16 step against the plain versions."""
    import yaml
    from ddsp_svc_tpu_torch.data.dataset import get_data_loaders
    from ddsp_svc_tpu_torch.models.factory import build_model
    from ddsp_svc_tpu_torch.models.losses import RSSLoss
    from ddsp_svc_tpu_torch.train import __main__ as train_main
    from ddsp_svc_tpu_torch.train.step import (
        TrainState, batch_to_device, create_optimizer, eval_step, train_step,
        warm_up_buckets)
    from ddsp_svc_tpu_torch.utils.config import load_config

    args = load_config(os.path.join(ROOT, "configs", config))
    sr, block = args.data.sampling_rate, args.data.block_size
    n_unit = args.data.encoder_out_channels
    work = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(work, ignore_errors=True)
    write_dataset(os.path.join(work, "train"), 2, 3, 4.0, sr, block, n_unit, 0)
    write_dataset(os.path.join(work, "val"), 2, 1, 4.0, sr, block, n_unit, 1)
    args["data"].update(train_path=os.path.join(work, "train"),
                        valid_path=os.path.join(work, "val"))
    args["train"].update(interval_log=1, epochs=1000)
    say(f"training path ({synth}): {sr} Hz block {block} n_unit {n_unit}, "
        f"batch {args.train.batch_size} x {args.data.duration} s crops, RSS "
        f"{args.loss.fft_min}..{args.loss.fft_max} x {args.loss.n_scale} "
        f"scales; synthetic dataset of 6 training and 2 validation clips")
    expect_train = tuple(expect) + ("dft_magnitude",)

    def config_file(name: str, bf16: bool, interval_val: int,
                    **train) -> str:
        cfg = json.loads(json.dumps(args))
        cfg["model"]["bf16"] = bf16
        cfg["env"]["expdir"] = os.path.join(work, "exp_" + name)
        cfg["train"].update(interval_val=interval_val, **train)
        path = os.path.join(work, name + ".yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return path

    def run(cfg_path: str, steps: int, label: str):
        before = {k: v.clone() for k, v in
                  build_model(load_config(cfg_path), device="cuda",
                              seed=0).state_dict().items()}
        t0 = time.perf_counter()
        state, saver = train_main.main(["-c", cfg_path, "--max-steps",
                                        str(steps)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(saver.expdir, "log_values.jsonl")) as f:
            values = [json.loads(line) for line in f]
        losses = [v["train/loss"] for v in values if "train/loss" in v]
        k = int(load_config(cfg_path).train.steps_per_dispatch or 1)
        if len(losses) < steps // k or not np.isfinite(losses).all():
            fail(f"{label}: losses {losses}")
        if not any("validation/loss" in v for v in values):
            fail(f"{label}: no validation pass")
        moved = sum(not torch.equal(v, before[k])
                    for k, v in state.model.state_dict().items())
        say(f"{label}: {steps} steps to global step {saver.global_step} in "
            f"{wall:.1f} s (validation and checkpoint included), losses "
            f"{[round(x, 4) for x in losses[-steps:]]}, {moved} tensors moved")
        if moved == 0:
            fail(f"{label}: no parameter moved")
        return state, saver

    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # fp32: steps with one validation pass and a checkpoint (then, for the
    # default model, a resume from it)
    cfg32 = config_file("fp32", False, FP32_STEPS)
    K.reset_launch_counts()
    run(cfg32, FP32_STEPS, f"train {synth} fp32")
    if full:
        state, saver = run(cfg32, 1, f"train {synth} fp32 resumed")
        if state.step != FP32_STEPS + 1:
            fail(f"the resumed run did not restore step {FP32_STEPS}")
    counts = path_launches(K, f"training path ({synth}, fp32)", expect_train)
    if counts["combsub_spectral_bwd"]:
        fail("fp32 training launched the combsub adjoint (its chain is the "
             "plain torch.fft one)")
    add(counts)
    if full:
        # model.bf16: the spectral chain runs on its kernel's and its
        # adjoint's bf16-operand forms; the validation pass at the last step
        # runs the attention's form on bf16 q, k, v
        cfg16 = config_file("bf16", True, BF16_STEPS)
        K.reset_launch_counts()
        run(cfg16, BF16_STEPS, f"train {synth} bf16")
        add(bf16_path_launches(K, f"training path ({synth}, bf16)",
                               expect_train + ("combsub_spectral_bwd",)))

    # the four train options together through the entry: K-step graphed
    # dispatches over the device pool, remat and asynchronous checkpoints,
    # each checkpoint also written synchronously at the same moment
    for bf16 in ((False, True) if full else (False,)):
        name = "options_bf16" if bf16 else "options"
        cfg_opt = config_file(name, bf16, OPTION_STEPS, **TRAIN_OPTIONS)
        K.reset_launch_counts()
        with sync_twins() as saves:
            run(cfg_opt, OPTION_STEPS, f"train {synth} "
                f"{'bf16' if bf16 else 'fp32'} {json.dumps(TRAIN_OPTIONS)}")
        launches = path_launches if not bf16 else bf16_path_launches
        add(launches(K, f"training path ({synth}, {name})",
                     expect_train + (("combsub_spectral_bwd",)
                                     if bf16 else ())))
        check_twins(torch, saves, f"{synth} {name}")

    # the graphed step against the eager one, at this config's width
    for bf16 in ((False, True) if full else (False,)):
        # the kernels a step launches: the synth's own (CombSubFast's
        # spectral chain only under bf16, with its adjoint) and #6
        step_kernels = bf16_names(tuple(
            k for k in expect_train if k != "performer_attention"
            and (bf16 or k != "combsub_spectral")) + (
                ("combsub_spectral_bwd",) if bf16 else ()), bf16)
        add(graph_phase(torch, K, config_file("graph", bf16, 10 ** 6),
                        f"{synth} {'bf16' if bf16 else 'fp32'}", step_kernels,
                        full))

    # one step on the kernels against the same step on the plain versions:
    # same weights, batch, noise and loss scales, at loss eps 1e-3 (the
    # conditioned regime of the JAX package's gradient parity tests)
    loader, _ = get_data_loaders(load_config(cfg32))
    batch = batch_to_device(next(iter(loader.epoch(0))), "cuda")
    g = torch.Generator(device="cuda").manual_seed(7)
    noise = torch.rand(batch["audio"].shape, generator=g, device="cuda") * 2 - 1
    rss = RSSLoss(int(args.loss.fft_min), int(args.loss.fft_max),
                  int(args.loss.n_scale), eps=1e-3)

    if full:
        # the bf16 validation forward (infer=True) on the kernels' forms
        # against the same forward on the plain forms. Both round the same
        # operands to bf16; their fp32 rounding differences (~1e-6) flip
        # bf16 roundings downstream (2^-8 relative each), and the flips grow
        # through the three PCmer layers towards bf16's own noise (bf16 vs
        # fp32 reads 1.8e-2). So the signal is held to the JAX package's
        # bf16 bound, 5e-2 relative RMS (tests/test_bf16.py); its spectral
        # loss, which the flips hardly move, to 1e-4
        model16 = build_model(load_config(cfg16), device="cuda", seed=0)
        outs = []
        for plain in (False, True):
            with plain_kernels(K) if plain else nullcontext():
                gen = torch.Generator(device="cuda").manual_seed(42)
                sig, loss = eval_step(model16, batch, rss, gen)
            outs.append((sig, float(loss)))
        (sig_k, loss_k), (sig_p, loss_p) = outs
        rel_rms = ((sig_k - sig_p).pow(2).mean()
                   / sig_p.pow(2).mean()).sqrt().item()
        rel_loss = abs(loss_k - loss_p) / abs(loss_p)
        say(f"validation forward {synth} bf16, kernels vs plain versions: "
            f"signal rel RMS {rel_rms:.3e} (tolerance 5e-2), all-bucket loss "
            f"{loss_k:.6f} vs {loss_p:.6f} (rel {rel_loss:.2e}, tolerance "
            f"1e-4)")
        if not (torch.isfinite(sig_k).all() and rel_rms < 5e-2
                and rel_loss < 1e-4):
            fail("bf16 validation forward disagrees with the plain versions")

    # per-parameter bounds of tests/test_train_parity.py (rel < 2e-2, cos >
    # 1 - 1e-4); under bf16 the chains' fp32 rounding differences pass
    # through bf16 matmuls in the backward and come out at ~1e-3 (the bf16
    # and fp32 steps themselves differ by ~3e-2)
    for bf16 in ((False, True) if full else (False,)):
        tol_rel, tol_cos = 2e-2, 1 - 1e-4
        cfg = load_config(cfg16 if bf16 else cfg32)
        label = f"{synth} {'bf16' if bf16 else 'fp32'}"
        states = []
        for plain in (False, True):
            model = build_model(cfg, device="cuda", seed=0)
            st = TrainState(0, model, create_optimizer(model, 1e-4))
            ctx = plain_kernels(K) if plain else nullcontext()
            with ctx:
                loss = float(train_step(st, batch, rss, noise=noise,
                                        loss_idx=PINNED_LOSS_IDX))
            states.append((st, loss))
        (sk, lk), (sp, lp) = states
        rel_loss = abs(lk - lp) / abs(lp)
        worst_rel, worst_cos = grads_agree(f"{label} step", sk.model,
                                           sp.model, tol_rel, tol_cos)
        say(f"train step {label}, kernels vs plain versions: loss {lk:.6f} vs "
            f"{lp:.6f} (rel {rel_loss:.2e}, tolerance 1e-4); worst parameter "
            f"gradient rel {worst_rel:.3e} (< {tol_rel}), cos "
            f"{worst_cos:.7f} (> {tol_cos})")
        if not rel_loss < 1e-4:
            fail(f"{label} step loss disagrees with the plain versions")

        for plain in (False, True):
            st = states[int(plain)][0]
            ctx = plain_kernels(K) if plain else nullcontext()
            times = []
            with ctx:
                warm_up_buckets(st, batch, rss)
                for _ in range(TIMED_STEPS + 1):
                    t0 = time.perf_counter()
                    train_step(st, batch, rss)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
            say(f"train step {label} on the "
                f"{'plain versions' if plain else 'kernels'}: "
                f"{np.median(times[1:]) * 1e3:.1f} ms median of "
                f"{TIMED_STEPS} (batch {args.train.batch_size} x "
                f"{batch['audio'].shape[1]} samples, RSS "
                f"{args.loss.n_scale} scales drawn per step)")
    shutil.rmtree(work, ignore_errors=True)
    return total


# the trainer's options (train/solver.py): the run of all four through the
# entry, its steps, and the graphed phase's steps, dispatch size and timed
# dispatches
TRAIN_OPTIONS = {"steps_per_dispatch": 4, "data_on_device": True,
                 "remat": True, "async_save": True}
OPTION_STEPS = 8
GRAPH_STEPS, GRAPH_K, GRAPH_TIMED = 8, 4, 5
GRAPH_LOSS_RTOL, GRAPH_PARAM_TOL = 1e-5, 1e-4


@contextmanager
def sync_twins():
    """While it is open, every Saver.save_model also writes the same state
    synchronously beside the file (`<path>.sync`); yields {path: (ms in
    save_model, ms in the synchronous save)}."""
    from ddsp_svc_tpu_torch.train import saver as saver_mod
    from ddsp_svc_tpu_torch.train.checkpoint import save_checkpoint
    real = saver_mod.Saver.save_model
    saves = {}

    def both(self, model, optimizer, postfix):
        t0 = time.perf_counter()
        path = real(self, model, optimizer, postfix)
        t1 = time.perf_counter()
        save_checkpoint(path + ".sync", self.global_step, model, optimizer)
        saves[path] = ((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3)
        return path

    saver_mod.Saver.save_model = both
    try:
        yield saves
    finally:
        saver_mod.Saver.save_model = real


def check_twins(torch, saves: dict, label: str) -> None:
    """Each checkpoint against its synchronous twin: every tensor equal
    (model and optimizer state)."""
    def same(a, b) -> bool:
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        if torch.is_tensor(a):
            return torch.equal(a, b)
        return a == b

    for path in saves:
        got, ref = (torch.load(p, weights_only=True)
                    for p in (path, path + ".sync"))
        if not same(got, ref):
            fail(f"{label}: {os.path.basename(path)} differs from the "
                 "synchronous checkpoint of the same state")
    t_async = [a for a, _ in saves.values()]
    t_sync = [b for _, b in saves.values()]
    say(f"checkpoints {label}: {len(saves)} asynchronous saves, each equal "
        f"to the synchronous one of the same state; the training thread "
        f"spent {np.median(t_async):.1f} ms a save in save_model "
        f"(asynchronous: host copy and queue; max {max(t_async):.1f}) "
        f"against {np.median(t_sync):.1f} ms a synchronous save (max "
        f"{max(t_sync):.1f})")


def profile_dispatch(torch, fn, k: int) -> tuple:
    """One dispatch of k steps under torch.profiler: (CUDA launch API calls
    a step, memcpy calls a step, the device's idle share of the traced
    window)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages() if "Launch" in e.key)
    copies = sum(e.count for e in prof.key_averages()
                 if e.key.startswith("cudaMemcpy"))
    _, busy, _ = device_split(torch, prof, lambda ev: "all")
    evs = list(prof.events())
    window = (max(e.time_range.end for e in evs)
              - min(e.time_range.start for e in evs)) / 1e3
    return launches / k, copies / k, 1.0 - busy / window


def graph_phase(torch, K, cfg_path: str, label: str, expect,
                full: bool) -> dict:
    """The graphed step (train/graphed.py) against the eager step at one
    config's width, from the same weights and data: GRAPH_STEPS (full) or
    GRAPH_K steps on the loader's batches, and for the default model also
    on the device pool's crops, each eager and as graphed dispatches of
    GRAPH_K. Each step's loss within GRAPH_LOSS_RTOL relative and every
    parameter after them within GRAPH_PARAM_TOL x max|param| of the eager
    run's, the replays' launch counts equal to the eager steps' (#6 at 2 x
    n_scale a step) and each kernel of `expect` launched; ms a step eager
    and graphed (median of GRAPH_TIMED dispatches after a warm one, the
    capture apart), launch API calls a step and the idle share
    (torch.profiler). With full also the peak memory of a step with and
    without remat, and a remat step's gradients against the plain step's.
    Returns the graphed dispatches' launch counts."""
    import random
    from ddsp_svc_tpu_torch.data.dataset import get_data_loaders
    from ddsp_svc_tpu_torch.data.device_pool import DevicePool
    from ddsp_svc_tpu_torch.models.factory import build_model
    from ddsp_svc_tpu_torch.models.losses import RSSLoss
    from ddsp_svc_tpu_torch.train.graphed import GraphedTrainSteps
    from ddsp_svc_tpu_torch.train.step import (
        BATCH_KEYS, TrainState, create_optimizer, stage, train_step,
        train_steps)
    from ddsp_svc_tpu_torch.utils.config import load_config

    args = load_config(cfg_path)
    loader, _ = get_data_loaders(args)
    rss = RSSLoss(int(args.loss.fft_min), int(args.loss.fft_max),
                  int(args.loss.n_scale))
    n_steps = GRAPH_STEPS if full else GRAPH_K
    host = [{k: b[k] for k in BATCH_KEYS}
            for e in range(n_steps) for b in loader.epoch(e)][:n_steps]
    runs = [("loader batches", host, None)]
    if full:
        pool = DevicePool(loader.dataset, int(args.data.block_size), "cuda")
        rng = random.Random(0)
        bsz = int(args.train.batch_size)
        runs.append(("device pool", [
            pool.sample([rng.randrange(len(pool)) for _ in range(bsz)], rng)
            for _ in range(n_steps)], pool))

    def fresh():
        model = build_model(args, device="cuda", seed=0)
        return TrainState(0, model, create_optimizer(
            model, float(args.train.lr), float(args.train.weight_decay or 0)))

    def chunks(items):
        return [stage(items[i:i + GRAPH_K], "cuda")
                for i in range(0, len(items), GRAPH_K)]

    def eager_run(items, pool):
        st = fresh()
        K.reset_launch_counts()
        losses = torch.cat([train_steps(st, x, rss, pool=pool)
                            for x in chunks(items)])
        return st, losses, K.launch_counts()

    def distance(a, la, b, lb):
        """(max relative loss difference, worst parameter difference over
        max|param| and its name, bit for bit)"""
        rel = ((la - lb).abs() / lb.abs()).max().item()
        worst, worst_name = 0.0, ""
        for (name, p), q in zip(a.model.named_parameters(),
                                b.model.parameters()):
            err = ((p - q).abs().max() / q.abs().max()).item()
            if err >= worst:
                worst, worst_name = err, name
        bitwise = torch.equal(la, lb) and all(
            torch.equal(p, q) for p, q in zip(a.model.parameters(),
                                              b.model.parameters()))
        return rel, worst, worst_name, bitwise

    total = {}
    for kind, items, pool in runs:
        # cuDNN's weight-gradient convolutions may sum in another order on
        # every run, and AdamW's first steps turn a near-zero gradient's
        # sign into a whole lr step; the gated runs take its deterministic
        # algorithms (both sides), the spread of two default runs is shown
        torch.backends.cudnn.deterministic = True
        eager, le, counts_e = eager_run(items, pool)
        graphed = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = GraphedTrainSteps(graphed, rss, chunks(items)[0], pool=pool)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        K.reset_launch_counts()
        lg = torch.cat([steps(x) for x in chunks(items)])
        counts_g = K.launch_counts()
        torch.backends.cudnn.deterministic = False
        for k, v in counts_g.items():
            total[k] = total.get(k, 0) + v
        rel, worst, worst_name, bitwise = distance(graphed, lg, eager, le)
        spread = distance(*eager_run(items, pool)[:2], *eager_run(
            items, pool)[:2])
        say(f"graphed {label} ({kind}), {n_steps} steps as dispatches of "
            f"{GRAPH_K} against {n_steps} eager steps (cuDNN deterministic): "
            f"losses rel {rel:.3e} (tolerance {GRAPH_LOSS_RTOL}), parameters "
            f"{worst:.3e} x max|param| ({worst_name}; tolerance "
            f"{GRAPH_PARAM_TOL}), bit for bit {bitwise}; two eager runs with "
            f"cuDNN's default algorithms: losses rel {spread[0]:.3e}, "
            f"parameters {spread[1]:.3e} x max|param| ({spread[2]}), bit for "
            f"bit {spread[3]}; the capture (warm-up included) "
            f"{capture_s:.2f} s once; launches through the replays "
            f"{json.dumps(counts_g)}")
        if not (torch.isfinite(lg).all() and rel <= GRAPH_LOSS_RTOL
                and worst <= GRAPH_PARAM_TOL):
            fail(f"graphed {label} ({kind}) disagrees with the eager steps")
        if counts_g != counts_e or counts_g["dft_magnitude"] != \
                2 * rss.n_scale * n_steps:
            fail(f"graphed {label} ({kind}): replays launched {counts_g}, "
                 f"the eager steps {counts_e}")
        for name in expect:
            if counts_g[name] <= 0:
                fail(f"graphed {label} ({kind}): {name} not launched")
        x = chunks(items)[0]
        times = {}
        for mode, fn in (("eager", lambda: train_steps(eager, x, rss,
                                                       pool=pool)),
                         ("graphed", lambda: steps(x))):
            walls = []
            for _ in range(GRAPH_TIMED + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3 / GRAPH_K)
            launches, copies, idle = profile_dispatch(torch, fn, GRAPH_K)
            times[mode] = np.median(walls[1:])
            say(f"train step {label} ({kind}) {mode}: "
                f"{times[mode]:.2f} ms a step, median of {GRAPH_TIMED} "
                f"dispatches of {GRAPH_K} (walls "
                f"{[round(w, 2) for w in walls[1:]]}); torch.profiler over "
                f"one dispatch: {launches:.1f} CUDA launch API calls and "
                f"{copies:.1f} memcpy calls a step, device idle share "
                f"{idle:.3f}")
        say(f"train step {label} ({kind}): graphed / eager "
            f"{times['graphed'] / times['eager']:.3f}")

    if full:
        # remat: a step's gradients against the plain step's (from the same
        # weights, cuDNN deterministic), then the peak memory of a further
        # step with and without
        batch = {k: v[0] for k, v in stage(host[:1], "cuda").items()}
        states, peaks = {}, {}
        torch.backends.cudnn.deterministic = True
        for remat in (False, True):
            states[remat] = fresh()
            train_step(states[remat], batch, rss, remat=remat)
        torch.backends.cudnn.deterministic = False
        worst_rel, worst_cos = grads_agree(f"{label} remat step",
                                           states[True].model,
                                           states[False].model, 2e-2,
                                           1 - 1e-4)
        for remat in (False, True):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            train_step(states[remat], batch, rss, remat=remat)
            torch.cuda.synchronize()
            peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        say(f"train step {label} remat: gradients against the plain step's "
            f"worst rel {worst_rel:.3e} (< 2e-2), cos {worst_cos:.7f} (> 1 - "
            f"1e-4); peak memory above the resident state {peaks[True]:.3f} "
            f"GiB with remat, {peaks[False]:.3f} GiB without")
    return total


# the CLI phase: the kernels each segment of the offline path launches; the
# staged-bf16 run's mel also takes #6's bf16-input form, as JAX's takes
# dft_magnitude_pallas(mxu_bf16=True) on the TPU
CLI_PER_SEGMENT = {"performer_attention": 3, "combsub_spectral": 1,
                   "harmonic_source": 1, "fused_resblocks_inject": 3,
                   "dft_magnitude": 0, "dft_magnitude_bf16": 0}
CLI_STAGED_PER_SEGMENT = dict(CLI_PER_SEGMENT, dft_magnitude_bf16=1)
CLI_STAGED = 128  # the staged-bf16 threshold of the second CLI run


def sung_wav(sr: int, seed: int = 0, phrases=(5.0, 4.5, 2.5)) -> np.ndarray:
    """A sung-like line: phrases (by default 5.0, 4.5 and 2.5 s, 13 s in
    all) of notes between 150 and 500 Hz, six decaying harmonics, 5.5 Hz
    vibrato, split by 0.5 s of silence; the slicer cuts a segment at a
    silence once it holds 5 s (the default: three segments)."""
    rng = np.random.default_rng(seed)
    parts = []
    for i, dur in enumerate(phrases):
        if i:
            parts.append(np.zeros(int(0.5 * sr)))
        n = int(dur * sr)
        t = np.arange(n) / sr
        notes = 150 * 2 ** (rng.integers(0, 21, int(dur * 2) + 1) / 12)
        f0 = notes[(t * 2).astype(int)] * (1 + 0.03 * np.sin(2 * np.pi * 5.5 * t))
        ph = 2 * np.pi * np.cumsum(f0) / sr
        x = sum(0.35 / k * np.sin(k * ph) for k in range(1, 7))
        env = np.minimum(1.0, np.minimum(t, t[-1] - t) / 0.03)
        parts.append(x * env * (0.8 + 0.2 * np.sin(2 * np.pi * 0.7 * t)))
    audio = np.concatenate(parts)
    return (audio + 3e-4 * rng.standard_normal(len(audio))).astype(np.float32)


def cli_phase(torch, K, card: str) -> dict:
    """The offline CLI (`python -m ddsp_svc_tpu_torch.infer`'s main) end to
    end on a 44.1 kHz wav at configs/combsub.yaml's full width: CREPE f0,
    HuBERT-soft units, CombSubFast, NSF-HiFiGAN (H_NSF), the wav written;
    fp32, staged bf16, and fp32 on the plain versions; the staged mel
    against the fp32 one; parselmouth against its CPU run; each stage's
    wall. Returns the launch counts of the fp32 and staged runs, summed, and
    the fp32 and staged experiments' checkpoints (under build/chip_smoke_cli/,
    which the batch and preprocess phases read and main removes)."""
    import yaml
    from ddsp_svc_tpu_torch.data.features import (F0Extractor, UnitsEncoder,
                                                  VolumeExtractor)
    from ddsp_svc_tpu_torch.data.wavio import read_wav, write_wav
    from ddsp_svc_tpu_torch.infer import __main__ as cli
    from ddsp_svc_tpu_torch.infer.enhancer import Enhancer, NsfHifiGAN
    from ddsp_svc_tpu_torch.infer.offline import convert_features, split
    from ddsp_svc_tpu_torch.models.factory import build_model, load_model
    from ddsp_svc_tpu_torch.nn.crepe import CrepeExtractor, decode
    from ddsp_svc_tpu_torch.nn.hubert import HubertSoft, init_hubert_
    from ddsp_svc_tpu_torch.ops.resample import resample
    from ddsp_svc_tpu_torch.ops.spectral import log_mel_spectrogram
    from ddsp_svc_tpu_torch.train.checkpoint import save_checkpoint
    from ddsp_svc_tpu_torch.utils.config import load_config

    work = os.path.join(ROOT, "build", "chip_smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "nsf"))
    args = load_config(os.path.join(ROOT, "configs", "combsub.yaml"))
    sr, bs = args.data.sampling_rate, args.data.block_size
    audio = sung_wav(sr)
    wav = os.path.join(work, "in.wav")
    write_wav(wav, audio, sr)
    # HuBERT-soft in the bshall layout (weight norm on the positional conv)
    sd = init_hubert_(HubertSoft(), torch.Generator().manual_seed(5)).state_dict()
    w = sd.pop("positional_embedding.conv.weight")
    sd["positional_embedding.conv.weight_g"] = w.pow(2).sum((0, 1), keepdim=True).sqrt()
    sd["positional_embedding.conv.weight_v"] = w
    torch.save(sd, os.path.join(work, "hubert-soft.pt"))
    nsf = NsfHifiGAN(None, h=H_NSF, seed=1, device="cpu")
    torch.save({"generator": nsf.model.state_dict()},
               os.path.join(work, "nsf", "model"))
    with open(os.path.join(work, "nsf", "config.json"), "w") as f:
        json.dump(H_NSF, f)
    args["data"]["encoder_ckpt"] = os.path.join(work, "hubert-soft.pt")
    args["enhancer"]["ckpt"] = os.path.join(work, "nsf", "model")
    model = build_model(args, device="cpu", seed=0)
    ckpts = {}
    for name, threshold in (("fp32", 0), ("bf16", CLI_STAGED)):
        exp = os.path.join(work, "exp_" + name)
        args["enhancer"]["bf16_min_channels"] = threshold
        os.makedirs(exp)
        with open(os.path.join(exp, "config.yaml"), "w") as f:
            yaml.safe_dump(json.loads(json.dumps(args)), f)
        ckpts[name] = os.path.join(exp, "model_0.pt")
        save_checkpoint(ckpts[name], 0, model)
    n_seg = len(split(audio, sr, bs))
    dur = len(audio) / sr
    say(f"CLI path: {dur:.3f} s wav at {sr} Hz, {n_seg} segments; "
        f"CombSubFast (configs/combsub.yaml, n_unit "
        f"{args.data.encoder_out_channels}), HuBERT-soft (768 x 12 layers), "
        f"CREPE full, NSF-HiFiGAN initial channel "
        f"{H_NSF['upsample_initial_channel']}; weights from seeds 0/1/5")
    if n_seg < 3:
        fail(f"the CLI wav split into {n_seg} segments, expected >= 3")

    def run(label, kind, plain=False, out_dir="out"):
        out = os.path.join(work, out_dir, label + ".wav")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with plain_kernels(K) if plain else nullcontext():
            cli.main(["-m", ckpts[kind], "-i", wav, "-o", out, "-pe", "crepe",
                      "-e", "true"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        y, sr_o = read_wav(out)
        rms = float(np.sqrt(np.mean(y.astype(np.float64) ** 2)))
        say(f"CLI {label}: {y.shape[-1]} samples at {sr_o} Hz, rms {rms:.4f}, "
            f"{wall:.2f} s; launches {json.dumps(counts)}")
        if not (sr_o == sr and abs(y.shape[-1] - len(audio)) <= bs
                and np.isfinite(y).all() and rms > 0):
            fail(f"CLI {label}: {y.shape[-1]} samples at {sr_o} Hz (input "
                 f"{len(audio)}), finite {np.isfinite(y).all()}, rms {rms}")
        return y.astype(np.float64), counts, wall

    # the first run extracts f0 into the cache beside its output; the
    # others read it, so every run converts from the same f0
    y32, counts, first_wall = run("fp32", "fp32")
    for name, per in CLI_PER_SEGMENT.items():
        if counts[name] != per * n_seg:
            fail(f"CLI fp32 launched {name} {counts[name]} times, expected "
                 f"{per} per segment x {n_seg}")
    y16, counts16, _ = run(f"staged bf16 ({CLI_STAGED})", "bf16")
    for name, per in CLI_STAGED_PER_SEGMENT.items():
        if counts16[name] != per * n_seg:
            fail(f"CLI staged bf16 launched {name} {counts16[name]} times, "
                 f"expected {per} per segment x {n_seg}")
    ref, _, _ = run("fp32 on the plain versions", "fp32", plain=True)
    err = float(np.abs(y32 - ref).max())
    scale = float(np.abs(ref).max())
    rel = float(np.sqrt(np.mean((y16 - y32) ** 2) / np.mean(y32 ** 2)))
    say(f"CLI kernels vs plain versions: max|err| {err:.3e} = "
        f"{err / scale:.3e} x max|ref| (tolerance 1e-3 x max|ref|); staged "
        f"bf16 vs fp32: rel RMS {rel:.3e} (tolerance 2e-2)")
    if not err <= 1e-3 * scale:
        fail("the CLI's audio disagrees with the plain versions")
    if not rel < 2e-2:
        fail("the staged-bf16 CLI run is not within 2e-2 of fp32")

    # the staged mel (#6's bf16-input form on the card) against the same
    # bf16 route on the plain version (cuFFT of the bf16-rounded frames) on
    # each segment at H_NSF's geometry: the linear mel within rel RMS 1e-4;
    # the bf16 route's distance from the fp32 route (cuFFT of fp32 frames)
    # beside it (JAX's bf16 route reads alike: the frames' rounding)
    geo = tuple(H_NSF[k] for k in ("sampling_rate", "n_fft", "hop_size",
                                   "win_size", "num_mels", "fmin", "fmax"))
    mel_rel = mel_dlog = mel_mean = 0.0
    for _, a in split(audio, sr, bs):
        x = torch.as_tensor(a, device="cuda")[None]
        m16 = log_mel_spectrogram(x, *geo, mxu_bf16=True).double()
        with plain_kernels(K):
            m_p = log_mel_spectrogram(x, *geo, mxu_bf16=True).double()
        m32 = log_mel_spectrogram(x, *geo).double()
        mel_rel = max(mel_rel, ((m16.exp() - m_p.exp()).pow(2).mean()
                                / m_p.exp().pow(2).mean()).sqrt().item())
        mel_dlog = max(mel_dlog, (m16 - m32).abs().max().item())
        mel_mean = max(mel_mean, (m16 - m32).abs().mean().item())
    say(f"CLI staged mel (dft_magnitude_bf16) vs the same route on the plain "
        f"version: rel RMS {mel_rel:.3e} (tolerance 1e-4); the bf16 route vs "
        f"the fp32 mel (cuFFT): max|d log mel| {mel_dlog:.3e}, worst "
        f"segment's mean {mel_mean:.3e}")
    if not mel_rel < 1e-4:
        fail("the staged mel disagrees with its plain version")

    # parselmouth's candidate stage runs on the card: against its CPU run
    # (dio and harvest are host numpy whatever the device; their walls below)
    got = F0Extractor("parselmouth", sr, bs, 50.0, 1100.0,
                      device="cuda").extract(audio, uv_interp=False)
    cpu = F0Extractor("parselmouth", sr, bs, 50.0, 1100.0,
                      device="cpu").extract(audio, uv_interp=False)
    same = float(((got > 0) == (cpu > 0)).mean())
    v = (got > 0) & (cpu > 0)
    cents = float(np.abs(1200 * np.log2(got[v] / cpu[v])).max()) if v.any() else 0.0
    say(f"f0 parselmouth, card vs CPU: voicing agrees on {same:.4f} of "
        f"frames (>= 0.99), voiced frames within {cents:.4f} cents (< 1); "
        f"{v.mean():.3f} of frames voiced")
    if not (same >= 0.99 and cents < 1.0 and v.mean() > 0.5):
        fail("the parselmouth f0 on the card disagrees with the CPU")

    # the stage walls (host clock around work that ends on the host)
    def wall(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    walls = {}
    for family in ("parselmouth", "dio", "harvest", "crepe"):
        ext = F0Extractor(family, sr, bs, 50.0, 1100.0, device="cuda")
        ext.extract(audio[:sr])
        f0, walls[f"f0 {family}"] = wall(lambda: ext.extract(audio, uv_interp=True))
        if not (f0.shape == (len(audio) // bs + 1,) and np.isfinite(f0).all()):
            fail(f"f0 {family}: shape {f0.shape}, finite {np.isfinite(f0).all()}")
    crepe = CrepeExtractor(50.0, 1100.0, device="cuda")
    wav16k, _ = wall(lambda: resample(torch.as_tensor(audio, device="cuda")[None],
                                      sr, 16000)[0])
    probs, walls["crepe network (device stage)"] = wall(lambda: crepe.probabilities(wav16k))
    _, walls["crepe Viterbi + cents (host)"] = wall(
        lambda: decode(probs, 50.0, 1100.0))
    mdl, margs = load_model(ckpts["fp32"], device="cuda")
    enc = UnitsEncoder(margs.data.encoder, margs.data.encoder_ckpt,
                       margs.data.encoder_sample_rate,
                       margs.data.encoder_hop_size, device="cuda")
    segs = split(audio, sr, bs)
    units, walls["units (HuBERT, device stage)"] = wall(
        lambda: [(st, enc.encode(a[None], sr, bs)) for st, a in segs])
    f0 = np.load(os.path.join(work, "out", "cache", os.listdir(
        os.path.join(work, "out", "cache"))[0]))[None, :, None].astype(np.float32)
    volume = VolumeExtractor(bs).extract(audio)[None]
    for label, threshold in (("fp32", 0), ("staged bf16", CLI_STAGED)):
        enh = Enhancer("nsf-hifigan", margs.enhancer.ckpt, device="cuda",
                       bf16_min_channels=threshold)
        convert_features(mdl, units, f0, volume, enhancer=enh)
        (result, _), walls[f"synth + enhance {label} (device stage)"] = wall(
            lambda: convert_features(mdl, units, f0, volume, enhancer=enh))
    _, walls["write"] = wall(lambda: write_wav(os.path.join(work, "w.wav"),
                                               result.astype(np.float32), sr))
    _, _, total = run("fp32, f0 cache empty", "fp32", out_dir="out_total")
    for name, t in walls.items():
        say(f"{card}: CLI stage {name}: {t * 1e3:.1f} ms")
    say(f"{card}: CLI total (fp32, CREPE f0 included, warm): {total:.2f} s "
        f"for {dur:.3f} audio-s = {dur / total:.2f} audio-s/s (first run, "
        f"builds included: {first_wall:.2f} s)")
    return {k: counts[k] + counts16[k] for k in counts}, ckpts


# the batch phase: six wavs of 3..13 s (phrases split by 0.5 s silences),
# whose segments fall into the 64..512-frame buckets
BATCH_WAVS = ((3.0,), (5.0,), (5.5, 1.0), (5.5, 3.0), (5.0, 4.7, 0.3),
              (5.0, 4.5, 2.5))
BATCH_SIZE = 16
# the kernels of one synth chunk and of one enhance_batch call (and, staged
# at 128, #6 once in its mel)
SYNTH_PER_CHUNK = {"performer_attention": 3, "combsub_spectral": 1}
ENHANCE_PER_CALL = {"harmonic_source": 1, "fused_resblocks_inject": 3}


def batch_phase(torch, K, card: str, ckpts: dict) -> dict:
    """Directory conversion (`python -m ddsp_svc_tpu_torch.infer -i DIR -o
    OUT --batch 16`) at configs/combsub.yaml's full width with the CLI
    phase's checkpoints: six sung wavs; every output written, finite, of its
    input's length; hooked batch runs in fp32 and staged bf16 against the
    single path file by file (fp32 1e-4 of max |ref|; staged rel RMS
    2e-2, the staged bound, since the batch's own fp32 rounding flips bf16
    roundings); launches against the bucket plan; walls. Returns the launch counts of the first run and the
    two hooked runs, summed."""
    from ddsp_svc_tpu_torch.data.wavio import read_wav, write_wav
    from ddsp_svc_tpu_torch.infer import __main__ as cli
    from ddsp_svc_tpu_torch.infer.batch import run_inference_batch
    from ddsp_svc_tpu_torch.infer.offline import run_inference, split
    from ddsp_svc_tpu_torch.models.factory import bucket_frames

    work = os.path.join(ROOT, "build", "chip_smoke_batch")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "in"))
    sr, bs = 44100, 512
    wavs, audios = [], []
    for seed, phrases in enumerate(BATCH_WAVS):
        a = sung_wav(sr, seed + 1, phrases)
        wavs.append(os.path.join(work, "in", f"w{seed}.wav"))
        write_wav(wavs[-1], a, sr)
        audios.append(a)
    dur = sum(len(a) for a in audios) / sr
    # the bucket plan: each segment's frames as the units give them
    groups = {}
    for a in audios:
        for _, seg in split(a, sr, bs):
            b = bucket_frames(len(seg) // bs + 1)
            groups[b] = groups.get(b, 0) + 1
    chunks = sum(-(-n // BATCH_SIZE) for n in groups.values())
    n_seg = sum(groups.values())
    say(f"batch path: {len(wavs)} wavs ({dur:.3f} audio-s at {sr} Hz), "
        f"{n_seg} segments in buckets {json.dumps(dict(sorted(groups.items())))}"
        f", --batch {BATCH_SIZE}: {chunks} synth chunks and {chunks} "
        f"enhance_batch calls")

    def expect(label, counts, staged):
        want = {k: v * chunks for k, v in {**SYNTH_PER_CHUNK,
                                            **ENHANCE_PER_CALL}.items()}
        want["dft_magnitude_bf16"] = chunks if staged else 0
        bad = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
        say(f"batch {label} launches: {json.dumps(counts)}")
        if bad:
            fail(f"batch {label}: launches (got, expected) {bad}")

    out1 = os.path.join(work, "out")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    outs = cli.main(["-m", ckpts["fp32"], "-i", os.path.join(work, "in"),
                     "-o", out1, "--batch", str(BATCH_SIZE), "-pe", "crepe",
                     "-eak", "0"])
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = K.launch_counts()
    expect("fp32 CLI", counts, staged=False)
    if outs != [os.path.join(out1, os.path.basename(w)) for w in wavs]:
        fail(f"batch CLI wrote {outs}")
    for o, a in zip(outs, audios):
        y, sr_o = read_wav(o)
        if not (sr_o == sr and abs(y.shape[-1] - len(a)) <= bs
                and np.isfinite(y).all() and np.sqrt(np.mean(y ** 2)) > 0):
            fail(f"batch CLI {o}: {y.shape[-1]} samples at {sr_o} Hz (input "
                 f"{len(a)}), finite {np.isfinite(y).all()}")
    walls = {}
    t0 = time.perf_counter()
    run_inference_batch(ckpts["fp32"], wavs, os.path.join(work, "warm"),
                        batch_size=BATCH_SIZE, pitch_extractor="crepe",
                        f0_min=50.0, f0_max=1100.0, walls=walls)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0

    def noise(f, s, shape):
        return (np.random.default_rng((7, f, s)).random(shape, np.float32)
                * 2 - 1)

    def rand(f, s):
        r = np.random.default_rng((11, f, s)).random((1, 9), np.float32)
        r[:, 0] = 0
        return r

    # CREPE ran once a file above; the cache's names carry the CLI's floats
    cache = os.path.join(out1, "cache")
    f0_kw = dict(pitch_extractor="crepe", f0_min=50.0, f0_max=1100.0)
    for label, kind in (("fp32", "fp32"), (f"staged bf16 ({CLI_STAGED})",
                                           "bf16")):
        K.reset_launch_counts()
        got = run_inference_batch(
            ckpts[kind], wavs, os.path.join(work, "hooked_" + kind),
            batch_size=BATCH_SIZE, cache_dir=cache, **f0_kw,
            noise_hook=noise, enhancer_rand_hook=rand, output_subtype="FLOAT")
        torch.cuda.synchronize()
        hooked = K.launch_counts()
        expect(label, hooked, staged=kind == "bf16")
        for k, v in hooked.items():
            counts[k] += v
        worst = worst_rms = 0.0
        for fi, wav in enumerate(wavs):
            ref = run_inference(
                ckpts[kind], wav, os.path.join(work, f"single_{kind}_{fi}.wav"),
                cache_dir=cache, **f0_kw,
                noise_hook=lambda i, shape: noise(fi, i, shape),
                enhancer_rand_hook=lambda i: rand(fi, i),
                output_subtype="FLOAT")
            y, r = read_wav(got[fi])[0], read_wav(ref)[0]
            if y.shape != r.shape:
                fail(f"batch {label} {wav}: {y.shape} vs single {r.shape}")
            worst = max(worst, float(np.abs(y - r).max() / np.abs(r).max()))
            worst_rms = max(worst_rms, float(np.sqrt(
                np.mean((y - r) ** 2) / np.mean(r ** 2))))
        if kind == "fp32":
            say(f"batch {label} vs single path, file by file: max|err| "
                f"{worst:.3e} x max|ref| (tolerance 1e-4), rel RMS "
                f"{worst_rms:.3e}")
            ok = worst < 1e-4
        else:
            # the batch's fp32 rounding (other batch sizes, masking) differs
            # from the single path's by ~1e-6 and flips bf16 roundings in
            # the wide stages (2^-8 each): the staged bound, as staged
            # against fp32
            say(f"batch {label} vs single path, file by file: rel RMS "
                f"{worst_rms:.3e} (tolerance 2e-2), max|err| {worst:.3e} x "
                "max|ref|")
            ok = worst_rms < 2e-2
        if not ok:
            fail(f"batch {label} disagrees with the single path")
    for name, t in walls.items():
        say(f"{card}: batch stage {name}: {t * 1e3:.1f} ms")
    say(f"{card}: batch directory, {dur:.3f} audio-s (CREPE f0 included): "
        f"first {first:.2f} s = {dur / first:.2f} audio-s/s, warm "
        f"{warm:.2f} s = {dur / warm:.2f} audio-s/s")
    shutil.rmtree(work, ignore_errors=True)
    return counts


def preprocess_phase(torch, K, card: str, ckpt: str) -> dict:
    """`python -m ddsp_svc_tpu_torch.preprocess -c CFG`'s main on a store of
    2 speakers x 3 clips x 4 s (and one validation clip a speaker) at 44.1
    kHz with configs/combsub.yaml at full width, f0 parselmouth (the native
    NCCF library), the CLI phase's HuBERT-soft on the card: the store's
    layout and f0_stats.npy, the units against the plain path on the CPU
    (1e-4 of max |ref|, tests/test_torch_features.py's HuBERT bound), then
    one trainer step that reads the store. Returns the step's launches."""
    import yaml
    from ddsp_svc_tpu_torch import preprocess as entry
    from ddsp_svc_tpu_torch.data.features import (F0Extractor, UnitsEncoder,
                                                  VolumeExtractor)
    from ddsp_svc_tpu_torch.data.wavio import load_audio
    from ddsp_svc_tpu_torch.train import __main__ as train_main
    from ddsp_svc_tpu_torch.utils.config import load_config

    args = load_config(os.path.join(os.path.dirname(ckpt), "config.yaml"))
    d = args.data
    sr, bs = d.sampling_rate, d.block_size
    work = os.path.join(ROOT, "build", "chip_smoke_preprocess")
    shutil.rmtree(work, ignore_errors=True)
    write_dataset(os.path.join(work, "train"), 2, 3, 4.0, sr, bs,
                  d.encoder_out_channels, 0)
    write_dataset(os.path.join(work, "val"), 2, 1, 4.0, sr, bs,
                  d.encoder_out_channels, 1)
    for split in ("train", "val"):  # keep the audio; the features are made
        for sub in ("units", "f0", "volume"):
            shutil.rmtree(os.path.join(work, split, sub))
        os.remove(os.path.join(work, split, "f0_stats.npy"))
    cfg = json.loads(json.dumps(args))
    cfg["data"].update(f0_extractor="parselmouth",
                       train_path=os.path.join(work, "train"),
                       valid_path=os.path.join(work, "val"))
    cfg["train"].update(interval_log=1, interval_val=1000, epochs=1000)
    cfg["env"]["expdir"] = os.path.join(work, "exp")
    cfg_path = os.path.join(work, "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    t0 = time.perf_counter()
    entry.main(["-c", cfg_path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rels = sorted(os.path.relpath(os.path.join(r, f), os.path.join(work, "train", "audio"))
                  for r, _, fs in os.walk(os.path.join(work, "train", "audio"))
                  for f in fs)
    n_files = len(rels) + 2
    for rel in rels:
        stem = rel[:-len(".wav")]
        for sub, suffix in (("units", ".0.npy"), ("f0", ".npy"),
                            ("f0_stat", ".npy"), ("volume", ".npy")):
            if not os.path.isfile(os.path.join(work, "train", sub, stem + suffix)):
                fail(f"preprocess wrote no {sub}/{stem}{suffix}")
    stats = np.load(os.path.join(work, "train", "f0_stats.npy"),
                    allow_pickle=True).item()
    want = {"1": float(np.log(110.0)), "2": float(np.log(220.0))}
    say(f"preprocess: {len(rels)} training and 2 validation clips, "
        f"f0_stats {json.dumps(stats)} (mean log f0 {json.dumps(want)})")
    if sorted(stats) != ["1", "2"] or any(abs(stats[k] - v) > 0.02
                                          for k, v in want.items()):
        fail("preprocess: f0_stats.npy is off the clips' pitch")
    cpu = UnitsEncoder(d.encoder, d.encoder_ckpt, d.encoder_sample_rate,
                       d.encoder_hop_size, device="cpu")
    worst = 0.0
    for rel in rels:
        audio, _ = load_audio(os.path.join(work, "train", "audio", rel), sr=sr)
        ref = cpu.encode(audio[None], sr, bs)[0]
        got = np.load(os.path.join(work, "train", "units", rel[:-4] + ".0.npy"))
        if got.shape != ref.shape:
            fail(f"preprocess units {rel}: {got.shape} vs {ref.shape}")
        worst = max(worst, float(np.abs(got - ref).max() / np.abs(ref).max()))
    say(f"preprocess units (card) vs the plain path on the CPU: max|err| "
        f"{worst:.3e} x max|ref| (tolerance 1e-4)")
    if not worst < 1e-4:
        fail("the preprocessed units disagree with the CPU's")

    # the stages apart, over the training clips (host clock)
    audios = [load_audio(os.path.join(work, "train", "audio", r), sr=sr)[0]
              for r in rels]
    ext = F0Extractor("parselmouth", sr, bs, d.f0_min, d.f0_max, backend="auto")
    vol = VolumeExtractor(bs)
    enc = UnitsEncoder(d.encoder, d.encoder_ckpt, d.encoder_sample_rate,
                       d.encoder_hop_size, device="cuda")
    stage = {}
    for name, fn in (("native f0 (NCCF, host)", lambda a: ext.extract(a)),
                     ("volume (host)", vol.extract),
                     ("units (HuBERT-soft, device)",
                      lambda a: enc.encode(a[None], sr, bs))):
        t0 = time.perf_counter()
        for a in audios:
            fn(a)
        torch.cuda.synchronize()
        stage[name] = time.perf_counter() - t0
    for name, t in stage.items():
        say(f"{card}: preprocess stage {name}: {t * 1e3:.1f} ms for "
            f"{len(audios)} clips of 4 s")
    say(f"{card}: preprocess total {wall:.2f} s for {n_files} files = "
        f"{n_files / wall:.2f} files/s (4 worker threads, HuBERT load "
        "included)")

    K.reset_launch_counts()
    state, saver = train_main.main(["-c", cfg_path, "--max-steps", "1"])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    with open(os.path.join(saver.expdir, "log_values.jsonl")) as f:
        losses = [json.loads(line).get("train/loss") for line in f]
    losses = [x for x in losses if x is not None]
    say(f"preprocess -> train: one step on the store, loss {losses}, "
        f"launches {json.dumps(counts)}")
    if state.step != 1 or len(losses) != 1 or not np.isfinite(losses).all():
        fail(f"the step on the preprocessed store: step {state.step}, "
             f"losses {losses}")
    if counts["dft_magnitude"] <= 0:
        fail("the step on the preprocessed store launched no dft_magnitude")
    shutil.rmtree(work, ignore_errors=True)
    return counts


# the GAN phase: H_NSF fine-tuned at the train.gan block's defaults (batch 8
# x 32-frame crops); each D or G step runs the generator once: #3 once and
# #4 at each of the three narrow stages
GAN_BATCH, GAN_CROP = 8, 32
GAN_PER_FORWARD = {"harmonic_source": 1, "fused_resblocks_inject": 3}
GAN_TIMED = 5
GAN_LOSS_RTOL = 1e-4
# the device-time split of a G step: the innermost labelled range over each
# op, a backward op taking its forward op's label (by sequence number)
GAN_LABELS = ("discriminators", "mel", "generator", "#3 kernel",
              "#3 plain replay", "#4 kernel", "#4 plain replay")


@contextmanager
def gan_labels(torch, K):
    """Label the G step's parts with torch.profiler ranges: the
    discriminators' scores, the mel, the generator, #3's and #4's launches
    and their plain replays in the backward."""
    from ddsp_svc_tpu_torch.nn import discriminators as D
    from ddsp_svc_tpu_torch.nn import nsf_hifigan
    from ddsp_svc_tpu_torch.train import gan

    def labelled(label, fn):
        def call(*a, **kw):
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        return call

    replay = K._replay_grads

    def labelled_replay(plain, *a):
        name = ("#3" if "harmonic_source" in plain.__qualname__ else "#4")
        with torch.profiler.record_function(name + " plain replay"):
            return replay(plain, *a)

    swaps = [(D.MultiPeriodDiscriminator, "score", "discriminators"),
             (D.MultiScaleDiscriminator, "score", "discriminators"),
             (gan, "mel_of", "mel"),
             (nsf_hifigan.Generator, "forward", "generator"),
             (K, "_harmonic_source_launch", "#3 kernel"),
             (K, "_trio_launch", "#4 kernel")]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in swaps]
    for obj, name, label in swaps:
        setattr(obj, name, labelled(label, getattr(obj, name)))
    K._replay_grads = labelled_replay
    try:
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
        K._replay_grads = replay


def device_split(torch, prof, part_of) -> tuple:
    """Device time of a torch.profiler trace by part: each kernel, memcpy
    and memset event goes to the part `part_of(event)` names. A part's ms
    is the union of its events' intervals (cuDNN runs a grouped conv's
    groups as concurrent kernels on several streams, so a sum would count
    overlapping time twice), and busy the union of all of them. Returns
    ({part: (ms, launches)}, busy ms, the number of streams)."""
    dev = [ev for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(ev, "is_user_annotation", False)]

    def union_ms(intervals) -> float:
        total, end = 0.0, -math.inf
        for start, stop in sorted(intervals):
            total += max(0.0, stop - max(start, end))
            end = max(end, stop)
        return total / 1e3

    parts = {}
    for ev in dev:
        parts.setdefault(part_of(ev), []).append((ev.time_range.start,
                                                  ev.time_range.end))
    busy = union_ms([iv for ivs in parts.values() for iv in ivs])
    streams = len({getattr(ev, "device_resource_id", None) for ev in dev})
    return ({k: (union_ms(iv), len(iv)) for k, iv in parts.items()}, busy,
            streams)


def gan_part_of(torch, prof, labels=GAN_LABELS):
    """device_split's part_of for a GAN step traced under gan_labels: #3's
    and #4's own kernels by name; any other by the op that launched it (the
    CUDA runtime call of the same id, and its parent op), under the
    innermost `labels` range around that op; a backward op (autograd's
    evaluate_function) takes the label of its forward op (same sequence
    number); the optimizer's step is its own; the rest is "other"."""
    cpu = [ev for ev in prof.events()
           if ev.device_type != torch.autograd.DeviceType.CUDA]
    runtime = {ev.id: ev for ev in cpu if ev.name.startswith("cuda")}

    def label_of(ev):
        while ev is not None:
            if ev.name in labels:
                return ev.name
            if ev.name.startswith("Optimizer.step"):
                return "optimizer (AdamW)"
            ev = ev.cpu_parent
        return None

    fwd = {}
    for ev in cpu:
        seq = getattr(ev, "sequence_nr", -1)
        if seq >= 0 and not ev.name.startswith("autograd::engine"):
            lab = label_of(ev)
            if lab is not None:
                fwd.setdefault(seq, lab)

    def part_of(ev):
        low = ev.name.lower()
        if "harmonic_source" in low:
            return "#3 kernel"
        if "resblocks_kernel" in low:
            return "#4 kernel"
        op = runtime.get(ev.id)
        if op is None:
            return "other"
        lab = label_of(op)
        if lab is None:
            while op.cpu_parent is not None and not op.name.startswith(
                    "autograd::engine::evaluate_function"):
                op = op.cpu_parent
            lab = fwd.get(getattr(op, "sequence_nr", -1), "other")
        return lab

    return part_of


def gan_phase(torch, K, card: str, ckpts: dict, device: str = "cuda"
              ) -> dict:
    """Enhancer GAN fine-tuning (`python -m ddsp_svc_tpu_torch.train_gan`)
    at H_NSF's full width, warm-started from the CLI phase's NSF-HiFiGAN,
    on a store of 2 speakers x 3 clips x 4 s (and a validation clip each),
    batch 8 x 32-frame crops: one D step and one G step on the kernels
    against the same on the plain versions (each loss term within 1e-4
    relative, every parameter gradient through grads_agree, #3/#4 at 1/3 a
    step); ms per D, G and D + G step (median of 5 warm) and it/s, peak
    memory, a warm G step's device time by part (torch.profiler); the entry
    in-process: 4 steps validating every 2 (checkpoints, exports,
    config.json), a resume to 6, 2 steps on the device clip pool; then the
    exported model_best.pt converts the CLI phase's wav through the CLI.
    Returns the launch counts of the entry's runs and the conversion."""
    import yaml
    from ddsp_svc_tpu_torch import train_gan as entry
    from ddsp_svc_tpu_torch.data.wavio import read_wav
    from ddsp_svc_tpu_torch.infer import __main__ as cli
    from ddsp_svc_tpu_torch.infer.enhancer import NsfHifiGAN
    from ddsp_svc_tpu_torch.infer.offline import split
    from ddsp_svc_tpu_torch.nn.nsf_hifigan import generator_from_h
    from ddsp_svc_tpu_torch.train import gan as G
    from ddsp_svc_tpu_torch.train.gan_solver import GanDataset
    from ddsp_svc_tpu_torch.utils.config import load_config

    on_card = device != "cpu"
    exp_cli = os.path.dirname(ckpts["fp32"])
    args = load_config(os.path.join(exp_cli, "config.yaml"))
    nsf_ckpt = args.enhancer.ckpt
    d = args.data
    sr, bs = d.sampling_rate, d.block_size
    work = os.path.join(ROOT, "build", "chip_smoke_gan")
    shutil.rmtree(work, ignore_errors=True)
    write_dataset(os.path.join(work, "train"), 2, 3, 4.0, sr, bs,
                  d.encoder_out_channels, 0)
    write_dataset(os.path.join(work, "val"), 2, 1, 4.0, sr, bs,
                  d.encoder_out_channels, 1)
    with open(os.path.join(os.path.dirname(nsf_ckpt), "config.json")) as f:
        h = json.load(f)
    upp = math.prod(h["upsample_rates"])
    say(f"GAN path: NSF-HiFiGAN initial channel "
        f"{h['upsample_initial_channel']}, upsample {h['upsample_rates']} "
        f"(warm start: the CLI phase's checkpoint), MPD periods 2/3/5/7/11 + "
        f"MSD x 3; batch {GAN_BATCH} x {GAN_CROP} frames = "
        f"{GAN_CROP * upp} samples; store 2 speakers x 3 clips x 4 s at "
        f"{sr} Hz")

    # one D step and one G step on the kernels against the plain versions,
    # each from the same fresh state, batch and rand_ini
    ds = GanDataset(os.path.join(work, "train"), h, sr, bs)
    batch = {k: torch.as_tensor(v, device=device) for k, v in
             ds.sample_batch(np.random.default_rng(0), GAN_BATCH,
                             GAN_CROP).items()}
    batch["mel"] = G.mel_of(h, batch["audio"]).transpose(1, 2)
    rand_ini = torch.rand((GAN_BATCH, 9), generator=torch.Generator(
        device=device).manual_seed(3), device=device)
    rand_ini[:, 0] = 0.0
    warm = NsfHifiGAN(nsf_ckpt, device="cpu").model.state_dict()

    def fresh():
        g = generator_from_h(h)
        g.load_state_dict(warm)
        trainer = G.GanTrainer(h)
        return trainer, trainer.create_state(g.to(device), seed=0)

    runs = {}
    for plain in (False, True):
        with plain_kernels(K) if plain else nullcontext():
            trainer, st_d = fresh()
            K.reset_launch_counts()
            d_logs = trainer.step_d(st_d, batch, rand_ini)
            counts_d = K.launch_counts()
            trainer, st_g = fresh()
            K.reset_launch_counts()
            g_logs = trainer.step_g(st_g, batch, rand_ini)
            counts_g = K.launch_counts()
        runs[plain] = (st_d, st_g, {**d_logs, **g_logs}, counts_d, counts_g)
    (kd, kg, k_logs, counts_d, counts_g) = runs[False]
    (pd, pg, p_logs, _, _) = runs[True]
    if on_card:
        for label, counts in (("D", counts_d), ("G", counts_g)):
            want = {k: GAN_PER_FORWARD.get(k, 0) for k in counts}
            if counts != want:
                fail(f"the GAN {label} step launched {json.dumps(counts)}, "
                     f"expected {json.dumps(want)}")
    for k, v in k_logs.items():
        ref = float(p_logs[k])
        rel = abs(float(v) - ref) / abs(ref)
        say(f"GAN step {k}, kernels vs plain versions: {float(v):.6f} vs "
            f"{ref:.6f} (rel {rel:.2e}, tolerance {GAN_LOSS_RTOL})")
        if not rel < GAN_LOSS_RTOL:
            fail(f"the GAN step's {k} disagrees with the plain versions")
    tol_rel, tol_cos = 2e-2, 1 - 1e-4  # the train phase's bounds
    for label, mk, mp in (("D step mpd", kd.mpd, pd.mpd),
                          ("D step msd", kd.msd, pd.msd),
                          ("G step generator", kg.generator, pg.generator)):
        worst_rel, worst_cos = grads_agree(f"GAN {label}", mk, mp, tol_rel,
                                           tol_cos)
        say(f"GAN {label}, kernels vs plain versions: worst parameter "
            f"gradient rel {worst_rel:.3e} (< {tol_rel}), cos "
            f"{worst_cos:.7f} (> {tol_cos})")
    if any(p.grad is not None for p in kd.generator.parameters()):
        fail("the GAN D step formed gradients of the generator")
    if any(p.grad is not None for p in kg.d_parameters()):
        fail("the GAN G step formed gradients of the discriminators")
    del runs, pd, pg, kd, kg
    if on_card:
        g_step_leaves(torch, K, G, fresh, batch, rand_ini, generator_from_h,
                      h, warm)

    # ms per step on the kernels (host clock around synchronised steps)
    trainer, st = fresh()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    d_ms, g_ms = [], []
    for _ in range(GAN_TIMED + 1):
        for fn, times in ((trainer.step_d, d_ms), (trainer.step_g, g_ms)):
            t0 = time.perf_counter()
            fn(st, batch)
            if on_card:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    dg = [a + b for a, b in zip(d_ms[1:], g_ms[1:])]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0
    say(f"{card}: GAN D step {np.median(d_ms[1:]):.1f} ms, G step "
        f"{np.median(g_ms[1:]):.1f} ms, D + G {np.median(dg):.1f} ms = "
        f"{1e3 / np.median(dg):.2f} it/s (median of {GAN_TIMED} warm; batch "
        f"{GAN_BATCH} x {GAN_CROP * upp} samples; first D + G "
        f"{d_ms[0] + g_ms[0]:.1f} ms); peak memory {peak:.2f} GiB")
    from torch.profiler import ProfilerActivity, profile
    for label, fn in (("D", trainer.step_d), ("G", trainer.step_g)):
        with gan_labels(torch, K):
            fn(st, batch)
            if on_card:
                torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if on_card else [])) as prof:
                t0 = time.perf_counter()
                fn(st, batch)
                if on_card:
                    torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        by_part, busy, streams = device_split(torch, prof,
                                              gan_part_of(torch, prof))
        parts = {k: ms for k, (ms, _) in by_part.items()}
        total = sum(parts.values())
        say(f"{card}: GAN {label} step device time by part (torch.profiler, "
            f"one warm step): busy {busy:.2f} ms of a {wall:.2f} ms traced "
            f"wall (idle share {1 - busy / wall:.3f}; kernels on {streams} "
            f"streams); the parts sum to {total:.2f} ms: " + ", ".join(
                f"{k} {v:.2f} ({100 * v / max(total, 1e-9):.1f} %)"
                for k, v in sorted(parts.items(), key=lambda kv: -kv[1])))
    del st, trainer

    # the entry in-process: 4 steps validating every 2, a resume to 6, then
    # 2 steps on the device clip pool
    def config_file(name: str, **gan) -> str:
        cfg = json.loads(json.dumps(args))
        cfg["data"].update(train_path=os.path.join(work, "train"),
                           valid_path=os.path.join(work, "val"))
        cfg["train"]["gan"] = {"expdir": os.path.join(work, name),
                               "batch_size": GAN_BATCH,
                               "crop_frames": GAN_CROP, "interval_log": 1,
                               "interval_val": 2, **gan}
        path = os.path.join(work, name + ".yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return path

    launches = {}

    def run(cfg_path: str, steps: int, start: int, label: str):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        argv = ["-c", cfg_path, "--max-steps", str(steps)]
        state, expdir = entry.main(argv + ([] if on_card else
                                           ["--device", "cpu"]))
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        n_val = sum(1 for n in range(start + 1, steps + 1)
                    if n % 2 == 0 or n == steps)
        forwards = 2 * (steps - start) + n_val
        say(f"GAN entry {label}: steps {start} -> {state.step} in {wall:.1f} "
            f"s ({n_val} validations and checkpoints included); launches "
            f"{json.dumps(counts)}")
        if state.step != steps:
            fail(f"GAN entry {label} ended at step {state.step}")
        if on_card:
            want = {k: GAN_PER_FORWARD.get(k, 0) * forwards for k in counts}
            if counts != want:
                fail(f"GAN entry {label} launched {json.dumps(counts)}, "
                     f"expected {json.dumps(want)}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return expdir

    cfg = config_file("gan")
    expdir = run(cfg, 4, 0, "4 steps")
    enh_dir = os.path.join(expdir, "enhancer")
    for path in ("gan_2.pt", "gan_4.pt", "enhancer/model_2.pt",
                 "enhancer/model_4.pt", "enhancer/model_best.pt"):
        if not os.path.isfile(os.path.join(expdir, path)):
            fail(f"the GAN entry wrote no {path}")
    with open(os.path.join(enh_dir, "config.json")) as f:
        if json.load(f) != h:
            fail("the GAN export's config.json is not h")
    run(cfg, 6, 4, "resumed from gan_4.pt")
    if not os.path.isfile(os.path.join(expdir, "gan_6.pt")):
        fail("the resumed GAN run wrote no gan_6.pt")
    pool_dir = run(config_file("gan_pool", data_on_device=True), 2, 0,
                   "on the device clip pool")
    shutil.rmtree(pool_dir, ignore_errors=True)

    # the fine-tuned enhancer converts the CLI phase's wav through the CLI
    exp = os.path.join(work, "exp_convert")
    os.makedirs(exp)
    shutil.copy(ckpts["fp32"], os.path.join(exp, "model_0.pt"))
    cfg_c = json.loads(json.dumps(args))
    cfg_c["enhancer"]["ckpt"] = os.path.join(enh_dir, "model_best.pt")
    with open(os.path.join(exp, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg_c, f)
    wav = os.path.join(os.path.dirname(exp_cli), "in.wav")
    audio, _ = read_wav(wav)
    n_seg = len(split(audio, sr, bs))
    out = os.path.join(work, "converted.wav")
    K.reset_launch_counts()
    cli.main(["-m", os.path.join(exp, "model_0.pt"), "-i", wav, "-o", out,
              "-pe", "dio", "-e", "true"]
             + ([] if on_card else ["--device", "cpu"]))
    counts = K.launch_counts()
    y, sr_o = read_wav(out)
    say(f"GAN export through the CLI: {y.shape[-1]} samples at {sr_o} Hz "
        f"(input {len(audio)}), {n_seg} segments, launches "
        f"{json.dumps(counts)}")
    if not (sr_o == sr and abs(y.shape[-1] - len(audio)) <= bs
            and np.isfinite(y).all() and np.abs(y).max() > 0):
        fail("the fine-tuned enhancer's conversion is not a finite wav of "
             "the input's length")
    if on_card:
        for name, per in GAN_PER_FORWARD.items():
            if counts[name] != per * n_seg:
                fail(f"the conversion launched {name} {counts[name]} times, "
                     f"expected {per} per segment x {n_seg}")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    shutil.rmtree(work, ignore_errors=True)
    return launches


# the streaming phase: a 10.8 s sung wav (two phrases split by 0.5 s of
# silence) through gui.py's defaults, and the incremental engine's blocks
STREAM_PHRASES = (5.0, 5.3)
STREAM_PER_WINDOW = {"performer_attention": 3, "combsub_spectral": 1,
                     "harmonic_source": 1, "fused_resblocks_inject": 3}
# StreamingSession's own arguments among StreamConfig.session_kwargs()'s;
# the rest go to SvcCore.infer
STREAM_SESSION_KEYS = ("samplerate", "block_time", "crossfade_time",
                       "buffer_num", "use_phase_vocoder", "pipeline_depth")
INC_FRAMES_PER_BLOCK = 26
INC_BATCH_FRAMES = 64


def _percentiles(walls) -> str:
    ms = np.asarray(walls) * 1e3
    return (f"p50 {np.percentile(ms, 50):.1f} / p95 {np.percentile(ms, 95):.1f}"
            f" / max {ms.max():.1f} ms")


def stream_phase(torch, K, card: str, ckpts: dict, device: str = "cuda"
                 ) -> dict:
    """Streaming conversion at configs/combsub.yaml's full width with the
    CLI phase's checkpoints (HuBERT-soft, H_NSF). SOLA: the sung wav through
    `python -m ddsp_svc_tpu_torch.stream`'s session with gui.py's defaults
    (44.1 kHz, blocks of 0.3 s, crossfade 0.04, buffer 2, dio, the enhancer
    on in fp32), with injected noise and SineGen phases, at pipeline_depth 0,
    at depth 1 (bit for bit depth 0's blocks, one block late) and on the
    plain versions (each window within 1e-3 of max |ref|; the spliced
    blocks where the SOLA shifts agree); #1-#4 at 3/1/1/3 a window; the
    per-block walls against the 300 ms block and one warm window's stages.
    Incremental: a causal + frame_norm model_0.pt from a seed through
    `IncrementalSession` (26 frames a block, dio): its recorded features
    replayed through a fresh engine (atol 2e-5), the engine against the
    model's batch forward on 64 frames (1e-3 of max |ref|; the forward
    launches #2 once, #1 never), the per-block walls and the CUDA launches
    a frame (torch.profiler, one warm block). Returns the launch counts of
    the two SOLA runs on the kernels."""
    import yaml
    from ddsp_svc_tpu_torch import stream as entry
    from ddsp_svc_tpu_torch.infer.realtime import IncrementalSession
    from ddsp_svc_tpu_torch.infer.streaming import StreamingSession, SvcCore
    from ddsp_svc_tpu_torch.models.factory import build_model
    from ddsp_svc_tpu_torch.models.incremental import IncrementalCombSubFast
    from ddsp_svc_tpu_torch.train.checkpoint import save_checkpoint
    from ddsp_svc_tpu_torch.utils.config import load_config

    # ---- SOLA ----
    cfg = entry.effective_config(entry.parse_args(["-m", ckpts["fp32"]]))
    sr = cfg.samplerate
    audio = sung_wav(sr, seed=2, phrases=STREAM_PHRASES)
    core = SvcCore(cfg.checkpoint_path, device=device)
    bs = int(core.args.data.block_size)
    rng = np.random.default_rng(11)
    noises, rand_inis = {}, {}

    def noise_hook(step, shape):
        if step not in noises:
            noises[step] = (rng.random(shape) * 2 - 1).astype(np.float32)
        return noises[step]

    def rand_hook(step):
        if step not in rand_inis:
            rand_inis[step] = rng.random((1, 9)).astype(np.float32)
            rand_inis[step][:, 0] = 0.0
        return rand_inis[step]

    infer = core.infer
    windows = []

    def recording(*a, **kw):
        out = infer(*a, **kw)
        if kw.get("materialize", True):
            windows.append(out[0].copy())
        return out

    core.infer = recording

    def run(depth, label, plain=False):
        core._step = 0
        windows.clear()
        sess = StreamingSession(core, noise_hook=noise_hook,
                                enhancer_rand_hook=rand_hook,
                                **dict(cfg.session_kwargs(),
                                       pipeline_depth=depth))
        bf = sess.block_frame
        n_blocks = len(audio) // bf
        outs, walls = [], []
        K.reset_launch_counts()
        with plain_kernels(K) if plain else nullcontext():
            for i in range(n_blocks):
                t0 = time.perf_counter()
                outs.append(sess.process_block(audio[i * bf:(i + 1) * bf]))
                walls.append(time.perf_counter() - t0)
            outs += sess.flush()
        torch.cuda.synchronize()
        counts = K.launch_counts()
        y = np.concatenate(outs)
        if not (all(o.shape == (bf,) for o in outs) and np.isfinite(y).all()
                and np.sqrt(np.mean(y ** 2)) > 0):
            fail(f"SOLA {label}: blocks of {set(o.shape for o in outs)}, "
                 f"finite {np.isfinite(y).all()}")
        say(f"{card}: SOLA {label}: {n_blocks} blocks of {bf} samples "
            f"({bf / sr * 1e3:.0f} ms): first {walls[0] * 1e3:.1f} ms, warm "
            f"{_percentiles(walls[1:])}; launches {json.dumps(counts)}")
        return outs, list(sess.shifts), counts, n_blocks, list(windows), sess

    n_frames = int(cfg.block_time * sr * (1 + cfg.buffer_num)) // bs + 1
    say(f"SOLA path: {len(audio) / sr:.3f} s wav at {sr} Hz; gui.py's "
        f"defaults (block {cfg.block_time} s, crossfade {cfg.crossfade_time}"
        f" s, buffer {cfg.buffer_num}, {cfg.pitch_extractor}, enhancer on, "
        f"fp32): windows of {n_frames} frames in the "
        f"{max(32, 1 << (n_frames - 1).bit_length())}-frame bucket, masked "
        "to its own length")
    outs0, shifts0, counts0, n_blocks, win0, sess0 = run(0, "pipeline_depth 0")
    for name, per in STREAM_PER_WINDOW.items():
        if counts0[name] != per * n_blocks:
            fail(f"SOLA launched {name} {counts0[name]} times, expected "
                 f"{per} a window x {n_blocks}")
    outs1, _, counts1, _, _, _ = run(1, "pipeline_depth 1")
    if not (len(outs1) == len(outs0) + 1 and not outs1[0].any() and all(
            np.array_equal(a, b) for a, b in zip(outs0, outs1[1:]))):
        fail("SOLA pipeline_depth 1 is not depth 0's stream, one block late")
    say("SOLA pipeline_depth 1 = depth 0 bit for bit, one block late")
    outs_p, shifts_p, _, _, win_p, _ = run(0, "on the plain versions",
                                           plain=True)
    err = max(float(np.abs(g - r).max() / np.abs(r).max())
              for g, r in zip(win0, win_p))
    agree = 0
    while agree < len(shifts0) and shifts0[agree] == shifts_p[agree]:
        agree += 1
    same = sum(a == b for a, b in zip(shifts0, shifts_p))
    scale = max(float(np.abs(r).max()) for r in outs_p)
    splice_err = max([float(np.abs(g - r).max()) for g, r in
                      zip(outs0[:agree], outs_p[:agree])] or [0.0])
    say(f"SOLA kernels vs plain versions: each window max|err| <= "
        f"{err:.3e} x its max|ref| (tolerance 1e-3); SOLA shifts agree on "
        f"{same} of {len(shifts0)} blocks ({agree} from the start); spliced "
        f"blocks there max|err| {splice_err / scale:.3e} x max|ref| "
        f"(tolerance 1e-3)")
    if not (err <= 1e-3 and splice_err <= 1e-3 * scale):
        fail("the SOLA path disagrees with the plain versions")
    fused_counts = fused_window_runs(torch, K, card, cfg, audio, core, infer,
                                     noise_hook, rand_hook, device)

    # one warm window's stages (host clock, the device synchronised at each)
    walls = {}
    res = infer(sess0.input_wav, sr, walls=walls,
                safe_prefix_pad_length=sess0.safe_prefix_pad_length,
                **{k: v for k, v in cfg.session_kwargs().items()
                   if k not in STREAM_SESSION_KEYS})
    t0 = time.perf_counter()
    sess0._splice(*res)
    walls["splice"] = time.perf_counter() - t0
    say(f"{card}: SOLA warm window stages: " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in walls.items()))

    # ---- incremental ----
    work = os.path.dirname(os.path.dirname(ckpts["fp32"]))
    exp = os.path.join(work, "exp_causal")
    os.makedirs(exp, exist_ok=True)
    args = load_config(os.path.join(os.path.dirname(ckpts["fp32"]),
                                    "config.yaml"))
    args["model"]["c"] = True
    args["model"]["frame_norm"] = True
    with open(os.path.join(exp, "config.yaml"), "w") as f:
        yaml.safe_dump(json.loads(json.dumps(args)), f)
    ckpt = os.path.join(exp, "model_0.pt")
    save_checkpoint(ckpt, 0, build_model(args, device="cpu", seed=3))
    sess = IncrementalSession.from_checkpoint(
        ckpt, device=device, frames_per_block=INC_FRAMES_PER_BLOCK,
        f0_extractor="dio", record=True)
    n = sess.block_samples
    inc_audio = audio[: (len(audio) // n) * n]
    outs, walls = [], []
    for i in range(len(inc_audio) // n):
        t0 = time.perf_counter()
        outs.append(sess.process_block(inc_audio[i * n:(i + 1) * n]))
        walls.append(time.perf_counter() - t0)
    outs.append(sess.flush())
    y = np.concatenate(outs)
    if not (y.shape == (len(inc_audio) + 2 * bs,) and np.isfinite(y).all()
            and np.abs(y).max() > 0):
        fail(f"incremental stream: shape {y.shape}, finite "
             f"{np.isfinite(y).all()}")
    say(f"{card}: incremental path (causal + frame_norm CombSubFast, "
        f"{INC_FRAMES_PER_BLOCK} frames = {n} samples = "
        f"{n / sr * 1e3:.1f} ms a block, lookahead "
        f"{sess.lookahead_frames} frames, context {sess.ctx_frames}): "
        f"{len(walls)} blocks, first {walls[0] * 1e3:.1f} ms, warm "
        f"{_percentiles(walls[1:])}")
    eng = IncrementalCombSubFast(sess.engine.model)
    raw, _ = eng.process(eng.init_state(np.asarray([[1]])), *(
        np.concatenate(sess.recorded[k], axis=1)
        for k in ("units", "f0", "volume", "noise")))
    replay = raw.cpu().numpy()[0] * np.concatenate(sess.recorded["mask"])
    rep_err = float(np.abs(np.concatenate(outs[:-1]) - replay).max())
    say(f"incremental session vs its features replayed through the engine: "
        f"max|err| {rep_err:.3e} (tolerance atol 2e-5)")
    if not rep_err <= 2e-5:
        fail("the incremental session disagrees with its replay")

    model = sess.engine.model
    g = np.random.default_rng(12)
    f = INC_BATCH_FRAMES
    units = g.standard_normal((1, f, model.unit2ctrl.unit_prenet["1"]
                               .in_channels)).astype(np.float32)
    f0 = (150 + 250 * g.random((1, f, 1))).astype(np.float32)
    volume = g.random((1, f)).astype(np.float32)
    noise = (g.random((1, f * bs)) * 2 - 1).astype(np.float32)
    spk = np.asarray([[1]], np.int64)
    dev = [torch.as_tensor(a, device=device) for a in
           (units, f0, volume, spk, noise)]
    K.reset_launch_counts()
    with torch.no_grad():
        ref = model(*dev[:4], infer=True, noise=dev[4])[0].cpu().numpy()
    counts = K.launch_counts()
    shifted = np.zeros_like(noise)
    shifted[:, bs:] = noise[:, :-bs]
    got, st = eng.process(eng.init_state(spk), units, f0[:, :, 0], volume,
                          shifted)
    tail, _ = eng.flush(st, noise_last=noise[:, -bs:])
    got = torch.cat([got, tail], -1).cpu().numpy()[:, 2 * bs:]
    inc_err = float(np.abs(got - ref).max() / np.abs(ref).max())
    say(f"incremental engine vs the batch forward on the card ({f} frames): "
        f"max|err| {inc_err:.3e} x max|ref| (tolerance 1e-3); the forward "
        f"launched combsub_spectral {counts['combsub_spectral']} and "
        f"performer_attention {counts['performer_attention']} times "
        "(expected 1 and 0)")
    if not (inc_err <= 1e-3 and counts["combsub_spectral"] == 1
            and counts["performer_attention"] == 0):
        fail("the incremental engine or the causal batch forward is off")

    # CUDA launches a frame over one warm block of the engine
    from torch.profiler import ProfilerActivity, profile
    blk = [np.concatenate(sess.recorded[k], axis=1)[
        :, :INC_FRAMES_PER_BLOCK * (bs if k == "noise" else 1)]
        for k in ("units", "f0", "volume", "noise")]
    st = eng.init_state(spk)
    eng.process(st, *blk)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.process(st, *blk)
        torch.cuda.synchronize()
    runtime = sum(e.count for e in prof.key_averages()
                  if "LaunchKernel" in e.key or e.key == "cudaMemcpyAsync")
    kernels = sum(1 for e in prof.events()
                  if e.device_type.name == "CUDA")
    t0 = time.perf_counter()
    eng.process(st, *blk)
    torch.cuda.synchronize()
    block_ms = (time.perf_counter() - t0) * 1e3
    say(f"{card}: incremental engine, one warm block of "
        f"{INC_FRAMES_PER_BLOCK} frames: {block_ms:.1f} ms (profiler off); "
        f"torch.profiler: {runtime} launch and copy calls on the host = "
        f"{runtime / INC_FRAMES_PER_BLOCK:.1f} a frame, {kernels} device "
        f"events = {kernels / INC_FRAMES_PER_BLOCK:.1f} a frame")
    return {k: counts0[k] + counts1[k] + fused_counts[k] for k in counts0}


def fused_window_runs(torch, K, card, cfg, audio, core, infer, noise_hook,
                      rand_hook, device) -> dict:
    """The SOLA stream again, at adaptive key 0, through the eager core and
    a SvcCore(fused_window=True) (one CUDA graph per window shape), both
    with cuDNN deterministic and the same noise and SineGen phases: each
    fused window within 1e-6 x max|ref| of the eager one (the spread of
    two eager runs without cuDNN deterministic printed beside it); #1-#4
    counted 3/1/1/3 at each replay; the block walls, the capture's time,
    and one window's launch calls and idle share (torch.profiler) of both.
    Returns the fused run's launch counts."""
    from ddsp_svc_tpu_torch.infer.streaming import StreamingSession, SvcCore

    fused = SvcCore(cfg.checkpoint_path, device=device, fused_window=True)
    kw = dict(cfg.session_kwargs(), enhancer_adaptive_key=0,
              pipeline_depth=0)

    def stream(c, call):
        c._step = 0
        windows, walls = [], []
        sess = StreamingSession(c, noise_hook=noise_hook,
                                enhancer_rand_hook=rand_hook, **kw)

        def recording(*a, **k):
            out = call(*a, **k)
            windows.append(out[0].copy())
            return out

        c.infer = recording
        bf = sess.block_frame
        K.reset_launch_counts()
        try:
            for i in range(len(audio) // bf):
                t0 = time.perf_counter()
                sess.process_block(audio[i * bf:(i + 1) * bf])
                walls.append(time.perf_counter() - t0)
        finally:
            del c.infer
        torch.cuda.synchronize()
        return windows, walls, K.launch_counts(), sess

    saved = core.infer
    del core.infer  # the recording wrapper of the SOLA runs
    det = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = False
        spread_a, _, _, _ = stream(core, core.infer)
        torch.backends.cudnn.deterministic = True
        ref, walls_e, _, sess = stream(core, core.infer)
        got, walls_f, counts, _ = stream(fused, fused.infer)
        spread_b, _, _, _ = stream(core, core.infer)
        torch.backends.cudnn.deterministic = False
        spread_c, _, _, _ = stream(core, core.infer)
        torch.backends.cudnn.deterministic = True
        window_kw = dict(safe_prefix_pad_length=sess.safe_prefix_pad_length,
                         **{k: v for k, v in kw.items()
                            if k not in STREAM_SESSION_KEYS})
        prof = {}
        for label, c in (("eager", core), ("fused", fused)):
            prof[label] = profile_dispatch(
                torch, lambda: c.infer(sess.input_wav, cfg.samplerate,
                                       **window_kw), 1)
    finally:
        torch.backends.cudnn.deterministic = det
        core.infer = saved
    n = len(ref)
    err = max(float(np.abs(g - r).max() / np.abs(r).max())
              for g, r in zip(got, ref))
    det_spread = max(float(np.abs(g - r).max() / np.abs(r).max())
                     for g, r in zip(spread_b, ref))
    spread = max(float(np.abs(g - r).max() / np.abs(r).max())
                 for g, r in zip(spread_a, spread_c))
    bad = {k: counts[k] for k, per in STREAM_PER_WINDOW.items()
           if counts[k] != per * n}
    captures = [p.capture_s for p in fused._windows.values()]
    say(f"{card}: SOLA fused window (SvcCore(fused_window=True), adaptive "
        f"key 0, one CUDA graph per window shape: {len(captures)} shape(s), "
        f"capture {', '.join(f'{t * 1e3:.1f}' for t in captures)} ms with "
        f"its warm-up): {n} windows vs the eager core's, cuDNN "
        f"deterministic: max|err| {err:.3e} x max|ref| (tolerance 1e-6); "
        f"two eager runs deterministic {det_spread:.3e}, default cuDNN "
        f"{spread:.3e}; launches {json.dumps(counts)}")
    say(f"{card}: SOLA block walls, eager {_percentiles(walls_e[1:])}; "
        f"fused {_percentiles(walls_f[1:])} (first {walls_f[0] * 1e3:.1f} "
        "ms, the capture)")
    for label, (calls, copies, idle) in prof.items():
        say(f"{card}: SOLA one window, {label}: {calls:.0f} CUDA launch calls"
            f", {copies:.0f} memcpy calls, device idle share {idle:.3f} "
            "(torch.profiler)")
    if bad or not err <= 1e-6:
        fail(f"the fused window: err {err:.3e}, launches off {bad}")
    return counts


# the serving phase: the synthesizers exported at 512 frames and the op
# nodes each graph holds; ExportedSynth's windows overlap by 8 frames
SERVE_FRAMES = 512
EXPORTS = (("CombSubFast", "combsub.yaml",
            {"performer_attention": 3, "combsub_spectral": 1}),
           ("Sins", "sins.yaml", {"performer_attention": 3,
                                  "oscillator_bank": 1,
                                  "ltv_fir_convolve": 2}),
           ("CombSub", "combsub-old.yaml",
            {"performer_attention": 3, "ltv_fir_convolve": 3}))
SERVE_PER_WINDOW = {"performer_attention": 3, "combsub_spectral": 1}
# one API request is one SvcCore window: the synth, and with the enhancer
# its source and three narrow stages
API_PER_REQUEST = {True: STREAM_PER_WINDOW,
                   False: {"performer_attention": 3, "combsub_spectral": 1,
                           "harmonic_source": 0, "fused_resblocks_inject": 0}}
PCM16 = 1.0 / 32767


def _pcm16(audio, sr: int) -> np.ndarray:
    """audio as a PCM16 wav carries it."""
    from ddsp_svc_tpu_torch.data.wavio import read_wav_bytes, wav_bytes
    return read_wav_bytes(wav_bytes(audio, sr))[0]


@contextmanager
def http_server(handler):
    """A ThreadingHTTPServer on 127.0.0.1:0 serving in a thread; yields its
    port and shuts it down after."""
    import threading
    from http.server import ThreadingHTTPServer
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        thread.join()


def http(port: int, path: str, body=None, timeout: float = 300):
    """(status, body) of a GET, or of a POST of `body`."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def export_checks(torch, K, synth: str, ckpt: str, expect, card: str,
                  device: str = "cuda"):
    """Export a checkpoint's synthesizer at SERVE_FRAMES on the card, load
    it back, count its ddsp_svc op nodes, and hold a replay against the
    eager model on the kernels and on the plain versions. Returns (path,
    the replay's launch counts)."""
    from ddsp_svc_tpu_torch.export import export_synth
    from ddsp_svc_tpu_torch.models.factory import load_model

    out = os.path.join(os.path.dirname(ckpt), "model.pt2")
    t0 = time.perf_counter()
    export_synth(ckpt, out, frames=SERVE_FRAMES, device=device)
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    program = torch.export.load(out)
    forward = program.module()
    t_load = time.perf_counter() - t0
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    ops = {t.split(".")[1]: targets.count(t) for t in set(targets)
           if t.startswith("ddsp_svc.")}
    if ops != expect:
        fail(f"exported {synth}: op nodes {ops}, expected {expect}")
    model, args = load_model(ckpt, device=device)
    bs, n_unit = int(args.data.block_size), int(args.data.encoder_out_channels)
    g = np.random.default_rng(21)
    f = SERVE_FRAMES
    x = [torch.as_tensor(a, device=device) for a in (
        g.standard_normal((1, f, n_unit)).astype(np.float32),
        (150 + 250 * g.random((1, f, 1))).astype(np.float32),
        g.random((1, f)).astype(np.float32), np.ones((1, 1), np.int64),
        (g.random((1, f * bs)) * 2 - 1).astype(np.float32))]
    with torch.no_grad():
        forward(*x)  # warm
        sync(torch, device)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        got = forward(*x)
        sync(torch, device)
        t_call = time.perf_counter() - t0
        counts = K.launch_counts()
        eager = model(*x[:4], infer=True, noise=x[4])[0]
        with plain_kernels(K):
            plain = model(*x[:4], infer=True, noise=x[4])[0]
    for name, n in expect.items():
        if counts[name] != n:
            fail(f"exported {synth}: a call launched {name} {counts[name]} "
                 f"times, expected {n}")
    scale = plain.abs().max().item()
    e_k = (got - eager).abs().max().item() / eager.abs().max().item()
    e_p = (got - plain).abs().max().item() / scale
    say(f"{card}: exported {synth} ({SERVE_FRAMES} frames, n_unit {n_unit}, "
        f"{os.path.getsize(out)} bytes): export {t_export:.2f} s, load "
        f"{t_load:.2f} s, one call {t_call * 1e3:.2f} ms; op nodes "
        f"{json.dumps(ops)}; a call's launches {json.dumps(counts)}; vs "
        f"eager on the kernels {e_k:.3e} x max|ref| (tolerance 1e-6), vs "
        f"eager on the plain versions {e_p:.3e} x max|ref| (tolerance 1e-3)")
    if not (torch.isfinite(got).all() and e_k <= 1e-6 and e_p <= 1e-3):
        fail(f"exported {synth} disagrees with its eager model")
    return out, counts


def sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


# the mesh phase: world size 1 over NCCL, then 2 ranks sharing the card over
# Gloo (NCCL refuses two ranks on one card); each rank's kernels on the
# time-parallel path, and SvcCore.infer's arguments
MESH_RUNS = (("nccl", 1), ("gloo", 2))
MESH_KERNELS = ("performer_attention_moments", "performer_attention_apply",
                "combsub_spectral", "harmonic_source", "fused_resblocks_inject",
                "performer_attention_moments_mxu_bf16",
                "performer_attention_apply_mxu_bf16",
                "combsub_spectral_mxu_bf16")
MESH_INFER = dict(pitch_extractor_type="dio", enhancer_adaptive_key=0)
MESH_STAGES = ("synth", "synth bf16", "enhance fp32", "enhance staged",
               "SvcCore.infer")


def mesh_calls(torch, d: dict, synths: dict, enhancers: dict, core):
    """The mesh phase's five calls on the job's inputs `d`, each timed on the
    host around a synchronize: the bucketed synth fp32 and model.bf16 (the
    split attention's and #2's bf16-operand forms), the enhancer fp32 and
    staged bf16 on the reference synth's output, and a whole SvcCore
    window. Returns ({stage: output on the CPU}, {stage: seconds})."""
    outs, walls = {}, {}
    synth_out = torch.as_tensor(d["synth_ref"], device=d["device"])

    def timed(name, fn):
        sync(torch, d["device"])
        t0 = time.perf_counter()
        y = fn()
        sync(torch, d["device"])
        walls[name] = time.perf_counter() - t0
        outs[name] = torch.as_tensor(y).float().cpu().reshape(-1)

    for stage, synth in synths.items():
        timed(stage, lambda synth=synth: synth(
            d["units"], d["f0"], d["volume"], d["spk"], noise=d["noise"]))
    for kind, enh in enhancers.items():
        timed(f"enhance {kind}", lambda enh=enh: enh.enhance(
            synth_out, d["sr"], d["f0"], d["block"], adaptive_key=0,
            rand_ini=d["rand_ini"])[0])
    core._step = 0
    timed("SvcCore.infer", lambda: core.infer(d["audio"], d["sr"],
                                              **MESH_INFER)[0])
    return outs, walls


def mesh_models(d: dict, mesh=None):
    """The bucketed synths (fp32, and model.bf16 on the same weights), the
    two enhancers and a SvcCore of the job's checkpoints, time-sharded over
    `mesh` (None: unsharded)."""
    from ddsp_svc_tpu_torch.infer.enhancer import Enhancer
    from ddsp_svc_tpu_torch.infer.streaming import SvcCore
    from ddsp_svc_tpu_torch.models.factory import (build_model, load_model,
                                                   make_bucketed_synth)
    from ddsp_svc_tpu_torch.utils.config import DotDict

    dev = d["device"]
    model, args = load_model(d["ckpt"], device=dev)
    args16 = DotDict(json.loads(json.dumps(args)))
    args16["model"]["bf16"] = True
    model16 = build_model(args16, device=dev)
    model16.load_state_dict(model.state_dict())
    enhancers = {kind: Enhancer("nsf-hifigan", d["nsf"], device=dev,
                                bf16_min_channels=threshold, mesh=mesh)
                 for kind, threshold in (("fp32", 0), ("staged", CLI_STAGED))}
    return ({"synth": make_bucketed_synth(model, mesh=mesh),
             "synth bf16": make_bucketed_synth(model16, mesh=mesh)},
            enhancers, SvcCore(d["ckpt"], device=dev, mesh=mesh))


def mesh_rank(rank: int, world: int, backend: str, port: int, job: str):
    """One rank of the mesh phase, spawned: joins `world` ranks on the job's
    device (cuda:0 for every rank) over `backend`, runs mesh_calls once to
    warm up and once with the launch counts from 0, and saves its outputs,
    walls and counts."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ddsp_svc_tpu_torch.ops import kernels as K
    from ddsp_svc_tpu_torch.parallel import init_distributed, make_mesh

    d = torch.load(job, weights_only=False)
    dev = "cuda:0" if d["device"] == "cuda" else d["device"]
    init_distributed(f"127.0.0.1:{port}", world, rank, backend=backend,
                     device=dev)
    try:
        models = mesh_models(d, make_mesh(device=dev))
        mesh_calls(torch, d, *models)
        K.reset_launch_counts()
        outs, walls = mesh_calls(torch, d, *models)
        torch.save({"outs": outs, "walls": walls,
                    "launches": K.launch_counts()}, f"{job}.{rank}")
    finally:
        dist.destroy_process_group()


def mesh_phase(torch, K, card: str, ckpts: dict, device: str = "cuda"
               ) -> dict:
    """One utterance's conversion time-sharded over ranks (parallel/): the
    CLI phase's 13 s sung wav, its dio f0, volume and HuBERT-soft units, at
    configs/combsub.yaml's width with H_NSF. Each run spawns its ranks on
    cuda:0 (world size 1 over NCCL, 2 over Gloo) and holds every rank's
    whole output against the unsharded run on the kernels: the bucketed
    synth (1121 frames in the 2048 bucket, noise injected) within 1e-4 x
    max|ref|, the enhancer on the reference synth output fp32 within 1e-5
    x max|ref| and staged bf16 at 128 within rel RMS 2e-2, SvcCore.infer's
    window (synth and fp32 enhancer sharded) within 1e-4 x max|ref|, and
    the model.bf16 synth on the same weights (#1's split and #2 in their
    bf16-operand forms) within rel RMS 5e-2 (the JAX package's bf16 bound:
    the all-reduced moments sum in another order and flip bf16 roundings
    downstream); each rank launched #1's moments and apply, #2, #3 and #4
    and the bf16 forms of #1's split and #2, and never the single #1. Prints the walls of each run (two ranks share one card: a
    record, no speed-up expected). Returns the ranks' launches, summed.
    device='cpu' rehearses it on the CPU, on the plain versions, over Gloo
    only (no kernel launches)."""
    import torch.multiprocessing as mp
    import socket
    from ddsp_svc_tpu_torch.data.features import VolumeExtractor

    work = os.path.join(ROOT, "build", "chip_smoke_mesh")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    d = {"ckpt": ckpts["fp32"], "device": device, "nsf": os.path.join(
        os.path.dirname(os.path.dirname(ckpts["fp32"])), "nsf", "model")}
    synths, enhancers, core = mesh_models(d)
    sr, bs = core.args.data.sampling_rate, core.args.data.block_size
    audio = sung_wav(sr)
    f0 = core._f0_extractor("dio", sr, bs, 50, 1100).extract(audio,
                                                              uv_interp=True)
    units = core.units_encoder.encode(audio[None], sr, bs)
    n = units.shape[1]
    rng = np.random.default_rng(11)
    ri = rng.random((1, 9)).astype(np.float32)
    ri[:, 0] = 0.0
    d.update(sr=sr, block=bs, audio=audio, units=units,
             f0=f0[None, :n, None].astype(np.float32),
             volume=VolumeExtractor(bs).extract(audio)[None, :n].astype(
                 np.float32), spk=np.ones((1, 1), np.int64),
             noise=(rng.random((1, n * bs)) * 2 - 1).astype(np.float32),
             rand_ini=ri)
    d["synth_ref"] = synths["synth"](d["units"], d["f0"], d["volume"],
                                     d["spk"], noise=d["noise"]).cpu()
    mesh_calls(torch, d, synths, enhancers, core)
    refs, walls = mesh_calls(torch, d, synths, enhancers, core)
    say(f"{card}: mesh phase: {len(audio) / sr:.3f} s wav, {n} frames in "
        f"the {max(32, 1 << (n - 1).bit_length())}-frame bucket; unsharded "
        "(one process, no group) " + ", ".join(
            f"{k} {v * 1e3:.1f} ms" for k, v in walls.items()))
    job = os.path.join(work, "job.pt")
    torch.save(d, job)
    del synths, enhancers, core
    total = {}
    for backend, world in MESH_RUNS:
        if device != "cuda":
            backend = "gloo"
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        mp.start_processes(mesh_rank, args=(world, backend, port, job),
                           nprocs=world, join=True, start_method="spawn")
        spawn_s = time.perf_counter() - t0
        for rank in range(world):
            res = torch.load(f"{job}.{rank}", weights_only=False)
            label = f"mesh {backend} world size {world} rank {rank}"
            errs = []
            for stage, tol in (("synth", 1e-4), ("enhance fp32", 1e-5),
                               ("SvcCore.infer", 1e-4)):
                got, ref = res["outs"][stage], refs[stage]
                if got.shape != ref.shape or not torch.isfinite(got).all():
                    fail(f"{label}: {stage} gave {tuple(got.shape)} "
                         f"(expected {tuple(ref.shape)}) or non-finite values")
                err = ((got - ref).abs().max() / ref.abs().max()).item()
                if not err <= tol:
                    fail(f"{label}: {stage} {err:.3e} x max|ref| against the "
                         f"unsharded run, over {tol}")
                errs.append(f"{stage} {err:.3e} x max|ref| (<= {tol})")
            for stage, tol in (("enhance staged", 2e-2), ("synth bf16", 5e-2)):
                got, ref = res["outs"][stage], refs[stage]
                rel = (torch.linalg.vector_norm(got - ref)
                       / torch.linalg.vector_norm(ref)).item()
                if got.shape != ref.shape or not rel <= tol:
                    fail(f"{label}: {stage} rel RMS {rel:.3e}, over {tol}")
                errs.append(f"{stage} rel RMS {rel:.3e} (<= {tol})")
            say(f"{label}: " + "; ".join(errs))
            counts = res["launches"]
            say(f"{label} launches: {json.dumps(counts)}")
            for name in MESH_KERNELS if device == "cuda" else ():
                if counts[name] <= 0:
                    fail(f"{name} was not launched on {label}")
            if counts["performer_attention"] or counts[
                    "performer_attention_mxu_bf16"]:
                fail(f"{label} launched the single #1 on the sharded path")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            say(f"{card}: {label} walls: " + ", ".join(
                f"{k} {v * 1e3:.1f} ms" for k, v in res["walls"].items()))
        say(f"mesh {backend} world size {world}: {spawn_s:.1f} s with the "
            "ranks' start")
    shutil.rmtree(work, ignore_errors=True)
    return total


# the mesh-training phase: data- and tensor-parallel steps at combsub.yaml's
# full width, each rank set spawned once (NCCL at world size 1, then 2 Gloo
# ranks sharing the card), all of its cases run in it
MT_CASES = {
    "nccl": (("dp fp32", "step", (1, 1), False),
             ("dp bf16", "step", (1, 1), True)),
    "gloo": (("dp fp32", "step", (2, 1), False),
             ("tp fp32", "step", (1, 2), False),
             ("dp bf16", "step", (2, 1), True),
             ("graphed K=4", "graphed", (2, 1), False),
             ("gan", "gan", (2, 1), False),
             ("causal", "causal", (2, 1), False))}
MT_MORE = 4           # timed steps after the gated first one
MT_GRAPH_K = 4
MT_GAN_BATCH, MT_GAN_FRAMES = 8, 32
MT_CAUSAL_FRAMES = 1024
# each parameter tensor's 99th percentile of |diff| < MT_Q99, and every
# entry's < MT_MAX x (lr / 1e-3)
MT_LOSS_RTOL, MT_Q99, MT_MAX = 2e-4, 1e-4, 4e-3
MT_GAN_LOSS_RTOL, MT_GAN_ATOL, MT_GAN_RTOL = 1e-4, 1e-5, 1e-4
MT_CAUSAL_TOL = 1e-5
# the gated first step's loss eps: the well-conditioned regime in which
# tests/test_train_parity.py and tests/test_torch_train.py compare steps.
# At the config's 1e-7 the loss's log of near-zero bins turns any change of
# summation order into gradient differences of up to ~3e-2 relative (the
# row-split floor that tools/rss_row_split_floor.py reads: one process, its
# batch as two halves), which AdamW's first step turns into whole-lr moves
MT_GATE_EPS = 1e-3
# the DP GAN steps' gradients against the single-process ones: a sound run
# reads rel 6.9e-4 (float noise of the split batch), a copy whose G step
# skips the gradient all-reduce rel 0.75, cos 0.80 (PERF.md)
MT_GAN_GRAD_REL, MT_GAN_GRAD_COS = 5e-3, 1 - 1e-4
# the kernels each case must launch on every rank (on the card)
MT_EXPECT = {"step": ("dft_magnitude",),
             "step bf16": ("dft_magnitude", "combsub_spectral_mxu_bf16",
                           "combsub_spectral_bwd_mxu_bf16"),
             "graphed": ("dft_magnitude",),
             "gan": ("harmonic_source", "fused_resblocks_inject"),
             "causal": ("combsub_spectral",)}


def _mt_state(torch, d, device, mesh, bf16: bool, eps: float = 1e-7):
    """A TrainState of combsub.yaml's model from seed 0 (bf16: model.bf16)
    on `device`, cut to this rank's slices of the mesh (None: whole), and
    its RSS loss (at `eps`)."""
    from ddsp_svc_tpu_torch.models.factory import build_model
    from ddsp_svc_tpu_torch.models.losses import RSSLoss
    from ddsp_svc_tpu_torch.parallel import shard_train_state
    from ddsp_svc_tpu_torch.train.step import TrainState, create_optimizer
    from ddsp_svc_tpu_torch.utils.config import load_config

    args = load_config(d["cfg16" if bf16 else "cfg"])
    model = build_model(args, device=device, seed=0)
    st = TrainState(0, model, create_optimizer(
        model, float(args.train.lr), float(args.train.weight_decay or 0)))
    if mesh is not None:
        shard_train_state(st, mesh)
    return st, RSSLoss(int(args.loss.fft_min), int(args.loss.fft_max),
                       int(args.loss.n_scale), eps=eps)


def _host(torch, t):
    """A float32 copy on the host (never a view of the live tensor)."""
    return t.detach().to("cpu", torch.float32, copy=True)


def _mt_timed(torch, fn, n: int) -> float:
    """Median ms of n calls of fn, each ended by a synchronize."""
    walls = []
    for _ in range(n):
        sync(torch, "cuda" if torch.cuda.is_available() else "cpu")
        t0 = time.perf_counter()
        fn()
        sync(torch, "cuda" if torch.cuda.is_available() else "cpu")
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def mt_step(torch, d, mesh, bf16: bool) -> dict:
    """One step from seed-0 weights on the job's global batch (this rank's
    rows), its noise and loss scales pinned and the loss at MT_GATE_EPS,
    then MT_MORE timed steps at the config's loss drawing their own; the
    loss, the gathered parameters after step 1 (on every rank), ms a step
    and the idle share."""
    from ddsp_svc_tpu_torch.parallel import full_state_dicts, shard_batch
    from ddsp_svc_tpu_torch.train.step import (batch_to_device, train_step,
                                               warm_up_buckets)

    st, gate_rss = _mt_state(torch, d, mesh.device, mesh, bf16, MT_GATE_EPS)
    rss = _mt_state(torch, d, "cpu", None, bf16)[1]
    batch = batch_to_device(shard_batch(d["batch"], mesh), mesh.device)
    noise = torch.as_tensor(d["noise"], device=mesh.device)
    loss = train_step(st, batch, gate_rss, noise=noise,
                      loss_idx=PINNED_LOSS_IDX, mesh=mesh)
    params = {k: _host(torch, v)
              for k, v in full_state_dicts(st.model)[0].items()}
    warm_up_buckets(st, batch, rss, mesh=mesh)
    ms = _mt_timed(torch, lambda: train_step(st, batch, rss, mesh=mesh),
                   MT_MORE)
    idle = (profile_dispatch(torch, lambda: train_step(st, batch, rss,
                                                       mesh=mesh), 1)[2]
            if torch.cuda.is_available() else float("nan"))
    return {"loss": float(loss), "params": params, "ms": ms, "idle": idle}


def mt_graphed(torch, d, mesh, bf16: bool) -> dict:
    """MT_GRAPH_K eager data-parallel steps against one graphed dispatch of
    MT_GRAPH_K (train/graphed.py under the mesh) from the same weights and
    batches: the largest loss and parameter differences, bit for bit, and
    ms a step graphed (a further dispatch)."""
    from ddsp_svc_tpu_torch.parallel import shard_batch
    from ddsp_svc_tpu_torch.train.graphed import GraphedTrainSteps
    from ddsp_svc_tpu_torch.train.step import stage, train_steps

    staged = stage([shard_batch(b, mesh) for b in d["batches"]], mesh.device)
    eager, rss = _mt_state(torch, d, mesh.device, mesh, bf16)
    le = train_steps(eager, staged, rss, mesh=mesh)
    graphed, _ = _mt_state(torch, d, mesh.device, mesh, bf16)
    steps = GraphedTrainSteps(graphed, rss, staged, mesh=mesh)
    lg = steps(staged)
    rel = ((lg - le).abs() / le.abs()).max().item()
    worst = max(((p - q).abs().max() / q.abs().max()).item() for p, q in zip(
        graphed.model.parameters(), eager.model.parameters()))
    bitwise = torch.equal(lg, le) and all(torch.equal(p, q) for p, q in zip(
        graphed.model.parameters(), eager.model.parameters()))
    ms = _mt_timed(torch, lambda: steps(staged), 2) / MT_GRAPH_K
    return {"loss_rel": rel, "param_rel": worst, "bitwise": bitwise,
            "loss": float(lg[-1]), "ms": ms}


def _mt_gan(torch, d, device, mesh=None):
    """The GAN trainer over H_NSF from seeded weights (mesh: data-parallel)
    and the job's batch (this rank's rows, the mel of each)."""
    from ddsp_svc_tpu_torch.nn.layers import lecun_init_
    from ddsp_svc_tpu_torch.nn.nsf_hifigan import generator_from_h
    from ddsp_svc_tpu_torch.parallel import shard_batch
    from ddsp_svc_tpu_torch.train.gan import GanTrainer, mel_of

    h = d["h"]
    gen = lecun_init_(generator_from_h(h), torch.Generator().manual_seed(0))
    trainer = GanTrainer(h, mesh=mesh)
    st = trainer.create_state(gen.to(device), seed=1)
    rows = d["gan_batch"] if mesh is None else shard_batch(d["gan_batch"],
                                                           mesh)
    batch = {k: torch.as_tensor(v, device=device) for k, v in rows.items()}
    batch["mel"] = mel_of(h, batch["audio"]).transpose(1, 2)
    ri = {k: torch.as_tensor(d[k], device=device) for k in ("ri_d", "ri_g")}
    return trainer, st, batch, ri


def _gan_grads(torch, st) -> dict:
    """The G step's generator gradients and the D step's discriminator
    gradients (left in .grad), on the host."""
    return {f"{part}.{k}": _host(torch, p.grad) for part, module in (
        ("g", st.generator), ("mpd", st.mpd), ("msd", st.msd))
        for k, p in module.named_parameters()}


def mt_gan(torch, d, mesh, bf16: bool) -> dict:
    """One data-parallel D and G step (rand_ini the whole batch's): the
    losses, the generator (every rank) and the steps' gradients (rank 0),
    then ms a D + G step."""
    import torch.distributed as dist
    trainer, st, batch, ri = _mt_gan(torch, d, mesh.device, mesh)
    logs = trainer.step_d(st, batch, rand_ini=ri["ri_d"])
    logs.update(trainer.step_g(st, batch, rand_ini=ri["ri_g"]))
    gen = {k: _host(torch, v) for k, v in st.generator.state_dict().items()}
    grads = _gan_grads(torch, st) if dist.get_rank() == 0 else None
    ms = _mt_timed(torch, lambda: (trainer.step_d(st, batch, ri["ri_d"]),
                                   trainer.step_g(st, batch, ri["ri_g"])), 2)
    return {"logs": {k: float(v) for k, v in logs.items()},
            "generator": gen, "grads": grads, "ms": ms}


def _mt_causal_model(torch, d, device):
    from ddsp_svc_tpu_torch.models.factory import build_model
    from ddsp_svc_tpu_torch.utils.config import load_config
    return build_model(load_config(d["cfg_causal"]), device=device, seed=3)


def mt_causal(torch, d, mesh, bf16: bool) -> dict:
    """The causal + frame_norm model's inference forward time-sharded over
    the mesh's data axis (make_time_parallel_forward): the whole signal and
    ms a call."""
    from ddsp_svc_tpu_torch.parallel import make_time_parallel_forward
    fwd = make_time_parallel_forward(_mt_causal_model(torch, d, mesh.device),
                                     mesh)
    x = [torch.as_tensor(d["causal"][k], device=mesh.device)
         for k in ("units", "f0", "volume", "spk_id", "noise")]
    out = fwd(*x).cpu()
    return {"signal": out, "ms": _mt_timed(torch, lambda: fwd(*x), 3)}


MT_RUN = {"step": mt_step, "graphed": mt_graphed, "gan": mt_gan,
          "causal": mt_causal}


def mesh_train_rank(rank: int, world: int, backend: str, port: int,
                    job: str):
    """One rank of the mesh-training phase, spawned: joins `world` ranks
    on the job's device (cuda:0 for every rank) over `backend`, runs the
    backend's cases (each on its (n_data, n_model) mesh, its launch counts
    from 0 and its peak memory), and saves their results."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    from ddsp_svc_tpu_torch.ops import kernels as K
    from ddsp_svc_tpu_torch.parallel import init_distributed, make_mesh

    d = torch.load(job, weights_only=False)
    on_card = d["device"] == "cuda"
    dev = "cuda:0" if on_card else "cpu"
    if not on_card:
        torch.set_num_threads(1)  # ranks share the host's cores
    init_distributed(f"127.0.0.1:{port}", world, rank, backend=backend,
                     device=dev)
    try:
        meshes, out = {}, {}
        for name, kind, shape, bf16 in MT_CASES[backend]:
            if kind == "graphed" and not on_card:
                continue
            if shape not in meshes:
                meshes[shape] = make_mesh(*shape, device=dev)
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            res = MT_RUN[kind](torch, d, meshes[shape], bf16)
            res["launches"] = K.launch_counts()
            res["peak_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                               if on_card else 0.0)
            out[name] = res
        torch.save(out, f"{job}.{backend}.{rank}")
    finally:
        dist.destroy_process_group()


def mt_job(device: str = "cuda") -> tuple:
    """The mesh-training phase's inputs: configs/combsub.yaml over a
    synthetic store in build/chip_smoke_mesh_train (copies of it as fp32,
    bf16 and causal + frame_norm configs there), the loader's first
    MT_GRAPH_K batches, the step's noise, the GAN's batch and rand_ini and
    the causal forward's inputs, drawn from seed 19. Returns (args, work,
    job)."""
    import yaml
    from ddsp_svc_tpu_torch.data.dataset import get_data_loaders
    from ddsp_svc_tpu_torch.train.step import BATCH_KEYS
    from ddsp_svc_tpu_torch.utils.config import load_config

    args = load_config(os.path.join(ROOT, "configs", "combsub.yaml"))
    d = args.data
    work = os.path.join(ROOT, "build", "chip_smoke_mesh_train")
    shutil.rmtree(work, ignore_errors=True)
    write_dataset(os.path.join(work, "train"), 2, 3, 4.0, d.sampling_rate,
                  d.block_size, d.encoder_out_channels, 0)
    args["data"].update(train_path=os.path.join(work, "train"),
                        valid_path=os.path.join(work, "train"))
    job = {"device": device, "h": H_NSF}
    for key, model in (("cfg", {}), ("cfg16", {"bf16": True}),
                       ("cfg_causal", {"c": True, "frame_norm": True})):
        cfg = json.loads(json.dumps(args))
        cfg["model"].update(model)
        job[key] = os.path.join(work, key + ".yaml")
        with open(job[key], "w") as f:
            yaml.safe_dump(cfg, f)
    loader, _ = get_data_loaders(load_config(job["cfg"]))
    batches = [{k: b[k] for k in BATCH_KEYS}
               for e in range(MT_GRAPH_K) for b in loader.epoch(e)]
    rng = np.random.default_rng(19)
    n_rows, n_frames = batches[0]["f0"].shape[:2]
    gan_t = MT_GAN_FRAMES * H_NSF["hop_size"]
    tt = np.arange(gan_t) / H_NSF["sampling_rate"]
    f0 = 150.0 + 250.0 * rng.random((MT_GAN_BATCH, 1))
    ri = rng.random((2, MT_GAN_BATCH, 9)).astype(np.float32)
    ri[:, :, 0] = 0.0
    cf = MT_CAUSAL_FRAMES
    job.update(
        batch=batches[0], batches=batches[:MT_GRAPH_K],
        noise=(rng.random((n_rows, n_frames * d.block_size)) * 2 - 1
               ).astype(np.float32),
        gan_batch={"audio": (0.3 * np.sin(2 * np.pi * f0 * tt)
                             + 0.01 * rng.standard_normal((MT_GAN_BATCH, gan_t))
                             ).astype(np.float32),
                   "f0": np.repeat(f0, MT_GAN_FRAMES, 1).astype(np.float32)},
        ri_d=ri[0], ri_g=ri[1],
        causal={"units": rng.standard_normal(
                    (1, cf, d.encoder_out_channels)).astype(np.float32),
                "f0": (200 * rng.random((1, cf, 1)) + 80).astype(np.float32),
                "volume": rng.random((1, cf)).astype(np.float32),
                "spk_id": np.ones((1, 1), np.int64),
                "noise": (rng.random((1, cf * d.block_size)) * 2 - 1
                          ).astype(np.float32)})
    return args, work, job


def mesh_train_phase(torch, K, card: str, device: str = "cuda") -> dict:
    """Training on a mesh (parallel/sharding.py, train/step.py's mesh=) at
    configs/combsub.yaml's full width: CombSubFast (44.1 kHz, block 512,
    256 units, PCmer 3 x 8 heads x 256), batch 24 of 2 s crops (172
    frames) from a synthetic store (mt_job), RSS 256..2048 x 4 scales;
    H_NSF for the GAN (batch 8 x 32 frames); a causal + frame_norm
    CombSubFast on 1024 frames. Ranks spawned on cuda:0 (world size 1 over
    NCCL, then 2 over Gloo), cuDNN deterministic on every side. Each step
    case: one step from seed-0 weights and the same batch, noise and
    pinned loss scales as a single-process eager step made here, its loss
    within rtol 2e-4 and its gathered parameters, tensor by tensor, at the
    99th percentile of |diff| < 1e-4 and at most 4e-3 x (lr / 1e-3); under
    DP every rank's parameters bit for bit rank 0's; then the warm-up over
    every loss bucket and MT_MORE timed steps. DP and TP (1 x 2: 4 heads
    and 256 conv channels a rank; dense_out's 1539 columns replicated),
    fp32 and DP bf16 (#2, #7); the graphed K = 4 dispatch under DP against
    4 eager DP steps (loss 1e-5 relative, parameters 1e-4 x max|param|); a
    DP GAN D + G step (#3, #4) against the single-process one (losses 1e-4
    relative, the steps' gradients rel < MT_GAN_GRAD_REL, every rank's
    generator bit for bit rank 0's); the causal model time-sharded against
    its unsharded forward (1e-5 x max|ref|). Prints each case's ms, each
    rank's launch counts and peak memory. Returns the ranks' launches,
    summed. device='cpu' runs it over Gloo only, without the graphed case
    (for a small rehearsal on the CPU, tests/test_torch_mesh_train.py)."""
    import socket
    import torch.multiprocessing as mp
    from ddsp_svc_tpu_torch.train.step import (batch_to_device, train_step,
                                               warm_up_buckets)

    on_card = device == "cuda"
    args, work, job = mt_job(device)
    d = args.data
    n_rows, n_frames = job["batch"]["f0"].shape[:2]
    cf = MT_CAUSAL_FRAMES
    lr = float(args.train.lr)
    say(f"mesh training phase: {d.sampling_rate} Hz block {d.block_size}, "
        f"batch {n_rows} x {n_frames} frames, RSS {args.loss.fft_min}.."
        f"{args.loss.fft_max} x {args.loss.n_scale} scales, lr {lr}; GAN "
        f"H_NSF batch {MT_GAN_BATCH} x {MT_GAN_FRAMES} frames; causal "
        f"CombSubFast on {cf} frames; cuDNN deterministic")

    # the single-process references, here, from the same weights and inputs
    torch.backends.cudnn.deterministic = True
    refs = {}

    class _One:  # the job's device as a mesh of one rank with no group
        device = torch.device("cuda", torch.cuda.current_device()) \
            if on_card else torch.device("cpu")

    batch = batch_to_device(job["batch"], _One.device)
    noise = torch.as_tensor(job["noise"], device=_One.device)
    for bf16 in (False, True):
        st, rss = _mt_state(torch, job, _One.device, None, bf16)
        gate_rss = _mt_state(torch, job, "cpu", None, bf16, MT_GATE_EPS)[1]
        loss = train_step(st, batch, gate_rss, noise=noise,
                          loss_idx=PINNED_LOSS_IDX)
        refs[bf16] = (float(loss), {k: _host(torch, v) for k, v in
                                    st.model.state_dict().items()})
        warm_up_buckets(st, batch, rss)
        ms = _mt_timed(torch, lambda: train_step(st, batch, rss), MT_MORE)
        say(f"mesh training: single-process eager {'bf16' if bf16 else 'fp32'}"
            f" step {ms:.2f} ms (median of {MT_MORE})")
        del st
    trainer, st, batch, ri = _mt_gan(torch, job, _One.device)
    logs = trainer.step_d(st, batch, rand_ini=ri["ri_d"])
    logs.update(trainer.step_g(st, batch, rand_ini=ri["ri_g"]))
    refs["gan"] = ({k: float(v) for k, v in logs.items()},
                   {k: _host(torch, v)
                    for k, v in st.generator.state_dict().items()},
                   _gan_grads(torch, st))
    del trainer, st
    with torch.no_grad():
        x = [torch.as_tensor(job["causal"][k], device=_One.device)
             for k in ("units", "f0", "volume", "spk_id", "noise")]
        refs["causal"] = _mt_causal_model(torch, job, _One.device)(
            *x[:4], noise=x[4], infer=True)[0].cpu()
    torch.backends.cudnn.deterministic = False
    path = os.path.join(work, "job.pt")
    torch.save(job, path)

    total = {}
    for backend, world in (("nccl", 1), ("gloo", 2)):
        if not on_card and backend == "nccl":
            continue
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        mp.start_processes(mesh_train_rank, args=(world, backend, port, path),
                           nprocs=world, join=True, start_method="spawn")
        say(f"mesh training {backend} world size {world}: "
            f"{time.perf_counter() - t0:.1f} s with the ranks' start")
        ranks = [torch.load(f"{path}.{backend}.{r}", weights_only=False)
                 for r in range(world)]
        for name, kind, shape, bf16 in MT_CASES[backend]:
            if name not in ranks[0]:
                continue  # the graphed case, on the card only
            label = (f"mesh training {backend} world size {world} {name} "
                     f"({shape[0]} x {shape[1]})")
            res = ranks[0][name]
            if kind == "step":
                ref_loss, ref_params = refs[bf16]
                rel = abs(res["loss"] - ref_loss) / abs(ref_loss)
                # each tensor's 99th percentile and its largest entry
                q99s, worst = {}, 0.0
                for k, v in ref_params.items():
                    if not k.endswith("projection_matrix"):
                        diff = (res["params"][k] - v).abs().flatten().double()
                        q99s[k] = torch.quantile(diff, 0.99).item()
                        worst = max(worst, diff.max().item())
                top = max(q99s, key=q99s.get)
                gate = MT_MAX * lr / 1e-3
                same = all(all(torch.equal(r[name]["params"][k], v)
                               for k, v in res["params"].items())
                           for r in ranks[1:])
                say(f"{label}: step-1 loss {res['loss']:.6f} rel "
                    f"{rel:.3e} (<= {MT_LOSS_RTOL}) at loss eps "
                    f"{MT_GATE_EPS}; parameters, {len(q99s)} tensors: the "
                    f"largest 99th percentile of |diff| {q99s[top]:.3e} "
                    f"({top}, {res['params'][top].numel()} entries; < "
                    f"{MT_Q99}), max {worst:.3e} (< {gate:.1e})"
                    + (f"; every rank's parameters bit for bit rank 0's "
                       f"{same}" if shape[0] > 1 else "")
                    + f"; {res['ms']:.2f} ms a step (median of {MT_MORE}), "
                    f"device idle share {res['idle']:.3f} (torch.profiler, "
                    "one further step)")
                if not (rel <= MT_LOSS_RTOL and q99s[top] < MT_Q99
                        and worst < gate):
                    fail(f"{label}: disagrees with the single-process step")
                if shape[0] > 1 and not same:
                    fail(f"{label}: the data-parallel ranks' parameters "
                         "differ")
                expect = MT_EXPECT["step bf16" if bf16 else "step"]
            elif kind == "graphed":
                say(f"{label}: {MT_GRAPH_K} graphed steps against as many "
                    f"eager ones: losses rel {res['loss_rel']:.3e} (<= "
                    f"{GRAPH_LOSS_RTOL}), parameters {res['param_rel']:.3e} "
                    f"x max|param| (<= {GRAPH_PARAM_TOL}), bit for bit "
                    f"{res['bitwise']}; {res['ms']:.2f} ms a step graphed")
                if not (res["loss_rel"] <= GRAPH_LOSS_RTOL
                        and res["param_rel"] <= GRAPH_PARAM_TOL):
                    fail(f"{label}: disagrees with the eager DP steps")
                expect = MT_EXPECT["graphed"]
            elif kind == "gan":
                ref_logs, ref_gen, ref_grads = refs["gan"]
                rel = max(abs(res["logs"][k] - v) / abs(v)
                          for k, v in ref_logs.items())
                outside = sum(int(((res["generator"][k] - v).abs()
                                   > MT_GAN_ATOL + MT_GAN_RTOL * v.abs()
                                   ).sum()) for k, v in ref_gen.items())
                n_gen = sum(v.numel() for v in ref_gen.values())
                g_rel, g_cos = 0.0, 1.0
                for k, r in ref_grads.items():
                    g, r = res["grads"][k].double(), r.double()
                    nr = r.norm().item()
                    g_rel = max(g_rel, (g - r).norm().item() / (nr + 1e-12))
                    if nr > 1e-10:
                        g_cos = min(g_cos, ((g * r).sum() / (
                            g.norm() * nr + 1e-30)).item())
                say(f"{label}: D + G losses rel {rel:.3e} (<= "
                    f"{MT_GAN_LOSS_RTOL}); the steps' gradients against the "
                    f"single-process ones worst rel {g_rel:.3e} (< "
                    f"{MT_GAN_GRAD_REL}), cos {g_cos:.7f} (> "
                    f"{MT_GAN_GRAD_COS}); generator entries outside atol "
                    f"{MT_GAN_ATOL} + rtol {MT_GAN_RTOL}: {outside} of "
                    f"{n_gen} (AdamW's first step on the gradients' float "
                    f"noise); {res['ms']:.1f} ms a D + G step")
                same = all(all(torch.equal(r[name]["generator"][k], v)
                               for k, v in res["generator"].items())
                           for r in ranks[1:])
                say(f"{label}: every rank's generator bit for bit rank 0's "
                    f"{same}")
                if not (rel <= MT_GAN_LOSS_RTOL and g_rel < MT_GAN_GRAD_REL
                        and g_cos > MT_GAN_GRAD_COS and same):
                    fail(f"{label}: disagrees with the single-process GAN "
                         "steps")
                expect = MT_EXPECT["gan"]
            else:
                ref = refs["causal"]
                errs = [((r[name]["signal"] - ref).abs().max()
                         / ref.abs().max()).item() for r in ranks]
                say(f"{label}: every rank's whole signal against the "
                    f"unsharded causal forward, max {max(errs):.3e} x "
                    f"max|ref| (<= {MT_CAUSAL_TOL}); {res['ms']:.1f} ms a "
                    "call")
                if not max(errs) <= MT_CAUSAL_TOL:
                    fail(f"{label}: disagrees with the unsharded forward")
                expect = MT_EXPECT["causal"]
            for r, rank in enumerate(ranks):
                counts = rank[name]["launches"]
                say(f"{label} rank {r}: peak memory "
                    f"{rank[name]['peak_gib']:.3f} GiB, launches "
                    f"{json.dumps({k: v for k, v in counts.items() if v})}")
                for kname in expect if on_card else ():
                    if counts[kname] <= 0:
                        fail(f"{kname} was not launched on {label} rank {r}")
                if kind == "causal" and counts["performer_attention"]:
                    fail(f"{label}: a causal layer launched #1")
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v
    shutil.rmtree(work, ignore_errors=True)
    return total

def serve_phase(torch, K, card: str, ckpts: dict, device: str = "cuda"
                ) -> dict:
    """Serving at full width with the CLI phase's checkpoints: the three
    synthesizers exported and checked (export_checks); `serve`'s
    ExportedSynth and handler over the CombSubFast artifact; `api`'s
    handler over a SvcCore; the web panel's handler (genconfig, /stream,
    an infer job). Returns the launch counts of the in-process runs on the
    kernels."""
    import yaml
    from ddsp_svc_tpu_torch import api, serve, webui
    from ddsp_svc_tpu_torch.data.wavio import read_wav_bytes, wav_bytes
    from ddsp_svc_tpu_torch.data.wavio import write_wav
    from ddsp_svc_tpu_torch.infer.streaming import SvcCore
    from ddsp_svc_tpu_torch.models.factory import build_model
    from ddsp_svc_tpu_torch.ops.resample import resample
    from ddsp_svc_tpu_torch.train.checkpoint import save_checkpoint
    from ddsp_svc_tpu_torch.utils.config import load_config

    total = {k: 0 for k in K.launch_counts()}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    # ---- export ----
    work = os.path.dirname(os.path.dirname(ckpts["fp32"]))
    artifacts = {}
    for synth, config, expect in EXPORTS:
        ckpt = ckpts["fp32"]
        if synth != "CombSubFast":
            exp = os.path.join(work, "exp_" + synth)
            os.makedirs(exp, exist_ok=True)
            args = load_config(os.path.join(ROOT, "configs", config))
            with open(os.path.join(exp, "config.yaml"), "w") as f:
                yaml.safe_dump(json.loads(json.dumps(args)), f)
            ckpt = os.path.join(exp, "model_0.pt")
            save_checkpoint(ckpt, 0, build_model(args, device="cpu", seed=0))
        artifacts[synth], counts = export_checks(torch, K, synth, ckpt,
                                                 expect, card, device)
        add(counts)

    # ---- serve ----
    cfg_path = os.path.join(os.path.dirname(ckpts["fp32"]), "config.yaml")
    t0 = time.perf_counter()
    synth = serve.ExportedSynth(artifacts["CombSubFast"], cfg_path,
                                device=device)
    t_load = time.perf_counter() - t0
    sr, bs = synth.sr, synth.block
    body = wav_bytes(sung_wav(sr), sr)
    audio = read_wav_bytes(body)[0]  # what the servers read
    dur = len(audio) / sr
    n_f = len(audio) // bs + 1
    step = synth.frames - synth.overlap
    n_win = next(i + 1 for i in range(n_f) if i * step + synth.frames >= n_f)
    say(f"serve: ExportedSynth over the CombSubFast artifact ({synth.frames} "
        f"frames, overlap {synth.overlap}, dio, HuBERT-soft), loaded with "
        f"its warm call in {t_load:.2f} s; the {dur:.3f} s wav = {n_f} "
        f"frames = {n_win} windows")
    with http_server(serve.make_handler(synth)) as port:
        code, info = http(port, "/healthz")
        if code != 200 or json.loads(info)["status"] != "ok":
            fail(f"serve /healthz: {code} {info[:200]}")
        for path, key, label in (("/convert", 0.0, "first"),
                                 ("/convert", 0.0, "warm"),
                                 ("/voiceChangeModel?fPitchChange=2", 2.0,
                                  "voiceChangeModel")):
            synth._rng = np.random.default_rng(0)
            K.reset_launch_counts()
            t0 = time.perf_counter()
            code, resp = http(port, path, body)
            wall = time.perf_counter() - t0
            counts = K.launch_counts()
            add(counts)
            if code != 200:
                fail(f"serve {path}: {code} {resp[:300]}")
            out, sr_o = read_wav_bytes(resp)
            synth._rng = np.random.default_rng(0)
            ref = _pcm16(synth.convert(audio, key=key), sr)
            err = float(np.abs(out - ref).max())
            rms = float(np.sqrt(np.mean(out.astype(np.float64) ** 2)))
            say(f"{card}: serve {path} ({label}): {wall * 1e3:.1f} ms = "
                f"{dur / wall:.2f} audio-s/s; {len(out)} samples at {sr_o} "
                f"Hz, rms {rms:.4f}; vs the direct call max|err| {err:.3e} "
                f"(tolerance one PCM16 step {PCM16:.3e}); launches "
                f"{json.dumps(counts)}")
            if not (sr_o == sr and len(out) == n_f * bs and np.isfinite(out).all()
                    and rms > 0 and err <= PCM16):
                fail(f"serve {path}: {len(out)} samples (expected {n_f * bs}) "
                     f"at {sr_o} Hz, rms {rms}, err {err}")
            for name, per in SERVE_PER_WINDOW.items():
                if counts[name] != per * n_win:
                    fail(f"serve {path} launched {name} {counts[name]} "
                         f"times, expected {per} a window x {n_win}")
    del synth

    # ---- API ----
    core = SvcCore(ckpts["fp32"], device=device)
    fresh = SvcCore(ckpts["fp32"], device=device)
    saved_core, api.CORE = api.CORE, core
    try:
        with http_server(api.Handler) as port:
            code, info = http(port, "/")
            if code != 200 or json.loads(info) != {"status": "ok",
                                                   "model": True}:
                fail(f"api GET: {code} {info[:200]}")
            for enhance, query in ((True, "enhance=true&pe=dio&sampleRate"
                                    "=16000"), (False, "enhance=false")):
                core._step = 0
                K.reset_launch_counts()
                t0 = time.perf_counter()
                code, resp = http(port, "/voiceChangeModel?" + query, body)
                wall = time.perf_counter() - t0
                counts = K.launch_counts()
                add(counts)
                if code != 200:
                    fail(f"api {query}: {code} {resp[:300]}")
                out, sr_o = read_wav_bytes(resp)
                refs = []
                for plain in (False, True):
                    fresh._step = 0
                    with plain_kernels(K) if plain else nullcontext():
                        y, y_sr = fresh.infer(audio, sr, use_enhancer=enhance,
                                              pitch_extractor_type="dio")
                    target = 16000 if enhance else y_sr
                    if target != y_sr:
                        y = resample(torch.from_numpy(y)[None], y_sr,
                                     target)[0].numpy()
                    refs.append(y)
                err = float(np.abs(out - _pcm16(refs[0], target)).max())
                e_p = float(np.abs(refs[0] - refs[1]).max()
                            / np.abs(refs[1]).max())
                rms = float(np.sqrt(np.mean(out.astype(np.float64) ** 2)))
                say(f"{card}: api {query}: {wall * 1e3:.1f} ms = "
                    f"{dur / wall:.2f} audio-s/s; {len(out)} samples at "
                    f"{sr_o} Hz, rms {rms:.4f}; vs a fresh SvcCore.infer "
                    f"max|err| {err:.3e} (tolerance one PCM16 step); kernels "
                    f"vs plain versions {e_p:.3e} x max|ref| (tolerance "
                    f"1e-3); launches {json.dumps(counts)}")
                if not (sr_o == target and len(out) == len(refs[0])
                        and np.isfinite(out).all() and rms > 0
                        and err <= PCM16 and e_p <= 1e-3):
                    fail(f"api {query}: {len(out)} samples at {sr_o} Hz, "
                         f"rms {rms}, err {err}, plain {e_p}")
                for name, per in API_PER_REQUEST[enhance].items():
                    if counts[name] != per:
                        fail(f"api {query} launched {name} {counts[name]} "
                             f"times, expected {per}")
    finally:
        api.CORE = saved_core
    del core, fresh

    # ---- the web panel ----
    panel = os.path.join(work, "panel")
    os.makedirs(panel, exist_ok=True)
    stream_wav = os.path.join(panel, "stream_in.wav")
    write_wav(stream_wav, sung_wav(sr, seed=2, phrases=STREAM_PHRASES), sr)
    cli_wav = os.path.join(work, "in.wav")
    saved = webui.REPO_ROOT, webui.DEVICE, webui.JOBS
    webui.REPO_ROOT, webui.DEVICE, webui.JOBS = panel, device, {}
    try:
        with http_server(webui.Handler) as port:
            def post(path, **form):
                import html
                import urllib.parse
                code, page = http(port, path, urllib.parse.urlencode(
                    form).encode())
                page = html.unescape(page.decode())
                if code != 200 or "error:" in page:
                    fail(f"panel {path} {form.get('action')}: {code} "
                         f"{page[-600:]}")
                return page

            post("/run", action="genconfig",
                 base=os.path.join(ROOT, "configs", "combsub.yaml"),
                 train_path="data/train", valid_path="data/val",
                 expdir="exp/panel", batch_size="8", out="opt.yaml")
            opt = load_config(os.path.join(panel, "opt.yaml"))
            if not (opt.train.batch_size == 8 and opt.model.type
                    == "CombSubFast"):
                fail("panel genconfig wrote the wrong config")
            K.reset_launch_counts()
            t0 = time.perf_counter()
            page = post("/stream", action="stream", model=ckpts["fp32"],
                        input=stream_wav, output="stream_out.wav",
                        samplerate=str(sr), pe="dio", enhance="true")
            wall = time.perf_counter() - t0
            add(K.launch_counts())
            stats = json.loads(page[page.index("{"): page.rindex("}") + 1])
            y, _ = read_wav_bytes(open(os.path.join(panel, "stream_out.wav"),
                                       "rb").read())
            say(f"{card}: panel /stream: {stats['blocks']} blocks of "
                f"{stats['block_ms']} ms, latency {json.dumps(stats['latency_ms'])}"
                f" ms, {wall:.2f} s with the core's load; {len(y)} samples "
                f"written; launches {json.dumps(K.launch_counts())}")
            if not (stats["blocks"] > 0 and len(y) == stats["blocks"]
                    * int(0.3 * sr) and np.isfinite(y).all()):
                fail("panel /stream: wrong output")
            out_wav = os.path.join(panel, "job_out.wav")
            t0 = time.perf_counter()
            page = post("/run", action="infer", model=ckpts["fp32"],
                        input=cli_wav, output=out_wav)
            if "started 'infer'" not in page:
                fail(f"panel infer: {page[-300:]}")
            job = webui.JOBS["infer"]
            if job.args[-2:] != ["--device", device]:
                fail(f"panel infer job: {job.args}")
            try:
                job.wait(timeout=300)
            finally:
                if job.poll() is None:
                    job.kill()
                    job.wait()
            wall = time.perf_counter() - t0
            page = http(port, "/")[1].decode()
            if job.returncode != 0 or "exited 0" not in page \
                    or not os.path.isfile(out_wav):
                log = open(os.path.join(panel, "webui_infer.log")).read()
                fail(f"panel infer job exited {job.returncode}: {log[-800:]}")
            y, y_sr = read_wav_bytes(open(out_wav, "rb").read())
            say(f"{card}: panel infer job (python -m ddsp_svc_tpu_torch.infer"
                f" -pe crepe -e true on the card, a subprocess): exited 0 in "
                f"{wall:.2f} s, {len(y)} samples at {y_sr} Hz")
    finally:
        webui.REPO_ROOT, webui.DEVICE, webui.JOBS = saved
        webui.STREAM_CORES.clear()
    return total


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
    from ddsp_svc_tpu_torch import native
    t0 = time.perf_counter()
    lib = native.build()
    say(f"build: the native NCCF library ({native.CXX} "
        f"{' '.join(native.CXX_FLAGS)}) -> {os.path.relpath(lib, ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = kernel_phase(torch, K, gen)
    rows.update(bf16_forms_phase(torch, K, gen))
    rows.update(mxu_forms_phase(torch, K, gen))
    keyshift_units_phase(torch, smi[0])
    for name, row in rows.items():
        t_b, by = row["bound"]
        say(f"kernel {name}: max|err| {row['max_abs_err']:.3e} ({row['tol']}), "
            f"{row['ms']:.4f} ms, device_ms {row['device_ms']:.4f}, plain "
            f"{row['plain_ms']:.4f} ms, bound {t_b:.4f} ms ({by})")
    # launches: the sum over the main paths' runs, each counted from 0 just
    # before it (the CLI; then offline and training for each synthesizer)
    launches = {k: 0 for k in K.launch_counts()}
    t0 = time.perf_counter()
    mxu_counts = mxu_path_phase(torch, K, smi[0])
    say(f"slice paths (bf16-operand forms): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cli_counts, ckpts = cli_phase(torch, K, smi[0])
    say(f"CLI paths: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    batch_counts = batch_phase(torch, K, smi[0], ckpts)
    say(f"batch paths: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pre_counts = preprocess_phase(torch, K, smi[0], ckpts["fp32"])
    say(f"preprocess paths: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gan_counts = gan_phase(torch, K, smi[0], ckpts)
    say(f"GAN paths: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    stream_counts = stream_phase(torch, K, smi[0], ckpts)
    say(f"streaming paths: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve_counts = serve_phase(torch, K, smi[0], ckpts)
    say(f"serving paths: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh_counts = mesh_phase(torch, K, smi[0], ckpts)
    say(f"mesh paths: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh_train_counts = mesh_train_phase(torch, K, smi[0])
    say(f"mesh training paths: {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(os.path.join(ROOT, "build", "chip_smoke_cli"),
                  ignore_errors=True)
    for counts in (mxu_counts, cli_counts, batch_counts, pre_counts,
                   gan_counts, stream_counts, serve_counts, mesh_counts,
                   mesh_train_counts):
        for k, v in counts.items():
            launches[k] += v
    for synth, config, expect, full in SYNTHS:
        t0 = time.perf_counter()
        segments = [] if full else None
        runs = [main_path_phase(torch, K, synth, config, expect, batched=full,
                                segments_out=segments)]
        if full:
            runs.append(enhancer_phase(torch, K, segments, smi[0]))
        runs.append(train_phase(torch, K, synth, config, expect, full=full))
        say(f"{synth} paths: {time.perf_counter() - t0:.1f} s")
        for counts in runs:
            for k, v in counts.items():
                launches[k] += v

    report = []
    for name, row in rows.items():
        t_b, by = row["bound"]
        report.append({
            "name": name, "route": row["route"], "source": row["source"],
            "replaces": row["replaces"], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "device_ms": row["device_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": t_b, "bound_by": by,
            "library_ms": row["library_ms"],
        })
    say(json.dumps({"kernels": report}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
