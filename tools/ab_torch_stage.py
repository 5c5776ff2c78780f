#!/usr/bin/env python3
"""Where the fused-stage kernel's (#11) time goes, on the card.

Builds edited copies of `ddsp_svc_tpu_torch/csrc/fused_stage.cu` (each
without one of the stage's pieces, so its output is wrong and only its time
counts) into build/ab_torch_stage/ (one nvcc per variant, all at once),
loads each in turn under the `fused_stage` wrapper, and prints each
variant's registers, spills and its time at the enhancer's three narrow
stages of a 512-frame segment (C = 64 / 32 / 16, u = 2, from x_pre (1, T /
2, 2C)), beside the same stage as the trio kernel (#4) on the upsampled
activation and as the cuDNN ConvTranspose that produces it. Two times per
call, each the median over seven turns in alternating order (A B .., ..
B A, ..): "synced", the median of 20 CUDA-event timings of one call each
on an idle card (as chip_smoke.py times the kernels, the wrapper's host
work included), and "back-to-back", 20 calls between one pair of events,
over 20 (the device's own time, as long as the host keeps ahead).
Variants:
  - committed: the source as it is;
  - no fill: the stage starts from h as zero_buffers leaves it (the
    chains, their copy-back and the mean only);
  - no copy-back: chains 2 and 3 start from chain 1's output, not from x0
    (the scratch is written but never read);
  - no window: the x_pre window is not staged (the fill reads t as it is);
  - no fill GEMM: the transposed conv's k-steps are skipped;
  - no injection: the epilogue skips the injection conv.
Run from the root of a checkout on a machine with the card:

    python3 tools/ab_torch_stage.py
"""
import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "ddsp_svc_tpu_torch", "csrc")
WORK = os.path.join(ROOT, "build", "ab_torch_stage")
SOURCE = "fused_stage.cu"
STAGES = ((64, 4), (32, 2), (16, 1))  # (C, source-conv stride)


def replace(old, new):
    def edit(text: str) -> str:
        if old not in text:
            raise RuntimeError(f"{SOURCE} has no {old!r}")
        return text.replace(old, new)
    return edit


VARIANTS = (
    ("committed", lambda t: t),
    ("no fill", replace("  fill_stage<C>(", "  if (false) fill_stage<C>(")),
    ("no copy-back", replace("if (r > 0) {  // h = x0 again",
                             "if (false) {  // h = x0 again")),
    ("no window", replace(
        "for (int col = threadIdx.x; col < nx; col += kThreads) {",
        "for (int col = threadIdx.x; col < 0; col += kThreads) {")),
    ("no fill GEMM", replace(
        "for (int s0 = 0; s0 < kSteps; s0 += kChunk) {",
        "for (int s0 = 0; s0 < 0; s0 += kChunk) {")),
    ("no injection", replace(
        "for (int tau = 0; tau < a.ksrc; ++tau) {",
        "for (int tau = 0; tau < 0; ++tau) {")),
)


def build_variants():
    from ddsp_svc_tpu_torch.ops import build
    nvcc = build.nvcc_path()
    with open(os.path.join(CSRC, SOURCE)) as f:
        text = f.read()
    procs = []
    for name, edit in VARIANTS:
        d = os.path.join(WORK, name.replace(" ", "_"))
        os.makedirs(d, exist_ok=True)
        src = os.path.join(d, SOURCE)
        with open(src, "w") as f:
            f.write(edit(text))
        lib = os.path.join(d, "fused_stage.so")
        procs.append((name, lib, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-I", CSRC, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = {}
    for name, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{out.decode(errors='replace')}")
        libs[name] = lib
    return libs


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this tool runs on the card")
    import torch.nn.functional as F
    from ddsp_svc_tpu_torch.ops import build
    from ddsp_svc_tpu_torch.ops import kernels as K
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    stages = []
    for c, s in STAGES:
        t_out = 262144 // s
        stages.append((randn(1, t_out // 2, 2 * c), randn(1, 262144, 1, scale=0.1),
                       randn(2 * c, c, 4, scale=(1.0 / (8 * c)) ** 0.5),
                       randn(c, scale=0.05),
                       randn(c, 1, 2 * s if s > 1 else 1, scale=0.2),
                       randn(c, scale=0.05),
                       [randn(3, 2, c, c, k, scale=(2.0 / (k * c)) ** 0.5)
                        for k in (3, 7, 11)],
                       [randn(3, 2, c, scale=0.01) for _ in range(3)], 2, s))

    def upsample(args):
        return F.conv_transpose1d(F.leaky_relu(args[0].transpose(1, 2), 0.1),
                                  args[2], args[3], stride=2,
                                  padding=1).transpose(1, 2)

    ups = [upsample(a) for a in stages]

    def median_ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(20):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            fn()
        b.record()
        b.synchronize()
        return float(np.median(times)), a.elapsed_time(b) / 20

    def use(name):
        build._loaded["fused_stage"] = ctypes.CDLL(libs[name])

    def run(name):
        if name == "#4 on the upsampled input":
            return [median_ms(lambda a=a, x=x: K.fused_resblocks_inject(
                x, a[1], a[4], a[5], a[6], a[7], a[9])) for a, x in zip(stages, ups)]
        if name == "cuDNN ConvTranspose":
            return [median_ms(lambda a=a: upsample(a)) for a in stages]
        use(name)
        return [median_ms(lambda a=a: K.fused_stage(*a)) for a in stages]

    names = [n for n, _ in VARIANTS] + ["#4 on the upsampled input",
                                        "cuDNN ConvTranspose"]
    for name, _ in VARIANTS:
        use(name)
        info = [K.stage_kernel_info(c) for c, _ in STAGES]
        print(f"[{name}] registers / spill bytes at C = 64, 32, 16: "
              + ", ".join(f"{i['registers']} / {i['spill_bytes']}" for i in info),
              flush=True)
    times = {n: [] for n in names}
    for turn in range(7):
        for name in (names if turn % 2 == 0 else names[::-1]):
            times[name].append(run(name))
    for name in names:
        t = np.median(np.array(times[name]), axis=0)  # (stage, synced | b2b)
        print(f"[{name}] C = 64 / 32 / 16, ms, median of 7 turns: synced "
              + " / ".join(f"{v:.3f}" for v in t[:, 0])
              + f" (sum {t[:, 0].sum():.3f}); back-to-back "
              + " / ".join(f"{v:.3f}" for v in t[:, 1])
              + f" (sum {t[:, 1].sum():.3f})", flush=True)


if __name__ == "__main__":
    main()
