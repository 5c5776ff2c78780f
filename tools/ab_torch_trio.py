#!/usr/bin/env python3
"""Accuracy and time of the kernels on the tensor-core conv core (the trio
#4/#5, one chain #10, the fused stage #11) against edited copies of the
core, on the card.

Builds edited copies of `ddsp_svc_tpu_torch/csrc/resblocks.cu`,
`resblock_chain.cu` and `fused_stage.cu` with their `resblock_mma.cuh` into
build/ab_torch_trio/ (one nvcc per source and variant, all at once), loads
each variant in turn under the wrappers, and prints for each variant:
  - the trio's max |err| against the plain version in float64 on the card,
    over max |ref|, at the enhancer's C = 64 stage of a 512-frame segment
    (T = 65536) and on inputs and weights of magnitude 10^[-3, 3] (C = 64
    and 16, T = 1000), with max |err| against the fp32 plain version (the
    cuDNN chain) at the path shape;
  - the same two errors for #10 at that stage at each k, and for #11 at
    the three narrow stages of the segment (u = 2, from x_pre (1, T / 2,
    2C));
  - the trio's time at the path shape, the median of 20 CUDA-event
    timings, in turns (A B .., .. B A, A B ..).
Variants:
  - committed: the sources as they are (chunks of 4 k-steps re-accumulated
    in fp32);
  - chunk 1: the fp32 re-accumulation after every k-step;
  - no re-accumulation: every MMA accumulates into the running sum, in the
    tensor cores' own (truncating) accumulation;
  - no a_lo / no b_lo: 3xTF32 without the weights' or the activations'
    lo part (two MMAs a k-step).
The fp32 plain versions' own errors against float64 (cuDNN) are printed
beside them, with max |ref|.
Run from the root of a checkout on a machine with the card:

    python3 tools/ab_torch_trio.py
"""
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "ddsp_svc_tpu_torch", "csrc")
WORK = os.path.join(ROOT, "build", "ab_torch_trio")
HEADER = "resblock_mma.cuh"
SOURCES = ("resblocks", "resblock_chain", "fused_stage")
MMA_LO_B_HI = "mma_tf32(part[mt][nt], a_lo[mt], b_hi, {});"
MMA_HI_LO = "mma_tf32(part[mt][nt], a_hi[mt], b_lo, part[mt][nt]);"


def replace(*pairs):
    def edit(text: str) -> str:
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"{HEADER} has no {old!r}")
            text = text.replace(old, new)
        return text
    return edit


def no_reaccumulation(text: str) -> str:
    # every k-step of conv_pass accumulates straight into its running sum
    return replace(
        ("      add_frags<C>(acc, part);\n    }\n  }\n\n#pragma unroll\n"
         "  for (int nt = 0; nt < kNT; ++nt) {\n    const int col",
         "    }\n  }\n\n#pragma unroll\n"
         "  for (int nt = 0; nt < kNT; ++nt) {\n    const int col"),
        ("mma_k_step<C, kFirst, decltype(zero_start)::value>(part, sw_step, b);",
         "mma_k_step<C, kFirst, false>(acc, sw_step, b);"))(text)


VARIANTS = (
    ("committed", lambda t: t),
    ("chunk 1", replace(("constexpr int kChunk = 4;",
                         "constexpr int kChunk = 1;"))),
    ("no re-accumulation", no_reaccumulation),
    ("no a_lo", replace(
        (MMA_LO_B_HI.format("zero"),
         "for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;"),
        (MMA_LO_B_HI.format("part[mt][nt]"), ""))),
    ("no b_lo", replace((MMA_HI_LO, ""))),
)


def build_variants():
    from ddsp_svc_tpu_torch.ops import build
    nvcc = build.nvcc_path()
    procs = []
    for name, edit in VARIANTS:
        d = os.path.join(WORK, name.replace(" ", "_"))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(CSRC, HEADER)) as f:
            text = edit(f.read())
        with open(os.path.join(d, HEADER), "w") as f:
            f.write(text)
        for src in SOURCES:
            shutil.copy(os.path.join(CSRC, f"{src}.cu"), d)
            lib = os.path.join(d, f"{src}.so")
            procs.append((name, src, lib, subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, "-o", lib,
                 os.path.join(d, f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = {name: {} for name, _ in VARIANTS}
    for name, src, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name} {src}.cu:\n"
                     f"{out.decode(errors='replace')}")
        libs[name][src] = lib
    return libs


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this tool runs on the card")
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

    def trio(c, t, wide):
        if wide:
            def draw(*shape):
                u = torch.rand(shape, generator=gen, device="cuda")
                sign = torch.randint(0, 2, shape, generator=gen,
                                     device="cuda") * 2 - 1
                return sign * 10.0 ** (6 * u - 3)
            ws = [draw(3, 2, c, c, k) for k in (3, 7, 11)]
            x = draw(1, t, c)
        else:
            ws = [torch.randn((3, 2, c, c, k), generator=gen, device="cuda")
                  * (2.0 / (k * c)) ** 0.5 for k in (3, 7, 11)]
            x = torch.randn((1, t, c), generator=gen, device="cuda")
        bs = [torch.randn((3, 2, c), generator=gen, device="cuda") * 0.01
              for _ in range(3)]
        ref64 = K.resblocks_inject_plain(
            x.double(), None, None, None, [w.double() for w in ws],
            [b.double() for b in bs], 1)
        return x, ws, bs, ref64

    cases = {"path C=64 T=65536": trio(64, 65536, False),
             "wide C=64": trio(64, 1000, True),
             "wide C=16": trio(16, 1000, True)}
    x, ws, bs, ref64 = cases["path C=64 T=65536"]
    ref32 = K.resblocks_inject_plain(x, None, None, None, ws, bs, 1)
    line = "fp32 cuDNN chain vs float64:"
    for label, (xc, wc, bc, r) in cases.items():
        p32 = K.resblocks_inject_plain(xc, None, None, None, wc, bc, 1)
        line += (f" {label} {((p32.double() - r).abs().max() / r.abs().max()).item():.3e}"
                 " x max|ref|;")
    print(line, flush=True)

    def use(name):
        for src, lib in libs[name].items():
            build._loaded[src] = ctypes.CDLL(lib)

    # #10 at the C = 64 stage at each k, #11 at the three narrow stages:
    # (label, kernel, plain, args)
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    others = []
    for k in (3, 7, 11):
        others.append((f"#10 k={k}", K.fused_resblock_chain,
                       K.resblock_chain_plain,
                       [randn(1, 65536, 64),
                        randn(3, 2, 64, 64, k, scale=(2.0 / (k * 64)) ** 0.5),
                        randn(3, 2, 64, scale=0.01), k]))
    for c, s in ((64, 4), (32, 2), (16, 1)):
        t_out = 262144 // s
        others.append((f"#11 C={c}", K.fused_stage, K.stage_plain,
                       [randn(1, t_out // 2, 2 * c),
                        randn(1, 262144, 1, scale=0.1),
                        randn(2 * c, c, 4, scale=(1.0 / (8 * c)) ** 0.5),
                        randn(c, scale=0.05),
                        randn(c, 1, 2 * s if s > 1 else 1, scale=0.2),
                        randn(c, scale=0.05),
                        [randn(3, 2, c, c, k, scale=(2.0 / (k * c)) ** 0.5)
                         for k in (3, 7, 11)],
                        [randn(3, 2, c, scale=0.01) for _ in range(3)], 2, s]))

    def f64(args):
        return [[a.double() for a in v] if isinstance(v, list)
                else v.double() if torch.is_tensor(v) else v for v in args]

    refs = []
    for label, _, plain, args in others:
        r64, r32 = plain(*f64(args)), plain(*args)
        refs.append((r64, r32))
        scale = r64.abs().max().item()
        print(f"{label}: max|ref| {scale:.3f}; fp32 plain (cuDNN) vs float64 "
              f"{(r32.double() - r64).abs().max().item() / scale:.3e} x "
              "max|ref|", flush=True)

    def time_ms():
        fn = lambda: K.fused_resblocks(x, ws, bs)  # noqa: E731
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
        return float(np.median(times))

    names = [n for n, _ in VARIANTS]
    for name in names:
        use(name)
        line = f"[{name}] vs float64:"
        for label, (xc, wc, bc, r) in cases.items():
            got = K.fused_resblocks(xc, wc, bc).double()
            line += f" {label} {((got - r).abs().max() / r.abs().max()).item():.3e};"
        err32 = (K.fused_resblocks(x, ws, bs) - ref32).abs().max().item()
        print(line + f" vs fp32 chain at the path shape: max|err| {err32:.3e}",
              flush=True)
        for (label, kern, _, args), (r64, r32) in zip(others, refs):
            got = kern(*args)
            e64 = ((got.double() - r64).abs().max() / r64.abs().max()).item()
            e32 = (got - r32).abs().max().item()
            print(f"[{name}] {label}: vs float64 {e64:.3e} x max|ref|; vs fp32 "
                  f"plain max|err| {e32:.3e}", flush=True)
    times = {n: [] for n in names}
    for order in (names, names[::-1], names):
        for name in order:
            use(name)
            times[name].append(time_ms())
    for name in names:
        print(f"[{name}] C=64 T=65536: "
              + " / ".join(f"{t:.3f}" for t in times[name]) + " ms", flush=True)


if __name__ == "__main__":
    main()
