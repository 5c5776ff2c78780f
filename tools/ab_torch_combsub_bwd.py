#!/usr/bin/env python3
"""The CombSubFast spectral adjoint kernel (#7) in its block sizes, on the
card.

Builds copies of `ddsp_svc_tpu_torch/csrc/combsub_spectral_bwd.cu` into
build/ab_torch_combsub_bwd/ (one nvcc per variant, all at once, with
-Xptxas -v for the registers, spills and static shared memory), and with
--parent DIR the adjoint of the checkout at DIR (e.g. an earlier commit
unpacked with `git archive` under build/; its C launch interface must be
this checkout's). Variants:
  - blocks of at most kThreads = 128 (committed) or 256 threads;
  - each with its launch bounds asking for 768 resident threads an SM
    (at most 85 registers a thread);
  - the parent's.
At chip_smoke.py's shape (24 x 173 frame rows of n_fft 1024, g at 1e-3 of
tooth's scale) it prints for each variant its registers at that size, the
worst gradient's max |out - plain| / max |plain|, and, on 301 rows whose g,
tooth and noise are each scaled by their own 10^[-4, 0] (the last 101 with
noise at 1e-3 of tooth's scale), each gradient's worst row against the
plain adjoint in float64 on the CPU over that row's own max (the card
tests' tolerance: 2e-5); then two device times per call, medians over five
turns in alternating order: the kernel's own time from torch.profiler (10
calls), and 20 calls back to back between one pair of CUDA events. With
--parent it also builds the parent's combsub_spectral.cu (#2) and
ltv_fir_convolve.cu (#9) and checks that this checkout's give the same
bits on the same inputs. Run from the root of a checkout on a machine with
the card:

    python3 tools/ab_torch_combsub_bwd.py [--parent DIR]
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "ddsp_svc_tpu_torch", "csrc")
WORK = os.path.join(ROOT, "build", "ab_torch_combsub_bwd")
THREADS = "constexpr int kThreads = 128;"
# the kernel's launch bounds, to which a variant adds a minimum of resident
# blocks an SM (a cap on the registers)
BOUNDS = "__launch_bounds__(L / 8 > kThreads ? L / 8 : kThreads)"


def source(kernel, csrc=CSRC):
    with open(os.path.join(csrc, f"{kernel}.cu")) as f:
        return f.read()


def variants(parent: str):
    """(kernel, label, source text, include dir)."""
    committed = source("combsub_spectral_bwd")
    for needed in (BOUNDS, THREADS):
        if needed not in committed:
            raise RuntimeError(f"combsub_spectral_bwd.cu has no {needed!r}")
    out = []
    for threads in (128, 256):
        for capped in (False, True):
            label = f"kThreads={threads}"
            text = committed.replace(THREADS,
                                     f"constexpr int kThreads = {threads};")
            if capped:  # 768 threads an SM at least: <= 85 registers
                label += f" minBlocks={768 // threads}"
                text = text.replace(BOUNDS,
                                    BOUNDS[:-1] + f", {768 // threads})")
            out.append(("combsub_spectral_bwd", label + (
                " (committed)" if text == committed else ""), text, CSRC))
    if parent:
        parent_csrc = os.path.join(parent, "ddsp_svc_tpu_torch", "csrc")
        out.append(("combsub_spectral_bwd", "parent",
                    source("combsub_spectral_bwd", parent_csrc), parent_csrc))
        for kernel in ("combsub_spectral", "ltv_fir_convolve"):
            out += [(kernel, "committed", source(kernel), CSRC),
                    (kernel, "parent", source(kernel, parent_csrc),
                     parent_csrc)]
    return out


def ptxas_info(text: str, want: str):
    """(registers, spill store bytes) of the first compiled entry whose
    mangled name contains `want`."""
    name = None
    spill = 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and want in name:
            return int(m.group(1)), spill
    return None, None


def build_all(items):
    """{(kernel, label): (library path, nvcc's ptxas output)}."""
    from ddsp_svc_tpu_torch.ops import build
    nvcc = build.nvcc_path()
    procs = []
    for kernel, label, text, include in items:
        d = os.path.join(WORK, kernel, re.sub(r"[^A-Za-z0-9]+", "_", label))
        os.makedirs(d, exist_ok=True)
        src = os.path.join(d, f"{kernel}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(d, f"{kernel}.so")
        procs.append(((kernel, label), lib, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", include, "-o",
             lib, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = {}
    for key, lib, proc in procs:
        out, _ = proc.communicate()
        text = out.decode(errors="replace")
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {key}:\n{text}")
        libs[key] = (lib, text)
    return libs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default="",
                    help="a checkout whose adjoint kernel is measured beside "
                         "this one's variants")
    parent = ap.parse_args().parent
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this tool runs on the card")
    from torch.profiler import ProfilerActivity, profile
    from ddsp_svc_tpu_torch.ops import kernels as K
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    items = variants(parent)
    libs = build_all(items)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + shift

    def fn_of(key, symbol):
        fn = getattr(ctypes.CDLL(libs[key][0]), symbol)
        fn.argtypes = K._SIGNATURES[symbol]
        fn.restype = ctypes.c_int
        return fn

    def adjoint(key):
        fn = fn_of(key, "combsub_spectral_bwd_launch")

        def call(g, tooth, noise, hm, hp, nm, n):
            outs = (torch.empty_like(g), torch.empty_like(g),
                    *(torch.empty_like(hm) for _ in range(3)))
            err = fn(*(x.data_ptr() for x in (g, tooth, noise, hm, hp, nm)),
                     K.combsub_window(n, g.device).data_ptr(),
                     *(x.data_ptr() for x in outs), g.shape[0], n,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")
            return outs
        return call

    # the training shape, as chip_smoke.py makes it
    r, n = 24 * 173, 1024
    bins = n // 2 + 1
    args = (randn(r, n, scale=1e-3), randn(r, n), randn(r, n),
            randn(r, bins, scale=0.3), randn(r, bins),
            randn(r, bins, scale=0.3, shift=-3.0), n)
    plain = K.combsub_spectral_bwd_plain(*args)

    def scale():
        return 10.0 ** (-4 * torch.rand((301, 1), generator=gen, device=dev))

    s_tooth, s_noise = scale(), scale()
    s_noise[200:] = 1e-3 * s_tooth[200:]
    mixed = (randn(301, n) * scale(), randn(301, n) * s_tooth,
             randn(301, n) * s_noise, randn(301, bins, scale=0.3),
             randn(301, bins), randn(301, bins, scale=0.3, shift=-3.0), n)
    f64 = K.combsub_spectral_bwd_plain(
        *(a.double().cpu() if torch.is_tensor(a) else a for a in mixed))

    def row_errors(outs):
        return [((o.double().cpu() - ref).abs().amax(1)
                 / ref.abs().amax(1)).max().item() for o, ref in zip(outs, f64)]

    print("plain (cuFFT) mixed-scale worst rows vs float64, d_tooth d_noise "
          "d_hm d_hp d_nm: " + " ".join(
              f"{e:.3e}" for e in row_errors(K.combsub_spectral_bwd_plain(
                  *mixed))), flush=True)
    keys = [(k, lab) for k, lab, _, _ in items if k == "combsub_spectral_bwd"]
    calls = {key: adjoint(key) for key in keys}
    for key in keys:
        regs, spill = ptxas_info(libs[key][1], "ILi512E" if "parent" not in
                                 key[1] else "combsub_spectral_bwd_kernel")
        outs = calls[key](*args)
        torch.cuda.synchronize()
        err = max(((o - p).abs().max() / p.abs().max()).item()
                  for o, p in zip(outs, plain))
        rows = row_errors(calls[key](*mixed))
        print(f"[{key[1]}] {regs} registers, {spill} bytes spilled at n "
              f"{n}; {r} x {n}: worst gradient vs plain {err:.3e} x max|ref|;"
              f" mixed-scale worst rows vs float64: "
              + " ".join(f"{e:.3e}" for e in rows)
              + ("" if max(rows) <= 2e-5 and err <= 2e-5 else " (FAILS)"),
              flush=True)

    if parent:  # #2 and #9 on the shared packing helper: the same bits
        fwd = (randn(513, n), randn(513, n), randn(513, bins, scale=0.3),
               randn(513, bins), randn(513, bins, scale=0.3, shift=-3.0))
        conv = (randn(r, 1024), randn(r, 1022, scale=0.02))
        for kernel in ("combsub_spectral", "ltv_fir_convolve"):
            got = []
            for label in ("committed", "parent"):
                fn = fn_of((kernel, label), f"{kernel}_launch")
                stream = torch.cuda.current_stream().cuda_stream
                if kernel == "combsub_spectral":
                    out = torch.empty_like(fwd[0])
                    err = fn(*(x.data_ptr() for x in fwd),
                             K.combsub_window(n, dev).data_ptr(),
                             out.data_ptr(), 513, n, stream)
                else:
                    out = torch.empty((r, 2048), device=dev)
                    err = fn(conv[0].data_ptr(), conv[1].data_ptr(),
                             out.data_ptr(), r, 1024, 1022, 2048, stream)
                if err:
                    raise RuntimeError(f"{kernel} {label}: CUDA error {err}")
                got.append(out)
            torch.cuda.synchronize()
            regs = [ptxas_info(libs[kernel, label][1], "ILi512E" if kernel ==
                               "combsub_spectral" else "ILi1024E")[0]
                    for label in ("committed", "parent")]
            print(f"[{kernel}] committed and parent give the same bits: "
                  f"{torch.equal(*got)}; registers {regs[0]} and {regs[1]}",
                  flush=True)

    def times(fn):
        fn(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn(*args)
            torch.cuda.synchronize()
        us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and "combsub_spectral_bwd_kernel" in ev.name)
        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
        for _ in range(20):
            fn(*args)
        end_ev.record()
        end_ev.synchronize()
        return us / 1e3 / 10, start_ev.elapsed_time(end_ev) / 20

    res = {key: [] for key in keys}
    for turn in range(5):
        for key in (keys if turn % 2 == 0 else keys[::-1]):
            res[key].append(times(calls[key]))
    for key in keys:
        t = np.median(np.array(res[key]), axis=0)
        print(f"[{key[1]}] {r} x {n}, ms per call, median of 5 turns: kernel "
              f"{t[0]:.4f}, back-to-back {t[1]:.4f}", flush=True)


if __name__ == "__main__":
    main()
