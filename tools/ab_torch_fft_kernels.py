#!/usr/bin/env python3
"""A/B of the design choices in the port's two FFT kernels, on the card.

Builds edited copies of `ddsp_svc_tpu_torch/csrc/dft_magnitude.cu` and
`ltv_fir_convolve.cu` (with their `fft_pow2.cuh`) next to the committed
ones, then times every variant in turns (A B C, C B A, A B C; the median of
30 CUDA-event timings each) at chip_smoke.py's shapes: #6 at the RSS loss's
16 sizes at a training batch's frame rows, #9 at 513 and 4152 rows with
impulse responses of 510 and 1022. Variants:
  - committed: the sources as they are (twiddles from a short polynomial
    in the exact fraction);
  - sincospif: the twiddles from sincospif;
  - __sincosf: the twiddles from the fast intrinsics (~4e-7 off).
Beside them the one-call cuFFT yardstick (|rfft|, and the three-call
irfft(rfft * rfft) chain). Each variant's max |err| against float64 is
printed once. Run from the root of a checkout on a machine with the card:

    python3 tools/ab_torch_fft_kernels.py
"""
import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "ddsp_svc_tpu_torch", "csrc")
WORK = os.path.join(ROOT, "build", "ab_torch_fft_kernels")

# the committed twiddle's body, from its first line to its return
TWIDDLE = ("  float f = (float)num * inv_den;\n  f -= rintf(f);\n  const float q",
           "  return make_float2(cos_f, INV ? sin_f : -sin_f);")


def twiddle_from(body: str):
    """An edit of fft_pow2.cuh that replaces the twiddle's body."""
    def edit(text: str) -> str:
        start = text.index(TWIDDLE[0])
        end = text.index(TWIDDLE[1]) + len(TWIDDLE[1])
        return text[:start] + body + text[end:]
    return edit


SINCOSPIF = twiddle_from("""  float sn, cs;
  sincospif(2.0f * (float)num * inv_den, &sn, &cs);
  return make_float2(cs, INV ? sn : -sn);""")
INTRINSICS = twiddle_from("""  float f = (float)num * inv_den;
  f -= rintf(f);
  float sn, cs;
  __sincosf(6.28318530717958648f * f, &sn, &cs);
  return make_float2(cs, INV ? sn : -sn);""")
VARIANTS = {src: {"committed": None, "sincospif": SINCOSPIF,
                  "__sincosf": INTRINSICS}
            for src in ("dft_magnitude", "ltv_fir_convolve")}
NVCC = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC"]


def build_all():
    """{(source, variant): ctypes function}, all nvcc processes at once."""
    from ddsp_svc_tpu_torch.ops.build import nvcc_path

    procs = []
    for src, variants in VARIANTS.items():
        for name, edit in variants.items():
            folder = os.path.join(WORK, f"{src}_{name}")
            os.makedirs(folder, exist_ok=True)
            for fname in (f"{src}.cu", "fft_pow2.cuh"):
                with open(os.path.join(CSRC, fname)) as f:
                    text = f.read()
                if edit is not None and fname == "fft_pow2.cuh":
                    text = edit(text)
                with open(os.path.join(folder, fname), "w") as f:
                    f.write(text)
            lib = os.path.join(folder, "lib.so")
            procs.append((src, name, lib, subprocess.Popen(
                [nvcc_path(), *NVCC, "-o", lib, os.path.join(folder, f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    fns = {}
    for src, name, lib, proc in procs:
        out = proc.communicate()[0].decode()
        if proc.returncode:
            sys.exit(f"FAIL: nvcc {src} {name}\n{out}")
        fn = getattr(ctypes.CDLL(lib), f"{src}_launch")
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 4 + [i] * 4 + [p] if src == "dft_magnitude"
                       else [p] * 3 + [i] * 4 + [p])
        fns[src, name] = fn
    return fns


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("FAIL: no CUDA device")
    from ddsp_svc_tpu_torch.models.losses import default_buckets
    from ddsp_svc_tpu_torch.ops import kernels as K

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    fns = build_all()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def dft(fn, x, n):
        l, m = K.dft_plan(n)
        chirp, bhat = K.dft_tables(n, x.device) or (None, None)
        out = torch.empty((x.shape[0], n // 2 + 1), device=x.device)
        if fn(x.data_ptr(), out.data_ptr(), K._ptr(chirp), K._ptr(bhat),
              x.shape[0], n, l, m, stream()):
            sys.exit("FAIL: dft_magnitude launch")
        return out

    def ltv(fn, a, h, n):
        out = torch.empty((a.shape[0], n), device=a.device)
        if fn(a.data_ptr(), h.data_ptr(), out.data_ptr(), a.shape[0],
              a.shape[1], h.shape[1], n, stream()):
            sys.exit("FAIL: ltv_fir_convolve launch")
        return out

    def time_ms(f, iters=30):
        for _ in range(3):
            f()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            f()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def race(src, call, library, ref, label):
        names = list(VARIANTS[src])
        times = {k: [] for k in names}
        for order in (names, names[::-1], names):
            for k in order:
                times[k].append(time_ms(lambda: call(fns[src, k])))
        errs = {k: (call(fns[src, k]).double() - ref).abs().max().item()
                for k in names}
        lib_ms = time_ms(library)
        print(f"{label}: " + ", ".join(
            f"{k} {np.median(times[k]):.4f} ms (err {errs[k]:.1e})"
            for k in names) + f", cuFFT {lib_ms:.4f} ms", flush=True)
        return {**{k: float(np.median(v)) for k, v in times.items()},
                "cuFFT": lib_ms}

    g = torch.Generator(device="cuda").manual_seed(0)
    total = {}
    for n in default_buckets(256, 2048):
        rows = 24 * ((172 * 512 - n) // n + 1)
        x = torch.randn((rows, n), generator=g, device="cuda") * 0.1
        got = race("dft_magnitude", lambda fn: dft(fn, x, n),
                   lambda: torch.abs(torch.fft.rfft(x, n)),
                   K.dft_magnitude_plain(x.double(), n),
                   f"dft_magnitude n={n} rows={rows} M={K.dft_plan(n)[1]}")
        total = {k: total.get(k, 0.0) + v for k, v in got.items()}
    print("dft_magnitude, sum over the 16 sizes: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in total.items()), flush=True)
    total = {}
    for rows in (513, 4152):
        for ir in (510, 1022):
            a = torch.randn((rows, 1024), generator=g, device="cuda")
            h = torch.randn((rows, ir), generator=g, device="cuda") * 0.02
            got = race("ltv_fir_convolve", lambda fn: ltv(fn, a, h, 2048),
                       lambda: torch.fft.irfft(torch.fft.rfft(a, 2048)
                                               * torch.fft.rfft(h, 2048), 2048),
                       K.ltv_fir_convolve_plain(a.double(), h.double(), 2048),
                       f"ltv_fir_convolve rows={rows} ir={ir}")
            total = {k: total.get(k, 0.0) + v for k, v in got.items()}
    print("ltv_fir_convolve, sum over the 4 shapes: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in total.items()), flush=True)


if __name__ == "__main__":
    main()
