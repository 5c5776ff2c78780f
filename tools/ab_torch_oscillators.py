#!/usr/bin/env python3
"""The two sine-bank kernels, the NSF harmonic source (#3) and the Sins
oscillator bank (#8), in their design variants, on the card.

Builds edited copies of `ddsp_svc_tpu_torch/csrc/harmonic_source.cu` and
`oscillator_bank.cu` into build/ab_torch_oscillators/ (one nvcc per
variant, all at once, with -Xptxas -v for the registers), and with
--parent DIR the two sources of the checkout at DIR (e.g. an earlier commit
unpacked with `git archive` under build/; their C launch interfaces must be
this checkout's). Variants:
  - #3: the committed source (`__sinf` of the wrapped phase), the accurate
    sinpif, and the parent's;
  - #8: the Chebyshev step (committed) and the rotation z[k+1] = z[k]
    e^{j phase}, each re-seeded every 8, 16 (committed) or 32 harmonics,
    each with the lerp split (committed) and unsplit, and the parent's.
At chip_smoke.py's shapes (#3: 512 mel frames x upp 512; #8: 1 x 512 and
24 x 172 frames of block 512, 128 harmonics, amplitudes <= 0.1) it prints
for each variant its registers (and for #8 the SASS instructions a term in
its main loop, cuobjdump), max |out - plain| (the JAX tolerances: atol
2e-5 for #3, 2e-3 for #8), max |out - f64| with the float64 evaluation of
the same formula from the same fp32 inputs, the gate 2 x the fp32 plain
version's own error + 1e-7 x max|f64|, and two device times per call,
medians over five turns in alternating order: the kernel's own time from
torch.profiler (10 calls), and 20 calls back to back between one pair of
CUDA events. Run from the root of a checkout on a machine with the card:

    python3 tools/ab_torch_oscillators.py [--parent DIR]
"""
import argparse
import ctypes
import math
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "ddsp_svc_tpu_torch", "csrc")
WORK = os.path.join(ROOT, "build", "ab_torch_oscillators")

def source(kernel, csrc=CSRC):
    with open(os.path.join(csrc, f"{kernel}.cu")) as f:
        return f.read()


def replace(kernel, *pairs):
    """The committed source of `kernel` with each (old, new) replaced."""
    text = source(kernel)
    for old, new in pairs:
        if old not in text:
            raise RuntimeError(f"{kernel}.cu has no {old!r}")
        text = text.replace(old, new)
    return text


# #8's alternatives as edits of the committed source (the Chebyshev step,
# re-seeded every 16 harmonics, the lerp split)
ROTATION = (
    ("    u[i] = 0.f;", "    u[i] = c1[i];"),
    ("        u[i] = fmaf(sn, c1[i], -__fmul_rn(cn, s1[i]));",
     "        u[i] = cn;"),
    ("""          const float next = fmaf(c2[i], s[i], -u[i]);
          u[i] = s[i];
          s[i] = next;""",
     """          const float cn = fmaf(u[i], c1[i], -__fmul_rn(s[i], s1[i]));
          s[i] = fmaf(s[i], c1[i], __fmul_rn(u[i], s1[i]));
          u[i] = cn;"""))
UNSPLIT = (
    ("""          acc0[i] = fmaf(a[q], s[i], acc0[i]);
          acc1[i] = fmaf(d[q], s[i], acc1[i]);""",
     "          acc0[i] = fmaf(fmaf(d[q], frac[i], a[q]), s[i], acc0[i]);"),
    ("    y[i] = fmaf(frac[i], acc1[i], acc0[i]);", "    y[i] = acc0[i];"))


def variants(parent: str):
    """(kernel, label, source text); the parent's sources where `parent`
    names a checkout."""
    parent_csrc = os.path.join(parent, "ddsp_svc_tpu_torch", "csrc")
    out = [("harmonic_source", "committed (__sinf)", replace("harmonic_source")),
           ("harmonic_source", "sinpif", replace("harmonic_source", (
               "__sinf(__fmul_rn(kTwoPi, ph))", "sinpif(__fmul_rn(2.f, ph))")))]
    if parent:
        out.append(("harmonic_source", "parent",
                    source("harmonic_source", parent_csrc)))
    for step, step_edits in (("chebyshev", ()), ("rotation", ROTATION)):
        for reseed in (8, 16, 32):
            for lerp, lerp_edits in (("split", ()), ("lerp", UNSPLIT)):
                label = f"{step} R={reseed} {lerp}"
                if (step, reseed, lerp) == ("chebyshev", 16, "split"):
                    label += " (committed)"
                out.append(("oscillator_bank", label, replace(
                    "oscillator_bank", *step_edits, *lerp_edits, (
                        "constexpr int kReseed = 16;",
                        f"constexpr int kReseed = {reseed};"))))
    if parent:
        out.append(("oscillator_bank", "parent",
                    source("oscillator_bank", parent_csrc)))
    return out


def build_all(items):
    """{(kernel, label): (library path, registers per kernel instance)}."""
    from ddsp_svc_tpu_torch.ops import build
    nvcc = build.nvcc_path()
    procs = []
    for kernel, label, text in items:
        d = os.path.join(WORK, kernel, re.sub(r"[^A-Za-z0-9]+", "_", label))
        os.makedirs(d, exist_ok=True)
        src = os.path.join(d, f"{kernel}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(d, f"{kernel}.so")
        procs.append(((kernel, label), lib, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = {}
    for key, lib, proc in procs:
        out, _ = proc.communicate()
        text = out.decode(errors="replace")
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {key}:\n{text}")
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        libs[key] = (lib, regs)
    return libs


def loop_slots(lib: str):
    """#8's instructions (issue slots) per term in the main loop of the
    float4 form's SASS: the median distance between the starts of
    consecutive LDS.128 pairs (a0 and slope of 4 harmonics, serving 4
    harmonics x 4 samples), over 16; None where the kernel has no such
    loop (the parent's)."""
    from ddsp_svc_tpu_torch.ops import build
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    body = next((f for f in sass.split("Function : ")[1:]
                 if f.startswith(("_Z", "oscillator")) and "ILb1E" in
                 f.split("\n")[0]), None)
    if body is None:
        return None
    ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     body)
    lds = [i for i, op in enumerate(ops) if op == "LDS.128"]
    gaps = [b - a for a, b in zip(lds[::2], lds[2::2])]
    return float(np.median(gaps)) / 16 if gaps else None


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default="",
                    help="a checkout whose two kernels are measured beside "
                         "this one's variants")
    parent = ap.parse_args().parent
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this tool runs on the card")
    from torch.profiler import ProfilerActivity, profile
    from ddsp_svc_tpu_torch.nn.nsf_hifigan import _source_phase
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
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    # the inputs: #3 as chip_smoke.py makes them; #8 at its two shapes
    f0 = 100 + 400 * torch.rand((1, 512), generator=gen, device=dev)
    ri = torch.rand((1, 9), generator=gen, device=dev)
    ri[:, 0] = 0
    start, rad = _source_phase(f0, 512, 44100, ri, 8)
    hs_args = (start.contiguous(), rad.contiguous(),
               torch.randn((9,), generator=gen, device=dev) * 0.3,
               torch.randn((1,), generator=gen, device=dev) * 0.05, 512)
    osc_cases = []
    for b, f in ((1, 512), (24, 172)):
        phase = (torch.rand((b, f * 512), generator=gen, device=dev) * 2 - 1) \
            * math.pi
        amps = torch.rand((b, f, 128), generator=gen, device=dev) * 0.1
        osc_cases.append((f"{b}x{f}", (phase, amps, 512)))
    cases = {"harmonic_source": [("512x512", hs_args)],
             "oscillator_bank": osc_cases}

    def caller(kernel, lib_path):
        lib = ctypes.CDLL(lib_path)
        fn = getattr(lib, f"{kernel}_launch")
        fn.argtypes = K._SIGNATURES[f"{kernel}_launch"]
        fn.restype = ctypes.c_int
        if kernel == "harmonic_source":
            def call(start, rad, w, b, upp):
                bsz, f, n_h = start.shape
                out = torch.empty((bsz, f * upp), device=dev)
                err = fn(start.data_ptr(), rad.data_ptr(), w.data_ptr(),
                         b.data_ptr(), out.data_ptr(), bsz * f, n_h, upp, 0.1,
                         stream())
                if err:
                    raise RuntimeError(f"CUDA error {err}")
                return out
        else:
            def call(phase, amps, block):
                bsz, f, n_h = amps.shape
                out = torch.empty_like(phase)
                err = fn(phase.data_ptr(), amps.data_ptr(), out.data_ptr(),
                         bsz * f, f, n_h, block, stream())
                if err:
                    raise RuntimeError(f"CUDA error {err}")
                return out
        return call

    plains = {"harmonic_source": K.harmonic_source_plain,
              "oscillator_bank": K.oscillator_bank_plain}
    tols = {"harmonic_source": 2e-5, "oscillator_bank": 2e-3}
    refs = {}
    for kernel, cs in cases.items():
        for name, args in cs:
            f64 = plains[kernel](*[a.double() if torch.is_tensor(a) else a
                                   for a in args])
            p32 = plains[kernel](*args)
            pe = (p32.double() - f64).abs().max().item()
            scale = f64.abs().max().item()
            refs[kernel, name] = (p32, f64, pe, 2 * pe + 1e-7 * scale)
            print(f"{kernel} {name}: fp32 plain vs float64 {pe:.3e}, max|f64| "
                  f"{scale:.4f}, gate {2 * pe + 1e-7 * scale:.3e}", flush=True)
    torch.cuda.empty_cache()

    calls = {key: caller(key[0], path) for key, (path, _) in libs.items()}
    for kernel, label, _ in items:
        fn = calls[kernel, label]
        parts = []
        for name, args in cases[kernel]:
            got = fn(*args)
            torch.cuda.synchronize()
            p32, f64, _, gate = refs[kernel, name]
            ep = (got - p32).abs().max().item()
            e64 = (got.double() - f64).abs().max().item()
            ok = ep <= tols[kernel] and e64 <= gate
            parts.append(f"{name} vs plain {ep:.2e} vs f64 {e64:.3e}"
                         f"{'' if ok else ' (FAILS)'}")
        slots = (loop_slots(libs[kernel, label][0])
                 if kernel == "oscillator_bank" else None)
        print(f"[{kernel} {label}] {libs[kernel, label][1]} registers"
              + ("" if slots is None else
                 f", {slots:.2f} SASS instructions a term in the main loop")
              + "; " + "; ".join(parts), flush=True)

    def times(fn, args, kernel):
        fn(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn(*args)
            torch.cuda.synchronize()
        us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and f"{kernel}_kernel" in ev.name)
        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
        for _ in range(20):
            fn(*args)
        end_ev.record()
        end_ev.synchronize()
        return us / 1e3 / 10, start_ev.elapsed_time(end_ev) / 20

    keys = [(k, lab) for k, lab, _ in items]
    res = {key: [] for key in keys}
    for turn in range(5):
        for key in (keys if turn % 2 == 0 else keys[::-1]):
            res[key].append([times(calls[key], args, key[0])
                             for _, args in cases[key[0]]])
    for key in keys:
        t = np.median(np.array(res[key]), axis=0)  # (shape, profiler | b2b)
        print(f"[{key[0]} {key[1]}] ms per call, median of 5 turns: "
              + "; ".join(f"{name} kernel {t[i, 0]:.4f}, back-to-back "
                          f"{t[i, 1]:.4f}"
                          for i, (name, _) in enumerate(cases[key[0]])),
              flush=True)


if __name__ == "__main__":
    main()
