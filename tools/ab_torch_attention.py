#!/usr/bin/env python3
"""Where the FAVOR+ attention kernel's (#1) time goes, on the card.

Builds edited copies of `ddsp_svc_tpu_torch/csrc/performer_attention.cu`
(each without one piece, so its output is wrong and only its time counts,
or with 16-CTA clusters allowed) into
build/ab_torch_attention/ (one nvcc per variant, all at once), loads each in
turn under the `performer_attention` wrapper and prints, at the offline
path's shape (B = 1, H = 8, T = 512, 384 valid frames) and the batched
forward's (B = 16, T = 512), each variant's cluster size and registers and
two device times per call, medians over five turns in alternating order:
the kernel's own time from torch.profiler, and 20 calls back to back
between one pair of CUDA events over 20. With --parent DIR it also times
DIR/performer_attention.cu, an earlier form of the kernel with the
three-launch C interface (q, k, v, proj, valid, part, ctx, out, B, H, T,
dn, ratio, stream), on the same inputs; each --source NAME=FILE times
another form of the source with today's C interface beside them.
Variants:
  - committed: the source as it is;
  - cluster 16: launches of 16 tiles or more take clusters of 16 CTAs, past
    the portable 8 (it fails where the card does not place them);
  - no keys: the key tiles are skipped (the context stays zero);
  - no reduction: the cluster barriers stay, the DSMEM sums and gathers go;
  - no output product: the query tiles' output contraction is skipped;
  - no context product: the key tiles' context contraction is skipped;
  - no projection: the feature projection's product is skipped;
  - no exp: the features are the exponent itself, not its exp;
  - no query tiles: the query phase is skipped.
Run from the root of a checkout on a machine with the card:

    python3 tools/ab_torch_attention.py [--parent DIR] [--source NAME=FILE ...]
"""
import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "ddsp_svc_tpu_torch", "csrc")
WORK = os.path.join(ROOT, "build", "ab_torch_attention")
SOURCE = "performer_attention.cu"
SHAPES = ((1, 384), (16, 512))  # (B, valid frames) at H = 8, T = 512


def replace(*pairs):
    def edit(text: str) -> str:
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"{SOURCE} has no {old!r}")
            text = text.replace(old, new)
        return text
    return edit


VARIANTS = (
    ("committed", replace()),
    ("cluster 16", replace(
        ("constexpr int kMaxCluster = 8;", "constexpr int kMaxCluster = 16;"),
        ("cudaError_t setup() {\n", "cudaError_t setup() {\n  cudaFuncSetAttribute("
         "favor_kernel<false, float>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"))),
    ("no keys", replace(("key_partials<kMxu>(k + base, v + base, st, 0, limit,",
                         "key_partials<kMxu>(k + base, v + base, st, 0, 0,"))),
    ("no reduction", replace(
        ("for (int i = lo + threadIdx.x; i < hi; i += kThreads) {",
         "for (int i = lo + threadIdx.x; i < lo; i += kThreads) {"),
        ("if (i < kCtx4 && owner != rank) {", "if (false) {"),
        ("if (i < kCtx4 && i / per != rank) own[i] = got[u];",
         "if (false) own[i] = got[u];"))),
    ("no output product", replace(
        ("for (int j = j0; j < j0 + kMP / 2; j += 4) {",
         "for (int j = j0; j < j0; j += 4) {"))),
    ("no context product", replace(
        ("for (int t = r0; t < r1; ++t) {\n      float4 vv",
         "for (int t = r0; t < r0; ++t) {\n      float4 vv"))),
    ("no projection", replace(("for (int c = 0; c < kD; c += 4) {",
                               "for (int c = 0; c < 0; c += 4) {"))),
    ("no exp", replace(("expf(", "("))),
    ("no query tiles", replace(
        ("for (int tile = rank; tile < n_tiles; tile += cs) {",
         "for (int tile = rank; tile < 0; tile += cs) {"))),
)


def build_variants(parent, extra):
    from ddsp_svc_tpu_torch.ops import build
    nvcc = build.nvcc_path()
    with open(os.path.join(CSRC, SOURCE)) as f:
        text = f.read()
    sources = [(name, edit(text)) for name, edit in VARIANTS]
    if parent:
        with open(os.path.join(parent, SOURCE)) as f:
            sources.append(("parent", f.read()))
    for name, path in extra:
        with open(path) as f:
            sources.append((name, f.read()))
    procs = []
    for name, body in sources:
        d = os.path.join(WORK, name.replace(" ", "_"))
        os.makedirs(d, exist_ok=True)
        src = os.path.join(d, SOURCE)
        with open(src, "w") as f:
            f.write(body)
        lib = os.path.join(d, "performer_attention.so")
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
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default="",
                    help="a directory holding an earlier performer_attention.cu")
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=FILE: another form of performer_attention.cu")
    a = ap.parse_args()
    extra = [tuple(x.split("=", 1)) for x in a.source]
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this tool runs on the card")
    from torch.profiler import ProfilerActivity, profile
    from ddsp_svc_tpu_torch.nn.pcmer import gaussian_orthogonal_random_matrix
    from ddsp_svc_tpu_torch.ops import build
    from ddsp_svc_tpu_torch.ops import kernels as K
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    libs = build_variants(a.parent, extra)
    gen = torch.Generator(device="cuda").manual_seed(0)
    proj = torch.from_numpy(gaussian_orthogonal_random_matrix(266, 64, 0)).cuda()
    cases = [tuple(torch.randn((b, 8, 512, 64), generator=gen, device="cuda")
                   for _ in range(3)) + (valid,) for b, valid in SHAPES]

    def parent_call(lib):
        fn = lib.performer_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p]

        def call(q, k, v, valid):
            b, h, t, d = q.shape
            lengths = torch.full((b,), valid, dtype=torch.int32, device="cuda")
            size = 266 * 65
            part = torch.empty((b * h * -(-t // 32) * size,), device="cuda")
            ctx = torch.empty((b * h * size,), device="cuda")
            out = torch.empty_like(q)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), proj.data_ptr(),
                     lengths.data_ptr(), part.data_ptr(), ctx.data_ptr(),
                     out.data_ptr(), b, h, t, d ** -0.25, 266 ** -0.5,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")
            return out
        return call

    def use(name):
        lib = ctypes.CDLL(libs[name])
        if name == "parent":
            return parent_call(lib)
        build._loaded["performer_attention"] = lib
        return lambda q, k, v, valid: K.performer_attention(q, k, v, proj, valid)

    def times(fn, args):
        fn(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn(*args)
            torch.cuda.synchronize()
        us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and "favor_" in ev.name)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn(*args)
        end.record()
        end.synchronize()
        return us / 1e3 / 10, start.elapsed_time(end) / 20

    names = ([n for n, _ in VARIANTS] + [n for n, _ in extra]
             + (["parent"] if a.parent else []))
    ref = [K.performer_attention_plain(*c[:3], proj, c[3]) for c in cases]
    usable = []
    for name in names:
        fn = use(name)
        try:
            outs = [fn(*c) for c in cases]
            torch.cuda.synchronize()
        except RuntimeError as exc:
            print(f"[{name}] does not launch: {exc}", flush=True)
            continue
        usable.append(name)
        errs = [((o - r)[:, :, :c[3]].abs().max() / r.abs().max()).item()
                for o, r, c in zip(outs, ref, cases)]
        info = "" if name == "parent" else (
            "; {cluster}-CTA clusters, {registers} registers".format(
                **K.attention_kernel_info(512)))
        print(f"[{name}] max|err| / max|ref| at B = 1 / 16: "
              + " / ".join(f"{e:.2e}" for e in errs) + info, flush=True)
    res = {n: [] for n in usable}
    for turn in range(5):
        for name in (usable if turn % 2 == 0 else usable[::-1]):
            fn = use(name)
            res[name].append([times(fn, c) for c in cases])
    for name in usable:
        t = np.median(np.array(res[name]), axis=0)  # (shape, profiler | b2b)
        print(f"[{name}] ms per call, median of 5 turns: B = 1 kernel "
              f"{t[0, 0]:.4f}, back-to-back {t[0, 1]:.4f}; B = 16 kernel "
              f"{t[1, 0]:.4f}, back-to-back {t[1, 1]:.4f}", flush=True)


if __name__ == "__main__":
    main()
