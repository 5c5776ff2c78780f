#!/usr/bin/env python3
"""Host time against device time of the kernels whose calls are short, on
the card: the FAVOR+ attention (#1), the CombSubFast spectral chain (#2),
the NSF harmonic source (#3) and the Sins oscillator bank (#8).

At chip_smoke.py's shapes (#1: H = 8, T = 512 at B = 1 with 384 valid frames
and at B = 16; #2: 513 rows of n_fft 1024; #3: 512 mel frames x upp 512, 9
harmonics; #8: 1 x 512 and 24 x 172 frames of block 512, 128 harmonics),
prints for each wrapper:
  - host ms per call: the host clock over 20 calls queued back to back
    before one synchronize, median of 5 turns after 3 warm-up calls;
  - the kernel's own device ms per call, from torch.profiler over 20 more
    calls ("not measured" where the profiler records no device time);
  - device_ms as chip_smoke.py measures it (20 calls back to back between
    one pair of CUDA events, over 20, median of 5 turns).
A wrapper whose host ms exceeds its kernel's device ms is host-bound, and
its device_ms then reads the host's rate. With --parent DIR the wrappers and
kernels of the checkout at DIR (e.g. an earlier commit unpacked with `git
archive` under build/) are imported beside this checkout's, under another
package name, and measured on the same inputs, the host times of the two
in alternating turns (this, parent, parent, this, ...; medians over the
turns), since the host's pace moves between processes. Run from the root
of a checkout on a machine with the card:

    python3 tools/split_torch_host_device.py [--parent DIR]
"""
import argparse
import importlib
import importlib.util
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import device_ms  # noqa: E402

CALLS = 20


def host_ms(torch, fn, args) -> float:
    """Host ms per call over CALLS calls queued back to back before one
    synchronize, after 3 warm-up calls."""
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn(*args)
    ms = (time.perf_counter() - t0) * 1e3 / CALLS
    torch.cuda.synchronize()
    return ms


def kernel_ms(torch, fn, args, kernel: str):
    """Device ms per call of the CUDA kernels whose names hold `kernel`
    (torch.profiler over CALLS calls), or None."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn(*args)
        torch.cuda.synchronize()
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and kernel in ev.name)
    return us / 1e3 / CALLS if us else None


def parent_kernels(root: str):
    """ops.kernels of the ddsp_svc_tpu_torch under `root`, imported as the
    package parent_ddsp_svc_tpu_torch (its imports are relative)."""
    pkg = os.path.join(os.path.abspath(root), "ddsp_svc_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_ddsp_svc_tpu_torch", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{spec.name}.ops.kernels")


def cases(torch, K, randn, gen):
    """(label, kernel name, wrapper, args) at chip_smoke.py's
    shapes."""
    from ddsp_svc_tpu_torch.nn.nsf_hifigan import _source_phase
    from ddsp_svc_tpu_torch.nn.pcmer import gaussian_orthogonal_random_matrix
    proj = torch.from_numpy(
        gaussian_orthogonal_random_matrix(266, 64, 0)).cuda()
    out = [
        ("performer_attention B=1 T=512 valid=384", "favor_kernel",
         K.performer_attention,
         tuple(randn(1, 8, 512, 64) for _ in range(3)) + (proj, 384)),
        ("performer_attention B=16 T=512", "favor_kernel",
         K.performer_attention,
         tuple(randn(16, 8, 512, 64) for _ in range(3)) + (proj, None))]
    r, n = 513, 1024
    bins = n // 2 + 1
    out.append(("combsub_spectral 513 x 1024", "combsub_spectral_kernel",
                K.combsub_spectral,
                (randn(r, n), randn(r, n), randn(r, bins, scale=0.3),
                 randn(r, bins), randn(r, bins, scale=0.3, shift=-3.0), n)))
    f0 = 100 + 400 * torch.rand((1, 512), generator=gen, device="cuda")
    ri = torch.rand((1, 9), generator=gen, device="cuda")
    ri[:, 0] = 0
    start, rad = _source_phase(f0, 512, 44100, ri, 8)
    out.append(("harmonic_source 512 frames x upp 512",
                "harmonic_source_kernel", K.harmonic_source,
                (start.contiguous(), rad.contiguous(), randn(9, scale=0.3),
                 randn(1, scale=0.05), 512)))
    for b, f in ((1, 512), (24, 172)):
        phase = (torch.rand((b, f * 512), generator=gen, device="cuda")
                 * 2 - 1) * math.pi
        amps = torch.rand((b, f, 128), generator=gen, device="cuda") * 0.1
        out.append((f"oscillator_bank {b} x {f} frames x 128 harmonics",
                    "oscillator_bank_kernel", K.oscillator_bank,
                    (phase, amps, 512)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default="",
                    help="a checkout whose wrappers and kernels are measured "
                         "beside this one's")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this tool runs on the card")
    from ddsp_svc_tpu_torch.ops import kernels as K
    forms = [("this", K)]
    if a.parent:
        forms.append(("parent", parent_kernels(a.parent)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    for label, mod in forms:
        print(f"{label}: {os.path.dirname(mod.__file__)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale + shift

    with torch.no_grad():
        for name, kernel, fn, args in cases(torch, K, randn, gen):
            fns = {label: getattr(mod, fn.__name__) for label, mod in forms}
            hosts = {label: [] for label in fns}
            for turn in range(5):
                order = list(fns) if turn % 2 == 0 else list(fns)[::-1]
                for label in order:
                    hosts[label].append(host_ms(torch, fns[label], args))
            for label, f in fns.items():
                kern = kernel_ms(torch, f, args, kernel)
                print(f"{name} [{label}]: host "
                      f"{statistics.median(hosts[label]):.4f} ms per call "
                      "queued back to back; kernel's own device time "
                      + ("not measured (the profiler recorded none)"
                         if kern is None else
                         f"{kern:.4f} ms per call (torch.profiler)")
                      + f"; device_ms {device_ms(torch, f, [args]):.4f}",
                      flush=True)


if __name__ == "__main__":
    main()
