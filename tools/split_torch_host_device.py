#!/usr/bin/env python3
"""Host time against device time of the FAVOR+ attention (#1) and CombSubFast
spectral (#2) kernels, on the card.

At chip_smoke.py's shapes (#1: H = 8, T = 512 at B = 1 with 384 valid frames
and at B = 16; #2: 513 rows of n_fft 1024), prints for each wrapper:
  - host ms per call: the host clock over 20 calls queued back to back
    before one synchronize, median of 5 turns after 3 warm-up calls;
  - the kernel's own device ms per call, from torch.profiler over 20 more
    calls ("not measured" where the profiler records no device time);
  - device_ms as chip_smoke.py measures it (20 calls back to back between
    one pair of CUDA events, over 20, median of 5 turns).
A wrapper whose host ms exceeds its kernel's device ms is host-bound, and
its device_ms then reads the host's rate. Run from the root of a checkout on
a machine with the card:

    python3 tools/split_torch_host_device.py
"""
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import device_ms  # noqa: E402

CALLS = 20


def host_and_kernel_ms(torch, fn, args, kernel: str):
    """(host ms per call queued back to back, median of 5 turns; device ms
    per call of the CUDA kernels whose names hold `kernel`, or None)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    hosts = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn(*args)
        hosts.append((time.perf_counter() - t0) * 1e3 / CALLS)
        torch.cuda.synchronize()
    host = statistics.median(hosts)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn(*args)
        torch.cuda.synchronize()
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and kernel in ev.name)
    return host, (us / 1e3 / CALLS if us else None)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this tool runs on the card")
    from ddsp_svc_tpu_torch.nn.pcmer import gaussian_orthogonal_random_matrix
    from ddsp_svc_tpu_torch.ops import kernels as K
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale + shift

    proj = torch.from_numpy(gaussian_orthogonal_random_matrix(266, 64, 0)).cuda()
    r, n = 513, 1024
    bins = n // 2 + 1
    cases = [
        ("performer_attention B=1 T=512 valid=384", "favor_kernel",
         K.performer_attention,
         tuple(randn(1, 8, 512, 64) for _ in range(3)) + (proj, 384)),
        ("performer_attention B=16 T=512", "favor_kernel", K.performer_attention,
         tuple(randn(16, 8, 512, 64) for _ in range(3)) + (proj, None)),
        ("combsub_spectral 513 x 1024", "combsub_spectral_kernel",
         K.combsub_spectral,
         (randn(r, n), randn(r, n), randn(r, bins, scale=0.3), randn(r, bins),
          randn(r, bins, scale=0.3, shift=-3.0), n)),
    ]
    for name, kernel, fn, args in cases:
        host, kern = host_and_kernel_ms(torch, fn, args, kernel)
        print(f"{name}: host {host:.4f} ms per call queued back to back; "
              "kernel's own device time "
              + ("not measured (the profiler recorded none)" if kern is None
                 else f"{kern:.4f} ms per call (torch.profiler)")
              + f"; device_ms {device_ms(torch, fn, [args]):.4f}", flush=True)


if __name__ == "__main__":
    main()
