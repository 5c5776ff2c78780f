#!/usr/bin/env python3
"""The DFT magnitude's gradient per row on rows of unequal scale, on the card.

Rows of n_fft samples scaled by 10^u, u uniform in [-4, 0] (quiet frames
beside loud ones in the RSS loss), with the upstream gradient
1 / (|X| + 1e-7) that the loss's log term gives. For each backward below,
each row's gradient is held against autograd of the plain version in
float64 on the CPU, over that row's own max |ref|; the worst and the
median row are printed at n = 614, 853, 2047, 8191:
  - kernel: the port's `dft_magnitude` (the #6 kernel forward, its
    autograd backward: the spectrum, |X| and the inverse in float64);
  - fp32 cuFFT: the same backward in fp32 with batched cuFFT;
  - fp32 cuFFT, rows scaled: each row scaled to unit max around each
    batched cuFFT call;
  - fp32 CPU: autograd of the plain version in fp32 on the CPU.
Run from the root of a checkout on a machine with the card:

    python3 tools/dft_grad_rows.py
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def fp32_backward(frames, g, n, scale_rows):
    """d frames of sum(g * |rfft(frames)|) in fp32 with batched cuFFT."""
    import torch
    s = frames.abs().amax(1, keepdim=True).clamp_min(1e-30) if scale_rows \
        else torch.ones_like(frames[:, :1])
    spec = torch.fft.rfft(frames / s, n) * s
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-12)
    spec = spec * (g / mag)
    s2 = spec.abs().amax(1, keepdim=True).clamp_min(1e-30) if scale_rows \
        else torch.ones_like(frames[:, :1])
    return torch.fft.ifft(spec / s2, n).real * (n * s2)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this tool runs on the card")
    from ddsp_svc_tpu_torch.ops import kernels as K
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    for n in (614, 853, 2047, 8191):
        gen = torch.Generator(device="cuda").manual_seed(n + 2)
        rows = 301
        scale = 10.0 ** (-4 * torch.rand((rows, 1), generator=gen,
                                         device="cuda"))
        x = torch.randn((rows, n), generator=gen, device="cuda") * scale
        x64 = x.double().cpu().requires_grad_()
        m64 = K.dft_magnitude_plain(x64, n)
        up = 1.0 / (m64.detach() + 1e-7)
        (m64 * up).sum().backward()
        ref = x64.grad
        g = up.float().cuda()
        xk = x.clone().requires_grad_()
        (K.dft_magnitude(xk, n) * g).sum().backward()
        xc = x.cpu().requires_grad_()
        (K.dft_magnitude_plain(xc, n) * up.float()).sum().backward()
        grads = {"kernel": xk.grad, "fp32 cuFFT": fp32_backward(x, g, n, False),
                 "fp32 cuFFT, rows scaled": fp32_backward(x, g, n, True),
                 "fp32 CPU": xc.grad}
        line = f"n={n}:"
        for name, got in grads.items():
            err = (got.double().cpu() - ref).abs().amax(1) / ref.abs().amax(1)
            line += (f" {name} worst {err.max().item():.3e} median "
                     f"{err.median().item():.3e};")
        print(line, flush=True)


if __name__ == "__main__":
    main()
