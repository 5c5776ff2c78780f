#!/usr/bin/env python3
"""The RSS loss's row-split floor at chip_smoke.py's mesh-training shape.

A data-parallel step over 2 ranks forms the whole batch's gradient as the
mean of the two halves' gradients: the same sum in another order. This
measures how far that reassociation alone moves the gradients, in one
process with no collective: combsub.yaml's CombSubFast from seed 0
(chip_smoke.py's `_mt_state`), the mesh-training phase's batch (24 x 172
frames), noise and pinned loss scales (`mt_job`, `PINNED_LOSS_IDX`), the
gradients of the whole batch's loss against those of the batch taken as
two halves of 12 rows (each half's loss over 2, accumulated). For the
config's loss eps 1e-7 and chip_smoke.py's gate eps (MT_GATE_EPS) it
prints the median and the largest relative difference (|diff| / |ref|,
L2 over each parameter tensor). cuDNN deterministic, TF32 off. Run from
the root of a checkout on a machine with the card:

    python3 tools/rss_row_split_floor.py
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> None:
    import torch
    from ddsp_svc_tpu_torch.train.step import batch_to_device, forward_signal

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    from ddsp_svc_tpu_torch.ops import build
    build.build()
    _, work, job = cs.mt_job("cuda")
    dev = torch.device("cuda")
    batch = batch_to_device(job["batch"], dev)
    noise = torch.as_tensor(job["noise"], device=dev)
    n = noise.shape[0]
    for eps in (1e-7, cs.MT_GATE_EPS):
        st, rss = cs._mt_state(torch, job, dev, None, False, eps)
        grads = []
        for rows in ((slice(None),), (slice(0, n // 2), slice(n // 2, None))):
            st.model.zero_grad(set_to_none=True)
            for r in rows:
                sub = {k: v[r] for k, v in batch.items()}
                (rss(forward_signal(st.model, sub, noise[r]), sub["audio"],
                     idx=cs.PINNED_LOSS_IDX) / len(rows)).backward()
            grads.append([p.grad.clone() for p in st.model.parameters()])
        rel = sorted(((a - b).norm() / b.norm()).item()
                     for a, b in zip(grads[1], grads[0]))
        print(f"row-split floor at loss eps {eps}: one process, batch {n} "
              f"as two halves of {n // 2} rows, the gradients against the "
              f"whole batch's over {len(rel)} tensors: median rel "
              f"{rel[len(rel) // 2]:.3e}, max {rel[-1]:.3e}", flush=True)
    cs.shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
