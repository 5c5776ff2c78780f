"""Ahead-of-time export of the synthesizer, the counterpart of the root
`tools/export.py`: the inference forward traced by torch.export into a
program that a server loads and runs without the port's model code
(`ddsp_svc_tpu_torch/serve.py`).

    python -m ddsp_svc_tpu_torch.export -m exp/model_best.pt \\
        -o exp/model.pt2 --frames 512 [--batch 1] \\
        [--spk-mix "{1: 0.5, 2: 0.5}"] [--device cpu]

-m takes what `models.factory.load_model` reads (the port's
`model_{step}.pt`, a reference `.pt`, the JAX package's `.ckpt`), with its
config.yaml beside it. The program's signature is

    (units (B, F, n_unit), f0 (B, F, 1), volume (B, F), spk_id (B, 1)
     int64, noise (B, F * block)) -> signal (B, F * block)

at the pinned (B, F), with `infer=True` and the speaker mix baked in. The
kernels it reaches (#1, #2, #8, #9) are the `ddsp_svc::` custom ops of
`ops/kernels.py`, nodes of the graph; a loader imports that module first,
which registers them. The artifact holds tensors of the device it was
exported on (the card unless --device cpu) and runs there.
"""
from __future__ import annotations

import argparse
import os
from ast import literal_eval
from typing import Dict, Optional

import torch
import torch.nn as nn

from .models.factory import load_model
from .utils.device import resolve_device


class _InferForward(nn.Module):
    """The synthesizer's inference forward with the speaker mix fixed."""

    def __init__(self, model: nn.Module,
                 spk_mix_dict: Optional[Dict[int, float]]):
        super().__init__()
        self.model = model
        self.spk_mix_dict = spk_mix_dict

    def forward(self, units, f0, volume, spk_id, noise):
        signal, _, _ = self.model(units, f0, volume, spk_id,
                                  spk_mix_dict=self.spk_mix_dict, infer=True,
                                  noise=noise)
        return signal


def export_program(model: nn.Module, frames: int, batch: int = 1,
                   spk_mix_dict: Optional[Dict[int, float]] = None
                   ) -> torch.export.ExportedProgram:
    """`model`'s inference forward at (batch, frames), exported on the
    device of its parameters. Traced under no_grad with the parameters
    frozen, so no autograd Function enters the graph."""
    dev = next(model.parameters()).device
    block = int(model.block_size)
    n_unit = model.unit2ctrl.unit_prenet["1"].in_channels
    for p in model.parameters():
        p.requires_grad_(False)
    example = (torch.zeros((batch, frames, n_unit), device=dev),
               torch.full((batch, frames, 1), 200.0, device=dev),
               torch.zeros((batch, frames), device=dev),
               torch.ones((batch, 1), dtype=torch.int64, device=dev),
               torch.zeros((batch, frames * block), device=dev))
    with torch.no_grad():
        return torch.export.export(_InferForward(model.eval(), spk_mix_dict),
                                   example)


def export_synth(model_path: str, out_path: str, frames: int = 512,
                 batch: int = 1, spk_mix_dict=None, device=None) -> str:
    """Export the checkpoint's synthesizer to `out_path` (a `.pt2` of
    torch.export.save) on `device` (CUDA unless the caller asks for the
    CPU); returns the path."""
    model, _ = load_model(model_path, device=resolve_device(device))
    program = export_program(model, frames, batch, spk_mix_dict)
    torch.export.save(program, out_path)
    print(f"[export] {out_path}: {os.path.getsize(out_path)} bytes, "
          f"device={next(model.parameters()).device}")
    return out_path


def main(argv=None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--frames", type=int, default=512)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--spk-mix", type=str, default="None")
    p.add_argument("--device", type=str, default=None,
                   help="torch device the program runs on (default: cuda; "
                        "'cpu' holds the plain versions of the kernels)")
    args = p.parse_args(argv)
    return export_synth(args.model_path, args.output, frames=args.frames,
                        batch=args.batch,
                        spk_mix_dict=literal_eval(args.spk_mix),
                        device=args.device)


if __name__ == "__main__":
    main()
