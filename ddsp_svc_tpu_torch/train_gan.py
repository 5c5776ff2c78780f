"""Enhancer GAN fine-tuning entry point:

    python -m ddsp_svc_tpu_torch.train_gan -c configs/combsub.yaml \
        [--max-steps N] [--device cpu]

Counterpart of the root `train_gan.py`: fine-tunes the NSF-HiFiGAN
enhancer adversarially on the dataset's ground-truth audio with the
`train.gan` config block (train/gan_solver.py), the generator warm-started
from `enhancer.ckpt`. Checkpoints G + D + optimizers to `<gan
expdir>/gan_{step}.pt` (rerun the same command to resume) and exports
`<gan expdir>/enhancer/model_{step|best}.pt` + config.json: point
`enhancer.ckpt` at it to convert with the fine-tuned enhancer. Runs on
CUDA; `--device cpu` runs the plain versions of the kernels on the CPU.
"""
from __future__ import annotations

import argparse

from .train.gan_solver import train_gan
from .utils.config import load_config


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Fine-tune the NSF-HiFiGAN enhancer with the PyTorch port")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--max-steps", type=int, default=None,
                   help="override train.gan.max_steps")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    return p.parse_args(argv)


def main(argv=None):
    """Returns (state, expdir) of the finished run."""
    cmd = parse_args(argv)
    args = load_config(cmd.config)
    state, expdir = train_gan(args, max_steps=cmd.max_steps,
                              device=cmd.device)
    print(f" [*] GAN fine-tuning done at step {state.step}; "
          f"checkpoints in {expdir}")
    return state, expdir


if __name__ == "__main__":
    main()
