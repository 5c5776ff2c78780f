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

Data-parallel over N processes (`train.gan.data_parallel: true` in the
config; each process one rank, card R modulo the cards here):

    python -m ddsp_svc_tpu_torch.train_gan -c CFG --num-processes N \
        --coordinator 127.0.0.1:29500 --process-id R [--backend gloo]

joins the group (`parallel.init_distributed`, NCCL on CUDA and Gloo on
the CPU unless --backend says) before the loop builds its mesh;
--no-data-parallel turns the config's data_parallel off for one process.
"""
from __future__ import annotations

import argparse

from .parallel import init_distributed
from .train.gan_solver import train_gan
from .utils.config import load_config
from .utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Fine-tune the NSF-HiFiGAN enhancer with the PyTorch port")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--max-steps", type=int, default=None,
                   help="override train.gan.max_steps")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    p.add_argument("--no-data-parallel", action="store_true",
                   help="override train.gan.data_parallel to false")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port where rank 0 listens")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="process-group backend (default: nccl on CUDA, "
                        "gloo on the CPU)")
    return p.parse_args(argv)


def main(argv=None):
    """Returns (state, expdir) of the finished run."""
    cmd = parse_args(argv)
    args = load_config(cmd.config)
    device = resolve_device(cmd.device)
    if cmd.no_data_parallel:
        if cmd.num_processes > 1:
            raise ValueError("--no-data-parallel trains one process alone")
        if args.train.gan:
            args["train"]["gan"]["data_parallel"] = False
    elif cmd.num_processes > 1:
        init_distributed(cmd.coordinator, cmd.num_processes, cmd.process_id,
                         backend=cmd.backend, device=device)
    state, expdir = train_gan(args, max_steps=cmd.max_steps, device=device)
    print(f" [*] GAN fine-tuning done at step {state.step}; "
          f"checkpoints in {expdir}")
    return state, expdir


if __name__ == "__main__":
    main()
