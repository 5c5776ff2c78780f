"""Training entry point for one device:

    python -m ddsp_svc_tpu_torch.train -c configs/combsub.yaml --max-steps N

Counterpart of the root `train.py`: builds the model from the config
(weights from seed 0), AdamW from `train.lr` / `train.weight_decay`, resumes
from the newest checkpoint in `env.expdir` if there is one, and runs the
solver loop with the config's train options (steps_per_dispatch,
data_on_device, remat, async_save; train/solver.py). Runs on CUDA, where
a K-step dispatch and the device pool replay a captured CUDA graph of the
step; `--device cpu` runs the plain versions on the CPU, K steps as K
eager steps. Multi-host and mesh flags are not ported yet.
"""
from __future__ import annotations

import argparse

from ..data.dataset import get_data_loaders
from ..models.factory import build_model
from ..models.losses import RSSLoss
from ..utils.config import load_config
from ..utils.device import resolve_device
from . import solver
from .checkpoint import latest_checkpoint, restore_checkpoint
from .step import TrainState, create_optimizer


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Train a DDSP-SVC model with the PyTorch port")
    p.add_argument("-c", "--config", type=str, required=True)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    return p.parse_args(argv)


def main(argv=None):
    """Returns (state, saver) of the finished run."""
    cmd = parse_args(argv)
    args = load_config(cmd.config)
    device = resolve_device(cmd.device)
    print(" > config:", cmd.config)
    print(" > device:", device)
    model = build_model(args, device=device, seed=0)
    optimizer = create_optimizer(model, lr=float(args.train.lr),
                                 weight_decay=float(args.train.weight_decay
                                                    or 0.0))
    loader_train, dataset_valid = get_data_loaders(args)
    state = TrainState(step=0, model=model, optimizer=optimizer,
                       seed=int(args.train.seed or 0))
    initial_step = 0
    ckpt = latest_checkpoint(args.env.expdir)
    if ckpt is not None:
        print(" [*] restoring checkpoint:", ckpt)
        initial_step = restore_checkpoint(ckpt, model, optimizer)
        state.step = initial_step
    rss = RSSLoss(fft_min=int(args.loss.fft_min),
                  fft_max=int(args.loss.fft_max),
                  n_scale=int(args.loss.n_scale))
    return solver.train(args, initial_step, state, rss, loader_train,
                        dataset_valid, max_steps=cmd.max_steps)


if __name__ == "__main__":
    main()
