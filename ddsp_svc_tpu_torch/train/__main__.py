"""Training entry point:

    python -m ddsp_svc_tpu_torch.train -c configs/combsub.yaml --max-steps N
    python -m ddsp_svc_tpu_torch.train -c CFG --num-processes 4 \
        --coordinator 127.0.0.1:29500 --process-id R --n-model 2 [--backend gloo]

Counterpart of the root `train.py`: builds the model from the config
(weights from seed 0), AdamW from `train.lr` / `train.weight_decay`, resumes
from the newest checkpoint in `env.expdir` if there is one, and runs the
solver loop with the config's train options (steps_per_dispatch,
data_on_device, remat, async_save; train/solver.py). Runs on CUDA, where
a K-step dispatch and the device pool replay a captured CUDA graph of the
step; `--device cpu` runs the plain versions on the CPU, K steps as K
eager steps.

The mesh flags are train.py's: with --num-processes N > 1 each process
(one rank, one device: card R modulo the cards here) joins the group at
--coordinator (`parallel.init_distributed`, NCCL on CUDA and Gloo on the
CPU unless --backend says), and the ranks train data- and tensor-parallel
on a (N / n_model) x n_model mesh: the model and its optimizer state cut
by `parallel.shard_train_state` after any resume, each global batch's rows
split over 'data'. Every rank runs the same command but --process-id;
rank 0 writes the logs and the checkpoints (the gathered single-device
state, which any mesh or one process resumes). One process with
--n-model 1 is the single-device run.
"""
from __future__ import annotations

import argparse

from ..data.dataset import get_data_loaders
from ..models.factory import build_model
from ..models.losses import RSSLoss
from ..parallel import init_distributed, make_mesh, shard_train_state
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
    p.add_argument("--no-data-parallel", action="store_true",
                   help="train in one process, on no mesh")
    p.add_argument("--n-model", type=int, default=1,
                   help="tensor-parallel axis size (ranks = data x model)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port where rank 0 listens")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="process-group backend (default: nccl on CUDA, "
                        "gloo on the CPU)")
    return p.parse_args(argv)


def join_mesh(cmd, device):
    """The (data, model) mesh of --num-processes ranks, or None for one
    process with --n-model 1 (or --no-data-parallel)."""
    if cmd.no_data_parallel:
        if cmd.num_processes > 1 or cmd.n_model > 1:
            raise ValueError("--no-data-parallel trains one process alone")
        return None
    if cmd.num_processes == 1 and cmd.n_model == 1:
        return None
    if cmd.n_model < 1 or cmd.num_processes % cmd.n_model:
        raise ValueError(f"--n-model {cmd.n_model} must divide "
                         f"--num-processes {cmd.num_processes}")
    init_distributed(cmd.coordinator, cmd.num_processes, cmd.process_id,
                     backend=cmd.backend, device=device)
    return make_mesh(n_data=cmd.num_processes // cmd.n_model,
                     n_model=cmd.n_model, device=device)


def main(argv=None):
    """Returns (state, saver) of the finished run."""
    cmd = parse_args(argv)
    args = load_config(cmd.config)
    device = resolve_device(cmd.device)
    mesh = join_mesh(cmd, device)
    if mesh is not None:
        device = mesh.device
    print(" > config:", cmd.config)
    print(" > device:", device)
    if mesh is not None:
        print(f" > mesh: data={mesh.size('data')} x "
              f"model={mesh.size('model')}, rank {cmd.process_id}")
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
    if mesh is not None:
        shard_train_state(state, mesh)
    rss = RSSLoss(fft_min=int(args.loss.fft_min),
                  fft_max=int(args.loss.fft_max),
                  n_scale=int(args.loss.n_scale))
    return solver.train(args, initial_step, state, rss, loader_train,
                        dataset_valid, max_steps=cmd.max_steps, mesh=mesh)


if __name__ == "__main__":
    main()
