"""Preprocessing entry point of the port, the counterpart of the root
`preprocess.py`:

    python -m ddsp_svc_tpu_torch.preprocess -c configs/combsub.yaml [--device cpu]

Turns `{data.train_path,data.valid_path}/audio/{spk}/*.wav` into the feature
store that `python -m ddsp_svc_tpu_torch.train` reads (units, f0, f0_stat,
volume and the train pass's f0_stats.npy; `data/preprocess.py`). Runs the
units encoder (and CREPE) on CUDA; `--device cpu` runs them on the CPU. The
parselmouth family runs on the native NCCF library, built at first use.
"""
from __future__ import annotations

import argparse

from .data.preprocess import preprocess_from_config
from .utils.config import load_config


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Extract the training features with the PyTorch port")
    p.add_argument("-c", "--config", type=str, required=True)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs the units "
                        "encoder and CREPE on the CPU)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    cmd = parse_args(argv)
    preprocess_from_config(load_config(cmd.config), device=cmd.device)


if __name__ == "__main__":
    main()
