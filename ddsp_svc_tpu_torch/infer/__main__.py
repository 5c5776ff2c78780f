"""Offline voice-conversion CLI of the port, the counterpart of the root
`main.py`, with its flags and defaults plus --device:

    python -m ddsp_svc_tpu_torch.infer -m exp/model_best.pt -i in.wav \\
        -o out.wav -id 1 -mix "None" -k 0 -e true -pe crepe -fmin 50 \\
        -fmax 1100 -th -60 -eak 0 -sr 44100 [--device cpu]

-m takes the port's `model_{step}.pt`, a reference torch `.pt` or the JAX
package's `.ckpt` (`models.factory.load_model`), each with its config.yaml
beside it. --compat-double-key reproduces the reference's double key
change. When -i is a directory, every `*.wav` in it (sorted) is converted
into the directory -o, segments from many files packed into batches of
--batch (`infer/batch.py::run_inference_batch`). Runs on CUDA; `--device
cpu` runs the plain versions of the kernels on the CPU.
"""
from __future__ import annotations

import argparse
import glob
import os
from ast import literal_eval

from .batch import run_inference_batch
from .offline import run_inference


def parse_args(args=None):
    p = argparse.ArgumentParser()
    p.add_argument("-m", "--model_path", type=str, required=True)
    p.add_argument("-i", "--input", type=str, required=True)
    p.add_argument("-o", "--output", type=str, required=True)
    p.add_argument("-id", "--spk_id", type=str, default=1)
    p.add_argument("-mix", "--spk_mix_dict", type=str, default="None")
    p.add_argument("-k", "--key", type=str, default=0)
    p.add_argument("-e", "--enhance", type=str, default="true")
    p.add_argument("-pe", "--pitch_extractor", type=str, default="crepe",
                   help="parselmouth, dio, harvest, crepe (default)")
    p.add_argument("-fmin", "--f0_min", type=str, default=50)
    p.add_argument("-fmax", "--f0_max", type=str, default=1100)
    p.add_argument("-th", "--threhold", type=str, default=-60)
    p.add_argument("-eak", "--enhancer_adaptive_key", type=str, default=0)
    p.add_argument("-sr", "--sampling_rate", type=int, default=44100)
    p.add_argument("--compat-double-key", action="store_true")
    p.add_argument("--batch", type=int, default=16,
                   help="device batch size in directory mode")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    return p.parse_args(args=args)


def main(argv=None):
    """Returns the path of the written wav, or in directory mode the list
    of them (in the inputs' sorted order)."""
    cmd = parse_args(argv)
    eak = cmd.enhancer_adaptive_key
    common = dict(
        model_path=cmd.model_path,
        spk_id=int(cmd.spk_id),
        spk_mix_dict=literal_eval(cmd.spk_mix_dict),
        key=float(cmd.key),
        enhance=(str(cmd.enhance).lower() == "true"),
        pitch_extractor=cmd.pitch_extractor,
        f0_min=float(cmd.f0_min),
        f0_max=float(cmd.f0_max),
        threshold_db=float(cmd.threhold),
        enhancer_adaptive_key=eak if eak == "auto" else float(eak),
        sampling_rate=cmd.sampling_rate,
        compat_double_key=cmd.compat_double_key,
        device=cmd.device,
    )
    if os.path.isdir(cmd.input):
        inputs = sorted(glob.glob(os.path.join(cmd.input, "*.wav")))
        if not inputs:
            raise SystemExit(f" [x] no .wav files in {cmd.input}")
        outs = run_inference_batch(input_paths=inputs, output_dir=cmd.output,
                                   batch_size=cmd.batch, **common)
        for o in outs:
            print(f" [*] wrote {o}")
        return outs
    return run_inference(input_path=cmd.input, output_path=cmd.output,
                         **common)


if __name__ == "__main__":
    main()
