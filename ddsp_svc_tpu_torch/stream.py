"""Streaming (real-time) voice-conversion entry of the port, the
counterpart of the root `gui.py`, with its flags plus --device:

    python -m ddsp_svc_tpu_torch.stream -m exp/model_best.pt -i in.wav \\
        -o out.wav [-id 1 -k 0 -th -45 -sr 44100 --block-time 0.3 \\
        --crossfade-time 0.04 --buffer-num 2 -pe dio -e true \\
        --phase-vocoder --pipeline-depth 1] [--device cpu]

With -i/-o a wav file streams block by block through the real-time path
(`infer/streaming.py`: SvcCore, StreamingSession with SOLA splicing) and
each block's conversion time is printed; without -i a full-duplex sound
card stream runs live (needs the `sounddevice` package). `--config
DIR[:NAME]` loads a YAML settings profile (`infer/stream_config.py`), the
flags given explicitly override it, and `--save-config DIR[:NAME]` writes
the effective settings. Runs on CUDA; `--device cpu` runs the plain
versions of the kernels on the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from .data.wavio import load_audio, write_wav
from .infer.stream_config import StreamConfig
from .infer.streaming import StreamingSession, SvcCore


def parse_args(args=None):
    p = argparse.ArgumentParser(description="Streaming (real-time) VC")
    p.add_argument("-m", "--model_path", type=str, default=None)
    p.add_argument("-i", "--input", type=str, default=None,
                   help="input wav; omit for live sounddevice streaming")
    p.add_argument("-o", "--output", type=str, default=None)
    # tunables default to None so a loaded profile's values survive unless
    # the flag is given explicitly
    p.add_argument("-id", "--spk_id", type=int, default=None)
    p.add_argument("-k", "--pitch", type=float, default=None)
    p.add_argument("-th", "--threhold", type=float, default=None)
    p.add_argument("-sr", "--samplerate", type=int, default=None)
    p.add_argument("--block-time", type=float, default=None)
    p.add_argument("--crossfade-time", type=float, default=None)
    p.add_argument("--buffer-num", type=int, default=None)
    p.add_argument("-pe", "--pitch_extractor", type=str, default=None)
    p.add_argument("-e", "--enhance", type=str, default=None)
    p.add_argument("--phase-vocoder", action="store_true", default=None)
    p.add_argument("--pipeline-depth", type=int, default=None,
                   help="windows in flight on the device (each adds a "
                        "block of latency; overlaps device work with I/O)")
    p.add_argument("--config", type=str, default=None, metavar="DIR[:NAME]",
                   help="load a settings profile (YAML) before applying flags")
    p.add_argument("--save-config", type=str, default=None,
                   metavar="DIR[:NAME]",
                   help="write the effective settings as a profile and exit "
                        "unless -i/-m are also given")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    return p.parse_args(args=args)


def _split_profile(spec: str):
    directory, _, name = spec.partition(":")
    return directory, (name or "default")


def effective_config(cmd) -> StreamConfig:
    """The profile (if any) overlaid with the flags passed explicitly."""
    if cmd.config:
        cfg = StreamConfig.load(*_split_profile(cmd.config))
    else:
        cfg = StreamConfig(block_time=0.3, crossfade_time=0.04,
                           threshold_db=-45.0, use_phase_vocoder=False,
                           use_enhancer=True)
    overlay = (("model_path", "checkpoint_path"), ("spk_id", "spk_id"),
               ("pitch", "pitch_adjust"), ("threhold", "threshold_db"),
               ("samplerate", "samplerate"), ("block_time", "block_time"),
               ("crossfade_time", "crossfade_time"),
               ("buffer_num", "buffer_num"),
               ("pitch_extractor", "pitch_extractor"),
               ("pipeline_depth", "pipeline_depth"))
    for flag, field in overlay:
        if getattr(cmd, flag) is not None:
            setattr(cfg, field, getattr(cmd, flag))
    if cmd.enhance is not None:
        cfg.use_enhancer = cmd.enhance.lower() == "true"
    if cmd.phase_vocoder is not None:
        cfg.use_phase_vocoder = bool(cmd.phase_vocoder)
    return cfg


def make_session(cfg: StreamConfig, device=None) -> StreamingSession:
    """A StreamingSession over a SvcCore of cfg's checkpoint on `device`
    (CUDA unless the caller asks for the CPU)."""
    core = SvcCore(cfg.checkpoint_path, device=device)
    return StreamingSession(core, **cfg.session_kwargs())


def stream_file(cfg: StreamConfig, input_path: str, output_path: str,
                device=None) -> None:
    """Stream a wav file block by block through the real-time path, print
    each block's conversion time and write the spliced output."""
    sess = make_session(cfg, device)
    audio, _ = load_audio(input_path, sr=cfg.samplerate, mono=True)
    bf = sess.block_frame
    n_blocks = len(audio) // bf
    outs = []
    for b in range(n_blocks):
        t0 = time.perf_counter()
        outs.append(sess.process_block(audio[b * bf:(b + 1) * bf]))
        dt = (time.perf_counter() - t0) * 1000
        print(f"block {b + 1}/{n_blocks} | inference time (ms): {dt:.1f}")
    outs.extend(sess.flush())  # the windows still in flight
    write_wav(output_path, np.concatenate(outs).astype(np.float32),
              cfg.samplerate)
    print(f" [*] wrote {output_path}")


def stream_live(cfg: StreamConfig, device=None) -> None:
    """A full-duplex sound card stream through the real-time path."""
    try:
        import sounddevice as sd
    except ImportError:
        raise SystemExit(
            "sounddevice (PortAudio) not available - use -i/-o for file "
            "streaming through the same real-time path")
    sess = make_session(cfg, device)

    def callback(indata, outdata, frames, times, status):
        block = indata.mean(axis=1) if indata.ndim > 1 else indata
        out = sess.process_block(block.astype(np.float32))
        outdata[:] = out[: len(outdata), None].repeat(outdata.shape[1], axis=1)

    kwargs = {}
    if any(cfg.sounddevices):
        kwargs["device"] = tuple(cfg.sounddevices)
    with sd.Stream(callback=callback, blocksize=sess.block_frame,
                   samplerate=cfg.samplerate, dtype="float32", **kwargs):
        print("Start conversion - Ctrl-C to stop")
        while True:
            time.sleep(cfg.block_time)


def main(argv=None) -> None:
    cmd = parse_args(argv)
    cfg = effective_config(cmd)
    if cmd.save_config:
        path = cfg.save(*_split_profile(cmd.save_config))
        print(f" [*] saved settings profile: {path}")
        if not (cmd.input or cmd.model_path):
            return
    if not cfg.checkpoint_path:
        raise SystemExit("-m/--model_path required (or a profile with "
                         "checkpoint_path via --config)")
    if cmd.input:
        if not cmd.output:
            raise SystemExit("-o required with -i")
        stream_file(cfg, cmd.input, cmd.output, cmd.device)
    else:
        stream_live(cfg, cmd.device)


if __name__ == "__main__":
    main()
