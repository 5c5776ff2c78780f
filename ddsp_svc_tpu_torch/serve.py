"""Model-code-free serving, the counterpart of the root `tools/serve.py`: an
HTTP voice-conversion server over a synthesizer exported by
`python -m ddsp_svc_tpu_torch.export`.

The program pins (batch, frames), so every request runs the same traced
graph; long inputs run in fixed windows with a cross-faded overlap. The
feature front end (f0, volume, units) is the only model code involved: the
synthesizer needs no checkpoint and no module definition at serve time,
only config.yaml and the artifact. The kernels the program holds are the
`ddsp_svc::` custom ops, registered by importing `ops/kernels.py` before
the program is loaded.

    python -m ddsp_svc_tpu_torch.export -m exp/model_best.pt \\
        -o exp/model.pt2 --frames 256
    python -m ddsp_svc_tpu_torch.serve -a exp/model.pt2 -c exp/config.yaml \\
        --port 8080 [--host 127.0.0.1 -pe dio --overlap-frames 8 -th -60] \\
        [--device cpu]

    POST /convert?spk_id=1&key=0   body: wav           -> wav (model sr)
    POST /voiceChangeModel         sSpeakId, fPitchChange (the API's keys)
    GET  /healthz                  -> {"status": "ok", ...}

Runs on CUDA, where the artifact must have been exported; `--device cpu`
serves a CPU artifact.
"""
from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .data.features import F0Extractor, UnitsEncoder, VolumeExtractor
from .data.wavio import read_wav_bytes, wav_bytes
from .ops import kernels  # noqa: F401  registers the ddsp_svc ops
from .ops.resample import resample
from .utils.config import load_config
from .utils.device import resolve_device


class ExportedSynth:
    """Windowed voice conversion over a fixed-shape exported synthesizer."""

    def __init__(self, artifact_path: str, config_path: str,
                 pitch_extractor: str = "dio", f0_min: float = 50.0,
                 f0_max: float = 1100.0, threshold_db: float = -60.0,
                 overlap_frames: int = 8, seed: int = 0, device=None):
        """device: where the program runs (CUDA unless the caller asks for
        the CPU): the device it was exported on."""
        self.device = resolve_device(device)
        self.program = torch.export.load(artifact_path)
        user = set(self.program.graph_signature.user_inputs)
        units_v, _, _, _, noise_v = [
            n.meta["val"] for n in self.program.graph.nodes
            if n.op == "placeholder" and n.name in user]
        if units_v.device.type != self.device.type:
            raise ValueError(f"{artifact_path} was exported for "
                             f"{units_v.device.type}, not {self.device}")
        self.batch, self.frames, self.n_unit = units_v.shape
        if self.batch != 1:
            raise ValueError("serving expects a batch-1 artifact")
        self.block = noise_v.shape[1] // self.frames
        self.forward = self.program.module()

        self.args = load_config(config_path)
        data = self.args.data
        self.sr = int(data.sampling_rate)
        if self.block != int(data.block_size):
            raise ValueError(f"artifact block {self.block} != config "
                             f"block_size {data.block_size}")
        self.n_spk = int(self.args.model.n_spk or 1)
        self.f0_ext = F0Extractor(pitch_extractor, self.sr, self.block,
                                  f0_min, f0_max, device=self.device)
        self.vol_ext = VolumeExtractor(self.block)
        self.units_enc = UnitsEncoder(
            data.encoder, data.encoder_ckpt, data.encoder_sample_rate,
            data.encoder_hop_size, device=self.device,
            trust_pickle=bool(data.encoder_trust_pickle))
        self.threshold_db = float(threshold_db)
        self.overlap = int(overlap_frames)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()  # one program, one call at a time

        # one warm call, so that the first request sees the steady state
        z = np.zeros
        self._call(z((1, self.frames, self.n_unit), np.float32),
                   z((1, self.frames, 1), np.float32),
                   z((1, self.frames), np.float32),
                   np.ones((1, 1), np.int64),
                   z((1, self.frames * self.block), np.float32))

    @torch.no_grad()
    def _call(self, units, f0, volume, spk_id, noise) -> np.ndarray:
        out = self.forward(*(torch.as_tensor(a, device=self.device)
                             for a in (units, f0, volume, spk_id, noise)))
        return out.cpu().numpy()

    def convert(self, audio: np.ndarray, spk_id: int = 1,
                key: float = 0.0) -> np.ndarray:
        """audio (T,) float32 at the model's rate -> converted audio."""
        if not 1 <= int(spk_id) <= self.n_spk:
            raise ValueError(f"spk_id {spk_id} out of range [1, {self.n_spk}]")
        f0 = self.f0_ext.extract(audio, uv_interp=True) * 2.0 ** (key / 12.0)
        volume = self.vol_ext.extract(audio)
        units = self.units_enc.encode(audio[None], self.sr, self.block)
        n_f = min(len(f0), len(volume), units.shape[1])

        # the response mask with a 9-frame dilation (main.py's)
        mask = (volume[:n_f] > 10 ** (self.threshold_db / 20)).astype(
            np.float32)
        mask = np.pad(mask, (4, 4), constant_values=(mask[0], mask[-1]))
        mask = np.array([np.max(mask[n: n + 9]) for n in range(n_f)])
        mask_up = np.repeat(mask, self.block)

        F = self.frames
        step = max(F - self.overlap, 1)
        out = np.zeros(n_f * self.block, dtype=np.float32)
        weight = np.zeros(n_f * self.block, dtype=np.float32)
        fade = np.ones(F * self.block, dtype=np.float32)
        ramp = np.linspace(0.0, 1.0, self.overlap * self.block,
                           endpoint=False)
        fade[: len(ramp)] = ramp
        fade[len(fade) - len(ramp):] = ramp[::-1]

        spk = np.asarray([[int(spk_id)]], dtype=np.int64)
        for start in range(0, n_f, step):
            sl = slice(start, start + F)
            u = units[:, sl, :]
            f = f0[sl][None, :, None].astype(np.float32)
            v = volume[sl][None, :].astype(np.float32)
            valid = u.shape[1]
            if valid < F:  # the tail window: edge-padded to the pinned shape
                u = np.pad(u, ((0, 0), (0, F - valid), (0, 0)))
                f = np.pad(f, ((0, 0), (0, F - valid), (0, 0)), mode="edge")
                v = np.pad(v, ((0, 0), (0, F - valid)))
            noise = self._rng.uniform(
                -1.0, 1.0, size=(1, F * self.block)).astype(np.float32)
            with self._lock:
                seg = self._call(u, f, v, spk, noise)[0]
            w = fade.copy()
            if start == 0:
                w[: self.overlap * self.block] = 1.0  # no left neighbour
            n_s = valid * self.block
            out[start * self.block: start * self.block + n_s] += (
                seg[:n_s] * w[:n_s])
            weight[start * self.block: start * self.block + n_s] += w[:n_s]
            if start + F >= n_f:
                break
        out /= np.maximum(weight, 1e-8)
        return (out * mask_up).astype(np.float32)


def make_handler(synth: ExportedSynth):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urllib.parse.urlparse(self.path).path == "/healthz":
                info = {"status": "ok", "frames": synth.frames,
                        "block_size": synth.block,
                        "sampling_rate": synth.sr, "n_spk": synth.n_spk,
                        "device": str(synth.device)}
                self._send(200, json.dumps(info).encode())
            else:
                self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            parsed = urllib.parse.urlparse(self.path)
            q = {k: v[0] for k, v in
                 urllib.parse.parse_qs(parsed.query).items()}
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            try:
                if parsed.path == "/voiceChangeModel":
                    spk_id = int(float(q.get("sSpeakId", q.get("spk_id", 1))))
                    key = float(q.get("fPitchChange", q.get("key", 0)))
                else:
                    spk_id = int(q.get("spk_id", 1))
                    key = float(q.get("key", 0))
                audio, sr = read_wav_bytes(body)
                if audio.ndim > 1:
                    audio = audio.mean(axis=0)
                if sr != synth.sr:  # on the CPU, as load_audio resamples
                    audio = resample(torch.from_numpy(
                        audio.astype(np.float32))[None], sr,
                        synth.sr)[0].numpy()
                t0 = time.perf_counter()
                out = synth.convert(audio, spk_id=spk_id, key=key)
                dt = time.perf_counter() - t0
                print(f"[serve] {len(audio) / synth.sr:.2f}s audio in "
                      f"{dt * 1e3:.0f} ms ({len(audio) / synth.sr / max(dt, 1e-9):.1f}x "
                      "realtime)")
                self._send(200, wav_bytes(out, synth.sr), ctype="audio/wav")
            except Exception as exc:
                self._send(400, json.dumps({"error": repr(exc)}).encode())

        def log_message(self, *a):
            pass

    return Handler


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("-a", "--artifact", required=True)
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("-pe", "--pitch_extractor", type=str, default="dio")
    p.add_argument("--overlap-frames", type=int, default=8)
    p.add_argument("-th", "--threshold", type=float, default=-60.0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' serves a CPU "
                        "artifact)")
    args = p.parse_args(argv)
    synth = ExportedSynth(args.artifact, args.config,
                          pitch_extractor=args.pitch_extractor,
                          overlap_frames=args.overlap_frames,
                          threshold_db=args.threshold, device=args.device)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(synth))
    print(f"[serve] artifact={args.artifact} frames={synth.frames} "
          f"sr={synth.sr} at http://{args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
