"""HTTP voice-conversion API, the counterpart of the root `flask_api.py`
(on the standard library's http.server):

    python -m ddsp_svc_tpu_torch.api -m exp/model_best.pt --port 6842 \\
        [--host 127.0.0.1] [--device cpu]

    POST /voiceChangeModel
        body: WAV bytes
        query: sSpeakId (int, 1), fPitchChange (semitones, 0), threhold
            (dB, -45; the reference's spelling), enhance (true/false,
            true), fSafePrefixPadLength (s, 0), pe (f0 extractor, dio),
            sampleRate (of the response, the model's rate by default)
        response: WAV bytes (PCM16) of the converted audio; 400 with
            {"error": ...} when the request cannot be converted
    GET  -> {"status": "ok", "model": true}

Each request is one whole-window conversion through
`infer/streaming.py::SvcCore.infer`, the streaming engine's, run one at a
time (the core's step counter, which seeds each window's noise, is shared
state). The output is resampled on the CPU by `ops/resample.py`. Runs on
CUDA unless given --device cpu.
"""
from __future__ import annotations

import argparse
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .data.wavio import read_wav_bytes, wav_bytes
from .infer.streaming import SvcCore
from .ops.resample import resample

CORE = None  # the SvcCore that main() loads
CORE_LOCK = threading.Lock()


def convert_request(query: dict, body: bytes):
    """One request's query (parse_qs's lists) and wav body -> (audio,
    rate) of the response."""
    get = lambda k, d: float(query.get(k, [d])[0])  # noqa: E731
    audio, sr = read_wav_bytes(body)
    if audio.ndim > 1:
        audio = audio.mean(axis=0)
    with CORE_LOCK:
        out, out_sr = CORE.infer(
            audio.astype(np.float32), sr,
            spk_id=int(get("sSpeakId", 1)),
            pitch_adjust=get("fPitchChange", 0),
            threshold_db=get("threhold", -45),
            use_enhancer=str(query.get("enhance", ["true"])[0]).lower()
            == "true",
            safe_prefix_pad_length=get("fSafePrefixPadLength", 0),
            pitch_extractor_type=str(query.get("pe", ["dio"])[0]))
    target_sr = int(get("sampleRate", out_sr))
    if target_sr != out_sr:
        out = resample(torch.from_numpy(np.asarray(out, np.float32))[None],
                       out_sr, target_sr)[0].numpy()
        out_sr = target_sr
    return out.astype(np.float32), out_sr


class Handler(BaseHTTPRequestHandler):
    def _send(self, code, body, ctype):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        parsed = urllib.parse.urlparse(self.path)
        if parsed.path != "/voiceChangeModel":
            self.send_error(404)
            return
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        try:
            out, out_sr = convert_request(urllib.parse.parse_qs(parsed.query),
                                          body)
        except Exception as exc:
            self._send(400, json.dumps({"error": repr(exc)}).encode(),
                       "application/json")
            return
        self._send(200, wav_bytes(out, out_sr), "audio/wav")

    def do_GET(self):
        body = json.dumps({"status": "ok", "model": CORE is not None}).encode()
        self._send(200, body, "application/json")

    def log_message(self, *a):
        pass


def main(argv=None) -> None:
    global CORE
    p = argparse.ArgumentParser()
    p.add_argument("-m", "--model_path", type=str, required=True)
    p.add_argument("--port", type=int, default=6842)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    args = p.parse_args(argv)
    CORE = SvcCore(args.model_path, device=args.device)
    server = ThreadingHTTPServer((args.host, args.port), Handler)
    print(f"voice-change API at http://{args.host}:{args.port}"
          "/voiceChangeModel")
    server.serve_forever()


if __name__ == "__main__":
    main()
