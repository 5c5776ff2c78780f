"""Web control panel, the counterpart of the root `webui.py` (the
standard library's http.server):

    python -m ddsp_svc_tpu_torch.webui --port 7860 [--host 127.0.0.1] \\
        [--device cpu]

The panel writes a training config derived from a template and launches
the port's entries as subprocesses (`python -m ddsp_svc_tpu_torch.
preprocess`, `.train`, `.infer`, each with the panel's --device; one job
of each name at a time, a log file each, their status polled on the
page), and TensorBoard. The /stream page drives the streaming engine
(`infer/streaming.py`: SvcCore, StreamingSession) block by block over a
wav with the GUI's tunables, returns per-block latency stats, and saves
and loads YAML settings profiles (`infer/stream_config.py`).

REPO_ROOT (where relative paths resolve, and the job logs go), JOBS and
the stream page's core cache are module globals. Runs on CUDA unless
given --device cpu.
"""
from __future__ import annotations

import argparse
import html
import json
import os
import subprocess
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .data.wavio import load_audio, write_wav
from .infer.stream_config import StreamConfig
from .infer.streaming import StreamingSession, SvcCore
from .utils.config import deep_update, load_config, save_config
from .utils.device import resolve_device

# the checkout that holds the package: the jobs run there, so that
# `python -m ddsp_svc_tpu_torch.<entry>` resolves
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = CHECKOUT
DEVICE = None  # the panel's --device: main() sets it, the jobs take it
JOBS = {}
JOB_LOCK = threading.Lock()
STREAM_CORES = {}


def _resolve(path):
    """Relative paths are relative to REPO_ROOT, wherever the server
    process was started from."""
    return path if os.path.isabs(path) else os.path.join(REPO_ROOT, path)


def launch_job(name, cmd_args):
    with JOB_LOCK:
        if name in JOBS and JOBS[name].poll() is None:
            return f"job '{name}' already running (pid {JOBS[name].pid})"
        with open(_resolve(f"webui_{name}.log"), "w") as log:
            proc = subprocess.Popen(cmd_args, stdout=log,
                                    stderr=subprocess.STDOUT, cwd=CHECKOUT)
        JOBS[name] = proc
        return f"started '{name}' (pid {proc.pid}); log: webui_{name}.log"


def entry(name, *args):
    """The command of one of the port's entries on the panel's device."""
    return [sys.executable, "-m", f"ddsp_svc_tpu_torch.{name}", *args,
            "--device", str(resolve_device(DEVICE))]


def job_status():
    out = {}
    with JOB_LOCK:
        for name, proc in JOBS.items():
            rc = proc.poll()
            out[name] = "running" if rc is None else f"exited {rc}"
    return out


def generate_config(base_config, overrides, out_path="configs/opt.yaml"):
    """A training config derived from a template, `overrides` merged in."""
    cfg = deep_update(load_config(_resolve(base_config)), overrides)
    out_path = _resolve(out_path)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    save_config(out_path, cfg)
    return out_path


def run_streaming(form_get):
    """Drive a StreamingSession block by block over a wav with the GUI's
    tunables; returns the spliced output's path and per-block latency
    stats, or saves or loads a settings profile."""
    cfg = StreamConfig(
        checkpoint_path=_resolve(form_get("model")),
        samplerate=int(form_get("samplerate", "44100")),
        block_time=float(form_get("block_time", "0.3")),
        crossfade_time=float(form_get("crossfade_time", "0.04")),
        buffer_num=int(form_get("buffer_num", "2")),
        spk_id=int(form_get("spk", "1")),
        pitch_adjust=float(form_get("key", "0")),
        threshold_db=float(form_get("threshold", "-45")),
        pitch_extractor=form_get("pe", "dio"),
        use_enhancer=form_get("enhance", "true").lower() == "true",
        use_phase_vocoder=form_get("phase_vocoder", "false").lower() == "true",
    )
    if form_get("profile_save"):
        path = cfg.save(_resolve(form_get("profile_dir", "profiles")),
                        form_get("profile_save"))
        return {"saved_profile": path}
    if form_get("profile_load"):
        cfg = StreamConfig.load(_resolve(form_get("profile_dir", "profiles")),
                                form_get("profile_load"))
        return {"loaded_profile": form_get("profile_load"),
                "config": cfg.__dict__.copy()}

    in_path = _resolve(form_get("input"))
    out_path = _resolve(form_get("output", "stream_out.wav"))
    core = STREAM_CORES.get(cfg.checkpoint_path)
    if core is None:
        core = SvcCore(cfg.checkpoint_path, device=DEVICE)
        STREAM_CORES[cfg.checkpoint_path] = core
    sess = StreamingSession(core, **cfg.session_kwargs())
    audio, _ = load_audio(in_path, sr=cfg.samplerate, mono=True)
    bf = sess.block_frame
    n_blocks = len(audio) // bf
    if n_blocks == 0:
        raise ValueError(f"input shorter than one block ({len(audio)} < "
                         f"{bf} samples)")
    outs, times_ms = [], []
    for b in range(n_blocks):
        st = time.perf_counter()
        outs.append(sess.process_block(audio[b * bf: (b + 1) * bf]))
        times_ms.append((time.perf_counter() - st) * 1000)
    outs += sess.flush()  # the windows still in flight, if pipelined
    write_wav(out_path, np.concatenate(outs).astype(np.float32),
              cfg.samplerate)
    t = np.asarray(times_ms)
    return {
        "output": out_path,
        "blocks": n_blocks,
        "block_ms": round(bf / cfg.samplerate * 1000, 1),
        "latency_ms": {
            "p50": round(float(np.percentile(t, 50)), 1),
            "p95": round(float(np.percentile(t, 95)), 1),
            "max": round(float(t.max()), 1),
        },
    }


STREAM_PAGE = """<!doctype html><html><head><title>DDSP-SVC stream</title>
</head><body><h2>Realtime streaming (SOLA engine)</h2>
<form method=post action=/stream>
model: <input name=model value=exp/webui/model_best.pt><br>
input wav: <input name=input value=samples/source.wav>
output: <input name=output value=stream_out.wav><br>
samplerate: <input name=samplerate value=44100 size=6>
block time (s): <input name=block_time value=0.3 size=5>
crossfade (s): <input name=crossfade_time value=0.04 size=5>
buffer num: <input name=buffer_num value=2 size=3><br>
spk: <input name=spk value=1 size=3>
key: <input name=key value=0 size=3>
threshold (dB): <input name=threshold value=-45 size=5>
pitch extractor: <input name=pe value=dio size=10>
enhance: <input name=enhance value=true size=5>
phase vocoder: <input name=phase_vocoder value=false size=5><br>
<button name=action value=stream>Convert (streaming)</button>
<h3>Settings profiles (YAML)</h3>
dir: <input name=profile_dir value=profiles>
save as: <input name=profile_save value="">
load: <input name=profile_load value="">
<button name=action value=stream>Save / load profile</button>
</form>
<p><a href=/>back to control panel</a></p>
<pre>{msg}</pre></body></html>"""


PAGE = """<!doctype html><html><head><title>DDSP-SVC</title></head><body>
<h2>DDSP-SVC control panel (PyTorch port)</h2>
<form method=post action=/run>
<h3>1. Generate config</h3>
base config: <input name=base value=configs/combsub.yaml><br>
train path: <input name=train_path value=data/train><br>
valid path: <input name=valid_path value=data/val><br>
expdir: <input name=expdir value=exp/webui><br>
batch size: <input name=batch_size value=24><br>
<button name=action value=genconfig>Generate configs/opt.yaml</button>
<h3>2. Pipeline</h3>
<button name=action value=preprocess>Run preprocessing</button>
<button name=action value=train>Start training</button>
<button name=action value=tensorboard>Launch TensorBoard</button>
<h3>3. Inference</h3>
model: <input name=model value=exp/webui/model_best.pt>
input: <input name=input value=samples/source.wav>
output: <input name=output value=out.wav>
key: <input name=key value=0 size=3>
spk: <input name=spk value=1 size=3>
<button name=action value=infer>Convert</button>
</form>
<h3>Status</h3><pre>{status}</pre>
<p>{msg}</p>
<p><a href=/stream>realtime streaming page</a></p></body></html>"""


class Handler(BaseHTTPRequestHandler):
    def _page(self, body: str):
        data = body.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _respond(self, msg=""):
        self._page(PAGE.format(
            status=html.escape(json.dumps(job_status(), indent=2)),
            msg=html.escape(msg)))

    def _respond_stream(self, msg=""):
        self._page(STREAM_PAGE.format(msg=html.escape(msg)))

    def do_GET(self):
        if self.path.startswith("/stream"):
            self._respond_stream()
        else:
            self._respond()

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        form = urllib.parse.parse_qs(self.rfile.read(length).decode())
        get = lambda k, d="": form.get(k, [d])[0]  # noqa: E731
        if self.path.startswith("/stream"):
            try:
                msg = json.dumps(run_streaming(get), indent=2)
            except Exception as exc:
                msg = f"error: {exc!r}"
            self._respond_stream(msg)
            return
        try:
            msg = self._run_action(get("action"), get)
        except Exception as exc:  # report it; don't drop the connection
            msg = f"error: {exc!r}"
        self._respond(msg)

    def _run_action(self, action, get):
        config = _resolve(get("config", "configs/opt.yaml"))
        if action == "genconfig":
            path = generate_config(
                get("base", "configs/combsub.yaml"),
                {"data": {"train_path": get("train_path"),
                          "valid_path": get("valid_path")},
                 "env": {"expdir": get("expdir")},
                 "train": {"batch_size": int(get("batch_size", "24"))}},
                out_path=get("out", "configs/opt.yaml"))
            return f"wrote {path}"
        if action == "preprocess":
            return launch_job("preprocess", entry("preprocess", "-c", config))
        if action == "train":
            return launch_job("train", entry("train", "-c", config))
        if action == "tensorboard":
            return launch_job("tensorboard", [
                "tensorboard", "--logdir", get("expdir", "exp"), "--port",
                "6006"])
        if action == "infer":
            return launch_job("infer", entry(
                "infer", "-m", get("model"), "-i", get("input"), "-o",
                get("output"), "-k", get("key", "0"), "-id", get("spk", "1")))
        return ""

    def log_message(self, *a):
        pass


def main(argv=None) -> None:
    global DEVICE
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the stream page and the jobs "
                        "(default: cuda; 'cpu' runs the plain versions of "
                        "the kernels)")
    args = p.parse_args(argv)
    DEVICE = str(resolve_device(args.device))
    server = ThreadingHTTPServer((args.host, args.port), Handler)
    print(f"DDSP-SVC webui (PyTorch port) at http://{args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
