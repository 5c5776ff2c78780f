"""PyTorch port, the web control panel (`python -m
ddsp_svc_tpu_torch.webui`): the three cases of tests/test_webui_http.py
against the port's panel, its real ThreadingHTTPServer on an ephemeral
port with REPO_ROOT, JOBS and the panel's device redirected (the panel,
genconfig's deep update of a template; a job launched as a subprocess of
the port's CLI with --device cpu, polled to its exit, a second launch
refused while it runs; the /stream page converting a wav through the
port's StreamingSession and saving and loading a YAML profile). The
stream page's checkpoint is the JAX package's `.ckpt` (bench_stream.py's),
which the port's load_model reads."""
import html
import json
import os
import threading
import time
import urllib.parse
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
import yaml

from ddsp_svc_tpu_torch import webui
from ddsp_svc_tpu_torch.data.wavio import load_audio, write_wav

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def server(tmp_path, monkeypatch):
    # route repo-root-relative artifacts (opt.yaml, job logs) into tmp
    monkeypatch.setattr(webui, "REPO_ROOT", str(tmp_path))
    monkeypatch.setattr(webui, "JOBS", {})
    monkeypatch.setattr(webui, "DEVICE", "cpu")
    (tmp_path / "configs").mkdir()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), webui.Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv, tmp_path
    srv.shutdown()
    srv.server_close()
    for proc in webui.JOBS.values():
        proc.kill()
        proc.wait()


def _get(srv, path="/"):
    port = srv.server_address[1]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, html.unescape(r.read().decode())


def _post(srv, path="/run", timeout=30, **form):
    port = srv.server_address[1]
    data = urllib.parse.urlencode(form).encode()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", data=data,
                                timeout=timeout) as r:
        return r.status, html.unescape(r.read().decode())


def test_panel_and_genconfig(server):
    srv, tmp = server
    status, body = _get(srv)
    assert status == 200 and "control panel" in body

    status, body = _post(
        srv, action="genconfig",
        base=os.path.join(REPO, "configs", "combsub.yaml"),
        train_path="/data/train", valid_path="/data/val",
        expdir="exp/web-test", batch_size="8", out="configs/opt.yaml")
    assert status == 200 and "wrote" in body
    cfg = yaml.safe_load((tmp / "configs" / "opt.yaml").read_text())
    assert cfg["data"]["train_path"] == "/data/train"
    assert cfg["train"]["batch_size"] == 8
    assert cfg["env"]["expdir"] == "exp/web-test"
    # untouched template fields survive the deep update
    assert cfg["model"]["type"] == "CombSubFast"
    assert cfg["data"]["block_size"] == 512


def test_job_launch_status_and_dedup(server):
    srv, tmp = server
    # a real subprocess of the port's CLI on the panel's device; the bogus
    # model path makes it exit quickly, which lets the polling see it end
    form = dict(action="infer", model="/nonexistent/model.pt",
                input="/nonexistent/in.wav", output=str(tmp / "out.wav"))
    status, body = _post(srv, **form)
    assert status == 200 and "started 'infer'" in body
    assert (tmp / "webui_infer.log").exists()
    args = webui.JOBS["infer"].args
    assert args[1:3] == ["-m", "ddsp_svc_tpu_torch.infer"]
    assert args[-2:] == ["--device", "cpu"]

    # a second launch while it runs is refused
    status, body2 = _post(srv, **form)
    if "started" not in body2:  # it may have finished already
        assert "already running" in body2

    deadline = time.time() + 120
    while time.time() < deadline:
        _, body = _get(srv)
        if "exited" in body:
            break
        time.sleep(0.5)
    assert "exited" in body, body[-1000:]
    assert webui.JOBS["infer"].returncode != 0  # the bogus model
    assert "nonexistent" in (tmp / "webui_infer.log").read_text()


def test_stream_page_convert_and_profiles(server):
    """GET renders the tunables form; POST converts a wav through the
    port's StreamingSession and reports per-block latency; a profile saved
    is a YAML file, and loaded echoes its values."""
    import bench_stream

    srv, tmp = server
    status, body = _get(srv, "/stream")
    assert "block_time" in body and "profile_save" in body

    sr, block = 16000, 256
    ckpt = bench_stream._make_ckpt(str(tmp), sr, block, causal=False,
                                   frame_norm=False, bf16=False)
    write_wav(str(tmp / "in.wav"), bench_stream._song(sr, 1.0).astype(
        np.float32), sr)
    status, body = _post(
        srv, "/stream", timeout=300, action="stream", model=ckpt,
        input=str(tmp / "in.wav"), output=str(tmp / "out.wav"),
        samplerate=str(sr), block_time="0.25", crossfade_time="0.04",
        buffer_num="2", spk="1", key="0", threshold="-45", pe="dio",
        enhance="false", phase_vocoder="false")
    assert status == 200
    stats = json.loads(body[body.index("{"): body.rindex("}") + 1])
    assert stats["blocks"] == 4 and stats["latency_ms"]["p95"] > 0
    out, _ = load_audio(str(tmp / "out.wav"), sr=sr, mono=True)
    assert len(out) == 4 * int(0.25 * sr)
    assert np.isfinite(out).all() and np.abs(out).max() > 0
    assert list(webui.STREAM_CORES) == [ckpt]
    assert webui.STREAM_CORES[ckpt].device.type == "cpu"

    status, body = _post(srv, "/stream", action="stream", model=ckpt,
                         block_time="0.5", spk="3",
                         profile_dir=str(tmp / "profiles"),
                         profile_save="stage")
    assert status == 200
    prof = tmp / "profiles" / "stage.yaml"
    saved = yaml.safe_load(prof.read_text())
    assert saved["block_time"] == 0.5 and saved["spk_id"] == 3

    status, body = _post(srv, "/stream", action="stream", model=ckpt,
                         profile_dir=str(tmp / "profiles"),
                         profile_load="stage")
    assert status == 200
    loaded = json.loads(body[body.index("{"): body.rindex("}") + 1])
    assert loaded["config"]["block_time"] == 0.5
    assert loaded["config"]["spk_id"] == 3
