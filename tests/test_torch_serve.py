"""PyTorch port, model-code-free serving against the JAX package on the
CPU: `ddsp_svc_tpu_torch.serve.ExportedSynth` over the port's exported
CombSubFast (`export_synth(..., device="cpu")`, 16 frames at 16 kHz,
block 256) against `tools/serve.py`'s over JAX's artifact of the same
`.ckpt`, with the same HuBERT-soft checkpoint (a torch file both packages
read, as tests/test_torch_cli.py shares it), dio f0, seed 0 and an overlap
of 4 frames; and the HTTP surface (`make_handler`): /healthz, /convert,
/voiceChangeModel, a 400 on an out-of-range speaker and on a body that is
no wav, and a wav at another rate. Weights from seeds."""
import os
import shutil
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import yaml
from http.server import ThreadingHTTPServer

from ddsp_svc_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from ddsp_svc_tpu.utils import convert as jconvert
from ddsp_svc_tpu_torch import serve
from ddsp_svc_tpu_torch.data.wavio import read_wav_bytes, wav_bytes
from ddsp_svc_tpu_torch.export import export_synth
from ddsp_svc_tpu_torch.models.factory import build_model
from ddsp_svc_tpu_torch.nn.hubert import HubertSoft, init_hubert_
from ddsp_svc_tpu_torch.ops.resample import resample
from ddsp_svc_tpu_torch.utils.config import DotDict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

torch.set_num_threads(2)

SR, BS, NF, N_SPK = 16000, 256, 16, 2
# tests/test_torch_cli.py's run_inference tolerance, relative to max |ref|
TOL = 2e-4
# one step of the PCM16 the HTTP responses carry
PCM16 = 1.0 / 32767


def _pcm16(audio):
    """audio as a PCM16 wav at SR carries it."""
    return read_wav_bytes(wav_bytes(audio, SR))[0]


def _song(n, f0=220.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    ph = 2 * np.pi * np.cumsum(f0 * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))) / SR
    x = 0.4 * np.sin(ph) + 0.15 * np.sin(2 * ph)
    return (x + 1e-3 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """config.yaml (HuBERT-soft from a bshall-layout torch file), a JAX
    `.ckpt` of a CombSubFast from a seed, the port's CPU artifact of it and
    JAX's; the port's ExportedSynth and JAX's, made once."""
    import export as jexport_tool
    import serve as jserve

    tmp = tmp_path_factory.mktemp("serve")
    sd = init_hubert_(HubertSoft(), torch.Generator().manual_seed(5)).state_dict()
    w = sd.pop("positional_embedding.conv.weight")
    sd["positional_embedding.conv.weight_g"] = torch.sqrt(
        (w ** 2).sum(dim=(0, 1), keepdim=True))
    sd["positional_embedding.conv.weight_v"] = w
    torch.save(sd, tmp / "hubert-soft.pt")
    cfg = {"data": {"sampling_rate": SR, "block_size": BS,
                    "encoder_out_channels": 256, "encoder": "hubertsoft",
                    "encoder_ckpt": str(tmp / "hubert-soft.pt"),
                    "encoder_sample_rate": 16000, "encoder_hop_size": 320},
           "model": {"type": "CombSubFast", "n_spk": N_SPK, "c": False}}
    config = str(tmp / "config.yaml")
    (tmp / "config.yaml").write_text(yaml.safe_dump(cfg))
    tm = build_model(DotDict(cfg), device="cpu", seed=7)
    ckpt = str(tmp / "model_1.ckpt")
    jsave_checkpoint(ckpt, 1, jconvert.convert_synth_state_dict(
        {k: v.numpy() for k, v in tm.state_dict().items()}, num_layers=3))
    artifact = export_synth(ckpt, str(tmp / "model.pt2"), frames=NF,
                            device="cpu")
    jartifact = jexport_tool.export_synth(ckpt, str(tmp / "model.stablehlo"),
                                          frames=NF, batch=1)
    kw = dict(threshold_db=-80.0, overlap_frames=4)
    synth = serve.ExportedSynth(artifact, config, device="cpu", **kw)
    jsynth = jserve.ExportedSynth(jartifact, config, **kw)
    yield synth, jsynth
    shutil.rmtree(tmp, ignore_errors=True)


def test_exported_synth_matches_jax(setup):
    """Three and a part windows (not a multiple of the window) at key 2,
    speaker 2, both from seed 0's noise: the same length, within 2e-4 of
    max |ref|; an out-of-range speaker raises, as in JAX."""
    synth, jsynth = setup
    audio = _song(3 * NF * BS + 5 * BS)
    for s in (synth, jsynth):
        s._rng = np.random.default_rng(0)
    got = synth.convert(audio, spk_id=2, key=2.0)
    ref = jsynth.convert(audio, spk_id=2, key=2.0)
    assert (synth.batch, synth.frames, synth.n_unit, synth.block) == (
        1, NF, 256, BS)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.isfinite(got).all() and np.abs(ref).max() > 1e-3
    err = np.abs(got - ref).max()
    assert err < TOL * np.abs(ref).max(), err / np.abs(ref).max()
    with pytest.raises(ValueError, match="out of range"):
        synth.convert(audio, spk_id=N_SPK + 1)


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": "audio/wav"})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        return read_wav_bytes(r.read())


def test_http_surface(setup):
    """GET /healthz; POST /convert and /voiceChangeModel, each against
    ExportedSynth.convert called directly from the same noise seed (its
    PCM16 within one step); a 22.05 kHz wav resampled on the way in; 400 with a
    JSON error on an out-of-range speaker and on a body that is no wav."""
    synth, _ = setup
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(synth))
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as r:
            assert r.status == 200 and b'"ok"' in r.read()

        # PCM16 on the way in: what the server reads is the direct call's
        # input
        body = wav_bytes(_song(2 * NF * BS, f0=196.0, seed=1), SR)
        audio = read_wav_bytes(body)[0]
        for path, spk, key in (("/convert?spk_id=1&key=0", 1, 0.0),
                               ("/voiceChangeModel?sSpeakId=2&fPitchChange=3",
                                2, 3.0)):
            synth._rng = np.random.default_rng(0)
            out, sr = _post(port, path, body)
            synth._rng = np.random.default_rng(0)
            ref = synth.convert(audio, spk_id=spk, key=key)
            assert sr == SR and out.shape == ref.shape
            assert np.isfinite(out).all() and np.abs(out).max() > 1e-4
            assert np.abs(out - _pcm16(ref)).max() <= PCM16

        body = wav_bytes(_song(int(2 * NF * BS * 22050 / SR), f0=196.0,
                               seed=2), 22050)
        synth._rng = np.random.default_rng(0)
        out, sr = _post(port, "/convert", body)
        sent = read_wav_bytes(body)[0]
        synth._rng = np.random.default_rng(0)
        ref = synth.convert(resample(torch.from_numpy(sent)[None], 22050,
                                     SR)[0].numpy())
        assert sr == SR and out.shape == ref.shape
        assert np.abs(out - _pcm16(ref)).max() <= PCM16

        for path, body in (("/convert?spk_id=3", body),
                           ("/convert", b"not a wav")):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(port, path, body)
            assert e.value.code == 400 and b"error" in e.value.read()
    finally:
        server.shutdown()
        server.server_close()
