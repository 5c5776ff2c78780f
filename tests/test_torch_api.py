"""PyTorch port, the voice-change HTTP API (`python -m
ddsp_svc_tpu_torch.api`) against the root `flask_api.py` on the CPU: the
same wav posted to both servers, each over its package's SvcCore on the
same checkpoint, HuBERT and NSF-HiFiGAN torch files (16 kHz, block 256),
the noise and SineGen phases injected into both; the JAX core's synth is
its masked bucketed synth, as tests/test_torch_streaming.py's `jax_core`
fixture has it (JAX's own streaming synth pads the window without
masking, ROADMAP.md queue 3). Enhancer off and on, a pitch change, a
safe-prefix pad and a response rate other than the model's; GET's status;
a 400 on an out-of-range speaker. Weights from seeds."""
import functools
import json
import threading
import urllib.error
import urllib.parse
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
import yaml

import flask_api
from ddsp_svc_tpu.infer import streaming as jstreaming
from ddsp_svc_tpu.models.factory import make_jitted_synth
from ddsp_svc_tpu_torch import api
from ddsp_svc_tpu_torch.data.wavio import read_wav_bytes, wav_bytes
from ddsp_svc_tpu_torch.infer.enhancer import NsfHifiGAN
from ddsp_svc_tpu_torch.infer.streaming import SvcCore
from ddsp_svc_tpu_torch.models.factory import build_model
from ddsp_svc_tpu_torch.nn.hubert import HubertSoft, init_hubert_
from ddsp_svc_tpu_torch.train.checkpoint import save_checkpoint
from ddsp_svc_tpu_torch.utils.config import DotDict

torch.set_num_threads(2)

SR, BLOCK, N_SPK = 16000, 256, 2
# tests/test_torch_streaming.py's enhancer geometry at 16 kHz
H = {
    "sampling_rate": 16000, "num_mels": 16, "n_fft": 512, "win_size": 512,
    "hop_size": 128, "fmin": 40, "fmax": 8000,
    "upsample_rates": [4, 4, 8], "upsample_kernel_sizes": [8, 8, 16],
    "upsample_initial_channel": 32, "resblock": "1",
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
}
# tests/test_torch_streaming.py::test_svc_core_infer_matches_jax's
# tolerance (relative to max |ref|), plus one step of the PCM16 responses
TOL, PCM16 = 2e-4, 1.0 / 32767


def _sung(seconds, seed=0):
    """A sung-like line with a silence in the middle."""
    rng = np.random.default_rng(seed)
    t = np.arange(round(SR * seconds)) / SR
    f0 = 190.0 * 2 ** (np.floor(t * 3) % 4 / 12)
    ph = 2 * np.pi * np.cumsum(f0 * (1 + 0.03 * np.sin(2 * np.pi * 5.5 * t))) / SR
    x = 0.4 * np.sin(ph) + 0.15 * np.sin(2 * ph) + 0.08 * np.sin(3 * ph)
    x[(t > 0.55 * t[-1]) & (t < 0.65 * t[-1])] = 0.0
    return (x + 1e-3 * rng.standard_normal(len(t))).astype(np.float32)


class _Hooks:
    """One noise excitation and SineGen phase set per window step, drawn
    once and handed to both packages."""

    def __init__(self, seed=3):
        self.rng = np.random.default_rng(seed)
        self.noises, self.rand_inis = {}, {}

    def noise(self, step, shape):
        if step not in self.noises:
            self.noises[step] = (self.rng.random(shape) * 2 - 1).astype(
                np.float32)
        return self.noises[step]

    def rand_ini(self, step):
        if step not in self.rand_inis:
            ri = self.rng.random((1, 9)).astype(np.float32)
            ri[:, 0] = 0.0
            self.rand_inis[step] = ri
        return self.rand_inis[step]


def _serve(handler):
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """Both APIs on one experiment (config.yaml, the port's model_0.pt, a
    HuBERT-soft and an NSF-HiFiGAN checkpoint, from seeds), each core's
    noise and SineGen phases read from `hooks` by its step."""
    root = tmp_path_factory.mktemp("api")
    sd = init_hubert_(HubertSoft(), torch.Generator().manual_seed(5)).state_dict()
    w = sd.pop("positional_embedding.conv.weight")
    sd["positional_embedding.conv.weight_g"] = torch.sqrt(
        (w ** 2).sum(dim=(0, 1), keepdim=True))
    sd["positional_embedding.conv.weight_v"] = w
    torch.save(sd, root / "hubert-soft.pt")
    (root / "nsf").mkdir()
    nsf = NsfHifiGAN(None, h=H, seed=6, device="cpu")
    torch.save({"generator": nsf.model.state_dict()}, root / "nsf" / "model")
    (root / "nsf" / "config.json").write_text(json.dumps(H))
    args = {
        "data": {"sampling_rate": SR, "block_size": BLOCK,
                 "encoder": "hubertsoft", "encoder_sample_rate": 16000,
                 "encoder_hop_size": 320, "encoder_out_channels": 256,
                 "encoder_ckpt": str(root / "hubert-soft.pt")},
        "model": {"type": "CombSubFast", "n_spk": N_SPK},
        "enhancer": {"type": "nsf-hifigan",
                     "ckpt": str(root / "nsf" / "model"),
                     "bf16_min_channels": 0},
    }
    (root / "exp").mkdir()
    (root / "exp" / "config.yaml").write_text(yaml.safe_dump(args))
    ckpt = str(root / "exp" / "model_0.pt")
    save_checkpoint(ckpt, 0, build_model(DotDict(args), device="cpu", seed=7))

    hooks = _Hooks()
    core = SvcCore(ckpt, device="cpu")
    core.infer = functools.partial(core.infer, noise_hook=hooks.noise,
                                   enhancer_rand_hook=hooks.rand_ini)

    jcore = jstreaming.SvcCore(ckpt)

    def hooked_synth(spk_mix_dict):
        run = make_jitted_synth(jcore.model, jcore.variables,
                                spk_mix_dict=spk_mix_dict, mask_padding=True)

        def synth(units, f0, volume, spk_id, rng):
            return run(units, f0, volume, spk_id, rng, noise=hooks.noise(
                jcore._step, (1, units.shape[1] * BLOCK)))
        return synth

    jcore._synth = hooked_synth
    enhancer = jcore.enhancer
    enhancer.enhancer._forward = enhancer.enhancer._forward_impl
    enhance = enhancer.enhance
    enhancer.enhance = lambda *a, rng=None, **kw: enhance(
        *a, rand_ini=hooks.rand_ini(jcore._step), **kw)

    saved = api.CORE, flask_api.CORE
    api.CORE, flask_api.CORE = core, jcore
    servers = _serve(api.Handler), _serve(flask_api.Handler)
    yield servers, (core, jcore)
    for s in servers:
        s.shutdown()
        s.server_close()
    api.CORE, flask_api.CORE = saved


def _post(server, query, body):
    port = server.server_address[1]
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/voiceChangeModel?"
        + urllib.parse.urlencode(query), data=body)
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.status == 200 and r.headers["Content-Type"] == "audio/wav"
        return read_wav_bytes(r.read())


@pytest.mark.parametrize("query", [
    {"enhance": "false"},
    {"enhance": "true", "sSpeakId": 2, "fPitchChange": 2, "threhold": -50},
    {"enhance": "false", "sampleRate": 22050, "fSafePrefixPadLength": 0.2},
], ids=["enhance off", "enhance on, speaker 2, key 2", "22.05 kHz response"])
def test_api_matches_flask_api(servers, query):
    """One second of a sung line (63 frames in the 64-frame bucket) posted
    to both servers: the same rate and length, within 2e-4 of max |ref|
    plus one PCM16 step."""
    (server, jserver), cores = servers
    body = wav_bytes(_sung(1.0, seed=1), SR)
    for c in cores:
        c._step = 0
    got, sr = _post(server, query, body)
    ref, sr_ref = _post(jserver, query, body)
    assert sr == sr_ref == int(query.get("sampleRate", SR))
    assert got.shape == ref.shape and np.abs(ref).max() > 1e-3
    err = np.abs(got - ref).max()
    assert err <= TOL * np.abs(ref).max() + PCM16, err / np.abs(ref).max()


def test_api_status_and_errors(servers):
    """GET answers the status; a speaker out of range answers 400 with the
    error, not a dropped connection."""
    (server, _), _ = servers
    port = server.server_address[1]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok", "model": True}
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, {"sSpeakId": N_SPK + 1},
              wav_bytes(_sung(0.5), SR))
    assert e.value.code == 400 and b"out of range" in e.value.read()
