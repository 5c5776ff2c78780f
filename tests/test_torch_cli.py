"""PyTorch port, the offline CLI end to end against the JAX package on the
CPU: `load_model` on its three checkpoint kinds (the port's
`model_{step}.pt`, a reference-format torch `.pt`, and the JAX package's
flax-msgpack `.ckpt` written by its own saver and read back with no
`msgpack` package), `run_inference` against the JAX package's on the same
checkpoint, HuBERT and enhancer torch files and injected randomness
(16 kHz, block 256, dio, enhancer on), the f0 cache's file names, the CLI's
flags against `main.py::parse_args`, and the CLI converting a wav with each
checkpoint kind. Weights from seeds."""
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from ddsp_svc_tpu.infer import offline as joffline
from ddsp_svc_tpu.infer.enhancer import Enhancer as JEnhancer
from ddsp_svc_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from ddsp_svc_tpu.utils import convert as jconvert
from ddsp_svc_tpu_torch.data.wavio import read_wav, write_wav
from ddsp_svc_tpu_torch.infer import __main__ as cli
from ddsp_svc_tpu_torch.infer import offline
from ddsp_svc_tpu_torch.infer.enhancer import NsfHifiGAN
from ddsp_svc_tpu_torch.models.factory import build_model, load_model
from ddsp_svc_tpu_torch.nn.hubert import HubertSoft, init_hubert_
from ddsp_svc_tpu_torch.train.checkpoint import save_checkpoint
from ddsp_svc_tpu_torch.utils.config import DotDict
from torch_tmp import tmp_path  # noqa: F401  (removed when each test ends)

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]

SR, BLOCK, N_SPK = 16000, 256, 3
# tests/test_torch_offline.py's enhancer geometry at 16 kHz
H = {
    "sampling_rate": 16000, "num_mels": 16, "n_fft": 512, "win_size": 512,
    "hop_size": 128, "fmin": 40, "fmax": 8000,
    "upsample_rates": [4, 4, 8], "upsample_kernel_sizes": [8, 8, 16],
    "upsample_initial_channel": 32, "resblock": "1",
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
}
# tests/test_torch_offline.py's convert_features tolerance, relative to
# max |ref|
TOL = 2e-4


def _wav(seconds_on, seconds_off, seconds_tail, seed=0):
    """A sung-like line (harmonics, vibrato), a silence, a second phrase."""
    rng = np.random.default_rng(seed)

    def phrase(sec, f0):
        t = np.arange(max(int(SR * sec), 1)) / SR
        inst = f0 * (1 + 0.03 * np.sin(2 * np.pi * 5.5 * t))
        ph = 2 * np.pi * np.cumsum(inst) / SR
        x = sum(a * np.sin(k * ph) for k, a in ((1, 0.4), (2, 0.15), (3, 0.08)))
        return x * np.minimum(1, np.minimum(t, t[-1] - t) / 0.02)

    audio = np.concatenate([phrase(seconds_on, 190.0),
                            np.zeros(int(SR * seconds_off)),
                            phrase(seconds_tail, 260.0)])
    return (audio + 1e-4 * rng.standard_normal(len(audio))).astype(np.float32)


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """An experiment dir (config.yaml, the port's model_0.pt), a HuBERT-soft
    checkpoint in the bshall layout and an NSF-HiFiGAN checkpoint with its
    config.json, all from seeds, and two input wavs."""
    root = tmp_path_factory.mktemp("cli")
    hubert = init_hubert_(HubertSoft(), torch.Generator().manual_seed(5))
    sd = hubert.state_dict()
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
        "data": {"sampling_rate": SR, "block_size": BLOCK, "encoder": "hubertsoft",
                 "encoder_sample_rate": 16000, "encoder_hop_size": 320,
                 "encoder_out_channels": 256,
                 "encoder_ckpt": str(root / "hubert-soft.pt")},
        "model": {"type": "CombSubFast", "n_spk": N_SPK},
        "enhancer": {"type": "nsf-hifigan", "ckpt": str(root / "nsf" / "model"),
                     "bf16_min_channels": 0},
    }
    (root / "exp").mkdir()
    (root / "exp" / "config.yaml").write_text(yaml.safe_dump(args))
    model = build_model(DotDict(args), device="cpu", seed=7)
    save_checkpoint(str(root / "exp" / "model_0.pt"), 0, model)
    write_wav(str(root / "two_phrases.wav"), _wav(5.2, 0.4, 0.6), SR)
    write_wav(str(root / "short.wav"), _wav(0.7, 0.0, 0.0, seed=1), SR)
    yield root, model
    shutil.rmtree(root, ignore_errors=True)


def _write_kind(root, model, kind) -> str:
    """model's weights as a checkpoint of `kind`, config.yaml beside it."""
    d = root / kind
    d.mkdir(exist_ok=True)
    (d / "config.yaml").write_text((root / "exp" / "config.yaml").read_text())
    sd = model.state_dict()
    if kind == "port":
        path = d / "model_12.pt"
        save_checkpoint(str(path), 12, model)
    elif kind == "reference":
        # the reference synthesizer's own buffers ride along
        path = d / "model_12.pt"
        torch.save({"global_step": 12, "optimizer": {},
                    "model": {**sd, "sampling_rate": torch.tensor(SR),
                              "block_size": torch.tensor(BLOCK)}}, path)
    elif kind == "bare":
        path = d / "model_best.pt"
        torch.save(sd, path)
    else:  # the JAX package's saver, flax msgpack
        path = d / "model_12.ckpt"
        variables = jconvert.convert_synth_state_dict(
            {k: v.numpy() for k, v in sd.items()}, num_layers=3)
        jsave_checkpoint(str(path), 12, variables,
                         opt_state={"mu": {"w": np.ones(3, np.float32)},
                                    "count": np.int32(12)})
    return str(path)


@pytest.mark.parametrize("kind", ["port", "reference", "bare", "jax"])
def test_load_model_reads_each_checkpoint_kind(exp, kind, monkeypatch):
    """Every kind loads the same weights (the JAX .ckpt through the port's
    msgpack reader with the msgpack package refused) and the config."""
    root, model = exp
    path = _write_kind(root, model, kind)
    monkeypatch.setitem(sys.modules, "msgpack", None)
    got, args = load_model(path, device="cpu")
    assert args.data.block_size == BLOCK and args.model.n_spk == N_SPK
    own = model.state_dict()
    for k, v in got.state_dict().items():
        torch.testing.assert_close(v, own[k], rtol=0, atol=0)


class _EagerJEnhancer(JEnhancer):
    """The JAX Enhancer with its mel + generator forward run op by op. Under
    jax.jit, XLA on the CPU loses the accuracy of the harmonic source's
    compensated phase scan: its error against float64 grows with the frame
    count (4.1e-4 at 672 frames, the eager form and the port 1.0e-5), which
    moves the jitted enhancer's output by 2.3e-3 of its max on this test's
    first segment (ROADMAP.md queue 3)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.enhancer._forward = self.enhancer._forward_impl


def test_run_inference_matches_jax(exp, tmp_path, monkeypatch):
    """run_inference against the JAX package's (its enhancer eager, see
    _EagerJEnhancer): the same model_0.pt, HuBERT-soft and NSF-HiFiGAN
    torch files, dio f0, key 3, the enhancer on, the noise and SineGen
    phases injected per segment; two segments (the silence split), within
    2e-4 of max |ref|. The f0 cache files carry the same names and
    values."""
    root, _ = exp
    monkeypatch.setattr(joffline, "Enhancer", _EagerJEnhancer)
    wav = str(root / "two_phrases.wav")
    rng = np.random.default_rng(3)
    noises, rand_inis = {}, {}

    def noise_hook(i, shape):
        if i not in noises:
            noises[i] = (rng.random(shape) * 2 - 1).astype(np.float32)
        return noises[i]

    def rand_hook(i):
        if i not in rand_inis:
            rand_inis[i] = np.concatenate([[0.0], rng.random(8)])[None].astype(
                np.float32)
        return rand_inis[i]

    kw = dict(spk_id=2, key=3, pitch_extractor="dio", f0_min=50.0,
              f0_max=1100.0, sampling_rate=SR, noise_hook=noise_hook,
              enhancer_rand_hook=rand_hook, output_subtype="FLOAT")
    ref_path = joffline.run_inference(
        str(root / "exp" / "model_0.pt"), wav, str(tmp_path / "ref.wav"),
        cache_dir=str(tmp_path / "jcache"), **kw)
    got_path = offline.run_inference(
        str(root / "exp" / "model_0.pt"), wav, str(tmp_path / "got.wav"),
        cache_dir=str(tmp_path / "cache"), device="cpu", **kw)
    assert len(noises) == 2
    ref, sr_ref = read_wav(ref_path)
    got, sr = read_wav(got_path)
    assert sr == sr_ref == SR and got.shape == ref.shape
    assert np.abs(got - ref).max() < TOL * np.abs(ref).max()
    names = os.listdir(tmp_path / "cache")
    assert names == os.listdir(tmp_path / "jcache") and len(names) == 1
    assert names[0].startswith("dio_50.0_1100.0_")
    assert np.array_equal(np.load(tmp_path / "cache" / names[0]),
                          np.load(tmp_path / "jcache" / names[0]))


def test_cli_flags_match_main():
    """Every flag and default of main.py::parse_args, plus --device."""
    spec = importlib.util.spec_from_file_location("jax_main", ROOT / "main.py")
    jmain = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmain)
    for argv in (["-m", "a.pt", "-i", "in.wav", "-o", "out.wav"],
                 ["-m", "a.ckpt", "-i", "in.wav", "-o", "out.wav", "-id", "3",
                  "-mix", "{1: 0.5, 2: 0.5}", "-k", "-2", "-e", "false",
                  "-pe", "harvest", "-fmin", "60", "-fmax", "900", "-th",
                  "-50", "-eak", "auto", "-sr", "22050",
                  "--compat-double-key", "--batch", "4"]):
        got = vars(cli.parse_args(argv + ["--device", "cpu"]))
        assert got.pop("device") == "cpu"
        assert got == vars(jmain.parse_args(argv))
    assert vars(cli.parse_args(["-m", "a", "-i", "b", "-o", "c"]))["device"] is None


def test_cli_converts_with_each_checkpoint_kind(exp, tmp_path):
    """The CLI's main on the CPU: crepe f0, the enhancer on, the same audio
    from each checkpoint kind; 16 kHz, within a block of the input's length,
    finite, RMS > 0. A directory input goes through directory mode: one
    wav of the input's length in the output directory."""
    root, model = exp
    wav = str(root / "short.wav")
    n_in = read_wav(wav)[0].shape[-1]
    outs = []
    for kind in ("port", "reference", "jax"):
        out = str(tmp_path / f"{kind}.wav")
        assert cli.main(["-m", _write_kind(root, model, kind), "-i", wav,
                         "-o", out, "-pe", "crepe", "-sr", str(SR),
                         "--device", "cpu"]) == out
        audio, sr = read_wav(out)
        assert sr == SR and abs(audio.shape[-1] - n_in) <= BLOCK
        assert np.isfinite(audio).all() and np.sqrt(np.mean(audio ** 2)) > 0
        outs.append(audio)
    assert all(np.array_equal(outs[0], o) for o in outs[1:])
    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "short.wav").write_bytes(pathlib.Path(wav).read_bytes())
    got = cli.main(["-m", _write_kind(root, model, "port"), "-i",
                    str(tmp_path / "in"), "-o", str(tmp_path / "dir_out"),
                    "-pe", "crepe", "-sr", str(SR), "--device", "cpu"])
    assert got == [str(tmp_path / "dir_out" / "short.wav")]
    audio, sr = read_wav(got[0])
    assert sr == SR and abs(audio.shape[-1] - n_in) <= BLOCK
    assert np.isfinite(audio).all() and np.sqrt(np.mean(audio ** 2)) > 0


def test_cli_module_runs(exp, tmp_path):
    """python -m ddsp_svc_tpu_torch.infer in a process of its own."""
    root, model = exp
    out = tmp_path / "out.wav"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    run = subprocess.run(
        [sys.executable, "-m", "ddsp_svc_tpu_torch.infer", "-m",
         _write_kind(root, model, "port"), "-i", str(root / "short.wav"),
         "-o", str(out), "-pe", "parselmouth", "-e", "false", "-sr", str(SR),
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    audio, sr = read_wav(str(out))
    assert sr == SR and np.isfinite(audio).all()
