"""PyTorch port, streaming conversion (the SOLA engine) against the JAX
package on the CPU: `phase_vocoder`, `sola_shift`, `SvcCore.infer` and a
6-block `StreamingSession` (enhancer off and on, the crossfade and the
phase vocoder) against the JAX package's on the same checkpoint, HuBERT and
NSF-HiFiGAN torch files with the noise and SineGen phases injected (the JAX
core's synth and enhancer wrapped, its enhancer run eager), the pipelined
session against the sequential one bit for bit, `StreamConfig` profiles,
and `python -m ddsp_svc_tpu_torch.stream` (its flags against gui.py's, a
wav streamed end to end). 16 kHz, block 256, weights from seeds."""
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import yaml

from ddsp_svc_tpu.infer import streaming as jstreaming
from ddsp_svc_tpu.infer.stream_config import StreamConfig as JStreamConfig
from ddsp_svc_tpu.models.factory import make_jitted_synth
from ddsp_svc_tpu_torch import stream as cli
from ddsp_svc_tpu_torch.data.wavio import read_wav, write_wav
from ddsp_svc_tpu_torch.infer.enhancer import NsfHifiGAN
from ddsp_svc_tpu_torch.infer.stream_config import StreamConfig
from ddsp_svc_tpu_torch.infer.streaming import (StreamingSession, SvcCore,
                                                phase_vocoder, sola_shift)
from ddsp_svc_tpu_torch.models.factory import build_model
from ddsp_svc_tpu_torch.nn.hubert import HubertSoft, init_hubert_
from ddsp_svc_tpu_torch.train.checkpoint import save_checkpoint
from ddsp_svc_tpu_torch.utils.config import DotDict
from torch_tmp import tmp_path  # noqa: F401  (removed when each test ends)

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]

SR, BLOCK, N_SPK = 16000, 256, 2
# tests/test_torch_cli.py's enhancer geometry at 16 kHz
H = {
    "sampling_rate": 16000, "num_mels": 16, "n_fft": 512, "win_size": 512,
    "hop_size": 128, "fmin": 40, "fmax": 8000,
    "upsample_rates": [4, 4, 8], "upsample_kernel_sizes": [8, 8, 16],
    "upsample_initial_channel": 32, "resblock": "1",
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
}
# the CLI's tolerance (tests/test_torch_cli.py), relative to max |ref|
TOL = 2e-4
# gui.py's defaults at 16 kHz: blocks of 0.3 s, a 0.9 s window (57 frames,
# bucket 64), 0.5 s of silence front before the enhancer
SESSION = dict(samplerate=SR, block_time=0.3, crossfade_time=0.04,
               buffer_num=2)
INFER = dict(spk_id=2, pitch_adjust=2, threshold_db=-50.0,
             pitch_extractor_type="dio", enhancer_adaptive_key=0)


def _sung(seconds, seed=0):
    """A sung-like line with a silence in the middle."""
    rng = np.random.default_rng(seed)
    t = np.arange(round(SR * seconds)) / SR
    f0 = 190.0 * 2 ** (np.floor(t * 3) % 4 / 12)
    ph = 2 * np.pi * np.cumsum(f0 * (1 + 0.03 * np.sin(2 * np.pi * 5.5 * t))) / SR
    x = 0.4 * np.sin(ph) + 0.15 * np.sin(2 * ph) + 0.08 * np.sin(3 * ph)
    x[(t > 0.55 * t[-1]) & (t < 0.65 * t[-1])] = 0.0
    return (x + 1e-3 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """An experiment (config.yaml, the port's model_0.pt: a non-causal
    CombSubFast, as configs/combsub.yaml) with a HuBERT-soft checkpoint and
    an NSF-HiFiGAN checkpoint, from seeds."""
    root = tmp_path_factory.mktemp("stream")
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
    save_checkpoint(str(root / "exp" / "model_0.pt"), 0,
                    build_model(DotDict(args), device="cpu", seed=7))
    write_wav(str(root / "in.wav"), _sung(2.0), SR)
    yield root
    shutil.rmtree(root, ignore_errors=True)


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


@pytest.fixture(scope="module")
def jax_core(exp):
    """The JAX package's SvcCore on the same files, made once (its jitted
    synth compiles once). Its synth is the JAX package's bucketed synth with
    `mask_padding=True` (as its offline path runs it), given the noise of
    `core.hooks`: its own streaming synth pads the window without masking,
    so the window depends on the pad frames (58.9 % of max |out| on a
    0.9 s window here; ROADMAP.md queue 3), where the port, as the
    reference GUI, converts the window as at its own length. Its enhancer
    takes the SineGen phases and runs op by op (under jit the JAX harmonic
    source drifts, ROADMAP.md queue 3; see
    tests/test_torch_cli.py::_EagerJEnhancer). A test sets `core.hooks`
    and `core._step`."""
    core = jstreaming.SvcCore(str(exp / "exp" / "model_0.pt"))

    def hooked_synth(spk_mix_dict):
        run = make_jitted_synth(core.model, core.variables,
                                spk_mix_dict=spk_mix_dict, mask_padding=True)

        def synth(units, f0, volume, spk_id, rng):
            return run(units, f0, volume, spk_id, rng, noise=core.hooks.noise(
                core._step, (1, units.shape[1] * BLOCK)))
        return synth

    core._synth = hooked_synth
    enhancer = core.enhancer
    enhancer.enhancer._forward = enhancer.enhancer._forward_impl
    enhance = enhancer.enhance
    enhancer.enhance = lambda *a, rng=None, **kw: enhance(
        *a, rand_ini=core.hooks.rand_ini(core._step), **kw)
    return core


def _reset(hooks, *cores):
    for c in cores:
        c._step = 0
        c.hooks = hooks


@pytest.fixture(scope="module")
def core(exp):
    return SvcCore(str(exp / "exp" / "model_0.pt"), device="cpu")


# ------------------------------------------------------ the splice ----


@pytest.mark.parametrize("n", [640, 441])
def test_phase_vocoder_matches_jax(n):
    """Even and odd lengths (the Nyquist bin counted once or not at all),
    fp32 on both sides: within 1e-5 of max |ref|."""
    rng = np.random.default_rng(n)
    a, b = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    fade_in = (np.sin(np.pi * np.arange(0, 1, 1 / n) / 2) ** 2).astype(
        np.float32)
    fade_out = 1 - fade_in
    ref = np.asarray(jstreaming.phase_vocoder(
        *(jnp.asarray(x) for x in (a, b, fade_out, fade_in))))
    got = phase_vocoder(*(torch.from_numpy(x) for x in (a, b, fade_out,
                                                        fade_in))).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-5 * np.abs(ref).max()


def test_sola_shift_matches_jax():
    """The same shifts on random windows, and a known offset found."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        buf = rng.standard_normal(640).astype(np.float32)
        wav = rng.standard_normal(640 + 160 + 500).astype(np.float32)
        assert sola_shift(wav, buf, 160) == jstreaming.sola_shift(wav, buf, 160)
    wav = np.concatenate([0.01 * rng.standard_normal(57), buf,
                          rng.standard_normal(800)]).astype(np.float32)
    assert sola_shift(wav, buf, 160) == 57


class _ShiftingPassthrough:
    """A core that returns its window rolled by a random shift (the SOLA
    splice must absorb it), as tests/test_streaming.py's."""

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)

    def infer(self, audio, sample_rate, **kw):
        return np.roll(audio, int(self.rng.uniform(-200, 200))), SR


@pytest.mark.parametrize("vocoder", [False, True])
def test_session_splice_matches_jax(vocoder):
    """Both sessions over the shifting passthrough core: the same shifts
    and blocks within 1e-5 of max |ref| (the crossfade is the same numpy
    on both sides; the phase vocoder fp32 FFTs)."""
    kw = dict(samplerate=SR, block_time=0.1, crossfade_time=0.02,
              buffer_num=1, use_phase_vocoder=vocoder)
    sess = StreamingSession(_ShiftingPassthrough(), **kw)
    jsess = jstreaming.StreamingSession(_ShiftingPassthrough(), **kw)
    signal = _sung(1.5)
    bf = sess.block_frame
    got = np.concatenate([sess.process_block(signal[i * bf:(i + 1) * bf])
                          for i in range(len(signal) // bf)])
    ref = np.concatenate([jsess.process_block(signal[i * bf:(i + 1) * bf])
                          for i in range(len(signal) // bf)])
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-5 * np.abs(ref).max()


# ------------------------------------------------ SvcCore and session ----


@pytest.mark.parametrize("enhance", [False, True])
def test_svc_core_infer_matches_jax(core, jax_core, enhance):
    """One 0.9 s window (57 frames in the 64-frame bucket; 0.5 s of silence
    front skipped by the f0 and the enhancer) with
    the noise and SineGen phases injected: the rate and length equal, the
    audio within 2e-4 of max |ref|."""
    hooks = _Hooks()
    _reset(hooks, core, jax_core)
    window = _sung(0.9, seed=1)
    kw = dict(INFER, use_enhancer=enhance, safe_prefix_pad_length=0.53)
    ref, sr_ref = jax_core.infer(window, SR, **kw)
    got, sr = core.infer(window, SR, noise_hook=hooks.noise,
                         enhancer_rand_hook=hooks.rand_ini, **kw)
    assert sr == sr_ref == SR and got.shape == ref.shape
    assert np.abs(ref).max() > 1e-3
    assert np.abs(got - ref).max() < TOL * np.abs(ref).max()


def test_window_is_converted_at_its_own_length(exp, core):
    """The port's window (57 frames padded to 64, masked) equals the same
    features through the model at their exact length (1e-5 of max |ref|,
    tests/test_torch_models.py's padding bound). The JAX package's own
    streaming synth pads without masking; held here to show how far that
    moves its window from the exact length (ROADMAP.md queue 3): more than
    1e-2 of max |ref| (58.9 % read here)."""
    window = _sung(0.9, seed=1)
    kw = dict(INFER, use_enhancer=False)
    _reset(_Hooks(), core)
    got = core.infer(window, SR, noise_hook=core.hooks.noise, **kw)[0]

    jcore = jstreaming.SvcCore(str(exp / "exp" / "model_0.pt"))
    run, jhooks = jcore._synth(None), _Hooks()
    jcore._synth = lambda mix: lambda u, f, v, s, rng: run(
        u, f, v, s, rng, noise=jhooks.noise(jcore._step,
                                            (1, u.shape[1] * BLOCK)))
    unmasked = jcore.infer(window, SR, **kw)[0]

    frames = []

    def exact_length(units, f0, volume, spk_id, noise=None, generator=None):
        frames.append(units.shape[1])
        with torch.no_grad():
            return core.model(*(torch.as_tensor(a) for a in (
                units, f0, volume, spk_id)), infer=True,
                noise=torch.as_tensor(noise))[0]

    _reset(_Hooks(), core)
    cached, core._synth_cache = core._synth_cache, {None: exact_length}
    try:
        ref = core.infer(window, SR, noise_hook=core.hooks.noise, **kw)[0]
    finally:
        core._synth_cache = cached
    assert frames == [57]
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() < 1e-5 * scale
    drift = np.abs(unmasked - ref).max() / scale
    print(f"the JAX streaming window vs its exact length: {drift:.3e} x "
          "max|ref|")
    assert drift > 1e-2


@pytest.mark.parametrize("enhance,vocoder", [(False, False), (True, True)])
def test_streaming_session_matches_jax(core, jax_core, enhance, vocoder):
    """Six blocks of gui.py's defaults through both sessions, noise and
    phases injected: the same SOLA shifts, the spliced stream within 2e-4
    of max |ref| (the crossfade; with the enhancer, the phase vocoder)."""
    hooks = _Hooks(seed=4)
    _reset(hooks, core, jax_core)
    kw = dict(SESSION, use_phase_vocoder=vocoder, use_enhancer=enhance,
              **INFER)
    sess = StreamingSession(core, noise_hook=hooks.noise,
                            enhancer_rand_hook=hooks.rand_ini, **kw)
    jsess = jstreaming.StreamingSession(jax_core, **kw)
    jshifts = []
    real_shift = jstreaming.sola_shift

    def spy(*a):
        jshifts.append(real_shift(*a))
        return jshifts[-1]

    audio = _sung(6 * 0.3, seed=2)
    bf = sess.block_frame
    got, ref = [], []
    jstreaming.sola_shift = spy
    try:
        for i in range(6):
            got.append(sess.process_block(audio[i * bf:(i + 1) * bf]))
            ref.append(jsess.process_block(audio[i * bf:(i + 1) * bf]))
    finally:
        jstreaming.sola_shift = real_shift
    assert sess.shifts == jshifts and len(jshifts) == 6
    got, ref = np.concatenate(got), np.concatenate(ref)
    assert got.shape == ref.shape == (6 * bf,)
    assert np.abs(ref).max() > 1e-3
    assert np.abs(got - ref).max() < TOL * np.abs(ref).max()


def test_pipelined_session_matches_sequential(core):
    """pipeline_depth 1 gives the sequential session's blocks bit for bit,
    one block late (silence while priming), the last one from flush(); the
    noise and phases drawn from the per-step generators."""

    def run(depth):
        core._step = 0
        sess = StreamingSession(core, pipeline_depth=depth, **SESSION,
                                **INFER)
        audio = _sung(1.2, seed=5)
        bf = sess.block_frame
        outs = [sess.process_block(audio[i * bf:(i + 1) * bf])
                for i in range(len(audio) // bf)]
        return outs + sess.flush()

    plain, piped = run(0), run(1)
    assert len(piped) == len(plain) + 1 and not piped[0].any()
    for a, b in zip(plain, piped[1:]):
        np.testing.assert_array_equal(a, b)


def test_svc_core_options(exp, tmp_path):
    """A missing enhancer checkpoint warns and the core converts raw (the
    JAX package's behaviour); fused_window with a mesh raises ValueError
    (the two are exclusive; tests/test_torch_parallel.py runs the mesh,
    test_fused_window_matches_default_window the fused window); a speaker
    id out of range raises before the device sees it."""
    d = tmp_path / "exp"
    d.mkdir()
    args = yaml.safe_load((exp / "exp" / "config.yaml").read_text())
    args["enhancer"]["ckpt"] = str(tmp_path / "missing" / "model")
    (d / "config.yaml").write_text(yaml.safe_dump(args))
    (d / "model_0.pt").write_bytes((exp / "exp" / "model_0.pt").read_bytes())
    with pytest.warns(RuntimeWarning, match="enhancer checkpoint not found"):
        raw = SvcCore(str(d / "model_0.pt"), device="cpu")
    assert raw.enhancer is None
    out, sr = raw.infer(_sung(0.5), SR)
    assert sr == SR and out.shape == (32 * BLOCK,) and np.isfinite(out).all()
    with pytest.raises(ValueError, match="exclusive"):
        SvcCore(str(exp / "exp" / "model_0.pt"), device="cpu",
                mesh=object(), fused_window=True)
    for kw in (dict(spk_id=N_SPK + 1),
               dict(use_spk_mix=True, spk_mix_dict={1: 0.5, 0: 0.5})):
        with pytest.raises(ValueError, match="out of range"):
            raw.infer(_sung(0.5), SR, **kw)


@pytest.fixture(scope="module")
def cores(exp):
    """The default core and the fused-window core on the same checkpoint."""
    ckpt = str(exp / "exp" / "model_0.pt")
    return (SvcCore(ckpt, device="cpu"),
            SvcCore(ckpt, device="cpu", fused_window=True))


@pytest.mark.parametrize("enhance,key", [(False, 0), (True, 0), (True, 2)],
                         ids=["raw", "enhancer-key0", "enhancer-key2"])
def test_fused_window_matches_default_window(cores, enhance, key):
    """SvcCore(fused_window=True) against the default window with the same
    step, noise and SineGen rotations (the JAX package's
    tests/test_streaming.py cases: enhancer off, on at adaptive keys 0 and
    2), on gui.py's window with its silence front: within 1e-6 x max|ref|
    (both run the same operations, so the CPU gives the same bits), over
    two windows of one program (the second through its cached key); with
    'auto' the fused core takes the default window, as JAX's does."""
    core, fused = cores
    sess = StreamingSession(core, **SESSION)
    window = np.concatenate([_sung(0.6, seed=3), _sung(0.3, seed=4)])
    window = window[:sess.input_frames]
    kw = dict(INFER, use_enhancer=enhance, enhancer_adaptive_key=key,
              safe_prefix_pad_length=sess.safe_prefix_pad_length)
    keys = set(fused._windows)
    for step in range(2):
        x = np.roll(window, 137 * step)
        ref, sr_r = core.infer(x, SR, **kw)
        got, sr_g = fused.infer(x, SR, **kw)
        assert sr_g == sr_r and got.shape == ref.shape
        err = float(np.abs(got - ref).max())
        assert err <= 1e-6 * float(np.abs(ref).max()), err
    assert len(set(fused._windows) - keys) == 1
    if enhance:
        before = dict(fused._windows)
        got, _ = fused.infer(x, SR, **dict(kw, enhancer_adaptive_key="auto"))
        ref, _ = core.infer(x, SR, **dict(kw, enhancer_adaptive_key="auto"))
        assert fused._windows == before
        np.testing.assert_array_equal(got, ref)


# ----------------------------------------------- profiles and entry ----


def test_stream_config_roundtrip_and_overlay(tmp_path):
    """A profile saved and loaded back equal (the speaker mix's int keys
    too), the JAX package's loader reads it, and the entry's overlay: the
    profile over the defaults, explicit flags over the profile."""
    cfg = StreamConfig(
        samplerate=32000, block_time=0.5, pitch_adjust=2.0, spk_id=3,
        spk_mix_dict={1: 0.25, 2: 0.75}, use_enhancer=False,
        use_phase_vocoder=True, checkpoint_path="exp/foo/model_best.pt",
        threshold_db=-35.0, buffer_num=4, crossfade_time=0.05,
        pitch_extractor="harvest", use_spk_mix=True,
        sounddevices=["mic", "speakers"], pipeline_depth=1)
    path = cfg.save(str(tmp_path / "profiles"), "stage")
    assert path.endswith("stage.yaml")
    got = StreamConfig.load(str(tmp_path / "profiles"), "stage")
    assert got == cfg and all(isinstance(k, int) for k in got.spk_mix_dict)
    jgot = JStreamConfig.load(str(tmp_path / "profiles"), "stage")
    assert vars(jgot) == vars(got)
    assert got.session_kwargs() == jgot.session_kwargs()
    assert StreamConfig.list_profiles(str(tmp_path / "profiles")) == ["stage"]

    cmd = cli.parse_args(["--config", f"{tmp_path}/profiles:stage"])
    eff = cli.effective_config(cmd)
    assert eff.block_time == 0.5 and eff.spk_id == 3
    cmd = cli.parse_args(["--config", f"{tmp_path}/profiles:stage",
                          "--block-time", "0.2", "-e", "true"])
    eff = cli.effective_config(cmd)
    assert eff.block_time == 0.2 and eff.use_enhancer is True
    assert eff.pitch_extractor == "harvest"


def test_stream_flags_match_gui(monkeypatch):
    """Every flag and default of gui.py::parse_args, plus --device; the
    same effective settings from the same flags."""
    spec = importlib.util.spec_from_file_location("jax_gui", ROOT / "gui.py")
    gui = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gui)
    for argv in ([], ["-m", "a.pt", "-i", "in.wav", "-o", "out.wav"],
                 ["-m", "a.ckpt", "-i", "in.wav", "-o", "out.wav", "-id", "3",
                  "-k", "-2", "-th", "-50", "-sr", "22050", "--block-time",
                  "0.25", "--crossfade-time", "0.05", "--buffer-num", "3",
                  "-pe", "harvest", "-e", "false", "--phase-vocoder",
                  "--pipeline-depth", "1", "--config", "d:n",
                  "--save-config", "e:m"]):
        monkeypatch.setattr(sys, "argv", ["gui.py"] + argv)
        ref = gui.parse_args()
        got = cli.parse_args(argv + ["--device", "cpu"])
        assert vars(got).pop("device") == "cpu"
        got = cli.parse_args(argv)
        assert {k: v for k, v in vars(got).items() if k != "device"} == vars(ref)
        if "--config" not in argv:
            assert vars(cli.effective_config(got)) == vars(
                gui.effective_config(ref))
    assert cli.parse_args([]).device is None


def test_stream_module_runs(exp, tmp_path):
    """python -m ddsp_svc_tpu_torch.stream -i/-o --device cpu in a process
    of its own: a block's time printed per block, the wav written at the
    session's rate, as long as the input's whole blocks, finite and
    live."""
    out = tmp_path / "out.wav"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    run = subprocess.run(
        [sys.executable, "-m", "ddsp_svc_tpu_torch.stream", "-m",
         str(exp / "exp" / "model_0.pt"), "-i", str(exp / "in.wav"), "-o",
         str(out), "-sr", str(SR), "-pe", "dio", "--pipeline-depth", "1",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert run.stdout.count("inference time (ms)") == 6
    audio, sr = read_wav(str(out))
    # six blocks of 4800 samples and the window still in flight
    assert sr == SR and audio.shape == (7 * 4800,)
    assert np.isfinite(audio).all() and np.abs(audio).max() > 1e-3
