"""PyTorch port, batched offline conversion on the CPU: `run_inference_batch`
against the port's own `run_inference` file by file and against the JAX
package's `run_inference_batch` (its enhancer eager, as
tests/test_torch_cli.py runs it), with the same checkpoint, HuBERT and
enhancer torch files and injected randomness; a remainder chunk (--batch
smaller than a bucket group), the adaptive key resolved per segment
('auto'), the batched bucket synth against the single one, and the CLI's
directory mode. 16 kHz, block 256, weights from seeds."""
import json
import shutil

import numpy as np
import pytest
import torch
import yaml

from ddsp_svc_tpu.infer import batch as jbatch
from ddsp_svc_tpu.infer.enhancer import Enhancer as JEnhancer
from ddsp_svc_tpu_torch.data.wavio import read_wav, write_wav
from ddsp_svc_tpu_torch.infer import __main__ as cli
from ddsp_svc_tpu_torch.infer import offline
from ddsp_svc_tpu_torch.infer.batch import run_inference_batch
from ddsp_svc_tpu_torch.infer.enhancer import NsfHifiGAN
from ddsp_svc_tpu_torch.models.factory import (
    bucket_frames, build_model, make_batched_synth, make_bucketed_synth)
from ddsp_svc_tpu_torch.nn.hubert import HubertSoft, init_hubert_
from ddsp_svc_tpu_torch.train.checkpoint import save_checkpoint
from ddsp_svc_tpu_torch.utils.config import DotDict
from torch_tmp import tmp_path  # noqa: F401  (removed when each test ends)

torch.set_num_threads(2)

SR, BLOCK, N_SPK = 16000, 256, 3
# tests/test_torch_cli.py's enhancer geometry at 16 kHz
H = {
    "sampling_rate": 16000, "num_mels": 16, "n_fft": 512, "win_size": 512,
    "hop_size": 128, "fmin": 40, "fmax": 8000,
    "upsample_rates": [4, 4, 8], "upsample_kernel_sizes": [8, 8, 16],
    "upsample_initial_channel": 32, "resblock": "1",
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
}
# tests/test_batch_inference.py's bound against the single path (PCM16
# quantisation), and tests/test_torch_cli.py's bound against the JAX
# package, each relative to max |ref|
TOL_SINGLE = 1e-3
TOL_JAX = 2e-4
# each input: its base f0 [Hz] and (phrase, silence, phrase, ...) seconds.
# The slicer keeps >= 5 s a segment, so a long first phrase and a short
# tail give two segments; the frames fall into buckets 64, 128 and 512.
# One octave up, e_short's f0 passes 760 Hz, so 'auto' resolves its
# adaptive key to 3 and the others' to 0
WAVS = {"a_two": (170, (5.2, 0.4, 0.6)), "b_two": (210, (5.6, 0.4, 1.4)),
        "c_short": (250, (1.5,)), "d_short": (190, (0.9,)),
        "e_short": (430, (0.7,))}


def _wav(base, parts, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i, sec in enumerate(parts):
        t = np.arange(int(SR * sec)) / SR
        if i % 2:
            out.append(np.zeros(len(t)))
            continue
        inst = (base + 30 * i) * (1 + 0.03 * np.sin(
            2 * np.pi * 5.5 * t))
        ph = 2 * np.pi * np.cumsum(inst) / SR
        x = sum(a * np.sin(k * ph) for k, a in ((1, 0.4), (2, 0.15), (3, 0.08)))
        out.append(x * np.minimum(1, np.minimum(t, t[-1] - t) / 0.02))
    audio = np.concatenate(out)
    return (audio + 1e-4 * rng.standard_normal(len(audio))).astype(np.float32)


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """An experiment dir (config.yaml, model_0.pt), a HuBERT-soft checkpoint
    in the bshall layout, an NSF-HiFiGAN checkpoint, and the input wavs
    in a directory of their own; all from seeds."""
    root = tmp_path_factory.mktemp("batch")
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
    (root / "in").mkdir()
    for seed, (name, (base, parts)) in enumerate(sorted(WAVS.items())):
        write_wav(str(root / "in" / f"{name}.wav"), _wav(base, parts, seed),
                  SR)
    yield root, model
    shutil.rmtree(root, ignore_errors=True)


def _wavs(root, names=None):
    return [str(root / "in" / f"{n}.wav") for n in (names or sorted(WAVS))]


def _noise(f, s, shape):
    return (np.random.default_rng((7, f, s)).random(shape, np.float32)
            * 2 - 1)


def _enh_rand(f, s):
    r = np.random.default_rng((11, f, s)).random((1, 9), np.float32)
    r[:, 0] = 0
    return r


def test_inputs_cover_buckets_and_remainders(exp):
    """The inputs give segments of several lengths inside each of the
    buckets 64, 128 and 512, so --batch 2 leaves a remainder chunk."""
    from ddsp_svc_tpu_torch.infer.offline import split
    root, _ = exp
    frames = [len(a) // BLOCK for p in _wavs(root)
              for _, a in split(read_wav(p)[0], SR, BLOCK)]
    buckets = [bucket_frames(n) for n in frames]
    assert len(frames) == 7 and sorted(set(buckets)) == [64, 128, 512]
    assert max(buckets.count(b) for b in set(buckets)) == 3


@pytest.mark.parametrize("batch_size,eak", [(2, 0), (16, "auto")])
def test_batch_matches_single(exp, tmp_path, batch_size, eak):
    """Each file of the batched path against run_inference on it alone,
    the same noise and SineGen rotations injected, the same f0 cache: within
    1e-3 of max |ref| (PCM16 outputs). batch 2 leaves a one-item remainder
    chunk in the 64-frame bucket; 'auto' resolves the adaptive key per
    segment (an octave up, e_short's key is 3, the others' 0, so its
    64-frame segment is batched apart from the two others of its bucket)."""
    root, _ = exp
    kw = dict(spk_id=2, key=12, pitch_extractor="dio", f0_min=65.0,
              f0_max=800.0, enhancer_adaptive_key=eak, sampling_rate=SR,
              seed=7, cache_dir=str(tmp_path / "cache"), device="cpu")
    wavs = _wavs(root)
    outs = run_inference_batch(
        str(root / "exp" / "model_0.pt"), wavs, str(tmp_path / "batch"),
        batch_size=batch_size, noise_hook=_noise, enhancer_rand_hook=_enh_rand,
        **kw)
    assert [o.rsplit("/", 1)[1] for o in outs] == [
        f"{n}.wav" for n in sorted(WAVS)]
    for fi, wav in enumerate(wavs):
        single = offline.run_inference(
            str(root / "exp" / "model_0.pt"), wav, str(tmp_path / f"s{fi}.wav"),
            noise_hook=lambda i, shape: _noise(fi, i, shape),
            enhancer_rand_hook=lambda i: _enh_rand(fi, i), **kw)
        got, sr_g = read_wav(outs[fi])
        ref, sr_r = read_wav(single)
        assert sr_g == sr_r == SR and got.shape == ref.shape
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err < TOL_SINGLE, (fi, err)


class _EagerJEnhancer(JEnhancer):
    """The JAX Enhancer with its single and batched generator forwards run
    op by op (tests/test_torch_cli.py::_EagerJEnhancer says why: under jit,
    XLA on the CPU loses the harmonic source's compensated phase scan)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.enhancer._forward = self.enhancer._forward_impl
        self.enhancer._forward_batch = self.enhancer._forward_batch_impl


@pytest.mark.parametrize("hooks", [True, False], ids=["hooks", "default_noise"])
def test_batch_matches_jax(exp, tmp_path, monkeypatch, hooks):
    """The port's batched path against the JAX package's on the same
    checkpoint, HuBERT and enhancer files and dio f0, FLOAT outputs, within
    2e-4 of max |ref|. 'hooks': noise and rotations injected, the enhancer
    on (eager in JAX); 'default_noise': no hooks and the enhancer off, so
    the synth noise is each side's own default draw, which the port makes
    as JAX does. The f0 cache files carry the same names and values."""
    root, _ = exp
    monkeypatch.setattr(jbatch, "Enhancer", _EagerJEnhancer)
    wavs = _wavs(root, ["a_two", "c_short", "d_short"])
    kw = dict(batch_size=2, spk_id=3, key=-2, pitch_extractor="dio",
              f0_min=65.0, f0_max=800.0, sampling_rate=SR, seed=3,
              output_subtype="FLOAT", enhance=hooks)
    if hooks:
        kw.update(noise_hook=_noise, enhancer_rand_hook=_enh_rand)
    ref = jbatch.run_inference_batch(
        str(root / "exp" / "model_0.pt"), wavs, str(tmp_path / "jax"), **kw)
    got = run_inference_batch(
        str(root / "exp" / "model_0.pt"), wavs, str(tmp_path / "port"),
        device="cpu", **kw)
    for g, r in zip(got, ref):
        a, sr_a = read_wav(g)
        b, sr_b = read_wav(r)
        assert sr_a == sr_b == SR and a.shape == b.shape
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err < TOL_JAX, (g, err)
    names = sorted(p.name for p in (tmp_path / "port" / "cache").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax" / "cache").iterdir())
    for n in names:
        assert np.array_equal(np.load(tmp_path / "port" / "cache" / n),
                              np.load(tmp_path / "jax" / "cache" / n))


def test_batched_synth_matches_single(exp):
    """make_batched_synth on three items of one 64-frame bucket (64, 27 and
    33 valid frames, f0 edge-padded per item) against make_bucketed_synth on
    each item alone: each valid prefix within 5e-5 of its max (the JAX
    package's bound for the per-item valid vector)."""
    _, model = exp
    rng = np.random.default_rng(0)
    lengths, bucket = [64, 27, 33], 64
    b = len(lengths)
    units = rng.standard_normal((b, bucket, 256)).astype(np.float32)
    f0 = (150 + 100 * rng.random((b, bucket, 1))).astype(np.float32)
    vol = rng.random((b, bucket)).astype(np.float32)
    noise = (rng.random((b, bucket * BLOCK)) * 2 - 1).astype(np.float32)
    for i, n in enumerate(lengths):
        f0[i, n:] = f0[i, n - 1]
        units[i, n:], vol[i, n:], noise[i, n * BLOCK:] = 0, 0, 0
    spk = np.array([[1], [2], [3]], np.int64)
    out = make_batched_synth(model)(units, f0, vol, spk, np.array(lengths),
                                    noise).numpy()
    single = make_bucketed_synth(model)
    for i, n in enumerate(lengths):
        ref = single(units[i:i + 1, :n], f0[i:i + 1, :n], vol[i:i + 1, :n],
                     spk[i:i + 1], noise=noise[i:i + 1, :n * BLOCK]).numpy()[0]
        err = np.abs(out[i, :n * BLOCK] - ref).max() / np.abs(ref).max()
        assert err < 5e-5, (i, n, err)


def test_cli_directory_mode(exp, tmp_path):
    """-i a directory: every wav in it, in sorted order, one output each in
    the directory -o, within a block of its input's length; files that are
    not wavs are left alone."""
    root, _ = exp
    (root / "in" / "notes.txt").write_text("not audio")
    outs = cli.main(["-m", str(root / "exp" / "model_0.pt"), "-i",
                     str(root / "in"), "-o", str(tmp_path / "out"), "-pe",
                     "parselmouth", "-sr", str(SR), "--batch", "3",
                     "--device", "cpu"])
    assert outs == [str(tmp_path / "out" / f"{n}.wav") for n in sorted(WAVS)]
    for o, wav in zip(outs, _wavs(root)):
        y, sr = read_wav(o)
        assert sr == SR and abs(y.shape[-1] - read_wav(wav)[0].shape[-1]) <= BLOCK
        assert np.isfinite(y).all() and np.sqrt(np.mean(y ** 2)) > 0


def test_cli_directory_without_wavs_exits(exp, tmp_path):
    """A directory with no wav exits with main.py's message."""
    root, _ = exp
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no .wav files in"):
        cli.main(["-m", str(root / "exp" / "model_0.pt"), "-i",
                  str(tmp_path / "empty"), "-o", str(tmp_path / "out"),
                  "--device", "cpu"])
