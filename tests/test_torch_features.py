"""PyTorch port, the feature front end against the JAX package on the CPU:
volume, the NaN-masked pools and `nearest_align` (1e-6); the copied WORLD
trackers bit for bit; the autocorrelation candidate stage and the tracked f0
of the 'parselmouth' family; HuBERT at full width, its variants and both
torch checkpoint layouts (each held through the JAX package's own
converter), and the JAX package's flax HuBERT variables as `.ckpt` and
`.msgpack` files (read without the msgpack package); CREPE at full width on a handful of frames, the torchcrepe
loader and the post-processing chain; `UnitsEncoder.encode` at 44.1 kHz
(the resampler at 44.1 -> 16 kHz is held by
tests/test_torch_enhancer.py::test_resample_matches_jax).
Inputs from numpy seeds; weights seeded in numpy and written as the torch
checkpoints the loaders read."""
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ddsp_svc_tpu.data import features as jfeatures
from ddsp_svc_tpu.data import world_f0 as jworld
from ddsp_svc_tpu.nn import crepe as jcrepe
from ddsp_svc_tpu.nn.hubert import HubertSoft as JHubertSoft
from ddsp_svc_tpu.ops import interp as jinterp
from ddsp_svc_tpu.ops import pools as jpools
from ddsp_svc_tpu.ops import volume as jvolume
from ddsp_svc_tpu.utils import convert as jconvert
from ddsp_svc_tpu_torch.data import features, world_f0
from ddsp_svc_tpu_torch.nn import crepe, hubert
from ddsp_svc_tpu_torch.ops import interp, pools, volume
from ddsp_svc_tpu_torch.utils import convert

torch.set_num_threads(2)

# HuBERT's fp32 forward through 12 post-norm layers: the two frameworks'
# matmul and conv orders differ; relative to max |ref|
HUBERT_TOL = 1e-4
# CREPE's bin probabilities (sigmoid outputs in [0, 1])
CREPE_ATOL = 1e-5


def _tone(f0, sr, dur, vibrato=0.0):
    """tests/test_features.py's tone: a sine with 5 Hz vibrato."""
    t = np.arange(int(sr * dur)) / sr
    inst = f0 * (1 + vibrato * np.sin(2 * np.pi * 5 * t))
    phase = 2 * np.pi * np.cumsum(inst) / sr
    return (0.5 * np.sin(phase)).astype(np.float32), inst


def _sung(sr, dur, seed=0):
    """A harmonic line with vibrato, a silent gap and a little noise."""
    rng = np.random.default_rng(seed)
    audio, _ = _tone(180.0, sr, dur, vibrato=0.04)
    t = np.arange(len(audio)) / sr
    audio = audio + 0.2 * np.sin(2 * np.pi * 360.0 * t).astype(np.float32)
    audio[int(0.4 * len(audio)):int(0.5 * len(audio))] = 0.0
    return (audio + 1e-3 * rng.standard_normal(len(audio))).astype(np.float32)


# ----------------------------- small ops ------------------------------------


@pytest.mark.parametrize("hop", [512, 363.7])
def test_volume_matches_jax(hop):
    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal(20000)).astype(np.float32)
    np.testing.assert_allclose(volume.extract_volume_np(x, hop),
                               jvolume.extract_volume_np(x, hop), atol=1e-6)
    if hop == 512:
        got = volume.extract_volume(torch.from_numpy(x[None]), hop).numpy()
        ref = np.asarray(jvolume.extract_volume(jnp.asarray(x[None]), hop))
        np.testing.assert_allclose(got, ref, atol=1e-6)
    ext = features.VolumeExtractor(hop)
    assert ext.extract(x).shape == (int(len(x) // hop) + 1,)


def test_pools_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 37)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = np.nan
    x[0, 10:16] = np.nan  # a window of NaNs only: count clamped to 1
    for k in (3, 4, 5):
        got = pools.masked_avg_pool_1d(torch.from_numpy(x), k).numpy()
        ref = np.asarray(jpools.masked_avg_pool_1d(jnp.asarray(x), k))
        np.testing.assert_allclose(got, ref, atol=1e-6)
    y = np.nan_to_num(x)
    for k in (3, 4, 5):
        got = pools.median_pool_1d(torch.from_numpy(y), k).numpy()
        ref = np.asarray(jpools.median_pool_1d(jnp.asarray(y), k))
        np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("ratio", [0.5, 1.5, 2.5, 1.6, 0.5805])
def test_nearest_align_matches_jax(ratio):
    """Half-integer ratios put frames exactly on x.5: both round half to
    even."""
    units = np.random.default_rng(2).standard_normal((1, 40, 3)).astype(np.float32)
    n = 50
    got = interp.nearest_align(torch.from_numpy(units), n, ratio).numpy()
    ref = np.asarray(jinterp.nearest_align(jnp.asarray(units), n, ratio))
    np.testing.assert_allclose(got, ref, atol=1e-6)


# ----------------------------- WORLD trackers --------------------------------


@pytest.mark.parametrize("family", ["dio", "harvest"])
@pytest.mark.parametrize("sr,hop", [(16000, 256), (44100, 512)])
def test_world_f0_bit_for_bit(family, sr, hop):
    audio = _sung(sr, 1.2)
    got = getattr(world_f0, family)(audio, sr, hop, 65, 800)
    ref = getattr(jworld, family)(audio, sr, hop, 65, 800)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    ext = features.F0Extractor(family, sr, hop, 65, 800)
    jext = jfeatures.F0Extractor(family, sr, hop, 65, 800)
    assert np.array_equal(ext.extract(audio, uv_interp=True,
                                      silence_front=0.1),
                          jext.extract(audio, uv_interp=True,
                                       silence_front=0.1))


def test_stonemask_bit_for_bit():
    sr, hop = 16000, 256
    audio, _ = _tone(261.63, sr, 1.0)
    n = len(audio) // hop + 1
    f0 = np.full(n, 261.63 * 2 ** (0.5 / 12))
    f0[:2] = 0.0
    assert np.array_equal(world_f0.stonemask(audio, sr, f0, hop),
                          jworld.stonemask(audio, sr, f0, hop))


# ----------------------------- autocorrelation ------------------------------


def _ac_frames(audio, sr, hop, win):
    n = len(audio) // hop + 1
    x = np.pad(audio, (win // 2, win // 2 + win))
    idx = np.round(np.arange(n) * hop).astype(np.int64)[:, None] + np.arange(win)
    return x[np.minimum(idx, len(x) - 1)]


@pytest.mark.parametrize("f0_hz,vibrato", [(110.0, 0.0), (440.0, 0.0),
                                           (220.0, 0.03)])
def test_autocorr_candidates_match_jax(f0_hz, vibrato):
    """The candidate stage on tests/test_features.py's tones and vibrato
    plus a silent stretch: freqs and strengths within 1e-4 relative (XLA's
    and PyTorch's fp32 FFTs round differently); the candidate order is
    jax.lax.top_k's, ties at -inf included."""
    sr, hop, f0_min, f0_max = 44100, 512, 65.0, 800.0
    audio, _ = _tone(f0_hz, sr, 0.6, vibrato)
    audio[:6000] = 0.0
    win = jfeatures.next_pow2(int(3 * sr / f0_min))
    frames = _ac_frames(audio, sr, hop, win)
    freqs, strengths = features.autocorr_candidates(
        torch.from_numpy(frames), sr, f0_min, f0_max)
    jf, js = jfeatures._autocorr_candidates(jnp.asarray(frames), sr, f0_min,
                                            f0_max)
    np.testing.assert_allclose(freqs.numpy(), np.asarray(jf), rtol=1e-4)
    np.testing.assert_allclose(strengths.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("f0_hz,vibrato", [(110.0, 0.0), (220.0, 0.0),
                                           (440.0, 0.0), (220.0, 0.03)])
def test_parselmouth_f0_matches_jax(f0_hz, vibrato):
    """The tracked f0 (silence_front on): every frame's
    voicing the same, voiced frames within 1 cent."""
    sr, hop = 44100, 512
    audio, _ = _tone(f0_hz, sr, 1.0, vibrato)
    audio[:8000] = 0.0
    got = features.F0Extractor("parselmouth", sr, hop, 65, 800,
                               device="cpu").extract(audio, silence_front=0.05)
    ref = jfeatures.F0Extractor("parselmouth", sr, hop, 65, 800).extract(
        audio, silence_front=0.05)
    assert got.shape == ref.shape == (len(audio) // hop + 1,)
    assert np.array_equal(got > 0, ref > 0)
    v = ref > 0
    assert v.sum() > 0.7 * len(v)
    assert np.abs(1200 * np.log2(got[v] / ref[v])).max() < 1.0


def test_f0_extractor_backends():
    """'native' and 'auto' run the parselmouth family on the port's NCCF
    library: the JAX package's native backend's f0 bit for bit (both
    libraries built here with the same flags), the frame contract
    (silence_front, uv_interp) included. An unknown backend or family
    raises."""
    sr, hop = 44100, 512
    audio, _ = _tone(220.0, sr, 1.0, 0.03)
    audio[:8000] = 0.0
    ref = jfeatures.F0Extractor("parselmouth", sr, hop, 65, 800,
                                backend="native").extract(
        audio, uv_interp=True, silence_front=0.05)
    for backend in ("native", "auto"):
        got = features.F0Extractor("parselmouth", sr, hop, 65, 800,
                                   backend=backend).extract(
            audio, uv_interp=True, silence_front=0.05)
        assert np.array_equal(got, ref)
    with pytest.raises(ValueError):
        features.F0Extractor("parselmouth", backend="jax", device="cpu")
    with pytest.raises(ValueError):
        features.F0Extractor("yin", device="cpu")


# ----------------------------- HuBERT ----------------------------------------


def _hubert_torch_sd(rng, n_layers=12, proj=256):
    """Seeded weights in the bshall HuBERT-soft layout (weight_g/weight_v on
    the positional conv), as torch tensors."""
    def w(*shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    def vec(n, scale=0.02, one=False):
        return ((1.0 if one else 0.0)
                + scale * rng.standard_normal(n)).astype(np.float32)

    sd = {"feature_extractor.conv0.weight": w(512, 1, 10, fan_in=10),
          "feature_extractor.norm0.weight": vec(512, one=True),
          "feature_extractor.norm0.bias": vec(512)}
    for i, k in enumerate([3] * 4 + [2] * 2, start=1):
        sd[f"feature_extractor.conv{i}.weight"] = w(512, 512, k, fan_in=512 * k)
    sd.update({"feature_projection.norm.weight": vec(512, one=True),
               "feature_projection.norm.bias": vec(512),
               "feature_projection.projection.weight": w(768, 512, fan_in=512),
               "feature_projection.projection.bias": vec(768),
               "positional_embedding.conv.weight_g":
                   np.abs(vec(128, 0.5, one=True)).reshape(1, 1, 128),
               "positional_embedding.conv.weight_v":
                   w(768, 48, 128, fan_in=48 * 128),
               "positional_embedding.conv.bias": vec(768),
               "norm.weight": vec(768, one=True), "norm.bias": vec(768)})
    for i in range(n_layers):
        lp = f"encoder.layers.{i}."
        sd.update({lp + "self_attn.in_proj_weight": w(2304, 768, fan_in=768),
                   lp + "self_attn.in_proj_bias": vec(2304),
                   lp + "self_attn.out_proj.weight": w(768, 768, fan_in=768),
                   lp + "self_attn.out_proj.bias": vec(768),
                   lp + "linear1.weight": w(3072, 768, fan_in=768),
                   lp + "linear1.bias": vec(3072),
                   lp + "linear2.weight": w(768, 3072, fan_in=3072),
                   lp + "linear2.bias": vec(768),
                   lp + "norm1.weight": vec(768, one=True),
                   lp + "norm1.bias": vec(768),
                   lp + "norm2.weight": vec(768, one=True),
                   lp + "norm2.bias": vec(768)})
    if proj:
        sd["proj.weight"] = w(proj, 768, fan_in=768)
        sd["proj.bias"] = vec(proj)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def _fairseq_sd(bshall, n_layers):
    """The same weights under fairseq's names (q/k/v apart, fc1/fc2)."""
    sd = {f"feature_extractor.conv_layers.{i}.0.weight":
          bshall[f"feature_extractor.conv{i}.weight"] for i in range(7)}
    for p in ("weight", "bias"):
        sd[f"feature_extractor.conv_layers.0.2.{p}"] = bshall[
            f"feature_extractor.norm0.{p}"]
        sd[f"layer_norm.{p}"] = bshall[f"feature_projection.norm.{p}"]
        sd[f"post_extract_proj.{p}"] = bshall[f"feature_projection.projection.{p}"]
        sd[f"encoder.layer_norm.{p}"] = bshall[f"norm.{p}"]
        sd[f"final_proj.{p}"] = bshall[f"proj.{p}"]
    for p in ("weight_g", "weight_v", "bias"):
        sd[f"encoder.pos_conv.0.{p}"] = bshall[f"positional_embedding.conv.{p}"]
    for i in range(n_layers):
        b, f = f"encoder.layers.{i}.", f"encoder.layers.{i}."
        for p in ("weight", "bias"):
            for n, part in zip("qkv", bshall[f"{b}self_attn.in_proj_{p}"].chunk(3)):
                sd[f"{f}self_attn.{n}_proj.{p}"] = part.clone()
            sd[f"{f}self_attn.out_proj.{p}"] = bshall[f"{b}self_attn.out_proj.{p}"]
            sd[f"{f}fc1.{p}"] = bshall[f"{b}linear1.{p}"]
            sd[f"{f}fc2.{p}"] = bshall[f"{b}linear2.{p}"]
            sd[f"{f}self_attn_layer_norm.{p}"] = bshall[f"{b}norm1.{p}"]
            sd[f"{f}final_layer_norm.{p}"] = bshall[f"{b}norm2.{p}"]
    return sd


@pytest.fixture(scope="module")
def hubert_ckpt(tmp_path_factory):
    """A HuBERT-soft torch checkpoint in the bshall layout."""
    sd = _hubert_torch_sd(np.random.default_rng(10))
    path = tmp_path_factory.mktemp("hubert") / "hubert-soft.pt"
    torch.save(sd, path)
    return str(path), sd


def _max_rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_hubert_soft_full_width_matches_jax(hubert_ckpt):
    """HuBERT-soft at full width (768 wide, 12 layers) on 1 s at 16 kHz,
    the bshall checkpoint loaded by the port and, through
    convert_hubert_state_dict, by the JAX package: within 1e-4 of max
    |ref|. jax_hubert_to_torch maps the JAX variables back onto the port's
    state dict."""
    _, sd = hubert_ckpt
    model = hubert.load_hubert_state_dict(hubert.HubertSoft(), sd).eval()
    wav = _sung(16000, 1.0)[None]
    with torch.no_grad():
        got = model(torch.from_numpy(wav)).numpy()
    variables = jconvert.convert_hubert_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    ref = np.asarray(JHubertSoft().apply(variables, jnp.asarray(wav)))
    assert got.shape == ref.shape == (1, 50, 256)
    assert _max_rel(got, ref) < HUBERT_TOL, _max_rel(got, ref)
    back = convert.jax_hubert_to_torch(variables)
    own = model.state_dict()
    assert back.keys() == own.keys()
    for k in own:
        # the positional conv's fold rounds apart in numpy and torch
        torch.testing.assert_close(back[k], own[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("encoder", list(hubert.VARIANTS))
def test_hubert_variant_shapes(encoder):
    """Each of the five encoder variants: the JAX package's output shape
    and layer count (jax.eval_shape, no compute)."""
    output_layer, proj_dim, pad = hubert.VARIANTS[encoder]
    model = hubert.HubertSoft.variant(encoder).eval()
    wav = np.zeros((1, 4000), np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(wav)).shape
    jm = JHubertSoft(output_layer=output_layer, proj_dim=proj_dim,
                     pad_input=pad)
    variables = jax.eval_shape(jm.init, jax.random.key(0), jnp.asarray(wav))
    ref = jax.eval_shape(jm.apply, variables, jnp.asarray(wav)).shape
    assert tuple(got) == tuple(ref)
    n_jax = sum(k.startswith("layer_") for k in variables["params"])
    assert len(model.encoder.layers) == n_jax == (output_layer or 12)


def test_fairseq_layout_matches_jax(tmp_path):
    """HuBERT-base (9 layers, final_proj) in the fairseq layout, wrapped
    under 'model' as fairseq saves it, through each package's UnitsEncoder:
    within 1e-4 of max |ref|."""
    bshall = _hubert_torch_sd(np.random.default_rng(11), n_layers=9)
    path = tmp_path / "contentvec.pt"
    torch.save({"model": _fairseq_sd(bshall, 9)}, path)
    wav = _sung(16000, 0.4, seed=3)[None]
    enc = features.UnitsEncoder("hubertbase", str(path), device="cpu")
    jenc = jfeatures.UnitsEncoder("hubertbase", str(path))
    got = enc.encode(wav, 16000, 320)
    ref = np.asarray(jenc.encode(wav, 16000, 320))
    assert got.shape == ref.shape == (1, 21, 256)
    assert _max_rel(got, ref) < HUBERT_TOL, _max_rel(got, ref)


def test_units_encoder_unpickles_in_full_only_when_trusted(tmp_path):
    """A checkpoint that pickles a run configuration beside its weights, as
    fairseq's do: refused by default, naming the file; read in full, with a
    warning, under trust_pickle=True, giving the bare state dict's units."""
    import argparse

    bshall = _hubert_torch_sd(np.random.default_rng(12), n_layers=9)
    sd = _fairseq_sd(bshall, 9)
    path = tmp_path / "fairseq.pt"
    torch.save({"args": argparse.Namespace(task="hubert"), "model": sd}, path)
    with pytest.raises(ValueError, match="fairseq.pt"):
        features.UnitsEncoder("hubertbase", str(path), device="cpu")
    with pytest.warns(RuntimeWarning, match="unpickling"):
        enc = features.UnitsEncoder("hubertbase", str(path), device="cpu",
                                    trust_pickle=True)
    torch.save({"model": sd}, tmp_path / "bare.pt")
    bare = features.UnitsEncoder("hubertbase", str(tmp_path / "bare.pt"),
                                 device="cpu")
    wav = _sung(16000, 0.3, seed=4)[None]
    np.testing.assert_array_equal(enc.encode(wav, 16000, 320),
                                  bare.encode(wav, 16000, 320))


@pytest.fixture(scope="module")
def flax_hubert(tmp_path_factory):
    """HuBERT-base (9 layers, final_proj) initialised by the JAX package
    from a seed, its variables serialized by flax as `.ckpt` and as
    `.msgpack` (the same bytes), and the JAX UnitsEncoder's units of a
    sung line through the `.ckpt`."""
    from flax import serialization

    variables = jax.jit(JHubertSoft(output_layer=9, proj_dim=256,
                                    pad_input=False).init)(
        jax.random.key(7), jnp.zeros((1, 1600)))
    blob = serialization.msgpack_serialize(jax.tree.map(np.asarray,
                                                        variables))
    root = tmp_path_factory.mktemp("flax_hubert")
    paths = {ext: root / f"hubert.{ext}" for ext in ("ckpt", "msgpack")}
    paths["ckpt"].write_bytes(blob)
    os.link(paths["ckpt"], paths["msgpack"])  # the same bytes, one copy
    wav = _sung(16000, 0.4, seed=6)[None]
    ref = np.asarray(jfeatures.UnitsEncoder(
        "hubertbase", str(paths["ckpt"])).encode(wav, 16000, 320))
    return paths, wav, ref


@pytest.mark.parametrize("ext", ["ckpt", "msgpack"])
def test_units_encoder_reads_flax_variables(flax_hubert, ext, monkeypatch):
    """The JAX package's flax HuBERT variables through the port's
    UnitsEncoder, with the msgpack package refused, against JAX's
    UnitsEncoder on the same file: within 1e-4 of max |ref|."""
    import sys

    paths, wav, ref = flax_hubert
    path = str(paths[ext])
    monkeypatch.setitem(sys.modules, "msgpack", None)
    got = features.UnitsEncoder("hubertbase", path, device="cpu").encode(
        wav, 16000, 320)
    assert got.shape == ref.shape == (1, 21, 256)
    assert np.abs(ref).max() > 1e-3
    assert _max_rel(got, ref) < HUBERT_TOL, _max_rel(got, ref)


def test_units_encoder_matches_jax(hubert_ckpt):
    """UnitsEncoder.encode at 44.1 kHz and hop 512 (resample 441 : 160 ->
    HuBERT-soft -> nearest alignment), the same bshall checkpoint file for
    both packages: within 1e-4 of max |ref|."""
    path, _ = hubert_ckpt
    audio = _sung(44100, 0.6, seed=4)[None]
    got = features.UnitsEncoder("hubertsoft", path, device="cpu").encode(
        audio, 44100, 512)
    ref = np.asarray(jfeatures.UnitsEncoder("hubertsoft", path).encode(
        audio, 44100, 512))
    assert got.shape == ref.shape == (1, audio.shape[1] // 512 + 1, 256)
    assert _max_rel(got, ref) < HUBERT_TOL, _max_rel(got, ref)


# ----------------------------- CREPE -----------------------------------------


def test_crepe_full_width_matches_jax():
    """CrepeFull at full width on 6 normalised frames, JAX-initialised
    weights through jax_crepe_to_torch: atol 1e-5 on the probabilities."""
    jm = jcrepe.CrepeFull()
    variables = jm.init(jax.random.key(3), jnp.zeros((1, 1024)))
    model = crepe.CrepeFull()
    model.load_state_dict(convert.jax_crepe_to_torch(variables))
    ext = crepe.CrepeExtractor(device="cpu", model=model)
    frames = ext.frames(_sung(16000, 0.03, seed=5))
    assert frames.shape == (7, 1024)
    frames = frames[:6]
    with torch.no_grad():
        got = model(frames).numpy()
    ref = np.asarray(jm.apply(variables, jnp.asarray(frames.numpy())))
    np.testing.assert_allclose(got, ref, atol=CREPE_ATOL)


def test_torchcrepe_loader_matches_jax_converter():
    """torchcrepe's full.pth layout (Conv2d (out, in, k, 1), BatchNorm
    statistics) folded by the port's loader against jax_crepe_to_torch of
    convert_crepe_state_dict's folding: rtol 1e-6."""
    rng = np.random.default_rng(7)
    sd, c_in = {}, 1
    for i, (ch, k, _, _) in enumerate(crepe.SPECS, start=1):
        sd[f"conv{i}.weight"] = rng.standard_normal((ch, c_in, k, 1)) * 0.05
        sd[f"conv{i}.bias"] = rng.standard_normal(ch) * 0.05
        sd[f"conv{i}_BN.weight"] = 1 + 0.1 * rng.standard_normal(ch)
        sd[f"conv{i}_BN.bias"] = 0.1 * rng.standard_normal(ch)
        sd[f"conv{i}_BN.running_mean"] = 0.1 * rng.standard_normal(ch)
        sd[f"conv{i}_BN.running_var"] = 0.5 + rng.random(ch)
        c_in = ch
    sd["classifier.weight"] = rng.standard_normal((360, 2048)) * 0.02
    sd["classifier.bias"] = rng.standard_normal(360) * 0.02
    sd = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}
    got = crepe.load_torchcrepe_state_dict(crepe.CrepeFull(), sd).state_dict()
    ref = convert.jax_crepe_to_torch(jconvert.convert_crepe_state_dict(sd))
    assert got.keys() == ref.keys()
    for k in got:
        torch.testing.assert_close(got[k], ref[k], rtol=1e-6, atol=1e-7)


def _controlled_probs(n, seed=8):
    """(n, 360) bin probabilities: a bump drifting across bins, its height
    moving through the 0.05 periodicity threshold."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    centre = 120 + 30 * np.sin(t / 9.0)
    height = 0.02 + 0.8 * (0.5 + 0.5 * np.sin(t / 5.0)) ** 2
    bins = np.arange(360)[None, :]
    probs = height[:, None] * np.exp(-0.5 * ((bins - centre[:, None]) / 3.0) ** 2)
    return (probs + 1e-3 * rng.random((n, 360))).astype(np.float32)


def test_crepe_decode_matches_jax():
    """Viterbi + local-average cents + periodicity on the host: the JAX
    extractor's predict with its network replaced by the same
    probabilities; equal to float32 rounding."""
    probs = _controlled_probs(60)
    jext = jcrepe.CrepeExtractor(65.0, 800.0, variables={"params": {}})
    jext._apply = lambda v, chunk: np.pad(probs, ((0, len(chunk) - len(probs)),
                                                  (0, 0)))
    ref_f0, ref_pd = jext.predict(np.zeros(59 * 80, np.float32))
    got_f0, got_pd = crepe.decode(probs, 65.0, 800.0)
    np.testing.assert_allclose(got_f0, ref_f0, rtol=1e-6)
    np.testing.assert_array_equal(got_pd, ref_pd)


@pytest.mark.parametrize("sr,hop", [(16000, 256), (44100, 512)])
@pytest.mark.parametrize("uv_interp", [False, True])
def test_crepe_chain_matches_jax(sr, hop, uv_interp):
    """F0Extractor('crepe') from the 5 ms track on: median pool 4 of the
    periodicity, < 0.05 -> NaN, masked average pool 4, nearest resample onto
    the hop grid (and uv_interp), the JAX test's tolerance (atol 2e-4, rtol
    1e-5, tests/test_crepe_ab.py); both extractors given the same track."""
    audio = (0.3 * np.random.default_rng(9).standard_normal(int(sr * 1.3))
             ).astype(np.float32)

    def track(wav16k, batch_size=512):
        n = 1 + len(wav16k) // 80
        return crepe.decode(_controlled_probs(n), 65.0, 800.0)

    ext = features.F0Extractor("crepe", sr, hop, 65, 800, device="cpu")
    ext._crepe = types.SimpleNamespace(predict=track)
    jext = jfeatures.F0Extractor("crepe", sr, hop, 65, 800)
    jext._crepe = types.SimpleNamespace(
        predict=lambda wav16k, batch_size=512: track(np.asarray(wav16k)))
    got = ext.extract(audio, uv_interp=uv_interp)
    ref = jext.extract(audio, uv_interp=uv_interp)
    assert got.shape == ref.shape == (len(audio) // hop + 1,)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-5)
    if not uv_interp:
        assert (got == 0).any() and (got > 0).any()
