"""PyTorch port, the NSF-HiFiGAN enhancer against the JAX package on the
CPU: the Generator in each of its forms (trio with the injection, trio
without it, the fused stage, every stage on convolutions) against the JAX
Generator in the same form, its Pallas kernels in interpret mode; per-item
`valid_frames`; the pre-padded log-mel; the resampler; `enhance` with an
adaptive key and `enhance_batch` against the JAX `Enhancer`; loading a
reference checkpoint; resampling on load. Weights: the port's, seeded,
mapped into the JAX package by its own converter."""
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ddsp_svc_tpu.data import wavio as jwavio
from ddsp_svc_tpu.infer.enhancer import Enhancer as JEnhancer
from ddsp_svc_tpu.infer.enhancer import NsfHifiGAN as JNsfHifiGAN
from ddsp_svc_tpu.nn.nsf_hifigan import Generator as JGenerator
from ddsp_svc_tpu.ops import spectral as jspectral
from ddsp_svc_tpu.ops.resample import resample as jresample
from ddsp_svc_tpu.utils import convert as jconvert
from ddsp_svc_tpu_torch.data import wavio
from ddsp_svc_tpu_torch.infer.enhancer import Enhancer, NsfHifiGAN
from ddsp_svc_tpu_torch.nn.layers import lecun_init_
from ddsp_svc_tpu_torch.nn.nsf_hifigan import generator_from_h
from ddsp_svc_tpu_torch.ops import spectral
from ddsp_svc_tpu_torch.ops.resample import resample
from torch_tmp import tmp_path  # noqa: F401  (removed when each test ends)

torch.set_num_threads(2)

SR = 16000
# tests/test_batch_inference.py's geometry: stages of 32, 16, 8, 4 and 2
# channels; the u = 4 stages (C = 32, 16) and the u = 2 stage (C = 8) take
# the trio and stage kernels' paths
H = {
    "sampling_rate": SR, "num_mels": 16, "n_fft": 512, "win_size": 512,
    "hop_size": 128, "fmin": 40, "fmax": 8000,
    "upsample_rates": [4, 4, 2, 2, 2], "upsample_kernel_sizes": [8, 8, 4, 4, 4],
    "upsample_initial_channel": 64, "resblock": "1",
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5]] * 3,
}
FORMS = {"inject": {}, "no_inject": {"fused_inject": False},
         "stage": {"fused_stage": True},
         "unfused": {"fused_resblocks": False}}
# the JAX package's fused-vs-unfused Generator tolerance
# (tests/test_nsf_hifigan.py)
ATOL, RTOL = 2e-5, 1e-4
# enhance and enhance_batch against the JAX Enhancer, relative to max |ref|:
# inside the JAX package's own Generator-vs-reference bound, 5e-3
# (tests/test_nsf_hifigan.py). The seeded generator amplifies the two
# frameworks' fp32 rounding differences (the mel agrees to 5e-7, the source
# to ~1e-5) more on these 70-frame signals than on the 24-frame random mels
# above: read 1.6e-4 to 9.3e-4 over f0 of 150 to 900 Hz and keys 0 to 3
ENHANCE_TOL = 2e-3


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _port_generator(form: str, seed: int = 2):
    tg = generator_from_h(H, **FORMS[form])
    return lecun_init_(tg, torch.Generator().manual_seed(seed)).eval()


def _jax_generator(form: str):
    forms = FORMS[form]
    return JGenerator(
        sampling_rate=SR, num_mels=H["num_mels"],
        upsample_rates=tuple(H["upsample_rates"]),
        upsample_kernel_sizes=tuple(H["upsample_kernel_sizes"]),
        upsample_initial_channel=H["upsample_initial_channel"],
        resblock_kernel_sizes=tuple(H["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(tuple(d) for d in
                                      H["resblock_dilation_sizes"]),
        # "force": the Pallas kernels in interpret mode on the CPU
        fused_resblocks="force" if forms.get("fused_resblocks", True)
        else False,
        fused_mxu_bf16=False, fused_inject=forms.get("fused_inject", True),
        fused_stage=forms.get("fused_stage", False))


def _variables(module):
    sd = {k: v.numpy() for k, v in module.state_dict().items()}
    return jconvert.convert_nsf_hifigan_state_dict(sd, H)


def _generator_inputs(seed, b=3, f=24):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((b, f, H["num_mels"])).astype(np.float32)
    f0 = (150.0 + 100.0 * rng.random((b, f))).astype(np.float32)
    ri = rng.uniform(0, 1, (b, 9)).astype(np.float32)
    ri[:, 0] = 0
    return mel, f0, ri


@pytest.mark.parametrize("form", list(FORMS))
def test_generator_form_matches_jax(form):
    """Each form against the JAX Generator in the same form (its trio and
    stage kernels in interpret mode): atol 2e-5, rtol 1e-4."""
    mel, f0, ri = _generator_inputs(1, b=2)
    tg = _port_generator(form)
    ref = np.asarray(_jax_generator(form).apply(
        _variables(tg), *(jnp.asarray(a) for a in (mel, f0, ri))))
    with torch.no_grad():
        got = tg(_t(mel), _t(f0), _t(ri)).numpy()
    assert got.shape == ref.shape == (2, 24 * 128)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("form", ["inject", "no_inject", "unfused"])
def test_generator_valid_frames(form):
    """A bucket-padded batch with per-item valid_frames against the JAX
    Generator's (atol 2e-5, rtol 1e-4), and each item against its own
    exact-length forward within 1e-4 of its max |out| (the JAX package's
    masked fused-trio bound, tests/test_batch_inference.py) with the tail
    exactly 0."""
    mel, f0, ri = _generator_inputs(2)
    lengths = [24, 17, 9]
    tg = _port_generator(form)
    ref = np.asarray(_jax_generator(form).apply(
        _variables(tg), *(jnp.asarray(a) for a in (mel, f0, ri)),
        valid_frames=jnp.asarray(lengths, jnp.int32)))
    with torch.no_grad():
        got = tg(_t(mel), _t(f0), _t(ri),
                 valid_frames=torch.tensor(lengths)).numpy()
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
        for i, n in enumerate(lengths):
            exact = tg(_t(mel[i:i + 1, :n]), _t(f0[i:i + 1, :n]),
                       _t(ri[i:i + 1])).numpy()[0]
            err = np.abs(got[i, :n * 128] - exact).max()
            assert err < 1e-4 * np.abs(exact).max(), (i, err)
            assert not got[i, n * 128:].any()


def test_log_mel_pre_padded():
    """pre_padded=True on audio the caller reflect-padded: the JAX
    frontend's on the same input within atol 2e-4 (the frontend tolerance
    of tests/test_nsf_hifigan.py), and equal to the frontend's own
    padding."""
    x = (np.random.default_rng(6).standard_normal((2, 5000)) * 0.2
         ).astype(np.float32)
    args = (16000, 512, 128, 512, 32, 40.0, 8000.0)
    padded = np.pad(x, ((0, 0), (192, 192)), mode="reflect")
    ref = np.asarray(jspectral.log_mel_spectrogram(jnp.asarray(padded), *args,
                                                   pre_padded=True))
    got = spectral.log_mel_spectrogram(_t(padded), *args, pre_padded=True)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)
    own = spectral.log_mel_spectrogram(_t(x), *args)
    torch.testing.assert_close(got, own, atol=0, rtol=0)


@pytest.mark.parametrize("orig,new", [(44100, 49500), (49500, 44100),
                                      (44100, 16000)])
def test_resample_matches_jax(orig, new):
    """The same float64-built filter bank applied by each framework's fp32
    convolution: within 1e-5 of max |ref| (the rounding of sums of 309 to
    1155 taps, read ~1e-7)."""
    x = (np.random.default_rng(orig + new).standard_normal((2, 3001)) * 0.3
         ).astype(np.float32)
    ref = np.asarray(jresample(jnp.asarray(x), orig, new))
    got = resample(_t(x), orig, new).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-5 * np.abs(ref).max()


@pytest.fixture(scope="module")
def enhancers():
    enh = Enhancer("nsf-hifigan", None, h=H, seed=3, device="cpu")
    gen_sd = {k: v.numpy() for k, v in
              enh.enhancer.model.state_dict().items()}
    jenh = JEnhancer("nsf-hifigan", None, h=H,
                     variables=jconvert.convert_nsf_hifigan_state_dict(gen_sd,
                                                                       H))
    return enh, jenh


def _segments(seed, lengths, hop=128, f0_hz=(180.0, 900.0)):
    rng = np.random.default_rng(seed)
    audios, f0s, ris = [], [], []
    for t in lengths:
        audios.append((rng.standard_normal((1, t)) * 0.1).astype(np.float32))
        nf = t // hop + 1
        f0s.append(np.linspace(*f0_hz, nf, dtype=np.float32)[None, :, None])
        ri = rng.uniform(0, 1, (1, 9)).astype(np.float32)
        ri[:, 0] = 0
        ris.append(ri)
    return audios, f0s, ris


@pytest.mark.parametrize("key", [2, "auto"])
def test_enhance_adaptive_key_matches_jax(enhancers, key):
    """enhance with an adaptive key (2: 16 kHz -> 18 kHz and back; 'auto'
    from a 900 Hz f0 peak: key 3) and a silence front, against the JAX
    Enhancer: within ENHANCE_TOL of max |ref|."""
    enh, jenh = enhancers
    audios, f0s, ris = _segments(4, [9000])
    ref, sr_r = jenh.enhance(audios[0], SR, f0s[0], 128, adaptive_key=key,
                             silence_front=0.05, rand_ini=ris[0])
    got, sr_g = enh.enhance(_t(audios[0]), SR, f0s[0], 128, adaptive_key=key,
                            silence_front=0.05, rand_ini=ris[0])
    ref = np.asarray(ref)
    assert sr_g == sr_r and got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() < ENHANCE_TOL * np.abs(ref).max()


@pytest.mark.parametrize("key", [0, 3])
def test_enhance_batch_matches_jax_and_single(enhancers, key):
    """enhance_batch against the JAX enhance_batch (ENHANCE_TOL of each
    item's max |ref|) and each item against the port's own enhance of it
    (1e-5, the JAX package's own batch-vs-single bound)."""
    enh, jenh = enhancers
    audios, f0s, ris = _segments(5, [16000, 12160, 7040], f0_hz=(150., 260.))
    rand_ini = np.concatenate(ris, 0)
    ref, sr_r = jenh.enhance_batch(audios, SR, f0s, 128, adaptive_key=key,
                                   rand_ini=rand_ini, pad_to=17000)
    got, sr_g = enh.enhance_batch(audios, SR, f0s, 128, adaptive_key=key,
                                  rand_ini=rand_ini, pad_to=17000)
    assert sr_g == sr_r and len(got) == 3
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        assert g.shape == r.shape
        assert np.abs(g.numpy() - r).max() < ENHANCE_TOL * np.abs(r).max(), i
        single, _ = enh.enhance(_t(audios[i]), SR, f0s[i], 128,
                                adaptive_key=key, rand_ini=ris[i])
        assert g.shape == single.shape
        err = (g - single).abs().max() / single.abs().max()
        assert err < 1e-5, (i, err.item())


def _weight_norm_state_dict(tg, seed):
    """tg's weights in the reference format: every conv but the injection
    convs as weight_g / weight_v (torch weight_norm, dim 0), the
    ConvTranspose norms per input channel."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in tg.state_dict().items():
        if k.endswith(".weight") and not k.startswith(("noise_convs",
                                                       "m_source")):
            p = k[:-len("weight")]
            w = v.numpy()
            norm = np.sqrt((w ** 2).sum(axis=tuple(range(1, w.ndim)),
                                        keepdims=True))
            scale = rng.uniform(0.5, 2.0, norm.shape).astype(np.float32)
            sd[p + "weight_v"] = torch.from_numpy(w * scale)
            sd[p + "weight_g"] = torch.from_numpy(norm)
        else:
            sd[k] = v
    return sd


@pytest.mark.parametrize("wrapped", [True, False])
def test_checkpoint_loading_matches_jax(tmp_path, wrapped):
    """A reference-format checkpoint (weight_g / weight_v, under a
    'generator' key or bare) and its config.json, loaded by the JAX
    NsfHifiGAN and by the port's: the port's folded weights equal to the
    originals (1e-5 relative), the forward on audio within ENHANCE_TOL of
    max |ref|."""
    tg = _port_generator("unfused", seed=8)
    sd = _weight_norm_state_dict(tg, 9)
    path = tmp_path / "model"
    torch.save({"generator": sd} if wrapped else sd, path)
    (tmp_path / "config.json").write_text(json.dumps(H))
    nsf = NsfHifiGAN(str(path), device="cpu")
    jnsf = JNsfHifiGAN(str(path))
    for k, v in tg.state_dict().items():
        torch.testing.assert_close(nsf.model.state_dict()[k], v, atol=1e-6,
                                   rtol=1e-5)
    audio = (np.random.default_rng(10).standard_normal((1, 6000)) * 0.1
             ).astype(np.float32)
    f0 = np.full((1, 6000 // 128 + 1), 220.0, np.float32)
    ri = np.zeros((1, 9), np.float32)
    ref, _ = jnsf(jnp.asarray(audio), jnp.asarray(f0), rand_ini=ri)
    got, _ = nsf(_t(audio), _t(f0), rand_ini=_t(ri))
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() < ENHANCE_TOL * np.abs(ref).max()


def test_load_audio_resamples_like_jax(tmp_path):
    """A 44.1 kHz stereo file loaded at 16 kHz, mono: the JAX loader's
    samples within 1e-5 of max |ref| (the resampler's tolerance above)."""
    t = np.arange(44100 // 2) / 44100
    stereo = np.stack([np.sin(2 * np.pi * 440 * t),
                       0.5 * np.sin(2 * np.pi * 1250 * t)]).astype(np.float32)
    path = str(tmp_path / "a.wav")
    wavio.write_wav(path, stereo * 0.5, 44100, subtype="FLOAT")
    ref, sr_r = jwavio.load_audio(path, 16000)
    got, sr_g = wavio.load_audio(path, 16000)
    assert sr_g == sr_r == 16000 and got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-5 * np.abs(ref).max()
