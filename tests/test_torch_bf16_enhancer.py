"""PyTorch port, the staged-bf16 NSF-HiFiGAN enhancer against the JAX
package on the CPU: the Generator at `bf16_min_channels` (the wide stages in
bf16, the narrow ones fp32, the output fp32) against the JAX staged forward
and against its own fp32 forward, where the casts fall, the full-bf16
`dtype`, the mel's `mxu_bf16` route, and `Enhancer(bf16_min_channels=)`.
Weights: the port's, seeded, mapped into the JAX package by its own
converter. bf16 rounds differently in XLA-CPU and in PyTorch, so the bounds
are relative RMS: JAX's own staged-vs-fp32 bound, 2e-2
(tests/test_nsf_hifigan.py::test_generator_staged_bf16_tracks_fp32)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from ddsp_svc_tpu.infer.enhancer import Enhancer as JEnhancer
from ddsp_svc_tpu.nn.nsf_hifigan import Generator as JGenerator
from ddsp_svc_tpu.ops import spectral as jspectral
from ddsp_svc_tpu.utils import convert as jconvert
from ddsp_svc_tpu_torch.infer.enhancer import Enhancer
from ddsp_svc_tpu_torch.nn.layers import lecun_init_
from ddsp_svc_tpu_torch.nn.nsf_hifigan import generator_from_h
from ddsp_svc_tpu_torch.ops import spectral

torch.set_num_threads(2)

# tests/test_nsf_hifigan.py's geometry: stages of 32, 16, 8, 4 and 2
# channels; at bf16_min_channels=16 the first two run in bf16
H = {
    "sampling_rate": 16000, "num_mels": 16, "n_fft": 512, "win_size": 512,
    "hop_size": 128, "fmin": 40, "fmax": 8000,
    "upsample_rates": [4, 4, 2, 2, 2], "upsample_kernel_sizes": [8, 8, 4, 4, 4],
    "upsample_initial_channel": 64, "resblock": "1",
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5]] * 3,
}
THRESHOLD = 16
REL_RMS = 2e-2


def _rel_rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / (np.sqrt(np.mean(b ** 2))
                                                   + 1e-12))


def _jax_generator(**kw):
    return JGenerator(
        sampling_rate=H["sampling_rate"], num_mels=H["num_mels"],
        upsample_rates=tuple(H["upsample_rates"]),
        upsample_kernel_sizes=tuple(H["upsample_kernel_sizes"]),
        upsample_initial_channel=H["upsample_initial_channel"],
        resblock_kernel_sizes=tuple(H["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(tuple(d) for d in
                                      H["resblock_dilation_sizes"]), **kw)


def _inputs(seed=3, b=2, f=12):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((b, f, H["num_mels"])).astype(np.float32)
    f0 = (150.0 + 100.0 * rng.random((b, f))).astype(np.float32)
    ri = rng.uniform(0, 1, (b, 9)).astype(np.float32)
    ri[:, 0] = 0
    return mel, f0, ri


def _port(**kw):
    g = generator_from_h(H, **kw)
    return lecun_init_(g, torch.Generator().manual_seed(2)).eval()


def _variables(g):
    sd = {k: v.numpy() for k, v in g.state_dict().items()}
    return jconvert.convert_nsf_hifigan_state_dict(sd, H)


@pytest.mark.parametrize("kw", [{"bf16_min_channels": THRESHOLD},
                                {"dtype": "bf16"}], ids=["staged", "full"])
def test_bf16_generator_matches_jax_and_fp32(kw):
    """The staged (threshold 16) and the full-bf16 Generator: fp32 output,
    within rel RMS 2e-2 of the JAX forward of the same form and of the
    port's own fp32 forward on the same weights."""
    jkw = dict(kw)
    if "dtype" in kw:
        kw, jkw = {"dtype": torch.bfloat16}, {"dtype": jnp.bfloat16}
    mel, f0, ri = _inputs()
    g32 = _port()
    g16 = _port(**kw)
    g16.load_state_dict(g32.state_dict())
    ref = np.asarray(_jax_generator(**jkw).apply(
        _variables(g32), *(jnp.asarray(a) for a in (mel, f0, ri))))
    args = [torch.from_numpy(a) for a in (mel, f0, ri)]
    with torch.no_grad():
        y16 = g16(*args)
        y32 = g32(*args).numpy()
    assert y16.dtype == torch.float32 and bool(torch.isfinite(y16).all())
    y16 = y16.numpy()
    assert y16.shape == ref.shape == (2, 12 * 128)
    to_jax, to_fp32 = _rel_rms(y16, ref), _rel_rms(y16, y32)
    assert to_jax < REL_RMS, to_jax
    assert to_fp32 < REL_RMS, to_fp32
    # bf16 really ran: the fp32 forward is not within bf16's reach of it
    assert to_fp32 > 1e-4, to_fp32


def test_staged_casts_fall_on_the_wide_stages(monkeypatch):
    """At threshold 16 the C = 32 and 16 stages are bf16: their transposed
    convs run on bf16 inputs and weights, and their injection conv and 18
    ResBlock convs run in the trio's bf16-input form (JAX's
    fused_resblocks_inject_pallas on a bf16 stage), here its plain version:
    fp32 convs on the upcast input and the fp32 weights. conv_pre,
    conv_post and the narrow stages run fp32."""
    seen = []
    conv1d, convt = F.conv1d, F.conv_transpose1d

    def spy(fn, kind):
        def run(x, w, *a, **k):
            seen.append((kind, x.dtype, w.dtype, w.shape[0]
                         if kind == "conv" else w.shape[1]))
            return fn(x, w, *a, **k)
        return run

    monkeypatch.setattr(F, "conv1d", spy(conv1d, "conv"))
    monkeypatch.setattr(F, "conv_transpose1d", spy(convt, "up"))
    mel, f0, ri = _inputs(b=1)
    with torch.no_grad():
        out = _port(bf16_min_channels=THRESHOLD)(
            *(torch.from_numpy(a) for a in (mel, f0, ri)))
    assert out.dtype == torch.float32
    bf16 = [s for s in seen if s[1] == torch.bfloat16]
    assert all(s[2] == torch.bfloat16 for s in bf16)
    assert sorted({s[3] for s in bf16}) == [16, 32]
    assert [s[0] for s in bf16] == ["up", "up"]
    fp32 = [s for s in seen if s[1] == torch.float32]
    assert all(s[2] == torch.float32 for s in fp32)
    trio = [s for s in fp32 if s[0] == "conv" and s[3] in (16, 32)]
    assert len(trio) == 2 * (1 + 18), trio
    assert all(s[3] < THRESHOLD or s[3] in (1, 16, 32, 64)
               for s in fp32), fp32


def test_log_mel_mxu_bf16_takes_the_fp32_route():
    """On the CPU, mxu_bf16=True gives the fp32 route's bits (the card
    takes the dft_magnitude kernel: tests/test_torch_cuda.py), and JAX's
    mel under mxu_bf16=True on the CPU within the frontend tolerance
    (atol 2e-4, tests/test_torch_enhancer.py::test_log_mel_pre_padded)."""
    rng = np.random.default_rng(5)
    x = (0.3 * rng.standard_normal((2, 4000))).astype(np.float32)
    args = (H["sampling_rate"], H["n_fft"], H["hop_size"], H["win_size"],
            H["num_mels"], H["fmin"], H["fmax"])
    got = spectral.log_mel_spectrogram(torch.from_numpy(x), *args,
                                       mxu_bf16=True)
    fp32 = spectral.log_mel_spectrogram(torch.from_numpy(x), *args)
    assert torch.equal(got, fp32)
    ref = np.asarray(jspectral.log_mel_spectrogram(jnp.asarray(x), *args,
                                                   mxu_bf16=True))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)


def test_enhancer_staged_matches_jax():
    """Enhancer(bf16_min_channels=16).enhance against the JAX Enhancer's on
    the same weights and SineGen phases (rel RMS 2e-2), and against the
    port's fp32 Enhancer (rel RMS 2e-2)."""
    rng = np.random.default_rng(6)
    sr, hop, n = 16000, 128, 40
    tt = np.arange(n * hop) / sr
    audio = (0.3 * np.sin(2 * np.pi * 220 * tt)
             + 0.01 * rng.standard_normal(n * hop)).astype(np.float32)[None]
    f0 = np.full((1, n, 1), 220.0, np.float32)
    ri = np.concatenate([[0.0], rng.random(8)])[None].astype(np.float32)
    enh16 = Enhancer("nsf-hifigan", None, h=H, seed=1, device="cpu",
                     bf16_min_channels=THRESHOLD)
    enh32 = Enhancer("nsf-hifigan", None, h=H, seed=1, device="cpu")
    got, sr_o = enh16.enhance(torch.from_numpy(audio), sr, f0, hop,
                              rand_ini=ri)
    fp32, _ = enh32.enhance(torch.from_numpy(audio), sr, f0, hop, rand_ini=ri)
    jenh = JEnhancer("nsf-hifigan", None, h=H,
                     variables=_variables(enh16.enhancer.model),
                     bf16_min_channels=THRESHOLD)
    ref, jsr = jenh.enhance(audio, sr, f0, hop, rand_ini=ri)
    ref = np.asarray(ref)
    assert sr_o == jsr == sr and got.dtype == torch.float32
    assert got.shape == ref.shape == fp32.shape
    assert _rel_rms(got.numpy(), ref) < REL_RMS
    assert _rel_rms(got.numpy(), fp32.numpy()) < REL_RMS
