"""PyTorch port, DSP ops: each function of `ddsp_svc_tpu_torch.ops` against
its JAX counterpart on the same seeded numpy inputs (CPU)."""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ddsp_svc_tpu import ops as jops
from ddsp_svc_tpu.ops import masking as jmasking
from ddsp_svc_tpu.ops import phase as jphase
from ddsp_svc_tpu.ops import spectral as jspectral
from ddsp_svc_tpu_torch.ops import (exciters, interp, masking, phase,
                                    spectral, windows)

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("n", [1, 64, 1024, 2048])
def test_windows_bit_identical(n):
    np.testing.assert_array_equal(windows.hann_window(n).numpy(),
                                  np.asarray(jops.hann_window(n)))
    np.testing.assert_array_equal(windows.sqrt_hann_window(n).numpy(),
                                  np.asarray(jops.sqrt_hann_window(n)))


def test_upsample_frames():
    x = np.random.default_rng(0).standard_normal((2, 7, 3)).astype(np.float32)
    ref = np.asarray(jops.upsample_frames(jnp.asarray(x), 64))
    got = interp.upsample_frames(_t(x), 64).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("sr,block", [(44100, 512), (16000, 160)])
def test_f0_to_rot_upsampled(sr, block):
    """Double-single frame carries: the JAX scan and the port's scan combine
    in other orders, so they agree to the compensated floor plus the fp32
    closed form (the JAX package's own phase tests hold 1e-6 rotations)."""
    rng = np.random.default_rng(1)
    f0 = (80 + 700 * rng.random((2, 300))).astype(np.float32)
    ip = rng.uniform(-np.pi, np.pi, 2).astype(np.float32)
    ref = np.asarray(jphase.f0_to_rot_upsampled(jnp.asarray(f0), block, sr,
                                                jnp.asarray(ip)))
    got = phase.f0_to_rot_upsampled(_t(f0), block, sr, _t(ip)).numpy()
    d = got - ref
    d -= np.round(d)  # rotations are compared modulo 1
    assert np.abs(d).max() < 1e-6, np.abs(d).max()


def test_double_single_primitives_exact():
    rng = np.random.default_rng(2)
    a = (rng.standard_normal(1000) * 1e3).astype(np.float32)
    b = (rng.standard_normal(1000) * 1e-2).astype(np.float32)
    for fn in ("_two_sum", "_two_prod", "_fast_two_sum"):
        x, y = getattr(phase, fn)(_t(a), _t(b))
        ex = getattr(a.astype(np.float64), "__add__" if "sum" in fn
                     else "__mul__")(b.astype(np.float64))
        np.testing.assert_array_equal(
            x.numpy().astype(np.float64) + y.numpy().astype(np.float64), ex)
    q = phase._div_ds(_t(a), _t(b), 44100.0)
    jq = jphase._div_ds(jnp.asarray(a), jnp.asarray(b), jnp.float32(44100.0))
    for x, y in zip(q, jq):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_cumsum_mod1_compensated():
    x = np.random.default_rng(3).random((2, 500)).astype(np.float32)
    ref = np.asarray(jphase._cumsum_mod1_compensated(jnp.asarray(x), axis=1))
    got = phase._cumsum_mod1_compensated(_t(x), dim=1).numpy()
    d = got - ref
    d -= np.round(d)
    assert np.abs(d).max() < 1e-6


def test_combtooth_and_remove_above_fmax():
    rng = np.random.default_rng(4)
    f0 = np.where(rng.random((2, 400)) < 0.2, 0.0,
                  100 + 300 * rng.random((2, 400))).astype(np.float32)
    rot = rng.uniform(-0.5, 0.5, (2, 400)).astype(np.float32)
    ref = np.asarray(jops.combtooth(jnp.asarray(rot), jnp.asarray(f0), 44100))
    got = exciters.combtooth(_t(rot), _t(f0), 44100).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    amps = rng.random((2, 10, 30)).astype(np.float32)
    pitch = (200 + 800 * rng.random((2, 10, 1))).astype(np.float32)
    ref = np.asarray(jops.remove_above_fmax(jnp.asarray(amps),
                                            jnp.asarray(pitch), 8000.0))
    got = exciters.remove_above_fmax(_t(amps), _t(pitch), 8000.0).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("valid", [5, [3, 9]])
def test_masks(valid):
    np.testing.assert_array_equal(
        masking.frame_mask(12, valid, torch.float32).numpy(),
        np.asarray(jmasking.frame_mask(12, jnp.asarray(valid), jnp.float32)))
    np.testing.assert_array_equal(
        masking.valid_col(valid).numpy(),
        np.asarray(jmasking.valid_col(jnp.asarray(valid))))


def test_framing_overlap_add_stft():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 1000)).astype(np.float32)
    np.testing.assert_array_equal(
        spectral.frame_signal(_t(x), 128, 64).numpy(),
        np.asarray(jspectral.frame_signal(jnp.asarray(x), 128, 64)))
    fr = rng.standard_normal((2, 9, 128)).astype(np.float32)
    np.testing.assert_allclose(
        spectral.overlap_add_half(_t(fr), 64).numpy(),
        np.asarray(jspectral.overlap_add_half(jnp.asarray(fr), 64)), atol=1e-6)
    win = jops.hann_window(200)
    ref = np.asarray(jspectral.stft(jnp.asarray(x), 256, 64, win))
    got = spectral.stft(_t(x), 256, 64, windows.hann_window(200)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4)


def test_mel_filterbank_and_log_mel():
    """Same slaney basis bit for bit; the log-mel frontend within the JAX
    package's own frontend tolerance (atol 2e-4, test_nsf_hifigan.py)."""
    np.testing.assert_array_equal(
        spectral.mel_filterbank(44100, 2048, 128, 40, 16000),
        jspectral.mel_filterbank(44100, 2048, 128, 40, 16000))
    x = (np.random.default_rng(6).standard_normal((2, 5000)) * 0.2
         ).astype(np.float32)
    args = (16000, 512, 128, 512, 32, 40.0, 8000.0)
    ref = np.asarray(jspectral.log_mel_spectrogram(jnp.asarray(x), *args))
    got = spectral.log_mel_spectrogram(_t(x), *args).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-4)


@pytest.mark.parametrize("keyshift,speed,n", [
    (2, 1.0, 5000), (-3, 1.0, 5000), (0, 1.25, 5000), (2, 1.0, 200)],
    ids=["keyshift+2", "keyshift-3", "speed1.25", "constant-pad"])
def test_log_mel_keyshift_matches_jax(keyshift, speed, n):
    """The keyshift/speed mel (`_log_mel_keyshift`) against JAX's at atol
    2e-4, the fp32 mel's bound: +2 (n_fft 512 -> 575, bins truncated), -3
    (431, bins padded), speed 1.25 (hop 160), and an input of 200 samples,
    whose right pad reaches past it (constant padding)."""
    x = (np.random.default_rng(7).standard_normal((2, n)) * 0.2
         ).astype(np.float32)
    args = (16000, 512, 128, 512, 32, 40.0, 8000.0)
    ref = np.asarray(jspectral.log_mel_spectrogram(
        jnp.asarray(x), *args, keyshift=keyshift, speed=speed))
    got = spectral.log_mel_spectrogram(_t(x), *args, keyshift=keyshift,
                                       speed=speed).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-4)


def test_config():
    from ddsp_svc_tpu.utils.config import load_config as jload
    from ddsp_svc_tpu_torch.utils.config import load_config

    path = os.path.join(os.path.dirname(__file__), "..", "configs",
                        "combsub.yaml")
    a, b = load_config(path), jload(path)
    assert a == b
    assert a.model.type == "CombSubFast" and a.model.bf16 is None
