"""PyTorch port, the slice as a whole: `convert_features` (bucketed synth,
response mask, enhancer, stitching) against the JAX package's segment loop
of `run_inference` on the same weights, noise and SineGen phases, and the
offline helpers against theirs, on the CPU."""
import numpy as np
import jax
import pytest
import torch

from ddsp_svc_tpu.infer import offline as joffline
from ddsp_svc_tpu.infer.enhancer import Enhancer as JEnhancer
from ddsp_svc_tpu.models.factory import make_jitted_synth
from ddsp_svc_tpu.models.synths import CombSubFast as JCombSubFast
from ddsp_svc_tpu.utils import convert as jconvert
from ddsp_svc_tpu_torch.infer import offline
from ddsp_svc_tpu_torch.infer.enhancer import Enhancer
from ddsp_svc_tpu_torch.models.factory import build_model
from ddsp_svc_tpu_torch.utils.config import DotDict

torch.set_num_threads(2)

SR, BLOCK, N_UNIT, N_SPK = 16000, 64, 16, 4
H = {
    "sampling_rate": 16000, "num_mels": 16, "n_fft": 512, "win_size": 512,
    "hop_size": 128, "fmin": 40, "fmax": 8000,
    "upsample_rates": [4, 4, 8], "upsample_kernel_sizes": [8, 8, 16],
    "upsample_initial_channel": 32, "resblock": "1",
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
}
ARGS = DotDict({
    "data": {"sampling_rate": SR, "block_size": BLOCK,
             "encoder_out_channels": N_UNIT},
    "model": {"type": "CombSubFast", "n_spk": N_SPK},
})


def _jax_segment_loop(jm, variables, jenh, segments, f0, volume, spk_id,
                      noises, rand_inis, threshold_db=-60):
    """run_inference's segment loop (ddsp_svc_tpu/infer/offline.py:165-217)
    over given features, with its noise and SineGen phases injected."""
    synth = make_jitted_synth(jm, variables, mask_padding=True)
    mask = joffline.response_mask(volume[0], threshold_db, BLOCK)
    spk = np.asarray([[spk_id]], np.int64)
    result, current_length, sr_o = np.zeros(0), 0, SR
    for i, (start_frame, seg_units) in enumerate(segments):
        n_f = seg_units.shape[1]
        seg_f0 = f0[:, start_frame: start_frame + n_f, :]
        seg_volume = volume[:, start_frame: start_frame + n_f]
        seg_out = synth(seg_units, seg_f0, seg_volume, spk,
                        jax.random.key(i), noise=noises[i])
        seg_out = seg_out * mask[:, start_frame * BLOCK:
                                 (start_frame + n_f) * BLOCK]
        seg_out, sr_o = jenh.enhance(seg_out, SR, seg_f0, BLOCK,
                                     rand_ini=rand_inis[i])
        seg_out = np.asarray(seg_out).reshape(-1)
        silent = round(start_frame * BLOCK * sr_o / SR) - current_length
        if silent >= 0:
            result = np.append(result, np.zeros(silent))
            result = np.append(result, seg_out)
        else:
            result = joffline.cross_fade(result, seg_out,
                                         current_length + silent)
        current_length = current_length + silent + len(seg_out)
    return result, sr_o


def test_convert_features_matches_jax_segment_loop():
    """Two segments, 40 frames (bucket-padded to 64, masked) and 32 frames
    (exact bucket), the second overlapping the first's tail so the
    cross-fade runs; quiet frames exercise the response mask. Within 2e-4
    of max |ref|: twice the CombSubFast tolerance (1e-4 of its max), which
    the enhancer's log-mel and convolutions carry through (measured 3e-5)."""
    rng = np.random.default_rng(0)
    total = 80
    f0 = (150 + 80 * np.sin(np.arange(total) / 7.0))[None, :, None]
    f0 = f0.astype(np.float32)
    volume = (0.2 * rng.random((1, total))).astype(np.float32)
    volume[0, 20:26] = 1e-4
    segments = [(2, rng.standard_normal((1, 40, N_UNIT)).astype(np.float32)),
                (38, rng.standard_normal((1, 32, N_UNIT)).astype(np.float32))]
    noises = [(rng.random((1, n.shape[1] * BLOCK)) * 2 - 1).astype(np.float32)
              for _, n in segments]
    rand_inis = [np.concatenate([[0.0], rng.random(8)])[None].astype(np.float32)
                 for _ in segments]

    model = build_model(ARGS, device="cpu", seed=0)
    enhancer = Enhancer("nsf-hifigan", None, h=H, seed=1, device="cpu")
    got, sr = offline.convert_features(
        model, segments, f0, volume, spk_id=3, enhancer=enhancer,
        noise_hook=lambda i, shape: noises[i],
        enhancer_rand_hook=lambda i: rand_inis[i])

    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jm = JCombSubFast(sampling_rate=SR, block_size=BLOCK, n_unit=N_UNIT,
                      n_spk=N_SPK)
    variables = jconvert.convert_synth_state_dict(sd, num_layers=3)
    gen_sd = {k: v.numpy() for k, v in
              enhancer.enhancer.model.state_dict().items()}
    jenh = JEnhancer("nsf-hifigan", None, h=H,
                     variables=jconvert.convert_nsf_hifigan_state_dict(gen_sd, H))
    ref, sr_ref = _jax_segment_loop(jm, variables, jenh, segments, f0, volume,
                                    3, noises, rand_inis)
    assert sr == sr_ref == SR
    assert got.shape == ref.shape == ((38 + 32) * BLOCK,)
    assert np.abs(got - ref).max() < 2e-4 * np.abs(ref).max()


def test_convert_features_checks_speakers():
    model = build_model(ARGS, device="cpu", seed=0)
    seg = [(0, np.zeros((1, 8, N_UNIT), np.float32))]
    f0 = np.full((1, 8, 1), 200, np.float32)
    vol = np.ones((1, 8), np.float32)
    with pytest.raises(ValueError, match="out of range"):
        offline.convert_features(model, seg, f0, vol, spk_id=N_SPK + 1)
    with pytest.raises(ValueError, match="out of range"):
        offline.convert_features(model, seg, f0, vol, spk_mix_dict={0: 1.0})
    out, sr = offline.convert_features(model, seg, f0, vol,
                                       spk_mix_dict={1: 0.5, 4: 0.5})
    assert out.shape == (8 * BLOCK,) and sr == SR and np.isfinite(out).all()


def test_split_cross_fade_response_mask_match_jax():
    rng = np.random.default_rng(1)
    sr = 8000
    audio = (rng.standard_normal(14 * sr) * 0.3).astype(np.float32)
    audio[6 * sr: 8 * sr] *= 1e-4  # a silence the slicer cuts at
    got, ref = offline.split(audio, sr, 80.0), joffline.split(audio, sr, 80.0)
    assert len(got) == len(ref) == 2
    for (s1, a1), (s2, a2) in zip(got, ref):
        assert s1 == s2
        np.testing.assert_array_equal(a1, a2)
    a, b = rng.standard_normal(500), rng.standard_normal(300)
    np.testing.assert_array_equal(offline.cross_fade(a, b, 420),
                                  joffline.cross_fade(a, b, 420))
    vol = rng.random(60).astype(np.float32) * 0.01
    np.testing.assert_array_equal(offline.response_mask(vol, -45, 64),
                                  joffline.response_mask(vol, -45, 64))
