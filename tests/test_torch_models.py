"""PyTorch port, models: Unit2Control, CombSubFast and the NSF-HiFiGAN
Generator against the JAX package's modules on the same weights, and the
weight bridge, on the CPU.

The port's modules draw their weights from a seed; the JAX package's own
torch -> flax converters give the JAX modules the same weights (this skips
the slow flax init on the CPU), and the bridge test holds
`jax_*_to_torch` as the exact inverse of those converters."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ddsp_svc_tpu.models.synths import CombSubFast as JCombSubFast
from ddsp_svc_tpu.nn.nsf_hifigan import Generator as JGenerator
from ddsp_svc_tpu.nn.unit2control import Unit2Control as JUnit2Control
from ddsp_svc_tpu.utils import convert as jconvert
from ddsp_svc_tpu_torch.models.synths import CombSubFast
from ddsp_svc_tpu_torch.nn.layers import lecun_init_
from ddsp_svc_tpu_torch.nn.nsf_hifigan import generator_from_h
from ddsp_svc_tpu_torch.nn.unit2control import Unit2Control
from ddsp_svc_tpu_torch.utils.convert import jax_nsf_to_torch, jax_synth_to_torch

torch.set_num_threads(2)

SR, BLOCK, N_UNIT, N_SPK = 16000, 64, 16, 3
# stage widths 16 and 8 take the trio kernel's path, width 4 the wide path
H = {
    "sampling_rate": 16000, "num_mels": 16, "n_fft": 256, "win_size": 256,
    "hop_size": 64, "fmin": 40, "fmax": 8000,
    "upsample_rates": [4, 4, 4], "upsample_kernel_sizes": [8, 8, 8],
    "upsample_initial_channel": 32, "resblock": "1",
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np_sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _seeded(module, seed):
    return lecun_init_(module, torch.Generator().manual_seed(seed)).eval()


def _synth_inputs(seed, b, f):
    rng = np.random.default_rng(seed)
    units = rng.standard_normal((b, f, N_UNIT)).astype(np.float32)
    f0 = (120 + 200 * rng.random((b, f, 1))).astype(np.float32)
    f0[:, f // 3: f // 3 + 4] = 0.0  # an unvoiced stretch
    volume = rng.random((b, f)).astype(np.float32)
    spk = np.asarray([[1 + i % N_SPK] for i in range(b)], np.int64)
    noise = (rng.random((b, f * BLOCK)) * 2 - 1).astype(np.float32)
    return units, f0, volume, spk, noise


@pytest.fixture(scope="module")
def synth_pair():
    """The port's CombSubFast from seed 0, and the JAX CombSubFast's
    variables holding the same weights."""
    tm = _seeded(CombSubFast(SR, BLOCK, n_unit=N_UNIT, n_spk=N_SPK), 0)
    variables = jconvert.convert_synth_state_dict(_np_sd(tm), num_layers=3)
    jm = JCombSubFast(sampling_rate=SR, block_size=BLOCK, n_unit=N_UNIT,
                      n_spk=N_SPK)
    return jm, variables, tm


def test_unit2control_matches_jax():
    """Controls, masked and speaker-mixed, within 1e-4 of max |ref|: fp32
    on both sides, through three PCmer layers whose FAVOR+ features
    exponentiate projection sums (a few 1e-6 relative each)."""
    rng = np.random.default_rng(1)
    b, f, splits = 2, 24, {"a": 5, "b": 7}
    units = rng.standard_normal((b, f, N_UNIT)).astype(np.float32)
    f0 = (100 + 300 * rng.random((b, f, 1))).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (b, f)).astype(np.float32)
    volume = rng.random((b, f)).astype(np.float32)
    spk = np.asarray([1, 3], np.int64)
    tm = _seeded(Unit2Control(N_UNIT, N_SPK, splits), 1)
    params, consts = jconvert.convert_unit2control(
        {f"unit2ctrl.{k}": v for k, v in _np_sd(tm).items()})
    variables = {"params": params, "constants": consts}
    jm = JUnit2Control(N_UNIT, N_SPK, splits)
    jargs = [jnp.asarray(a) for a in (units, f0, phase, volume, spk)]
    targs = [_t(a) for a in (units, f0, phase, volume, spk)]
    for kw in ({}, dict(valid_frames=[17, 9]),
               dict(spk_mix_dict={1: 0.25, 3: 0.75})):
        jkw = dict(kw)
        if "valid_frames" in jkw:
            jkw["valid_frames"] = jnp.asarray(kw["valid_frames"])
        ref = jax.jit(lambda v, *a: jm.apply(v, *a, infer=True, **jkw))(
            variables, *jargs)
        with torch.no_grad():
            got = tm(*targs, infer=True, **kw)
        for name in splits:
            r, g = np.asarray(ref[name]), got[name].numpy()
            assert g.shape == r.shape
            # every frame, the replicated tail past valid_frames included
            assert np.abs(g - r).max() < 1e-4 * np.abs(r).max(), (kw, name)


def _jax_synth(jm, variables, units, f0, volume, spk, noise, valid):
    def fwd(v, u, f, vol, s, n, vf):
        return jm.apply(v, u, f, vol, s, infer=True, noise=n, valid_frames=vf)
    vf = None if valid is None else jnp.asarray(valid)
    return jax.jit(fwd)(variables, *(jnp.asarray(a) for a in
                                      (units, f0, volume, spk, noise)), vf)


@pytest.mark.parametrize("frames,valid", [(32, None), (64, 40)])
def test_combsub_fast_matches_jax(synth_pair, frames, valid):
    """CombSubFast(infer=True, noise=...) audio within 1e-4 of max |ref|
    (the control tolerance above, carried through exp(magnitude) filters);
    with bucket padding, the first `valid` frames of a padded forward."""
    jm, variables, tm = synth_pair
    units, f0, volume, spk, noise = _synth_inputs(2, 1, frames)
    ref, ref_phase, _ = _jax_synth(jm, variables, units, f0, volume, spk,
                                   noise, valid)
    with torch.no_grad():
        got, got_phase, _ = tm(_t(units), _t(f0), _t(volume), _t(spk),
                               infer=True, noise=_t(noise), valid_frames=valid)
    n = (frames if valid is None else valid) * BLOCK
    ref, got = np.asarray(ref)[:, :n], got.numpy()[:, :n]
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()
    np.testing.assert_allclose(got_phase.numpy(), np.asarray(ref_phase),
                               atol=1e-5)


def test_combsub_fast_padding_equals_exact_length(synth_pair):
    """A bucket-padded forward with valid_frames equals the exact-length
    forward on the valid prefix (the masking contract of the bucketed
    synth), within fp32 summation-order noise."""
    _, _, tm = synth_pair
    units, f0, volume, spk, noise = _synth_inputs(3, 1, 40)
    pad = 24
    padded = (np.pad(units, ((0, 0), (0, pad), (0, 0))),
              np.pad(f0, ((0, 0), (0, pad), (0, 0)), mode="edge"),
              np.pad(volume, ((0, 0), (0, pad))), spk,
              np.pad(noise, ((0, 0), (0, pad * BLOCK))))
    with torch.no_grad():
        exact, _, _ = tm(*(_t(a) for a in (units, f0, volume, spk)),
                         noise=_t(noise))
        got, _, _ = tm(*(_t(a) for a in padded[:4]), noise=_t(padded[4]),
                       valid_frames=40)
    exact = exact.numpy()
    got = got.numpy()[:, :exact.shape[1]]
    assert np.abs(got - exact).max() < 1e-5 * np.abs(exact).max()


def test_generator_matches_jax():
    """The port's Generator (the 16- and 8-wide stages through the trio
    kernel's plain version, the last on F.conv1d) against the JAX Generator on the same
    weights: atol 2e-5, rtol 1e-4, the JAX package's fused-vs-unfused
    generator tolerance."""
    rng = np.random.default_rng(7)
    b, f = 2, 12
    mel = rng.standard_normal((b, f, H["num_mels"])).astype(np.float32)
    f0 = (150 + 100 * rng.random((b, f))).astype(np.float32)
    ri = rng.random((b, 9)).astype(np.float32)
    ri[:, 0] = 0
    tg = _seeded(generator_from_h(H), 2)
    variables = jconvert.convert_nsf_hifigan_state_dict(_np_sd(tg), H)
    jg = JGenerator(
        sampling_rate=H["sampling_rate"], num_mels=H["num_mels"],
        upsample_rates=tuple(H["upsample_rates"]),
        upsample_kernel_sizes=tuple(H["upsample_kernel_sizes"]),
        upsample_initial_channel=H["upsample_initial_channel"],
        resblock_kernel_sizes=tuple(H["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(tuple(d) for d in
                                      H["resblock_dilation_sizes"]))
    ref = np.asarray(jax.jit(jg.apply)(
        variables, *(jnp.asarray(a) for a in (mel, f0, ri))))
    with torch.no_grad():
        got = tg(_t(mel), _t(f0), _t(ri)).numpy()
    assert got.shape == ref.shape == (b, f * 64)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)


def test_weight_bridge_inverts_the_jax_converters(synth_pair):
    """jax_*_to_torch is the exact inverse of the JAX package's torch ->
    flax converters, both ways round, and its keys are the reference
    model's (the port's own state_dict keys)."""
    _, variables, tm = synth_pair
    sd = jax_synth_to_torch(variables)
    assert set(sd) == set(tm.state_dict())
    assert "unit2ctrl.dec_post.0.net.2.attn.fast_attention.projection_matrix" in sd
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy())
    back = jconvert.convert_synth_state_dict(
        {k: v.numpy() for k, v in sd.items()}, num_layers=3)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    assert len(leaves) == len(flat)
    for path, leaf in leaves:
        np.testing.assert_array_equal(flat[path], leaf)

    tg = _seeded(generator_from_h(H), 3)
    params = jconvert.convert_nsf_hifigan_state_dict(_np_sd(tg), H)["params"]
    sd = jax_nsf_to_torch(params, H)
    assert "resblocks.8.convs2.2.weight" in sd and "ups.2.weight" in sd
    assert set(sd) == set(tg.state_dict())
    for k, v in tg.state_dict().items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy())
