"""PyTorch port, the Sins and CombSub synthesizers: the oscillator bank and
the LTV-FIR convolution (the plain versions of kernels #8 and #9), the
frequency filter, whole forwards and one training step of each synthesizer,
against the JAX package on the CPU at a small size (16 kHz, block 256, 32
harmonics, 64-bin filters).

The port's models draw their weights from a seed; the JAX package's own
torch -> flax converter gives the JAX models the same weights, and the JAX
gradients come back through the port's `jax_synth_to_torch`. Both sides get
the same noise excitation."""
import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ddsp_svc_tpu.infer import offline as joffline
from ddsp_svc_tpu.models import losses as jlosses
from ddsp_svc_tpu.models.factory import make_jitted_synth
from ddsp_svc_tpu.models.synths import CombSub as JCombSub
from ddsp_svc_tpu.models.synths import Sins as JSins
from ddsp_svc_tpu.ops import exciters as jexciters
from ddsp_svc_tpu.ops import fft_filter as jfft_filter
from ddsp_svc_tpu.ops import pallas_kernels as jpk
from ddsp_svc_tpu.utils import convert as jconvert
from ddsp_svc_tpu_torch.data.wavio import write_wav
from ddsp_svc_tpu_torch.infer.offline import convert_features
from ddsp_svc_tpu_torch.models import losses as tlosses
from ddsp_svc_tpu_torch.models.factory import build_model
from ddsp_svc_tpu_torch.ops import fft_filter
from ddsp_svc_tpu_torch.ops import kernels as K
from ddsp_svc_tpu_torch.train import __main__ as train_main
from ddsp_svc_tpu_torch.train.step import TrainState, create_optimizer, train_step
from ddsp_svc_tpu_torch.utils.config import DotDict
from ddsp_svc_tpu_torch.utils.convert import jax_synth_to_torch
from torch_tmp import tmp_path  # noqa: F401  (removed when each test ends)

torch.set_num_threads(2)

SR, BLOCK, N_UNIT, N_SPK = 16000, 256, 16, 2
SIZES = {"Sins": dict(n_harmonics=32, n_mag_allpass=64, n_mag_noise=64),
         "CombSub": dict(n_mag_allpass=64, n_mag_harmonic=128, n_mag_noise=64)}
JAX_MODELS = {"Sins": JSins, "CombSub": JCombSub}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel_max(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max()
                 / np.abs(np.asarray(ref)).max())


# ---------------------------------------------------- #8 oscillator bank ---


def _osc_inputs(seed, b=2, f=6, h=128, block=64):
    rng = np.random.default_rng(seed)
    phase = (rng.random((b, f * block)) * 2 * np.pi - np.pi).astype(np.float32)
    amps = (rng.random((b, f, h)) * 0.1).astype(np.float32)
    return phase, amps


@pytest.mark.parametrize("h,chunk", [(128, 32), (60, 32)])
def test_oscillator_bank_plain_matches_jax(h, chunk):
    """Against the JAX package's XLA bank at atol 2e-3 (its own
    kernel-vs-XLA bound, test_pallas_kernels.py), and against
    oscillator_bank_pallas in interpret mode at atol 2e-5: both wrap the
    sine argument, so only rounding separates them (read: 5.0e-6 and 6.5e-6
    against max |out| 4.5)."""
    phase, amps = _osc_inputs(0, h=h)
    got = K.oscillator_bank(_t(phase), _t(amps), 64, chunk).numpy()
    ref = np.asarray(jexciters.oscillator_bank(jnp.asarray(phase),
                                               jnp.asarray(amps), 64))
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=0)
    pallas = np.asarray(jpk.oscillator_bank_pallas(
        jnp.asarray(phase), jnp.asarray(amps), 64, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=0)


def test_oscillator_bank_backward():
    """The kernel's backward (oscillator_bank_bwd_plain, autograd of the
    plain version re-run) against autograd through the plain version at 1e-6
    of max |ref| (the same arithmetic), each gradient only when asked for,
    and its amplitude gradient against jax.grad of the XLA bank (which does
    not wrap) at 2e-4 (unwrapped arguments of up to 128 pi carry ulp(400)
    ~3e-5 of rounding into each sine)."""
    phase, amps = _osc_inputs(1, f=5, h=40, block=32)
    rng = np.random.default_rng(2)
    g = rng.standard_normal(phase.shape).astype(np.float32)
    p, a = _t(phase).requires_grad_(), _t(amps).requires_grad_()
    (K.oscillator_bank(p, a, 32, 16) * _t(g)).sum().backward()
    d_phase, d_amps = K.oscillator_bank_bwd_plain(_t(g), _t(phase), _t(amps),
                                                  32, 16, needs=(True, True))
    assert _rel_max(d_amps, a.grad) < 1e-6
    assert _rel_max(d_phase, p.grad) < 1e-6
    assert K.oscillator_bank_bwd_plain(_t(g), _t(phase), _t(amps), 32)[0] is None
    ref = jax.grad(lambda am: jnp.sum(jexciters.oscillator_bank(
        jnp.asarray(phase), am, 32) * g))(jnp.asarray(amps))
    assert _rel_max(d_amps, ref) < 2e-4


# The kernel's evaluation order (csrc/oscillator_bank.cu), emulated in fp32:
# the Chebyshev step along the harmonics, re-seeded every kReseed harmonics
# (read from the source), the lerp split. fp32 ops round as on the card; an
# FFMA is one fp32 rounding of the float64 result (exact but for a rare
# double rounding); the SFU's __sincosf at each re-seed is the correctly
# rounded value moved by its error bound on [-pi, pi], +-4e-7, with a
# seeded sign. No code outside this file calls it.


def _osc_reseed():
    text = (Path(K.__file__).resolve().parents[1] / "csrc"
            / "oscillator_bank.cu").read_text()
    return int(re.search(r"constexpr int kReseed = (\d+);", text).group(1))


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _f32(x):
    return float(np.float32(x))


def _sincos_accurate(x):
    """sincos_accurate of the kernel: Cody-Waite by pi/2, then the CUDA
    math library's sinf/cosf polynomials."""
    def c(v):
        return torch.full_like(x, _f32(v))

    q = torch.round(x * _f32(0.636619772))
    r = _fma(q, c(-1.57079601e+00), x)
    r = _fma(q, c(-3.13916473e-07), r)
    r = _fma(q, c(-5.39030253e-15), r)
    r2 = r * r
    ps = _fma(c(-1.95152959e-4), r2, c(8.33216087e-3))
    ps = _fma(ps, r2, c(-1.66666546e-1))
    sr = _fma(ps * r2, r, r)
    pc = _fma(c(2.44331571e-5), r2, c(-1.38873163e-3))
    pc = _fma(pc, r2, c(4.16666457e-2))
    pc = _fma(pc, r2, c(-0.5))
    cr = _fma(pc, r2, c(1.0))
    i = q.to(torch.int64)
    odd = (i & 1) == 1
    sv, cv = torch.where(odd, cr, sr), torch.where(odd, sr, cr)
    return (torch.where((i & 2) == 2, -sv, sv),
            torch.where(((i + 1) & 2) == 2, -cv, cv))


def _sincos_multiple(n, ph, gen):
    """sincos_multiple of the kernel: n ph wrapped exactly to [-pi, pi],
    then the SFU modelled as above."""
    nn = torch.full_like(ph, float(n))
    y = ph * nn
    lo = _fma(nn, ph, -y)
    q = torch.round(y * _f32(0.15915494309189533577))
    r = _fma(-q, torch.full_like(q, 6.28125), y)
    r = _fma(-q, torch.full_like(q, _f32(1.9353071795864769253e-3)), r)
    r = (r + lo).double()

    def sign():
        return torch.randint(0, 2, ph.shape, generator=gen) * 2.0 - 1

    return ((torch.sin(r) + 4e-7 * sign()).float(),
            (torch.cos(r) + 4e-7 * sign()).float())


def oscillator_bank_emulated(phase, amps, block, reseed, seed=0):
    """The kernel's arithmetic on (B, T) phases and (B, F, H) amplitudes."""
    gen = torch.Generator().manual_seed(seed)
    b, f, h = amps.shape
    a0 = amps.reshape(b * f, h)
    sl = torch.cat([amps[:, 1:], amps[:, -1:]], dim=1).reshape(b * f, h) - a0
    ph = phase.reshape(b * f, block)
    frac = (torch.arange(block, dtype=torch.float32) / float(block))[None]
    frac = frac.expand_as(ph)
    s1, c1 = _sincos_accurate(ph)
    c2 = 2.0 * c1
    s, u = s1, torch.zeros_like(ph)
    acc0 = acc1 = torch.zeros_like(ph)
    for k in range(h):
        if k and k % reseed == 0:
            sn, cn = _sincos_multiple(k + 1, ph, gen)
            s, u = sn, _fma(sn, c1, -(cn * s1))
        ak, dk = a0[:, k:k + 1].expand_as(ph), sl[:, k:k + 1].expand_as(ph)
        acc0, acc1 = _fma(ak, s, acc0), _fma(dk, s, acc1)
        s, u = _fma(c2, s, -u), s
    return _fma(frac, acc1, acc0).reshape(b, f * block)


@pytest.mark.parametrize("h", [128, 60])
def test_oscillator_bank_kernel_order_matches_jax(h):
    """The kernel's evaluation order (emulated) against the JAX package's
    XLA bank at atol 2e-3, its kernel-vs-XLA bound
    (test_pallas_kernels.py), on the same inputs."""
    phase, amps = _osc_inputs(0, h=h)
    got = oscillator_bank_emulated(_t(phase), _t(amps), 64, _osc_reseed())
    ref = np.asarray(jexciters.oscillator_bank(jnp.asarray(phase),
                                               jnp.asarray(amps), 64))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-3, rtol=0)


def test_oscillator_bank_kernel_order_float64_gate():
    """The kernel's evaluation order (emulated) at 128 harmonics against
    float64 within 2x the fp32 plain version's own error + 1e-7 of max
    |f64|, on 51,200 samples: uniform phases, and phases near 0 and +-pi
    (within 0.1), where the recurrence is weakest."""
    rng = np.random.default_rng(5)
    b, f, h, block = 4, 25, 128, 512
    phase = (rng.random((b, f * block)) * 2 - 1) * np.pi
    phase[1] = (rng.random(f * block) * 2 - 1) * 0.1
    phase[2] = np.sign(rng.random(f * block) - 0.5) * (
        np.pi - rng.random(f * block) * 0.1)
    phase = _t(phase.astype(np.float32))
    amps = _t((rng.random((b, f, h)) * 0.1).astype(np.float32))
    got = oscillator_bank_emulated(phase, amps, block, _osc_reseed())
    f64 = K.oscillator_bank_plain(phase.double(), amps.double(), block)
    plain = K.oscillator_bank_plain(phase, amps, block)
    e_plain = (plain.double() - f64).abs().max().item()
    err = (got.double() - f64).abs().max().item()
    assert err <= 2 * e_plain + 1e-7 * f64.abs().max().item(), (err, e_plain)


# --------------------------------------------------- #9 LTV-FIR convolve ---


def _ltv_inputs(seed, rows=10, frame=128, ir=126):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((rows, frame)).astype(np.float32)
    h = (rng.standard_normal((rows, ir)) * 0.05).astype(np.float32)
    g = rng.standard_normal((rows, 256)).astype(np.float32)
    return a, h, g


def test_ltv_fir_convolve_plain_matches_jax():
    """The plain version against ltv_fir_convolve_pallas in interpret mode
    and against its plain-jnp reference _spectral_convolve_dft, output and
    both gradients (autograd through the plain version, and the kernel's
    backward ltv_fir_convolve_bwd_plain, against the Pallas custom VJP):
    2e-4 of max |ref| each, the JAX package's own bound
    (test_pallas_kernels.py)."""
    a, h, g = _ltv_inputs(3)
    n = 256
    ja, jh = jnp.asarray(a), jnp.asarray(h)
    pallas, vjp = jax.vjp(
        lambda x, y: jpk.ltv_fir_convolve_pallas(x, y, n, True), ja, jh)
    dft = jpk._spectral_convolve_dft(ja, jh, n)
    ta, th = _t(a).requires_grad_(), _t(h).requires_grad_()
    got = K.ltv_fir_convolve(ta, th, n)
    assert _rel_max(got.detach(), pallas) < 2e-4
    assert _rel_max(got.detach(), dft) < 2e-4
    (got * _t(g)).sum().backward()
    bwd = K.ltv_fir_convolve_bwd_plain(_t(g), _t(a), _t(h), n)
    for ref, auto, plain in zip(vjp(jnp.asarray(g)), (ta.grad, th.grad), bwd):
        assert _rel_max(auto, ref) < 2e-4
        assert _rel_max(plain, ref) < 2e-4
    assert K.ltv_fir_convolve_bwd_plain(_t(g), _t(a), _t(h), n,
                                        needs=(False, True))[0] is None


def _filter_cases():
    """The three frequency_filter cases of test_pallas_kernels.py:79-114:
    static Hann, complex all-pass, dynamic window."""
    rng = np.random.default_rng(7)
    b, t, n_frames, n_mag = 2, 4096, 8, 65
    audio = rng.standard_normal((b, t)).astype(np.float32)
    mags = rng.random((b, n_frames, n_mag)).astype(np.float32)
    phase = (rng.random((b, n_frames, n_mag)) - 0.5).astype(np.float32)
    half_width = (20.0 + 50.0 * rng.random((b, n_frames, 1))).astype(np.float32)
    return audio, [
        ("static", dict(magnitudes=mags, hann_windowed=True)),
        ("allpass", dict(magnitudes=np.exp(1j * np.pi * phase).astype(
            np.complex64), hann_windowed=False)),
        ("dynamic", dict(magnitudes=mags, hann_windowed=True,
                         half_width_frames=half_width)),
    ]


@pytest.mark.parametrize("case", ["static", "allpass", "dynamic"])
def test_frequency_filter_matches_jax(case):
    """The port's frequency_filter against the JAX package's (its XLA path),
    output and the gradient of sum(out^2) with respect to the magnitudes,
    2e-4 of max |ref| (the JAX package's Pallas-vs-XLA bound)."""
    audio, cases = _filter_cases()
    kw = dict(cases)[case]
    ref = jfft_filter.frequency_filter(
        jnp.asarray(audio), **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                               else v for k, v in kw.items()})
    tkw = {k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    got = fft_filter.frequency_filter(_t(audio), **tkw)
    assert got.shape == ref.shape == audio.shape
    assert _rel_max(got, ref) < 2e-4
    if case == "allpass":
        return  # complex magnitudes: the gradient cases are the real ones

    def j_loss(m):
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        jkw["magnitudes"] = m
        return jnp.sum(jfft_filter.frequency_filter(jnp.asarray(audio),
                                                    **jkw) ** 2)

    g_ref = jax.grad(j_loss)(jnp.asarray(kw["magnitudes"]))
    m = tkw["magnitudes"].clone().requires_grad_()
    (fft_filter.frequency_filter(_t(audio), **{**tkw, "magnitudes": m}) ** 2
     ).sum().backward()
    assert _rel_max(m.grad, g_ref) < 2e-4


# ------------------------------------------------------ whole synths -----


def _args(mtype):
    return DotDict({
        "data": {"sampling_rate": SR, "block_size": BLOCK,
                 "encoder_out_channels": N_UNIT},
        "model": {"type": mtype, "n_spk": N_SPK, **SIZES[mtype]},
    })


@pytest.fixture(scope="module", params=["Sins", "CombSub"])
def pair(request):
    """The port's model from build_model (seed 0), the JAX model, and JAX
    variables holding the same weights (through the JAX package's
    converter); the port's weight bridge maps them back bit for bit."""
    mtype = request.param
    tm = build_model(_args(mtype), device="cpu", seed=0)
    sd = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
    variables = jconvert.convert_synth_state_dict(sd, num_layers=3)
    back = jax_synth_to_torch(variables)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v)
    jm = JAX_MODELS[mtype](sampling_rate=SR, block_size=BLOCK, n_unit=N_UNIT,
                           n_spk=N_SPK, **SIZES[mtype])
    return mtype, tm, jm, variables


def _inputs(seed, b, f):
    rng = np.random.default_rng(seed)
    units = rng.standard_normal((b, f, N_UNIT)).astype(np.float32)
    f0 = (120 + 200 * rng.random((b, f, 1))).astype(np.float32)
    f0[:, f // 3: f // 3 + 3] = 0.0  # an unvoiced stretch
    volume = rng.random((b, f)).astype(np.float32)
    spk = np.asarray([[1 + i % N_SPK] for i in range(b)], np.int64)
    noise = (rng.random((b, f * BLOCK)) * 2 - 1).astype(np.float32)
    return units, f0, volume, spk, noise


# Both synths carry the control tolerance (1e-4 of max |ref|) through
# their filters, as CombSubFast does. Sins adds what wrapping its oscillator
# argument costs (the JAX XLA bank does not wrap): an unwrapped argument of
# up to 32 pi rounds by ulp(100) / 2 ~ 4e-6, so each sine moves by at most
# that, and the bank by at most 4e-6 sum_k |a_k|, a few times 4e-6 of its
# max |out|. Read: at most 1.4e-5 (Sins) and 1.6e-5 (CombSub) of max |ref|
# over the cases below, the masked item the largest.
TOL = 1e-4


@pytest.mark.parametrize("infer,valid", [(True, None), (False, None),
                                         (True, [24, 17])])
def test_synth_matches_jax(pair, infer, valid):
    """Whole forwards with injected noise, against the JAX model on the
    same weights; with per-item valid_frames, each item's valid prefix."""
    mtype, tm, jm, variables = pair
    units, f0, volume, spk, noise = _inputs(2, 2, 24)
    vf = None if valid is None else jnp.asarray(valid)
    ref, _, _ = jax.jit(lambda v, *a: jm.apply(
        v, *a, infer=infer, noise=jnp.asarray(noise), valid_frames=vf))(
            variables, *(jnp.asarray(a) for a in (units, f0, volume, spk)))
    with torch.no_grad():
        got, _, _ = tm(*(_t(a) for a in (units, f0, volume, spk)), infer=infer,
                       noise=_t(noise),
                       valid_frames=None if valid is None else _t(valid))
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    for i, n in enumerate(valid or [24, 24]):
        r, g = ref[i, :n * BLOCK], got[i, :n * BLOCK]
        assert np.abs(g - r).max() < TOL * np.abs(r).max(), (
            mtype, i, np.abs(g - r).max() / np.abs(r).max())


def test_synth_padding_equals_exact_length(pair):
    """A bucket-padded forward with valid_frames equals the exact-length
    forward on the valid prefix (the masking contract of the bucketed
    synth), within fp32 summation-order noise."""
    _, tm, _, _ = pair
    units, f0, volume, spk, noise = _inputs(3, 1, 20)
    pad = 12
    padded = (np.pad(units, ((0, 0), (0, pad), (0, 0))),
              np.pad(f0, ((0, 0), (0, pad), (0, 0)), mode="edge"),
              np.pad(volume, ((0, 0), (0, pad))), spk,
              np.pad(noise, ((0, 0), (0, pad * BLOCK))))
    with torch.no_grad():
        exact, _, _ = tm(*(_t(a) for a in (units, f0, volume, spk)),
                         noise=_t(noise))
        got, _, _ = tm(*(_t(a) for a in padded[:4]), noise=_t(padded[4]),
                       valid_frames=20)
    exact = exact.numpy()
    got = got.numpy()[:, :exact.shape[1]]
    assert np.abs(got - exact).max() < 1e-5 * np.abs(exact).max()


def test_train_step_matches_jax(pair):
    """One step (infer=False, the RSS loss at two pinned sizes, loss eps
    1e-3) against jax.value_and_grad of the JAX model: the loss to 1e-4
    relative, every parameter gradient to rel < 2e-2 and cos > 1 - 1e-4
    (tests/test_train_parity.py's bounds), and AdamW moved the weights."""
    mtype, tm, jm, variables = pair
    model = build_model(_args(mtype), device="cpu", seed=0)
    state = TrainState(0, model, create_optimizer(model, 5e-4))
    units, f0, volume, spk, noise = _inputs(4, 2, 16)
    rng = np.random.default_rng(5)
    audio = (0.3 * rng.standard_normal(noise.shape)).astype(np.float32)
    batch = dict(units=units, f0=f0, volume=volume, spk_id=spk, audio=audio)
    rss = tlosses.RSSLoss(128, 512, n_scale=2, eps=1e-3)
    idx = (3, 9)
    loss = train_step(state, {k: _t(v) for k, v in batch.items()}, rss,
                      noise=_t(noise), loss_idx=idx)
    grads = {k: p.grad.numpy().astype(np.float64)
             for k, p in model.named_parameters()}
    j_rss = jlosses.RSSLoss(buckets=[rss.buckets[i] for i in idx], eps=1e-3)
    consts = variables["constants"]

    def loss_of(params):
        signal, _, _ = jm.apply(
            {"params": params, "constants": consts},
            *(jnp.asarray(batch[k]) for k in ("units", "f0", "volume",
                                              "spk_id")),
            infer=False, noise=jnp.asarray(noise))
        return j_rss.mss(signal, jnp.asarray(audio))

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_of))(variables["params"])
    assert abs(float(loss) - float(j_loss)) < 1e-4 * abs(float(j_loss))
    ref = jax_synth_to_torch({"params": j_grads, "constants": consts})
    for name, g in grads.items():
        r = ref[name].numpy().astype(np.float64)
        nr = np.linalg.norm(r)
        rel = np.linalg.norm(g - r) / (nr + 1e-12)
        assert rel < 2e-2, (mtype, name, rel)
        if nr > 1e-10:
            cos = float(np.dot(g.ravel(), r.ravel())
                        / (np.linalg.norm(g) * nr + 1e-30))
            assert cos > 1 - 1e-4, (mtype, name, cos)
    moved = [k for k, v in model.state_dict().items()
             if not torch.equal(v, tm.state_dict()[k])]
    assert moved


def test_convert_features_matches_jax(pair):
    """The offline entry point on the CPU: one 40-frame segment (bucket-
    padded to 64 and masked) through convert_features without an enhancer,
    against the JAX package's bucketed synth (make_jitted_synth with
    mask_padding) times its response mask, on the same weights and noise;
    the bound is the synth's (TOL)."""
    mtype, tm, jm, variables = pair
    units, f0, volume, spk, noise = _inputs(6, 1, 40)
    volume[0, 10:14] = 1e-4  # quiet frames for the response mask
    got, sr = convert_features(tm, [(0, units)], f0, volume, spk_id=2,
                               noise_hook=lambda i, shape: noise)
    synth = make_jitted_synth(jm, variables, mask_padding=True)
    ref = synth(units, f0, volume, np.asarray([[2]]), jax.random.key(0),
                noise=noise)[0] * joffline.response_mask(volume[0], -60,
                                                         BLOCK)[0]
    assert sr == SR and got.shape == ref.shape == (40 * BLOCK,)
    assert np.abs(got - ref).max() < TOL * np.abs(ref).max()


def test_train_main_runs_on_cpu(pair, tmp_path):
    """The training entry point with --device cpu on a tiny dataset in the
    AudioDataset layout: two steps, a validation pass and a checkpoint."""
    import yaml

    mtype = pair[0]
    rng = np.random.default_rng(7)
    t = SR
    for split in ("train", "val"):
        for spk in (1, 2):
            root = tmp_path / split
            for sub in ("audio", "units", "f0", "volume"):
                (root / sub / str(spk)).mkdir(parents=True, exist_ok=True)
            n_frames = t // BLOCK + 1
            write_wav(str(root / "audio" / str(spk) / "a.wav"),
                      (0.3 * np.sin(np.arange(t) * 0.05)).astype(np.float32), SR)
            np.save(root / "units" / str(spk) / "a.0.npy",
                    rng.standard_normal((n_frames, N_UNIT)).astype(np.float32))
            np.save(root / "f0" / str(spk) / "a.npy",
                    np.full((n_frames,), 150.0 * spk, np.float32))
            np.save(root / "volume" / str(spk) / "a.npy",
                    np.full((n_frames,), 0.2, np.float32))
    args = _args(mtype)
    args["data"].update(train_path=str(tmp_path / "train"),
                        valid_path=str(tmp_path / "val"), duration=0.5,
                        n_aunit=0)
    args.update(loss={"fft_min": 128, "fft_max": 512, "n_scale": 2},
                env={"expdir": str(tmp_path / "exp")},
                train={"batch_size": 2, "cache_all_data": True,
                       "cache_fp16": False, "epochs": 4, "interval_log": 1,
                       "interval_val": 2, "lr": 1e-3, "weight_decay": 0.0,
                       "seed": 0})
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(dict(args)))
    state, saver = train_main.main(["-c", str(cfg), "--max-steps", "2",
                                    "--device", "cpu"])
    assert isinstance(state.model, type(pair[1])) and saver.global_step == 2
    assert (tmp_path / "exp" / "model_2.pt").is_file()
    assert "Real Time Factor" in (tmp_path / "exp" / "log_info.txt").read_text()
