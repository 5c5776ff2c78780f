"""PyTorch port, the bf16-input forms of the trio kernel (#4/#5) and of the
DFT magnitude (#6) against the JAX package on the CPU: the plain versions
of the forms (`ops/kernels.py`) against `fused_resblocks_inject_pallas`,
`fused_resblocks_pallas` and `_fused_resblocks_fwd_impl(valid=)` in
interpret mode on the same bf16 inputs, the staged and the full-bf16
Generator against JAX's `Generator(fused_resblocks="force")` of the same
form, and the bf16 DFT route of the mel against JAX's
`log_mel_spectrogram(mxu_bf16=True)` on its "mxu" magnitude backend.
tests/test_torch_cuda.py holds the kernels against these plain versions
on the card."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ddsp_svc_tpu.nn.nsf_hifigan import Generator as JGenerator
from ddsp_svc_tpu.ops import pallas_kernels as jpk
from ddsp_svc_tpu.ops import spectral as jspectral
from ddsp_svc_tpu.utils import convert as jconvert
from ddsp_svc_tpu_torch.nn.layers import lecun_init_
from ddsp_svc_tpu_torch.nn.nsf_hifigan import generator_from_h
from ddsp_svc_tpu_torch.ops import kernels as K
from ddsp_svc_tpu_torch.ops import spectral
from ddsp_svc_tpu_torch.ops.windows import hann_window

torch.set_num_threads(2)

# one bf16 ulp: both sides upcast exactly and compute in fp32, so only a
# rounding of the output to bf16 may flip
ULP = dict(rtol=2.0 ** -7, atol=2e-5)
# the Generator's bound: tests/test_nsf_hifigan.py's staged-vs-fp32 bound
REL_RMS = 2e-2
# tests/test_torch_bf16_enhancer.py's geometry: stages of 32, 16, 8, 4, 2
H = {
    "sampling_rate": 16000, "num_mels": 16, "n_fft": 512, "win_size": 512,
    "hop_size": 128, "fmin": 40, "fmax": 8000,
    "upsample_rates": [4, 4, 2, 2, 2], "upsample_kernel_sizes": [8, 8, 4, 4, 4],
    "upsample_initial_channel": 64, "resblock": "1",
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5]] * 3,
}


def _bf16(a):
    """A numpy array rounded to bf16, as (torch bf16, jnp bf16)."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _trio_case(seed, c=16, t=160, s_src=4, ksrc=8, b=2):
    """bf16 x and har, fp32 weights in the JAX layout (n_dil, 2, k, C_in,
    C_out) and the port's (n_dil, 2, C_out, C_in, k)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    har = (rng.standard_normal((b, t * s_src, 1)) * 0.1).astype(np.float32)
    nc_k = (rng.standard_normal((ksrc, 1, c)) * 0.2).astype(np.float32)
    nc_b = (rng.standard_normal(c) * 0.05).astype(np.float32)
    jw, tw, bs = [], [], []
    for k in (3, 7, 11):
        w = (rng.standard_normal((3, 2, k, c, c)) * (2.0 / (k * c)) ** 0.5
             ).astype(np.float32)
        jw.append(jnp.asarray(w))
        tw.append(torch.from_numpy(np.ascontiguousarray(
            w.transpose(0, 1, 4, 3, 2))))
        bs.append((rng.standard_normal((3, 2, c)) * 0.01).astype(np.float32))
    return dict(x=x, har=har, nc_k=nc_k, nc_b=nc_b, jw=jw, tw=tw, bs=bs,
                s_src=s_src)


def _port_args(case):
    return (torch.from_numpy(np.ascontiguousarray(
        case["nc_k"].transpose(2, 1, 0))), torch.from_numpy(case["nc_b"]),
        case["tw"], [torch.from_numpy(b) for b in case["bs"]])


@pytest.mark.parametrize("har_bf16", [False, True], ids=["har-fp32",
                                                         "har-bf16"])
def test_trio_inject_bf16_matches_pallas(har_bf16):
    """fused_resblocks_inject on bf16 x (har fp32 as a staged stage gets
    it, or bf16 as the full-bf16 Generator's) against
    fused_resblocks_inject_pallas(mxu_bf16=False, interpret=True) on the
    same inputs: bf16 out, within one bf16 ulp."""
    case = _trio_case(40)
    x_t, x_j = _bf16(case["x"])
    if har_bf16:
        har_t, har_j = _bf16(case["har"])
    else:
        har_t, har_j = (torch.from_numpy(case["har"]),
                        jnp.asarray(case["har"]))
    ref = jpk.fused_resblocks_inject_pallas(
        x_j, har_j, jnp.asarray(case["nc_k"]), jnp.asarray(case["nc_b"]),
        *case["jw"], *(jnp.asarray(b) for b in case["bs"]), case["s_src"],
        mxu_bf16=False, interpret=True)
    assert ref.dtype == jnp.bfloat16
    nc_w, nc_b, ws, bs = _port_args(case)
    got = K.fused_resblocks_inject_bf16(x_t, har_t, nc_w, nc_b, ws, bs,
                                        case["s_src"])
    assert got.dtype == torch.bfloat16 and got.shape == x_t.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **ULP)


def test_trio_bf16_no_inject_and_valid_match_pallas():
    """The trio alone (fused_resblocks_bf16 against fused_resblocks_pallas)
    and the per-row valid form with the injection (against
    _fused_resblocks_fwd_impl(valid=)) on bf16 x, within one bf16 ulp on
    each row's valid samples; the port's valid form zeroes each row past
    its length."""
    case = _trio_case(41)
    x_t, x_j = _bf16(case["x"])
    jbs = [jnp.asarray(b) for b in case["bs"]]
    nc_w, nc_b, ws, bs = _port_args(case)
    ref = jpk.fused_resblocks_pallas(x_j, *case["jw"], *jbs, mxu_bf16=False,
                                     interpret=True)
    got = K.fused_resblocks_bf16(x_t, ws, bs)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **ULP)
    valid = [150, 77]
    ref = jpk._fused_resblocks_fwd_impl(
        x_j, tuple(case["jw"]), tuple(jbs), (3, 7, 11), (1, 3, 5), None,
        False, True,
        inject=(jnp.asarray(case["har"]), jnp.asarray(case["nc_k"]),
                jnp.asarray(case["nc_b"]), case["s_src"]),
        valid=jnp.asarray(valid))
    got = K.fused_resblocks_inject(x_t, torch.from_numpy(case["har"]), nc_w,
                                   nc_b, ws, bs, case["s_src"], valid=valid)
    got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    for i, n in enumerate(valid):
        # JAX's Generator masks the tail after the kernel; the port's
        # kernel zeroes it itself
        np.testing.assert_allclose(got[i, :n], ref[i, :n], **ULP)
        assert not got[i, n:].any()


def test_trio_bf16_rejects_other_dtypes():
    """The forms' entries take bf16 x only; on the card the wrapper takes
    fp32 or bf16 x (har fp32, or bf16 beside bf16 x) and raises on any
    other (meta tensors stand in for the card's)."""
    x = torch.zeros((1, 40, 16))
    w = [torch.zeros((3, 2, 16, 16, k)) for k in (3, 7, 11)]
    b = [torch.zeros((3, 2, 16))] * 3
    with pytest.raises(TypeError, match="bfloat16"):
        K.fused_resblocks_bf16(x, w, b)
    with pytest.raises(TypeError, match="bfloat16"):
        K.dft_magnitude_bf16(torch.zeros((2, 64)), 64)
    meta = [t.to("meta") for t in w]
    bm = [t.to("meta") for t in b]
    with torch.no_grad():
        with pytest.raises(TypeError, match="expected torch.float32"):
            K.fused_resblocks(torch.empty((1, 40, 16), dtype=torch.float16,
                                          device="meta"), meta, bm)
        with pytest.raises(TypeError, match="expected torch.float32"):
            K.fused_resblocks_inject(
                torch.empty((1, 40, 16), device="meta"),
                torch.empty((1, 160, 1), dtype=torch.bfloat16, device="meta"),
                torch.empty((16, 1, 8), device="meta"),
                torch.empty((16,), device="meta"), meta, bm, 4)
        with pytest.raises(TypeError, match="expected torch.float32"):
            K.dft_magnitude(torch.empty((2, 64), dtype=torch.float16,
                                        device="meta"), 64)


def _jax_generator(**kw):
    return JGenerator(
        sampling_rate=H["sampling_rate"], num_mels=H["num_mels"],
        upsample_rates=tuple(H["upsample_rates"]),
        upsample_kernel_sizes=tuple(H["upsample_kernel_sizes"]),
        upsample_initial_channel=H["upsample_initial_channel"],
        resblock_kernel_sizes=tuple(H["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(tuple(d) for d in
                                      H["resblock_dilation_sizes"]), **kw)


def _rel_rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


@pytest.mark.parametrize("form", ["staged", "full"])
def test_bf16_generator_forms_match_forced_jax(form, monkeypatch):
    """The staged (threshold 16: the C = 32 and 16 stages bf16, their
    trios in the bf16-input form) and the full-bf16 Generator (every trio
    stage, C = 32/16/8, in the bf16-input form, har bf16) against JAX's
    Generator(fused_resblocks="force") of the same form in interpret mode,
    and against the port's fp32 forward, at rel RMS 2e-2; the form's plain
    version ran on each trio stage (one call each, bf16 in and out) and the
    output is not the fp32 one (bf16 ran)."""
    kw, jkw = ({"bf16_min_channels": 16}, {"bf16_min_channels": 16}) \
        if form == "staged" else ({"dtype": torch.bfloat16},
                                  {"dtype": jnp.bfloat16})
    rng = np.random.default_rng(43)
    f = 12
    mel = rng.standard_normal((1, f, H["num_mels"])).astype(np.float32)
    f0 = (150.0 + 100.0 * rng.random((1, f))).astype(np.float32)
    ri = rng.uniform(0, 1, (1, 9)).astype(np.float32)
    ri[:, 0] = 0
    g32 = lecun_init_(generator_from_h(H), torch.Generator().manual_seed(2))
    g16 = generator_from_h(H, **kw)
    g16.load_state_dict(g32.state_dict())
    sd = {k: v.numpy() for k, v in g32.state_dict().items()}
    variables = jconvert.convert_nsf_hifigan_state_dict(sd, H)
    ref = np.asarray(jax.jit(_jax_generator(fused_resblocks="force",
                                            **jkw).apply)(
        variables, *(jnp.asarray(a) for a in (mel, f0, ri))))
    seen = []
    plain = K.resblocks_inject_plain

    def spy(x_up, har, *a, **k):
        seen.append((x_up.shape[-1], x_up.dtype,
                     None if har is None else har.dtype))
        return plain(x_up, har, *a, **k)

    monkeypatch.setattr(K, "resblocks_inject_plain", spy)
    args = [torch.from_numpy(a) for a in (mel, f0, ri)]
    with torch.no_grad():
        y16 = g16(*args)
        y32 = g32(*args).numpy()
    assert y16.dtype == torch.float32 and bool(torch.isfinite(y16).all())
    y16 = y16.numpy()
    assert y16.shape == ref.shape == (1, f * 128)
    bf16_stages = [s for s in seen if s[1] == torch.bfloat16]
    want = [32, 16] if form == "staged" else [32, 16, 8]
    assert [s[0] for s in bf16_stages] == want, seen
    har_dtype = torch.float32 if form == "staged" else torch.bfloat16
    assert all(s[2] == har_dtype for s in bf16_stages), seen
    to_jax, to_fp32 = _rel_rms(y16, ref), _rel_rms(y16, y32)
    assert to_jax < REL_RMS, to_jax
    assert to_fp32 < REL_RMS, to_fp32
    assert to_fp32 > 1e-4, to_fp32


def test_bf16_stage_never_takes_the_fused_stage():
    """A bf16 stage with fused_stage=True runs the trio's bf16-input form,
    never the fused stage (#11 is fp32 only, as JAX's _stage_fusable)."""
    g = generator_from_h(H, fused_stage=True, bf16_min_channels=16)
    assert not g._stage_fusable(64, 4, 8, torch.bfloat16)
    assert g._stage_fusable(64, 4, 8, None)


def test_mel_bf16_route_matches_jax_mxu():
    """The mel's bf16 DFT route (the windowed frames rounded to bf16, the
    plain version of #6's bf16-input form) against JAX's
    log_mel_spectrogram(mxu_bf16=True) on the "mxu" backend (bf16 frames
    and DFT matrices in interpret mode): JAX's own bf16-route bound
    (tests/test_pallas_kernels.py::test_log_mel_mxu_bf16_tracks_fp32), max
    |log-mel diff| < 0.1 and mean < 0.01."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((2, 4096)) * 0.2).astype(np.float32)
    sr, n_fft, hop, win, n_mels, fmin, fmax = (16000, 512, 128, 512, 16,
                                               40.0, 8000.0)
    jspectral.set_mag_backend("mxu")
    try:
        ref = np.asarray(jspectral.log_mel_spectrogram(
            jnp.asarray(x), sr, n_fft, hop, win, n_mels, fmin, fmax,
            mxu_bf16=True))
    finally:
        jspectral.set_mag_backend("auto")
    xp = spectral.mel_reflect_pad(torch.from_numpy(x), win, hop)
    mag = spectral.bf16_frames_magnitude(xp, n_fft, hop, hann_window(win))
    got = spectral._log_mel(mag, sr, n_fft, n_mels, fmin, fmax, 1e-5).numpy()
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    assert float(diff.max()) < 0.1, float(diff.max())
    assert float(diff.mean()) < 0.01, float(diff.mean())
