"""PyTorch port, kernels: the plain version of each hand-written kernel
against the JAX package's plain reference of its Pallas kernel
(`tests/test_pallas_kernels.py` holds each Pallas kernel against the same
references), on the CPU. tests/test_torch_cuda.py holds each CUDA kernel
against its plain version on the card."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ddsp_svc_tpu.nn import nsf_hifigan as jnsf
from ddsp_svc_tpu.nn import pcmer as jpcmer
from ddsp_svc_tpu.ops import pallas_kernels as jpk
from ddsp_svc_tpu_torch.nn.nsf_hifigan import _source_phase
from ddsp_svc_tpu_torch.ops import kernels as K

torch.set_num_threads(2)


def _state() -> str:
    return (f"torch threads {torch.get_num_threads()}, fp32 matmul precision "
            f"{torch.get_float32_matmul_precision()}, cpu capability "
            f"{torch.backends.cpu.get_cpu_capability()}")


def _t(a, device="cpu"):
    return torch.from_numpy(np.asarray(a)).to(device)


def _attention_inputs(seed, b=2, h=3, t=40, d=64):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32)
               for _ in range(3))
    proj = jpcmer.gaussian_orthogonal_random_matrix(266, d, seed=seed)
    return q, k, v, proj


def _trio_params(rng, c, ks=(3, 7, 11)):
    """Weights in the JAX layout (n_dil, 2, k, C_in, C_out) and the port's
    (n_dil, 2, C_out, C_in, k)."""
    jw, tw, bs = [], [], []
    for k in ks:
        w = (rng.standard_normal((3, 2, k, c, c)) * (2.0 / (k * c)) ** 0.5
             ).astype(np.float32)
        jw.append(w)
        tw.append(np.ascontiguousarray(w.transpose(0, 1, 4, 3, 2)))
        bs.append((rng.standard_normal((3, 2, c)) * 0.01).astype(np.float32))
    return jw, tw, bs


def _inject_case(seed, c, t, s_src, ksrc):
    rng = np.random.default_rng(seed)
    x_up = rng.standard_normal((2, t, c)).astype(np.float32)
    har = (rng.standard_normal((2, t * s_src, 1)) * 0.1).astype(np.float32)
    nc_k = (rng.standard_normal((ksrc, 1, c)) * 0.2).astype(np.float32)
    nc_b = (rng.standard_normal(c) * 0.05).astype(np.float32)
    jw, tw, bs = _trio_params(rng, c)
    return x_up, har, nc_k, nc_b, jw, tw, bs


@pytest.mark.parametrize("valid", [None, 27, [40, 13]])
def test_performer_attention_plain_matches_jax(valid):
    """2e-5 of max |ref|: the JAX package's kernel-vs-reference tolerance.
    Masked rows past valid_frames are meaningless in both and not compared."""
    q, k, v, proj = _attention_inputs(21)
    qf = jpcmer.softmax_kernel(jnp.asarray(q), jnp.asarray(proj), True)
    kf = jpcmer.softmax_kernel(jnp.asarray(k), jnp.asarray(proj), False)
    n = [40, 40] if valid is None else np.broadcast_to(valid, (2,))
    if valid is not None:  # the JAX package's masked XLA branch (pcmer.py)
        from ddsp_svc_tpu.ops.masking import frame_mask
        kf = kf * frame_mask(40, jnp.asarray(valid), kf.dtype)[:, None, :, None]
    ref = np.asarray(jpcmer.linear_attention(qf, kf, jnp.asarray(v)))
    got = K.performer_attention(_t(q), _t(k), _t(v), _t(proj), valid).numpy()
    exact = K.performer_attention(*(_t(a).double() for a in (q, k, v, proj)),
                                  valid).numpy()
    dev = [float(np.abs(got[i, :, :n[i]] - ref[i, :, :n[i]]).max()
                 / np.abs(ref[i, :, :n[i]]).max()) for i in range(2)]
    dev64 = [float(np.abs(got[i, :, :n[i]] - exact[i, :, :n[i]]).max()
                   / np.abs(exact[i, :, :n[i]]).max()) for i in range(2)]
    assert max(dev) < 2e-5, (
        f"relative deviation per row {dev} (bound 2e-5); the port's fp32 "
        f"against its own float64 run {dev64}; {_state()}")


def test_performer_attention_plain_matches_pallas_reference():
    q, k, v, proj = _attention_inputs(3)
    ref = np.asarray(jpk.performer_attention_reference(
        *(jnp.asarray(a) for a in (q, k, v, proj))))
    got = K.performer_attention_plain(_t(q), _t(k), _t(v), _t(proj)).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-5


@pytest.mark.parametrize("n_fft,rows", [(256, 37), (1024, 5)])
def test_combsub_spectral_plain_matches_jax(n_fft, rows):
    """2e-5 of max |ref|, as the JAX package's kernel test."""
    rng = np.random.default_rng(11)
    bins = n_fft // 2 + 1
    tooth = rng.standard_normal((rows, n_fft)).astype(np.float32)
    noise = rng.standard_normal((rows, n_fft)).astype(np.float32)
    hm = (rng.standard_normal((rows, bins)) * 0.3).astype(np.float32)
    hp = rng.standard_normal((rows, bins)).astype(np.float32)
    nm = (rng.standard_normal((rows, bins)) * 0.3 - 3).astype(np.float32)
    args = (tooth, noise, hm, hp, nm)
    ref = np.asarray(jpk._combsub_spectral_ref(
        *(jnp.asarray(a) for a in args), n_fft))
    got = K.combsub_spectral(*(_t(a) for a in args), n_fft).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-5


@pytest.mark.parametrize("upp", [64, 128])
def test_harmonic_source_plain_matches_jax(upp):
    """The port's _source_phase + plain merge against the JAX package's
    harmonic_source_fused, atol 2e-5 (its Pallas kernel's tolerance)."""
    rng = np.random.default_rng(7)
    b, f, sr = 2, 5, 44100
    f0 = (100 + 500 * rng.random((b, f))).astype(np.float32)
    ri = rng.random((b, 9)).astype(np.float32)
    ri[:, 0] = 0
    w = rng.standard_normal(9).astype(np.float32)
    bias = np.asarray([0.03], np.float32)
    ref = np.asarray(jnsf.harmonic_source_fused(
        jnp.asarray(f0), upp, sr, jnp.asarray(ri), jnp.asarray(w),
        jnp.float32(0.03)))[..., 0]
    start, rad = _source_phase(_t(f0), upp, sr, _t(ri), 8)
    got = K.harmonic_source(start, rad, _t(w), _t(bias), upp).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("c,t,s_src,ksrc", [(16, 640, 4, 8), (8, 512, 1, 1),
                                            (8, 300, 2, 4)])
def test_resblocks_inject_plain_matches_jax(c, t, s_src, ksrc):
    """atol 1e-4, rtol 1e-4: the JAX package's trio kernel tolerance."""
    x_up, har, nc_k, nc_b, jw, tw, bs = _inject_case(30, c, t, s_src, ksrc)
    ref = np.asarray(jpk.resblocks_inject_reference(
        jnp.asarray(x_up), jnp.asarray(har), jnp.asarray(nc_k),
        jnp.asarray(nc_b), [jnp.asarray(w) for w in jw],
        [jnp.asarray(b) for b in bs], (3, 7, 11), (1, 3, 5), s_src))
    got = K.fused_resblocks_inject(
        _t(x_up), _t(har), _t(nc_k.transpose(2, 1, 0).copy()), _t(nc_b),
        [_t(w) for w in tw], [_t(b) for b in bs], s_src).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_resblocks_plain_no_inject_and_valid():
    """har=None is the fused_resblocks_pallas form; a per-row valid length
    equals an exact-length run on each row's valid prefix."""
    rng = np.random.default_rng(31)
    c, t = 16, 200
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    jw, tw, bs = _trio_params(rng, c)
    ref = np.asarray(jpk.resblocks_reference(
        jnp.asarray(x), [jnp.asarray(w) for w in jw],
        [jnp.asarray(b) for b in bs], (3, 7, 11), (1, 3, 5)))
    tws, tbs = [_t(w) for w in tw], [_t(b) for b in bs]
    got = K.fused_resblocks_inject(_t(x), None, None, None, tws, tbs, 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)
    masked = K.fused_resblocks_inject(_t(x), None, None, None, tws, tbs, 1,
                                      valid=[150, 77]).numpy()
    for i, n in enumerate((150, 77)):
        exact = np.asarray(jpk.resblocks_reference(
            jnp.asarray(x[i:i + 1, :n]), [jnp.asarray(w) for w in jw],
            [jnp.asarray(b) for b in bs], (3, 7, 11), (1, 3, 5)))[0]
        np.testing.assert_allclose(masked[i, :n], exact, atol=1e-4, rtol=1e-4)
        assert not masked[i, n:].any()


@pytest.mark.parametrize("n_fft", [375, 1092])
def test_dft_magnitude_plain_matches_jax(n_fft):
    """Against dft_magnitude_pallas in interpret mode at two of the RSS
    loss's non-power-of-two sizes: the magnitude at atol 2e-3 and the
    gradient of sum(log(mag + 1e-7)) (through its custom VJP) at atol 2e-3,
    the JAX package's own kernel tolerances (test_pallas_kernels.py)."""
    import jax

    rng = np.random.default_rng(n_fft)
    frames = rng.standard_normal((20, n_fft)).astype(np.float32)
    ref = np.asarray(jpk.dft_magnitude_pallas(jnp.asarray(frames), n_fft, True))
    x = _t(frames).requires_grad_()
    got = K.dft_magnitude(x, n_fft)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=2e-3, rtol=0)
    torch.log(got + 1e-7).sum().backward()
    ref_g = np.asarray(jax.grad(lambda fr: jnp.sum(jnp.log(
        jpk.dft_magnitude_pallas(fr, n_fft, True) + 1e-7)))(jnp.asarray(frames)))
    np.testing.assert_allclose(x.grad.numpy(), ref_g, atol=2e-3, rtol=0)


@pytest.mark.parametrize("n_fft,rows", [(256, 37), (1024, 5)])
def test_combsub_spectral_bwd_plain_matches_jax(n_fft, rows):
    """The plain adjoint, and autograd through combsub_spectral on the CPU,
    against the Pallas backward kernel in interpret mode: 2e-5 of max |ref|
    per gradient, the JAX package's kernel-vs-reference tolerance."""
    rng = np.random.default_rng(12)
    bins = n_fft // 2 + 1
    g = rng.standard_normal((rows, n_fft)).astype(np.float32)
    args = (rng.standard_normal((rows, n_fft)).astype(np.float32),
            rng.standard_normal((rows, n_fft)).astype(np.float32),
            (rng.standard_normal((rows, bins)) * 0.3).astype(np.float32),
            rng.standard_normal((rows, bins)).astype(np.float32),
            (rng.standard_normal((rows, bins)) * 0.3 - 3).astype(np.float32))
    ref = jpk._combsub_spectral_bwd_impl(
        *(jnp.asarray(a) for a in (g,) + args), n_fft, False, True)
    plain = K.combsub_spectral_bwd(_t(g), *(_t(a) for a in args), n_fft)
    xs = [_t(a).requires_grad_() for a in args]
    (K.combsub_spectral(*xs, n_fft) * _t(g)).sum().backward()
    for name, r, p, x in zip(("tooth", "noise", "hm", "hp", "nm"), ref, plain,
                             xs):
        r = np.asarray(r)
        scale = np.abs(r).max()
        for how, got in (("plain", p.numpy()), ("autograd", x.grad.numpy())):
            err = np.abs(got - r).max() / scale
            assert err < 2e-5, (name, how, err)


def test_wrappers_reject_what_the_kernels_do_not_take():
    """Shape checks run before any launch, so they are testable here with
    meta tensors standing in for the card's."""
    q = torch.empty((1, 2, 8, 32), device="meta")
    with pytest.raises(ValueError, match="dim_head 64"):
        K.performer_attention(q, q, q, torch.empty((266, 32), device="meta"))
    fr = torch.empty((3, 640), device="meta")
    ctl = torch.empty((3, 321), device="meta")
    with pytest.raises(ValueError, match="power-of-two"):
        K.combsub_spectral(fr, fr, ctl, ctl, ctl, 640)
    with pytest.raises(ValueError, match="power-of-two"):
        K.combsub_spectral_bwd(fr, fr, fr, ctl, ctl, ctl, 640)
    with pytest.raises(ValueError, match="n_fft in"):
        K.dft_magnitude(torch.empty((3, 9000), device="meta"), 9000)
    x = torch.empty((1, 50, 24), device="meta")
    w = [torch.empty((3, 2, 24, 24, k), device="meta") for k in (3, 7, 11)]
    with pytest.raises(ValueError, match="C in"):
        K.fused_resblocks_inject(x, None, None, None, w, w, 1)
