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
from ddsp_svc_tpu_torch.ops.masking import frame_mask
from ddsp_svc_tpu_torch.ops.windows import sqrt_hann_window
from torch_tmp import tmp_path  # noqa: F401  (removed when each test ends)

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


def _attention_fp32_bound(q, k, v, proj, valid):
    """A first-order bound, evaluated in float64, on the error of any fp32
    evaluation of the FAVOR+ formula, per output element (worst case: every
    rounding adds up). Each feature exp(a) carries a relative error of u
    times the sum of |terms| of its argument a (the d-term projection, the
    norm, the max), which exp turns from absolute into relative; the
    contractions over T keys and m features add (T + m) u times their sums
    of |terms|; out = N / D carries |dN| + |out| |dD| over D. u = 2^-24."""
    u = 2.0 ** -24
    q, k, v, p = (_t(a).double() for a in (q, k, v, proj))
    d, m, t = q.shape[-1], p.shape[0], q.shape[2]
    nrm = d ** -0.25

    def features(x, is_query):
        dd = torch.einsum("bhid,jd->bhij", nrm * x, p)
        dd_abs = torch.einsum("bhid,jd->bhij", (nrm * x).abs(), p.abs())
        diag = (x * x).sum(-1, keepdim=True) * 0.5 * nrm ** 2
        rel = u * (d * (dd_abs + diag) + dd.abs() + diag + 3)
        if is_query:
            mx = dd.amax(-1, keepdim=True)
            return m ** -0.5 * (torch.exp(dd - diag - mx) + 1e-4), rel + u * mx.abs()
        return m ** -0.5 * torch.exp(dd - diag + 1e-4), rel

    (qf, dq), (kf, dk) = features(q, True), features(k, False)
    if valid is not None:
        kf = kf * frame_mask(t, valid, kf.dtype)[:, None, :, None]
    ks = kf.sum(2)
    ctx = torch.einsum("bhtm,bhte->bhme", kf, v)
    d_ctx = torch.einsum("bhtm,bhte->bhme", kf * dk, v.abs())
    ctx_abs = torch.einsum("bhtm,bhte->bhme", kf, v.abs())
    den = torch.einsum("bhnm,bhm->bhn", qf, ks)[..., None]
    out = torch.einsum("bhnm,bhme->bhne", qf, ctx) / den
    g = (t + m) * u
    d_num = (torch.einsum("bhnm,bhme->bhne", qf * dq, ctx.abs())
             + torch.einsum("bhnm,bhme->bhne", qf, d_ctx)
             + g * torch.einsum("bhnm,bhme->bhne", qf, ctx_abs))
    d_den = (torch.einsum("bhnm,bhm->bhn", qf * dq, ks)
             + torch.einsum("bhnm,bhm->bhn", qf, (kf * dk).sum(2)))[..., None]
    d_den = d_den + g * den
    return ((d_num + out.abs() * d_den) / den + u * out.abs()).numpy()


@pytest.mark.parametrize("valid", [None, 27, [40, 13]])
def test_performer_attention_plain_matches_jax(valid):
    """The port's fp32 attention and the JAX package's, each against the
    port's formula evaluated in float64 on the same inputs, within the
    first-order fp32 error bound that float64 evaluation gives for each
    element (_attention_fp32_bound; it reads ~3.7e-4 of max |out| here,
    the errors ~1-3 % of it); and port against JAX within the sum of the
    two. The bound follows the conditioning of this formula: the key
    features exp(a) have no max subtraction, so their fp32 rounding grows
    with |a|, and a fixed 2e-5 of max |ref| sat below what fp32 promises
    for it. A broken formula (no max subtraction or no eps in the query
    features) moves the output by ~0.4 of max |out|. Masked rows past
    valid_frames are meaningless in both and not compared."""
    q, k, v, proj = _attention_inputs(21)
    qf = jpcmer.softmax_kernel(jnp.asarray(q), jnp.asarray(proj), True)
    kf = jpcmer.softmax_kernel(jnp.asarray(k), jnp.asarray(proj), False)
    n = [40, 40] if valid is None else np.broadcast_to(valid, (2,))
    if valid is not None:  # the JAX package's masked XLA branch (pcmer.py)
        from ddsp_svc_tpu.ops.masking import frame_mask as jframe_mask
        kf = kf * jframe_mask(40, jnp.asarray(valid), kf.dtype)[:, None, :, None]
    ref = np.asarray(jpcmer.linear_attention(qf, kf, jnp.asarray(v)))
    got = K.performer_attention(_t(q), _t(k), _t(v), _t(proj), valid).numpy()
    exact = K.performer_attention(*(_t(a).double() for a in (q, k, v, proj)),
                                  valid).numpy()
    bound = _attention_fp32_bound(q, k, v, proj, valid)
    for i in range(2):
        rows = (i, slice(None), slice(0, n[i]))
        b = bound[rows]
        ratios = {name: float((np.abs(x - y)[rows] / b).max())
                  for name, x, y in (("port", got, exact), ("jax", ref, exact),
                                      ("port_vs_jax", got, ref))}
        dev = {name: float(np.abs(x - y)[rows].max()
                           / np.abs(exact[rows]).max())
               for name, x, y in (("port", got, exact), ("jax", ref, exact))}
        assert (ratios["port"] <= 1 and ratios["jax"] <= 1
                and ratios["port_vs_jax"] <= 2), (
            f"row {i}: error over the fp32 bound {ratios} (port and JAX <= 1 "
            f"against float64, port vs JAX <= 2); relative to max |out| "
            f"{dev}, bound {float(b.max() / np.abs(exact[rows]).max()):.2e}; "
            f"{_state()}")


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


class _HalfLength:
    """The half-length real transforms of fft_pow2.cuh in float64, at
    n_fft: bin pairs (k, L - k), L = n/2, k = 0 .. L/2, and the pair's
    second bin (L at k = 0)."""

    def __init__(self, n_fft):
        self.n, self.l = n_fft, n_fft // 2
        self.k = torch.arange(self.l // 2 + 1)
        self.j = torch.where(self.k == 0, 0, self.l - self.k)
        self.bj = torch.where(self.k == 0, self.l, self.j)
        self.w = torch.exp(-2j * np.pi * self.k.double() / n_fft)

    def split(self, x):
        """(X[k], X[L - k]) of rfft(x) (X[0] and X[L] at k = 0) from the
        L-point FFT of z[i] = x[2i] + j x[2i+1]: real_split."""
        k, j, w = self.k, self.j, self.w
        z = torch.fft.fft(torch.complex(x[:, 0::2], x[:, 1::2]))
        e = (z[:, k] + z[:, j].conj()) / 2
        o = (z[:, k] - z[:, j].conj()) / 2j
        return e + w * o, (e - w * o).conj()

    def inverse(self, sk, sj):
        """irfft of the half spectrum (S[k], S[L - k]) (imaginary parts of
        DC and Nyquist dropped): the packing Z'[k] = Se[k] + j So[k]
        (real_pack), one L-point inverse, 1/L."""
        k, j, w = self.k, self.j, self.w
        sk, sj = (torch.where(k == 0, s.real + 0j, s) for s in (sk, sj))
        pe = (sk + sj.conj()) / 2
        po = (sk - sj.conj()) * w.conj() / 2
        zp = torch.zeros((sk.shape[0], self.l), dtype=torch.complex128)
        zp[:, k] = pe + 1j * po
        zp[:, j[1:]] = pe[:, 1:].conj() + 1j * po[:, 1:].conj()
        y = torch.fft.ifft(zp)  # the unscaled inverse / L
        return torch.stack((y.real, y.imag), -1).reshape(sk.shape[0], self.n)


def _combsub_spectral_emulated(tooth, noise, hm, hp, nm, n_fft):
    """combsub_spectral.cu's algorithm, written out in float64: each real
    row as an L = n/2-point complex FFT of its even and odd samples, the
    real split of both spectra at bin pairs (k, L - k), the filtered bins
    (imaginary parts of DC and Nyquist dropped), the packing Z'[k] = Se[k] +
    j So[k] for one L-point inverse, 1/L and the window on the way out."""
    hl = _HalfLength(n_fft)

    def filtered(a, nz, b):
        return (a * torch.polar(torch.exp(hm[:, b]), np.pi * hp[:, b])
                + nz * torch.exp(nm[:, b]) / 128)

    (ak, aj), (nk, nj) = hl.split(tooth), hl.split(noise)
    out = hl.inverse(filtered(ak, nk, hl.k), filtered(aj, nj, hl.bj))
    return out * sqrt_hann_window(n_fft, dtype=torch.float64)


def _combsub_spectral_bwd_emulated(g, tooth, noise, hm, hp, nm, n_fft):
    """combsub_spectral_bwd.cu's algorithm, written out in float64: three
    half-length forwards (g * window, tooth, noise) with the real split at
    the pairs (k, L - k); the per-bin gradients dS = w G, d_hm + j d_hp / pi
    = dS conj(A) conj(H), d_nm = Re(dS conj N) Q; the outputs' half spectra
    n Y, Y = dA / 2 inside and Re dA at DC and Nyquist, dA = dS conj(H) (and
    dS Q for d_noise), which is G conj(H) (and G Q) at every bin; and the
    two packed half-length inverses with their 1/L."""
    hl = _HalfLength(n_fft)
    rows, l = g.shape[0], hl.l
    win = sqrt_hann_window(n_fft, dtype=torch.float64)
    d_ctrl = [torch.zeros((rows, l + 1), dtype=torch.float64)
              for _ in range(3)]
    ys = []
    for (gb, ab, nb), b in zip(zip(hl.split(g * win), hl.split(tooth),
                                   hl.split(noise)), (hl.k, hl.bj)):
        h = torch.polar(torch.exp(hm[:, b]), np.pi * hp[:, b])
        q = torch.exp(nm[:, b]) / 128
        wk = torch.where((b == 0) | (b == l), 1.0, 2.0) / n_fft
        ds = wk * gb
        e = ds * ab.conj() * h.conj()
        for d, v in zip(d_ctrl, (e.real, np.pi * e.imag,
                                 (ds * nb.conj()).real * q)):
            d[:, b] = v
        da = ds * h.conj()
        y = torch.where((b == 0) | (b == l), da.real + 0j, da / 2)
        assert torch.allclose(n_fft * y, torch.where(
            (b == 0) | (b == l), (gb * h.conj()).real + 0j, gb * h.conj()))
        ys.append((gb * h.conj(), gb * q))
    (yak, ynk), (yaj, ynj) = ys
    return (hl.inverse(yak, yaj), hl.inverse(ynk, ynj), *d_ctrl)


@pytest.mark.parametrize("n_fft", [64, 1024, 4096])
def test_combsub_spectral_algorithm_matches_irfft(n_fft):
    """The index algebra of the spectral kernel (two half-length forward
    transforms, the packed Hermitian product, one half-length inverse)
    against the plain chain (rfft, irfft_any) in float64, within 1e-9 of
    max |ref|."""
    rng = np.random.default_rng(n_fft)
    rows, bins = 3, n_fft // 2 + 1
    args = (rng.standard_normal((rows, n_fft)),
            rng.standard_normal((rows, n_fft)),
            rng.standard_normal((rows, bins)) * 0.3,
            rng.standard_normal((rows, bins)),
            rng.standard_normal((rows, bins)) * 0.3 - 3)
    args = [torch.from_numpy(a) for a in args]
    ref = K.combsub_spectral_plain(*args, n_fft)
    got = _combsub_spectral_emulated(*args, n_fft)
    assert ((got - ref).abs().max() / ref.abs().max()).item() < 1e-9


@pytest.mark.parametrize("n_fft", [64, 1024, 4096])
def test_combsub_spectral_bwd_algorithm_matches_plain(n_fft):
    """The index algebra of the adjoint kernel (three half-length forward
    transforms, the per-bin gradients, the Hermitian halving with DC and
    Nyquist real, two packed half-length inverses) against the plain
    adjoint in float64, each gradient within 1e-9 of its max |ref|."""
    rng = np.random.default_rng(n_fft + 1)
    rows, bins = 3, n_fft // 2 + 1
    args = (rng.standard_normal((rows, n_fft)) * 1e-3,
            rng.standard_normal((rows, n_fft)),
            rng.standard_normal((rows, n_fft)),
            rng.standard_normal((rows, bins)) * 0.3,
            rng.standard_normal((rows, bins)),
            rng.standard_normal((rows, bins)) * 0.3 - 3)
    args = [torch.from_numpy(a) for a in args]
    refs = K.combsub_spectral_bwd_plain(*args, n_fft)
    gots = _combsub_spectral_bwd_emulated(*args, n_fft)
    for name, ref, got in zip(("tooth", "noise", "hm", "hp", "nm"), refs,
                              gots):
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        assert err < 1e-9, (name, err)


def test_combsub_window_is_cached():
    """The spectral kernels' window: bit-identical to sqrt_hann_window,
    made once per (n_fft, device)."""
    w = K.combsub_window(1024, torch.device("cpu"))
    assert w.dtype == torch.float32 and torch.equal(w, sqrt_hann_window(1024))
    assert K.combsub_window(1024, "cpu") is w
    assert K.combsub_window(512, "cpu") is not w


def test_attention_lengths():
    """valid_frames as the attention kernel takes them: None, an int or a
    one-value tensor on the host by value (nothing copied to the card); a
    list or (B,) tensor, and a 0-d tensor on the card (the meta device
    stands in for it), as (B,) int32 lengths on the kernel's device."""
    cpu = torch.device("cpu")
    assert K.attention_lengths(None, 3, 40, cpu) == (None, 40)
    assert K.attention_lengths(27, 3, 40, cpu) == (None, 27)
    assert K.attention_lengths(np.int64(5), 3, 40, cpu) == (None, 5)
    assert K.attention_lengths(torch.tensor(7), 3, 40, cpu) == (None, 7)
    for valid in ([4, 0, 50], np.array([4, 0, 50]), torch.tensor([4, 0, 50])):
        lengths, n = K.attention_lengths(valid, 3, 40, cpu)
        assert n == 0 and lengths.dtype == torch.int32
        assert lengths.tolist() == [4, 0, 50]
    lengths, n = K.attention_lengths(torch.tensor(6, device="meta"), 3, 40,
                                     torch.device("meta"))
    assert n == 0 and lengths.shape == (3,) and lengths.device.type == "meta"
    assert lengths.dtype == torch.int32


def test_attention_reads_views_of_one_stride():
    """The attention op reads q, k, v in place when they share strides
    with a unit last stride (the heads split off a (B, T, H * 64)
    projection), and rejects views the kernel cannot read: its CUDA
    implementation's checks (`_attention_checks`), made before any launch,
    so meta tensors stand in for the card's."""
    proj = torch.empty((266, 64), device="meta")
    split = torch.empty((2, 40, 8 * 64), device="meta").reshape(
        2, 40, 8, 64).transpose(1, 2)
    assert K._attention_strides(split, "q", (2, 8, 40, 64),
                                split.device) == (40 * 512, 64, 512)
    assert K._attention_checks(split, split, split, proj) == (
        266, (40 * 512, 64, 512))
    dense = torch.empty((2, 8, 40, 64), device="meta")
    with pytest.raises(ValueError, match="share them"):
        K._attention_checks(dense, split, split, proj)
    odd = torch.empty((2, 8, 40, 66), device="meta")[..., :64]
    with pytest.raises(ValueError, match="not a view"):
        K._attention_checks(odd, odd, odd, proj)
    with pytest.raises(ValueError, match="not a view"):
        K._attention_checks(*(torch.empty((2, 8, 64, 40), device="meta")
                              .transpose(2, 3),) * 3, proj)


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
    """fused_resblocks (har=None) is the fused_resblocks_pallas form; a
    per-row valid length equals an exact-length run on each row's valid
    prefix."""
    rng = np.random.default_rng(31)
    c, t = 16, 200
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    jw, tw, bs = _trio_params(rng, c)
    ref = np.asarray(jpk.resblocks_reference(
        jnp.asarray(x), [jnp.asarray(w) for w in jw],
        [jnp.asarray(b) for b in bs], (3, 7, 11), (1, 3, 5)))
    tws, tbs = [_t(w) for w in tw], [_t(b) for b in bs]
    got = K.fused_resblocks(_t(x), tws, tbs)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)
    masked = K.fused_resblocks_inject(_t(x), None, None, None, tws, tbs, 1,
                                      valid=[150, 77]).numpy()
    for i, n in enumerate((150, 77)):
        exact = np.asarray(jpk.resblocks_reference(
            jnp.asarray(x[i:i + 1, :n]), [jnp.asarray(w) for w in jw],
            [jnp.asarray(b) for b in bs], (3, 7, 11), (1, 3, 5)))[0]
        np.testing.assert_allclose(masked[i, :n], exact, atol=1e-4, rtol=1e-4)
        assert not masked[i, n:].any()


@pytest.mark.parametrize("k", [3, 7, 11])
def test_resblock_chain_plain_matches_jax(k):
    """One chain at C = 16, T = 500 (the JAX kernel test's shape) against
    fused_resblock_chain_pallas in interpret mode (fp32 matrix-unit inputs)
    and resblocks_reference: atol 1e-4, rtol 1e-4, that test's tolerance."""
    rng = np.random.default_rng(12 + k)
    c, t = 16, 500
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    w = (rng.standard_normal((3, 2, k, c, c)) * (2.0 / (k * c)) ** 0.5
         ).astype(np.float32)
    b = (rng.standard_normal((3, 2, c)) * 0.01).astype(np.float32)
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    got = K.fused_resblock_chain(_t(x), _t(w.transpose(0, 1, 4, 3, 2).copy()),
                                 _t(b), k).numpy()
    for ref in (jpk.fused_resblock_chain_pallas(
                    jx, jw, jb, k, tile=256, mxu_bf16=False, interpret=True),
                jpk.resblocks_reference(jx, (jw,), (jb,), (k,), (1, 3, 5))):
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4, rtol=1e-4)


def _dense_from_fragments(frags, c: int):
    """One conv's weights in fragment order, (k, C / 8, M / 16, 2, 32, 4),
    back to a dense (k, M, C) float64 weight as the kernel forms its
    products: each lane's A fragment (a0..a3 at rows g, g+8, g, g+8 and
    columns q, q, q+4, q+4 of the m16 x k8 tile, g = lane // 4, q = lane %
    4), hi plus lo. Checks that hi is tf32 (13 low mantissa bits zero) and
    that lo is the rest."""
    m = max(c, 16)
    assert frags.shape[1:] == (c // 8, m // 16, 2, 32, 4)
    hi, lo = frags[:, :, :, 0], frags[:, :, :, 1]
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert (lo.abs() <= 2.0 ** -11 * hi.abs()).all()
    rows = np.zeros((m // 16, 32, 4, m))
    cols = np.zeros((c // 8, 32, 4, c))
    for lane in range(32):
        for v in range(4):
            for mt in range(m // 16):
                rows[mt, lane, v, mt * 16 + lane // 4 + 8 * (v % 2)] = 1
            for grp in range(c // 8):
                cols[grp, lane, v, grp * 8 + lane % 4 + 4 * (v // 2)] = 1
    return torch.einsum("kgmlv,mlvo,glvi->koi", frags.double().sum(3),
                        torch.from_numpy(rows), torch.from_numpy(cols))


@pytest.mark.parametrize("c,k,d", [(64, 11, 5), (32, 7, 3), (16, 3, 1),
                                   (8, 7, 5)])
def test_mma_fragments_give_the_conv(c, k, d):
    """The tensor-core conv core's weight layout (kernels.mma_fragments), as
    the trio takes it (three chains) and as the one-chain kernel does
    (mma_fragments([w])): one dilated conv recomputed as the kernel forms
    it, a sum over k-steps (tap, 8 input channels) of the fragments' dense
    weight times the input shifted by the tap, against F.conv1d at 1e-6, in
    float64; hi + lo is the fp32 weight exactly."""
    rng = np.random.default_rng(c + k)
    t = 90
    ws = [torch.from_numpy(rng.standard_normal((3, 2, c, c, kk))
                           .astype(np.float32)) for kk in (3, k, 11)]
    w = ws[1][2:]  # the conv2 of the third dilation
    x = torch.from_numpy(rng.standard_normal((c, t)))
    m = max(c, 16)
    pad = (k - 1) // 2 * d
    xp = torch.nn.functional.pad(x, (pad, pad))
    taps = torch.stack([xp[:, tap * d:tap * d + t] for tap in range(k)])
    ref = torch.nn.functional.conv1d(x[None], w[0, 1].double(), padding=pad,
                                     dilation=d)[0]
    trio, one = K.mma_fragments(ws)[1], K.mma_fragments([ws[1]])[0]
    assert torch.equal(trio, one)
    for frags in (trio, one):
        frags = frags.reshape(3, 2, k, c // 8, m // 16, 2, 32, 4)[2, 1]
        got = torch.einsum("koi,kit->ot", _dense_from_fragments(frags, c),
                           taps)
        assert not got[c:].any()  # the rows that pad M to 16
        torch.testing.assert_close(got[:c], ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("u,c", [(1, 16), (2, 8), (4, 32), (8, 16)])
def test_stage_up_fragments_give_the_transposed_conv(u, c):
    """The fused stage's transposed-conv weights in fragment order
    (kernels.mma_fragments of kernels.stage_up_convs, as the wrapper lays
    them out beside the chains'), recomputed phase by phase as the kernel's
    fill forms them: an output column g of phase r = (g + p) mod u, m0 =
    (g + p - r) / u, sums over both halves of the input channels tap 0's
    dense weight times leaky(x_pre)[m0] and tap 1's times [m0 - 1]; against
    F.conv_transpose1d(leaky(x_pre)) at 1e-6, in float64."""
    rng = np.random.default_rng(u + c)
    t_in, k, p = 37, 2 * u, u // 2
    x = torch.from_numpy(rng.standard_normal((2 * c, t_in)))
    up = torch.from_numpy(rng.standard_normal((2 * c, c, k)).astype(np.float32))
    m = max(c, 16)
    ws = [torch.zeros((3, 2, c, c, k)) for k in (3, 7, 11)]
    frags = K.mma_fragments([K.stage_up_convs(up, u), *ws])[0].reshape(
        u, 2, 2, c // 8, m // 16, 2, 32, 4)
    xl = torch.nn.functional.leaky_relu(x, 0.1)
    xp = torch.nn.functional.pad(xl, (1, 1))  # column m of x_pre at m + 1
    ref = torch.nn.functional.conv_transpose1d(xl[None], up.double(),
                                               stride=u, padding=p)[0]
    g = torch.arange(ref.shape[-1])
    r = (g + p) % u
    m0 = (g + p - r) // u
    got = torch.zeros((m, ref.shape[-1]), dtype=torch.float64)
    for ph in range(u):
        cols = r == ph
        for half in range(2):
            dense = _dense_from_fragments(frags[ph, half], c)  # (2, M, C)
            xs = xp[half * c:(half + 1) * c]
            got[:, cols] += dense[0] @ xs[:, m0[cols] + 1]
            got[:, cols] += dense[1] @ xs[:, m0[cols]]
    assert not got[c:].any()  # the rows that pad M to 16
    torch.testing.assert_close(got[:c], ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("b,t_in,s_src,ksrc", [(2, 96, 4, 8), (1, 70, 1, 1)])
def test_stage_plain_matches_jax(b, t_in, s_src, ksrc):
    """stage_plain on the JAX kernel tests' two geometries (C = 8, u = 2;
    the second is the last stage's ksrc = 1 with a tile tail) against
    fused_stage_pallas in interpret mode and stage_reference: atol 2e-4,
    rtol 2e-4, those tests' tolerance."""
    rng = np.random.default_rng(11 + t_in)
    c_in, c, u, k_up = 16, 8, 2, 4
    p = (k_up - u) // 2
    x_pre = rng.standard_normal((b, t_in, c_in)).astype(np.float32)
    har = (rng.standard_normal((b, t_in * u * s_src, 1)) * 0.1
           ).astype(np.float32)
    up_k = (rng.standard_normal((k_up, c_in, c)) * 0.2).astype(np.float32)
    up_b = (rng.standard_normal(c) * 0.05).astype(np.float32)
    nc_k = (rng.standard_normal((ksrc, 1, c)) * 0.2).astype(np.float32)
    nc_b = (rng.standard_normal(c) * 0.05).astype(np.float32)
    jw, tw, bs = _trio_params(rng, c)
    jargs = [jnp.asarray(a) for a in (x_pre, har, up_k, up_b, nc_k, nc_b)]
    jws, jbs = [jnp.asarray(w) for w in jw], [jnp.asarray(x) for x in bs]
    got = K.fused_stage(
        _t(x_pre), _t(har), _t(up_k.transpose(1, 2, 0).copy()), _t(up_b),
        _t(nc_k.transpose(2, 1, 0).copy()), _t(nc_b), [_t(w) for w in tw],
        [_t(x) for x in bs], u, s_src).numpy()
    assert got.shape == (b, t_in * u, c)
    for ref in (jpk.fused_stage_pallas(
                    *jargs, *jws, *jbs, u, p, s_src, tile=128,
                    mxu_bf16=False, interpret=True),
                jpk.stage_reference(*jargs, jws, jbs, (3, 7, 11), (1, 3, 5),
                                    u, p, s_src)):
        np.testing.assert_allclose(got, np.asarray(ref), atol=2e-4, rtol=2e-4)


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


RSS_SIZES = (256, 375, 495, 614, 734, 853, 972, 1092, 1211, 1331, 1450, 1569,
             1689, 1808, 1928, 2047)


def _bluestein_rfft(x, n_fft, chirp, bhat):
    """rfft(x, n_fft) as the dft_magnitude kernel computes it where
    dft_plan's l is not a power of two, from the tables it reads (chirp,
    bhat complex), with torch.fft.fft standing in for its power-of-two FFT
    core: Bluestein over z (for even n the even and odd samples as one
    complex signal), then the real split."""
    l, m = K.dft_plan(n_fft)
    split = 2 * l == n_fft
    z = torch.complex(x[:, 0::2], x[:, 1::2]) if split else x.to(chirp.dtype)
    u = torch.zeros((x.shape[0], m), dtype=chirp.dtype)
    u[:, :l] = z * chirp
    zc = (torch.fft.ifft(torch.fft.fft(u) * bhat) * m)[:, :l] * chirp
    if not split:
        return zc[:, :n_fft // 2 + 1]
    k = torch.arange(l + 1)
    zk, zj = zc[:, k % l], zc[:, (l - k) % l].conj()
    w = torch.polar(torch.ones(l + 1, dtype=x.dtype),
                    -2 * np.pi * k.to(x.dtype) / n_fft)
    return 0.5 * (zk + zj) - 0.5j * w * (zk - zj)


@pytest.mark.parametrize("n_fft", RSS_SIZES + (8191,))
def test_dft_tables_give_rfft(n_fft):
    """The per-n tables that the dft_magnitude wrapper builds and the kernel
    reads (the chirp and FFT_m of the conj-chirp; the FFT core computes its
    twiddles, no table): a Bluestein over exactly those tables equals
    torch.fft.rfft to 1e-9 of max |ref| in float64 (dft_tables64), and
    within 2e-3 absolute (the kernel's tolerance) in fp32 (dft_tables, the
    complex64 casts the kernel reads) on unit-variance frames. This is the
    CPU check of what the kernel reads; the kernel itself runs on the card
    (tests/test_torch_cuda.py)."""
    l, m = K.dft_plan(n_fft)
    if n_fft == 256:  # the one power of two: no tables
        assert (l, m) == (128, 128) and K.dft_tables(256, "cpu") is None
        return
    assert m & (m - 1) == 0 and 2 * l - 1 <= m < 4 * l - 2
    assert l == (n_fft // 2 if n_fft % 2 == 0 else n_fft)
    rng = np.random.default_rng(n_fft)
    x = torch.from_numpy(rng.standard_normal((4, n_fft)))
    ref = torch.fft.rfft(x)
    chirp, bhat = (torch.from_numpy(t) for t in K.dft_tables64(n_fft))
    got = _bluestein_rfft(x, n_fft, chirp, bhat)
    assert ((got - ref).abs().max() / ref.abs().max()).item() < 1e-9
    c32, b32 = K.dft_tables(n_fft, "cpu")
    assert c32.dtype == torch.float32 and c32.shape == (l, 2)
    assert b32.shape == (m, 2)
    got32 = _bluestein_rfft(x.float(), n_fft, torch.view_as_complex(c32),
                            torch.view_as_complex(b32))
    assert (got32.abs() - ref.abs()).abs().max().item() < 2e-3


def test_kernel_build_hash_follows_header_chain(tmp_path, monkeypatch):
    """A library's name hashes its source and every csrc header it reaches
    through quoted includes, so an edit to a header included by another
    header rebuilds every library that depends on it, and only those."""
    from ddsp_svc_tpu_torch.ops import build

    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text('#include <math.h>\n#include "b.cuh"\n')
    (tmp_path / "other.cu").write_text('#include "c.cuh"\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n  # include "c.cuh"\n')
    (tmp_path / "c.cuh").write_text('#pragma once\n#include "b.cuh"\n// v1\n')
    before = build._lib_path("a"), build._lib_path("other")
    assert build._lib_path("a") == before[0]  # stable
    (tmp_path / "c.cuh").write_text('#pragma once\n#include "b.cuh"\n// v2\n')
    after = build._lib_path("a"), build._lib_path("other")
    assert after[0] != before[0] and after[1] != before[1]
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "c.cuh"\n// b2\n')
    assert build._lib_path("a") != after[0]
    assert build._lib_path("other") != after[1]  # c.cuh includes b.cuh
    unrelated = build._lib_path("a")
    (tmp_path / "d.cuh").write_text("// included by no source\n")
    assert build._lib_path("a") == unrelated


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


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", [
    "rad shape", "w dtype", "start strides", "b shape", "amps dtype",
    "amps device", "T != F * block"])
def test_sine_bank_wrappers_check_inputs(case):
    """The harmonic source's (#3) and the oscillator bank's (#8) input
    checks name each fault before any launch (meta tensors stand in
    for the card's; #8's are its op's CUDA implementation's,
    `_oscillator_bank_checks`)."""
    st, w, b = _meta(1, 4, 9), _meta(9), _meta(1)
    phase, amps = _meta(2, 3 * 64), _meta(2, 3, 128)
    calls = {
        "rad shape": (ValueError, "rad has shape",
                      lambda: K.harmonic_source(st, _meta(1, 4, 8), w, b, 64)),
        "w dtype": (TypeError, "w has dtype", lambda: K.harmonic_source(
            st, st, _meta(9, dtype=torch.float64), b, 64)),
        "start strides": (ValueError, "start is not contiguous",
                          lambda: K.harmonic_source(
                              _meta(1, 9, 4).transpose(1, 2), st, w, b, 64)),
        "b shape": (ValueError, "b has shape", lambda: K.harmonic_source(
            st, st, w, _meta(2), 64)),
        "amps dtype": (TypeError, "amplitudes_frames has dtype",
                       lambda: K._oscillator_bank_checks(
                           phase, _meta(2, 3, 128, dtype=torch.float64), 64)),
        "amps device": (ValueError, "amplitudes_frames is on cpu",
                        lambda: K._oscillator_bank_checks(
                            phase, torch.empty((2, 3, 128)), 64)),
        "T != F * block": (ValueError, "T = F \\* block_size",
                           lambda: K._oscillator_bank_checks(phase, amps, 32)),
    }
    err, match, call = calls[case]
    with pytest.raises(err, match=match):
        call()


def test_wrappers_reject_what_the_kernels_do_not_take():
    """Shape checks run before any launch, so they are testable here with
    meta tensors standing in for the card's (those of #1 and #2 in their
    ops' CUDA implementations, whose checks are called directly)."""
    q = torch.empty((1, 2, 8, 32), device="meta")
    with pytest.raises(ValueError, match="dim_head 64"):
        K._attention_checks(q, q, q, torch.empty((266, 32), device="meta"))
    fr = torch.empty((3, 640), device="meta")
    ctl = torch.empty((3, 321), device="meta")
    with pytest.raises(ValueError, match="power-of-two"):
        K._check_combsub(640, 3, fr.device, (
            ("tooth_frames", fr), ("noise_frames", fr), ("hm", ctl),
            ("hp", ctl), ("nm", ctl)))
    with pytest.raises(ValueError, match="power-of-two"):
        K.combsub_spectral_bwd(fr, fr, fr, ctl, ctl, ctl, 640)
    with pytest.raises(ValueError, match="n_fft in"):
        K.dft_magnitude(torch.empty((3, 9000), device="meta"), 9000)
    x = torch.empty((1, 50, 24), device="meta")
    w = [torch.empty((3, 2, 24, 24, k), device="meta") for k in (3, 7, 11)]
    with pytest.raises(ValueError, match="C in"):
        K.fused_resblocks_inject(x, None, None, None, w, w, 1)
    with pytest.raises(ValueError, match="C in"):
        K.fused_resblock_chain(torch.empty((1, 50, 128), device="meta"),
                               torch.empty((3, 2, 128, 128, 3), device="meta"),
                               torch.empty((3, 2, 128), device="meta"), 3)
    x = torch.empty((1, 50, 16), device="meta")
    with pytest.raises(ValueError, match="k in"):
        K.fused_resblock_chain(x, torch.empty((3, 2, 16, 16, 5), device="meta"),
                               torch.empty((3, 2, 16), device="meta"), 5)
    for dils in ((1, 3, 9), (1, 2, 6)):  # the halo; the 28-column row pad
        with pytest.raises(ValueError, match="dilations"):
            K.fused_resblock_chain(
                x, torch.empty((3, 2, 16, 16, 3), device="meta"),
                torch.empty((3, 2, 16), device="meta"), 3, dils)
    ws = [torch.empty((3, 2, 8, 8, k), device="meta") for k in (3, 7, 11)]
    bs = [torch.empty((3, 2, 8), device="meta")] * 3
    har = torch.empty((1, 600, 1), device="meta")
    nc = torch.empty((8, 1, 1), device="meta")
    b8 = torch.empty((8,), device="meta")
    with pytest.raises(ValueError, match="u in"):  # u = 3
        K.fused_stage(x, har, torch.empty((16, 8, 6), device="meta"), b8, nc,
                      b8, ws, bs, 3, 1)
    with pytest.raises(ValueError, match="u in"):  # C = 128
        K.fused_stage(torch.empty((1, 50, 256), device="meta"), har,
                      torch.empty((256, 128, 4), device="meta"),
                      torch.empty((128,), device="meta"), nc, b8, ws, bs, 2, 1)
    with torch.no_grad():
        with pytest.raises(ValueError, match="kernel sizes"):
            K.fused_stage(x, har, torch.empty((16, 8, 4), device="meta"), b8,
                          nc, b8, ws[:2] + ws[:1], bs, 2, 1)
        with pytest.raises(ValueError, match="dilations"):
            K.fused_stage(x, har, torch.empty((16, 8, 4), device="meta"), b8,
                          nc, b8, ws, bs, 2, 1, (1, 2, 6))
