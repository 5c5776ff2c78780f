"""PyTorch port, the bf16-operand forms (JAX's `mxu_bf16=True`) against the
JAX package on the CPU: the plain versions of the forms (`ops/kernels.py`,
`mxu_bf16=True`) against JAX's forms in interpret mode on the same seeded
inputs, the conv core (#4, #5, #10, #11) and the attention (#1 and its
split) at rel RMS 1e-3 and max |diff| 2^-7 x max |ref|, each at least 4x
nearer JAX's form than the port's fp32 form is; the spectral chain (#2,
#7), whose DFT matrices the port does not round, against JAX's form at rel
RMS 1e-2 and against JAX's fp32 reference on the same rounded frames at
1e-5; the bf16 CombSubFast and a fused_mxu_bf16 Generator against JAX's
forced forms; the routes that reach the forms; the layout of the conv
core's bf16 weight fragments. tests/test_torch_cuda.py holds the kernels
against these plain versions on the card."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ddsp_svc_tpu.models.synths import CombSubFast as JCombSubFast
from ddsp_svc_tpu.nn import pcmer as jpcmer
from ddsp_svc_tpu.nn.nsf_hifigan import Generator as JGenerator
from ddsp_svc_tpu.ops import pallas_kernels as jpk
from ddsp_svc_tpu.utils import convert as jconvert
from ddsp_svc_tpu_torch.models import synths as tsynths
from ddsp_svc_tpu_torch.models.synths import CombSubFast
from ddsp_svc_tpu_torch.nn import pcmer as tpcmer
from ddsp_svc_tpu_torch.nn import nsf_hifigan as tnsf
from ddsp_svc_tpu_torch.nn.layers import lecun_init_
from ddsp_svc_tpu_torch.nn.nsf_hifigan import generator_from_h
from ddsp_svc_tpu_torch.ops import kernels as K
from test_torch_bf16_forms import H, _bf16, _port_args, _trio_case

torch.set_num_threads(2)

# the conv core and #1: the same rounding points as JAX's forms, so only
# the order of fp32 sums (and a bf16 rounding it flips) differs
REL_RMS, MAX_REL = 1e-3, 2.0 ** -7
# the fp32 form's distance to JAX's form over the bf16 form's, at least
LOSES_BY = 4.0
# #2 / #7: JAX also rounds its DFT matrices, the port does not
SPECTRAL_REL_RMS = 1e-2
# the slice: tests/test_bf16.py's bf16 bound, and measurably not fp32
SLICE_REL_RMS, OFF_FP32 = 5e-2, 1e-3


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _holds(got, fp32, ref):
    """The bf16 form's plain version at REL_RMS / MAX_REL of JAX's form,
    and LOSES_BY times nearer it than the fp32 form. Returns readings."""
    got, fp32, ref = _np(got), _np(fp32), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    form, plain32 = _rel_rms(got, ref), _rel_rms(fp32, ref)
    worst = float(np.abs(got - ref).max() / np.abs(ref).max())
    readings = dict(form=form, fp32_form=plain32, max=worst)
    assert form <= REL_RMS and worst <= MAX_REL, readings
    assert plain32 >= LOSES_BY * form, readings
    return readings


# ------------------------------------------------------------ conv core ---


def _dense_from_bf16_fragments(frags, c: int):
    """One conv's weights in the bf16 fragment order (k, G, M / 16, 32, 8)
    back to a dense (k, M, C) float64 weight as mma.m16n8k16 reads them:
    lane l's A registers (two bf16 each, the low half first) hold rows g,
    g + 8, g, g + 8 and MMA columns (2q, 2q + 1), (2q, 2q + 1), (2q + 8,
    2q + 9), (2q + 8, 2q + 9) (g = l // 4, q = l % 4, PTX's layout), and
    the core's B loads put input channel q + 4 (j % 2) + 8 (j // 8) of the
    k-step's 16 at MMA column j = 2q + (j % 2) + 8 (j // 8)."""
    m, groups = max(c, 16), max(c // 16, 1)
    assert frags.shape[1:] == (groups, m // 16, 32, 8)
    dense = np.zeros((frags.shape[0], m, 16 * groups))
    f = frags.double().numpy()
    for lane in range(32):
        g, q = lane // 4, lane % 4
        for e in range(8):
            reg, half = e // 2, e % 2
            row = g + 8 * (reg % 2)
            col = 2 * q + half + 8 * (reg // 2)
            ch = (col % 8) // 2 + 4 * (col % 2) + 8 * (col // 8)
            for grp in range(groups):
                for mt in range(m // 16):
                    dense[:, mt * 16 + row, grp * 16 + ch] = \
                        f[:, grp, mt, lane, e]
    assert not dense[:, :, c:].any()  # the zero channels that pad K to 16
    return torch.from_numpy(dense[:, :, :c])


@pytest.mark.parametrize("c,k,d", [(64, 11, 5), (16, 3, 1), (8, 7, 5)])
def test_mma_fragments_bf16_give_the_conv(c, k, d):
    """The conv core's bf16 weight layout (kernels.mma_fragments_bf16), as
    the trio takes it and as one chain does: one dilated conv recomputed
    from PTX's m16n8k16 fragment layout and the core's K order, against
    F.conv1d with the bf16-rounded weights at 1e-6, in float64; the rows
    that pad M to 16 are zero."""
    rng = np.random.default_rng(c + k)
    t = 90
    ws = [torch.from_numpy(rng.standard_normal((3, 2, c, c, kk))
                           .astype(np.float32)) for kk in (3, k, 11)]
    w = ws[1][2:]  # the conv2 of the third dilation
    x = torch.from_numpy(rng.standard_normal((c, t)))
    m, groups = max(c, 16), max(c // 16, 1)
    pad = (k - 1) // 2 * d
    xp = torch.nn.functional.pad(x, (pad, pad))
    taps = torch.stack([xp[:, tap * d:tap * d + t] for tap in range(k)])
    ref = torch.nn.functional.conv1d(
        x[None], K.round_bf16(w[0, 1]).double(), padding=pad, dilation=d)[0]
    trio, one = K.mma_fragments_bf16(ws)[1], K.mma_fragments_bf16([ws[1]])[0]
    assert trio.dtype == torch.bfloat16 and torch.equal(trio, one)
    assert trio.numel() * 2 * 4 == K.mma_fragments([ws[1]])[0].numel() * 4 \
        * (2 if c == 8 else 1)  # a quarter of the tf32 bytes (C = 8: half)
    for frags in (trio, one):
        frags = frags.reshape(3, 2, k, groups, m // 16, 32, 8)[2, 1]
        got = torch.einsum("koi,kit->ot", _dense_from_bf16_fragments(frags, c),
                           taps)
        assert not got[c:].any()
        torch.testing.assert_close(got[:c], ref, atol=1e-6, rtol=1e-6)


def _jax_trio(case, x_j, har_j, mxu: bool, valid=None, inject=True):
    jbs = tuple(jnp.asarray(b) for b in case["bs"])
    if valid is not None:
        return jpk._fused_resblocks_fwd_impl(
            x_j, tuple(case["jw"]), jbs, (3, 7, 11), (1, 3, 5), None, mxu,
            True, inject=(har_j, jnp.asarray(case["nc_k"]),
                          jnp.asarray(case["nc_b"]), case["s_src"]),
            valid=jnp.asarray(valid))
    if not inject:
        return jpk.fused_resblocks_pallas(x_j, *case["jw"], *jbs,
                                          mxu_bf16=mxu, interpret=True)
    return jpk.fused_resblocks_inject_pallas(
        x_j, har_j, jnp.asarray(case["nc_k"]), jnp.asarray(case["nc_b"]),
        *case["jw"], *jbs, case["s_src"], mxu_bf16=mxu, interpret=True)


@pytest.mark.parametrize("x_dtype,har_dtype", [
    ("fp32", "fp32"), ("bf16", "fp32"), ("bf16", "bf16")])
def test_trio_inject_mxu_matches_pallas(x_dtype, har_dtype):
    """#4's bf16-operand form (fused_resblocks_inject(mxu_bf16=True)'s
    plain version) against fused_resblocks_inject_pallas(mxu_bf16=True,
    interpret=True) on the same inputs: an fp32 stage, and a bf16 stage with
    fp32 har (staged) and with bf16 har (full bf16)."""
    case = _trio_case(50)
    nc_w, nc_b, ws, bs = _port_args(case)
    if x_dtype == "bf16":
        x_t, x_j = _bf16(case["x"])
    else:
        x_t, x_j = torch.from_numpy(case["x"]), jnp.asarray(case["x"])
    if har_dtype == "bf16":
        har_t, har_j = _bf16(case["har"])
    else:
        har_t, har_j = torch.from_numpy(case["har"]), jnp.asarray(case["har"])
    ref = _jax_trio(case, x_j, har_j, True)
    got = K.fused_resblocks_inject(x_t, har_t, nc_w, nc_b, ws, bs,
                                   case["s_src"], mxu_bf16=True)
    fp32 = K.fused_resblocks_inject(x_t, har_t, nc_w, nc_b, ws, bs,
                                    case["s_src"])
    assert got.dtype == x_t.dtype and got.shape == x_t.shape
    _holds(got, fp32, ref)


@pytest.mark.parametrize("valid", [None, [150, 77]], ids=["whole", "valid"])
def test_trio_mxu_no_inject_and_valid_match_pallas(valid):
    """#5's bf16-operand form (the trio alone) against
    fused_resblocks_pallas(mxu_bf16=True), and the per-row valid form with
    the injection against _fused_resblocks_fwd_impl(valid=, mxu_bf16=True),
    each row's valid samples only (the port zeroes the tail itself)."""
    case = _trio_case(51)
    nc_w, nc_b, ws, bs = _port_args(case)
    x_t, x_j = torch.from_numpy(case["x"]), jnp.asarray(case["x"])
    if valid is None:
        ref = _jax_trio(case, x_j, None, True, inject=False)
        got = K.fused_resblocks(x_t, ws, bs, mxu_bf16=True)
        fp32 = K.fused_resblocks(x_t, ws, bs)
        _holds(got, fp32, ref)
        return
    har_t, har_j = torch.from_numpy(case["har"]), jnp.asarray(case["har"])
    ref = _np(_jax_trio(case, x_j, har_j, True, valid=valid))
    got = _np(K.fused_resblocks_inject(x_t, har_t, nc_w, nc_b, ws, bs,
                                       case["s_src"], valid=valid,
                                       mxu_bf16=True))
    fp32 = _np(K.fused_resblocks_inject(x_t, har_t, nc_w, nc_b, ws, bs,
                                        case["s_src"], valid=valid))
    rows = [np.s_[i, :n] for i, n in enumerate(valid)]
    _holds(np.concatenate([got[r] for r in rows]),
           np.concatenate([fp32[r] for r in rows]),
           np.concatenate([ref[r] for r in rows]))
    for i, n in enumerate(valid):
        assert not got[i, n:].any()


def test_stage_mxu_matches_pallas():
    """#11's bf16-operand form (fused_stage(mxu_bf16=True)'s plain version:
    the transposed conv fp32, the trio's convs on bf16 operands) at u = 4
    against fused_stage_pallas(mxu_bf16=True, interpret=True)."""
    rng = np.random.default_rng(52)
    c, u, t_in, s_src = 16, 4, 40, 2
    k = 2 * u
    t_out = t_in * u
    ksrc = 2 * s_src
    x = rng.standard_normal((2, t_in, 2 * c)).astype(np.float32)
    har = (rng.standard_normal((2, t_out * s_src, 1)) * 0.1).astype(np.float32)
    # the JAX layout (k, C_in, C); the port's (C_in, C, k)
    up = (rng.standard_normal((k, 2 * c, c)) * (1.0 / (2 * c * k)) ** 0.5
          ).astype(np.float32)
    up_b = (rng.standard_normal(c) * 0.05).astype(np.float32)
    nc_k = (rng.standard_normal((ksrc, 1, c)) * 0.2).astype(np.float32)
    nc_b = (rng.standard_normal(c) * 0.05).astype(np.float32)
    jw, tw, bs = [], [], []
    for kk in (3, 7, 11):
        w = (rng.standard_normal((3, 2, kk, c, c)) * (2.0 / (kk * c)) ** 0.5
             ).astype(np.float32)
        jw.append(jnp.asarray(w))
        tw.append(torch.from_numpy(np.ascontiguousarray(
            w.transpose(0, 1, 4, 3, 2))))
        bs.append((rng.standard_normal((3, 2, c)) * 0.01).astype(np.float32))
    ref = jpk.fused_stage_pallas(
        jnp.asarray(x), jnp.asarray(har), jnp.asarray(up), jnp.asarray(up_b),
        jnp.asarray(nc_k), jnp.asarray(nc_b), *jw,
        *(jnp.asarray(b) for b in bs), u, (k - u) // 2, s_src,
        mxu_bf16=True, interpret=True)
    args = (torch.from_numpy(x), torch.from_numpy(har),
            torch.from_numpy(np.ascontiguousarray(up.transpose(1, 2, 0))),
            torch.from_numpy(up_b),
            torch.from_numpy(np.ascontiguousarray(nc_k.transpose(2, 1, 0))),
            torch.from_numpy(nc_b), tw, [torch.from_numpy(b) for b in bs],
            u, s_src)
    got = K.fused_stage(*args, mxu_bf16=True)
    fp32 = K.fused_stage(*args)
    assert got.shape == (2, t_out, c)
    _holds(got, fp32, ref)


def test_chain_mxu_matches_pallas():
    """#10's bf16-operand form (its JAX default) against
    fused_resblock_chain_pallas(mxu_bf16=True, interpret=True), k = 7."""
    case = _trio_case(53)
    x_t, x_j = torch.from_numpy(case["x"]), jnp.asarray(case["x"])
    ref = jpk.fused_resblock_chain_pallas(
        x_j, case["jw"][1], jnp.asarray(case["bs"][1]), 7, mxu_bf16=True,
        interpret=True)
    b = torch.from_numpy(case["bs"][1])
    got = K.fused_resblock_chain(x_t, case["tw"][1], b, 7, mxu_bf16=True)
    fp32 = K.fused_resblock_chain(x_t, case["tw"][1], b, 7)
    _holds(got, fp32, ref)


# ------------------------------------------------------------ attention ---


def _attention_case(seed, t, masked):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((2, 2, t, 64)).astype(np.float32)
               for _ in range(3))
    proj = jpcmer.gaussian_orthogonal_random_matrix(266, 64, seed)
    valid = np.asarray([t - 37, t // 2], np.int32) if masked else None
    return q, k, v, proj, valid


@pytest.mark.parametrize("t,masked", [(128, False), (128, True),
                                      (256, False), (256, True)])
def test_attention_mxu_matches_pallas(t, masked):
    """#1's bf16-operand form (performer_attention(mxu_bf16=True)'s plain
    version) against performer_attention_pallas(mxu_bf16=True,
    interpret=True) at B = 2, H = 2, d = 64, masked per row and not (the
    valid rows only); the form takes bf16 q, k, v as the PCmer gives them
    and gives the same on their fp32 upcast."""
    q, k, v, proj, valid = _attention_case(60 + t, t, masked)
    ref = _np(jpk.performer_attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v, proj)), mxu_bf16=True,
        interpret=True, valid_frames=None if valid is None
        else jnp.asarray(valid)))
    tq, tk, tv, tp = (torch.from_numpy(a) for a in (q, k, v, proj))
    vf = None if valid is None else torch.from_numpy(valid)
    got = K.performer_attention(tq, tk, tv, tp, vf, mxu_bf16=True)
    assert got.dtype == torch.float32
    fp32 = K.performer_attention(tq, tk, tv, tp, vf)
    keep = (np.arange(t)[None, None, :, None] < (
        t if valid is None else valid[:, None, None, None]))
    keep = np.broadcast_to(keep, ref.shape)
    _holds(_np(got)[keep], _np(fp32)[keep], ref[keep])
    qb, kb, vb = (x.to(torch.bfloat16) for x in (tq, tk, tv))
    torch.testing.assert_close(
        K.performer_attention(qb, kb, vb, tp, vf, mxu_bf16=True),
        K.performer_attention(qb.float(), kb.float(), vb.float(), tp, vf,
                              mxu_bf16=True), atol=0, rtol=0)


def test_attention_mxu_split_matches_single():
    """The split's bf16-operand form: moments over two key shards (fp32
    sums), all-reduced, then the apply (rounding them), against #1's form
    in one call (1e-5 x max|ref|: only the order of fp32 sums differs) and
    against JAX's form at the form's bounds."""
    t = 256
    q, k, v, proj, valid = _attention_case(70, t, True)
    tq, tk, tv, tp = (torch.from_numpy(a).to(torch.bfloat16) if i < 3
                      else torch.from_numpy(a)
                      for i, a in enumerate((q, k, v, proj)))
    vl = torch.from_numpy(valid)
    parts = [K.performer_attention_moments(tk, tv, tp, lo, torch.minimum(
        vl, torch.tensor(hi)), mxu_bf16=True) for lo, hi in ((0, 100),
                                                              (100, t))]
    ctx = parts[0][0] + parts[1][0]
    ksum = parts[0][1] + parts[1][1]
    got = K.performer_attention_apply(tq, tp, ctx, ksum, mxu_bf16=True)
    single = K.performer_attention(tq, tk, tv, tp, vl, mxu_bf16=True)
    scale = float(single.abs().max())
    assert float((got - single).abs().max()) <= 1e-5 * scale
    ref = _np(jpk.performer_attention_pallas(
        *(jnp.asarray(a.float().numpy()) for a in (tq, tk, tv)),
        jnp.asarray(proj), mxu_bf16=True, interpret=True,
        valid_frames=jnp.asarray(valid)))
    fp32 = K.performer_attention(tq.float(), tk.float(), tv.float(), tp, vl)
    keep = np.broadcast_to(np.arange(t)[None, None, :, None]
                           < valid[:, None, None, None], ref.shape)
    _holds(_np(got)[keep], _np(fp32)[keep], ref[keep])


def test_bf16_training_attention_matches_jax_xla_route():
    """The bf16 training route (SelfAttention(compute_dtype=bf16) with
    infer=False: the plain softmax_kernel, projection.to(bf16), as JAX's
    XLA route's projection.astype(bf16)) against JAX's softmax_kernel +
    linear_attention on the same bf16 q, k, v: within bf16 noise (1e-2 rel
    RMS; the two round their bf16 einsums at other places, 8.0e-3 read),
    and nearer JAX's than the same route with the projection kept fp32
    (1.4e-2 read)."""
    t = 128
    q, k, v, proj, _ = _attention_case(71, t, False)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
                  for a in (tq, tk, tv))
    ref = jpcmer.linear_attention(
        jpcmer.softmax_kernel(jq, jnp.asarray(proj), is_query=True),
        jpcmer.softmax_kernel(jk, jnp.asarray(proj), is_query=False), jv)
    got = K.performer_attention_plain(tq, tk, tv, torch.from_numpy(proj))
    assert got.dtype == torch.bfloat16
    fp32_proj = tpcmer.linear_attention(
        *(tpcmer.softmax_kernel(x.float(), torch.from_numpy(proj), iq)
          .to(torch.bfloat16) for x, iq in ((tq, True), (tk, False))), tv)
    readings = dict(route=_rel_rms(_np(got), _np(ref)),
                    fp32_projection=_rel_rms(_np(fp32_proj), _np(ref)))
    assert readings["route"] < 1e-2, readings
    assert readings["route"] < readings["fp32_projection"], readings


# ------------------------------------------------------- spectral chain ---


def _spectral_case(seed, n_fft, rows=64):
    rng = np.random.default_rng(seed)
    bins = n_fft // 2 + 1
    win = np.sqrt(0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft))
    tooth = (rng.standard_normal((rows, n_fft)) * win).astype(np.float32)
    noise = (rng.uniform(-1, 1, (rows, n_fft)) * win).astype(np.float32)
    hm = (rng.standard_normal((rows, bins)) * 0.5 - 1).astype(np.float32)
    hp = rng.uniform(-1, 1, (rows, bins)).astype(np.float32)
    nm = (rng.standard_normal((rows, bins)) * 0.5).astype(np.float32)
    g = (rng.standard_normal((rows, n_fft)) * 1e-3).astype(np.float32)
    return tooth, noise, hm, hp, nm, g, win.astype(np.float32)


@pytest.mark.parametrize("n_fft", [128, 512])
def test_spectral_mxu_matches_pallas(n_fft):
    """#2's bf16-operand form (the frames rounded to bf16) against JAX's
    forced form combsub_spectral_pallas(mxu_bf16=True, interpret=True) at
    rel RMS 1e-2 (JAX also rounds its DFT matrices and the filtered
    spectrum; 2.5e-3 read, the fp32 form 3.0e-3), and against JAX's fp32
    _combsub_spectral_ref on the same rounded frames at 1e-5 (~2e-7 read),
    where the fp32 form reads ~1.7e-3."""
    tooth, noise, hm, hp, nm, _, _ = _spectral_case(80 + n_fft, n_fft)
    j = [jnp.asarray(a) for a in (tooth, noise, hm, hp, nm)]
    t = [torch.from_numpy(a) for a in (tooth, noise, hm, hp, nm)]
    got = _np(K.combsub_spectral(*t, n_fft, mxu_bf16=True))
    fp32 = _np(K.combsub_spectral(*t, n_fft))
    forced = _np(jpk.combsub_spectral_pallas(*j, n_fft, True, True))
    assert _rel_rms(got, forced) <= SPECTRAL_REL_RMS
    rounded = [jnp.asarray(K.round_bf16(x).numpy()) for x in t[:2]]
    ref = _np(jpk._combsub_spectral_ref(*rounded, *j[2:], n_fft))
    readings = dict(form=_rel_rms(got, ref), fp32_form=_rel_rms(fp32, ref))
    assert readings["form"] <= 1e-5, readings
    assert readings["fp32_form"] > 100 * readings["form"], readings


@pytest.mark.parametrize("n_fft", [128, 512])
def test_spectral_bwd_mxu_matches_pallas(n_fft):
    """#7's bf16-operand form (combsub_spectral_bwd_plain(mxu_bf16=True):
    g * window and the frames rounded) against jax.vjp of JAX's forced form
    at rel RMS 1e-2 for each gradient, and equal, within 1e-5 rel RMS, to
    the fp32 adjoint (jax.vjp of _combsub_spectral_ref) on the rounded
    frames and a cotangent whose product with the window is the rounded g *
    window."""
    tooth, noise, hm, hp, nm, g, win = _spectral_case(90 + n_fft, n_fft)
    j = [jnp.asarray(a) for a in (tooth, noise, hm, hp, nm)]
    t = [torch.from_numpy(a) for a in (tooth, noise, hm, hp, nm)]
    got = K.combsub_spectral_bwd(torch.from_numpy(g), *t, n_fft,
                                 mxu_bf16=True)
    _, vjp = jax.vjp(lambda *a: jpk.combsub_spectral_pallas(
        *a, n_fft, True, True), *j)
    forced = vjp(jnp.asarray(g))
    for name, a, b in zip(("tooth", "noise", "hm", "hp", "nm"), got, forced):
        assert _rel_rms(_np(a), _np(b)) <= SPECTRAL_REL_RMS, name
    gw = K.round_bf16(torch.from_numpy(g * win)).numpy()
    g_eq = np.where(win > 0, gw / np.where(win > 0, win, 1), 0.0)
    rounded = [jnp.asarray(K.round_bf16(x).numpy()) for x in t[:2]]
    _, vjp = jax.vjp(lambda *a: jpk._combsub_spectral_ref(*a, n_fft),
                     *rounded, *j[2:])
    for name, a, b in zip(("tooth", "noise", "hm", "hp", "nm"), got,
                          vjp(jnp.asarray(g_eq.astype(np.float32)))):
        assert _rel_rms(_np(a), _np(b)) <= 1e-5, name


# ---------------------------------------------------------------- slice ---

SR, BLOCK, N_UNIT, N_SPK, FRAMES = 16000, 256, 16, 2, 128


def test_bf16_combsubfast_matches_forced_jax():
    """A model.bf16 CombSubFast at inference (#1's and #2's bf16-operand
    forms, plain versions) against JAX's CombSubFast(bf16=True,
    fused_spectral="force", fused_attention="force") (its Pallas forms in
    interpret mode) on the same weights and noise, at tests/test_bf16.py's
    bound, and measurably off the fp32 forward."""
    tm = lecun_init_(CombSubFast(SR, BLOCK, n_unit=N_UNIT, n_spk=N_SPK),
                     torch.Generator().manual_seed(0))
    t16 = CombSubFast(SR, BLOCK, n_unit=N_UNIT, n_spk=N_SPK, bf16=True)
    t16.load_state_dict(tm.state_dict())
    sd = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
    variables = jconvert.convert_synth_state_dict(sd, num_layers=3)
    rng = np.random.default_rng(100)
    units = rng.standard_normal((1, FRAMES, N_UNIT)).astype(np.float32)
    f0 = (110.0 + 330.0 * rng.random((1, FRAMES, 1))).astype(np.float32)
    volume = rng.random((1, FRAMES)).astype(np.float32)
    spk = np.ones((1, 1), np.int64)
    noise = (rng.random((1, FRAMES * BLOCK)) * 2 - 1).astype(np.float32)
    jm = JCombSubFast(sampling_rate=SR, block_size=BLOCK, n_unit=N_UNIT,
                      n_spk=N_SPK, bf16=True, fused_spectral="force",
                      fused_attention="force")
    ref = np.asarray(jax.jit(lambda v, *a: jm.apply(
        v, *a, infer=True, noise=jnp.asarray(noise))[0])(
            variables, *(jnp.asarray(a) for a in (units, f0, volume, spk))))
    args = [torch.from_numpy(a) for a in (units, f0, volume, spk)]
    with torch.no_grad():
        got = t16(*args, infer=True, noise=torch.from_numpy(noise))[0]
        got32 = tm(*args, infer=True, noise=torch.from_numpy(noise))[0]
    readings = dict(to_jax=_rel_rms(_np(got), ref),
                    to_fp32=_rel_rms(_np(got), _np(got32)))
    assert np.isfinite(_np(got)).all()
    assert readings["to_jax"] < SLICE_REL_RMS, readings
    assert readings["to_fp32"] > OFF_FP32, readings


def _jax_generator(**kw):
    return JGenerator(
        sampling_rate=H["sampling_rate"], num_mels=H["num_mels"],
        upsample_rates=tuple(H["upsample_rates"]),
        upsample_kernel_sizes=tuple(H["upsample_kernel_sizes"]),
        upsample_initial_channel=H["upsample_initial_channel"],
        resblock_kernel_sizes=tuple(H["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(tuple(d) for d in
                                      H["resblock_dilation_sizes"]), **kw)


def test_mxu_generator_matches_forced_jax(monkeypatch):
    """A staged (threshold 16) fused_mxu_bf16 Generator against JAX's
    Generator(fused_resblocks="force", fused_mxu_bf16=True) of the same
    form: the trio of each narrow stage (C = 32 and 16 bf16, 8 fp32) on its
    bf16-operand form's plain version, at tests/test_bf16.py's bound and
    measurably off the fp32 forward."""
    rng = np.random.default_rng(101)
    f = 12
    mel = rng.standard_normal((1, f, H["num_mels"])).astype(np.float32)
    f0 = (150.0 + 100.0 * rng.random((1, f))).astype(np.float32)
    ri = rng.uniform(0, 1, (1, 9)).astype(np.float32)
    ri[:, 0] = 0
    g32 = lecun_init_(generator_from_h(H), torch.Generator().manual_seed(3))
    gm = generator_from_h(H, bf16_min_channels=16, fused_mxu_bf16=True)
    gm.load_state_dict(g32.state_dict())
    sd = {k: v.numpy() for k, v in g32.state_dict().items()}
    variables = jconvert.convert_nsf_hifigan_state_dict(sd, H)
    ref = np.asarray(jax.jit(_jax_generator(
        fused_resblocks="force", fused_mxu_bf16=True,
        bf16_min_channels=16).apply)(
            variables, *(jnp.asarray(a) for a in (mel, f0, ri))))
    seen = []
    plain = K.resblocks_inject_plain

    def spy(x_up, har, *a, **k):
        if "mxu_bf16" in k:  # the wrapper's call (not the form's upcast)
            seen.append((x_up.shape[-1], x_up.dtype, k["mxu_bf16"]))
        return plain(x_up, har, *a, **k)

    monkeypatch.setattr(K, "resblocks_inject_plain", spy)
    args = [torch.from_numpy(a) for a in (mel, f0, ri)]
    with torch.no_grad():
        got = gm(*args).numpy()
        assert seen == [(32, torch.bfloat16, True), (16, torch.bfloat16, True),
                        (8, torch.float32, True)], seen
        got32 = g32(*args).numpy()
    readings = dict(to_jax=_rel_rms(got, ref), to_fp32=_rel_rms(got, got32))
    assert readings["to_jax"] < SLICE_REL_RMS, readings
    assert readings["to_fp32"] > OFF_FP32, readings


# --------------------------------------------------------------- routes ---


def _spy(monkeypatch, mod, name, calls):
    real = getattr(mod, name)

    def spy(*a, **kw):
        calls.append((name, kw.get("mxu_bf16", False)))
        return real(*a, **kw)

    monkeypatch.setattr(mod, name, spy)


def test_routes_reach_the_forms(monkeypatch):
    """model.bf16 reaches #1's form at inference, and #2's (with #7's form
    in its backward) at inference and in training; the bf16 training attention stays on the plain route; a
    fused_mxu_bf16 Generator reaches #4's, #5's and #11's forms. On the CPU
    the wrappers run their plain versions, so the spies see the keyword."""
    calls = []
    for name in ("performer_attention", "performer_attention_moments",
                 "performer_attention_apply", "performer_attention_plain"):
        _spy(monkeypatch, tpcmer, name, calls)
    _spy(monkeypatch, tsynths, "combsub_spectral", calls)
    _spy(monkeypatch, K, "combsub_spectral_bwd", calls)
    model = lecun_init_(CombSubFast(SR, 128, n_unit=N_UNIT, n_spk=N_SPK,
                                    bf16=True),
                        torch.Generator().manual_seed(1))
    rng = np.random.default_rng(102)
    units = torch.from_numpy(rng.standard_normal((1, 32, N_UNIT))
                             .astype(np.float32))
    f0 = torch.full((1, 32, 1), 220.0)
    vol = torch.full((1, 32), 0.3)
    spk = torch.ones((1, 1), dtype=torch.int64)
    with torch.no_grad():
        model(units, f0, vol, spk, infer=True)
    assert ("performer_attention", True) in calls
    assert ("combsub_spectral", True) in calls
    calls.clear()
    sig = model(units, f0, vol, spk, infer=False)[0]
    sig.pow(2).sum().backward()
    assert ("performer_attention_plain", False) in calls
    assert ("performer_attention", True) not in calls
    assert ("combsub_spectral", True) in calls
    assert ("combsub_spectral_bwd", True) in calls, calls

    calls.clear()
    for name in ("fused_resblocks_inject", "fused_resblocks", "fused_stage"):
        _spy(monkeypatch, tnsf, name, calls)
    mel = torch.randn(1, 6, H["num_mels"])
    f0g = torch.full((1, 6), 200.0)
    ri = torch.zeros((1, 9))
    for overrides, want in (({}, "fused_resblocks_inject"),
                            ({"fused_inject": False}, "fused_resblocks"),
                            ({"fused_stage": True}, "fused_stage")):
        g = generator_from_h(H, fused_mxu_bf16=True, **overrides)
        calls.clear()
        with torch.no_grad():
            g(mel, f0g, ri)
        assert calls and all(c == (want, True) for c in calls), calls
