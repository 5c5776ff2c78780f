"""PyTorch port, on the card only: each hand-written CUDA kernel against its
plain PyTorch version on CUDA tensors, fp32 with TF32 off, at small and
ragged shapes (chip_smoke.py holds them at the main path's shapes). Every
test here is marked `cuda` and skips without a GPU. This file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from ddsp_svc_tpu_torch.nn.nsf_hifigan import _source_phase
from ddsp_svc_tpu_torch.nn.pcmer import gaussian_orthogonal_random_matrix
from ddsp_svc_tpu_torch.ops import kernels as K
from torch_tmp import tmp_path  # noqa: F401  (removed when each test ends)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels build and run only "
                    "on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, scale=1.0, shift=0.0):
    return torch.randn(shape, generator=gen, device=gen.device) * scale + shift


def _attention_case(cuda, b, t):
    g = torch.Generator(device=cuda).manual_seed(t)
    q, k, v = (_randn(g, b, 8, t, 64) for _ in range(3))
    proj = torch.from_numpy(gaussian_orthogonal_random_matrix(266, 64, 5)).to(cuda)
    return q, k, v, proj


def _assert_attention_close(got, ref, t, valid):
    """2e-5 of max |ref| on each row's valid prefix (the JAX package's
    kernel tolerance); a row with no valid frame gives zeros in both."""
    b = got.shape[0]
    n = [t] * b if valid is None else np.minimum(np.broadcast_to(valid, (b,)), t)
    for i in range(b):
        if n[i] == 0:
            assert not got[i].any() and not ref[i].any()
            continue
        r, o = ref[i, :, :n[i]], got[i, :, :n[i]]
        assert (o - r).abs().max().item() <= 2e-5 * r.abs().max().item()


@pytest.mark.parametrize("b,t,valid", [(2, 40, None), (1, 256, 200),
                                       (2, 1000, [999, 3]), (2, 64, [0, 64])])
def test_performer_attention_kernel(cuda, b, t, valid):
    """2e-5 of max |ref| on each row's valid prefix (the JAX package's
    kernel tolerance); a row with no valid frame gives zeros in both."""
    q, k, v, proj = _attention_case(cuda, b, t)
    ref = K.performer_attention_plain(q, k, v, proj, valid)
    got = K.performer_attention(q, k, v, proj, valid)
    _assert_attention_close(got, ref, t, valid)


@pytest.mark.parametrize("b,t,valid", [
    (1, 1, None), (3, 1, [0, 1, 5]), (3, 31, [0, 31, 40]), (1, 31, 30),
    (3, 33, [33, 1, 100]), (16, 33, 20), (3, 65, [0, 65, 40]), (16, 128, "mixed"),
    (1, 512, 384), (3, 512, [0, 512, 600]),
    (16, 512, None), (16, 512, "mixed"), (1, 1000, 999), (3, 1000, [1000, 0, 1500]),
    (16, 1000, "mixed")])
def test_performer_attention_kernel_shapes(cuda, b, t, valid):
    """Every cluster size, 1, 2, 4 and 8 CTAs (T of 1, 2, 3 to 4, and 5 to 32
    32-row tiles; past 8 tiles each CTA loops over its share), at B = 1, 3
    and 16, with per-row valid lengths of 0, inside T and past it ("mixed":
    lengths drawn from [0, T + 50) with a 0 and a T + 7 among them): within
    2e-5 of max |ref| on each row's valid prefix, and two calls bitwise
    equal (the cluster reduction sums in a fixed order)."""
    if valid == "mixed":
        valid = np.random.default_rng(t).integers(0, t + 50, b)
        valid[:2] = 0, t + 7
        valid = valid.tolist()
    q, k, v, proj = _attention_case(cuda, b, t)
    got = K.performer_attention(q, k, v, proj, valid)
    assert torch.equal(got, K.performer_attention(q, k, v, proj, valid))
    _assert_attention_close(got, K.performer_attention_plain(q, k, v, proj, valid),
                            t, valid)


def test_performer_attention_kernel_reads_split_heads(cuda):
    """q, k, v as the (B, H, T, 64) views SelfAttention splits off its
    (B, T, H * 64) projections, read in place: the same output, bit for
    bit, as from contiguous copies; a 0-d length on the card as the same
    int."""
    g = torch.Generator(device=cuda).manual_seed(2)
    views = [_randn(g, 2, 300, 8 * 64).reshape(2, 300, 8, 64).transpose(1, 2)
             for _ in range(3)]
    proj = torch.from_numpy(gaussian_orthogonal_random_matrix(266, 64, 5)).to(cuda)
    got = K.performer_attention(*views, proj, 250)
    assert got.is_contiguous()
    assert torch.equal(got, K.performer_attention(*(x.contiguous() for x in views),
                                                  proj, 250))
    assert torch.equal(got, K.performer_attention(
        *views, proj, torch.tensor(250, device=cuda)))


def _moment_ranges(b, t):
    """Key ranges at the span's edges: all, the first and the last frame, a
    range inside, an empty one, and per-row tensors with an empty row."""
    dev = "cuda"
    return [(0, None), (0, 1), (t - 1, t), (t // 5, t - t // 3), (t // 2, t // 2),
            (torch.tensor([0, t // 3, t - 7][:b], device=dev),
             torch.tensor([t // 2, t // 3, t][:b], device=dev))]


@pytest.mark.parametrize("b,t", [(1, 512), (3, 100), (2, 1000), (1, 31)])
def test_attention_moments_and_apply_kernels(cuda, b, t):
    """#1's split (performer_attention_moments / _apply, the entries a
    time-sharded PCmer layer runs) against their plain versions, key ranges
    at the span's edges and empty: the context and key sums each within
    2e-5 of its max |ref| (exactly 0 for an empty range), the output within
    2e-5 of max |ref|."""
    q, k, v, proj = _attention_case(cuda, b, t)
    for lo, hi in _moment_ranges(b, t):
        refs = K.performer_attention_moments_plain(k, v, proj, lo, hi)
        gots = K.performer_attention_moments(k, v, proj, lo, hi)
        for got, ref in zip(gots, refs):
            assert got.shape == ref.shape and got.is_contiguous()
            if not ref.any():
                assert not got.any()
                continue
            assert (got - ref).abs().max() <= 2e-5 * ref.abs().max()
        ref = K.performer_attention_apply_plain(q, proj, *refs)
        got = K.performer_attention_apply(q, proj, *gots)
        assert (got - ref).abs().max() <= 2e-5 * ref.abs().max()


@pytest.mark.parametrize("b,t,valid", [(1, 512, 384), (3, 1000, [1000, 0, 700]),
                                       (16, 128, None)])
def test_attention_split_matches_single_launch(cuda, b, t, valid):
    """Moments over [0, valid) then apply, and moments summed over four
    shards' key ranges then apply, against the single clustered launch:
    within 2e-5 of max |ref| on the valid rows (the unsplit moments take
    the single launch's tiles and sums, designed to agree bit for bit)."""
    q, k, v, proj = _attention_case(cuda, b, t)
    ref = K.performer_attention(q, k, v, proj, valid)
    hi = None if valid is None else torch.tensor(
        np.broadcast_to(valid, (b,)).copy(), dtype=torch.int32, device=cuda)
    got = K.performer_attention_apply(
        q, proj, *K.performer_attention_moments(k, v, proj, 0, hi))
    _assert_attention_close(got, ref, t, valid)
    cuts = [0, t // 4, t // 2 + 3, 3 * t // 4, t]
    parts = [K.performer_attention_moments(
        k, v, proj, lo, up if hi is None else torch.clamp(hi, max=up))
        for lo, up in zip(cuts, cuts[1:])]
    moments = [sum(p[i] for p in parts) for i in range(2)]
    _assert_attention_close(K.performer_attention_apply(q, proj, *moments),
                            ref, t, valid)


def test_time_parallel_gloo_on_card_matches_world_size_1(cuda, tmp_path):
    """The time-parallel synth (CombSubFast at configs/combsub.yaml's width,
    256 frames, 200 valid) and enhancer (H_NSF-like 16 kHz geometry) at
    world size 2 over Gloo, both ranks on this card, against world size 1
    over NCCL: 1e-4 of max |ref| for the synth, 1e-5 for the enhancer
    (fp32, TF32 off); every rank returns the whole output and launched #1's
    moments and apply, #2, #3 and #4."""
    from torch_parallel_worker import start_ranks

    from ddsp_svc_tpu_torch.infer.enhancer import NsfHifiGAN
    from ddsp_svc_tpu_torch.models.factory import build_model
    from ddsp_svc_tpu_torch.ops import build
    from ddsp_svc_tpu_torch.utils.config import DotDict

    build.build()  # here, not in each rank at once

    rng = np.random.default_rng(0)
    args = {"data": {"sampling_rate": 44100, "block_size": 512,
                     "encoder_out_channels": 256},
            "model": {"type": "CombSubFast", "n_spk": 2}}
    model = build_model(DotDict(args), device="cpu", seed=3)
    f = 256
    synth = dict(args=args, state=model.state_dict(),
                 units=torch.tensor(rng.standard_normal((1, f, 256)),
                                    dtype=torch.float32),
                 f0=torch.tensor(150 + 300 * rng.random((1, f, 1)),
                                 dtype=torch.float32),
                 volume=torch.tensor(rng.random((1, f)), dtype=torch.float32),
                 spk_id=torch.ones((1, 1), dtype=torch.int64),
                 noise=torch.tensor(rng.random((1, f * 512)) * 2 - 1,
                                    dtype=torch.float32),
                 valid_frames=200)
    h = {"sampling_rate": 16000, "num_mels": 16, "n_fft": 512, "win_size": 512,
         "hop_size": 128, "fmin": 40, "fmax": 8000, "upsample_rates": [4, 4, 8],
         "upsample_kernel_sizes": [8, 8, 16], "upsample_initial_channel": 128,
         "resblock_kernel_sizes": [3, 7, 11],
         "resblock_dilation_sizes": [[1, 3, 5]] * 3}
    nsf = NsfHifiGAN(None, h=h, seed=4, device="cpu")
    ri = torch.tensor(rng.random((1, 9)), dtype=torch.float32)
    ri[:, 0] = 0
    enh = dict(h=h, state=nsf.model.state_dict(),
               audio=torch.tensor(0.1 * rng.standard_normal((1, 200 * 128)),
                                  dtype=torch.float32),
               f0_frames=torch.tensor(150 + 300 * rng.random((1, 201)),
                                      dtype=torch.float32), rand_ini=ri)
    jobs = [("synth", "synth_forward", synth), ("enh", "enhancer_forward", enh)]
    one = start_ranks(jobs, 1, str(tmp_path / "w1"), "cuda", "nccl",
                      timeout=300).wait()
    two = start_ranks(jobs, 2, str(tmp_path / "w2"), "cuda", "gloo",
                      timeout=300).wait()
    for name, tol in (("synth", 1e-4), ("enh", 1e-5)):
        ref = one[0][name]
        assert torch.isfinite(ref).all()
        for rank in two:
            assert (rank[name] - ref).abs().max() <= tol * ref.abs().max()
    for rank in one + two:
        counts = rank["_launches"]
        for name in ("performer_attention_moments", "performer_attention_apply",
                     "combsub_spectral", "harmonic_source",
                     "fused_resblocks_inject"):
            assert counts[name] > 0, (name, counts)
        assert counts["performer_attention"] == 0


def _mesh_train_jobs():
    """A CombSubFast at configs/combsub.yaml's width (44.1 kHz, block 512,
    256 units), a batch of 4 x 48 frames and its noise, and a K = 2
    staging of two batches, for the mesh-training cases of
    tests/torch_parallel_worker.py."""
    from ddsp_svc_tpu_torch.models.factory import build_model
    from ddsp_svc_tpu_torch.train.step import stage
    from ddsp_svc_tpu_torch.utils.config import DotDict

    args = {"data": {"sampling_rate": 44100, "block_size": 512,
                     "encoder_out_channels": 256},
            "model": {"type": "CombSubFast", "n_spk": 2}}
    model = build_model(DotDict(args), device="cpu", seed=5)

    def batch(seed):
        rng = np.random.default_rng(seed)
        return {"audio": torch.tensor(0.3 * rng.standard_normal((4, 48 * 512)),
                                      dtype=torch.float32),
                "f0": torch.tensor(110 + 330 * rng.random((4, 48, 1)),
                                   dtype=torch.float32),
                "volume": torch.tensor(rng.random((4, 48)),
                                       dtype=torch.float32),
                "units": torch.tensor(rng.standard_normal((4, 48, 256)),
                                      dtype=torch.float32),
                "spk_id": torch.tensor([[1], [2], [1], [2]])}

    noise = torch.tensor(np.random.default_rng(9).random((4, 48 * 512)) * 2
                         - 1, dtype=torch.float32)
    step = dict(args=args, state=model.state_dict(), batches=[batch(0)],
                noises=[noise], loss_idx=(3, 9))
    staged = stage([{k: v.numpy() for k, v in batch(s).items()}
                    for s in (1, 2)], "cpu")
    return args, model, step, staged


def test_mesh_train_gloo_on_card_matches_single_process(cuda, tmp_path):
    """Training on a mesh with 2 Gloo ranks sharing this card: a DP (2 x 1)
    and a TP (1 x 2) step against the single-process step on the card from
    the same weights, batch, noise and loss scales (loss within 2e-4
    relative; parameters at the 99th percentile of |diff| < 1e-4 and at
    most 4e-3, tests/test_parallel.py's bounds; the DP ranks' parameters
    the same bit for bit); a graphed K = 2 dispatch
    under DP against 2 eager DP steps, bit for bit with cuDNN
    deterministic; a graphed dispatch under TP over Gloo raises (its
    collectives would sit inside the captured graphs)."""
    from torch_parallel_worker import _RSS, start_ranks

    from ddsp_svc_tpu_torch.ops import build
    from ddsp_svc_tpu_torch.train.step import (TrainState, create_optimizer,
                                               train_step)

    build.build()  # here, not in each rank at once
    args, model, step, staged = _mesh_train_jobs()
    jobs = [("dp", "mesh_steps", step, (2, 1)),
            ("tp", "mesh_steps", step, (1, 2)),
            ("graphed", "graphed_steps", dict(
                args=args, state=model.state_dict(), staged=staged, seed=4),
             (2, 1)),
            ("tp graphed", "graphed_steps", dict(
                args=args, state=model.state_dict(), staged=staged), (1, 2))]
    ranks = start_ranks(jobs, 2, str(tmp_path / "w2"), "cuda", "gloo",
                        timeout=600).wait()
    single = model.to(cuda)
    st = TrainState(0, single, create_optimizer(single, 1e-3))
    loss = float(train_step(st, {k: v.to(cuda) for k, v in
                                 step["batches"][0].items()}, _RSS,
                            noise=step["noises"][0].to(cuda),
                            loss_idx=step["loss_idx"]))
    ref = {k: v.cpu() for k, v in single.state_dict().items()}
    for name in ("dp", "tp"):
        res = ranks[0][name]
        assert abs(res["losses"][0] - loss) <= 2e-4 * abs(loss), name
        for k, v in ref.items():
            diff = (res["full"]["model"][k] - v).abs().flatten().double()
            assert torch.quantile(diff, 0.99) < 1e-4, (name, k)
            assert diff.max() < 4e-3, (name, k)
    for k, v in ranks[0]["dp"]["local"].items():  # the DP replicas agree
        assert torch.equal(ranks[1]["dp"]["local"][k], v), k
    for rank in ranks:
        res = rank["graphed"]
        assert res["bitwise"], (res["eager"], res["graphed"])
        assert "NCCL" in rank["tp graphed"]["error"]
        assert rank["_launches"]["dft_magnitude"] > 0


def test_nccl_takes_one_rank_a_card(cuda):
    """NCCL with more local ranks than cards (a 1 x 2 mesh on this one
    card) raises before joining; Gloo is the way to share a card."""
    from ddsp_svc_tpu_torch.parallel import init_distributed
    with pytest.raises(ValueError, match="one rank a card"):
        init_distributed("127.0.0.1:1", torch.cuda.device_count() + 1, 1,
                         backend="nccl", device="cuda")


@pytest.mark.parametrize("n_fft,rows", [(64, 3), (1024, 9), (4096, 5)])
def test_combsub_spectral_kernel(cuda, n_fft, rows):
    """2e-5 of max |ref|, the JAX package's kernel tolerance."""
    g = torch.Generator(device=cuda).manual_seed(n_fft)
    bins = n_fft // 2 + 1
    args = (_randn(g, rows, n_fft), _randn(g, rows, n_fft),
            _randn(g, rows, bins, scale=0.3), _randn(g, rows, bins),
            _randn(g, rows, bins, scale=0.3, shift=-3.0), n_fft)
    ref = K.combsub_spectral_plain(*args)
    got = K.combsub_spectral(*args)
    assert ((got - ref).abs().max() / ref.abs().max()).item() < 2e-5


@pytest.mark.parametrize("n_fft,rows", [(n, 37) for n in (64, 128, 256, 512, 1024,
                                                        2048, 4096)]
                         + [(1024, 4152)])
def test_combsub_spectral_kernel_sizes(cuda, n_fft, rows):
    """Every power of two the kernel takes, at a row count that leaves a
    block's last slots empty, and at a training batch's 4152 rows; 2e-5 of
    max |ref| (the JAX package's kernel tolerance)."""
    g = torch.Generator(device=cuda).manual_seed(n_fft + rows)
    bins = n_fft // 2 + 1
    args = (_randn(g, rows, n_fft), _randn(g, rows, n_fft),
            _randn(g, rows, bins, scale=0.3), _randn(g, rows, bins),
            _randn(g, rows, bins, scale=0.3, shift=-3.0), n_fft)
    ref = K.combsub_spectral_plain(*args)
    got = K.combsub_spectral(*args)
    assert ((got - ref).abs().max() / ref.abs().max()).item() < 2e-5


@pytest.mark.parametrize("n_fft", [256, 1024, 4096])
def test_combsub_spectral_kernel_mixed_scale(cuda, n_fft):
    """Rows whose tooth and noise are scaled by 10^u, u uniform in [-4, 0]
    (silent frames beside loud ones): each row against the chain in
    float64 on the CPU within 2e-5 of its own max."""
    g = torch.Generator(device=cuda).manual_seed(n_fft)
    rows, bins = 301, n_fft // 2 + 1
    scale = 10.0 ** (-4 * torch.rand((rows, 1), generator=g, device=cuda))
    args = (_randn(g, rows, n_fft) * scale, _randn(g, rows, n_fft) * scale,
            _randn(g, rows, bins, scale=0.3), _randn(g, rows, bins),
            _randn(g, rows, bins, scale=0.3, shift=-3.0))
    ref = K.combsub_spectral_plain(*(a.double().cpu() for a in args), n_fft)
    got = K.combsub_spectral(*args, n_fft).double().cpu()
    err = (got - ref).abs().amax(1) / ref.abs().amax(1)
    assert err.max().item() <= 2e-5, err.max().item()


@pytest.mark.parametrize("upp", [64, 300, 512])
def test_harmonic_source_kernel(cuda, upp):
    """atol 2e-5, the JAX package's kernel tolerance."""
    g = torch.Generator(device=cuda).manual_seed(upp)
    f0 = 100 + 400 * torch.rand((2, 33), generator=g, device=cuda)
    ri = torch.rand((2, 9), generator=g, device=cuda)
    ri[:, 0] = 0
    start, rad = _source_phase(f0, upp, 44100, ri, 8)
    args = (start.contiguous(), rad.contiguous(), _randn(g, 9, scale=0.3),
            _randn(g, 1, scale=0.05), upp)
    ref = K.harmonic_source_plain(*args)
    got = K.harmonic_source(*args)
    assert (got - ref).abs().max().item() < 2e-5


def _assert_float64_gate(got, plain, f64, where=None):
    """The kernel within twice the fp32 plain version's own error against
    float64 (the same formula evaluated in float64 from the same fp32
    inputs) + 1e-7 of max |f64|; the plain version's error taken over
    `where` (a mask of the output) when given."""
    e_plain = (plain.double() - f64).abs()
    if where is not None:
        e_plain = e_plain[where]
    limit = 2 * e_plain.max().item() + 1e-7 * f64.abs().max().item()
    err = (got.double() - f64).abs().max().item()
    assert err <= limit, (err, limit)


def _harmonic_source_case(cuda, b, f, upp, n_harm=8, w_scale=1.0):
    g = torch.Generator(device=cuda).manual_seed(b * f * upp)
    f0 = 100 + 400 * torch.rand((b, f), generator=g, device=cuda)
    ri = torch.rand((b, n_harm + 1), generator=g, device=cuda)
    ri[:, 0] = 0
    start, rad = _source_phase(f0, upp, 44100, ri, n_harm)
    return (start.contiguous(), rad.contiguous(),
            _randn(g, n_harm + 1, scale=w_scale), _randn(g, 1, scale=0.05),
            upp)


@pytest.mark.parametrize("b,f,upp", [(1, 512, 512), (2, 33, 300),
                                     (2, 33, 64), (3, 7, 250), (1, 5, 1030)])
def test_harmonic_source_kernel_float64(cuda, b, f, upp):
    """Against float64 within 2x the plain version's own error + 1e-7 of
    max |f64|, and atol 2e-5 against the plain version, with N(0, 1) merge
    weights (the JAX package's kernel test): at the path's 512 frames x upp
    512, at upp 300 and 250 (250: no float4 stores; 21 rows), upp 64 (66
    rows) and upp 1030 (a row over three blocks, the last one partial)."""
    _check_harmonic_source(_harmonic_source_case(cuda, b, f, upp))


def _check_harmonic_source(args):
    got = K.harmonic_source(*args)
    plain = K.harmonic_source_plain(*args)
    f64 = K.harmonic_source_plain(*(a.double() if torch.is_tensor(a) else a
                                    for a in args))
    assert (got - plain).abs().max().item() < 2e-5
    _assert_float64_gate(got, plain, f64)


@pytest.mark.parametrize("n_harm", [128, 299])
def test_harmonic_source_kernel_many_harmonics(cuda, n_harm):
    """Any number of harmonics, 129 and 300 here (the kernel reads each
    row's start, rad and weights from global memory, so nothing bounds
    H), at 2 x 40 frames of upp 512 with N(0, 0.1^2) merge weights (tanh
    not saturated); the same gates as test_harmonic_source_kernel_float64."""
    _check_harmonic_source(
        _harmonic_source_case(cuda, 2, 40, 512, n_harm, w_scale=0.1))


def _oscillator_case(cuda, b, f, h, block):
    g = torch.Generator(device=cuda).manual_seed(b * f * h + block)
    phase = (torch.rand((b, f * block), generator=g, device=cuda) * 2 - 1) * np.pi
    amps = torch.rand((b, f, h), generator=g, device=cuda) * 0.1
    return phase, amps


def _oscillator_f64(phase, amps, block):
    return K.oscillator_bank_plain(phase.double(), amps.double(), block)


@pytest.mark.parametrize("b,f,h,block", [
    (1, 512, 128, 512), (24, 172, 128, 512), (2, 9, 60, 300), (3, 5, 33, 64),
    (2, 7, 128, 130), (1, 3, 1, 512)])
def test_oscillator_bank_kernel_float64(cuda, b, f, h, block):
    """Against float64 within 2x the plain version's own error + 1e-7 of
    max |f64|, and atol 2e-3 against the plain version: at the path's two
    shapes (the offline 1 x 512 frames, a training batch of 24 x 172), 60
    and 33 harmonics (not a multiple of 4), block 300, 64 and 130 (130: no
    float4 loads or stores), and one harmonic."""
    phase, amps = _oscillator_case(cuda, b, f, h, block)
    got = K.oscillator_bank(phase, amps, block)
    plain = K.oscillator_bank_plain(phase, amps, block)
    torch.testing.assert_close(got, plain, atol=2e-3, rtol=0)
    _assert_float64_gate(got, plain, _oscillator_f64(phase, amps, block))


def test_oscillator_bank_kernel_phase_edges(cuda):
    """Phases of exactly +pi, -pi (fp32) and 0, and within 1e-3 of them,
    among uniform ones: where a recurrence along the harmonics is weakest
    (sin(phase) ~ 0). The kernel against float64 everywhere within 2x the
    plain version's own error on the uniform phases + 1e-7 of max |f64|;
    atol 2e-3 against the plain version; at phase 0 the output is 0."""
    b, f, h, block = 2, 16, 128, 512
    phase, amps = _oscillator_case(cuda, b, f, h, block)
    g = torch.Generator(device=cuda).manual_seed(3)
    near = torch.rand(phase[:, 3::8].shape, generator=g, device=cuda) * 1e-3
    pi = float(np.float32(np.pi))
    phase[:, 0::8] = pi
    phase[:, 1::8] = -pi
    phase[:, 2::8] = 0.0
    phase[:, 3::8] = near
    phase[:, 4::8] = -near
    phase[:, 5::8] = pi - near
    phase[:, 6::8] = near - pi
    uniform = torch.zeros_like(phase, dtype=torch.bool)
    uniform[:, 7::8] = True
    got = K.oscillator_bank(phase, amps, block)
    plain = K.oscillator_bank_plain(phase, amps, block)
    torch.testing.assert_close(got, plain, atol=2e-3, rtol=0)
    _assert_float64_gate(got, plain, _oscillator_f64(phase, amps, block),
                         where=uniform)
    assert got[:, 2::8].abs().max().item() == 0.0


def test_oscillator_bank_kernel_last_frame(cuda):
    """The last frame takes its own amplitudes at both ends (the frame
    repeated, f = F - 1): its samples equal bit for bit a one-frame call on
    the same phases and amplitudes, and keep the float64 gate."""
    b, f, h, block = 3, 6, 128, 512
    phase, amps = _oscillator_case(cuda, b, f, h, block)
    got = K.oscillator_bank(phase, amps, block)[:, -block:]
    p1, a1 = phase[:, -block:].contiguous(), amps[:, -1:].contiguous()
    assert torch.equal(got, K.oscillator_bank(p1, a1, block))
    _assert_float64_gate(got, K.oscillator_bank_plain(p1, a1, block),
                         _oscillator_f64(p1, a1, block))


@pytest.mark.parametrize("c,t,s_src,valid,inject", [
    (64, 700, 4, None, True), (32, 1500, 2, [1400, 600], True),
    (16, 3000, 1, None, True), (8, 5000, 1, 4000, True),
    (64, 333, 1, None, False), (16, 50, 2, None, True)])
def test_resblocks_inject_kernel(cuda, c, t, s_src, valid, inject):
    """atol 1e-4, rtol 1e-4: the JAX package's trio kernel tolerance."""
    g = torch.Generator(device=cuda).manual_seed(c * t)
    ksrc = 2 * s_src if s_src > 1 else 1
    ws = [_randn(g, 3, 2, c, c, k, scale=(2.0 / (k * c)) ** 0.5)
          for k in (3, 7, 11)]
    bs = [_randn(g, 3, 2, c, scale=0.01) for _ in range(3)]
    har = _randn(g, 2, t * s_src, 1, scale=0.1) if inject else None
    args = (_randn(g, 2, t, c), har, _randn(g, c, 1, ksrc, scale=0.2),
            _randn(g, c, scale=0.05), ws, bs, s_src)
    ref = K.resblocks_inject_plain(*args, valid=valid)
    got = K.fused_resblocks_inject(*args, valid=valid)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("valid", [None, [40000, 65536]])
def test_resblocks_kernel_at_path_shape(cuda, valid):
    """The trio without injection (#5) at the enhancer's C = 64 stage of a
    512-frame segment, T = 65536, and with per-row lengths: atol 1e-4, rtol
    1e-4, max |err| at most 2e-5 (it reads ~1e-5; summing each conv in the
    tensor cores' own accumulators, without the fp32 re-accumulation, reads
    ~9e-5, tools/ab_torch_trio.py), and every output past a row's length
    exactly 0."""
    g = torch.Generator(device=cuda).manual_seed(65)
    ws, bs = _trio(g, 64)
    x = _randn(g, 2, 65536, 64)
    ref = K.resblocks_inject_plain(x, None, None, None, ws, bs, 1, valid=valid)
    got = K.fused_resblocks(x, ws, bs, valid=valid)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    assert (got - ref).abs().max().item() <= 2e-5
    if valid is not None:
        assert not got[0, valid[0]:].any()


# one bf16 ulp: kernel and plain version upcast exactly and compute in
# fp32; only the output's rounding to bf16 may flip
BF16_ULP = dict(rtol=2.0 ** -7, atol=2e-5)


@pytest.mark.parametrize("c,t,s_src,valid,har", [
    (64, 700, 4, None, "fp32"), (32, 1500, 2, [1400, 600], "bf16"),
    (16, 3000, 1, None, "bf16"), (8, 5000, 1, 4000, "fp32"),
    (64, 333, 1, None, None), (64, 65536, 8, None, "fp32")])
def test_resblocks_bf16_kernel(cuda, c, t, s_src, valid, har):
    """The trio's bf16-input form (x bf16; har fp32 as a staged stage gets
    it, bf16 as the full-bf16 Generator's, or none: #5's form) against its
    plain version on the same inputs: bf16 out, within one bf16 ulp, the
    tail past a row's length exactly 0, the launch counted on the form
    (fused_resblocks_inject_bf16 / fused_resblocks_bf16), none on the fp32
    form's counts."""
    g = torch.Generator(device=cuda).manual_seed(c * t + 1)
    ksrc = 2 * s_src if s_src > 1 else 1
    ws = [_randn(g, 3, 2, c, c, k, scale=(2.0 / (k * c)) ** 0.5)
          for k in (3, 7, 11)]
    bs = [_randn(g, 3, 2, c, scale=0.01) for _ in range(3)]
    h = None if har is None else _randn(g, 2, t * s_src, 1, scale=0.1)
    if har == "bf16":
        h = h.to(torch.bfloat16)
    args = (_randn(g, 2, t, c).to(torch.bfloat16), h,
            _randn(g, c, 1, ksrc, scale=0.2), _randn(g, c, scale=0.05), ws,
            bs, s_src)
    ref = K.resblocks_inject_plain(*args, valid=valid)
    K.reset_launch_counts()
    got = K.fused_resblocks_inject(*args, valid=valid)
    counts = K.launch_counts()
    form = "fused_resblocks_bf16" if har is None \
        else "fused_resblocks_inject_bf16"
    assert counts[form] == 1 and sum(counts.values()) == 1, counts
    assert got.dtype == ref.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.float(), **BF16_ULP)
    if valid is not None:
        for i, n in enumerate(np.broadcast_to(valid, (2,))):
            assert not got[i, n:].any()


def test_resblocks_bf16_kernel_backward(cuda):
    """The bf16 form's backward (the plain form replayed) against autograd
    of the plain version, at the C = 32 stage: within one bf16 ulp (the
    replay and autograd run the same operations; cuDNN's backward may sum
    in another order)."""
    g = torch.Generator(device=cuda).manual_seed(32)
    ws, bs = _trio(g, 32)
    x = _randn(g, 1, 900, 32).to(torch.bfloat16).requires_grad_()
    har = _randn(g, 1, 3600, 1, scale=0.1)
    nw, nb = _randn(g, 32, 1, 8, scale=0.2), _randn(g, 32, scale=0.05)
    up = _randn(g, 1, 900, 32).to(torch.bfloat16)
    grads = []
    for fn in (K.fused_resblocks_inject, K.resblocks_inject_plain):
        x.grad = None
        (fn(x, har, nw, nb, ws, bs, 4).float() * up.float()).sum().backward()
        grads.append(x.grad.float())
    torch.testing.assert_close(grads[0], grads[1], **BF16_ULP)


@pytest.mark.parametrize("kernel", ["trio", "chain", "stage"])
@pytest.mark.parametrize("c", [64, 16])
def test_resblocks_kernel_wide_range(cuda, c, kernel):
    """The three kernels on the tensor-core conv core (the trio #5, one
    chain #10 at each k, the fused stage #11 at u = 2) on inputs and
    weights of magnitude 10^u, u uniform in [-3, 3], random signs, against
    the plain version in float64: within 4e-6 of max |ref| (the trio reads
    ~1.2e-6, the fp32 cuDNN chain 0.6-1.4e-6; these and the figures below
    from tools/ab_torch_trio.py). Summing in the tensor cores' own
    accumulators, which truncate, without the fp32 re-accumulation, reads
    6.7e-6 (C = 16) and 2.6e-5 (C = 64) on the trio, which 1e-4 against the
    fp32 chain would pass. A tf32 operand without its lo part reads ~5e-4
    here and fails every trio test (~3e-3 at unit scale)."""
    g = torch.Generator(device=cuda).manual_seed(c + 3)

    def wide(*shape):
        u = torch.rand(shape, generator=g, device=cuda)
        sign = torch.randint(0, 2, shape, generator=g, device=cuda) * 2 - 1
        return sign * 10.0 ** (6 * u - 3)

    def f64(args):
        return [[a.double() for a in x] if isinstance(x, list)
                else x.double() if torch.is_tensor(x) else x for x in args]

    ws = [wide(3, 2, c, c, k) for k in (3, 7, 11)]
    bs = [_randn(g, 3, 2, c, scale=0.01) for _ in range(3)]
    if kernel == "trio":
        runs = [(lambda x_, w_, b_: K.resblocks_inject_plain(
                    x_, None, None, None, w_, b_, 1), K.fused_resblocks,
                 [wide(1, 1000, c), ws, bs])]
    elif kernel == "chain":
        runs = [(K.resblock_chain_plain, K.fused_resblock_chain,
                 [wide(1, 1000, c), w, b, w.shape[-1]])
                for w, b in zip(ws, bs)]
    else:
        runs = [(K.stage_plain, K.fused_stage,
                 [wide(1, 500, 2 * c), wide(1, 2000, 1), wide(2 * c, c, 4),
                  _randn(g, c, scale=0.05), wide(c, 1, 4),
                  _randn(g, c, scale=0.05), ws, bs, 2, 2])]
    for plain, kern, args in runs:
        ref = plain(*f64(args))
        got = kern(*args).double()
        assert torch.isfinite(ref).all()
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        assert err <= 4e-6, err


# the RSS loss's 16 sizes (models/losses.py::default_buckets(256, 2048)), the
# ends of the kernel's range and a few small ones, at ragged row counts
DFT_SIZES = (256, 375, 495, 614, 734, 853, 972, 1092, 1211, 1331, 1450, 1569,
             1689, 1808, 1928, 2047, 2, 3, 8, 13, 8191, 8192)


@pytest.mark.parametrize("n_fft,rows", [(256, 100), (375, 33), (1092, 17),
                                        (2047, 40), (8, 3)] + [
    (n, 5 + (7 * n) % 61) for n in DFT_SIZES
    if n not in (256, 375, 1092, 2047, 8)])
def test_dft_magnitude_kernel(cuda, n_fft, rows):
    """atol 2e-3 (the JAX package's kernel test) on the magnitude, and the
    gradient through the autograd Function against autograd of the plain
    version at atol 2e-3, at every size of the RSS loss (powers of two, the
    half-length split around a Bluestein for even n, Bluestein for odd n)
    and at n = 2, 3, 8191, 8192."""
    g = torch.Generator(device=cuda).manual_seed(n_fft)
    x = _randn(g, rows, n_fft)
    gm = _randn(g, rows, n_fft // 2 + 1)
    xk, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    mk, mp = K.dft_magnitude(xk, n_fft), K.dft_magnitude_plain(xp, n_fft)
    torch.testing.assert_close(mk, mp, atol=2e-3, rtol=0)
    (mk * gm).sum().backward()
    (mp * gm).sum().backward()
    torch.testing.assert_close(xk.grad, xp.grad, atol=2e-3, rtol=0)


@pytest.mark.parametrize("n_fft", [256, 614, 853, 2047, 8191])
def test_dft_magnitude_kernel_mixed_scale(cuda, n_fft):
    """Rows scaled by 10^u, u uniform in [-4, 0], as silent frames sit beside
    loud ones in the loss: each row within 1e-4 of its own max |ref|, the
    reference the plain version in float64 on the CPU. A design that put
    two rows into one complex transform would round a quiet row at its
    neighbour's scale (~1e-6 of the loud row's max, up to ~1e-2 of the
    quiet row's) and fail."""
    g = torch.Generator(device=cuda).manual_seed(n_fft + 1)
    rows = 301
    scale = 10.0 ** (-4 * torch.rand((rows, 1), generator=g, device=cuda))
    x = _randn(g, rows, n_fft) * scale
    ref = K.dft_magnitude_plain(x.double().cpu(), n_fft)
    got = K.dft_magnitude(x, n_fft).double().cpu()
    err = (got - ref).abs().amax(1) / ref.abs().amax(1)
    assert err.max().item() <= 1e-4, err.max().item()


@pytest.mark.parametrize("n_fft", [614, 853, 2047, 8191])
def test_dft_magnitude_grad_mixed_scale(cuda, n_fft):
    """The backward on rows scaled by 10^u, u uniform in [-4, 0], with the
    upstream gradient 1 / (|X| + 1e-7) that the log term of the RSS loss
    gives: each row's gradient within 1e-4 of its own max |ref|, the
    reference autograd of the plain version in float64 on the CPU. The
    quiet rows carry the largest spectrum after the 1/|X|^2 weighting, so
    a batched transform that rounds rows at a neighbour's scale fails."""
    g = torch.Generator(device=cuda).manual_seed(n_fft + 2)
    rows = 301
    scale = 10.0 ** (-4 * torch.rand((rows, 1), generator=g, device=cuda))
    x = _randn(g, rows, n_fft) * scale
    x64 = x.double().cpu().requires_grad_()
    m64 = K.dft_magnitude_plain(x64, n_fft)
    up = 1.0 / (m64.detach() + 1e-7)
    (m64 * up).sum().backward()
    xk = x.clone().requires_grad_()
    (K.dft_magnitude(xk, n_fft) * up.float().to(cuda)).sum().backward()
    ref = x64.grad
    err = (xk.grad.double().cpu() - ref).abs().amax(1) / ref.abs().amax(1)
    assert err.max().item() <= 1e-4, err.max().item()


@pytest.mark.parametrize("n_fft,rows", [(n, 37) for n in (64, 128, 256, 512,
                                                        1024, 2048, 4096)]
                         + [(1024, 4152)])
def test_combsub_spectral_bwd_kernel(cuda, n_fft, rows):
    """Every power of two the kernel takes, at a row count that leaves a
    block's last slots empty, and at a training batch's 4152 rows: each of
    the five gradients within 2e-5 of its max |ref| (the JAX package's
    kernel tolerance), by the kernel and by autograd through
    combsub_spectral, against the plain adjoint."""
    g = torch.Generator(device=cuda).manual_seed(n_fft + rows)
    bins = n_fft // 2 + 1
    args = (_randn(g, rows, n_fft), _randn(g, rows, n_fft),
            _randn(g, rows, bins, scale=1.5), _randn(g, rows, bins, scale=1.5),
            _randn(g, rows, bins, scale=1.5))
    up = _randn(g, rows, n_fft)
    ref = K.combsub_spectral_bwd_plain(up, *args, n_fft)
    got = K.combsub_spectral_bwd(up, *args, n_fft)
    xs = [a.clone().requires_grad_() for a in args]
    (K.combsub_spectral(*xs, n_fft) * up).sum().backward()
    for r, o, x in zip(ref, got, xs):
        for out in (o, x.grad):
            assert ((out - r).abs().max() / r.abs().max()).item() < 2e-5


@pytest.mark.parametrize("n_fft", [256, 1024, 4096])
def test_combsub_spectral_bwd_kernel_mixed_scale(cuda, n_fft):
    """Rows whose g, tooth and noise are each scaled by their own 10^u, u
    uniform in [-4, 0], and rows whose noise is 1e-3 of tooth's scale: each
    row of each of the five gradients against the plain adjoint in float64
    on the CPU within 2e-5 of that row's own max. A transform shared by two
    of the signals rounds the smaller at the larger's scale and fails."""
    g = torch.Generator(device=cuda).manual_seed(n_fft + 1)
    rows, bins = 301, n_fft // 2 + 1

    def scale():
        return 10.0 ** (-4 * torch.rand((rows, 1), generator=g, device=cuda))

    s_tooth, s_noise = scale(), scale()
    s_noise[200:] = 1e-3 * s_tooth[200:]
    args = (_randn(g, rows, n_fft) * scale(), _randn(g, rows, n_fft) * s_tooth,
            _randn(g, rows, n_fft) * s_noise, _randn(g, rows, bins, scale=0.3),
            _randn(g, rows, bins), _randn(g, rows, bins, scale=0.3, shift=-3.0))
    refs = K.combsub_spectral_bwd_plain(*(a.double().cpu() for a in args), n_fft)
    gots = K.combsub_spectral_bwd(*args, n_fft)
    for name, ref, got in zip(("tooth", "noise", "hm", "hp", "nm"), refs, gots):
        err = (got.double().cpu() - ref).abs().amax(1) / ref.abs().amax(1)
        assert err.max().item() <= 2e-5, (name, err.max().item())


def test_combsub_spectral_plain_at_training_rows(cuda):
    """The plain chain on the card at a training batch's 4152 rows against
    the same chain in float64 on the CPU. cuFFT's C2R reads the imaginary
    parts of the DC and Nyquist bins at 2048 or more rows of n_fft 1024
    (every row ~2e-2 off when they are not zero); the plain version zeroes
    them, as irfft's semantics drop them."""
    g = torch.Generator(device=cuda).manual_seed(1)
    n_fft, rows = 1024, 4152
    bins = n_fft // 2 + 1
    args = (_randn(g, rows, n_fft), _randn(g, rows, n_fft),
            _randn(g, rows, bins, scale=1.5), _randn(g, rows, bins, scale=1.5),
            _randn(g, rows, bins, scale=1.5))
    got = K.combsub_spectral_plain(*args, n_fft).double().cpu()
    ref = K.combsub_spectral_plain(*(a.double().cpu() for a in args), n_fft)
    assert ((got - ref).abs().max() / ref.abs().max()).item() < 2e-5


def test_bf16_infer_forward_matches_plain(cuda, monkeypatch):
    """A model.bf16 CombSubFast at inference (bf16 q, k, v on the attention
    kernel's bf16-operand form; the spectral chain on its form) against the
    same model with both forms swapped for their plain forms (the wrappers'
    plain versions take the same mxu_bf16 keyword). Both round the same
    operands to bf16; their fp32 rounding differences (~1e-6) flip bf16
    roundings downstream (2^-8 each) that grow through the PCmer layers
    towards bf16's own noise, so the bound is the JAX package's bf16 bound,
    5e-2 relative RMS (tests/test_bf16.py). Only the forms are counted, no
    fp32 form."""
    from ddsp_svc_tpu_torch.models import synths
    from ddsp_svc_tpu_torch.nn import pcmer
    from ddsp_svc_tpu_torch.nn.layers import lecun_init_

    g = torch.Generator(device=cuda).manual_seed(9)
    model = lecun_init_(synths.CombSubFast(44100, 512, n_unit=32, n_spk=2,
                                           bf16=True),
                        torch.Generator().manual_seed(0)).to(cuda)
    b, frames = 2, 96
    args = (_randn(g, b, frames, 32),
            110 + 300 * torch.rand((b, frames, 1), generator=g, device=cuda),
            torch.rand((b, frames), generator=g, device=cuda),
            torch.tensor([[1], [2]], device=cuda))
    K.reset_launch_counts()
    with torch.no_grad():
        got, _, _ = model(*args, infer=True,
                          generator=torch.Generator(device=cuda).manual_seed(1))
        counts = K.launch_counts()
        monkeypatch.setattr(pcmer, "performer_attention",
                            K.performer_attention_plain)
        monkeypatch.setattr(synths, "combsub_spectral",
                            K.combsub_spectral_plain)
        ref, _, _ = model(*args, infer=True,
                          generator=torch.Generator(device=cuda).manual_seed(1))
    assert counts["performer_attention_mxu_bf16"] > 0
    assert counts["combsub_spectral_mxu_bf16"] > 0
    assert counts["performer_attention"] == counts["combsub_spectral"] == 0
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    rel_rms = ((got - ref).pow(2).mean() / ref.pow(2).mean()).sqrt().item()
    assert rel_rms < 5e-2, rel_rms


@pytest.mark.parametrize("b,f,h,block", [
    (1, 512, 128, 512), (2, 7, 128, 512), (2, 9, 60, 300), (3, 5, 33, 64)])
def test_oscillator_bank_kernel(cuda, b, f, h, block):
    """atol 2e-3 at amplitudes <= 0.1 (the JAX package's kernel test); the
    gradient of the amplitudes through the autograd Function (autograd of
    the plain version re-run) against autograd of the plain version at 1e-5
    of max |ref|, and the phase's gradient only when asked for."""
    g = torch.Generator(device=cuda).manual_seed(f * h)
    phase = (torch.rand((b, f * block), generator=g, device=cuda) * 2 - 1) * np.pi
    amps = torch.rand((b, f, h), generator=g, device=cuda) * 0.1
    ref = K.oscillator_bank_plain(phase, amps, block)
    counts = K.launch_counts()["oscillator_bank"]
    got = K.oscillator_bank(phase, amps, block)
    assert K.launch_counts()["oscillator_bank"] == counts + 1
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=0)
    up = _randn(g, b, f * block)
    ak, ap = amps.clone().requires_grad_(), amps.clone().requires_grad_()
    (K.oscillator_bank(phase, ak, block) * up).sum().backward()
    (K.oscillator_bank_plain(phase, ap, block) * up).sum().backward()
    assert ((ak.grad - ap.grad).abs().max()
            <= 1e-5 * ap.grad.abs().max()).item()
    pk, pp = phase.clone().requires_grad_(), phase.clone().requires_grad_()
    (K.oscillator_bank(pk, amps, block) * up).sum().backward()
    (K.oscillator_bank_plain(pp, amps, block) * up).sum().backward()
    assert ((pk.grad - pp.grad).abs().max()
            <= 1e-5 * pp.grad.abs().max()).item()


@pytest.mark.parametrize("rows,frame,ir,n", [(513, 1024, 510, 2048),
                                            (4152, 1024, 1022, 2048),
                                            (5, 128, 126, 256),
                                            (3, 1000, 77, 2048),
                                            (7, 33, 32, 64),
                                            (2, 2049, 2000, 4096)])
def test_ltv_fir_convolve_kernel(cuda, rows, frame, ir, n):
    """The output and both gradients within 2e-4 of their max |ref| (the
    JAX package's kernel test), against the plain version and autograd
    through it, at the Sins/CombSub shapes (offline and training rows) and
    ragged ones."""
    g = torch.Generator(device=cuda).manual_seed(rows + ir)
    a = _randn(g, rows, frame)
    h = _randn(g, rows, ir, scale=0.02)
    up = _randn(g, rows, n)
    ak, hk = a.clone().requires_grad_(), h.clone().requires_grad_()
    ap, hp = a.clone().requires_grad_(), h.clone().requires_grad_()
    got = K.ltv_fir_convolve(ak, hk, n)
    ref = K.ltv_fir_convolve_plain(ap, hp, n)
    assert ((got - ref).abs().max() <= 2e-4 * ref.abs().max()).item()
    (got * up).sum().backward()
    (ref * up).sum().backward()
    for x, y in ((ak.grad, ap.grad), (hk.grad, hp.grad)):
        assert ((x - y).abs().max() <= 2e-4 * y.abs().max()).item()


@pytest.mark.parametrize("rows,frame,ir,n", [(513, 1024, 510, 2048),
                                            (4152, 1024, 1022, 2048),
                                            (77, 100, 29, 128)])
def test_ltv_fir_convolve_kernel_mixed_scale(cuda, rows, frame, ir, n):
    """a and h rows scaled independently by 10^u, u uniform in [-3, 0]: each
    output row within 2e-4 of its own max |ref| (the JAX package's kernel
    tolerance, per row), the reference the plain version in float64 on the
    CPU. A design that put two signals into one complex transform would
    round the smaller at the larger's scale and fail."""
    g = torch.Generator(device=cuda).manual_seed(rows + frame)

    def scales():
        return 10.0 ** (-3 * torch.rand((rows, 1), generator=g, device=cuda))

    a = _randn(g, rows, frame) * scales()
    h = _randn(g, rows, ir) * scales()
    ref = K.ltv_fir_convolve_plain(a.double().cpu(), h.double().cpu(), n)
    got = K.ltv_fir_convolve(a, h, n).double().cpu()
    err = (got - ref).abs().amax(1) / ref.abs().amax(1)
    assert err.max().item() <= 2e-4, err.max().item()


def test_ltv_fir_convolve_plain_at_training_rows(cuda):
    """The plain version on the card at a training batch's 4152 rows
    against float64 on the CPU: its spectra have real DC and Nyquist bins,
    and irfft_any zeroes their imaginary parts before cuFFT's C2R."""
    g = torch.Generator(device=cuda).manual_seed(2)
    a, h = _randn(g, 4152, 1024), _randn(g, 4152, 1022, scale=0.02)
    got = K.ltv_fir_convolve_plain(a, h, 2048).double().cpu()
    ref = K.ltv_fir_convolve_plain(a.double().cpu(), h.double().cpu(), 2048)
    assert ((got - ref).abs().max() / ref.abs().max()).item() < 2e-5


def test_synths_on_kernels_match_plain(cuda, monkeypatch):
    """Sins and CombSub forwards at 44.1 kHz / block 512 (narrow control
    net) through the oscillator-bank and LTV-FIR kernels against the same
    forwards with both swapped for their plain versions: 1e-4 of max |ref|
    (the kernels' own errors, 2e-4 of max at the convolution, land well
    inside it after the filters' averaging)."""
    from ddsp_svc_tpu_torch.models import synths
    from ddsp_svc_tpu_torch.nn.layers import lecun_init_
    from ddsp_svc_tpu_torch.ops import fft_filter

    g = torch.Generator(device=cuda).manual_seed(4)
    b, frames = 2, 40
    args = (_randn(g, b, frames, 32),
            110 + 300 * torch.rand((b, frames, 1), generator=g, device=cuda),
            torch.rand((b, frames), generator=g, device=cuda),
            torch.tensor([[1], [2]], device=cuda))
    noise = torch.rand((b, frames * 512), generator=g, device=cuda) * 2 - 1
    for model in (synths.Sins(44100, 512, 128, 256, 256, n_unit=32, n_spk=2),
                  synths.CombSub(44100, 512, 256, 512, 256, n_unit=32,
                                 n_spk=2)):
        model = lecun_init_(model, torch.Generator().manual_seed(0)).to(cuda)
        K.reset_launch_counts()
        with torch.no_grad():
            got, _, _ = model(*args, noise=noise, valid_frames=[40, 31])
            counts = K.launch_counts()
            with monkeypatch.context() as mp:
                mp.setattr(synths, "oscillator_bank", K.oscillator_bank_plain)
                mp.setattr(fft_filter, "ltv_fir_convolve",
                           K.ltv_fir_convolve_plain)
                ref, _, _ = model(*args, noise=noise, valid_frames=[40, 31])
        assert counts["ltv_fir_convolve"] > 0
        assert (counts["oscillator_bank"] > 0) == isinstance(model, synths.Sins)
        assert ((got - ref).abs().max() <= 1e-4 * ref.abs().max()).item()


def _trio(g, c, scale=2.0):
    ws = [_randn(g, 3, 2, c, c, k, scale=(scale / (k * c)) ** 0.5)
          for k in (3, 7, 11)]
    return ws, [_randn(g, 3, 2, c, scale=0.01) for _ in range(3)]


@pytest.mark.parametrize("c,t,k", [(64, 700, 3), (32, 1500, 7),
                                   (16, 3000, 11), (8, 5000, 7),
                                   (64, 333, 11)])
def test_resblock_chain_kernel(cuda, c, t, k):
    """atol 1e-4, rtol 1e-4: the JAX package's chain kernel tolerance."""
    g = torch.Generator(device=cuda).manual_seed(c + t + k)
    args = (_randn(g, 2, t, c), _randn(g, 3, 2, c, c, k,
                                       scale=(2.0 / (k * c)) ** 0.5),
            _randn(g, 3, 2, c, scale=0.01), k)
    torch.testing.assert_close(K.fused_resblock_chain(*args),
                               K.resblock_chain_plain(*args), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("k", [3, 7, 11])
def test_resblock_chain_kernel_at_path_shape(cuda, k):
    """One chain (#10) at the enhancer's C = 64 stage of a 512-frame
    segment, T = 65536: atol 1e-4, rtol 1e-4 against the fp32 plain
    version (the JAX package's chain kernel tolerance), and within 4e-6 of
    max |ref| against the plain version in float64, as the wide-range test
    (the kernel reads 6-8e-7, the fp32 cuDNN chain 5-13e-7;
    tools/ab_torch_trio.py). Against the fp32 chain it reads up to 2.3e-5:
    one chain's output is ~3x the trio's (max |ref| 14-16), so the trio's
    absolute 2e-5 does not carry over."""
    g = torch.Generator(device=cuda).manual_seed(k)
    args = (_randn(g, 1, 65536, 64), _randn(g, 3, 2, 64, 64, k,
                                            scale=(2.0 / (k * 64)) ** 0.5),
            _randn(g, 3, 2, 64, scale=0.01), k)
    got, ref = K.fused_resblock_chain(*args), K.resblock_chain_plain(*args)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    ref64 = K.resblock_chain_plain(*(a.double() if torch.is_tensor(a) else a
                                     for a in args))
    err = ((got.double() - ref64).abs().max() / ref64.abs().max()).item()
    assert err <= 4e-6, err


def _stage_args(g, c, t_in, u, s_src, b):
    k = 2 * u
    t_out = (t_in - 1) * u - 2 * ((k - u) // 2) + k
    ksrc = 2 * s_src if s_src > 1 else 1
    ws, bs = _trio(g, c, 1.5)
    return (_randn(g, b, t_in, 2 * c), _randn(g, b, t_out * s_src, 1, scale=0.1),
            _randn(g, 2 * c, c, k, scale=(2.0 / (2 * c * k)) ** 0.5),
            _randn(g, c, scale=0.05), _randn(g, c, 1, ksrc, scale=0.2),
            _randn(g, c, scale=0.05), ws, bs, u, s_src)


@pytest.mark.parametrize("c,t_in,u,s_src,b", [
    (64, 350, 2, 4, 1), (32, 700, 2, 2, 2), (16, 1500, 2, 1, 1),
    (8, 517, 1, 2, 2), (16, 333, 4, 2, 2), (32, 100, 8, 1, 1)])
def test_fused_stage_kernel(cuda, c, t_in, u, s_src, b):
    """atol 2e-4, rtol 2e-4 (the JAX package's stage kernel tolerance) at
    every width and rate the kernel takes, ksrc = 1, u = 1 (T_out = T_in +
    1) and lengths no tile divides."""
    g = torch.Generator(device=cuda).manual_seed(c * t_in + u)
    args = _stage_args(g, c, t_in, u, s_src, b)
    got, ref = K.fused_stage(*args), K.stage_plain(*args)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("c,s_src", [(64, 4), (32, 2), (16, 1)])
def test_fused_stage_kernel_at_path_shape(cuda, c, s_src):
    """The fused stage (#11) at the enhancer's three narrow stages of a
    512-frame segment (u = 2, T_out = 262144 / s_src from x_pre (1, T_out /
    2, 2C), har of 262144 samples): atol 2e-4, rtol 2e-4 (the JAX package's
    stage kernel tolerance) and max |err| at most 2e-5."""
    g = torch.Generator(device=cuda).manual_seed(c)
    args = _stage_args(g, c, 131072 // s_src, 2, s_src, 1)
    got, ref = K.fused_stage(*args), K.stage_plain(*args)
    assert got.shape == ref.shape == (1, 262144 // s_src, c)
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=2e-4)
    assert (got - ref).abs().max().item() <= 2e-5


def _grads_agree(kern, plain, tensors, statics, up):
    """Gradients of sum(up * f(...)) with respect to every tensor argument,
    through the kernel's autograd Function and through autograd of the plain
    version: relative L2 < 2e-2 and cosine > 1 - 1e-4 each (the parity
    bounds of chip_smoke.py)."""
    grads = []
    for fn in (kern, plain):
        xs = [[x.clone().requires_grad_() for x in t] if isinstance(t, list)
              else t.clone().requires_grad_() for t in tensors]
        (fn(*xs, *statics) * up).sum().backward()
        flat = [x for t in xs for x in (t if isinstance(t, list) else [t])]
        grads.append([x.grad.double() for x in flat])
    for gk, gp in zip(*grads):
        rel = ((gk - gp).norm() / gp.norm()).item()
        cos = ((gk * gp).sum() / (gk.norm() * gp.norm())).item()
        assert rel < 2e-2 and cos > 1 - 1e-4, (rel, cos)


def test_resblock_kernels_backward(cuda):
    """The backward of #4 (with the injection), #5 (without), #10 and #11
    through their autograd Functions against autograd of the plain versions;
    the per-row valid form refuses to run with gradients."""
    g = torch.Generator(device=cuda).manual_seed(11)
    c, t, s = 16, 600, 2
    ws, bs = _trio(g, c)
    x, har = _randn(g, 2, t, c), _randn(g, 2, t * s, 1, scale=0.1)
    ncw, ncb = _randn(g, c, 1, 4, scale=0.2), _randn(g, c, scale=0.05)
    up = _randn(g, 2, t, c)
    _grads_agree(K.fused_resblocks_inject, K.resblocks_inject_plain,
                 [x, har, ncw, ncb, ws, bs], (s,), up)
    _grads_agree(K.fused_resblocks, lambda x_, w_, b_: K.resblocks_inject_plain(
        x_, None, None, None, w_, b_, 1), [x, ws, bs], (), up)
    _grads_agree(K.fused_resblock_chain, K.resblock_chain_plain,
                 [x, ws[1], bs[1]], (7,), up)
    args = _stage_args(g, c, t // 2, 2, s, 2)
    _grads_agree(K.fused_stage, K.stage_plain, list(args[:8]), args[8:],
                 _randn(g, 2, t, c))
    with pytest.raises(ValueError, match="inference-only"):
        K.fused_resblocks(x, [w.requires_grad_() for w in ws], bs, valid=300)


def test_generator_forms_on_kernels_match_plain(cuda, monkeypatch):
    """The Generator in each form (stages of 32, 16, 8 channels on the
    kernels) against the same forward with every kernel swapped for its
    plain version: 1e-4 of max |ref|, unbatched and with per-item
    valid_frames (whose tail is exactly 0); each form launches its own
    kernels."""
    from ddsp_svc_tpu_torch.nn import nsf_hifigan
    from ddsp_svc_tpu_torch.nn.layers import lecun_init_

    h = {"sampling_rate": 16000, "num_mels": 16,
         "upsample_rates": [4, 4, 2, 2, 2],
         "upsample_kernel_sizes": [8, 8, 4, 4, 4],
         "upsample_initial_channel": 64, "resblock_kernel_sizes": [3, 7, 11],
         "resblock_dilation_sizes": [[1, 3, 5]] * 3}
    g = torch.Generator(device=cuda).manual_seed(12)
    b, f, lengths = 3, 40, [40, 29, 11]
    mel = _randn(g, b, f, 16)
    f0 = 150 + 100 * torch.rand((b, f), generator=g, device=cuda)
    ri = torch.rand((b, 9), generator=g, device=cuda)
    ri[:, 0] = 0
    plain = dict(harmonic_source=K.harmonic_source_plain,
                 fused_resblocks_inject=K.resblocks_inject_plain,
                 fused_resblocks=lambda x_, w_, b_, d_, valid=None,
                 mxu_bf16=False: K.resblocks_inject_plain(
                     x_, None, None, None, w_, b_, 1, d_, valid, mxu_bf16),
                 fused_stage=K.stage_plain)
    for forms, kernel in (({}, "fused_resblocks_inject"),
                          ({"fused_inject": False}, "fused_resblocks"),
                          ({"fused_stage": True}, "fused_stage")):
        model = lecun_init_(nsf_hifigan.generator_from_h(h, **forms),
                            torch.Generator().manual_seed(0)).to(cuda).eval()
        for valid in (None, torch.tensor(lengths, device=cuda)):
            K.reset_launch_counts()
            with torch.no_grad():
                got = model(mel, f0, ri, valid_frames=valid)
                counts = K.launch_counts()
                with monkeypatch.context() as mp:
                    for name, fn in plain.items():
                        mp.setattr(nsf_hifigan, name, fn)
                    ref = model(mel, f0, ri, valid_frames=valid)
            # under valid_frames the fused stage steps aside for the trio
            want = "fused_resblocks_inject" if (
                kernel == "fused_stage" and valid is not None) else kernel
            assert counts[want] == 3 and counts["harmonic_source"] == 1, counts
            assert ((got - ref).abs().max() <= 1e-4 * ref.abs().max()).item()
            if valid is not None:
                for i, n in enumerate(lengths):
                    assert not got[i, n * 128:].any()


def test_wrappers_count_launches(cuda):
    K.reset_launch_counts()
    g = torch.Generator(device=cuda).manual_seed(0)
    f0 = 100 + 400 * torch.rand((1, 4), generator=g, device=cuda)
    start, rad = _source_phase(f0, 64, 16000, torch.zeros((1, 9), device=cuda), 8)
    w, b = _randn(g, 9), _randn(g, 1)
    K.harmonic_source_plain(start.contiguous(), rad.contiguous(), w, b, 64)
    K.harmonic_source(start.contiguous(), rad.contiguous(), w, b, 64)
    assert K.launch_counts() == {"performer_attention": 0,
                                 "performer_attention_moments": 0,
                                 "performer_attention_apply": 0,
                                 "combsub_spectral": 0,
                                 "harmonic_source": 1,
                                 "fused_resblocks_inject": 0,
                                 "fused_resblocks": 0,
                                 "fused_resblocks_inject_bf16": 0,
                                 "fused_resblocks_bf16": 0,
                                 "dft_magnitude": 0,
                                 "dft_magnitude_bf16": 0,
                                 "combsub_spectral_bwd": 0,
                                 "oscillator_bank": 0,
                                 "ltv_fir_convolve": 0,
                                 "fused_resblock_chain": 0,
                                 "fused_stage": 0,
                                 "performer_attention_mxu_bf16": 0,
                                 "performer_attention_moments_mxu_bf16": 0,
                                 "performer_attention_apply_mxu_bf16": 0,
                                 "combsub_spectral_mxu_bf16": 0,
                                 "combsub_spectral_bwd_mxu_bf16": 0,
                                 "fused_resblocks_inject_mxu_bf16": 0,
                                 "fused_resblocks_mxu_bf16": 0,
                                 "fused_resblock_chain_mxu_bf16": 0,
                                 "fused_stage_mxu_bf16": 0}


def test_staged_bf16_generator_on_card(cuda, monkeypatch):
    """Staged bf16 at threshold 128 (stages of 128 channels in bf16 on
    cuDNN, 64/32/16/8 fp32 on the trio kernel): fp32 output within rel RMS
    2e-2 of the fp32 forward on the same weights (the JAX package's own
    bound), #4 launched once per fp32 stage. At threshold 64 the C = 64
    stage runs the trio's bf16-input form (once) and the full-bf16
    Generator every narrow stage (4): each within rel RMS 2e-2 of the fp32
    forward and 2e-3 of the same form on the plain versions, or, where
    more, twice the plain form's own spread: its distance from itself run
    on the f0 moved by one fp32 ulp (a bf16 Generator turns any fp32
    difference into flipped bf16 roundings downstream; the mel itself is
    cast to bf16 first in full bf16, where a one-ulp move vanishes); with
    fused_resblocks=False, or where the trio would not be chosen, bf16
    stages of <= 64 channels run on cuDNN."""
    from ddsp_svc_tpu_torch.nn import nsf_hifigan
    from ddsp_svc_tpu_torch.nn.layers import lecun_init_

    h = {"sampling_rate": 16000, "num_mels": 16,
         "upsample_rates": [4, 4, 2, 2, 2],
         "upsample_kernel_sizes": [8, 8, 4, 4, 4],
         "upsample_initial_channel": 256, "resblock_kernel_sizes": [3, 7, 11],
         "resblock_dilation_sizes": [[1, 3, 5]] * 3}
    g = torch.Generator(device=cuda).manual_seed(13)
    mel = _randn(g, 1, 40, 16)
    f0 = 150 + 100 * torch.rand((1, 40), generator=g, device=cuda)
    ri = torch.zeros((1, 9), device=cuda)

    def make(hh=h, **kw):
        return lecun_init_(nsf_hifigan.generator_from_h(hh, **kw),
                           torch.Generator().manual_seed(0)).to(cuda).eval()

    with torch.no_grad():
        y32 = make()(mel, f0, ri)
        K.reset_launch_counts()
        y16 = make(bf16_min_channels=128)(mel, f0, ri)
        assert K.launch_counts()["fused_resblocks_inject"] == 4
        assert y16.dtype == torch.float32 and bool(torch.isfinite(y16).all())
        rel = ((y16 - y32).pow(2).mean().sqrt() / y32.pow(2).mean().sqrt()).item()
        assert 1e-5 < rel < 2e-2, rel
        for kw, n_bf16, n_fp32 in (({"bf16_min_channels": 64}, 1, 3),
                                   ({"dtype": torch.bfloat16}, 4, 0)):
            gen = make(**kw)
            K.reset_launch_counts()
            y = gen(mel, f0, ri)
            counts = K.launch_counts()
            assert counts["fused_resblocks_inject_bf16"] == n_bf16, counts
            assert counts["fused_resblocks_inject"] == n_fp32, counts
            assert counts["fused_stage"] == 0, counts
            with monkeypatch.context() as m:
                m.setattr(nsf_hifigan, "fused_resblocks_inject",
                          K.resblocks_inject_plain)
                m.setattr(nsf_hifigan, "harmonic_source",
                          K.harmonic_source_plain)
                y_p = gen(mel, f0, ri)
                y_pp = gen(mel, torch.nextafter(f0, f0 + 1), ri)

            def rel_rms(a, b):
                return ((a - b).pow(2).mean().sqrt()
                        / b.pow(2).mean().sqrt()).item()

            assert y.dtype == torch.float32 and bool(torch.isfinite(y).all())
            assert rel_rms(y, y32) < 2e-2, (kw, rel_rms(y, y32))
            floor = rel_rms(y_pp, y_p)
            assert rel_rms(y, y_p) < max(2e-3, 2 * floor), (
                kw, rel_rms(y, y_p), floor)
        # a bf16 stage never takes the fused stage (#11 is fp32 only)
        K.reset_launch_counts()
        make(bf16_min_channels=64, fused_stage=True)(mel, f0, ri)
        counts = K.launch_counts()
        assert counts["fused_stage"] == 3, counts
        assert counts["fused_resblocks_inject_bf16"] == 1, counts
        y = make(bf16_min_channels=64, fused_resblocks=False)(mel, f0, ri)
        rel = ((y - y32).pow(2).mean().sqrt() / y32.pow(2).mean().sqrt()).item()
        assert rel < 2e-2, rel
        # resblock kernel sizes the trio does not take: no stage would run
        # the kernel, so bf16 stages of <= 64 channels run on cuDNN
        h2 = dict(h, resblock_kernel_sizes=[3, 5, 7])
        y32 = make(h2)(mel, f0, ri)
        y = make(h2, bf16_min_channels=16)(mel, f0, ri)
        rel = ((y - y32).pow(2).mean().sqrt() / y32.pow(2).mean().sqrt()).item()
        assert rel < 2e-2, rel


def test_parselmouth_f0_on_card_matches_cpu(cuda):
    """The autocorrelation family with its candidate stage on the card
    against the same on the CPU: at least 99 % of frames agree on voicing,
    voiced frames within 1 cent."""
    from ddsp_svc_tpu_torch.data.features import F0Extractor

    sr, hop = 44100, 512
    t = np.arange(int(sr * 2.0)) / sr
    inst = 220 * (1 + 0.04 * np.sin(2 * np.pi * 5 * t))
    ph = 2 * np.pi * np.cumsum(inst) / sr
    audio = (0.4 * np.sin(ph) + 0.15 * np.sin(2 * ph)).astype(np.float32)
    audio[int(0.8 * sr):int(1.1 * sr)] = 0.0
    got = F0Extractor("parselmouth", sr, hop, 65, 800, device=cuda).extract(audio)
    ref = F0Extractor("parselmouth", sr, hop, 65, 800, device="cpu").extract(audio)
    same = (got > 0) == (ref > 0)
    assert same.mean() >= 0.99, same.mean()
    v = (got > 0) & (ref > 0)
    assert v.sum() > 0.5 * len(v)
    assert np.abs(1200 * np.log2(got[v] / ref[v])).max() < 1.0


def test_staged_mel_runs_the_dft_kernel(cuda, monkeypatch):
    """The staged-bf16 enhancer's mel (mxu_bf16=True) on the card takes the
    dft_magnitude kernel's bf16-input form, once a call, as JAX's takes
    dft_magnitude_pallas(mxu_bf16=True) on the TPU, and agrees with the
    same bf16 route on the plain version (cuFFT of the bf16-rounded frames)
    at H_NSF's geometry: the linear mel within rel RMS 1e-4. (The route
    rounds the frames to bf16 as JAX's does; tests/test_torch_bf16_forms.py
    holds it to JAX's bf16 route on the CPU.)"""
    from ddsp_svc_tpu_torch.ops import spectral
    from ddsp_svc_tpu_torch.ops.spectral import log_mel_spectrogram

    g = torch.Generator(device=cuda).manual_seed(21)
    t = torch.arange(44100, device=cuda) / 44100
    x = (0.3 * torch.sin(2 * np.pi * 220 * t)
         + 0.01 * _randn(g, 44100))[None].repeat(2, 1)
    geo = (44100, 2048, 512, 2048, 128, 40, 16000)
    K.reset_launch_counts()
    m16 = log_mel_spectrogram(x, *geo, mxu_bf16=True).double()
    assert K.launch_counts()["dft_magnitude_bf16"] == 1
    monkeypatch.setattr(spectral, "dft_magnitude_bf16", K.dft_magnitude_plain)
    m_p = log_mel_spectrogram(x, *geo, mxu_bf16=True).double()
    counts = K.launch_counts()
    assert counts["dft_magnitude_bf16"] == 1 and counts["dft_magnitude"] == 0
    assert m16.shape == m_p.shape
    rel = ((m16.exp() - m_p.exp()).pow(2).mean()
           / m_p.exp().pow(2).mean()).sqrt().item()
    assert rel < 1e-4, rel
    frames = (x[:, :8192].unfold(-1, 2048, 512)
              * torch.hann_window(2048, device=cuda)).reshape(-1, 2048)
    frames = frames.to(torch.bfloat16).contiguous()
    got, ref = K.dft_magnitude(frames, 2048), K.dft_magnitude_plain(frames,
                                                                   2048)
    assert (got - ref).abs().max().item() <= 2e-5 * ref.abs().max().item()


def _plain_swaps():
    """(module, name, plain version) of every kernel the offline path runs."""
    from ddsp_svc_tpu_torch.models import synths
    from ddsp_svc_tpu_torch.nn import nsf_hifigan, pcmer

    return [(pcmer, "performer_attention", K.performer_attention_plain),
            (synths, "combsub_spectral", K.combsub_spectral_plain),
            (nsf_hifigan, "harmonic_source", K.harmonic_source_plain),
            (nsf_hifigan, "fused_resblocks_inject", K.resblocks_inject_plain)]


def test_cli_on_card_matches_plain(cuda, tmp_path, monkeypatch):
    """The CLI on a short 16 kHz wav (crepe f0, enhancer on) on the kernels
    against the same run with every kernel swapped for its plain version
    (the f0 cache shared): 1e-3 of max |ref| (chip_smoke.py's path gate);
    #1, #2, #3 and #4 launched."""
    import json

    import yaml

    from ddsp_svc_tpu_torch.data.wavio import read_wav, write_wav
    from ddsp_svc_tpu_torch.infer import __main__ as cli
    from ddsp_svc_tpu_torch.infer.enhancer import NsfHifiGAN
    from ddsp_svc_tpu_torch.models.factory import build_model
    from ddsp_svc_tpu_torch.nn.hubert import HubertSoft, init_hubert_
    from ddsp_svc_tpu_torch.train.checkpoint import save_checkpoint
    from ddsp_svc_tpu_torch.utils.config import DotDict

    sr = 16000
    sd = init_hubert_(HubertSoft(), torch.Generator().manual_seed(5)).state_dict()
    w = sd.pop("positional_embedding.conv.weight")
    sd["positional_embedding.conv.weight_g"] = w.pow(2).sum((0, 1), keepdim=True).sqrt()
    sd["positional_embedding.conv.weight_v"] = w
    torch.save(sd, tmp_path / "hubert.pt")
    h = {"sampling_rate": sr, "num_mels": 16, "n_fft": 512, "win_size": 512,
         "hop_size": 128, "fmin": 40, "fmax": 8000,
         "upsample_rates": [4, 4, 8], "upsample_kernel_sizes": [8, 8, 16],
         "upsample_initial_channel": 64, "resblock_kernel_sizes": [3, 7, 11],
         "resblock_dilation_sizes": [[1, 3, 5]] * 3}
    nsf = NsfHifiGAN(None, h=h, seed=6, device="cpu")
    torch.save({"generator": nsf.model.state_dict()}, tmp_path / "nsf.pt")
    (tmp_path / "config.json").write_text(json.dumps(h))
    args = {"data": {"sampling_rate": sr, "block_size": 256,
                     "encoder": "hubertsoft", "encoder_sample_rate": 16000,
                     "encoder_hop_size": 320, "encoder_out_channels": 256,
                     "encoder_ckpt": str(tmp_path / "hubert.pt")},
            "model": {"type": "CombSubFast", "n_spk": 2},
            "enhancer": {"type": "nsf-hifigan", "ckpt": str(tmp_path / "nsf.pt")}}
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(args))
    save_checkpoint(str(tmp_path / "model_0.pt"), 0,
                    build_model(DotDict(args), device="cpu", seed=7))
    t = np.arange(int(sr * 1.5)) / sr
    ph = 2 * np.pi * np.cumsum(200 * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))) / sr
    write_wav(str(tmp_path / "in.wav"), (0.4 * np.sin(ph)).astype(np.float32), sr)

    def run(name):
        out = str(tmp_path / name)
        cli.main(["-m", str(tmp_path / "model_0.pt"), "-i",
                  str(tmp_path / "in.wav"), "-o", out, "-pe", "crepe",
                  "-sr", str(sr)])
        return read_wav(out)[0]

    K.reset_launch_counts()
    got = run("kernels.wav")
    counts = K.launch_counts()
    for name in ("performer_attention", "combsub_spectral", "harmonic_source",
                 "fused_resblocks_inject"):
        assert counts[name] > 0, counts
    for mod, name, fn in _plain_swaps():
        monkeypatch.setattr(mod, name, fn)
    ref = run("plain.wav")
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


def test_batched_synth_per_item_lengths(cuda, monkeypatch):
    """The batched bucket synth (the directory path's) on one 128-frame
    bucket of three items of 128, 91 and 33 valid frames at 44.1 kHz /
    block 512: #1 with per-item device lengths and #2 on the kernels
    against the same batch on the plain versions, and each item against its
    own exact-length run on the kernels, 1e-4 of max |ref| on each valid
    prefix; #1 launched 3 times (one a PCmer layer) and #2 once."""
    from ddsp_svc_tpu_torch.models import synths
    from ddsp_svc_tpu_torch.models.factory import (make_batched_synth,
                                                   make_bucketed_synth)
    from ddsp_svc_tpu_torch.nn import pcmer
    from ddsp_svc_tpu_torch.nn.layers import lecun_init_

    model = lecun_init_(synths.CombSubFast(44100, 512, n_unit=64, n_spk=2),
                        torch.Generator().manual_seed(0)).to(cuda).eval()
    rng = np.random.default_rng(3)
    lengths, bucket, block = [128, 91, 33], 128, 512
    b = len(lengths)
    units = rng.standard_normal((b, bucket, 64)).astype(np.float32)
    f0 = (110 + 300 * rng.random((b, bucket, 1))).astype(np.float32)
    vol = rng.random((b, bucket)).astype(np.float32)
    noise = (rng.random((b, bucket * block)) * 2 - 1).astype(np.float32)
    for i, n in enumerate(lengths):
        f0[i, n:] = f0[i, n - 1]
        units[i, n:], vol[i, n:], noise[i, n * block:] = 0, 0, 0
    spk = np.array([[1], [2], [1]], np.int64)
    batched = make_batched_synth(model)
    K.reset_launch_counts()
    got = batched(units, f0, vol, spk, np.array(lengths), noise)
    counts = K.launch_counts()
    assert counts["performer_attention"] == 3, counts
    assert counts["combsub_spectral"] == 1, counts
    single = make_bucketed_synth(model)
    alone = [single(units[i:i + 1, :n], f0[i:i + 1, :n], vol[i:i + 1, :n],
                    spk[i:i + 1], noise=noise[i:i + 1, :n * block])[0]
             for i, n in enumerate(lengths)]
    monkeypatch.setattr(pcmer, "performer_attention", K.performer_attention_plain)
    monkeypatch.setattr(synths, "combsub_spectral", K.combsub_spectral_plain)
    ref = batched(units, f0, vol, spk, np.array(lengths), noise)
    assert torch.isfinite(got).all()
    for i, n in enumerate(lengths):
        for other in (ref[i, :n * block], alone[i]):
            err = (got[i, :n * block] - other).abs().max().item()
            assert err <= 1e-4 * other.abs().max().item(), (i, n, err)


@pytest.mark.parametrize("staged", [0, 128])
def test_enhance_batch_mixed_lengths_on_kernels(cuda, monkeypatch, staged):
    """Enhancer.enhance_batch on items of 128, 91 and 33 frames padded to
    one 128-frame bucket (pad_to) with a generator of 256 initial channels:
    #3, #4 (per-item valid lengths) and, staged at 128 channels, #6 in the
    mel, against the same call on the plain versions. fp32: 1e-4 of max
    |ref| per item; staged (C = 256/128 in bf16): rel RMS 2e-2 per item, the
    JAX package's staged bound, as the kernels' fp32 rounding flips bf16
    roundings. #3 once, #4 once per fp32 stage of <= 64 channels (4), #6's
    bf16-input form once when staged."""
    from ddsp_svc_tpu_torch.infer.enhancer import Enhancer
    from ddsp_svc_tpu_torch.nn import nsf_hifigan
    from ddsp_svc_tpu_torch.ops import spectral

    h = {"sampling_rate": 16000, "num_mels": 32, "n_fft": 512, "win_size": 512,
         "hop_size": 128, "fmin": 40, "fmax": 8000,
         "upsample_rates": [4, 4, 2, 2, 2],
         "upsample_kernel_sizes": [8, 8, 4, 4, 4],
         "upsample_initial_channel": 256, "resblock_kernel_sizes": [3, 7, 11],
         "resblock_dilation_sizes": [[1, 3, 5]] * 3}
    enh = Enhancer("nsf-hifigan", None, h=h, seed=2, device=cuda,
                   bf16_min_channels=staged)
    rng = np.random.default_rng(4)
    lengths, bucket, block = [128, 91, 33], 128, 256
    t = np.arange(bucket * block) / 16000
    audios, f0s = [], []
    for i, n in enumerate(lengths):
        hz = 150.0 + 60 * i
        audios.append(torch.as_tensor(
            (0.3 * np.sin(2 * np.pi * hz * t[:n * block])
             + 0.01 * rng.standard_normal(n * block)).astype(np.float32),
            device=cuda)[None])
        f0s.append(np.full((1, n, 1), hz, np.float32))
    ri = rng.random((3, 9)).astype(np.float32)
    ri[:, 0] = 0

    def run():
        return enh.enhance_batch(audios, 16000, f0s, block, rand_ini=ri,
                                 pad_to=bucket * block)[0]

    K.reset_launch_counts()
    got = run()
    counts = K.launch_counts()
    assert counts["harmonic_source"] == 1, counts
    assert counts["fused_resblocks_inject"] == 4, counts
    assert counts["dft_magnitude_bf16"] == (1 if staged else 0), counts
    monkeypatch.setattr(nsf_hifigan, "harmonic_source", K.harmonic_source_plain)
    monkeypatch.setattr(nsf_hifigan, "fused_resblocks_inject",
                        K.resblocks_inject_plain)
    monkeypatch.setattr(spectral, "dft_magnitude_bf16", K.dft_magnitude_plain)
    ref = run()
    for i, (g_i, r_i) in enumerate(zip(got, ref)):
        assert g_i.shape == r_i.shape and bool(torch.isfinite(g_i).all())
        if staged:
            rel = ((g_i - r_i).pow(2).mean() / r_i.pow(2).mean()).sqrt().item()
            assert rel < 2e-2, (i, rel)
        else:
            err = (g_i - r_i).abs().max().item()
            assert err <= 1e-4 * r_i.abs().max().item(), (i, err)


def test_native_library_on_card_host(cuda):
    """The native NCCF library built and called on the card's host, held
    to tests/test_native.py's bounds (-march=native makes its bits the
    host's): a pure tone within 1 % median, silence unvoiced, volume within
    1e-4 of numpy; F0Extractor('parselmouth', backend='auto') runs it."""
    from ddsp_svc_tpu_torch import native
    from ddsp_svc_tpu_torch.data.features import F0Extractor
    from ddsp_svc_tpu_torch.ops.volume import extract_volume_np

    sr, hop = 44100, 512.0
    t = np.arange(int(sr * 1.5)) / sr
    for hz in (110.0, 220.0, 440.0):
        audio = (0.5 * np.sin(2 * np.pi * hz * t)).astype(np.float32)
        f0 = native.extract_f0_native(audio, sr, hop, 65, 800, 2048)
        mid = f0[6:-6]
        voiced = mid[mid > 0]
        assert len(voiced) > 0.9 * len(mid)
        assert np.median(np.abs(voiced - hz) / hz) < 0.01
        ext = F0Extractor("parselmouth", sr, 512, 65, 800, backend="auto")
        assert np.array_equal(ext.extract(audio), f0)
    assert (native.extract_f0_native(np.zeros(sr, np.float32), sr, hop, 65,
                                      800, 2048) == 0).all()
    noise = np.random.default_rng(0).standard_normal(sr).astype(np.float32)
    for h in (512.0, 185.76):
        np.testing.assert_allclose(native.extract_volume_native(noise, h),
                                   extract_volume_np(noise, h), atol=1e-4)


# ------------------------------------------- streaming and real time ----


def _causal_model(device, n_unit=256):
    """A causal + frame_norm CombSubFast at 16 kHz, block 256, seed 3."""
    from ddsp_svc_tpu_torch.models.factory import build_model
    from ddsp_svc_tpu_torch.utils.config import DotDict

    args = DotDict({"data": {"sampling_rate": 16000, "block_size": 256,
                             "encoder_out_channels": n_unit},
                    "model": {"type": "CombSubFast", "n_spk": 2, "c": True,
                              "frame_norm": True}})
    return build_model(args, device=device, seed=3)


def _causal_inputs(device, f, seed=0):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((1, f, 256)).astype(np.float32),
              (150 + 100 * rng.random((1, f, 1))).astype(np.float32),
              rng.random((1, f)).astype(np.float32),
              np.asarray([[2]], np.int64),
              (rng.random((1, f * 256)) * 2 - 1).astype(np.float32))
    return arrays, [torch.as_tensor(a, device=device) for a in arrays]


def test_causal_forward_on_card(cuda):
    """The causal + frame_norm CombSubFast at infer=True on the card against
    the same weights on the CPU: 1e-3 of max |ref| (chip_smoke.py's path
    gate); the spectral kernel (#2) launched once, the attention kernel
    (#1) never (a causal layer takes the prefix scan, as in JAX)."""
    cpu_model = _causal_model("cpu")
    model = _causal_model(cuda)
    _, host = _causal_inputs("cpu", 100)
    _, dev = _causal_inputs(cuda, 100)
    with torch.no_grad():
        ref = cpu_model(*host[:4], infer=True, noise=host[4])[0]
        K.reset_launch_counts()
        got = model(*dev[:4], infer=True, noise=dev[4])[0]
        counts = K.launch_counts()
    assert counts["combsub_spectral"] == 1, counts
    assert counts["performer_attention"] == 0, counts
    assert (got.cpu() - ref).abs().max() <= 1e-3 * ref.abs().max()


def test_incremental_engine_on_card_matches_batch(cuda):
    """IncrementalCombSubFast on the card over 40 frames and the flush
    against the model's batch forward on the card: 1e-3 of max |ref| (the
    JAX package's bound, tests/test_incremental.py)."""
    from ddsp_svc_tpu_torch.models.incremental import IncrementalCombSubFast

    model = _causal_model(cuda)
    (units, f0, volume, spk, noise), dev = _causal_inputs(cuda, 40, seed=1)
    with torch.no_grad():
        ref = model(*dev[:4], infer=True, noise=dev[4])[0].cpu().numpy()
    shifted = np.zeros_like(noise)
    shifted[:, 256:] = noise[:, :-256]
    eng = IncrementalCombSubFast(model)
    audio, state = eng.process(eng.init_state(spk), units, f0[:, :, 0],
                               volume, shifted)
    tail, _ = eng.flush(state, noise_last=noise[:, -256:])
    assert audio.device == model.unit2ctrl.f0_embed.weight.device
    got = torch.cat([audio, tail], -1).cpu().numpy()[:, 512:]
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


def _stream_exp(tmp_path):
    """A non-causal CombSubFast experiment with HuBERT-soft and NSF-HiFiGAN
    checkpoints (16 kHz, block 256; the enhancer's stages of 32, 16 and 8
    channels all take the trio kernel)."""
    import json

    import yaml

    from ddsp_svc_tpu_torch.infer.enhancer import NsfHifiGAN
    from ddsp_svc_tpu_torch.models.factory import build_model
    from ddsp_svc_tpu_torch.nn.hubert import HubertSoft, init_hubert_
    from ddsp_svc_tpu_torch.train.checkpoint import save_checkpoint
    from ddsp_svc_tpu_torch.utils.config import DotDict

    sd = init_hubert_(HubertSoft(), torch.Generator().manual_seed(5)).state_dict()
    w = sd.pop("positional_embedding.conv.weight")
    sd["positional_embedding.conv.weight_g"] = w.pow(2).sum((0, 1), keepdim=True).sqrt()
    sd["positional_embedding.conv.weight_v"] = w
    torch.save(sd, tmp_path / "hubert.pt")
    h = {"sampling_rate": 16000, "num_mels": 16, "n_fft": 512,
         "win_size": 512, "hop_size": 128, "fmin": 40, "fmax": 8000,
         "upsample_rates": [4, 4, 8], "upsample_kernel_sizes": [8, 8, 16],
         "upsample_initial_channel": 64, "resblock_kernel_sizes": [3, 7, 11],
         "resblock_dilation_sizes": [[1, 3, 5]] * 3}
    nsf = NsfHifiGAN(None, h=h, seed=6, device="cpu")
    torch.save({"generator": nsf.model.state_dict()}, tmp_path / "nsf.pt")
    (tmp_path / "config.json").write_text(json.dumps(h))
    args = {"data": {"sampling_rate": 16000, "block_size": 256,
                     "encoder": "hubertsoft", "encoder_sample_rate": 16000,
                     "encoder_hop_size": 320, "encoder_out_channels": 256,
                     "encoder_ckpt": str(tmp_path / "hubert.pt")},
            "model": {"type": "CombSubFast", "n_spk": 2},
            "enhancer": {"type": "nsf-hifigan",
                         "ckpt": str(tmp_path / "nsf.pt")}}
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(args))
    save_checkpoint(str(tmp_path / "model_0.pt"), 0,
                    build_model(DotDict(args), device="cpu", seed=7))
    t = np.arange(16000 * 2) / 16000
    ph = 2 * np.pi * np.cumsum(200 * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))) / 16000
    return str(tmp_path / "model_0.pt"), (0.4 * np.sin(ph)).astype(np.float32)


def test_sola_window_launches_and_pipeline_on_card(cuda, tmp_path,
                                                   monkeypatch):
    """gui.py's defaults at 16 kHz through StreamingSession on the card,
    enhancer on: #1/#2/#3/#4 launched 3/1/1/3 times a window; each window
    on the kernels against the plain versions within 1e-3 of max |ref|;
    pipeline_depth 1 gives the sequential blocks bit for bit, one block
    late."""
    from ddsp_svc_tpu_torch.infer.streaming import StreamingSession, SvcCore

    path, audio = _stream_exp(tmp_path)
    core = SvcCore(path, device=cuda)
    kw = dict(samplerate=16000, block_time=0.3, crossfade_time=0.04,
              buffer_num=2, pitch_extractor_type="dio",
              enhancer_adaptive_key=0)
    windows = []
    infer = core.infer

    def recording(*a, **k):
        out = infer(*a, **k)
        windows.append(out)
        return out

    def run(depth):
        core._step = 0
        sess = StreamingSession(core, pipeline_depth=depth, **kw)
        bf = sess.block_frame
        outs = [sess.process_block(audio[i * bf:(i + 1) * bf])
                for i in range(len(audio) // bf)]
        return outs + sess.flush()

    monkeypatch.setattr(core, "infer", recording)
    K.reset_launch_counts()
    plain_run = run(0)
    counts = K.launch_counts()
    n = len(windows)
    expect = {"performer_attention": 3, "combsub_spectral": 1,
              "harmonic_source": 1, "fused_resblocks_inject": 3}
    for name, per in expect.items():
        assert counts[name] == per * n, (name, counts)
    got = [w[0] for w in windows]
    windows.clear()
    for mod, name, fn in _plain_swaps():
        monkeypatch.setattr(mod, name, fn)
    run(0)
    for g, (r, _) in zip(got, windows):
        assert np.abs(g - r).max() <= 1e-3 * np.abs(r).max()
    monkeypatch.undo()
    piped = run(1)
    assert len(piped) == len(plain_run) + 1 and not piped[0].any()
    for a, b in zip(plain_run, piped[1:]):
        np.testing.assert_array_equal(a, b)


def test_fused_window_on_card_matches_eager(cuda, tmp_path, monkeypatch):
    """SvcCore(fused_window=True) on the card, gui.py's window at 16 kHz
    with its silence front: one CUDA graph per window shape, captured at
    its first window and replayed for the next; with cuDNN deterministic
    each window within 1e-6 x max|ref| of the eager core's (enhancer on at
    adaptive keys 0 and 2, and off); #1/#2/#3/#4 counted 3/1/1/3 at each
    replay (3/1/0/0 raw); a replay's output survives the next replay; a
    capture that meets a host-to-device copy raises."""
    from ddsp_svc_tpu_torch.infer import window_graph
    from ddsp_svc_tpu_torch.infer.streaming import StreamingSession, SvcCore

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    path, audio = _stream_exp(tmp_path)
    eager = SvcCore(path, device=cuda)
    fused = SvcCore(path, device=cuda, fused_window=True)
    sess = StreamingSession(eager, samplerate=16000, block_time=0.3,
                            crossfade_time=0.04, buffer_num=2)
    n = sess.input_frames
    kw = dict(pitch_extractor_type="dio",
              safe_prefix_pad_length=sess.safe_prefix_pad_length)
    per = {True: {"performer_attention": 3, "combsub_spectral": 1,
                  "harmonic_source": 1, "fused_resblocks_inject": 3},
           False: {"performer_attention": 3, "combsub_spectral": 1,
                   "harmonic_source": 0, "fused_resblocks_inject": 0}}
    for enh, key in ((True, 0), (True, 2), (False, 0)):
        kept = []
        for step in range(3):
            x = audio[step * 4800: step * 4800 + n]
            ref, sr_r = eager.infer(x, 16000, use_enhancer=enh,
                                    enhancer_adaptive_key=key, **kw)
            K.reset_launch_counts()
            got, sr_g = fused.infer(x, 16000, use_enhancer=enh,
                                    enhancer_adaptive_key=key,
                                    materialize=False, **kw)
            counts = K.launch_counts()
            for name, want in per[enh].items():
                assert counts[name] == want, (enh, key, step, counts)
            kept.append((got, ref))
            assert sr_g == sr_r and got.shape == ref.shape
        for got, ref in kept:
            err = np.abs(got.cpu().numpy() - ref).max()
            assert err <= 1e-6 * np.abs(ref).max(), (enh, key, err)
    assert len(fused._windows) == 3
    assert all(p.graph is not None for p in fused._windows.values())

    def with_copy(self, *args):
        out = forward(self, *args)
        return out * torch.tensor(1.0, device=out.device)

    forward = window_graph.WindowProgram.forward
    monkeypatch.setattr(window_graph.WindowProgram, "forward", with_copy)
    fresh = SvcCore(path, device=cuda, fused_window=True)
    with pytest.raises(RuntimeError):
        fresh.infer(audio[:n], 16000, use_enhancer=False, **kw)
    torch.cuda.synchronize()


def test_keyshift_mel_on_card_matches_cpu(cuda):
    """The keyshift/speed mel on the card (cuFFT of the scaled size)
    against the same on the CPU at atol 2e-4, the fp32 mel's bound."""
    from ddsp_svc_tpu_torch.ops.spectral import log_mel_spectrogram

    x = torch.from_numpy((np.random.default_rng(7).standard_normal(
        (2, 44100)) * 0.2).astype(np.float32))
    geo = (44100, 2048, 512, 2048, 128, 40, 16000)
    for keyshift, speed in ((2, 1.0), (-3, 1.0), (0, 1.25)):
        ref = log_mel_spectrogram(x, *geo, keyshift=keyshift, speed=speed)
        got = log_mel_spectrogram(x.to(cuda), *geo, keyshift=keyshift,
                                  speed=speed).cpu()
        torch.testing.assert_close(got, ref, atol=2e-4, rtol=0)


def test_hubert_discrete_on_card_matches_cpu(cuda):
    """HubertDiscrete.units on the card against the CPU on the same seeded
    weights and centres: the ids equal wherever the CPU's nearest centre
    beats the second by more than 1e-5 relative."""
    from ddsp_svc_tpu_torch.nn.hubert import (HubertDiscrete, HubertSoft,
                                              init_hubert_)

    model = init_hubert_(HubertSoft(output_layer=7, proj_dim=None),
                         torch.Generator().manual_seed(3))
    wav = (0.1 * np.random.default_rng(8).standard_normal((1, 32000))
           ).astype(np.float32)
    with torch.no_grad():
        feats = model(torch.from_numpy(wav))[0]
    centers = feats[::2][:40] + 0.3 * torch.randn(
        (40, 768), generator=torch.Generator().manual_seed(4))
    cpu = HubertDiscrete(model, centers.numpy(), device="cpu")
    card = HubertDiscrete(model, centers.numpy(), device=cuda)
    ref, got = cpu.units(wav)[0], card.units(wav)[0].cpu()
    d = ((feats[:, None] - centers[None]) ** 2).sum(-1).sort(1).values
    clear = (d[:, 1] - d[:, 0]) > 1e-5 * d[:, 0]
    assert clear.float().mean() > 0.9
    assert torch.equal(got[clear], ref[clear])


def test_stream_entry_on_card(cuda, tmp_path):
    """python -m ddsp_svc_tpu_torch.stream's main with no --device runs on
    the card: a 2 s wav streamed block by block, written, finite, live."""
    from ddsp_svc_tpu_torch import stream
    from ddsp_svc_tpu_torch.data.wavio import read_wav, write_wav

    path, audio = _stream_exp(tmp_path)
    write_wav(str(tmp_path / "in.wav"), audio, 16000)
    stream.main(["-m", path, "-i", str(tmp_path / "in.wav"), "-o",
                 str(tmp_path / "out.wav"), "-sr", "16000", "-pe", "dio"])
    out, sr = read_wav(str(tmp_path / "out.wav"))
    assert sr == 16000 and out.shape == (6 * 4800,)
    assert np.isfinite(out).all() and np.abs(out).max() > 1e-3


@pytest.mark.parametrize("upp", [512, 64])
@pytest.mark.parametrize("phase_grads", [False, True])
def test_harmonic_source_kernel_backward(cuda, upp, phase_grads):
    """#3 under autograd: the gradients of w and b (and of start and rad
    when asked for) through the kernel against autograd of the plain
    version on the same upstream gradient (the backward replays the plain
    bank: 1e-6 relative); one launch, none in the backward; without grad
    mode the kernel launches with no graph."""
    g = torch.Generator(device=cuda).manual_seed(upp)
    b, f = 2, 17
    f0 = 100 + 300 * torch.rand((b, f), generator=g, device=cuda)
    ri = torch.rand((b, 9), generator=g, device=cuda)
    ri[:, 0] = 0
    start, rad = _source_phase(f0, upp, 44100, ri, 8)
    w = _randn(g, 9)
    bias = _randn(g, 1, scale=0.1)
    g_out = _randn(g, b, f * upp)
    wants = (phase_grads, phase_grads, True, True)

    def grads(fn):
        xs = [x.detach().clone().contiguous().requires_grad_(want)
              for x, want in zip((start, rad, w, bias), wants)]
        out = fn(*xs, upp)
        assert out.grad_fn is not None
        return torch.autograd.grad((out * g_out).sum(),
                                   [x for x in xs if x.requires_grad])

    K.reset_launch_counts()
    got = grads(K.harmonic_source)
    assert K.harmonic_source.launches == 1
    ref = grads(K.harmonic_source_plain)
    assert K.harmonic_source.launches == 1
    assert len(got) == len(ref) == (4 if phase_grads else 2)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-6,
                                   atol=1e-7 * r.abs().max().item())
    with torch.no_grad():
        out = K.harmonic_source(start, rad, w.requires_grad_(), bias, upp)
    assert out.grad_fn is None and K.harmonic_source.launches == 2


# a small enhancer whose four stages (C = 64/32/16/8) all take the trio kernel
GAN_H = {"sampling_rate": 16000, "num_mels": 16, "n_fft": 512,
         "win_size": 512, "hop_size": 64, "fmin": 40, "fmax": 8000,
         "upsample_rates": [4, 4, 2, 2], "upsample_kernel_sizes": [8, 8, 4, 4],
         "upsample_initial_channel": 128, "resblock_kernel_sizes": [3, 7, 11],
         "resblock_dilation_sizes": [[1, 3, 5]] * 3}


def _gan_grads_agree(mk, mp):
    """chip_smoke.py's train-phase bounds: per parameter relative L2 < 2e-2
    and cosine > 1 - 1e-4; a missing gradient fails by name."""
    plain = dict(mp.named_parameters())
    for name, p in mk.named_parameters():
        assert p.grad is not None and plain[name].grad is not None, name
        gk, gp = p.grad.double(), plain[name].grad.double()
        rel = ((gk - gp).norm() / (gp.norm() + 1e-12)).item()
        cos = torch.nn.functional.cosine_similarity(
            gk.flatten(), gp.flatten(), dim=0).item()
        assert rel < 2e-2 and (gp.norm() < 1e-10 or cos > 1 - 1e-4), (
            name, rel, cos)


def test_gan_steps_on_kernels_match_plain(cuda, monkeypatch):
    """One D step and one G step of the GAN trainer on the kernels (#3 once
    and #4 at each of the four stages per generator forward) against the
    same steps with the kernels swapped for their plain versions, from the
    same weights, batch and rand_ini: the losses within 1e-4 relative,
    every gradient (the source merge's included) at the train bounds."""
    from ddsp_svc_tpu_torch.nn import nsf_hifigan
    from ddsp_svc_tpu_torch.nn.layers import lecun_init_
    from ddsp_svc_tpu_torch.train import gan as G

    g = torch.Generator(device=cuda).manual_seed(0)
    t = torch.arange(16 * 64, device=cuda) / 16000
    audio = torch.stack([0.4 * torch.sin(2 * np.pi * 220 * t),
                         0.3 * torch.sin(2 * np.pi * 330 * t)])
    audio = audio + 0.02 * _randn(g, *audio.shape)
    batch = {"audio": audio, "f0": torch.tensor([[220.0] * 16, [330.0] * 16],
                                                device=cuda),
             "mel": G.mel_of(GAN_H, audio).transpose(1, 2)}
    ri = torch.rand((2, 9), generator=g, device=cuda)
    ri[:, 0] = 0
    weights = lecun_init_(nsf_hifigan.generator_from_h(GAN_H),
                          torch.Generator().manual_seed(1)).state_dict()

    def steps():
        out = []
        for phase in ("d", "g"):
            gen = nsf_hifigan.generator_from_h(GAN_H)
            gen.load_state_dict(weights)
            trainer = G.GanTrainer(GAN_H)
            state = trainer.create_state(gen.to(cuda), seed=2)
            step = trainer.step_d if phase == "d" else trainer.step_g
            K.reset_launch_counts()
            logs = step(state, batch, ri)
            out.append((state, logs, K.launch_counts()))
        return out

    kern = steps()
    for _, _, counts in kern:
        assert counts["harmonic_source"] == 1, counts
        assert counts["fused_resblocks_inject"] == 4, counts
        assert sum(counts.values()) == 5, counts
    monkeypatch.setattr(nsf_hifigan, "harmonic_source",
                        K.harmonic_source_plain)
    monkeypatch.setattr(nsf_hifigan, "fused_resblocks_inject",
                        K.resblocks_inject_plain)
    plain = steps()
    for (sk, lk, _), (sp, lp, _) in zip(kern, plain):
        for k, v in lk.items():
            assert abs(float(v) - float(lp[k])) <= 1e-4 * abs(float(lp[k])), k
    _gan_grads_agree(kern[0][0].mpd, plain[0][0].mpd)
    _gan_grads_agree(kern[0][0].msd, plain[0][0].msd)
    _gan_grads_agree(kern[1][0].generator, plain[1][0].generator)
    assert kern[1][0].generator.m_source.l_linear.weight.grad.abs().max() > 0


def test_train_gan_entry_on_card(cuda, tmp_path):
    """python -m ddsp_svc_tpu_torch.train_gan's main with no --device runs
    on the card: 2 steps on a 16 kHz store, a validation, a checkpoint and
    an export; #3 and #4 launched at 1 and 4 a generator forward (two steps
    of D and G, one validation)."""
    import yaml

    from ddsp_svc_tpu_torch import train_gan
    from ddsp_svc_tpu_torch.data.wavio import write_wav

    for split in ("train", "val"):
        for sub in ("audio", "f0"):
            (tmp_path / split / sub / "1").mkdir(parents=True)
        tt = np.arange(16000) / 16000
        write_wav(str(tmp_path / split / "audio" / "1" / "a.wav"),
                  (0.4 * np.sin(2 * np.pi * 220 * tt)).astype(np.float32),
                  16000)
        np.save(str(tmp_path / split / "f0" / "1" / "a.npy"),
                np.full(16000 // 256 + 1, 220.0, np.float32))
    cfg = {"data": {"sampling_rate": 16000, "block_size": 256,
                    "train_path": str(tmp_path / "train"),
                    "valid_path": str(tmp_path / "val")},
           "enhancer": {"type": "nsf-hifigan", "ckpt": None},
           "env": {"expdir": str(tmp_path / "exp")},
           "train": {"seed": 0, "gan": {
               "h": GAN_H, "batch_size": 2, "crop_frames": 16,
               "interval_log": 1, "interval_val": 2,
               "expdir": str(tmp_path / "gan")}}}
    with open(tmp_path / "gan.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    K.reset_launch_counts()
    state, expdir = train_gan.main(["-c", str(tmp_path / "gan.yaml"),
                                    "--max-steps", "2"])
    counts = K.launch_counts()
    assert state.step == 2
    assert next(state.generator.parameters()).is_cuda
    assert (tmp_path / "gan" / "gan_2.pt").is_file()
    assert (tmp_path / "gan" / "enhancer" / "model_best.pt").is_file()
    assert counts["harmonic_source"] == 5 and counts[
        "fused_resblocks_inject"] == 20, counts


# ---------------------------------------------------- the custom ops ----


def _op_cases(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (_randn(g, 2, 8, 40, 64) for _ in range(3))
    split = _randn(g, 2, 40, 8 * 64).reshape(2, 40, 8, 64).transpose(1, 2)
    proj = torch.from_numpy(gaussian_orthogonal_random_matrix(266, 64, 5)).to(dev)
    rows, n = 5, 1024
    spectral = [_randn(g, rows, n) for _ in range(2)] + [
        _randn(g, rows, n // 2 + 1, scale=0.3) for _ in range(3)]
    phase = (2 * torch.rand((2, 4 * 512), generator=g, device=dev) - 1) * np.pi
    amps = 0.1 * torch.rand((2, 4, 128), generator=g, device=dev)
    # (name, op, args, tolerance relative to max |ref|, absolute tolerance):
    # each kernel's card test's (#8: atol 2e-3 at amplitudes <= 0.1)
    return [
        ("performer_attention", K.performer_attention_op,
         (q, k, v, proj, None, 40), 2e-5, 0.0),
        ("performer_attention", K.performer_attention_op,
         (split, split, split, proj, None, 27), 2e-5, 0.0),
        ("performer_attention", K.performer_attention_op,
         (q, k, v, proj, torch.tensor([30, 12], device=dev), 0), 2e-5, 0.0),
        ("combsub_spectral", K.combsub_spectral_op, (*spectral, n), 2e-5,
         0.0),
        ("oscillator_bank", K.oscillator_bank_op, (phase, amps, 512, 32),
         0.0, 2e-3),
        ("ltv_fir_convolve", K.ltv_fir_convolve_op,
         (_randn(g, 6, 1024), _randn(g, 6, 513), 2048), 2e-5, 0.0),
    ]


@pytest.mark.parametrize("case", range(6), ids=[
    "attention", "attention split heads", "attention lengths", "spectral",
    "oscillator bank", "ltv-fir"])
def test_custom_ops_on_card(cuda, case):
    """torch.library.opcheck's schema and fake-tensor checks of each op on
    CUDA tensors; one call launches its kernel once and agrees with the
    plain version (each kernel's card-test tolerance; the attention on the
    valid rows)."""
    name, op, args, tol, atol = _op_cases(cuda)[case]
    torch.library.opcheck(op, args, test_utils=("test_schema",
                                                "test_faketensor"))
    plain = {K.performer_attention_op: lambda q, k, v, p, n, va:
             K.performer_attention_plain(q, k, v, p, va if n is None else n),
             K.combsub_spectral_op: K.combsub_spectral_plain,
             K.oscillator_bank_op: K.oscillator_bank_plain,
             K.ltv_fir_convolve_op: K.ltv_fir_convolve_plain}[op]
    K.reset_launch_counts()
    got = op(*args)
    assert K.launch_counts()[name] == 1
    ref = plain(*args)
    if name == "performer_attention":
        n = args[4].tolist() if args[4] is not None else [args[5]] * 2
        got = torch.cat([got[i, :, :n[i]].flatten() for i in range(2)])
        ref = torch.cat([ref[i, :, :n[i]].flatten() for i in range(2)])
    assert got.is_cuda and got.is_contiguous()
    assert (got - ref).abs().max().item() <= (tol * ref.abs().max().item()
                                              + atol)


def test_exported_combsub_fast_on_card(cuda, tmp_path):
    """A CombSubFast (16 kHz, block 256, n_unit 64) exported on the card,
    saved and loaded: its graph holds 3 performer_attention and 1
    combsub_spectral op nodes, a replay launches #1/#2 3/1 times and
    matches the eager forward within 1e-6 of max |ref|."""
    from ddsp_svc_tpu_torch.export import export_program
    from ddsp_svc_tpu_torch.models.factory import build_model
    from ddsp_svc_tpu_torch.utils.config import DotDict

    args = DotDict({"data": {"sampling_rate": 16000, "block_size": 256,
                             "encoder_out_channels": 64},
                    "model": {"type": "CombSubFast", "n_spk": 2}})
    model = build_model(args, device=cuda, seed=0)
    program = export_program(model, frames=64)
    torch.export.save(program, str(tmp_path / "m.pt2"))
    program = torch.export.load(str(tmp_path / "m.pt2"))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("ddsp_svc.performer_attention.default") == 3
    assert targets.count("ddsp_svc.combsub_spectral.default") == 1
    g = torch.Generator(device=cuda).manual_seed(1)
    x = (_randn(g, 1, 64, 64), 150 + 200 * torch.rand(
        (1, 64, 1), generator=g, device=cuda),
         torch.rand((1, 64), generator=g, device=cuda),
         torch.ones((1, 1), dtype=torch.int64, device=cuda),
         2 * torch.rand((1, 64 * 256), generator=g, device=cuda) - 1)
    with torch.no_grad():
        ref = model(*x[:4], infer=True, noise=x[4])[0]
        K.reset_launch_counts()
        got = program.module()(*x)
    counts = K.launch_counts()
    assert counts["performer_attention"] == 3, counts
    assert counts["combsub_spectral"] == 1, counts
    assert (got - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()


# ------------------------------------------------ the trainer's options ----

TRAIN_SIZES = {"CombSubFast": {},
               "Sins": dict(n_harmonics=32, n_mag_allpass=64, n_mag_noise=64),
               "CombSub": dict(n_mag_allpass=64, n_mag_harmonic=128,
                               n_mag_noise=64)}


def _train_model_args(mtype, bf16):
    from ddsp_svc_tpu_torch.utils.config import DotDict
    return DotDict({
        "data": {"sampling_rate": 16000, "block_size": 256,
                 "encoder_out_channels": 32},
        "model": {"type": mtype, "n_spk": 2, "bf16": bf16,
                  **TRAIN_SIZES[mtype]},
    })


def _train_state(mtype, bf16, cuda):
    from ddsp_svc_tpu_torch.models.factory import build_model
    from ddsp_svc_tpu_torch.train.step import TrainState, create_optimizer
    model = build_model(_train_model_args(mtype, bf16), device=cuda, seed=0)
    return TrainState(0, model, create_optimizer(model, 5e-4, 0.01), seed=3)


def _train_batch(seed, frames=48):
    rng = np.random.default_rng(seed)
    return {"audio": (0.3 * rng.standard_normal((2, frames * 256))
                      ).astype(np.float32),
            "f0": (110 + 330 * rng.random((2, frames, 1))).astype(np.float32),
            "volume": rng.random((2, frames)).astype(np.float32),
            "units": rng.standard_normal((2, frames, 32)).astype(np.float32),
            "spk_id": np.asarray([[1], [2]], np.int64)}


class _PoolDataset:
    """The AudioDataset fields a DevicePool reads: three float16-cached
    files of unequal length, two unit variants."""
    waveform_sec = 0.768
    sample_rate = 16000
    hop_size = 256
    n_aunit = 1

    def __init__(self):
        rng = np.random.default_rng(9)
        self.paths = ["1/a", "1/b", "2/c"]
        self.data_buffer = {}
        for i, (rel, nf) in enumerate(zip(self.paths, (90, 130, 170))):
            self.data_buffer[rel] = {
                "duration": nf * 256 / 16000,
                "f0": 110 + 330 * rng.random((nf, 1)).astype(np.float32),
                "volume": rng.random(nf).astype(np.float32),
                "audio": (0.3 * rng.standard_normal(nf * 256)
                          ).astype(np.float16),
                "units": [rng.standard_normal((nf, 32)).astype(np.float16)
                          for _ in range(2)],
                "spk_id": np.asarray([1 + i // 2], np.int64)}


def _assert_graphed_matches_eager(eager, graphed, le, lg):
    """chip_smoke.py's gate: each step's loss within 1e-5 relative, every
    parameter within 1e-4 x max|param|."""
    assert torch.isfinite(lg).all()
    assert ((lg - le).abs() <= 1e-5 * le.abs()).all(), (lg, le)
    assert graphed.step == eager.step
    for (name, p), q in zip(graphed.model.named_parameters(),
                            eager.model.parameters()):
        assert ((p - q).abs().max() <= 1e-4 * q.abs().max()).item(), name


@pytest.mark.parametrize("mtype,bf16", [("CombSubFast", False),
                                        ("CombSubFast", True),
                                        ("Sins", False), ("CombSub", False)])
def test_graphed_dispatch_matches_eager(cuda, mtype, bf16):
    """A K = 4 dispatch as replays of the captured step (train/graphed.py)
    against 4 eager steps from the same weights, batches and seeds, then a
    second dispatch: the losses and parameters at chip_smoke.py's gate, and
    the replays' launch counts equal to the eager steps' (#6 8 a step at
    n_scale 4; under bf16 #2's and #7's bf16-operand forms once a step;
    Sins #8 once and #9 twice
    a step, CombSub #9 three times)."""
    from ddsp_svc_tpu_torch.models.losses import RSSLoss
    from ddsp_svc_tpu_torch.train.graphed import GraphedTrainSteps
    from ddsp_svc_tpu_torch.train.step import stage, train_steps

    rss = RSSLoss(128, 512, n_scale=4)
    stacks = [stage([_train_batch(4 * d + s) for s in range(4)], cuda)
              for d in range(2)]
    eager = _train_state(mtype, bf16, cuda)
    K.reset_launch_counts()
    le = torch.cat([train_steps(eager, x, rss) for x in stacks])
    counts_e = K.launch_counts()
    graphed = _train_state(mtype, bf16, cuda)
    steps = GraphedTrainSteps(graphed, rss, stacks[0])
    K.reset_launch_counts()
    lg = torch.cat([steps(x) for x in stacks])
    counts_g = K.launch_counts()
    _assert_graphed_matches_eager(eager, graphed, le, lg)
    assert counts_g == counts_e
    spectral = int(bf16 and mtype == "CombSubFast")
    per_step = {"dft_magnitude": 8,
                "combsub_spectral_mxu_bf16": spectral,
                "combsub_spectral_bwd_mxu_bf16": spectral,
                "combsub_spectral": 0, "combsub_spectral_bwd": 0,
                "oscillator_bank": int(mtype == "Sins"),
                "ltv_fir_convolve": {"Sins": 2, "CombSub": 3}.get(mtype, 0)}
    for name, n in per_step.items():
        assert counts_g[name] == 8 * n, (name, counts_g)


def test_graphed_pool_dispatch_matches_eager(cuda):
    """The pool step graphed (the crop gather inside the forward's graph;
    only the (K, B) index arrays cross) against eager pool steps."""
    import random

    from ddsp_svc_tpu_torch.data.device_pool import DevicePool
    from ddsp_svc_tpu_torch.models.losses import RSSLoss
    from ddsp_svc_tpu_torch.train.graphed import GraphedTrainSteps
    from ddsp_svc_tpu_torch.train.step import stage, train_steps

    pool = DevicePool(_PoolDataset(), 256, cuda)
    rng = random.Random(2)
    idx = stage([pool.sample([rng.randrange(3), rng.randrange(3)], rng)
                 for _ in range(4)], cuda)
    rss = RSSLoss(128, 512, n_scale=4)
    eager = _train_state("CombSubFast", True, cuda)
    le = train_steps(eager, idx, rss, pool=pool)
    graphed = _train_state("CombSubFast", True, cuda)
    lg = GraphedTrainSteps(graphed, rss, idx, pool=pool)(idx)
    _assert_graphed_matches_eager(eager, graphed, le, lg)


def test_gather_batch_on_card_matches_cpu(cuda):
    """The pool's crops gathered on the card equal the CPU's bit for bit
    (float16 cache cast to float32)."""
    import random

    from ddsp_svc_tpu_torch.data.device_pool import DevicePool

    ds = _PoolDataset()
    on_card, on_cpu = DevicePool(ds, 256, cuda), DevicePool(ds, 256, "cpu")
    idx = on_cpu.sample([0, 2, 1, 2], random.Random(1))
    got = on_card.gather({k: torch.from_numpy(v).to(cuda)
                          for k, v in idx.items()})
    ref = on_cpu.gather({k: torch.from_numpy(v) for k, v in idx.items()})
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k].cpu(), v), k


TRAIN_OPTION_SETS = {"k4": {"steps_per_dispatch": 4},
                     "pool": {"data_on_device": True},
                     "remat": {"remat": True},
                     "async": {"async_save": True},
                     "all": {"steps_per_dispatch": 4, "data_on_device": True,
                             "remat": True, "async_save": True}}


@pytest.mark.parametrize("options", list(TRAIN_OPTION_SETS))
@pytest.mark.parametrize("mtype,bf16", [("CombSubFast", False),
                                        ("CombSubFast", True),
                                        ("Sins", False), ("CombSub", False)])
def test_train_entry_options_on_card(cuda, tmp_path, mtype, bf16, options):
    """python -m ddsp_svc_tpu_torch.train's main on the card with each
    option alone and all four together, for each synthesizer (CombSubFast
    also bf16): 8 steps with a validation and checkpoints at step 8, finite
    losses, and a second run that resumes from model_8.pt."""
    import yaml

    from ddsp_svc_tpu_torch.data.wavio import write_wav
    from ddsp_svc_tpu_torch.train import __main__ as train_main

    rng = np.random.default_rng(0)
    for split, n in (("train", 3), ("val", 1)):
        for i in range(n):
            spk = 1 + i % 2
            for sub in ("audio", "units", "f0", "volume"):
                (tmp_path / split / sub / str(spk)).mkdir(parents=True,
                                                          exist_ok=True)
            t = 24000
            write_wav(str(tmp_path / split / "audio" / str(spk) / f"u{i}.wav"),
                      (0.3 * np.sin(2 * np.pi * 220 * np.arange(t) / 16000)
                       ).astype(np.float32), 16000)
            nf = t // 256 + 1
            for sub, arr in (("units", rng.standard_normal((nf, 32))),
                             ("f0", np.full(nf, 220.0)),
                             ("volume", np.full(nf, 0.2))):
                name = f"u{i}.0.npy" if sub == "units" else f"u{i}.npy"
                np.save(str(tmp_path / split / sub / str(spk) / name),
                        arr.astype(np.float32))
    cfg = dict(_train_model_args(mtype, bf16))
    cfg["data"].update(train_path=str(tmp_path / "train"),
                       valid_path=str(tmp_path / "val"), duration=1.0,
                       n_aunit=0)
    cfg.update(loss={"fft_min": 128, "fft_max": 512, "n_scale": 4},
               env={"expdir": str(tmp_path / "exp")},
               train={"batch_size": 2, "cache_all_data": True,
                      "cache_fp16": True, "epochs": 100, "interval_log": 4,
                      "interval_val": 8, "lr": 5e-4, "weight_decay": 0.0,
                      "seed": 0, **TRAIN_OPTION_SETS[options]})
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    state, saver = train_main.main(["-c", str(path), "--max-steps", "8"])
    assert state.step == saver.global_step == 8
    assert next(state.model.parameters()).is_cuda
    assert (tmp_path / "exp" / "model_8.pt").is_file()
    log = (tmp_path / "exp" / "log_values.jsonl").read_text()
    assert '"validation/loss"' in log and "NaN" not in log
    state2, saver2 = train_main.main(["-c", str(path), "--max-steps", "4"])
    assert state2.step == saver2.global_step == 12


def test_capture_with_host_copy_raises(cuda, monkeypatch):
    """A step that copies from pageable host memory while it runs (here the
    loss window built from numpy on every call, as before the windows were
    cached) cannot be captured: building the graphed step raises, and
    nothing falls back to eager steps."""
    from ddsp_svc_tpu_torch.models.losses import RSSLoss
    from ddsp_svc_tpu_torch.ops import spectral
    from ddsp_svc_tpu_torch.train import graphed as G
    from ddsp_svc_tpu_torch.train.step import stage

    monkeypatch.setattr(spectral, "hann_window", lambda n, dtype, device:
                        torch.as_tensor(np.hanning(n + 1)[:n], dtype=dtype,
                                        device=device))
    state = _train_state("CombSubFast", False, cuda)
    x = stage([_train_batch(0)], cuda)
    with pytest.raises(RuntimeError):
        G.GraphedTrainSteps(state, RSSLoss(128, 512, n_scale=4), x)
    torch.cuda.synchronize()


# ------------------------------------------- the bf16-operand forms ---
# Each form's kernel against its plain form on the same inputs: max |err|
# <= 2^-8 x max |ref| and rel RMS <= 1e-3 (the same bf16 rounding points;
# only the order of fp32 sums differs, and a bf16 rounding it flips), and
# against float64 (the plain form evaluated in float64 with the same bf16
# roundings) within the same bounds. A flipped rounding of a dominant
# feature moves an attention output by up to 2^-8 of itself, so the
# largest error of either fp32 side against float64 is a draw of a few
# flips: on the card the kernel read 2.2e-3 x max|ref| where the plain
# form read 3.6e-4 (B = 1, T = 512, bf16 q, k, v), so "twice the plain
# form's error" is no gate here; the bounds are the forms' own.
# The conv core's chains are 18 convs deep, and each flipped rounding of a
# conv input moves its outputs by 2^-9 of a product, which flips more
# downstream: at the path's shapes kernel and plain part by up to 9.5e-4
# rel RMS on fp32 output (the stage at C = 64), so its gate is 2e-3; on a
# bf16 output each of the two rounds the result once more, and a flipped
# output rounding is one bf16 ulp (2^-8..2^-7 of the value): max 2^-7.
MXU_MAX, MXU_REL_RMS = 2.0 ** -8, 1e-3
MXU_CONV_REL_RMS, MXU_BF16_OUT_MAX = 2e-3, 2.0 ** -7


def _assert_mxu_close(got, ref, f64=None, rel_rms=MXU_REL_RMS):
    bf16_out = got.dtype == torch.bfloat16
    got, ref = got.float(), ref.float()
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    rel = ((got - ref).pow(2).mean() / ref.pow(2).mean()).sqrt().item()
    limit = MXU_BF16_OUT_MAX if bf16_out else MXU_MAX
    assert err <= limit * scale and rel <= rel_rms, (err / scale, rel)
    if f64 is not None:
        d = got.double() - f64
        e_kern = d.abs().max().item() / f64.abs().max().item()
        rel = (d.pow(2).mean() / f64.pow(2).mean()).sqrt().item()
        assert e_kern <= limit and rel <= rel_rms, (e_kern, rel)


def _f64(args):
    return [[y.double() for y in a] if isinstance(a, list)
            else a.double() if torch.is_tensor(a) else a for a in args]


def _only(counts, name, n=1):
    assert counts[name] == n and sum(counts.values()) == n, counts


@pytest.mark.parametrize("c,t,s_src,valid,x,har", [
    (64, 700, 4, None, "fp32", "fp32"), (32, 1500, 2, [1400, 600], "fp32",
                                         "fp32"),
    (16, 3000, 1, None, "bf16", "fp32"), (8, 5000, 1, 4000, "bf16", "bf16"),
    (64, 333, 1, None, "fp32", None), (64, 2000, 4, None, "bf16", None),
    (64, 65536, 8, None, "fp32", "fp32")])
def test_resblocks_mxu_bf16_kernel(cuda, c, t, s_src, valid, x, har):
    """The trio's bf16-operand form (#4, #5) on fp32 and bf16 x, fp32 and
    bf16 har, with and without the injection and valid lengths, against its
    plain form: the bounds above (float64 on fp32 x), the tail past a row's
    length exactly 0, one launch counted on the form and none elsewhere."""
    g = torch.Generator(device=cuda).manual_seed(c * t + 7)
    ksrc = 2 * s_src if s_src > 1 else 1
    ws, bs = _trio(g, c)
    h = None if har is None else _randn(g, 2, t * s_src, 1, scale=0.1)
    if har == "bf16":
        h = h.to(torch.bfloat16)
    xx = _randn(g, 2, t, c)
    if x == "bf16":
        xx = xx.to(torch.bfloat16)
    args = (xx, h, _randn(g, c, 1, ksrc, scale=0.2), _randn(g, c, scale=0.05),
            ws, bs, s_src)
    with torch.no_grad():
        ref = K.resblocks_inject_plain(*args, valid=valid, mxu_bf16=True)
        f64 = (K.resblocks_inject_plain(*_f64(args), valid=valid,
                                        mxu_bf16=True)
               if x == "fp32" else None)
        K.reset_launch_counts()
        got = K.fused_resblocks_inject(*args, valid=valid, mxu_bf16=True)
        counts = K.launch_counts()
    _only(counts, "fused_resblocks_mxu_bf16" if har is None
          else "fused_resblocks_inject_mxu_bf16")
    assert got.dtype == xx.dtype and got.shape == xx.shape
    _assert_mxu_close(got, ref, f64, MXU_CONV_REL_RMS)
    if valid is not None:
        for i, n in enumerate(np.broadcast_to(valid, (2,))):
            assert not got[i, n:].any()


@pytest.mark.parametrize("c,t,k", [(64, 700, 3), (32, 1500, 7),
                                   (16, 3000, 11), (8, 4000, 7)])
def test_resblock_chain_mxu_bf16_kernel(cuda, c, t, k):
    """#10's bf16-operand form against its plain form."""
    g = torch.Generator(device=cuda).manual_seed(c + t + k)
    ws, bs = _trio(g, c)
    w, b = ws[(3, 7, 11).index(k)], bs[0]
    x = _randn(g, 2, t, c)
    ref = K.resblock_chain_plain(x, w, b, k, mxu_bf16=True)
    f64 = K.resblock_chain_plain(x.double(), w.double(), b.double(), k,
                                 mxu_bf16=True)
    K.reset_launch_counts()
    got = K.fused_resblock_chain(x, w, b, k, mxu_bf16=True)
    _only(K.launch_counts(), "fused_resblock_chain_mxu_bf16")
    _assert_mxu_close(got, ref, f64, MXU_CONV_REL_RMS)


@pytest.mark.parametrize("c,t_in,u,s_src,b", [
    (64, 350, 2, 4, 1), (32, 700, 2, 2, 2), (16, 333, 4, 2, 2),
    (8, 517, 1, 2, 2), (32, 100, 8, 1, 1)])
def test_fused_stage_mxu_bf16_kernel(cuda, c, t_in, u, s_src, b):
    """#11's bf16-operand form (the transposed conv fp32) against its plain
    form."""
    g = torch.Generator(device=cuda).manual_seed(c * t_in + u)
    args = _stage_args(g, c, t_in, u, s_src, b)
    ref = K.stage_plain(*args, mxu_bf16=True)
    f64 = K.stage_plain(*_f64(args), mxu_bf16=True)
    K.reset_launch_counts()
    got = K.fused_stage(*args, mxu_bf16=True)
    _only(K.launch_counts(), "fused_stage_mxu_bf16")
    _assert_mxu_close(got, ref, f64, MXU_CONV_REL_RMS)


def test_mxu_bf16_kernels_backward(cuda):
    """The conv core's forms are differentiable as the fp32 forms are: the
    backward replays the fp32 plain version (JAX's VJPs re-run their fp32
    references), so a form's gradient equals the fp32 form's, bit for bit
    with cuDNN's deterministic algorithms."""
    g = torch.Generator(device=cuda).manual_seed(5)
    ws, bs = _trio(g, 16)
    x = _randn(g, 1, 900, 16).requires_grad_()
    har = _randn(g, 1, 1800, 1, scale=0.1)
    nw, nb = _randn(g, 16, 1, 4, scale=0.2), _randn(g, 16, scale=0.05)
    up = _randn(g, 1, 900, 16)
    grads = []
    for mxu in (True, False):
        x.grad = None
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            (K.fused_resblocks_inject(x, har, nw, nb, ws, bs, 2,
                                      mxu_bf16=mxu) * up).sum().backward()
        grads.append(x.grad.clone())
    torch.testing.assert_close(grads[0], grads[1], atol=0, rtol=0)


@pytest.mark.parametrize("b,t,valid,dtype", [
    (1, 512, 384, "bf16"), (16, 512, None, "bf16"), (2, 1000, [999, 3], "fp32"),
    (2, 64, [0, 64], "bf16"), (3, 100, None, "fp32")])
def test_performer_attention_mxu_bf16_kernel(cuda, b, t, valid, dtype):
    """#1's bf16-operand form on bf16 (the PCmer's) or fp32 q, k, v against
    its plain form, each row's valid prefix; then its split (moments of two
    key ranges of each row's valid keys summed, the apply) against the
    single launch at the same bounds (the two sum the context in other
    orders before rounding it), each counted on its own form."""
    q, k, v, proj = _attention_case(cuda, b, t)
    if dtype == "bf16":
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    vf = valid if valid is None or isinstance(valid, int) \
        else torch.tensor(valid, device=cuda)
    ref = K.performer_attention_plain(q, k, v, proj, vf, mxu_bf16=True)
    f64 = K.performer_attention_plain(q.double(), k.double(), v.double(),
                                      proj.double(), vf, mxu_bf16=True)
    K.reset_launch_counts()
    got = K.performer_attention(q, k, v, proj, vf, mxu_bf16=True)
    _only(K.launch_counts(), "performer_attention_mxu_bf16")
    assert got.dtype == torch.float32
    n = [t] * b if valid is None else np.minimum(np.broadcast_to(valid, (b,)), t)
    rows = [i for i in range(b) if n[i] > 0]
    pick = (lambda y: torch.cat([y[i, :, :n[i]].flatten() for i in rows]))
    _assert_mxu_close(pick(got), pick(ref), pick(f64))
    hi = [min(int(x), t) for x in n]
    mid = [min(t // 3, x) for x in hi]
    parts = [K.performer_attention_moments(
        k, v, proj, torch.tensor(a, device=cuda),
        torch.tensor(z, device=cuda), mxu_bf16=True)
        for a, z in (([0] * b, mid), (mid, hi))]
    split = K.performer_attention_apply(q, proj, parts[0][0] + parts[1][0],
                                        parts[0][1] + parts[1][1],
                                        mxu_bf16=True)
    counts = K.launch_counts()
    assert counts["performer_attention_moments_mxu_bf16"] == 2
    assert counts["performer_attention_apply_mxu_bf16"] == 1
    assert counts["performer_attention_moments"] == 0
    assert counts["performer_attention_apply"] == 0
    _assert_mxu_close(pick(split), pick(got))


@pytest.mark.parametrize("n_fft,rows", [(64, 37), (512, 300), (1024, 513),
                                        (4096, 9)])
def test_combsub_spectral_mxu_bf16_kernels(cuda, n_fft, rows):
    """#2's and #7's bf16-operand forms (the frames, and g * window,
    rounded on load) against their plain forms: 2e-5 of max |ref| (the fp32
    forms' card tolerance: the transforms stay fp32), each gradient apart;
    each counted on its form."""
    g = torch.Generator(device=cuda).manual_seed(n_fft + rows)
    win = K.combsub_window(n_fft, cuda)
    bins = n_fft // 2 + 1
    args = (_randn(g, rows, n_fft) * win, _randn(g, rows, n_fft) * win,
            _randn(g, rows, bins, scale=0.5, shift=-1.0),
            _randn(g, rows, bins), _randn(g, rows, bins, scale=0.5))
    gg = _randn(g, rows, n_fft, scale=1e-3)
    ref = K.combsub_spectral_plain(*args, n_fft, mxu_bf16=True)
    refs = K.combsub_spectral_bwd_plain(gg, *args, n_fft, mxu_bf16=True)
    K.reset_launch_counts()
    got = K.combsub_spectral(*args, n_fft, mxu_bf16=True)
    gots = K.combsub_spectral_bwd(gg, *args, n_fft, mxu_bf16=True)
    counts = K.launch_counts()
    assert counts["combsub_spectral_mxu_bf16"] == 1
    assert counts["combsub_spectral_bwd_mxu_bf16"] == 1
    assert sum(counts.values()) == 2, counts
    for a, r in ((got, ref), *zip(gots, refs)):
        assert (a - r).abs().max().item() <= 2e-5 * r.abs().max().item()
    # the forms differ from the fp32 forms by the rounding of their inputs
    fp32 = K.combsub_spectral(*args, n_fft)
    assert (fp32 - got).abs().max().item() > 1e-5 * ref.abs().max().item()


def test_combsub_spectral_mxu_bf16_autograd(cuda):
    """Through combsub_spectral(mxu_bf16=True) with gradients wanted: the
    forward's form and then the adjoint's form, one launch each."""
    g = torch.Generator(device=cuda).manual_seed(3)
    n = 1024
    win = K.combsub_window(n, cuda)
    tooth = _randn(g, 65, n) * win
    noise = _randn(g, 65, n) * win
    ctl = [_randn(g, 65, n // 2 + 1, scale=0.3).requires_grad_()
           for _ in range(3)]
    K.reset_launch_counts()
    out = K.combsub_spectral(tooth, noise, *ctl, n, mxu_bf16=True)
    (out * _randn(g, 65, n)).sum().backward()
    counts = K.launch_counts()
    assert counts["combsub_spectral_mxu_bf16"] == 1
    assert counts["combsub_spectral_bwd_mxu_bf16"] == 1
    assert sum(counts.values()) == 2, counts


def test_custom_ops_mxu_bf16_on_card(cuda):
    """The attention and spectral ops' bf16-operand forms under
    torch.library.opcheck (schema and fake tensors) on CUDA tensors, bf16
    q, k, v for the attention."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (_randn(g, 2, 8, 40, 64).to(torch.bfloat16) for _ in range(3))
    proj = torch.from_numpy(gaussian_orthogonal_random_matrix(266, 64, 5)).to(
        cuda)
    rows, n = 5, 1024
    spectral = [_randn(g, rows, n) for _ in range(2)] + [
        _randn(g, rows, n // 2 + 1, scale=0.3) for _ in range(3)]
    for op, args in ((K.performer_attention_op,
                      (q, k, v, proj, torch.tensor([30, 12], device=cuda), 0,
                       True)),
                     (K.combsub_spectral_op, (*spectral, n, True))):
        torch.library.opcheck(op, args, test_utils=("test_schema",
                                                    "test_faketensor"))
