"""PyTorch port, time-parallel conversion (`ddsp_svc_tpu_torch/parallel/`)
on the CPU: ranks spawned as fresh processes (tests/torch_parallel_worker.py)
joined over Gloo at world sizes 2 and 4, against the port's unsharded
forwards and the JAX package's time-parallel paths on the 8-device CPU mesh
(its synthesizer FFTs as DFT matmuls there, `spectral.set_fft_mode("dft")`,
restored after). Weights from seeds, carried across by the JAX package's
converters and back by `utils/convert.py`; the noise and SineGen phases
are the same numpy draws on both sides. test_parallel.py's small
CombSubFast (16 kHz, block 256, 64 units) and `ENH_H`."""
import json
import pathlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import yaml

from ddsp_svc_tpu.infer.enhancer import Enhancer as JEnhancer
from ddsp_svc_tpu.infer.enhancer import NsfHifiGAN as JNsfHifiGAN
from ddsp_svc_tpu.models import CombSubFast as JCombSubFast
from ddsp_svc_tpu.ops import spectral as jspectral
from ddsp_svc_tpu.parallel import make_mesh as jmake_mesh
from ddsp_svc_tpu.parallel.timeparallel import (
    make_time_parallel_enhancer as jmake_time_parallel_enhancer,
    make_time_parallel_forward as jmake_time_parallel_forward)
from ddsp_svc_tpu.utils import convert as jconvert
from ddsp_svc_tpu_torch.infer.enhancer import Enhancer, NsfHifiGAN
from ddsp_svc_tpu_torch.models.factory import build_model, make_bucketed_synth
from ddsp_svc_tpu_torch.nn.pcmer import SelfAttention
from ddsp_svc_tpu_torch.ops import kernels as K
from ddsp_svc_tpu_torch.parallel import (Mesh, TimeShard, init_distributed,
                                         make_mesh, make_time_parallel_forward,
                                         time_span)
from ddsp_svc_tpu_torch.train.checkpoint import save_checkpoint
from ddsp_svc_tpu_torch.utils.config import DotDict, load_config
from ddsp_svc_tpu_torch.utils.convert import jax_nsf_to_torch, jax_synth_to_torch
from torch_parallel_worker import start_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
SR, BLOCK, N_UNIT, N_SPK = 16000, 256, 64, 4
WORLDS = (2, 4)
SIZES = {"CombSubFast": {},
         "Sins": dict(n_harmonics=32, n_mag_allpass=64, n_mag_noise=64),
         "CombSub": dict(n_mag_allpass=64, n_mag_harmonic=128, n_mag_noise=64)}
# tests/test_parallel.py's enhancer geometry
ENH_H = {
    "sampling_rate": 16000, "num_mels": 8, "n_fft": 128, "win_size": 128,
    "hop_size": 32, "fmin": 40, "fmax": 8000,
    "upsample_rates": [4, 4, 2], "upsample_kernel_sizes": [8, 8, 4],
    "upsample_initial_channel": 16, "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5]] * 3,
}
# chip_smoke.py's 44.1 kHz NSF-HiFiGAN
H_NSF = dict(ENH_H, sampling_rate=44100, num_mels=128, n_fft=2048,
             win_size=2048, hop_size=512, fmax=16000,
             upsample_rates=[8, 8, 2, 2, 2],
             upsample_kernel_sizes=[16, 16, 4, 4, 4],
             upsample_initial_channel=512)
# 256 frames: at 4 ranks each window (owned +- 49 frames for CombSubFast,
# +- 27 mel frames for ENH_H) is cut at both ends but for the outer ranks;
# JAX's mesh takes 8 shards of 32
FRAMES, VALID = 256, 150
# enhance against the JAX Enhancer, relative to max |ref|: the port's bound
# for the whole chain (tests/test_torch_enhancer.py::ENHANCE_TOL)
ENHANCE_TOL = 2e-3
SVC_INFER = dict(spk_id=2, pitch_extractor_type="dio", threshold_db=-60.0,
                 enhancer_adaptive_key=0)


def _args(mtype):
    return {"data": {"sampling_rate": SR, "block_size": BLOCK,
                     "encoder_out_channels": N_UNIT},
            "model": {"type": mtype, "n_spk": N_SPK, **SIZES[mtype]}}


def _synth_inputs(rng, f):
    return dict(
        units=rng.standard_normal((1, f, N_UNIT)).astype(np.float32),
        f0=(200 * rng.random((1, f, 1)) + 80).astype(np.float32),
        volume=rng.random((1, f)).astype(np.float32),
        spk_id=np.ones((1, 1), np.int64),
        noise=(rng.random((1, f * BLOCK)) * 2 - 1).astype(np.float32))


def _torch(kw):
    return {k: torch.as_tensor(v) for k, v in kw.items()}


def _sung(seconds, seed=0):
    """A sung-like line with a breath in the middle."""
    rng = np.random.default_rng(seed)
    t = np.arange(round(SR * seconds)) / SR
    f0 = 190.0 * 2 ** (np.floor(t * 3) % 4 / 12)
    ph = 2 * np.pi * np.cumsum(f0) / SR
    x = 0.4 * np.sin(ph) + 0.15 * np.sin(2 * ph)
    x[(t > 0.55 * t[-1]) & (t < 0.65 * t[-1])] = 0.0
    return (x + 1e-3 * rng.standard_normal(len(t))).astype(np.float32)


def _rel(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def _svc_experiment(root: pathlib.Path) -> str:
    """config.yaml + model_0.pt (CombSubFast, HuBERT-soft units from seeded
    weights) and an ENH_H NSF-HiFiGAN checkpoint."""
    nsf = NsfHifiGAN(None, h=ENH_H, seed=9, device="cpu")
    (root / "nsf").mkdir()
    torch.save({"generator": nsf.model.state_dict()}, root / "nsf" / "model")
    (root / "nsf" / "config.json").write_text(json.dumps(ENH_H))
    args = {"data": {"sampling_rate": SR, "block_size": BLOCK,
                     "encoder": "hubertsoft", "encoder_ckpt": None,
                     "encoder_sample_rate": 16000, "encoder_hop_size": 320,
                     "encoder_out_channels": 256},
            "model": {"type": "CombSubFast", "n_spk": 2},
            "enhancer": {"type": "nsf-hifigan",
                         "ckpt": str(root / "nsf" / "model"),
                         "bf16_min_channels": 0}}
    (root / "exp").mkdir()
    (root / "exp" / "config.yaml").write_text(yaml.safe_dump(args))
    path = str(root / "exp" / "model_0.pt")
    save_checkpoint(path, 0, build_model(DotDict(args), device="cpu", seed=8))
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every sharded case run at world sizes 2 and 4 (both started at once),
    with the unsharded and JAX references made meanwhile."""
    root = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(7)
    jobs, refs = [], {}

    # CombSubFast: weights carried JAX -> port; Sins and CombSub port-only
    fast = build_model(DotDict(_args("CombSubFast")), device="cpu", seed=1)
    jvars = jconvert.convert_synth_state_dict(
        {k: v.numpy() for k, v in fast.state_dict().items()}, num_layers=3)
    fast.load_state_dict(jax_synth_to_torch(jvars))
    models = {"CombSubFast": fast}
    for mtype in ("Sins", "CombSub"):
        models[mtype] = build_model(DotDict(_args(mtype)), device="cpu", seed=2)
    inputs = _synth_inputs(rng, FRAMES)
    for mtype, model in models.items():
        kw = dict(args=_args(mtype), state=model.state_dict(), **_torch(inputs))
        t = _torch(inputs)
        with torch.no_grad():
            refs[mtype] = model(t["units"], t["f0"], t["volume"], t["spk_id"],
                                noise=t["noise"])[0]
            refs[mtype + "/valid"] = model(
                t["units"], t["f0"], t["volume"], t["spk_id"], noise=t["noise"],
                valid_frames=VALID)[0][:, :VALID * BLOCK]
        jobs += [(mtype, "synth_forward", kw),
                 (mtype + "/valid", "synth_forward",
                  dict(kw, valid_frames=VALID))]

    # the bucketed synth: a 24-frame segment in the 32-frame bucket
    seg = _synth_inputs(rng, 24)
    run = make_bucketed_synth(fast)
    refs["bucket/noise"] = run(**seg)
    seg_kw = {k: v for k, v in seg.items() if k != "noise"}
    refs["bucket/generator"] = run(**seg_kw,
                                   generator=torch.Generator().manual_seed(5))
    kw = dict(args=_args("CombSubFast"), state=fast.state_dict(), **seg_kw)
    jobs += [("bucket/noise", "bucketed", dict(kw, noise=seg["noise"])),
             ("bucket/generator", "bucketed", dict(kw, seed=5))]

    # the enhancer: weights carried JAX -> port
    nsf = NsfHifiGAN(None, h=ENH_H, seed=3, device="cpu")
    jnsf_vars = jconvert.convert_nsf_hifigan_state_dict(
        {k: v.numpy() for k, v in nsf.model.state_dict().items()}, ENH_H)
    nsf.model.load_state_dict(jax_nsf_to_torch(jnsf_vars["params"], ENH_H))
    audio = (0.1 * rng.standard_normal((1, FRAMES * ENH_H["hop_size"]))
             ).astype(np.float32)
    f0_frames = (200 + 50 * rng.random((1, FRAMES))).astype(np.float32)
    ri = rng.random((1, 9)).astype(np.float32)
    ri[:, 0] = 0.0
    enh_in = dict(audio=audio, f0_frames=f0_frames, rand_ini=ri)
    refs["enhancer"] = nsf(*(torch.as_tensor(x) for x in enh_in.values()))[0]
    jobs.append(("enhancer", "enhancer_forward",
                 dict(h=ENH_H, state=nsf.model.state_dict(), **_torch(enh_in))))
    long_audio = (0.1 * rng.standard_normal((1, 64 * 256))).astype(np.float32)
    long_f0 = (220.0 + 30.0 * rng.random((1, 65, 1))).astype(np.float32)
    enh = Enhancer("nsf-hifigan", None, h=ENH_H, device="cpu")
    enh.enhancer.model.load_state_dict(nsf.model.state_dict())
    enhance_in = dict(sample_rate=SR, f0=long_f0, hop_size=256, rand_ini=ri)
    refs["enhance"] = enh.enhance(torch.as_tensor(long_audio), **enhance_in)[0]
    jobs.append(("enhance", "enhance", dict(
        h=ENH_H, state=nsf.model.state_dict(),
        audio=torch.as_tensor(long_audio), **enhance_in)))

    # SvcCore on one window (its unsharded reference run by rank 0)
    model_path = _svc_experiment(root)
    jobs.append(("svc", "svc_window", dict(
        model_path=model_path, audio=_sung(3.0), sample_rate=SR,
        infer_kw=SVC_INFER)))

    ranks = {w: start_ranks(jobs, w, str(root / f"w{w}")) for w in WORLDS}

    # the JAX package's time-parallel paths on its 8-device CPU mesh
    mesh = jmake_mesh(n_data=8, n_model=1)
    jfast = JCombSubFast(sampling_rate=SR, block_size=BLOCK, n_unit=N_UNIT,
                         n_spk=N_SPK)
    jnsf = JNsfHifiGAN(None, h=ENH_H, variables=jnsf_vars)
    try:
        fwd = jmake_time_parallel_forward(jfast, jvars, mesh, axis="data")
        refs["jax/CombSubFast"] = np.asarray(fwd(
            *(jnp.asarray(inputs[k]) for k in
              ("units", "f0", "volume", "spk_id", "noise"))))
        refs["jax/enhancer"] = np.asarray(jmake_time_parallel_enhancer(
            jnsf, mesh)(*(jnp.asarray(x) for x in enh_in.values())))
    finally:
        jspectral.set_fft_mode("fft")
    refs["jax/enhance"] = np.asarray(JEnhancer(
        "nsf-hifigan", None, h=ENH_H, variables=jnsf_vars).enhance(
        long_audio, SR, long_f0, 256, adaptive_key=0, rand_ini=ri)[0])

    results = {w: r.wait() for w, r in ranks.items()}
    yield refs, results
    shutil.rmtree(root, ignore_errors=True)


def _same_on_every_rank(results, name, key=None):
    def pick(rank):
        got = rank[name] if key is None else rank[name][key]
        return torch.as_tensor(got)

    for rank in results[1:]:
        assert torch.equal(pick(rank), pick(results[0]))
    return pick(results[0])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_combsubfast_matches_unsharded_and_jax(runs, world):
    """(a) CombSubFast's frames over 2 or 4 Gloo ranks: every rank returns
    the whole signal, within 1e-4 of max |ref| of the port's unsharded
    forward and within JAX's own 3e-3 of its time-parallel forward on 8
    devices (fft as DFT); also with 150 valid frames of 256."""
    refs, results = runs
    got = _same_on_every_rank(results[world], "CombSubFast")
    assert got.shape == refs["CombSubFast"].shape == (1, FRAMES * BLOCK)
    assert _rel(got, refs["CombSubFast"]) < 1e-4
    assert _rel(got, refs["jax/CombSubFast"]) < 3e-3
    got = _same_on_every_rank(results[world], "CombSubFast/valid")
    assert _rel(got[:, :VALID * BLOCK], refs["CombSubFast/valid"]) < 1e-4


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mtype", ["Sins", "CombSub"])
def test_sharded_sins_and_combsub_match_unsharded(runs, world, mtype):
    """(b) Sins (#8, #9 on the card) and CombSub (#9) sharded, at their own
    length and with 150 valid frames of 256 (at 4 ranks the last owns no
    valid frame): within 1e-4 of max |ref| of the port's unsharded forward
    (their LTV-FIR filters widen the radius)."""
    refs, results = runs
    got = _same_on_every_rank(results[world], mtype)
    assert _rel(got, refs[mtype]) < 1e-4
    got = _same_on_every_rank(results[world], mtype + "/valid")
    assert _rel(got[:, :VALID * BLOCK], refs[mtype + "/valid"]) < 1e-4


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("noise", ["noise", "generator"])
def test_bucketed_synth_on_mesh(runs, world, noise):
    """(c) make_bucketed_synth(mesh=) on a 24-frame segment in the 32-frame
    bucket (valid_frames 24, the padding masked), its noise injected or
    drawn over the bucket from a generator seeded alike on every rank:
    within 1e-4 of max |ref| of the unsharded bucketed synth, cropped to
    24 frames."""
    refs, results = runs
    got = _same_on_every_rank(results[world], f"bucket/{noise}")
    ref = refs[f"bucket/{noise}"]
    assert got.shape == ref.shape == (1, 24 * BLOCK)
    assert _rel(got, ref) < 1e-4


@pytest.mark.parametrize("world", WORLDS)
def test_time_parallel_enhancer_matches_jax(runs, world):
    """(d) NsfHifiGAN(mesh=) (make_time_parallel_enhancer: 256 mel frames,
    the mel cut from the whole signal's reflect padding, the source phase
    from the whole f0) against JAX's time-parallel enhancer on 8 devices at
    JAX's 1e-4 of max |ref|. Enhancer(mesh=).enhance (resampled to the
    adaptive rate and back) against JAX's Enhancer.enhance within
    ENHANCE_TOL, the port's enhance-vs-JAX bound
    (tests/test_torch_enhancer.py): the port's unsharded enhance reads the
    same distance from JAX's (framework rounding of the resampled chain,
    above JAX's 1e-4), so it is held no tighter. Each within 1e-5 of the
    port's unsharded one."""
    refs, results = runs
    got = _same_on_every_rank(results[world], "enhancer")
    assert got.shape == refs["jax/enhancer"].shape
    assert _rel(got, refs["jax/enhancer"]) < 1e-4
    assert _rel(got, refs["enhancer"]) < 1e-5
    got = _same_on_every_rank(results[world], "enhance")
    assert got.shape == refs["jax/enhance"].shape
    assert _rel(got, refs["jax/enhance"]) < ENHANCE_TOL
    assert _rel(got, refs["enhance"]) < 1e-5


@pytest.mark.parametrize("world", WORLDS)
def test_svc_core_on_mesh_matches_unsharded(runs, world):
    """(e) SvcCore(mesh=).infer on a 3 s window (dio f0, HuBERT-soft units,
    188 frames in the 256-frame bucket, the enhancer on, noise and SineGen
    phases from the step's generator on every rank) against
    SvcCore().infer: within 1e-4 of max |ref|, the same length."""
    _, results = runs
    got = _same_on_every_rank(results[world], "svc", "mesh")
    ref = results[world][0]["svc"]["ref"]
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert _rel(got, ref) < 1e-4


@pytest.mark.parametrize("cuts", [(0, 100), (0, 50, 100), (0, 7, 33, 64, 100),
                                  (0, 1, 2, 99, 100)])
def test_moments_apply_over_shards_match_plain(cuts):
    """(f) The plain moments summed over shards' key ranges (70 valid keys
    of 100; one row of a batch with 0 valid), then the plain apply, against
    performer_attention_plain: within 2e-5 of max |ref| (the JAX package's
    kernel tolerance); a row with no valid key gives zeros."""
    g = torch.Generator().manual_seed(len(cuts))
    q, k, v = (torch.randn((2, 8, 100, 64), generator=g) for _ in range(3))
    proj = SelfAttention(256).fast_attention.projection_matrix
    valid = torch.tensor([70, 0])
    ref = K.performer_attention_plain(q, k, v, proj, valid)
    parts = [K.performer_attention_moments_plain(
        k, v, proj, lo, torch.clamp(valid, max=hi)) for lo, hi in
        zip(cuts, cuts[1:])]
    got = K.performer_attention_apply_plain(
        q, proj, *(sum(p[i] for p in parts) for i in range(2)))
    assert (got[0, :, :70] - ref[0, :, :70]).abs().max() \
        <= 2e-5 * ref[0, :, :70].abs().max()
    assert not got[1].any() and not ref[1].any()


def test_receptive_radius_of_the_default_models():
    """R from the modules: configs/combsub.yaml's control net reaches 47
    frames (the prenet's two k3 convs, 2, and three k31 depthwise convs,
    45), the synth 2 more (the 50 %-overlap frames and the lerped f0);
    H_NSF's generator 15 mel frames (the C = 256 stage's trio, 60 samples
    at rate 8, the most)."""
    model = build_model(load_config(str(ROOT / "configs" / "combsub.yaml")),
                        device="cpu")
    assert model.unit2ctrl.receptive_radius() == 47
    assert model.receptive_radius() == 49
    nsf = NsfHifiGAN(None, h=H_NSF, device="cpu")
    assert nsf.model.receptive_radius() == 15


@pytest.mark.parametrize("n", [1, 7, 32, 64, 1121])
@pytest.mark.parametrize("parts", [1, 2, 3, 4])
def test_time_span_covers_each_frame_once(n, parts):
    """The owned spans cut [0, n) into contiguous parts, in order; each
    window is its span widened by the radius, clipped to [0, n)."""
    spans = [time_span(n, parts, i, 5) for i in range(parts)]
    assert spans[0][2] == 0 and spans[-1][3] == n
    for (lo, hi, own_lo, own_hi), nxt in zip(spans, spans[1:] + [None]):
        assert lo == max(0, own_lo - 5) and hi == min(n, own_hi + 5)
        if nxt is not None:
            assert own_hi == nxt[2]
        assert own_hi - own_lo in (n // parts, -(-n // parts))


def test_time_shard_ranges_and_masks():
    """A window [10, 40) owning [15, 35): its owned keys in window frames,
    cut at the valid length (an int, or a (B,) tensor per item), and the
    owned mask."""
    shard = TimeShard(None, 10, 40, 15, 35)
    assert shard.key_range() == (5, 25)
    assert shard.key_range(20) == (5, 20)
    assert shard.key_range(-3) == (5, -3)
    lo, hi = shard.key_range(torch.tensor([30, 12]))
    assert lo == 5 and hi.tolist() == [25, 12]
    m = shard.owned_mask(30, torch.tensor([30, 12]), torch.float32)
    assert m.shape == (2, 30)
    assert m[0].nonzero().flatten().tolist() == list(range(5, 25))
    assert m[1].nonzero().flatten().tolist() == list(range(5, 12))


def test_world_size_one_in_process_matches_unsharded():
    """init_distributed with no coordinator (one process, an in-process
    store) and make_mesh(device='cpu'): the time-parallel forward at world
    size 1 (one window, every collective a no-op sum) equals the unsharded
    forward to rounding."""
    model = build_model(DotDict(_args("CombSubFast")), device="cpu", seed=4)
    t = _torch(_synth_inputs(np.random.default_rng(3), 40))
    init_distributed(backend="gloo", device="cpu")
    try:
        mesh = make_mesh(device="cpu")
        assert (mesh.size("data"), mesh.size("model")) == (1, 1)
        assert mesh.index("data") == 0 and mesh.group("data") is None
        got = make_time_parallel_forward(model, mesh)(
            t["units"], t["f0"], t["volume"], t["spk_id"], t["noise"])
    finally:
        dist.destroy_process_group()
    with torch.no_grad():
        ref = model(t["units"], t["f0"], t["volume"], t["spk_id"],
                    noise=t["noise"])[0]
    assert _rel(got, ref) < 1e-5


def test_mesh_arguments_raise():
    """NCCL is for CUDA only; make_mesh needs a process group; a bucketed
    synth's mesh axis is a power of two and draws its noise only from a
    generator (or takes it injected), so that ranks agree; a causal layer
    on a shard starts from the carry its shard gives (zeros on the first
    rank, where it is the unsharded attention)."""
    with pytest.raises(ValueError, match="CUDA"):
        init_distributed(backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed(num_processes=2, backend="gloo", device="cpu")
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(device="cpu")
    model = build_model(DotDict(_args("CombSubFast")), device="cpu")

    def mesh(n):
        return Mesh({"data": n, "model": 1}, {"data": 0, "model": 0},
                    {"data": None, "model": None}, torch.device("cpu"))

    with pytest.raises(ValueError, match="power of two"):
        make_bucketed_synth(model, mesh=mesh(3))
    seg = _synth_inputs(np.random.default_rng(0), 8)
    seg.pop("noise")
    with pytest.raises(ValueError, match="generator"):
        make_bucketed_synth(model, mesh=mesh(2))(**seg)

    class FirstRank(TimeShard):  # nothing before it on its axis
        def carry(self, *tensors):
            return tuple(torch.zeros_like(t) for t in tensors)

    attn = SelfAttention(256, causal=True)
    x = torch.randn((1, 8, 256), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(attn(x, shard=FirstRank(None, 0, 8, 0, 8)),
                           attn(x))
