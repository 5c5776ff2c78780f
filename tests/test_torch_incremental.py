"""PyTorch port, the causal models and the exact incremental engine against
the JAX package on the CPU: `FrameGroupNorm`, `causal_linear_attention`
(forward in fp32 and bf16, and its gradient), the causal + frame_norm
CombSubFast and the causal Sins and CombSub forwards, the state-carrying
`IncrementalCombSubFast` (against the JAX engine state by state, against
the port's batch forward, chunked against one pass), `IncrementalSession`
against the JAX session on one wav, and a causal + frame_norm checkpoint
that loads, streams and trains. 16 kHz, block 256, tiny widths; weights
from seeds, the JAX modules given the same weights by the JAX package's
own converter."""
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from ddsp_svc_tpu.data.features import UnitsEncoder as JUnitsEncoder
from ddsp_svc_tpu.infer.realtime import IncrementalSession as JSession
from ddsp_svc_tpu.models.incremental import IncrementalCombSubFast as JEngine
from ddsp_svc_tpu.models.synths import CombSub as JCombSub
from ddsp_svc_tpu.models.synths import CombSubFast as JCombSubFast
from ddsp_svc_tpu.models.synths import Sins as JSins
from ddsp_svc_tpu.nn import layers as jlayers
from ddsp_svc_tpu.nn import pcmer as jpcmer
from ddsp_svc_tpu.utils import convert as jconvert
from ddsp_svc_tpu_torch.data.features import UnitsEncoder
from ddsp_svc_tpu_torch.data.wavio import write_wav
from ddsp_svc_tpu_torch.infer.realtime import IncrementalSession
from ddsp_svc_tpu_torch.models.factory import build_model, load_model
from ddsp_svc_tpu_torch.models.incremental import IncrementalCombSubFast
from ddsp_svc_tpu_torch.nn.hubert import HubertSoft, init_hubert_
from ddsp_svc_tpu_torch.nn.layers import FrameGroupNorm
from ddsp_svc_tpu_torch.nn.pcmer import causal_linear_attention
from ddsp_svc_tpu_torch.train import __main__ as train_main
from ddsp_svc_tpu_torch.train.checkpoint import save_checkpoint
from ddsp_svc_tpu_torch.utils.config import DotDict
from torch_tmp import tmp_path  # noqa: F401  (removed when each test ends)

torch.set_num_threads(2)

SR, BLOCK, N_UNIT, N_SPK = 16000, 256, 64, 4
SIZES = {"CombSubFast": dict(frame_norm=True),
         "Sins": dict(n_harmonics=32, n_mag_allpass=64, n_mag_noise=64),
         "CombSub": dict(n_mag_allpass=64, n_mag_harmonic=128,
                         n_mag_noise=64)}
JAX_MODELS = {"CombSubFast": JCombSubFast, "Sins": JSins,
              "CombSub": JCombSub}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _args(mtype, **model):
    return DotDict({
        "data": {"sampling_rate": SR, "block_size": BLOCK,
                 "encoder_out_channels": N_UNIT},
        "model": {"type": mtype, "n_spk": N_SPK, "c": True,
                  **SIZES[mtype], **model},
    })


def _pair(mtype, seed=0):
    """The port's causal model from build_model, the JAX model and its
    variables holding the same weights."""
    tm = build_model(_args(mtype), device="cpu", seed=seed)
    variables = jconvert.convert_synth_state_dict(
        {k: v.numpy().copy() for k, v in tm.state_dict().items()},
        num_layers=3)
    jm = JAX_MODELS[mtype](sampling_rate=SR, block_size=BLOCK, n_unit=N_UNIT,
                           n_spk=N_SPK, causal=True, **SIZES[mtype])
    return tm, jm, variables


@pytest.fixture(scope="module")
def fast_pair():
    return _pair("CombSubFast")


def _inputs(seed, f, unvoiced=False):
    rng = np.random.default_rng(seed)
    units = rng.standard_normal((1, f, N_UNIT)).astype(np.float32)
    f0 = (150 + 100 * rng.random((1, f, 1))).astype(np.float32)
    if unvoiced:
        f0[:, f // 3: f // 3 + 3] = 0.0
    volume = rng.random((1, f)).astype(np.float32)
    spk = np.asarray([[2]], np.int64)
    noise = (rng.random((1, f * BLOCK)) * 2 - 1).astype(np.float32)
    return units, f0, volume, spk, noise


# ------------------------------------------------- FrameGroupNorm ----


def test_frame_group_norm_matches_jax():
    """(2, 300, 64) at 4 groups against the flax FrameGroupNorm on the same
    scale and bias: fp32 within 1e-5 relative (one mean and variance over
    16 values a frame); valid_frames changes nothing."""
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((2, 300, 64)) + 1).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    ref = jlayers.FrameGroupNorm(4).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    norm = FrameGroupNorm(4, 64)
    with torch.no_grad():
        norm.weight.copy_(_t(scale))
        norm.bias.copy_(_t(bias))
        got = norm(_t(x))
        masked = norm(_t(x), valid_frames=[120, 7])
    assert _rel(got, ref) < 1e-5
    assert torch.equal(got, masked)


# ------------------------------------------ causal linear attention ----


def _attention_inputs(seed, t=300, m=24, d=16):
    """Positive FAVOR+-like features q, k (1, 2, T, m) and values v; T = 300
    leaves a padded third chunk of 128."""
    rng = np.random.default_rng(seed)
    q = np.exp(0.3 * rng.standard_normal((1, 2, t, m))).astype(np.float32)
    k = np.exp(0.3 * rng.standard_normal((1, 2, t, m))).astype(np.float32)
    v = rng.standard_normal((1, 2, t, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_linear_attention_matches_jax(dtype):
    """Chunks of 128 with a padded tail, the fp32 carry. fp32 within 1e-5
    relative (the prefix sums run in the same chunk order). bf16 inputs,
    each side's products rounded to bf16 (8 bits) by its own backend: 2e-2
    relative, a few bf16 ulps of the normalised output."""
    q, k, v = _attention_inputs(1)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    ref = jpcmer.causal_linear_attention(
        *(jnp.asarray(a, dtype=jdt) for a in (q, k, v)))
    got = causal_linear_attention(*(_t(a).to(tdt) for a in (q, k, v)))
    assert got.dtype == tdt and got.shape == ref.shape
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    assert _rel(got, ref) < (1e-5 if dtype == "float32" else 2e-2)
    # causality: the first 200 outputs ignore what comes after
    short = causal_linear_attention(*(_t(a[:, :, :200]).to(tdt)
                                      for a in (q, k, v)))
    np.testing.assert_array_equal(short.float().numpy(), got[:, :, :200])


def test_causal_linear_attention_grad_matches_jax():
    """The gradient of sum(w * out) in q, k and v against jax.grad, each
    within 1e-4 of its max |ref| (the causal model trains with it); finite,
    the padded tail of the last chunk included."""
    q, k, v = _attention_inputs(2)
    w = np.random.default_rng(3).standard_normal(
        (1, 2, 300, 16)).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jpcmer.causal_linear_attention(q, k, v) * w)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    (causal_linear_attention(tq, tk, tv) * _t(w)).sum().backward()
    for got, r in zip((tq.grad, tk.grad, tv.grad), ref):
        assert torch.isfinite(got).all()
        assert _rel(got, r) < 1e-4


# ------------------------------------------------ causal models ----


@pytest.mark.parametrize("mtype", ["CombSubFast", "Sins", "CombSub"])
def test_causal_synth_matches_jax(mtype):
    """Forwards with `causal` (and frame_norm for CombSubFast) at infer=True
    and in training, with injected noise, against the JAX model on the same
    weights: 1e-4 of max |ref|, the synth tests' tolerance
    (tests/test_torch_models.py, tests/test_torch_synths.py)."""
    tm, jm, variables = _pair(mtype, seed=1)
    units, f0, volume, spk, noise = _inputs(4, 40, unvoiced=True)
    for infer in (True, False):
        ref = jax.jit(lambda v, *a: jm.apply(
            v, *a, infer=infer, noise=jnp.asarray(noise))[0])(
                variables, *(jnp.asarray(a) for a in (units, f0, volume, spk)))
        with torch.no_grad():
            got = tm(*(_t(a) for a in (units, f0, volume, spk)), infer=infer,
                     noise=_t(noise))[0]
        assert got.shape == ref.shape and torch.isfinite(got).all()
        assert _rel(got, ref) < 1e-4, (mtype, infer, _rel(got, ref))


def test_non_incremental_models_are_refused():
    """The engine takes causal + frame_norm CombSubFast models only."""
    for model in (build_model(_args("CombSubFast", c=False), device="cpu"),
                  build_model(_args("CombSubFast", frame_norm=False),
                              device="cpu")):
        with pytest.raises(ValueError, match="frame_norm"):
            IncrementalCombSubFast(model)


# -------------------------------------------- the incremental engine ----


def _stream_noise(noise):
    """Frame j carries interval j-1's noise: the batch noise one block late."""
    shifted = np.zeros_like(noise)
    shifted[:, BLOCK:] = noise[:, :-BLOCK]
    return shifted


def test_incremental_matches_jax_engine(fast_pair):
    """process over 24 frames, then flush, against the JAX engine on the
    same weights and noise, state by state. The control network's states
    (prenet tails, attention moments, conv tails, the control vector)
    within 1e-4 relative; the rotation carry within 1e-5 of a turn. The
    audio within 1e-3 of max |ref|, the JAX engine's own bound against its
    batch forward: the JAX engine takes each interval's rotation as an fp32
    cumsum of the f0 steps, the port's as the batch forward's closed form on
    an exact double-single carry; the JAX carry's rounding moves it by a
    few 1e-6 of a turn and the sinc comb by ~100x that (ROADMAP.md queue
    3)."""
    tm, jm, variables = fast_pair
    units, f0, volume, spk, noise = _inputs(0, 24)
    sn = _stream_noise(noise)
    jeng = JEngine(jm, variables)
    jstate = jeng.init_state(spk, batch=1)
    jaudio, jstate = jeng.process(jstate, *(jnp.asarray(a) for a in (
        units, f0[:, :, 0], volume, sn)))
    jtail, jstate2 = jeng.flush(jstate, noise_last=jnp.asarray(
        noise[:, -BLOCK:]))
    eng = IncrementalCombSubFast(tm)
    state = eng.init_state(spk, batch=1)
    audio, state = eng.process(state, units, f0[:, :, 0], volume, sn)
    tail, state2 = eng.flush(state, noise_last=noise[:, -BLOCK:])
    scale = np.abs(np.asarray(jaudio)).max()
    assert np.abs(audio.numpy() - np.asarray(jaudio)).max() < 1e-3 * scale
    assert np.abs(tail.numpy() - np.asarray(jtail)).max() < 1e-3 * scale
    for st, jst in ((state, jstate), (state2, jstate2)):
        assert st.frame_idx == int(jst.frame_idx)
        pairs = [(st.prenet0_tail, jst.prenet0_tail),
                 (st.prenet1_tail, jst.prenet1_tail),
                 (st.prev_ctrl, jst.prev_ctrl), (st.prev_f0, jst.prev_f0),
                 (st.spk_embed, jst.spk_embed)]
        for ls, jls in zip(st.layers, jst.layers):
            pairs += [(ls.attn_s, jls.attn_s), (ls.attn_ksum, jls.attn_ksum),
                      (ls.conv_tail, jls.conv_tail)]
        for got, ref in pairs:
            assert _rel(got, ref) < 1e-4
        rot = (st.rot_hi.numpy() + st.rot_lo.numpy()
               - np.asarray(jst.rot_hi) - np.asarray(jst.rot_lo))
        assert np.abs(rot - np.round(rot)).max() < 1e-5, rot


def test_incremental_matches_batch(fast_pair):
    """The engine's stream (2 frames late, flushed) against the port's batch
    forward of the same model at infer=True: 1e-3 of max |ref|, the JAX
    package's bound (tests/test_incremental.py)."""
    tm, _, _ = fast_pair
    units, f0, volume, spk, noise = _inputs(1, 24, unvoiced=True)
    with torch.no_grad():
        ref = tm(*(_t(a) for a in (units, f0, volume, spk)), infer=True,
                 noise=_t(noise))[0].numpy()
    eng = IncrementalCombSubFast(tm)
    state = eng.init_state(spk, batch=1)
    audio, state = eng.process(state, units, f0[:, :, 0], volume,
                               _stream_noise(noise))
    tail, _ = eng.flush(state, noise_last=noise[:, -BLOCK:])
    got = np.concatenate([audio.numpy(), tail.numpy()], -1)[:, 2 * BLOCK:]
    assert got.shape == ref.shape
    assert _rel(got, ref) < 1e-3


def test_incremental_chunked_equals_single_pass(fast_pair):
    """Three chunks of frames give the one pass's stream, atol 1e-5 (the
    JAX package's bound; here the same operations in the same order)."""
    tm, _, _ = fast_pair
    units, f0, volume, spk, noise = _inputs(2, 24)
    sn = _stream_noise(noise)
    eng = IncrementalCombSubFast(tm)
    full, _ = eng.process(eng.init_state(spk), units, f0[:, :, 0], volume, sn)
    state, parts = eng.init_state(spk), []
    for lo, hi in ((0, 8), (8, 16), (16, 24)):
        blk, state = eng.process(state, units[:, lo:hi], f0[:, lo:hi, 0],
                                 volume[:, lo:hi], sn[:, lo * BLOCK:hi * BLOCK])
        parts.append(blk)
    np.testing.assert_allclose(torch.cat(parts, -1).numpy(), full.numpy(),
                               atol=1e-5)


# ------------------------------------------------ IncrementalSession ----


@pytest.fixture(scope="module")
def hubert_ckpt(tmp_path_factory):
    """A HuBERT-soft checkpoint (bshall layout) from a seed; the JAX
    package's UnitsEncoder reads the same file."""
    root = tmp_path_factory.mktemp("inc_hubert")
    sd = init_hubert_(HubertSoft(), torch.Generator().manual_seed(5)).state_dict()
    w = sd.pop("positional_embedding.conv.weight")
    sd["positional_embedding.conv.weight_g"] = torch.sqrt(
        (w ** 2).sum(dim=(0, 1), keepdim=True))
    sd["positional_embedding.conv.weight_v"] = w
    path = root / "hubert-soft.pt"
    torch.save(sd, path)
    yield str(path)
    shutil.rmtree(root, ignore_errors=True)


def _hubert_pair(hubert_ckpt):
    """A 256-unit causal + frame_norm CombSubFast (the encoder's width) and
    its JAX twin."""
    tm = build_model(DotDict({**_args("CombSubFast"), "data": {
        **_args("CombSubFast")["data"], "encoder_out_channels": 256}}),
        device="cpu", seed=2)
    variables = jconvert.convert_synth_state_dict(
        {k: v.numpy().copy() for k, v in tm.state_dict().items()},
        num_layers=3)
    jm = JCombSubFast(sampling_rate=SR, block_size=BLOCK, n_unit=256,
                      n_spk=N_SPK, causal=True, frame_norm=True)
    return tm, jm, variables


def _sung(n_samples, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / SR
    ph = 2 * np.pi * np.cumsum(220 * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))) / SR
    audio = 0.4 * np.sin(ph) + 0.1 * np.sin(2 * ph)
    audio[int(0.6 * len(t)):int(0.7 * len(t))] = 0.0  # a silence
    return (audio + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


FPB = 8  # frames a block of the session tests


def test_incremental_session_matches_jax(hubert_ckpt):
    """Six blocks of 8 frames and the flush, against the JAX session on the
    same wav, weights and HuBERT-soft file. What each session feeds its
    engine agrees: the dio f0, the volume, the noise (numpy, seed 7) and the
    mask bit for bit, the units within 2e-4 of max |ref| (the CLI's
    tolerance, tests/test_torch_cli.py). The JAX session's features through
    the port's engine, times its mask, give the port session's stream within
    2e-4 of max |ref|. The two streams themselves differ by the two
    engines' drift, not the sessions': the JAX engine's rotation carry
    drifts from the batch forward over the frames (1.4e-3 of max |ref| after
    48 frames, the port's engine 2.4e-6; ROADMAP.md queue 3), so they are
    held within 2e-3 of max |ref|."""
    tm, jm, variables = _hubert_pair(hubert_ckpt)
    kw = dict(spk_id=3, frames_per_block=FPB, context_time=0.5,
              f0_extractor="dio", threshold_db=-50.0, seed=7, pitch_adjust=2,
              record=True)
    jsess = JSession(jm, variables, JUnitsEncoder(
        "hubertsoft", hubert_ckpt, 16000, 320), **kw)
    sess = IncrementalSession(tm, UnitsEncoder(
        "hubertsoft", hubert_ckpt, 16000, 320, device="cpu"), **kw)
    assert (sess.lookahead_frames, sess.ctx_frames) == (
        jsess.lookahead_frames, jsess.ctx_frames)
    audio = _sung(6 * FPB * BLOCK)
    n = FPB * BLOCK
    got = [sess.process_block(audio[i * n:(i + 1) * n]) for i in range(6)]
    ref = [jsess.process_block(audio[i * n:(i + 1) * n]) for i in range(6)]
    got.append(sess.flush())
    ref.append(jsess.flush())
    got, ref = np.concatenate(got), np.concatenate(ref)
    assert got.shape == ref.shape == (6 * n + 2 * BLOCK,)
    assert np.abs(ref).max() > 1e-3  # the stream is live

    fed = {k: [np.concatenate(s.recorded[k], axis=-1 if k == "mask" else 1)
               for s in (sess, jsess)] for k in sess.recorded}
    mine, theirs = fed.pop("units")
    assert np.abs(mine - theirs).max() < 2e-4 * np.abs(theirs).max()
    for key, (mine, theirs) in fed.items():
        np.testing.assert_array_equal(mine, theirs, err_msg=key)
    eng = IncrementalCombSubFast(tm)
    raw, _ = eng.process(eng.init_state(np.asarray([[3]])), *(
        np.concatenate(jsess.recorded[k], axis=1)
        for k in ("units", "f0", "volume", "noise")))
    replay = raw.numpy()[0] * fed["mask"][1]
    assert np.abs(got[:6 * n] - replay).max() < 2e-4 * np.abs(ref).max()
    assert np.abs(got - ref).max() < 2e-3 * np.abs(ref).max()


@pytest.fixture(scope="module")
def causal_exp(tmp_path_factory, hubert_ckpt):
    """An experiment of a causal + frame_norm CombSubFast: config.yaml and
    model_0.pt, the HuBERT-soft checkpoint as its encoder."""
    root = tmp_path_factory.mktemp("causal_exp")
    args = _args("CombSubFast")
    args["data"].update(encoder="hubertsoft", encoder_sample_rate=16000,
                        encoder_hop_size=320, encoder_out_channels=256,
                        encoder_ckpt=hubert_ckpt)
    (root / "config.yaml").write_text(yaml.safe_dump(
        {k: dict(v) for k, v in args.items()}))
    model = build_model(args, device="cpu", seed=4)
    save_checkpoint(str(root / "model_0.pt"), 0, model)
    yield root, args
    shutil.rmtree(root, ignore_errors=True)


def test_session_replays_through_engine(causal_exp):
    """A session from the checkpoint (`from_checkpoint`, record=True) over
    six blocks: its output equals its recorded features and noise replayed
    through a fresh engine, times the recorded mask, at atol 2e-5 (the JAX
    package's bound, tests/test_realtime.py); the flushed stream is finite
    and live past the lookahead and pipeline delay."""
    root, _ = causal_exp
    sess = IncrementalSession.from_checkpoint(
        str(root / "model_0.pt"), device="cpu", spk_id=1,
        frames_per_block=FPB, context_time=0.5, threshold_db=-80.0, seed=7,
        record=True)
    audio = _sung(6 * FPB * BLOCK, seed=4)
    n = FPB * BLOCK
    got = np.concatenate([sess.process_block(audio[i * n:(i + 1) * n])
                          for i in range(6)])
    eng = IncrementalCombSubFast(sess.engine.model)
    raw, _ = eng.process(eng.init_state(np.asarray([[1]])), *(
        np.concatenate(sess.recorded[k], axis=1)
        for k in ("units", "f0", "volume", "noise")))
    ref = raw.numpy()[0] * np.concatenate(sess.recorded["mask"])
    np.testing.assert_allclose(got, ref, atol=2e-5)
    out = np.concatenate([got, sess.flush()])
    warm = (sess.lookahead_frames + 2 + FPB) * BLOCK
    assert np.isfinite(out).all() and np.abs(out[warm:]).max() > 1e-6
    assert out.shape == (6 * n + 2 * BLOCK,)


def test_causal_checkpoint_loads_and_trains(causal_exp, tmp_path):
    """load_model gives the causal + frame_norm model back bit for bit, and
    the trainer takes a finite step with it on the CPU."""
    root, args = causal_exp
    model, got_args = load_model(str(root / "model_0.pt"), device="cpu")
    assert isinstance(model.unit2ctrl.unit_prenet["2"], FrameGroupNorm)
    assert model.unit2ctrl.dec_post["0"].net[0].attn.causal
    saved = torch.load(root / "model_0.pt", weights_only=True)["model"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]), k

    n_frames = SR // BLOCK + 1
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        for sub in ("audio", "units", "f0", "volume"):
            (tmp_path / split / sub / "1").mkdir(parents=True)
        write_wav(str(tmp_path / split / "audio" / "1" / "a.wav"),
                  _sung(SR, seed=5), SR)
        np.save(tmp_path / split / "units" / "1" / "a.0.npy",
                rng.standard_normal((n_frames, 256)).astype(np.float32))
        np.save(tmp_path / split / "f0" / "1" / "a.npy",
                np.full((n_frames,), 220.0, np.float32))
        np.save(tmp_path / split / "volume" / "1" / "a.npy",
                np.full((n_frames,), 0.2, np.float32))
    cfg = {k: dict(v) for k, v in args.items()}
    cfg["data"].update(train_path=str(tmp_path / "train"),
                       valid_path=str(tmp_path / "val"), duration=0.5,
                       n_aunit=0)
    cfg.update(loss={"fft_min": 128, "fft_max": 512, "n_scale": 2},
               env={"expdir": str(tmp_path / "exp")},
               train={"batch_size": 2, "cache_all_data": True,
                      "cache_fp16": False, "epochs": 4, "interval_log": 1,
                      "interval_val": 100, "lr": 1e-3, "weight_decay": 0.0,
                      "seed": 0})
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    state, saver = train_main.main(["-c", str(tmp_path / "cfg.yaml"),
                                    "--max-steps", "1", "--device", "cpu"])
    assert saver.global_step == 1
    assert isinstance(state.model.unit2ctrl.unit_prenet["2"], FrameGroupNorm)
    log = (tmp_path / "exp" / "log_values.jsonl").read_text()
    assert "loss" in log and "nan" not in log.lower()
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
