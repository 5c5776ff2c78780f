"""PyTorch port, the trainer's four options on the CPU, against the JAX
package where it has a counterpart (16 kHz, block 256, a 3-layer PCmer):

  - data_on_device: DevicePool.sample and gather_batch bit for bit against
    the JAX pool's, fp16- and fp32-cached; a pool step equal to the host
    batch's step;
  - steps_per_dispatch: a K-step dispatch bit for bit K single steps
    (losses, parameters, AdamW state); the solver's log, validation,
    checkpoint and drain steps, and the data each step gets, equal to the
    JAX solver's (its steps replaced by recorders, so nothing compiles);
    the graphed step's combination of the loss buckets bit for bit the
    eager step's autograd;
  - remat: gradients bit for bit the plain step's, and the hazard it
    avoids (a draw inside a checkpointed forward differs on recompute);
  - async_save: checkpoints restoring tensors equal to synchronous ones,
    a write error surfacing on wait().
"""
import os
import random
import shutil
import types

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from ddsp_svc_tpu.data import dataset as jdataset
from ddsp_svc_tpu.data import device_pool as jpool
from ddsp_svc_tpu.train import saver as jsaver_mod
from ddsp_svc_tpu.train import solver as jsolver
from ddsp_svc_tpu.utils.config import DotDict
from ddsp_svc_tpu_torch.data import dataset as tdataset
from ddsp_svc_tpu_torch.data.device_pool import DevicePool
from ddsp_svc_tpu_torch.data.wavio import write_wav
from ddsp_svc_tpu_torch.models import synths
from ddsp_svc_tpu_torch.models.factory import build_model
from ddsp_svc_tpu_torch.models.losses import RSSLoss
from ddsp_svc_tpu_torch.train import saver as tsaver_mod
from ddsp_svc_tpu_torch.train import solver as tsolver
from ddsp_svc_tpu_torch.train.checkpoint import (
    AsyncCheckpointer, restore_checkpoint, save_checkpoint)
from ddsp_svc_tpu_torch.train.graphed import bucket_loss_grad, combine_buckets
from ddsp_svc_tpu_torch.train.step import (
    TrainState, create_optimizer, draw_noise, forward_signal, stage,
    train_step, train_steps)
from torch_tmp import tmp_path  # noqa: F401  (removed when each test ends)

torch.set_num_threads(2)

SR, BLOCK, N_UNIT, N_SPK = 16000, 256, 16, 2
B, FRAMES = 2, 32
FFT_MIN, FFT_MAX = 128, 512
SIZES = {"CombSubFast": {},
         "Sins": dict(n_harmonics=32, n_mag_allpass=64, n_mag_noise=64),
         "CombSub": dict(n_mag_allpass=64, n_mag_harmonic=128,
                         n_mag_noise=64)}


def _model_args(mtype="CombSubFast"):
    return DotDict({
        "data": {"sampling_rate": SR, "block_size": BLOCK,
                 "encoder_out_channels": N_UNIT},
        "model": {"type": mtype, "n_spk": N_SPK, **SIZES[mtype]},
    })


def _state(mtype="CombSubFast", seed=0):
    model = build_model(_model_args(mtype), device="cpu", seed=0)
    return TrainState(0, model, create_optimizer(model, 1e-3, 0.01),
                      seed=seed)


def _batch(seed, frames=FRAMES):
    rng = np.random.default_rng(seed)
    f0 = (110.0 + 330.0 * rng.random((B, frames, 1))).astype(np.float32)
    f0[0, :4] = 0.0
    return {"audio": (0.3 * rng.standard_normal((B, frames * BLOCK))
                      ).astype(np.float32),
            "f0": f0,
            "volume": rng.random((B, frames)).astype(np.float32),
            "units": rng.standard_normal((B, frames, N_UNIT)
                                         ).astype(np.float32),
            "spk_id": np.asarray([[1], [2]], np.int64)}


def _rss():
    return RSSLoss(FFT_MIN, FFT_MAX, n_scale=2)


def _assert_states_equal(a: TrainState, b: TrainState):
    assert a.step == b.step
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


# ------------------------------------------------------------ device pool --


class _FakeDataset:
    """The AudioDataset fields a pool reads: two speakers' files of
    unequal length, one too short for a crop, two unit variants."""
    waveform_sec = 1.0
    sample_rate = SR
    hop_size = BLOCK
    n_aunit = 1

    def __init__(self, dtype):
        rng = np.random.default_rng(5)
        self.paths = ["1/a", "1/short", "2/b"]
        self.data_buffer = {}
        for i, (rel, nf) in enumerate(zip(self.paths, (120, 50, 150))):
            self.data_buffer[rel] = {
                "duration": nf * BLOCK / SR,
                "f0": (150.0 + 50 * i) * np.ones((nf, 1), np.float32)
                + rng.random((nf, 1)).astype(np.float32),
                "volume": rng.random(nf).astype(np.float32),
                "audio": (0.2 * rng.standard_normal(nf * BLOCK)).astype(dtype),
                "units": [rng.standard_normal((nf, N_UNIT)).astype(dtype)
                          for _ in range(2)],
                "spk_id": np.asarray([1 + i // 2], np.int64),
            }


@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_pool_sample_and_gather_match_jax(dtype):
    """The same files, offsets and draws as the JAX pool for one seed, and
    the same crops, bit for bit; the cache keeps its dtype on the device."""
    ds = _FakeDataset(dtype)
    jp, tp = jpool.DevicePool(ds, BLOCK), DevicePool(ds, BLOCK, "cpu")
    assert tp.names == jp.names == ["1/a", "2/b"]
    assert tp.crop_frames == jp.crop_frames
    np.testing.assert_array_equal(tp.unit_base, jp.unit_base)
    for k, v in jp.arrays.items():
        v = np.asarray(v)
        np.testing.assert_array_equal(tp.arrays[k].numpy(), v)
        assert tp.arrays[k].numpy().dtype == v.dtype, k
    assert tp.arrays["audio"].numpy().dtype == dtype
    rng_j, rng_t = random.Random(3), random.Random(3)
    for files in ([0, 1], [1, 1, 0], [5, 2]):
        ij, it = jp.sample(files, rng_j), tp.sample(files, rng_t)
        for k in ij:
            np.testing.assert_array_equal(it[k], ij[k])
            assert it[k].dtype == ij[k].dtype
        ref = jpool.gather_batch(jp.arrays, ij, jp.crop_frames, BLOCK)
        got = tp.gather({k: torch.from_numpy(v) for k, v in it.items()})
        for k, v in ref.items():
            v = np.asarray(v)
            np.testing.assert_array_equal(got[k].numpy(), v)
            assert got[k].numpy().dtype == v.dtype, k


def test_pool_step_matches_host_batch():
    """A step on crops gathered from the pool equals the step on the host
    batch of the same crops (as the host loader builds it), bit for bit."""
    ds = _FakeDataset(np.float16)
    pool = DevicePool(ds, BLOCK, "cpu")
    idx = pool.sample([0, 1], random.Random(7))
    crop = pool.crop_frames
    host = {"audio": [], "f0": [], "volume": [], "units": []}
    for fi, (fs, us) in enumerate(zip(idx["feat_start"], idx["unit_start"])):
        buf = ds.data_buffer[pool.names[fi]]
        s = int(fs - pool.feat_base[fi])
        v = int(np.searchsorted(pool.unit_base[fi], us, side="right") - 1)
        host["audio"].append(buf["audio"][s * BLOCK:(s + crop) * BLOCK]
                             .astype(np.float32))
        host["f0"].append(buf["f0"][s:s + crop])
        host["volume"].append(buf["volume"][s:s + crop])
        host["units"].append(buf["units"][v][s:s + crop].astype(np.float32))
    host = {k: np.stack(v) for k, v in host.items()}
    host["spk_id"] = idx["spk_id"]
    rss = _rss()
    a, b = _state(seed=3), _state(seed=3)
    loss_a = train_steps(a, stage([host], "cpu"), rss)
    loss_b = train_steps(b, stage([idx], "cpu"), rss, pool=pool)
    assert torch.equal(loss_a, loss_b)
    _assert_states_equal(a, b)


# ------------------------------------------------------------- K per call --


def test_k_dispatch_equals_single_steps():
    """Three steps of one dispatch over a staged stack equal three single
    steps, bit for bit: losses, parameters and AdamW state (each step
    seeds its noise and loss scales from its own step count)."""
    rss = _rss()
    batches = [_batch(s) for s in range(3)]
    a, b = _state(seed=1), _state(seed=1)
    singles = torch.stack([
        train_step(a, {k: v[0] for k, v in stage([x], "cpu").items()}, rss)
        for x in batches])
    multi = train_steps(b, stage(batches, "cpu"), rss)
    assert multi.shape == (3,) and torch.equal(singles, multi)
    _assert_states_equal(a, b)


def test_bucket_combination_matches_eager_autograd():
    """The graphed step's loss buckets (train/graphed.py), each its own
    loss and gradient, combined as combine_buckets combines them, give the
    eager RSS loss and its gradient with respect to the signal bit for bit,
    a bucket drawn twice included."""
    rng = np.random.default_rng(2)
    audio = torch.from_numpy((0.3 * rng.standard_normal((B, 8192))
                              ).astype(np.float32))
    signal = (audio + 0.1 * torch.from_numpy(
        rng.standard_normal((B, 8192)).astype(np.float32))).requires_grad_()
    rss = RSSLoss(FFT_MIN, FFT_MAX, n_scale=4)
    idx = [3, 9, 3, 14]
    loss = rss(signal, audio, idx=idx)
    loss.backward()
    scale = torch.full((), 1.0 / rss.n_scale)
    outs = {i: bucket_loss_grad(signal, audio, rss.buckets[i], rss.eps, scale)
            for i in set(idx)}
    grad = torch.empty_like(signal)
    got = combine_buckets(outs, idx, rss.n_scale, grad)
    assert torch.equal(got, loss.detach())
    assert torch.equal(grad, signal.grad)


def test_windows_cached_and_never_fake(monkeypatch):
    """The windows the step reads are made once per (length, dtype,
    device) (a CUDA graph cannot capture their host-to-device copy); an
    export traced with an empty cache leaves no fake tensor in it, and the
    eager forward after it still equals the program's output."""
    from ddsp_svc_tpu_torch.export import export_program
    from ddsp_svc_tpu_torch.ops import windows

    monkeypatch.setattr(windows, "_CACHE", {})
    model = build_model(_model_args(), device="cpu", seed=0)
    program = export_program(model, frames=16)
    assert all(type(w) is torch.Tensor for w in windows._CACHE.values())
    x = {k: torch.from_numpy(v[:1]) for k, v in _batch(8, frames=16).items()}
    noise = torch.zeros((1, 16 * BLOCK))
    args = (x["units"], x["f0"], x["volume"], x["spk_id"], noise)
    with torch.no_grad():
        ref = model(*args[:4], infer=True, noise=noise)[0]
    got = program.module()(*args)
    got = got[0] if isinstance(got, (tuple, list)) else got
    assert torch.equal(got, ref)
    w = windows.sqrt_hann_window(2 * BLOCK)
    assert windows.sqrt_hann_window(2 * BLOCK) is w
    assert windows.sqrt_hann_window(2 * BLOCK, torch.float64) is not w


# ---------------------------------------------------------------- remat ----


@pytest.mark.parametrize("mtype", ["CombSubFast", "Sins", "CombSub"])
def test_noise_before_forward_is_the_models_draw(mtype):
    """The step draws the noise before the forward (train_step, the graphed
    step): it is the one draw the model would have made from the step's
    generator, so a step's numbers do not change."""
    model = build_model(_model_args(mtype), device="cpu", seed=0)
    x = {k: torch.from_numpy(v) for k, v in _batch(4, frames=16).items()}
    args = (x["units"], x["f0"], x["volume"], x["spk_id"])
    with torch.no_grad():
        ref = model(*args, infer=False,
                    generator=torch.Generator().manual_seed(11))[0]
        noise = draw_noise(model, x["f0"], torch.Generator().manual_seed(11))
        got = model(*args, infer=False, noise=noise)[0]
        buf = torch.empty_like(noise)
        draw_noise(model, x["f0"], torch.Generator().manual_seed(11), out=buf)
    assert torch.equal(got, ref)
    assert torch.equal(buf, noise)


@pytest.mark.parametrize("mtype", ["CombSubFast", "Sins"])
def test_remat_gradients_equal_plain(mtype):
    """A remat step's gradients (the forward recomputed in the backward)
    equal the plain step's bit for bit, and so do the parameters after."""
    rss = _rss()
    x = {k: torch.from_numpy(v) for k, v in _batch(5, frames=16).items()}
    grads = []
    states = []
    for remat in (False, True):
        st = _state(mtype, seed=2)
        train_step(st, x, rss, remat=remat)
        grads.append({n: p.grad.clone() for n, p in
                      st.model.named_parameters()})
        states.append(st)
    for name, g in grads[0].items():
        assert torch.equal(grads[1][name], g), name
    _assert_states_equal(*states)


def test_noise_drawn_inside_a_checkpoint_would_differ(monkeypatch):
    """The hazard the step avoids: under torch.utils.checkpoint the forward
    runs twice, and a draw from the step's explicit generator inside it
    (checkpoint restores only the default generators) gives other noise on
    the recompute, so the gradient would belong to a forward that never
    produced the loss."""
    draws = []
    real = synths._uniform_noise

    def spy(like, generator):
        draws.append(real(like, generator))
        return draws[-1]

    monkeypatch.setattr(synths, "_uniform_noise", spy)
    model = build_model(_model_args(), device="cpu", seed=0)
    x = {k: torch.from_numpy(v) for k, v in _batch(6, frames=16).items()}
    gen = torch.Generator().manual_seed(3)
    signal = checkpoint(
        lambda *a: model(*a, infer=False, generator=gen)[0],
        x["units"], x["f0"], x["volume"], x["spk_id"], use_reentrant=False)
    signal.square().mean().backward()
    assert len(draws) == 2 and not torch.equal(draws[0], draws[1])
    # the step's own path: the noise comes in, nothing is drawn inside
    draws.clear()
    signal = forward_signal(model, x, draw_noise(model, x["f0"], gen),
                            remat=True)
    signal.square().mean().backward()
    assert draws == []


# ----------------------------------------------------------- async saves ---


def test_async_checkpoints_equal_sync(tmp_path):
    """Asynchronous checkpoints (more saves than max_pending, the model
    stepped again right after each) restore the same tensors as a
    synchronous one taken at the same step; a failing write raises on
    wait()."""
    rss = _rss()
    st = _state()
    x = {k: torch.from_numpy(v) for k, v in _batch(7, frames=16).items()}
    train_step(st, x, rss)
    save_checkpoint(str(tmp_path / "sync.pt"), 1, st.model, st.optimizer)
    ac = AsyncCheckpointer(max_pending=2)
    paths = [str(tmp_path / f"async_{i}.pt") for i in range(4)]
    for p in paths:
        ac.save(p, 1, st.model, st.optimizer)
    before = {k: v.clone() for k, v in st.model.state_dict().items()}
    train_step(st, x, rss)  # updates the saved tensors in place
    ac.wait()
    ref_model = build_model(_model_args(), device="cpu", seed=1)
    ref_opt = create_optimizer(ref_model, 1e-3)
    assert restore_checkpoint(str(tmp_path / "sync.pt"), ref_model,
                              ref_opt) == 1
    for p in paths:
        model = build_model(_model_args(), device="cpu", seed=1)
        opt = create_optimizer(model, 1e-3)
        assert restore_checkpoint(p, model, opt) == 1
        for k, v in model.state_dict().items():
            assert torch.equal(v, ref_model.state_dict()[k]), k
            assert torch.equal(v, before[k]), k
        ref_state = ref_opt.state_dict()["state"]
        for i, s in opt.state_dict()["state"].items():
            for k, v in s.items():
                assert torch.equal(v, ref_state[i][k]), (i, k)
    (tmp_path / "blocker").write_bytes(b"")
    ac.save(str(tmp_path / "blocker" / "x.pt"), 1, st.model, st.optimizer)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ac.wait()
    ac.close()


# ---------------------------------------------------------------- solver ---


def _write_dataset(root, n_files=3, seconds=1.5):
    rng = np.random.default_rng(0)
    t = int(seconds * SR)
    n_frames = t // BLOCK + 1
    for i in range(n_files):
        spk = 1 + i % N_SPK
        for sub in ("audio", "units", "f0", "volume"):
            os.makedirs(os.path.join(root, sub, str(spk)), exist_ok=True)
        f0_hz = 150.0 + 50.0 * (i + 1)
        audio = 0.3 * np.sin(2 * np.pi * f0_hz * np.arange(t) / SR)
        write_wav(os.path.join(root, "audio", str(spk), f"u{i}.wav"),
                  audio.astype(np.float32), SR)
        np.save(os.path.join(root, "units", str(spk), f"u{i}.0.npy"),
                rng.standard_normal((n_frames, N_UNIT)).astype(np.float32))
        np.save(os.path.join(root, "f0", str(spk), f"u{i}.npy"),
                np.full((n_frames,), f0_hz, np.float32))
        np.save(os.path.join(root, "volume", str(spk), f"u{i}.npy"),
                np.full((n_frames,), 0.2, np.float32))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train_options")
    _write_dataset(str(root / "train"))
    _write_dataset(str(root / "val"), n_files=1)
    yield root
    shutil.rmtree(root, ignore_errors=True)


def _solver_args(root, expdir, **train):
    return DotDict({
        "data": {"train_path": str(root / "train"),
                 "valid_path": str(root / "val"), "duration": 1.0,
                 "block_size": BLOCK, "sampling_rate": SR,
                 "encoder_out_channels": N_UNIT, "n_aunit": 0},
        "model": {"type": "CombSubFast", "n_spk": N_SPK, "c": False},
        "loss": {"fft_min": FFT_MIN, "fft_max": FFT_MAX, "n_scale": 2},
        "env": {"expdir": str(expdir)},
        "train": {"batch_size": 2, "cache_all_data": True,
                  "cache_fp16": False, "epochs": 1, "interval_log": 1,
                  "interval_val": 1000, "lr": 1e-3, "weight_decay": 0.0,
                  "seed": 0, **train},
    })


def _run_jax_solver(args, max_steps, monkeypatch):
    """JAX's solver.train with its steps, validation and saves replaced by
    recorders: [(kind, global step), ...] and each step's data."""
    events, data = [], []

    def fake_maker(multi):
        def make(*a, **kw):
            def step(state, *args):
                d = {k: np.asarray(v) for k, v in args[-2].items()}
                n = len(next(iter(d.values()))) if multi else 1
                data.extend([{k: v[i] for k, v in d.items()}
                             for i in range(n)] if multi else [d])
                return state, (np.ones(n, np.float32) if multi
                               else np.float32(1.0))
            return step
        return make

    for name, multi in (("make_train_step", False),
                        ("make_train_step_multi", True),
                        ("make_train_step_pool", False),
                        ("make_train_step_pool_multi", True)):
        monkeypatch.setattr(jsolver, name, fake_maker(multi))
    monkeypatch.setattr(jsolver, "test", lambda args, model, state, rss, dv,
                        saver: events.append(("val", saver.global_step)) or 1.0)
    monkeypatch.setattr(jsaver_mod.Saver, "save_model", lambda self, v, o=None,
                        postfix=None: events.append(("save", postfix)))
    monkeypatch.setattr(jsaver_mod.Saver, "log_value", lambda self, d:
                        events.append(("log", self.global_step, sorted(d))))
    loader, valid = jdataset.get_data_loaders(args)
    state = types.SimpleNamespace(params=None, constants=None, opt_state=None)
    _, saver = jsolver.train(args, 0, None, state, None, None, loader, valid,
                             max_steps=max_steps)
    return events, data, saver.global_step


def _run_port_solver(args, max_steps, monkeypatch):
    """The port's solver.train on the CPU (its real steps), with the same
    recorders around validation, saves and logged values."""
    events, data = [], []
    real_stage, real_save = tsolver.stage, tsaver_mod.Saver.save_model

    def stage_spy(items, device):
        data.extend({k: np.asarray(v) for k, v in it.items()} for it in items)
        return real_stage(items, device)

    def save_spy(self, model, optimizer, postfix):
        events.append(("save", postfix))
        return real_save(self, model, optimizer, postfix)

    monkeypatch.setattr(tsolver, "stage", stage_spy)
    monkeypatch.setattr(tsolver, "test", lambda args, model, rss, dv, saver:
                        events.append(("val", saver.global_step)) or 1.0)
    monkeypatch.setattr(tsaver_mod.Saver, "save_model", save_spy)
    monkeypatch.setattr(tsaver_mod.Saver, "log_value", lambda self, d:
                        events.append(("log", self.global_step, sorted(d))))
    loader, valid = tdataset.get_data_loaders(args)
    model = build_model(args, device="cpu", seed=0)
    state = TrainState(0, model, create_optimizer(model, 1e-3),
                       seed=int(args.train.seed))
    rss = RSSLoss(FFT_MIN, FFT_MAX, n_scale=2)
    state, saver = tsolver.train(args, 0, state, rss, loader, valid,
                                 max_steps=max_steps)
    assert state.step == saver.global_step
    return events, data, saver.global_step


@pytest.mark.parametrize("train,max_steps,steps", [
    # K = 2 to max_steps (test_train_e2e.py::test_solver_steps_per_dispatch),
    # with remat and asynchronous checkpoints
    (dict(steps_per_dispatch=2, interval_log=2, interval_val=4, epochs=20,
          remat=True, async_save=True), 4, 4),
    # K = 4 over a partial last dispatch (..._drains_remainder): seven
    # batches, one dispatch and three drained
    (dict(steps_per_dispatch=4, interval_val=2, epochs=7), None, 7),
    # the pool with K = 2 (test_solver_data_on_device_with_k_dispatch)
    (dict(data_on_device=True, steps_per_dispatch=2, interval_log=3,
          interval_val=4, epochs=30), 6, 6),
], ids=["k2-remat-async", "k4-drain", "pool-k2"])
def test_solver_dispatch_matches_jax(data_root, tmp_path, monkeypatch, train,
                                     max_steps, steps):
    """The port's solver logs, validates, checkpoints, stops and drains at
    the global steps that JAX's solver does, and feeds each step the same
    batch (or the same pool crop indices)."""
    jargs = _solver_args(data_root, tmp_path / "jax", **train)
    targs = _solver_args(data_root, tmp_path / "port", **train)
    j_events, j_data, j_step = _run_jax_solver(jargs, max_steps, monkeypatch)
    t_events, t_data, t_step = _run_port_solver(targs, max_steps,
                                                monkeypatch)
    assert t_step == j_step == steps
    assert t_events == j_events
    assert len(t_data) == len(j_data) == steps
    for t, j in zip(t_data, j_data):
        assert t.keys() == j.keys()
        for k in t:
            np.testing.assert_array_equal(t[k], j[k])
    for kind, *rest in t_events:
        if kind == "save":
            assert (tmp_path / "port" / f"model_{rest[0]}.pt").is_file()
