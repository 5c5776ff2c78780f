"""PyTorch port, training: the losses, one full training step (forward,
loss, backward, AdamW), the bf16 forward, the data pipeline and the
checkpoint/resume cycle against the JAX package, on the CPU at a small size
(16 kHz, block 256, 2 items, 32 frames, loss FFT sizes 128..512).

The port's model draws its weights from a seed; the JAX package's own
torch -> flax converter gives the JAX model the same weights, and the JAX
gradients come back through the port's `jax_synth_to_torch`. Both sides get
the same noise excitation and the same pinned loss scales."""
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from ddsp_svc_tpu.data import dataset as jdataset
from ddsp_svc_tpu.models import losses as jlosses
from ddsp_svc_tpu.models.synths import CombSubFast as JCombSubFast
from ddsp_svc_tpu.train import create_optimizer as j_create_optimizer
from ddsp_svc_tpu.utils import convert as jconvert
from ddsp_svc_tpu.utils.config import DotDict
from ddsp_svc_tpu_torch.data import dataset as tdataset
from ddsp_svc_tpu_torch.data.wavio import read_wav, write_wav
from ddsp_svc_tpu_torch.models import losses as tlosses
from ddsp_svc_tpu_torch.models.synths import CombSubFast
from ddsp_svc_tpu_torch.nn.layers import lecun_init_
from ddsp_svc_tpu_torch.train import __main__ as train_main
from ddsp_svc_tpu_torch.train.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint)
from ddsp_svc_tpu_torch.train.step import (
    TrainState, create_optimizer, train_step)
from ddsp_svc_tpu_torch.utils.convert import jax_synth_to_torch
from torch_tmp import tmp_path  # noqa: F401  (removed when each test ends)

torch.set_num_threads(2)

SR, BLOCK, N_UNIT, N_SPK = 16000, 256, 16, 2
B, FRAMES = 2, 32
T = FRAMES * BLOCK
FFT_MIN, FFT_MAX = 128, 512
LOSS_IDX = (3, 9)  # pinned draw: two non-power-of-two sizes of the set


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _signals(seed):
    rng = np.random.default_rng(seed)
    tt = np.arange(T) / SR
    x_true = (0.3 * np.sin(2 * np.pi * 220 * tt)[None]
              + 0.05 * rng.standard_normal((B, T))).astype(np.float32)
    x_pred = (x_true + 0.1 * rng.standard_normal((B, T))).astype(np.float32)
    return x_true, x_pred


def _batch(seed):
    rng = np.random.default_rng(seed)
    units = rng.standard_normal((B, FRAMES, N_UNIT)).astype(np.float32)
    f0 = (110.0 + 330.0 * rng.random((B, FRAMES, 1))).astype(np.float32)
    f0[0, :4] = 0.0  # an unvoiced head
    volume = rng.random((B, FRAMES)).astype(np.float32)
    spk_id = np.asarray([[1], [2]], np.int64)
    audio = (0.3 * rng.standard_normal((B, T))).astype(np.float32)
    noise = (rng.random((B, T)) * 2 - 1).astype(np.float32)
    return dict(units=units, f0=f0, volume=volume, spk_id=spk_id,
                audio=audio), noise


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


# ---------------------------------------------------------------- losses ---


def test_default_buckets_match_jax():
    assert tlosses.default_buckets(256, 2048) == jlosses.default_buckets(256, 2048)
    assert tlosses.default_buckets(256, 2048)[:2] == (256, 375)


@pytest.mark.parametrize("n_fft", [128, 300, 511])
def test_sss_loss_matches_jax(n_fft):
    """1e-5 relative: both fp32; the port's magnitude carries the 1e-12
    floor of dft_magnitude inside its root, the JAX CPU branch takes |X|."""
    x_true, x_pred = _signals(1)
    ref = jlosses.sss_loss(jnp.asarray(x_true), jnp.asarray(x_pred), n_fft)
    got = tlosses.sss_loss(_t(x_true), _t(x_pred), n_fft)
    assert _rel(got, ref) < 1e-5, (float(got), float(ref))


def test_rss_pinned_mss_and_mel_l1_match_jax():
    x_true, x_pred = _signals(2)
    jt, jp = jnp.asarray(x_true), jnp.asarray(x_pred)
    tt, tp = _t(x_true), _t(x_pred)
    t_rss = tlosses.RSSLoss(FFT_MIN, FFT_MAX, n_scale=2)
    j_rss = jlosses.RSSLoss(FFT_MIN, FFT_MAX, n_scale=2)
    assert t_rss.buckets == j_rss.buckets
    pinned = jlosses.RSSLoss(buckets=[j_rss.buckets[i] for i in LOSS_IDX])
    assert _rel(t_rss(tp, tt, idx=LOSS_IDX), pinned.mss(jp, jt)) < 1e-5
    assert _rel(t_rss.mss(tp, tt), j_rss.mss(jp, jt)) < 1e-5
    ref = jlosses.mel_l1(jp, jt, sr=SR, n_fft=512, hop=128, n_mels=40)
    got = tlosses.mel_l1(tp, tt, sr=SR, n_fft=512, hop=128, n_mels=40)
    assert _rel(got, ref) < 1e-5
    # the host draw: n_scale indices in range, reproducible from a seed
    draw = t_rss.draw(torch.Generator().manual_seed(5))
    assert draw == t_rss.draw(torch.Generator().manual_seed(5))
    assert len(draw) == 2 and all(0 <= i < len(t_rss.buckets) for i in draw)


# ------------------------------------------------------ one training step ---


@pytest.fixture(scope="module")
def pair():
    """The port's CombSubFast from seed 0 and JAX variables holding the same
    weights."""
    tm = lecun_init_(CombSubFast(SR, BLOCK, n_unit=N_UNIT, n_spk=N_SPK),
                     torch.Generator().manual_seed(0))
    sd = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
    variables = jconvert.convert_synth_state_dict(sd, num_layers=3)
    return tm, variables


def _flat(sd):
    return {k: np.asarray(v, np.float64) for k, v in sd.items()
            if not k.endswith("projection_matrix")}


def test_train_step_matches_jax(pair):
    """One step at loss eps 1e-3 (the well-conditioned regime of
    tests/test_train_parity.py): the loss to 1e-4 relative, every
    parameter's gradient to rel < 2e-2 and cos > 1 - 1e-4, and AdamW
    (lr 5e-4, weight decay 0.01) on the port's gradients to 1e-5 of each
    leaf's max |value| against optax.adamw on the same gradients
    (test_train_parity.py:200-205, 297)."""
    tm0, variables = pair
    model = CombSubFast(SR, BLOCK, n_unit=N_UNIT, n_spk=N_SPK)
    model.load_state_dict(tm0.state_dict())
    lr, wd = 5e-4, 0.01
    state = TrainState(0, model, create_optimizer(model, lr, wd))
    batch, noise = _batch(3)
    rss = tlosses.RSSLoss(FFT_MIN, FFT_MAX, n_scale=2, eps=1e-3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss = train_step(state, {k: _t(v) for k, v in batch.items()}, rss,
                      noise=_t(noise), loss_idx=LOSS_IDX)
    assert state.step == 1
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}

    jm = JCombSubFast(sampling_rate=SR, block_size=BLOCK, n_unit=N_UNIT,
                      n_spk=N_SPK)
    j_rss = jlosses.RSSLoss(buckets=[rss.buckets[i] for i in LOSS_IDX],
                            eps=1e-3)
    consts = variables["constants"]

    def loss_of(params):
        signal, _, _ = jm.apply(
            {"params": params, "constants": consts},
            *(jnp.asarray(batch[k]) for k in ("units", "f0", "volume",
                                              "spk_id")),
            infer=False, noise=jnp.asarray(noise))
        return j_rss.mss(signal, jnp.asarray(batch["audio"]))

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_of))(variables["params"])
    assert _rel(loss, j_loss) < 1e-4, (float(loss), float(j_loss))

    ref = _flat(jax_synth_to_torch({"params": j_grads, "constants": consts}))
    assert set(ref) == set(grads)
    for name, r in ref.items():
        g = grads[name].astype(np.float64)
        nr = np.linalg.norm(r)
        rel = np.linalg.norm(g - r) / (nr + 1e-12)
        assert rel < 2e-2, (name, rel, nr)
        if nr > 1e-10:
            cos = float(np.dot(g.ravel(), r.ravel())
                        / (np.linalg.norm(g) * nr + 1e-30))
            assert cos > 1 - 1e-4, (name, cos, rel)

    # AdamW: the port's step against optax.adamw on the same gradients
    sd_grads = {k: before[k].numpy() for k in before}
    sd_grads.update(grads)
    j_tgrads = jconvert.convert_synth_state_dict(sd_grads, num_layers=3)
    opt = j_create_optimizer(lr, weight_decay=wd)
    updates, _ = opt.update(j_tgrads["params"], opt.init(variables["params"]),
                            variables["params"])
    j_after = jax_synth_to_torch({"params": optax.apply_updates(
        variables["params"], updates), "constants": consts})
    for name, p in model.state_dict().items():
        a, b = np.asarray(j_after[name]), p.numpy()
        err = np.abs(a - b).max() / (np.abs(b).max() + 1e-12)
        assert err < 1e-5, (name, err)


def _dtype_spy(monkeypatch):
    """Record the input dtype of every F.linear, F.conv1d and torch.exp
    call until monkeypatch.undo()."""
    import torch.nn.functional as F

    seen = {}
    for mod, name in ((F, "linear"), (F, "conv1d"), (torch, "exp")):
        def spy(x, *a, _real=getattr(mod, name), _calls=seen.setdefault(
                name, []), **kw):
            _calls.append(x.dtype)
            return _real(x, *a, **kw)
        monkeypatch.setattr(mod, name, spy)
    return seen


def test_bf16_forward_matches_jax_bf16(pair, monkeypatch):
    """model.bf16: the training forward (infer=False) against the JAX
    package's bf16 model on the same weights and noise. Both run the PCmer's
    matmuls in bf16 (2^-9 relative rounding each) but round at different
    places (torch rounds a matmul once after adding its bias, XLA after the
    product and again after the bias; the fused elementwise chains differ
    too), so the two bf16 runs differ by bf16 noise, not by fp32 noise. The
    bound is the JAX package's own bf16-vs-fp32 bound, 5e-2 relative RMS
    (tests/test_bf16.py); each bf16 run is also held to it against the fp32
    run, and the parameters stay fp32. Readings: port bf16 vs JAX bf16
    1.6e-2, port fp32 vs JAX bf16 1.7e-2, so this bound cannot tell a bf16
    port from an fp32 one: the dtype checks do. Each PCmer layer runs its
    six Dense/pointwise matmuls (q, k, v, out, two pointwise convs) and its
    depthwise conv on bf16 inputs; every exponential (the FAVOR+ features
    among them) takes fp32; and the bf16 output is measurably not the fp32
    one (1.8e-2 relative RMS read; an fp32 run would give 0)."""
    tm0, variables = pair
    model = CombSubFast(SR, BLOCK, n_unit=N_UNIT, n_spk=N_SPK, bf16=True)
    model.load_state_dict(tm0.state_dict())
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    batch, noise = _batch(4)
    args = [batch[k] for k in ("units", "f0", "volume", "spk_id")]
    seen = _dtype_spy(monkeypatch)
    with torch.no_grad():
        got, _, _ = model(*(_t(a) for a in args), infer=False, noise=_t(noise))
    monkeypatch.undo()
    n_layers = len(model.unit2ctrl.dec_post["0"].net)
    assert seen["linear"].count(torch.bfloat16) == 6 * n_layers, seen
    assert seen["conv1d"].count(torch.bfloat16) == n_layers, seen
    assert torch.bfloat16 not in seen["exp"] and len(seen["exp"]) >= 2 * n_layers
    with torch.no_grad():
        got32, _, _ = tm0(*(_t(a) for a in args), infer=False, noise=_t(noise))
    assert got.dtype == torch.float32
    got, got32 = got.numpy(), got32.numpy()
    jm = JCombSubFast(sampling_rate=SR, block_size=BLOCK, n_unit=N_UNIT,
                      n_spk=N_SPK, bf16=True)
    ref = np.asarray(jax.jit(lambda v, *a: jm.apply(
        v, *a, infer=False, noise=jnp.asarray(noise))[0])(
            variables, *(jnp.asarray(a) for a in args)))

    def rel_rms(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))

    readings = dict(bf16_vs_jax_bf16=rel_rms(got, ref),
                    bf16_vs_fp32=rel_rms(got, got32),
                    fp32_vs_jax_bf16=rel_rms(got32, ref),
                    jax_bf16_vs_fp32=rel_rms(ref, got32))
    assert np.isfinite(got).all()
    assert readings["bf16_vs_jax_bf16"] < 5e-2, readings
    assert readings["jax_bf16_vs_fp32"] < 5e-2, readings
    assert 1e-3 < readings["bf16_vs_fp32"] < 5e-2, readings


def test_bf16_train_steps_finite(pair):
    """Three bf16 steps on the CPU (the plain chains): finite losses and fp32
    parameters that moved."""
    tm0, _ = pair
    model = CombSubFast(SR, BLOCK, n_unit=N_UNIT, n_spk=N_SPK, bf16=True)
    model.load_state_dict(tm0.state_dict())
    state = TrainState(0, model, create_optimizer(model, 1e-4), seed=1)
    batch, _ = _batch(5)
    rss = tlosses.RSSLoss(FFT_MIN, FFT_MAX, n_scale=2)
    w0 = model.unit2ctrl.dec_post["0"].net[0].attn.to_q.weight.detach().clone()
    losses = [float(train_step(state, {k: _t(v) for k, v in batch.items()},
                               rss)) for _ in range(3)]
    assert all(np.isfinite(losses)), losses
    w1 = model.unit2ctrl.dec_post["0"].net[0].attn.to_q.weight
    assert w1.dtype == torch.float32 and not torch.equal(w0, w1)


# ------------------------------------------------ data and checkpoints ---


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
    stats = {str(s): float(np.log(200.0 + 50 * s)) for s in range(1, N_SPK + 1)}
    np.save(os.path.join(root, "f0_stats.npy"), stats, allow_pickle=True)


def _args(root, **train):
    return DotDict({
        "data": {"train_path": str(root / "train"),
                 "valid_path": str(root / "val"), "duration": 1.0,
                 "block_size": BLOCK, "sampling_rate": SR,
                 "encoder_out_channels": N_UNIT, "n_aunit": 0},
        "model": {"type": "CombSubFast", "n_spk": N_SPK, "c": False},
        "loss": {"fft_min": FFT_MIN, "fft_max": FFT_MAX, "n_scale": 2},
        "env": {"expdir": str(root / "exp")},
        "train": {"batch_size": 2, "cache_all_data": True,
                  "cache_fp16": False, "epochs": 4, "interval_log": 1,
                  "interval_val": 2, "lr": 1e-3, "weight_decay": 0.0,
                  "seed": 0, **train},
    })


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train")
    _write_dataset(str(root / "train"))
    _write_dataset(str(root / "val"), n_files=2)
    yield root
    shutil.rmtree(root, ignore_errors=True)


def test_wav_round_trip_and_loaders_match_jax(data_root):
    """The port's wavio reads what it wrote, and its loaders give the JAX
    package's crops, speakers and shuffle for the same seed, bit for bit."""
    path = data_root / "train" / "audio" / "1" / "u0.wav"
    audio, sr = read_wav(str(path))
    assert sr == SR and audio.dtype == np.float32 and audio.shape == (24000,)
    args = _args(data_root)
    t_loader, t_valid = tdataset.get_data_loaders(args)
    j_loader, j_valid = jdataset.get_data_loaders(args)
    assert len(t_loader) == len(j_loader) and len(t_valid) == len(j_valid)
    for epoch in range(2):
        for tb, jb in zip(t_loader.epoch(epoch), j_loader.epoch(epoch)):
            assert tb["name"] == jb["name"]
            for k in ("audio", "f0", "volume", "units", "spk_id"):
                np.testing.assert_array_equal(tb[k], jb[k])
    assert tb["audio"].shape == (2, 62 * BLOCK)
    import random
    item_t = t_valid.get_item(1, random.Random(0))
    item_j = j_valid.get_item(1, random.Random(0))
    np.testing.assert_array_equal(item_t["audio"], item_j["audio"])


def test_checkpoint_round_trip(tmp_path, pair):
    tm0, _ = pair
    model = CombSubFast(SR, BLOCK, n_unit=N_UNIT, n_spk=N_SPK)
    model.load_state_dict(tm0.state_dict())
    state = TrainState(0, model, create_optimizer(model, 1e-3))
    batch, _ = _batch(6)
    train_step(state, {k: _t(v) for k, v in batch.items()},
               tlosses.RSSLoss(FFT_MIN, FFT_MAX, n_scale=2))
    path = str(tmp_path / "model_7.pt")
    save_checkpoint(path, 7, model, state.optimizer)
    fresh = CombSubFast(SR, BLOCK, n_unit=N_UNIT, n_spk=N_SPK)
    opt = create_optimizer(fresh, 1e-3)
    assert restore_checkpoint(path, fresh, opt) == 7
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    saved, loaded = state.optimizer.state_dict(), opt.state_dict()
    for i, st in saved["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(loaded["state"][i][k]),
                               torch.as_tensor(v)), (i, k)
    assert latest_checkpoint(str(tmp_path)) == path
    assert latest_checkpoint(str(tmp_path / "none")) is None


def test_train_main_runs_validates_and_resumes(data_root, tmp_path,
                                               monkeypatch):
    """The entry point on the CPU: two steps with a validation pass and a
    checkpoint at step 2, then a second run that resumes from it and takes
    one more step; then the same with all four train options on (two steps
    per dispatch, the device pool, remat, asynchronous checkpoints), which
    resumes from its own checkpoint too."""
    import yaml

    args = _args(data_root)
    args["env"]["expdir"] = str(tmp_path / "exp")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(dict(args)))
    state, saver = train_main.main(["-c", str(cfg), "--max-steps", "2",
                                    "--device", "cpu"])
    assert state.step == 2 and saver.global_step == 2
    expdir = tmp_path / "exp"
    for name in ("model_2.pt", "model_best.pt", "config.yaml",
                 "log_info.txt", "log_values.jsonl"):
        assert (expdir / name).is_file(), name
    log = (expdir / "log_info.txt").read_text()
    assert "Real Time Factor" in log and "vc_" in "".join(
        os.listdir(expdir / "audio"))
    saved = {k: v.clone() for k, v in state.model.state_dict().items()}

    restored = {}
    real_restore = train_main.restore_checkpoint

    def spy(path, model, optimizer=None):
        step = real_restore(path, model, optimizer)
        restored.update(path=path, step=step, params={
            k: v.clone() for k, v in model.state_dict().items()})
        return step

    monkeypatch.setattr(train_main, "restore_checkpoint", spy)
    state2, saver2 = train_main.main(["-c", str(cfg), "--max-steps", "1",
                                      "--device", "cpu"])
    assert restored["path"].endswith("model_2.pt") and restored["step"] == 2
    for k, v in saved.items():
        assert torch.equal(restored["params"][k], v), k
    assert state2.step == 3 and saver2.global_step == 3

    opts = _args(data_root, steps_per_dispatch=2, data_on_device=True,
                 remat=True, async_save=True)
    opts["env"]["expdir"] = str(tmp_path / "exp_opts")
    cfg_opts = tmp_path / "opts.yaml"
    cfg_opts.write_text(yaml.safe_dump(dict(opts)))
    state3, saver3 = train_main.main(["-c", str(cfg_opts), "--max-steps", "2",
                                      "--device", "cpu"])
    assert state3.step == saver3.global_step == 2
    assert (tmp_path / "exp_opts" / "model_2.pt").is_file()
    log = (tmp_path / "exp_opts" / "log_info.txt").read_text()
    assert " [pool] 3 files" in log and "Real Time Factor" in log
    saved = {k: v.clone() for k, v in state3.model.state_dict().items()}
    state4, saver4 = train_main.main(["-c", str(cfg_opts), "--max-steps", "2",
                                      "--device", "cpu"])
    assert restored["path"].endswith(os.path.join("exp_opts", "model_2.pt"))
    for k, v in saved.items():
        assert torch.equal(restored["params"][k], v), k
    assert state4.step == saver4.global_step == 4
    assert (tmp_path / "exp_opts" / "model_4.pt").is_file()
