"""PyTorch port, training on a mesh (`ddsp_svc_tpu_torch/parallel/`) on the
CPU: ranks spawned as fresh processes (tests/torch_parallel_worker.py)
joined over Gloo, world sizes 2 and 4, each case on its own (n_data,
n_model) mesh, against the JAX package's single-device steps and the
port's own single-process ones, at tests/test_parallel.py's sizes and
bounds: CombSubFast at 16 kHz, block 256, 64 units, a batch of 8 x 8
frames, RSS over 128..512 (two scales, pinned); the GAN at its ENH_H.

Weights are the port's, drawn from seeds and carried into the JAX package
by its own converters; the JAX results come back through
`utils/convert.py`. Both sides get the same noise and rand_ini (the JAX
forward takes the test's noise through `noise=`). Also: the TP rules
against JAX's `param_shardings`, a checkpoint saved under 2 x 2 resumed on
one process (and a single-device one cut onto 2 x 2), the train and GAN
entries across two rank processes, and a causal CombSubFast time-sharded
against its unsharded forward and JAX's."""
import os
import shutil
import socket
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ddsp_svc_tpu.models import CombSubFast as JCombSubFast
from ddsp_svc_tpu.models import losses as jlosses
from ddsp_svc_tpu.ops import log_mel_spectrogram as j_log_mel
from ddsp_svc_tpu.ops import spectral as jspectral
from ddsp_svc_tpu.nn.nsf_hifigan import Generator as JGenerator
from ddsp_svc_tpu.parallel import make_mesh as jmake_mesh
from ddsp_svc_tpu.parallel import param_shardings as jparam_shardings
from ddsp_svc_tpu.parallel.timeparallel import (
    make_time_parallel_forward as jmake_time_parallel_forward)
from ddsp_svc_tpu.train import create_optimizer as j_create_optimizer
from ddsp_svc_tpu.train import make_train_step as j_make_train_step
from ddsp_svc_tpu.train.gan import GanState as JGanState
from ddsp_svc_tpu.train.gan import GanTrainer as JGanTrainer
from ddsp_svc_tpu.train.step import TrainState as JTrainState
from ddsp_svc_tpu.utils import convert as jconvert
from ddsp_svc_tpu_torch.data.wavio import write_wav
from ddsp_svc_tpu_torch.models.factory import build_model
from ddsp_svc_tpu_torch.models.losses import RSSLoss
from ddsp_svc_tpu_torch.nn.layers import lecun_init_
from ddsp_svc_tpu_torch.nn.nsf_hifigan import generator_from_h
from ddsp_svc_tpu_torch.parallel import Mesh, param_shardings
from ddsp_svc_tpu_torch.train import __main__ as train_main
from ddsp_svc_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)
from ddsp_svc_tpu_torch.train.gan import GanTrainer
from ddsp_svc_tpu_torch.train.step import (TrainState, create_optimizer,
                                           stage, train_step, train_steps)
from ddsp_svc_tpu_torch.utils.config import DotDict
from ddsp_svc_tpu_torch.utils.convert import jax_nsf_to_torch, jax_synth_to_torch
from torch_parallel_worker import _Pool, start_ranks

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, BLOCK, N_UNIT, N_SPK = 16000, 256, 64, 4
B, F = 8, 8
LR = 1e-3
LOSS_IDX = (3, 9)  # two of the 16 RSS sizes over 128..512, pinned
SINS = dict(n_harmonics=32, n_mag_allpass=64, n_mag_noise=64)  # 160 columns
# tests/test_parallel.py's bounds: the loss to 2e-4 relative; parameters
# after one AdamW step at the 99th percentile of |diff| < 1e-4 and at most
# 4e-3 (Adam's first step turns a float-noise sign flip of a near-zero
# gradient into ~2 lr). Against the port's own single-process step the
# loss and the bulk are held tighter (the same code, summed otherwise).
LOSS_RTOL, Q99, MAX = 2e-4, 1e-4, 4e-3
SELF_LOSS_RTOL, SELF_Q99 = 1e-6, 1e-6
ENH_H = {
    "sampling_rate": 16000, "num_mels": 8, "n_fft": 128, "win_size": 128,
    "hop_size": 32, "fmin": 40, "fmax": 8000,
    "upsample_rates": [4, 4, 2], "upsample_kernel_sizes": [8, 8, 4],
    "upsample_initial_channel": 16, "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5]] * 3,
}
CAUSAL_FRAMES, CAUSAL_VALID = 256, 150
CAUSAL_TOL = 1e-5  # x max |ref|, the sharded causal forward vs unsharded


def _args(mtype="CombSubFast", **model):
    return {"data": {"sampling_rate": SR, "block_size": BLOCK,
                     "encoder_out_channels": N_UNIT},
            "model": {"type": mtype, "n_spk": N_SPK,
                      **(SINS if mtype == "Sins" else {}), **model}}


def _batch(seed=0):
    """tests/test_parallel.py's batch (seed 0), and a noise draw."""
    rng = np.random.default_rng(seed)
    batch = {
        "audio": rng.standard_normal((B, F * BLOCK)).astype(np.float32),
        "units": rng.standard_normal((B, F, N_UNIT)).astype(np.float32),
        "f0": (200 * rng.random((B, F, 1))).astype(np.float32),
        "volume": rng.random((B, F)).astype(np.float32),
        "spk_id": np.ones((B, 1), dtype=np.int64),
    }
    noise = (rng.random((B, F * BLOCK)) * 2 - 1).astype(np.float32)
    return batch, noise


def _torch(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def _single_steps(args, state, batches, noises, remat=False, resume=None):
    """The port's single-process steps: (losses, state dict, optimizer)."""
    model = build_model(DotDict(args), device="cpu")
    model.load_state_dict(state)
    st = TrainState(0, model, create_optimizer(model, LR))
    if resume is not None:
        st.step = restore_checkpoint(resume, model, st.optimizer)
    rss = RSSLoss(128, 512, n_scale=2)
    losses = [float(train_step(st, _torch(b), rss, noise=torch.as_tensor(n),
                               loss_idx=LOSS_IDX, remat=remat))
              for b, n in zip(batches, noises)]
    return losses, model.state_dict(), st.optimizer


class _InjectedNoise:
    """The JAX model with the test's noise in place of its own draw."""

    def __init__(self, model, noise):
        self.model, self.noise = model, jnp.asarray(noise)

    def apply(self, variables, *args, rngs=None, **kw):
        return self.model.apply(variables, *args, noise=self.noise, **kw)


def _jax_step(state, batch, noise):
    """JAX's single-device make_train_step (optax.adamw at LR) from the
    port's weights, its noise and loss scales pinned: (loss, state dict)."""
    variables = jconvert.convert_synth_state_dict(
        {k: v.numpy() for k, v in state.items()}, num_layers=3)
    jm = JCombSubFast(sampling_rate=SR, block_size=BLOCK, n_unit=N_UNIT,
                      n_spk=N_SPK)
    rss = RSSLoss(128, 512, n_scale=2)
    j_rss = jlosses.RSSLoss(buckets=[rss.buckets[i] for i in LOSS_IDX])
    opt = j_create_optimizer(LR)
    step = j_make_train_step(_InjectedNoise(jm, noise),
                             lambda s, a, rng: j_rss.mss(s, a), opt)
    jstate = JTrainState(step=jnp.asarray(0, jnp.int32),
                         params=variables["params"],
                         constants=variables["constants"],
                         opt_state=opt.init(variables["params"]))
    jstate, loss = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.key(0))
    return float(loss), jax_synth_to_torch(
        {"params": jstate.params, "constants": variables["constants"]})


def _flax_discriminators(mpd, msd):
    """The port's discriminators as the JAX package's params."""
    out = {}
    for key, module, prefix in (("mpd", mpd, "disc_p"), ("msd", msd, "disc_s")):
        names = ([f"disc_p{p}" for p in (2, 3, 5, 7, 11)] if key == "mpd"
                 else [f"disc_s{i}" for i in range(3)])
        out[key] = {}
        for name, d in zip(names, module.discriminators):
            convs = [*d.convs, d.conv_post]
            out[key][name] = {f"Conv_{j}": {
                "kernel": jnp.asarray(c.weight.detach().numpy().transpose(
                    (2, 3, 1, 0) if c.weight.ndim == 4 else (2, 1, 0))),
                "bias": jnp.asarray(c.bias.detach().numpy())}
                for j, c in enumerate(convs)}
    return out


def _gan_inputs():
    """Seeded G and D weights (the port's, as state dicts), a batch with
    JAX's mel, JAX's rand_ini draws for a D and a G step, and the weights
    as the JAX package's params."""
    g = lecun_init_(generator_from_h(ENH_H), torch.Generator().manual_seed(0))
    st = GanTrainer(ENH_H).create_state(g, seed=1)
    weights = {name: {k: v.clone() for k, v in m.state_dict().items()}
               for name, m in (("g_state", g), ("mpd_state", st.mpd),
                               ("msd_state", st.msd))}
    rng = np.random.default_rng(2)
    t = F * int(np.prod(ENH_H["upsample_rates"]))
    batch = {"audio": (0.1 * rng.standard_normal((B, t))).astype(np.float32),
             "f0": (200.0 + 50.0 * rng.random((B, F))).astype(np.float32)}
    batch["mel"] = np.array(jnp.swapaxes(j_log_mel(
        jnp.asarray(batch["audio"]), ENH_H["sampling_rate"], ENH_H["n_fft"],
        ENH_H["hop_size"], ENH_H["win_size"], ENH_H["num_mels"],
        ENH_H["fmin"], ENH_H["fmax"]), 1, 2))
    keys = {"ri_d": jax.random.key(2), "ri_g": jax.random.key(3)}
    kw = dict(h=ENH_H, batch=_torch(batch), **weights, **{
        name: torch.as_tensor(np.array(jax.random.uniform(
            jax.random.fold_in(k, 0), (B, 9)).at[:, 0].set(0.0)))
        for name, k in keys.items()})
    jax_params = dict(
        g=jconvert.convert_nsf_hifigan_state_dict(
            {k: v.numpy() for k, v in g.state_dict().items()},
            ENH_H)["params"],
        d=_flax_discriminators(st.mpd, st.msd))
    return kw, batch, keys, jax_params


def _gan_jax(batch, keys, params) -> dict:
    """JAX's GanTrainer (mesh=None): one D and one G step; its logs and
    generator."""
    gen = JGenerator(
        sampling_rate=ENH_H["sampling_rate"], num_mels=ENH_H["num_mels"],
        upsample_rates=tuple(ENH_H["upsample_rates"]),
        upsample_kernel_sizes=tuple(ENH_H["upsample_kernel_sizes"]),
        upsample_initial_channel=ENH_H["upsample_initial_channel"],
        resblock_kernel_sizes=tuple(ENH_H["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(
            tuple(d) for d in ENH_H["resblock_dilation_sizes"]))
    tr = JGanTrainer(gen, ENH_H)
    jst = JGanState(step=jnp.asarray(0, jnp.int32), g_params=params["g"],
                    d_params=params["d"],
                    g_opt=tr.g_optimizer.init(params["g"]),
                    d_opt=tr.d_optimizer.init(params["d"]))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jst, d_logs = tr.step_d(jst, dict(jb), keys["ri_d"])
    jst, g_logs = tr.step_g(jst, dict(jb), keys["ri_g"])
    return {"logs": {k: float(v) for k, v in {**d_logs, **g_logs}.items()},
            "generator": jax_nsf_to_torch(
                jax.tree.map(np.asarray, jst.g_params), ENH_H)}


def _gan_single(kw):
    """The port's single-process D and G steps from the same inputs."""
    g = generator_from_h(ENH_H)
    g.load_state_dict(kw["g_state"])
    trainer = GanTrainer(ENH_H)
    st = trainer.create_state(g, seed=0)
    st.mpd.load_state_dict(kw["mpd_state"])
    st.msd.load_state_dict(kw["msd_state"])
    logs = trainer.step_d(st, kw["batch"], rand_ini=kw["ri_d"])
    logs.update(trainer.step_g(st, kw["batch"], rand_ini=kw["ri_g"]))
    return {"logs": {k: float(v) for k, v in logs.items()},
            "generator": st.generator.state_dict()}


def _causal_inputs():
    rng = np.random.default_rng(5)
    f = CAUSAL_FRAMES
    return dict(
        units=rng.standard_normal((1, f, N_UNIT)).astype(np.float32),
        f0=(200 * rng.random((1, f, 1)) + 80).astype(np.float32),
        volume=rng.random((1, f)).astype(np.float32),
        spk_id=np.ones((1, 1), np.int64),
        noise=(rng.random((1, f * BLOCK)) * 2 - 1).astype(np.float32))


def _write_train_data(root, n_files=3, seconds=1.5, n_unit=16):
    """The trainer's preprocessed layout (tests/test_torch_train.py's)."""
    rng = np.random.default_rng(0)
    t = int(seconds * SR)
    n_frames = t // BLOCK + 1
    for i in range(n_files):
        spk = 1 + i % 2
        for sub in ("audio", "units", "f0", "volume"):
            os.makedirs(os.path.join(root, sub, str(spk)), exist_ok=True)
        f0_hz = 150.0 + 50.0 * (i + 1)
        audio = 0.3 * np.sin(2 * np.pi * f0_hz * np.arange(t) / SR)
        write_wav(os.path.join(root, "audio", str(spk), f"u{i}.wav"),
                  audio.astype(np.float32), SR)
        np.save(os.path.join(root, "units", str(spk), f"u{i}.0.npy"),
                rng.standard_normal((n_frames, n_unit)).astype(np.float32))
        np.save(os.path.join(root, "f0", str(spk), f"u{i}.npy"),
                np.full((n_frames,), f0_hz, np.float32))
        np.save(os.path.join(root, "volume", str(spk), f"u{i}.npy"),
                np.full((n_frames,), 0.2, np.float32))


def _train_config(root, expdir):
    return {
        "data": {"train_path": str(root / "train"),
                 "valid_path": str(root / "val"), "duration": 1.0,
                 "block_size": BLOCK, "sampling_rate": SR,
                 "encoder_out_channels": 16, "n_aunit": 0},
        "model": {"type": "CombSubFast", "n_spk": 2},
        "loss": {"fft_min": 128, "fft_max": 512, "n_scale": 2},
        "env": {"expdir": str(expdir)},
        "train": {"batch_size": 2, "cache_all_data": True,
                  "cache_fp16": False, "epochs": 4, "interval_log": 1,
                  "interval_val": 2, "lr": 1e-3, "weight_decay": 0.0,
                  "seed": 0, "steps_per_dispatch": 2,
                  "data_on_device": True},
    }


def _gan_config(root, expdir):
    return {
        "data": {"sampling_rate": SR, "block_size": BLOCK,
                 "train_path": str(root / "train"),
                 "valid_path": str(root / "val")},
        "enhancer": {"type": "nsf-hifigan", "ckpt": None},
        "env": {"expdir": str(root / "exp")},
        "train": {"seed": 0, "gan": {
            "h": ENH_H, "lr": 1e-4, "batch_size": 2, "crop_frames": 16,
            "interval_log": 1, "interval_val": 2, "max_steps": 100,
            "expdir": str(expdir), "data_parallel": True}},
    }


def _entry_ranks(module, config, world, folder, extra=()):
    """`python -m ddsp_svc_tpu_torch.<module>` as `world` rank processes
    over Gloo on the CPU, each logging to a file in `folder`: the Popen
    list."""
    os.makedirs(folder, exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = []
    for r in range(world):
        with open(os.path.join(folder, f"{module}.{r}.log"), "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", f"ddsp_svc_tpu_torch.{module}", "-c",
                 config, "--max-steps", "2", "--device", "cpu", "--backend",
                 "gloo", "--num-processes", str(world), "--coordinator",
                 f"127.0.0.1:{port}", "--process-id", str(r), *extra],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def _wait(procs, folder, module, timeout=300):
    for p in procs:
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            p.wait()
    logs = []
    for r in range(len(procs)):
        with open(os.path.join(folder, f"{module}.{r}.log"),
                  errors="replace") as f:
            logs.append(f.read())
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    return logs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh case at world sizes 2 and 4 and the entries' rank pairs,
    all started at once, with the single-process and JAX references made
    meanwhile."""
    root = tmp_path_factory.mktemp("mesh_train")
    fast = build_model(DotDict(_args()), device="cpu", seed=1)
    state = {k: v.clone() for k, v in fast.state_dict().items()}
    sins = build_model(DotDict(_args("Sins")), device="cpu", seed=2)
    sins_state = {k: v.clone() for k, v in sins.state_dict().items()}
    (b1, n1), (b2, n2) = _batch(0), _batch(1)
    step = dict(args=_args(), state=state, batches=[_torch(b1)],
                noises=[torch.as_tensor(n1)], loss_idx=LOSS_IDX)

    # the device pool: test_parallel.py's arrays, a K = 2 dispatch
    rng = np.random.default_rng(4)
    n_pool = 40 * F
    arrays = {
        "units": torch.as_tensor(rng.standard_normal(
            (n_pool, N_UNIT)).astype(np.float16)),
        "f0": torch.as_tensor((200 * rng.random(n_pool)).astype(np.float32)),
        "volume": torch.as_tensor(rng.random(n_pool).astype(np.float32)),
        "audio": torch.as_tensor((0.2 * rng.standard_normal(
            n_pool * BLOCK)).astype(np.float16))}
    staged = stage([{
        "feat_start": rng.integers(0, n_pool - F, B).astype(np.int32),
        "unit_start": rng.integers(0, n_pool - F, B).astype(np.int32),
        "spk_id": np.ones((B, 1), np.int64)} for _ in range(2)], "cpu")
    pool_kw = dict(args=_args(), state=state, arrays=arrays, staged=staged,
                   crop_frames=F, seed=3)
    gan_kw = _gan_inputs()[0]

    causal_args = _args(c=True, frame_norm=True)
    causal = build_model(DotDict(causal_args), device="cpu", seed=6)
    cin = _causal_inputs()
    causal_kw = dict(args=causal_args, state=causal.state_dict(),
                     **_torch(cin))

    single_ckpt = str(root / "single.pt")
    save_checkpoint(single_ckpt, 0, fast, create_optimizer(fast, LR))
    mesh_ckpt = str(root / "mesh_2x2.pt")

    # the entries' data and configs
    _write_train_data(str(root / "data" / "train"))
    _write_train_data(str(root / "data" / "val"), n_files=2)
    configs = {}
    for n_model in (1, 2):
        path = root / f"train_m{n_model}.yaml"
        path.write_text(yaml.safe_dump(_train_config(
            root / "data", root / f"exp_m{n_model}")))
        configs[n_model] = str(path)
    gan_cfg = root / "gan.yaml"
    gan_cfg.write_text(yaml.safe_dump(_gan_config(root / "data",
                                                  root / "gan_exp")))

    jobs = {2: [("dp", "mesh_steps", step, (2, 1)),
                ("sins_tp", "mesh_steps", dict(
                    step, args=_args("Sins"), state=sins_state), (1, 2)),
                ("pool", "pool_steps", pool_kw, (2, 1)),
                ("gan", "gan_steps", gan_kw, (2, 1)),
                ("causal", "synth_forward", causal_kw),
                ("causal/valid", "synth_forward",
                 dict(causal_kw, valid_frames=CAUSAL_VALID))],
            4: [("dp", "mesh_steps", step, (4, 1)),
                ("tp", "mesh_steps", step, (2, 2)),
                ("tp1x4", "mesh_steps", step, (1, 4)),
                ("tp1x4/remat", "mesh_steps", dict(step, remat=True), (1, 4)),
                ("ckpt", "mesh_steps", dict(
                    step, batches=[_torch(b1), _torch(b2)],
                    noises=[torch.as_tensor(n1), torch.as_tensor(n2)],
                    save=(1, mesh_ckpt)), (2, 2)),
                ("resume", "mesh_steps", dict(
                    step, batches=[], noises=[], resume=single_ckpt), (2, 2)),
                ("causal", "synth_forward", causal_kw),
                ("causal/valid", "synth_forward",
                 dict(causal_kw, valid_frames=CAUSAL_VALID))]}
    ranks = {w: start_ranks(j, w, str(root / f"w{w}")) for w, j in jobs.items()}
    entries = {m: _entry_ranks("train", configs[m], 2, str(root / f"m{m}"),
                               ["--n-model", str(m)]) for m in (1, 2)}
    gan_entry = _entry_ranks("train_gan", str(gan_cfg), 2, str(root))
    # the references, while the ranks run
    refs = {}
    jvars = jconvert.convert_synth_state_dict(
        {k: v.numpy() for k, v in causal.state_dict().items()}, num_layers=3)
    jcausal = JCombSubFast(sampling_rate=SR, block_size=BLOCK, n_unit=N_UNIT,
                           n_spk=N_SPK, causal=True, frame_norm=True)
    try:
        fwd = jmake_time_parallel_forward(
            jcausal, jvars, jmake_mesh(n_data=8, n_model=1), axis="data")
        refs["causal/jax"] = np.asarray(fwd(*(jnp.asarray(cin[k]) for k in (
            "units", "f0", "volume", "spk_id", "noise"))))
    finally:
        jspectral.set_fft_mode("fft")
    # JAX's GAN steps (their trace and compile the longest reference) on a
    # thread, after the DFT mode above is restored, while the rest runs here
    gan = {}

    def gan_reference():
        try:
            gan["jax"] = _gan_jax(*_gan_inputs()[1:])
        except BaseException as e:  # re-raised below, in the fixture
            gan["error"] = e

    thread = threading.Thread(target=gan_reference)
    thread.start()
    refs.update(single=_single_steps(_args(), state, [b1], [n1]),
                jax=_jax_step(state, b1, n1),
                sins=_single_steps(_args("Sins"), sins_state, [b1], [n1]))
    refs["gan/single"] = _gan_single(gan_kw)
    model = build_model(DotDict(_args()), device="cpu")
    model.load_state_dict(state)
    st = TrainState(0, model, create_optimizer(model, LR), seed=3)
    refs["pool"] = (train_steps(st, staged, RSSLoss(128, 512, n_scale=2),
                                pool=_Pool(arrays, F, BLOCK)),
                    model.state_dict())
    t = _torch(cin)
    with torch.no_grad():
        refs["causal"] = causal(t["units"], t["f0"], t["volume"],
                                t["spk_id"], noise=t["noise"], infer=True)[0]
        refs["causal/valid"] = causal(
            t["units"], t["f0"], t["volume"], t["spk_id"], noise=t["noise"],
            infer=True, valid_frames=CAUSAL_VALID)[0][:, :CAUSAL_VALID * BLOCK]

    thread.join()
    if "error" in gan:
        raise gan["error"]
    refs["gan/jax"] = gan["jax"]
    results = {w: r.wait() for w, r in ranks.items()}
    logs = {f"train_m{m}": _wait(p, str(root / f"m{m}"), "train")
            for m, p in entries.items()}
    logs["gan"] = _wait(gan_entry, str(root), "train_gan")
    yield dict(refs=refs, results=results, logs=logs, root=root,
               configs=configs, gan_cfg=str(gan_cfg), mesh_ckpt=mesh_ckpt,
               single_ckpt=single_ckpt,
               state=state, batches=((b1, n1), (b2, n2)))
    shutil.rmtree(root, ignore_errors=True)


def _params(sd):
    return {k: v for k, v in sd.items() if not k.endswith("projection_matrix")}


def _assert_step(got_loss, got_sd, ref_loss, ref_sd, loss_rtol, q99):
    assert abs(got_loss - ref_loss) <= loss_rtol * abs(ref_loss), (
        got_loss, ref_loss)
    ref_sd = _params(ref_sd)
    assert set(_params(got_sd)) == set(ref_sd)
    for k, ref in ref_sd.items():
        diff = (torch.as_tensor(got_sd[k]).double()
                - torch.as_tensor(ref).double()).abs().flatten()
        assert torch.quantile(diff, 0.99).item() < q99, (k, diff.max())
        assert diff.max().item() < MAX, (k, diff.max())


CASES = [(2, "dp"), (4, "dp"), (4, "tp"), (4, "tp1x4")]


@pytest.mark.parametrize("world,case", CASES,
                         ids=["dp2", "dp4", "tp2x2", "tp1x4"])
def test_mesh_step_matches_jax_single_device(runs, world, case):
    """One data-parallel (2 and 4 ranks) or tensor-parallel (2 x 2, 1 x 4)
    CombSubFast step against JAX's single-device make_train_step at
    tests/test_parallel.py's bounds, and against the port's single-process
    step with the loss to 1e-6 and the bulk to 1e-6. Under DP every rank's
    parameters after the step are rank 0's, bit for bit."""
    res = runs["results"][world][0][case]
    j_loss, j_sd = runs["refs"]["jax"]
    _assert_step(res["losses"][0], res["full"]["model"], j_loss, j_sd,
                 LOSS_RTOL, Q99)
    s_losses, s_sd, _ = runs["refs"]["single"]
    _assert_step(res["losses"][0], res["full"]["model"], s_losses[0], s_sd,
                 SELF_LOSS_RTOL, SELF_Q99)
    for rank in runs["results"][world][1:]:
        assert rank[case]["losses"] == res["losses"]
        if case == "dp":
            for k, v in res["local"].items():
                assert torch.equal(rank[case]["local"][k], v), k


def test_remat_under_tensor_parallel_is_exact(runs):
    """remat under 1 x 4: the recompute calls the TP collectives again in
    the same order on every rank; the step equals the plain one bit for
    bit."""
    plain = runs["results"][4][0]["tp1x4"]
    remat = runs["results"][4][0]["tp1x4/remat"]
    assert remat["losses"] == plain["losses"]
    for k, v in plain["full"]["model"].items():
        assert torch.equal(remat["full"]["model"][k], v), k


def test_tp_rules_match_jax():
    """param_shardings names the same parameters as JAX's param_shardings
    on its tree (carried into the port's names by its converter) for 2 x 2
    and 1 x 4 meshes; the guard replicates CombSubFast's 771-column
    dense_out and shards Sins' 160 columns."""
    fast = build_model(DotDict(_args()), device="cpu", seed=0)
    variables = jconvert.convert_synth_state_dict(
        {k: v.numpy() for k, v in fast.state_dict().items()}, num_layers=3)
    for n_data, n_model in ((2, 2), (1, 4)):
        jmesh = jmake_mesh(n_data=n_data, n_model=n_model)
        specs = jparam_shardings(variables["params"], jmesh)
        marks = jax.tree.map(
            lambda p, s: np.full(p.shape, float(any(a is not None
                                                    for a in s.spec)),
                                 np.float32),
            variables["params"], specs)
        jax_sharded = {k for k, v in jax_synth_to_torch(
            {"params": marks, "constants": variables["constants"]}).items()
            if not k.endswith("projection_matrix") and v.max() > 0}
        mesh = Mesh({"data": n_data, "model": n_model},
                    {"data": 0, "model": 0}, {"data": None, "model": None},
                    torch.device("cpu"))
        ours = param_shardings(fast, mesh)
        assert {k for k, s in ours.items() if s is not None} == jax_sharded
        assert ours["unit2ctrl.dec_post.2.weight_v"] is None
        assert ours["unit2ctrl.dec_post.0.net.0.attn.to_q.weight"].dim == 0
        assert ours["unit2ctrl.dec_post.0.net.0.local_mixer.net.2.weight"
                    ].layout == "glu"
        sins = build_model(DotDict(_args("Sins")), device="cpu", seed=0)
        assert param_shardings(sins, mesh)[
            "unit2ctrl.dec_post.2.weight_v"].dim == 0


def test_sins_tp_step_shards_dense_out(runs):
    """A Sins step on a 1 x 2 mesh, its 160-column dense_out sharded (each
    rank holds 80 columns): against the port's single-process step."""
    res = runs["results"][2][0]["sins_tp"]
    assert res["local"]["unit2ctrl.dec_post.2.weight_v"].shape == (80, 256)
    s_losses, s_sd, _ = runs["refs"]["sins"]
    _assert_step(res["losses"][0], res["full"]["model"], s_losses[0], s_sd,
                 SELF_LOSS_RTOL, SELF_Q99)


def test_dp_pool_k_steps_match_single_process(runs):
    """A K = 2 dispatch on the device pool (the CPU's eager form) over 2
    ranks, the crop indices cut to each rank's rows and the noise and loss
    scales drawn from the step seeds: against the same dispatch in one
    process."""
    res = runs["results"][2][0]["pool"]
    losses, sd = runs["refs"]["pool"]
    for got, ref in zip(res["losses"], losses):
        assert abs(float(got) - float(ref)) <= SELF_LOSS_RTOL * abs(float(ref))
    _assert_step(float(res["losses"][-1]), res["full"]["model"],
                 float(losses[-1]), sd, SELF_LOSS_RTOL, SELF_Q99)


def test_checkpoint_under_2x2_resumes_on_one_process(runs):
    """A checkpoint written by rank 0 under 2 x 2 after step 1 holds the
    single-device state: one process restores it (model and AdamW) and
    takes step 2, matching the mesh's step 2 (the loss to 1e-6, the
    parameters at tests/test_parallel.py's bounds: a second AdamW step
    spreads the first's float noise; AdamW's moments within 1e-3 of their
    max); a single-device checkpoint
    cut onto 2 x 2 and gathered back is itself, bit for bit."""
    res = runs["results"][4][0]["ckpt"]
    (_, _), (b2, n2) = runs["batches"]
    losses, sd, opt = _single_steps(_args(), runs["state"], [b2], [n2],
                                    resume=runs["mesh_ckpt"])
    _assert_step(res["losses"][1], res["full"]["model"], losses[0], sd,
                 SELF_LOSS_RTOL, Q99)
    ref = opt.state_dict()["state"]
    for i, st in res["full"]["opt"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            diff = (st[k] - ref[i][k]).abs()
            assert diff.max() <= 1e-3 * ref[i][k].abs().max() + 1e-12, (i, k)
    payload = torch.load(runs["single_ckpt"], weights_only=True)
    back = runs["results"][4][0]["resume"]["full"]
    for k, v in payload["model"].items():
        assert torch.equal(back["model"][k], v), k
    assert runs["results"][4][0]["resume"]["step"] == 0


def test_dp_gan_steps_match_jax(runs):
    """One data-parallel D and G step over 2 ranks (rand_ini drawn for the
    whole batch, each rank its rows) against JAX's GanTrainer with
    mesh=None: every loss within 1e-4 relative, the generator's parameters
    within atol 1e-5 + rtol 1e-4 (tests/test_parallel.py's bounds); and
    against the port's single-process steps. Both ranks' generators are
    the same, bit for bit."""
    res = runs["results"][2][0]["gan"]
    for k, v in res["generator"].items():
        assert torch.equal(runs["results"][2][1]["gan"]["generator"][k], v), k
    for ref in (runs["refs"]["gan/jax"], runs["refs"]["gan/single"]):
        for k, v in ref["logs"].items():
            assert abs(res["logs"][k] - v) <= 1e-4 * abs(v), (k, v)
        for k, v in ref["generator"].items():
            np.testing.assert_allclose(
                res["generator"][k].numpy(), torch.as_tensor(v).numpy(),
                atol=1e-5, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("valid", ("", "/valid"), ids=("full", "valid"))
def test_causal_model_time_sharded(runs, world, valid):
    """A causal + frame_norm CombSubFast's 256 frames over 2 and 4 ranks
    (the causal attention carrying the lower ranks' moments in): every
    rank's whole signal within 1e-5 x max|ref| of the unsharded causal
    forward, also with 150 valid frames; and within JAX's own 3e-3 of its
    time-parallel forward of the same model on 8 devices (DFT mode)."""
    results = runs["results"][world]
    got = results[0]["causal" + valid]
    for rank in results[1:]:
        assert torch.equal(rank["causal" + valid], got)
    ref = runs["refs"]["causal" + valid]
    got = got[:, :ref.shape[1]]
    err = (got - ref).abs().max() / ref.abs().max()
    assert err <= CAUSAL_TOL, err
    if not valid:
        jref = runs["refs"]["causal/jax"]
        assert (np.abs(got.numpy() - jref).max() / np.abs(jref).max()
                < 3e-3)


def test_train_entry_on_two_ranks_resumes_on_one(runs, monkeypatch):
    """`python -m ddsp_svc_tpu_torch.train ... --num-processes 2` over Gloo
    with --n-model 1 (data-parallel, one row a rank) and --n-model 2
    (tensor-parallel), K = 2 on the device pool: two steps, rank 0 alone
    logging and writing model_2.pt; one process resumes each from it."""
    root = runs["root"]
    for m in (1, 2):
        logs = runs["logs"][f"train_m{m}"]
        assert f"mesh: data={2 // m} x model={m}" in logs[0]
        assert "model checkpoint saved" in logs[0]
        assert "model checkpoint saved" not in logs[1]
        exp = root / f"exp_m{m}"
        assert (exp / "model_2.pt").is_file()
        payload = torch.load(exp / "model_2.pt", weights_only=True)
        assert payload["global_step"] == 2
        full = build_model(DotDict(_train_config(root, exp)), device="cpu")
        assert {k: v.shape for k, v in payload["model"].items()} == {
            k: v.shape for k, v in full.state_dict().items()}
    restored = {}
    real = train_main.restore_checkpoint

    def spy(path, model, optimizer=None):
        restored[path] = real(path, model, optimizer)
        return restored[path]

    monkeypatch.setattr(train_main, "restore_checkpoint", spy)
    state, saver = train_main.main(["-c", runs["configs"][2], "--max-steps",
                                    "2", "--device", "cpu"])
    assert list(restored.values()) == [2]
    assert state.step == saver.global_step == 4


def test_gan_entry_data_parallel_on_two_ranks(runs):
    """`python -m ddsp_svc_tpu_torch.train_gan ... --num-processes 2` with
    train.gan.data_parallel: two D + G steps over 2 ranks (a row each);
    rank 0 alone logs, validates and writes gan_2.pt and the export."""
    logs = runs["logs"]["gan"]
    assert "gan step 2/2" in logs[0] and "gan step" not in logs[1]
    exp = runs["root"] / "gan_exp"
    assert (exp / "gan_2.pt").is_file()
    assert (exp / "enhancer" / "model_2.pt").is_file()


def test_mesh_arguments_raise(runs):
    """The entries' mesh flags and the loop's mesh checked before any
    work: --no-data-parallel trains one process alone; --n-model divides
    --num-processes; the data axis divides train.batch_size."""
    from ddsp_svc_tpu_torch.train import solver
    from ddsp_svc_tpu_torch.train_gan import main as gan_main
    from ddsp_svc_tpu_torch.utils.config import load_config

    cfg = runs["configs"][1]
    with pytest.raises(ValueError, match="one process alone"):
        train_main.main(["-c", cfg, "--no-data-parallel", "--n-model", "2",
                         "--device", "cpu"])
    with pytest.raises(ValueError, match="one process alone"):
        gan_main(["-c", runs["gan_cfg"], "--no-data-parallel",
                  "--num-processes", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="must divide"):
        train_main.main(["-c", cfg, "--num-processes", "3", "--n-model", "2",
                         "--device", "cpu"])
    mesh = Mesh({"data": 4, "model": 1}, {"data": 0, "model": 0},
                {"data": None, "model": None}, torch.device("cpu"))
    with pytest.raises(ValueError, match="batch_size 2 must divide"):
        solver.train(load_config(cfg), 0, None, None, None, None, mesh=mesh)
