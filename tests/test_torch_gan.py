"""PyTorch port, enhancer GAN fine-tuning against the JAX package on the CPU
at a small size (16 kHz, hop 64, upsample 4/4/2/2, initial channel 32,
resblock kernels 3/7/11; B = 2 crops of 16 frames, tests/test_gan.py's
batch): the discriminators' scores and feature maps, the three losses, one
D step and one G step (every loss term and every parameter gradient, the
source merge's included), AdamW against optax.adamw, the crop sampler and
the device clip pool.

The weights are the port's, drawn from seeds and mapped into the JAX
package (the generator by its own converter); the JAX gradients come back
through `jax_nsf_to_torch` and `jax_discriminators_to_torch`. Both sides
get the same rand_ini: the port's steps take JAX's draw. The JAX gradients
are read from the JAX steps themselves, whose optimizers are swapped for
one that stores the gradients as its state. The JAX G step runs in float64
(`jax.enable_x64`), so the port's float32 generator gradients are held to
JAX's exact ones rather than to JAX's own float32 rounding."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import optax
import pytest
import torch

from ddsp_svc_tpu.data.wavio import write_wav
from ddsp_svc_tpu.nn import discriminators as jdisc
from ddsp_svc_tpu.nn.nsf_hifigan import Generator as JGenerator
from ddsp_svc_tpu.ops import log_mel_spectrogram as j_log_mel
from ddsp_svc_tpu.train import gan_solver as jsolver
from ddsp_svc_tpu.train.gan import GanState as JGanState
from ddsp_svc_tpu.train.gan import GanTrainer as JGanTrainer
from ddsp_svc_tpu.utils import convert as jconvert
from ddsp_svc_tpu_torch.nn import discriminators as tdisc
from ddsp_svc_tpu_torch.nn.layers import lecun_init_
from ddsp_svc_tpu_torch.nn.nsf_hifigan import generator_from_h
from ddsp_svc_tpu_torch.train import gan_solver
from ddsp_svc_tpu_torch.train.gan import GanTrainer, create_optimizer
from ddsp_svc_tpu_torch.utils.convert import (jax_discriminators_to_torch,
                                              jax_nsf_to_torch)

torch.set_num_threads(2)

SR, HOP = 16000, 64
H = {
    "sampling_rate": SR, "num_mels": 16, "n_fft": 512, "win_size": 512,
    "hop_size": HOP, "fmin": 40, "fmax": 8000,
    "upsample_rates": [4, 4, 2, 2], "upsample_kernel_sizes": [8, 8, 4, 4],
    "upsample_initial_channel": 32, "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5]] * 3,
}
B, FRAMES = 2, 16
LR = 2e-4
# scores and feature maps: both fp32 on the CPU, through the same convs
ATOL, RTOL = 1e-5, 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # x the max |ref| of each gradient tensor
# the period-7 discriminator's third conv: its D-step gradients, float32
# sums over every output position, read 1.1e-4 (bias) and 9.1e-5 (weight)
# x max |ref| from JAX's float32 step, whose own are that far from JAX's
# step in float64 (the port's within 5e-7 of it); held at NOISY_TOL x max
# |ref|
NOISY_D = {"mpd": {"discriminators.3.convs.2.bias",
                   "discriminators.3.convs.2.weight"}}
NOISY_TOL = 10 * GRAD_TOL


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _batch():
    t = np.arange(FRAMES * HOP) / SR
    rng = np.random.default_rng(3)
    audio = np.stack([0.4 * np.sin(2 * np.pi * 220 * t),
                      0.3 * np.sin(2 * np.pi * 300 * t)])
    audio = (audio + 0.02 * rng.standard_normal(audio.shape)).astype(
        np.float32)
    f0 = np.stack([np.full(FRAMES, 220.0), np.full(FRAMES, 300.0)]).astype(
        np.float32)
    mel = np.asarray(jnp.swapaxes(j_log_mel(
        jnp.asarray(audio), SR, H["n_fft"], HOP, H["win_size"], H["num_mels"],
        H["fmin"], H["fmax"]), 1, 2))
    return {"audio": audio, "f0": f0, "mel": mel}


def _rand_ini(key):
    """JAX GanTrainer._generate's draw for a step's key."""
    ri = jax.random.uniform(jax.random.fold_in(key, 0), (B, 9))
    return np.asarray(ri.at[:, 0].set(0.0))


def _grads_capture():
    """An optax transformation that leaves the parameters as they are and
    keeps the last gradients as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


class _Float64GanTrainer(JGanTrainer):
    """JAX's GanTrainer whose rand_ini is drawn in float32, as JAX's float32
    step draws it, and cast to the batch's dtype: the same rand_ini under
    jax.enable_x64."""

    def _generate(self, g_params, batch, rng):
        ri = jax.random.uniform(rng, (batch["mel"].shape[0], 9), jnp.float32)
        ri = ri.at[:, 0].set(0.0).astype(batch["mel"].dtype)
        return self.generator.apply({"params": g_params}, batch["mel"],
                                    batch["f0"], ri)


def _flax_discriminators(mpd, msd):
    """The port's discriminators as the JAX package's params {'mpd', 'msd'}
    (the inverse of jax_discriminators_to_torch)."""
    out = {}
    for key, module, names in (("mpd", mpd, [f"disc_p{p}" for p in
                                             tdisc.PERIODS]),
                               ("msd", msd, [f"disc_s{i}" for i in range(3)])):
        out[key] = {}
        for name, d in zip(names, module.discriminators):
            convs = [*d.convs, d.conv_post]
            out[key][name] = {f"Conv_{j}": {
                "kernel": jnp.asarray(c.weight.detach().numpy().transpose(
                    (2, 3, 1, 0) if c.weight.ndim == 4 else (2, 1, 0))),
                "bias": jnp.asarray(c.bias.detach().numpy())}
                for j, c in enumerate(convs)}
    return out


def _flax_generator(sd):
    """The port's generator state dict as the JAX package's params (its own
    converter)."""
    return jconvert.convert_nsf_hifigan_state_dict(
        {k: v.numpy() for k, v in sd.items()}, H)["params"]


def _port_weights():
    """The port's generator and discriminators from seeds, as state
    dicts."""
    g = lecun_init_(generator_from_h(H), torch.Generator().manual_seed(0))
    state = GanTrainer(H, lr=LR).create_state(g, seed=1)
    return (g.state_dict(), state.mpd.state_dict(), state.msd.state_dict(),
            _flax_discriminators(state.mpd, state.msd))


def _jax_step(gen, phase: str, batch, g_params, d_params, key, dtype):
    """One JAX step ("d" or "g") in `dtype` from the given weights, its
    optimizers swapped for the gradient capture: (logs, state)."""
    trainer = (JGanTrainer if dtype == jnp.float32 else _Float64GanTrainer)(
        gen, H, lr=LR)
    capture = _grads_capture()
    trainer.g_optimizer = trainer.d_optimizer = capture
    # copies: the step donates its state
    cast = lambda t: jax.tree.map(lambda a: jnp.array(a, dtype), t)  # noqa
    g_params, d_params = cast(g_params), cast(d_params)
    state = JGanState(step=jnp.asarray(0, jnp.int32), g_params=g_params,
                      d_params=d_params, g_opt=capture.init(g_params),
                      d_opt=capture.init(d_params))
    step = trainer.step_d if phase == "d" else trainer.step_g
    return step(state, cast(batch), key)


@pytest.fixture(scope="module")
def jax_steps():
    """One JAX D step in float32 and one JAX G step in float64 (its sine
    source and every conv in float64; JAX rounds the generator's last tanh
    to float32) from the same state, the port's seeded weights mapped into
    it (the generator by the JAX package's own converter): their logs,
    their gradients and rand_ini, and the weights."""
    gen = JGenerator(
        sampling_rate=SR, num_mels=H["num_mels"],
        upsample_rates=tuple(H["upsample_rates"]),
        upsample_kernel_sizes=tuple(H["upsample_kernel_sizes"]),
        upsample_initial_channel=H["upsample_initial_channel"],
        resblock_kernel_sizes=tuple(H["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(tuple(d) for d in
                                      H["resblock_dilation_sizes"]))
    batch = _batch()
    g_sd, mpd_sd, msd_sd, d_params = _port_weights()
    g_params = _flax_generator(g_sd)
    kd, kg = jax.random.key(11), jax.random.key(12)
    sd, d_logs = _jax_step(gen, "d", batch, g_params, d_params, kd,
                           jnp.float32)
    with jax.enable_x64(True):
        sg, g_logs = _jax_step(gen, "g", batch, g_params, d_params, kg,
                               jnp.float64)
        g_grads = jax.tree.map(np.asarray, sg.g_opt)
        g_logs = {k: float(v) for k, v in g_logs.items()}
    return dict(
        batch=batch, g_sd=g_sd, mpd_sd=mpd_sd, msd_sd=msd_sd,
        d_params=jax.tree.map(np.asarray, d_params),
        d_logs={k: float(v) for k, v in d_logs.items()},
        g_logs=g_logs,
        d_grads=jax.tree.map(np.asarray, sd.d_opt),
        g_grads=g_grads,
        ri_d=_rand_ini(kd), ri_g=_rand_ini(kg), d_step=int(sd.step))


def _port_step(jax_steps, phase: str):
    """One port step ("d" or "g") from the fixture's weights, batch and
    rand_ini: (logs, state)."""
    g = generator_from_h(H)
    g.load_state_dict(jax_steps["g_sd"])
    trainer = GanTrainer(H, lr=LR)
    state = trainer.create_state(g, seed=0)
    state.mpd.load_state_dict(jax_steps["mpd_sd"])
    state.msd.load_state_dict(jax_steps["msd_sd"])
    batch = {k: _t(v) for k, v in jax_steps["batch"].items()}
    step = trainer.step_d if phase == "d" else trainer.step_g
    logs = step(state, batch, rand_ini=_t(jax_steps["ri_" + phase]))
    return logs, state


def _assert_grads(module, ref_sd, label, noisy=()):
    """Every parameter's .grad against the JAX gradient mapped into the
    port's layout, within GRAD_TOL x max |ref| (NOISY_TOL for the names in
    `noisy`). A missing gradient fails by name."""
    named = dict(module.named_parameters())
    assert sorted(named) == sorted(ref_sd), label
    for name, p in named.items():
        assert p.grad is not None, f"{label}: no gradient for {name}"
        ref, got = ref_sd[name].numpy(), p.grad.numpy()
        err = np.abs(got - ref).max() / np.abs(ref).max()
        tol = NOISY_TOL if name in noisy else GRAD_TOL
        assert err <= tol, f"{label}: {name} {err:.3e} x max|ref| > {tol}"


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


# ---------------------------------------------------- the discriminators ---


@pytest.mark.parametrize("kind", ["mpd", "msd"])
def test_discriminator_scores_and_feature_maps_match_jax(jax_steps, kind):
    """Scores and every feature map of y and y_hat (1063 samples:
    DiscriminatorP reflect-pads to each period) against the JAX discriminator with the
    same weights: atol 1e-5, rtol 1e-4."""
    rng = np.random.default_rng(1)
    y, y_hat = (0.3 * rng.standard_normal((B, 1063))).astype(np.float32), \
        (0.3 * rng.standard_normal((B, 1063))).astype(np.float32)
    jmod = (jdisc.MultiPeriodDiscriminator() if kind == "mpd"
            else jdisc.MultiScaleDiscriminator())
    ref = jax.jit(jmod.apply)({"params": jax_steps["d_params"][kind]},
                              jnp.asarray(y), jnp.asarray(y_hat))
    tmod = (tdisc.MultiPeriodDiscriminator() if kind == "mpd"
            else tdisc.MultiScaleDiscriminator())
    tmod.load_state_dict(jax_steps[kind + "_sd"])
    with torch.no_grad():
        got = tmod(_t(y), _t(y_hat))
    n_sub = 5 if kind == "mpd" else 3
    for scores_j, scores_t in zip(ref[:2], got[:2]):
        assert len(scores_t) == n_sub
        for s_j, s_t in zip(scores_j, scores_t):
            np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j),
                                       atol=ATOL, rtol=RTOL)
    for fmaps_j, fmaps_t in zip(ref[2:], got[2:]):
        for sub_j, sub_t in zip(fmaps_j, fmaps_t):
            assert len(sub_t) == len(sub_j) == (6 if kind == "mpd" else 8)
            for f_j, f_t in zip(sub_j, sub_t):
                # torch (B, C, ...) against JAX's channel-last (B, ..., C)
                f_t = np.moveaxis(f_t.numpy(), 1, -1)
                np.testing.assert_allclose(f_t, np.asarray(f_j), atol=ATOL,
                                           rtol=RTOL)


def test_discriminator_converter_inverts_the_flax_layout(jax_steps):
    """jax_discriminators_to_torch of the port's discriminators in the flax
    layout gives back their state dicts exactly."""
    got = jax_discriminators_to_torch(jax_steps["d_params"])
    for kind in ("mpd", "msd"):
        want = jax_steps[kind + "_sd"]
        assert sorted(got[kind]) == sorted(want)
        for k, v in want.items():
            assert torch.equal(got[kind][k], v), k


def test_grouped_conv_groups_in_the_same_order():
    """A flax conv of 4 groups whose kernels differ per group, carried by
    the converter: the port's grouped conv gives the same output channels
    in the same order (each group's channels from its own inputs)."""
    conv = fnn.Conv(8, (5,), feature_group_count=4, padding=((2, 2),))
    x = np.random.default_rng(2).standard_normal((1, 12, 8)).astype(np.float32)
    params = conv.init(jax.random.key(3), jnp.asarray(x))["params"]
    kernel = np.asarray(params["kernel"]).copy()  # (5, 2, 8)
    kernel *= np.repeat(10.0 ** np.arange(4), 2)[None, None, :]
    params = {"kernel": jnp.asarray(kernel), "bias": params["bias"]}
    ref = np.asarray(conv.apply({"params": params}, jnp.asarray(x)))
    # through the discriminators' converter, as a scale discriminator's conv
    d = {"disc_s0": {"Conv_0": params, "Conv_1": params}}
    sd = jax_discriminators_to_torch({"mpd": {}, "msd": d})["msd"]
    w = sd["discriminators.0.convs.0.weight"]
    b = sd["discriminators.0.convs.0.bias"]
    got = torch.nn.functional.conv1d(_t(x).transpose(1, 2), w, b, padding=2,
                                     groups=4).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_gan_losses_match_jax():
    rng = np.random.default_rng(4)
    fr = [[rng.standard_normal((2, 7)).astype(np.float32) for _ in range(3)]
          for _ in range(2)]
    fg = [[rng.standard_normal((2, 7)).astype(np.float32) for _ in range(3)]
          for _ in range(2)]
    jt = lambda xs: [[jnp.asarray(a) for a in d] for d in xs]  # noqa: E731
    tt = lambda xs: [[_t(a) for a in d] for d in xs]  # noqa: E731
    assert _rel(tdisc.feature_loss(tt(fr), tt(fg)),
                jdisc.feature_loss(jt(fr), jt(fg))) < LOSS_RTOL
    dr = [rng.standard_normal((2, 5)).astype(np.float32) for _ in range(3)]
    dg = [rng.standard_normal((2, 5)).astype(np.float32) for _ in range(3)]
    got = tdisc.discriminator_loss([_t(a) for a in dr], [_t(a) for a in dg])
    ref = jdisc.discriminator_loss([jnp.asarray(a) for a in dr],
                                   [jnp.asarray(a) for a in dg])
    assert _rel(got[0], ref[0]) < LOSS_RTOL
    for g_terms, r_terms in zip(got[1:], ref[1:]):
        for a, b in zip(g_terms, r_terms):
            assert _rel(a, b) < LOSS_RTOL
    got = tdisc.generator_loss([_t(a) for a in dg])
    ref = jdisc.generator_loss([jnp.asarray(a) for a in dg])
    assert _rel(got[0], ref[0]) < LOSS_RTOL
    for a, b in zip(got[1], ref[1]):
        assert _rel(a, b) < LOSS_RTOL


# --------------------------------------------------------------- the steps --


def test_step_d_matches_jax(jax_steps):
    """One D step against JAX's in float32: d_loss to 1e-5 relative; every
    MPD and MSD gradient within 1e-4 x its max |ref| (NOISY_D's within
    1e-3); the generator gets no gradient; the step counts D steps."""
    logs, state = _port_step(jax_steps, "d")
    assert _rel(logs["d_loss"], jax_steps["d_logs"]["d_loss"]) < LOSS_RTOL
    grads = jax_discriminators_to_torch(jax_steps["d_grads"])
    for kind in ("mpd", "msd"):
        _assert_grads(getattr(state, kind), grads[kind], kind,
                      NOISY_D.get(kind, ()))
    assert all(p.grad is None for p in state.generator.parameters())
    assert state.step == jax_steps["d_step"] == 1


def test_step_g_matches_jax(jax_steps):
    """One G step against JAX's in float64: g_loss, mel, fm and adv to 1e-5
    relative; every generator gradient, the source merge's
    (m_source.l_linear) included, within 1e-4 x its max |ref|; no
    discriminator gradient; the step count unchanged."""
    logs, state = _port_step(jax_steps, "g")
    for k in ("g_loss", "mel", "fm", "adv"):
        assert _rel(logs[k], jax_steps["g_logs"][k]) < LOSS_RTOL, k
    ref = jax_nsf_to_torch(jax_steps["g_grads"], H)
    _assert_grads(state.generator, ref, "generator")
    lin = state.generator.m_source.l_linear
    assert lin.weight.grad.abs().max() > 0 and lin.bias.grad.abs().max() > 0
    assert all(p.grad is None for p in state.d_parameters())
    assert state.step == 0


def test_adamw_matches_optax(jax_steps):
    """Two AdamW updates of the generator's parameters on injected
    gradients against optax.adamw(lr, 0.8, 0.99) (its weight decay 1e-4,
    which torch's default 1e-2 would miss by ~4e-6 x |p|): within 1e-7
    plus one float32 ulp of each value."""
    g = generator_from_h(H)
    g.load_state_dict(jax_steps["g_sd"])
    opt = create_optimizer(g.parameters(), LR)
    params = jax.tree.map(jnp.asarray, _flax_generator(jax_steps["g_sd"]))
    ref_opt = optax.adamw(LR, b1=0.8, b2=0.99)
    ref_state = ref_opt.init(params)

    @jax.jit
    def step(grads, opt_state, params):
        updates, opt_state = ref_opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    rng = np.random.default_rng(5)
    for _ in range(2):
        grads = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32)), params)
        params, ref_state = step(grads, ref_state, params)
        tg = jax_nsf_to_torch(jax.tree.map(np.asarray, grads), H)
        for name, p in g.named_parameters():
            p.grad = tg[name]
        opt.step()
    ref = jax_nsf_to_torch(jax.tree.map(np.asarray, params), H)
    for name, p in g.named_parameters():
        want = ref[name].numpy()
        err = np.abs(p.detach().numpy() - want)
        assert (err <= 1e-7 + np.spacing(np.abs(want))).all(), name


# ---------------------------------------------------------------- the data --


@pytest.fixture(scope="module")
def gan_data(tmp_path_factory):
    """Three clips of 0.5-0.9 s at 16 kHz with f0 at the data hop 256."""
    root = tmp_path_factory.mktemp("gan_data")
    rng = np.random.default_rng(6)
    for i, dur in enumerate((0.5, 0.9, 0.7)):
        spk = str(1 + i % 2)
        os.makedirs(root / "audio" / spk, exist_ok=True)
        os.makedirs(root / "f0" / spk, exist_ok=True)
        n = int(dur * SR)
        write_wav(str(root / "audio" / spk / f"c{i}.wav"),
                  (0.3 * rng.standard_normal(n)).astype(np.float32), SR)
        np.save(str(root / "f0" / spk / f"c{i}.npy"),
                (150 + 100 * rng.random(n // 256 + 1)).astype(np.float32))
    return str(root)


def test_sample_batch_matches_jax(gan_data):
    """The clips, the re-gridded f0 and three batches drawn from one seed,
    bit for bit against the JAX GanDataset."""
    ours = gan_solver.GanDataset(gan_data, H, SR, 256)
    ref = jsolver.GanDataset(gan_data, H, SR, 256)
    assert len(ours.clips) == len(ref.clips) == 3
    for (a, f), (ra, rf) in zip(ours.clips, ref.clips):
        np.testing.assert_array_equal(a, ra)
        np.testing.assert_array_equal(f, rf)
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        got, want = ours.sample_batch(r1, 4, FRAMES), ref.sample_batch(r2, 4,
                                                                       FRAMES)
        for k in ("audio", "f0"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_pooled_crop_matches_host_crop(gan_data):
    """ClipPool.gather at pinned (clip, start) pairs against the host crop:
    the audio equal to the host crop rounded to float16 (the pool stores
    float16, as JAX's), the f0 equal, the mel the mel of that audio."""
    ds = gan_solver.GanDataset(gan_data, H, SR, 256)
    pool = gan_solver.ClipPool(ds, FRAMES, "cpu")
    picks = [(0, 0), (1, 3), (2, int(pool.clip_max_start[2]))]
    got = pool.gather(np.asarray([pool.clip_base[c] + k for c, k in picks]))
    for i, (c, k) in enumerate(picks):
        audio, f0 = ds.clips[c]
        want = audio[k * HOP:(k + FRAMES) * HOP].astype(np.float16)
        np.testing.assert_array_equal(got["audio"][i].numpy(),
                                      want.astype(np.float32))
        np.testing.assert_array_equal(got["f0"][i].numpy(), f0[k:k + FRAMES])
    mel = gan_solver.mel_of(H, got["audio"]).transpose(1, 2)
    np.testing.assert_array_equal(got["mel"].numpy(), mel.numpy())
    assert got["mel"].shape == (3, FRAMES, H["num_mels"])
    # the starts are drawn as the JAX pool draws them, inside each clip
    s = pool.starts(np.random.default_rng(0), 64)
    assert ((s >= 0) & (s + FRAMES <= len(pool.f0))).all()
