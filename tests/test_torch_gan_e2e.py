"""PyTorch port, enhancer GAN fine-tuning end to end on the CPU
(`--device cpu`): `python -m ddsp_svc_tpu_torch.train_gan` on a
preprocessed-layout dataset writes, resumes and exports as the JAX
package's test_train_gan_cli_checkpoint_resume_and_export checks, the
resumed run on the device clip pool; the port's exported enhancer loads into the JAX
package's Enhancer and the port's with the same output; and a flax-msgpack
enhancer checkpoint as the JAX package's GAN export writes it loads into
the port with the JAX Enhancer's output."""
import contextlib
import io
import json
import os

import numpy as np
import jax
import pytest
import torch
import yaml
from flax import serialization

from ddsp_svc_tpu.infer.enhancer import Enhancer as JEnhancer
from ddsp_svc_tpu.utils import convert as jconvert
from ddsp_svc_tpu_torch import train_gan as entry
from ddsp_svc_tpu_torch.data.wavio import write_wav
from ddsp_svc_tpu_torch.infer.enhancer import Enhancer
from ddsp_svc_tpu_torch.nn.layers import lecun_init_
from ddsp_svc_tpu_torch.nn.nsf_hifigan import Generator, generator_from_h
from ddsp_svc_tpu_torch.train.gan_solver import train_gan
from ddsp_svc_tpu_torch.utils.config import DotDict

torch.set_num_threads(2)

SR, HOP = 16000, 256
H = {
    "sampling_rate": SR, "num_mels": 16, "n_fft": 512, "win_size": 512,
    "hop_size": 64, "fmin": 40, "fmax": 8000,
    "upsample_rates": [4, 4, 2, 2], "upsample_kernel_sizes": [8, 8, 4, 4],
    "upsample_initial_channel": 32, "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5]] * 3,
}
# enhance against the JAX Enhancer: the CLI's bound, x max |ref|
ENHANCE_TOL = 2e-4


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Two 1 s training clips and one validation clip (tests/test_gan_e2e.py's
    layout, f0 at the data hop 256)."""
    root = tmp_path_factory.mktemp("gan_ws")
    for split, n in (("train", 2), ("val", 1)):
        for i in range(n):
            adir = root / split / "audio" / "1"
            fdir = root / split / "f0" / "1"
            adir.mkdir(parents=True, exist_ok=True)
            fdir.mkdir(parents=True, exist_ok=True)
            t = np.arange(SR) / SR
            f0_hz = 200.0 + 20 * i
            audio = (0.4 * np.sin(2 * np.pi * f0_hz * t)).astype(np.float32)
            write_wav(str(adir / f"u{i}.wav"), audio, SR)
            np.save(str(fdir / f"u{i}.npy"),
                    np.full(len(audio) // HOP + 1, f0_hz, np.float32))
    return root


def _config(root, expdir, **gan):
    return {
        "data": {"sampling_rate": SR, "block_size": HOP,
                 "train_path": str(root / "train"),
                 "valid_path": str(root / "val")},
        "enhancer": {"type": "nsf-hifigan", "ckpt": None},
        "env": {"expdir": str(root / "exp")},
        "train": {"seed": 0, "gan": {
            "h": H, "lr": 1e-4, "batch_size": 2, "crop_frames": 16,
            "interval_log": 1, "interval_val": 2, "max_steps": 100,
            "expdir": str(expdir), **gan}},
    }


def _write_config(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


@pytest.fixture(scope="module")
def trained(workspace):
    """The entry run to step 2 (validation and export every 2 steps), then
    resumed to 4 on the device clip pool (train.gan.data_on_device, on the
    CPU here) with a rand_hook, each generator forward's rand_ini recorded:
    a dict of the expdir, the expdir the entry returned, the generator's
    weights at step 2, the resumed run's state, its rand_hook calls, the
    rand_ini its forwards got and its log."""
    expdir = workspace / "exp" / "gan"
    cfg = _write_config(workspace / "gan.yaml", _config(workspace, expdir))
    state2, out = entry.main(["-c", cfg, "--max-steps", "2", "--device",
                              "cpu"])
    gen2 = {k: v.clone() for k, v in state2.generator.state_dict().items()}
    calls, seen = [], []

    def rand_hook(step, phase):
        calls.append((step, phase))
        ri = np.zeros((2, 9), np.float32)
        ri[:, 1:] = 0.1 * len(calls)
        return ri

    forward = Generator.forward

    def recording(self, mel, f0, rand_ini, valid_frames=None):
        seen.append(rand_ini.clone())
        return forward(self, mel, f0, rand_ini, valid_frames)

    log = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(log):
        mp.setattr(Generator, "forward", recording)
        args = DotDict(_config(workspace, expdir, data_on_device=True))
        state4, _ = train_gan(args, max_steps=4, device="cpu",
                              rand_hook=rand_hook)
    return dict(expdir=str(expdir), out=out, gen2=gen2, state4=state4,
                calls=calls, seen=seen, log=log.getvalue())


def test_entry_writes_resumes_and_exports(trained):
    """gan_{2,4}.pt, enhancer/model_{2,4,best}.pt and config.json = h; the
    second run restores gan_2.pt (its weights and step) and goes on to
    step 4 (the last step validates and exports); the export holds the
    generator's plain weights."""
    expdir, state4 = trained["expdir"], trained["state4"]
    assert trained["out"] == expdir and state4.step == 4
    assert (" [*] restoring GAN checkpoint: "
            + os.path.join(expdir, "gan_2.pt")) in trained["log"]
    for n in (2, 4):
        assert os.path.isfile(os.path.join(expdir, f"gan_{n}.pt"))
        assert os.path.isfile(os.path.join(expdir, "enhancer",
                                           f"model_{n}.pt"))
    enh_dir = os.path.join(expdir, "enhancer")
    assert os.path.isfile(os.path.join(enh_dir, "model_best.pt"))
    with open(os.path.join(enh_dir, "config.json")) as f:
        assert json.load(f) == H
    ckpt = torch.load(os.path.join(expdir, "gan_2.pt"), weights_only=True)
    assert ckpt["global_step"] == 2
    assert sorted(ckpt) == ["d_opt", "discriminators", "g_opt", "generator",
                            "global_step"]
    assert sorted(ckpt["discriminators"]) == ["mpd", "msd"]
    for k, v in trained["gen2"].items():
        assert torch.equal(ckpt["generator"][k], v), k
    exported = torch.load(os.path.join(enh_dir, "model_4.pt"),
                          weights_only=True)["generator"]
    for k, v in state4.generator.state_dict().items():
        assert torch.equal(exported[k], v), k
    assert not any(k.endswith(("weight_g", "weight_v")) for k in exported)


def test_clip_pool_hook_and_log_lines(trained):
    """The resumed run on the device clip pool, 2 steps, with the JAX
    loop's log lines; rand_hook is asked for each step's rand_ini, D then
    G, and what it returns is what the generator gets."""
    assert trained["calls"] == [(2, "d"), (3, "g"), (3, "d"), (4, "g")]
    # four steps' forwards, then the validation's (rand_ini zeros)
    assert [round(float(r[0, 1]), 4) for r in trained["seen"]] == [
        0.1, 0.2, 0.3, 0.4, 0.0]
    text = trained["log"]
    assert " [pool] 2 clips" in text
    assert "gan step 4/4 | d_loss: " in text and " it/s" in text
    for key in ("g_loss", "mel", "fm", "adv"):
        assert f"| {key}: " in text
    assert " --- <gan validation> --- mel-L1: " in text


def test_entry_device_policy(workspace, tmp_path):
    """CUDA unless asked: without a card and without --device the entry
    raises; train.gan.data_parallel is not ported and raises."""
    args = DotDict(_config(workspace, tmp_path / "g"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_gan(args, max_steps=1)
    args["train"]["gan"]["data_parallel"] = True
    with pytest.raises(NotImplementedError, match="data_parallel"):
        train_gan(args, max_steps=1, device="cpu")


def _enhance_inputs():
    rng = np.random.default_rng(8)
    n = 20 * HOP
    t = np.arange(n) / SR
    audio = (0.3 * np.sin(2 * np.pi * 220 * t)
             + 0.02 * rng.standard_normal(n)).astype(np.float32)[None]
    f0 = np.linspace(200, 260, n // HOP + 1, dtype=np.float32)[None, :, None]
    ri = np.concatenate([[0.0], rng.random(8)])[None].astype(np.float32)
    return audio, f0, ri


def _assert_enhance_agrees(port_enh, jax_enh):
    audio, f0, ri = _enhance_inputs()
    ref, sr_j = jax_enh.enhance(audio, SR, f0, HOP, rand_ini=ri)
    got, sr_t = port_enh.enhance(torch.from_numpy(audio), SR, f0, HOP,
                                 rand_ini=ri)
    ref = np.asarray(ref)
    assert sr_t == sr_j == SR and got.shape == ref.shape
    err = np.abs(got.numpy() - ref).max()
    assert err <= ENHANCE_TOL * np.abs(ref).max(), err / np.abs(ref).max()


def test_exported_enhancer_loads_in_jax_and_port(trained):
    """The port's exported model_best.pt, loaded by the JAX package's
    Enhancer (its torch reader) and by the port's: the same enhance output
    within 2e-4 of max |ref|."""
    best = os.path.join(trained["expdir"], "enhancer", "model_best.pt")
    _assert_enhance_agrees(Enhancer("nsf-hifigan", best, device="cpu"),
                           JEnhancer("nsf-hifigan", best))


def test_port_reads_jax_msgpack_enhancer(tmp_path):
    """A flax-msgpack enhancer checkpoint as the JAX package's GAN export
    writes it ({"params": ...} + config.json): the port's NsfHifiGAN loads
    it, and its enhance agrees with the JAX Enhancer's within 2e-4 of max
    |ref|."""
    g = lecun_init_(generator_from_h(H), torch.Generator().manual_seed(4))
    params = jconvert.convert_nsf_hifigan_state_dict(
        {k: v.numpy() for k, v in g.state_dict().items()}, H)["params"]
    path = tmp_path / "model_2.ckpt"
    path.write_bytes(serialization.msgpack_serialize(
        {"params": jax.tree.map(np.asarray, params)}))
    with open(tmp_path / "config.json", "w") as f:
        json.dump(H, f)
    port = Enhancer("nsf-hifigan", str(path), device="cpu")
    for k, v in g.state_dict().items():
        assert torch.equal(port.enhancer.model.state_dict()[k], v), k
    _assert_enhance_agrees(port, JEnhancer("nsf-hifigan", str(path)))
