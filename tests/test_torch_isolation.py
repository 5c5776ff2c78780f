"""PyTorch port, isolation: the package and chip_smoke.py stand without JAX,
flax, msgpack and the JAX package (every module, the training ones, the Sins
and CombSub synthesizers, the resampler, the enhancer's forms with an
adaptive key and staged bf16, and the feature front end and the offline
CLI included), and entry points, the trainer's, the factory's for all three
synthesizers, `load_model`, `run_inference`, `run_inference_batch`, the
CLI, the preprocess entry, the streaming entry, the GAN entry, `SvcCore`,
`IncrementalSession.from_checkpoint`, `UnitsEncoder`, the torch f0
extractors, the export entry, the server's `ExportedSynth` and entry, the
API's entry and the web panel's among them, never fall back to the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

_CHILD = r"""
import importlib, importlib.abc, pkgutil, sys

sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["msgpack"] = None


class RefuseJaxPackage(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "ddsp_svc_tpu" or name.startswith("ddsp_svc_tpu."):
            raise ImportError(f"refused: {name}")
        return None


sys.meta_path.insert(0, RefuseJaxPackage())

import torch
import ddsp_svc_tpu_torch

names = [m.name for m in pkgutil.walk_packages(ddsp_svc_tpu_torch.__path__,
                                                "ddsp_svc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 40, names

from ddsp_svc_tpu_torch.infer.enhancer import Enhancer, NsfHifiGAN
from ddsp_svc_tpu_torch.models.factory import build_model
from ddsp_svc_tpu_torch.utils.config import DotDict

args = DotDict({"data": {"sampling_rate": 16000, "block_size": 64,
                         "encoder_out_channels": 8},
                "model": {"type": "CombSubFast", "n_spk": 2}})
h = {"sampling_rate": 16000, "num_mels": 8, "n_fft": 256, "win_size": 256,
     "hop_size": 64, "fmin": 40, "fmax": 8000, "upsample_rates": [8, 8],
     "upsample_kernel_sizes": [16, 16], "upsample_initial_channel": 16,
     "resblock_kernel_sizes": [3, 7, 11],
     "resblock_dilation_sizes": [[1, 3, 5]] * 3}
model = build_model(args, device="cpu")
nsf = NsfHifiGAN(None, h=h, device="cpu")
assert next(model.parameters()).device.type == "cpu"
others = [DotDict({**args, "model": {**args["model"], **m}}) for m in (
    {"type": "Sins", "n_harmonics": 8, "n_mag_allpass": 16, "n_mag_noise": 16},
    {"type": "CombSub", "n_mag_allpass": 16, "n_mag_harmonic": 32,
     "n_mag_noise": 16})]
for other in others:
    synth = build_model(other, device="cpu")
    with torch.no_grad():
        sig, _, _ = synth(torch.zeros((1, 4, 8)), torch.full((1, 4, 1), 200.0),
                          torch.ones((1, 4)), torch.ones((1, 1), dtype=torch.int64),
                          generator=torch.Generator().manual_seed(0))
    assert sig.shape == (1, 4 * 64) and bool(torch.isfinite(sig).all())
import numpy as np
for forms in ({"fused_inject": False}, {"fused_stage": True},
              {"bf16": 8}):
    bf16 = forms.pop("bf16", 0)
    enh = Enhancer("nsf-hifigan", None, h=h, device="cpu",
                   generator_overrides=forms, bf16_min_channels=bf16)
    out, sr = enh.enhance(torch.zeros((1, 1000)), 16000,
                          np.full((1, 17, 1), 200.0, np.float32), 64,
                          adaptive_key=2)
    # 1000 -> 1125 samples at 18 kHz, 17 mel frames x 64, 1088 -> 968 at 16 kHz
    assert sr == 16000 and out.shape == (1, 968), out.shape
args16 = DotDict({**args, "model": {**args["model"], "bf16": True}})
model16 = build_model(args16, device="cpu")
assert {p.dtype for p in model16.parameters()} == {torch.float32}

import os, tempfile, yaml
from ddsp_svc_tpu_torch.train.__main__ import main as train_main
cfg = os.path.join(tempfile.mkdtemp(), "cfg.yaml")
with open(cfg, "w") as f:
    yaml.safe_dump(dict(args), f)

from ddsp_svc_tpu_torch.data.features import F0Extractor, UnitsEncoder
from ddsp_svc_tpu_torch.infer.__main__ import main as cli_main
from ddsp_svc_tpu_torch.infer.offline import run_inference
from ddsp_svc_tpu_torch.models.factory import load_model
from ddsp_svc_tpu_torch.utils.config import save_config
from ddsp_svc_tpu_torch.infer.batch import run_inference_batch
from ddsp_svc_tpu_torch.preprocess import main as preprocess_main
from ddsp_svc_tpu_torch.stream import main as stream_main
from ddsp_svc_tpu_torch.infer.streaming import SvcCore
from ddsp_svc_tpu_torch.infer.realtime import IncrementalSession
from ddsp_svc_tpu_torch.train_gan import main as gan_main
from ddsp_svc_tpu_torch.api import main as api_main
from ddsp_svc_tpu_torch.export import main as export_main
from ddsp_svc_tpu_torch.serve import ExportedSynth, main as serve_main
from ddsp_svc_tpu_torch.webui import main as webui_main
ckpt = os.path.join(os.path.dirname(cfg), "model_0.pt")
gan_cfg = os.path.join(os.path.dirname(cfg), "gan.yaml")
with open(gan_cfg, "w") as f:
    yaml.safe_dump({**dict(args), "train": {"gan": {"h": h}}}, f)
save_config(os.path.join(os.path.dirname(cfg), "config.yaml"), args)
pre_cfg = os.path.join(os.path.dirname(cfg), "pre.yaml")
with open(pre_cfg, "w") as f:
    yaml.safe_dump({**dict(args), "data": {
        **args["data"], "f0_extractor": "parselmouth", "f0_min": 65,
        "f0_max": 800, "encoder": "hubertsoft", "encoder_ckpt": None,
        "encoder_sample_rate": 16000, "encoder_hop_size": 320,
        "train_path": "train", "valid_path": "val"}}, f)
torch.save(model.state_dict(), ckpt)
assert load_model(ckpt, device="cpu")[1].data.block_size == 64

torch.cuda.is_available = lambda: False  # as on a machine with no card
for make in (lambda: build_model(args), lambda: build_model(others[0]),
             lambda: build_model(others[1]), lambda: NsfHifiGAN(None, h=h),
             lambda: Enhancer("nsf-hifigan", None, h=h),
             lambda: train_main(["-c", cfg]), lambda: load_model(ckpt),
             lambda: run_inference(ckpt, "in.wav", "out.wav"),
             lambda: run_inference_batch(ckpt, ["in.wav"], "out"),
             lambda: preprocess_main(["-c", pre_cfg]),
             lambda: cli_main(["-m", ckpt, "-i", "in.wav", "-o", "out.wav"]),
             lambda: stream_main(["-m", ckpt, "-i", "in.wav", "-o", "out.wav"]),
             lambda: SvcCore(ckpt),
             lambda: IncrementalSession.from_checkpoint(ckpt),
             lambda: gan_main(["-c", gan_cfg]),
             lambda: UnitsEncoder("hubertsoft", None),
             lambda: F0Extractor("crepe"), lambda: F0Extractor("parselmouth"),
             lambda: export_main(["-m", ckpt, "-o", "m.pt2"]),
             # the device is resolved before the artifact is read
             lambda: ExportedSynth("model.pt2", cfg),
             lambda: serve_main(["-a", "model.pt2", "-c", cfg]),
             lambda: api_main(["-m", ckpt]), lambda: webui_main([])):
    try:
        make()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError("an entry point ran on the CPU unasked")
assert not any(m == "jax" or m.startswith(("jax.", "flax", "ddsp_svc_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("ISOLATED", len(names))
"""


def test_package_imports_and_builds_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ISOLATED" in out.stdout


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "msgpack", "ddsp_svc_tpu",
                   "torchaudio")


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py"] + sorted(
    (ROOT / "ddsp_svc_tpu_torch").rglob("*.py")),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, (path, bad)
