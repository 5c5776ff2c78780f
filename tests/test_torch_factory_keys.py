"""PyTorch port, `models/factory.py::build_model` against the JAX package's
kernel switches: JAX reads model.fused_spectral and model.fused_attention
(false: its plain XLA chain, "force": interpret mode); the port runs its
kernels on every path and has neither, so any value but unset or true
raises a ValueError naming the key, where it once was dropped without a
word."""
import json

import pytest

from ddsp_svc_tpu_torch.models.factory import build_model
from ddsp_svc_tpu_torch.utils.config import DotDict, load_config


def _args(**model):
    args = json.loads(json.dumps(load_config("configs/combsub.yaml")))
    args["data"]["encoder_out_channels"] = 16
    args["model"]["n_spk"] = 2
    args["model"].update(model)
    return DotDict(args)


@pytest.mark.parametrize("key,value", [
    ("fused_spectral", False), ("fused_spectral", "force"),
    ("fused_attention", False), ("fused_attention", "force"),
    ("fused_attention", "auto")])
def test_build_model_raises_on_kernel_switches(key, value):
    with pytest.raises(ValueError, match=f"model.{key}"):
        build_model(_args(**{key: value}), device="cpu")


@pytest.mark.parametrize("value", [None, True])
def test_build_model_takes_unset_or_true(value):
    model = build_model(_args(fused_spectral=value, fused_attention=value),
                        device="cpu")
    assert type(model).__name__ == "CombSubFast"
