"""PyTorch port, AOT export of the synthesizers against the JAX package on
the CPU: `python -m ddsp_svc_tpu_torch.export`'s `export_synth` on a JAX
`.ckpt` (CombSubFast, Sins, CombSub; 16 kHz, block 256, n_unit 64,
16-frame artifacts), the program saved and loaded back by torch.export,
against JAX's `model.apply(..., infer=True, noise=noise)` and against JAX's
own artifact (`tools/export.py`, `jax.export.deserialize(...).call`); the
graph's `ddsp_svc` op nodes; `torch.library.opcheck` of the four custom
ops. Weights from a seed, written by the JAX package's saver."""
import os
import shutil
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from ddsp_svc_tpu.models.factory import build_model as jbuild_model
from ddsp_svc_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from ddsp_svc_tpu.utils import convert as jconvert
from ddsp_svc_tpu.utils.config import DotDict as JDotDict
from ddsp_svc_tpu_torch import export
from ddsp_svc_tpu_torch.models.factory import build_model
from ddsp_svc_tpu_torch.nn.pcmer import gaussian_orthogonal_random_matrix
from ddsp_svc_tpu_torch.ops import kernels as K
from ddsp_svc_tpu_torch.utils.config import DotDict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

torch.set_num_threads(2)

SR, BLOCK, N_UNIT, N_SPK, FRAMES = 16000, 256, 64, 2, 16
SIZES = {"CombSubFast": {},
         "Sins": dict(n_harmonics=32, n_mag_allpass=64, n_mag_noise=64),
         "CombSub": dict(n_mag_allpass=64, n_mag_harmonic=128,
                         n_mag_noise=64)}
# the ddsp_svc op nodes of each exported graph: #1 in each PCmer layer,
# #2 in CombSubFast's filter chain, #8 in the Sins bank, #9 in each
# LTV-FIR filter
OPS = {"CombSubFast": {"performer_attention": 3, "combsub_spectral": 1},
       "Sins": {"performer_attention": 3, "oscillator_bank": 1,
                "ltv_fir_convolve": 2},
       "CombSub": {"performer_attention": 3, "ltv_fir_convolve": 3}}
# tests/test_torch_synths.py's and tests/test_torch_models.py's bound
# against JAX (1e-4 of max |ref|), and never looser than
# tests/test_export.py's atol 1e-3
TOL = 1e-4


def _inputs(seed=2):
    rng = np.random.default_rng(seed)
    units = rng.standard_normal((1, FRAMES, N_UNIT)).astype(np.float32)
    f0 = (120 + 200 * rng.random((1, FRAMES, 1))).astype(np.float32)
    f0[:, 5:8] = 0.0  # an unvoiced stretch
    volume = rng.random((1, FRAMES)).astype(np.float32)
    spk = np.asarray([[2]], np.int64)
    noise = (rng.random((1, FRAMES * BLOCK)) * 2 - 1).astype(np.float32)
    return units, f0, volume, spk, noise


@pytest.fixture(scope="module", params=list(SIZES))
def exported(request, tmp_path_factory):
    """One synthesizer: a JAX `.ckpt` (weights from a seed, written by the
    JAX package's saver) and its config.yaml; the port's artifact of it,
    saved and loaded; JAX's model, variables and its own artifact."""
    mtype = request.param
    tmp = tmp_path_factory.mktemp(mtype)
    cfg = {"data": {"sampling_rate": SR, "block_size": BLOCK,
                    "encoder_out_channels": N_UNIT},
           "model": {"type": mtype, "n_spk": N_SPK, "c": False,
                     **SIZES[mtype]}}
    (tmp / "config.yaml").write_text(yaml.safe_dump(cfg))
    tm = build_model(DotDict(cfg), device="cpu", seed=0)
    variables = jconvert.convert_synth_state_dict(
        {k: v.numpy() for k, v in tm.state_dict().items()}, num_layers=3)
    ckpt = str(tmp / "model_1.ckpt")
    jsave_checkpoint(ckpt, 1, variables)

    path = export.export_synth(ckpt, str(tmp / "model.pt2"), frames=FRAMES,
                               device="cpu")
    program = torch.export.load(path)

    import export as jexport_tool
    from jax import export as jexport
    jpath = jexport_tool.export_synth(ckpt, str(tmp / "model.stablehlo"),
                                      frames=FRAMES, batch=1)
    with open(jpath, "rb") as f:
        jprogram = jexport.deserialize(bytearray(f.read()))
    jm = jbuild_model(JDotDict(cfg))
    yield mtype, program, jm, variables, jprogram
    shutil.rmtree(tmp, ignore_errors=True)


def test_exported_program_matches_jax(exported):
    """The loaded program against the JAX model's inference forward and
    against JAX's exported artifact, the same noise injected: within 1e-4
    of max |ref|."""
    mtype, program, jm, variables, jprogram = exported
    units, f0, volume, spk, noise = _inputs()
    with torch.no_grad():
        got = program.module()(*(torch.from_numpy(a) for a in
                                 (units, f0, volume, spk, noise))).numpy()
    j_in = [jnp.asarray(a) for a in (units, f0, volume, spk, noise)]
    ref = np.asarray(jax.jit(lambda v, *a: jm.apply(
        v, *a[:4], infer=True, noise=a[4])[0])(variables, *j_in))
    ref_artifact = np.asarray(jprogram.call(*j_in))
    assert got.shape == ref.shape == ref_artifact.shape == (1, FRAMES * BLOCK)
    assert np.isfinite(got).all() and np.abs(ref).max() > 1e-3
    for r in (ref, ref_artifact):
        err = np.abs(got - r).max()
        assert err < min(TOL * np.abs(r).max(), 1e-3), (mtype, err)


def test_exported_graph_holds_the_ops(exported):
    """The kernels the synthesizer runs are ddsp_svc op nodes of the graph,
    as many as its forward calls them, and no autograd Function is."""
    mtype, program, *_ = exported
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    ops = {t.split(".")[1]: targets.count(t) for t in set(targets)
           if t.startswith("ddsp_svc.")}
    assert ops == OPS[mtype], ops
    assert not any("autograd" in t.lower() for t in targets)


def _op_cases():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 8, 40, 64, generator=g) for _ in range(3))
    split = torch.randn(2, 40, 8 * 64, generator=g).reshape(
        2, 40, 8, 64).transpose(1, 2)
    proj = torch.from_numpy(gaussian_orthogonal_random_matrix(266, 64, 5))
    rows, n = 5, 128
    spectral = [torch.randn(rows, n, generator=g) for _ in range(2)] + [
        0.3 * torch.randn(rows, n // 2 + 1, generator=g) for _ in range(3)]
    phase = torch.cumsum(0.1 * torch.rand(2, 4 * 64, generator=g), -1)
    amps = 0.1 * torch.rand(2, 4, 16, generator=g)
    return [
        ("attention", K.performer_attention_op, (q, k, v, proj, None, 40)),
        ("attention, split heads, by value", K.performer_attention_op,
         (split, split, split, proj, None, 27)),
        ("attention, (B,) lengths", K.performer_attention_op,
         (q, k, v, proj, torch.tensor([30, 12]), 0)),
        ("spectral", K.combsub_spectral_op, (*spectral, n)),
        ("oscillator bank", K.oscillator_bank_op, (phase, amps, 64, 32)),
        ("LTV-FIR", K.ltv_fir_convolve_op,
         (torch.randn(6, 100, generator=g), torch.randn(6, 29, generator=g),
          128)),
    ]


@pytest.mark.parametrize("case", range(6),
                         ids=[c[0] for c in _op_cases()])
def test_custom_ops_opcheck(case):
    """torch.library.opcheck's schema and fake-tensor checks of the four
    ops on small CPU inputs, and each op's CPU implementation equal to its
    plain version."""
    _, op, args = _op_cases()[case]
    torch.library.opcheck(op, args, test_utils=("test_schema",
                                                "test_faketensor"))
    plain = {K.performer_attention_op: lambda q, k, v, p, n, va:
             K.performer_attention_plain(q, k, v, p, va if n is None else n),
             K.combsub_spectral_op: K.combsub_spectral_plain,
             K.oscillator_bank_op: K.oscillator_bank_plain,
             K.ltv_fir_convolve_op: K.ltv_fir_convolve_plain}[op]
    assert torch.equal(op(*args), plain(*args))
