"""PyTorch port, HuBERT's span mask (`compute_mask`) and discrete units
(`HubertDiscrete`) against the JAX package's on the CPU: the mask's
properties (tests/test_hubert.py's), its span scatter bit for bit against
JAX's compute_mask on the same span starts, and the k-means ids of the
layer-7 features on the same weights and centres, at 16 kHz."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ddsp_svc_tpu.nn import hubert as jhubert
from ddsp_svc_tpu.utils import convert as jconvert
from ddsp_svc_tpu_torch.nn import hubert
from test_torch_features import _hubert_torch_sd

torch.set_num_threads(2)


def test_compute_mask_properties():
    """tests/test_hubert.py::test_compute_mask_properties on the port's:
    bool (4, 100), each row's masked share in (0.05, 0.85]; the span count
    as JAX's (max(min(round(0.8 T / 10), T // 10), 2) starts a row), each
    a whole span of 10."""
    g = torch.Generator().manual_seed(0)
    m = hubert.compute_mask((4, 100), mask_prob=0.8, mask_length=10,
                            generator=g)
    assert m.shape == (4, 100) and m.dtype == torch.bool
    frac = m.float().mean(1).numpy()
    assert (frac > 0.05).all() and (frac <= 0.85).all(), frac
    seen = []
    real = torch.randint

    def spy(lo, hi, size, **kw):
        seen.append((lo, hi, tuple(size)))
        return real(lo, hi, size, **kw)

    torch.randint = spy
    try:
        for shape, prob, length, least in (((3, 57), 0.8, 10, 2),
                                           ((2, 7), 0.1, 5, 2),
                                           ((1, 400), 0.65, 10, 2)):
            hubert.compute_mask(shape, prob, length, least, generator=g)
    finally:
        torch.randint = real
    assert seen == [(0, 48, (3, 5)), (0, 3, (2, 2)), (0, 391, (1, 26))]
    with pytest.raises(ValueError, match="mask_length"):
        hubert.compute_mask((1, 5), mask_length=10)


@pytest.mark.parametrize("b,t,n,length", [(3, 57, 5, 10), (2, 40, 5, 7)])
def test_span_mask_matches_jax_scatter(monkeypatch, b, t, n, length):
    """The port's scatter of spans from given starts against JAX's
    compute_mask with its start draw replaced by the same starts
    (overlapping spans included): bit for bit."""
    starts = np.random.default_rng(t).integers(0, t - length + 1, (b, n))
    monkeypatch.setattr(jhubert.jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(starts))
    mask_prob = n * length / t  # JAX's span count gives n
    ref = np.asarray(jhubert.compute_mask(jax.random.key(0), (b, t),
                                          mask_prob, length, 2))
    got = hubert.span_mask(torch.from_numpy(starts), t, length).numpy()
    np.testing.assert_array_equal(got, ref)


def test_hubert_discrete_units_match_jax(monkeypatch):
    """HubertDiscrete.units against JAX's HubertDiscrete on the same
    layer-7 weights (a bshall checkpoint's, 7 layers) and 16 centres drawn
    near the features: the ids equal wherever the nearest centre beats the
    second by more than 1e-5 relative (JAX's distances), which holds for
    most frames; the codebook dict form gives the same ids."""
    sd = _hubert_torch_sd(np.random.default_rng(20), n_layers=7)
    rng = np.random.default_rng(21)
    wav = (0.1 * rng.standard_normal((2, 8000))).astype(np.float32)
    variables = jconvert.convert_hubert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, num_layers=7)
    del variables["params"]["proj"]
    feats = np.asarray(jhubert.HubertSoft(output_layer=7, proj_dim=None).apply(
        variables, jnp.asarray(wav))).reshape(-1, 768)
    centers = (feats[rng.choice(len(feats), 16, replace=False)]
               + 0.3 * rng.standard_normal((16, 768))).astype(np.float32)
    ref = np.asarray(jhubert.HubertDiscrete(variables, centers).units(
        jnp.asarray(wav)))
    monkeypatch.setattr(hubert.HubertDiscrete, "CHUNK_BYTES", 16 * 768 * 4 * 7)
    model = hubert.HubertDiscrete(sd, centers, device="cpu")
    assert model.chunk == 7  # frames split into chunks of 7
    got = model.units(wav).numpy()
    assert got.shape == ref.shape == (2, 25)
    d = ((feats[:, None, :] - centers[None]) ** 2).sum(-1)
    d.sort(axis=1)
    clear = ((d[:, 1] - d[:, 0]) > 1e-5 * d[:, 0]).reshape(ref.shape)
    assert clear.mean() > 0.9, clear.mean()
    np.testing.assert_array_equal(got[clear], ref[clear])
    again = hubert.HubertDiscrete(
        hubert.load_hubert_state_dict(hubert.HubertSoft(num_layers=7), sd),
        {"n_features_in_": 768, "cluster_centers_": centers}, device="cpu")
    np.testing.assert_array_equal(again.units(torch.from_numpy(wav)).numpy(),
                                  got)
