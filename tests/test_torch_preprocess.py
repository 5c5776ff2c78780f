"""PyTorch port, preprocessing on the CPU: `python -m
ddsp_svc_tpu_torch.preprocess` and `data/preprocess.py::preprocess` against
the JAX package's on copies of one store of wavs, with the same HuBERT-soft
torch checkpoint: the same files; f0 (native NCCF and dio) and f0_stat
equal, volume within 1e-6, units within tests/test_torch_features.py's
HuBERT bound, f0_stats.npy equal, the all-unvoiced file moved to skip/;
then the port's trainer reads the store and takes a step. 16 kHz, block
256, weights from seeds."""
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from ddsp_svc_tpu.data import preprocess as jpreprocess
from ddsp_svc_tpu.data.features import F0Extractor as JF0Extractor
from ddsp_svc_tpu.data.features import UnitsEncoder as JUnitsEncoder
from ddsp_svc_tpu.data.features import VolumeExtractor as JVolumeExtractor
from ddsp_svc_tpu.utils.config import DotDict as JDotDict
from ddsp_svc_tpu_torch import preprocess as entry
from ddsp_svc_tpu_torch.data import preprocess
from ddsp_svc_tpu_torch.data.dataset import AudioDataset
from ddsp_svc_tpu_torch.data.features import (F0Extractor, UnitsEncoder,
                                              VolumeExtractor)
from ddsp_svc_tpu_torch.data.wavio import write_wav
from ddsp_svc_tpu_torch.nn.hubert import HubertSoft, init_hubert_
from ddsp_svc_tpu_torch.train import __main__ as train_main

torch.set_num_threads(2)

SR, BLOCK = 16000, 256
# tests/test_torch_features.py's HuBERT bound, relative to max |ref|
HUBERT_TOL = 1e-4
SECONDS = 1.3  # every clip: one HuBERT shape in JAX


def _clip(f0_hz, seed, voiced=True):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * SECONDS)) / SR
    if not voiced:
        return np.zeros(len(t), np.float32)
    inst = f0_hz * (1 + 0.03 * np.sin(2 * np.pi * (4 + seed) * t))
    ph = 2 * np.pi * np.cumsum(inst) / SR
    x = sum(0.3 / k * np.sin(k * ph) for k in range(1, 5))
    x[int(0.55 * len(x)): int(0.7 * len(x))] = 0.0  # an unvoiced stretch
    return (x + 1e-3 * rng.standard_normal(len(t))).astype(np.float32)


def _write_store(root):
    """train: 2 speakers x 2 clips and one silent clip (speaker 2); val:
    one clip a speaker."""
    for split, n in (("train", 2), ("val", 1)):
        for spk in (1, 2):
            d = root / split / "audio" / str(spk)
            d.mkdir(parents=True)
            for i in range(n):
                write_wav(str(d / f"c{i}.wav"),
                          _clip(140.0 * spk + 25 * i, 10 * spk + i), SR)
    write_wav(str(root / "train" / "audio" / "2" / "silent.wav"),
              _clip(0, 0, voiced=False), SR)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """The wav store, a HuBERT-soft checkpoint in the bshall layout from a
    seed, and a config that names both."""
    root = tmp_path_factory.mktemp("preprocess")
    _write_store(root / "wavs")
    hubert = init_hubert_(HubertSoft(), torch.Generator().manual_seed(5))
    sd = hubert.state_dict()
    w = sd.pop("positional_embedding.conv.weight")
    sd["positional_embedding.conv.weight_g"] = torch.sqrt(
        (w ** 2).sum(dim=(0, 1), keepdim=True))
    sd["positional_embedding.conv.weight_v"] = w
    torch.save(sd, root / "hubert-soft.pt")
    cfg = {
        "data": {"f0_extractor": "parselmouth", "f0_min": 65, "f0_max": 800,
                 "sampling_rate": SR, "block_size": BLOCK, "duration": 1.0,
                 "encoder": "hubertsoft", "encoder_sample_rate": 16000,
                 "encoder_hop_size": 320, "encoder_out_channels": 256,
                 "encoder_ckpt": str(root / "hubert-soft.pt"), "n_aunit": 0,
                 "use_vuv": False},
        "model": {"type": "CombSubFast", "n_spk": 2, "c": False},
        "loss": {"fft_min": 128, "fft_max": 512, "n_scale": 2},
        "train": {"batch_size": 2, "cache_all_data": True, "cache_fp16": False,
                  "epochs": 4, "interval_log": 1, "interval_val": 100,
                  "lr": 1e-3, "weight_decay": 0.0, "seed": 0},
    }
    yield root, cfg
    shutil.rmtree(root, ignore_errors=True)


def _copy(root, name, cfg):
    """A fresh copy of the wav store under root/name, with its config."""
    shutil.copytree(root / "wavs", root / name)
    cfg = {k: dict(v) for k, v in cfg.items()}
    cfg["data"].update(train_path=str(root / name / "train"),
                       valid_path=str(root / name / "val"))
    cfg["env"] = {"expdir": str(root / name / "exp")}
    path = root / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return root / name, path, cfg


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def _same_store(got, ref):
    """Every feature file of the port's store against the JAX one's."""
    for split in ("train", "val"):
        g, r = got / split, ref / split
        assert _files(g) == _files(r)
        for rel in _files(g):
            if not rel.endswith(".npy") or rel == "f0_stats.npy":
                continue
            a, b = np.load(g / rel), np.load(r / rel)
            assert a.shape == b.shape and a.dtype == b.dtype, rel
            if rel.startswith("units"):
                # the silent clip's units are exact zeros on both sides
                err = np.abs(a - b).max()
                assert err <= HUBERT_TOL * np.abs(b).max(), (rel, err)
            elif rel.startswith("volume"):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=rel)
            else:  # f0 and f0_stat
                assert np.array_equal(a, b), rel
    stats = np.load(got / "train" / "f0_stats.npy", allow_pickle=True).item()
    ref_stats = np.load(ref / "train" / "f0_stats.npy", allow_pickle=True).item()
    assert stats == ref_stats and sorted(stats) == ["1", "2"]
    assert not (got / "val" / "f0_stats.npy").exists()


def test_preprocess_entry_matches_jax_and_trains(store):
    """`python -m ddsp_svc_tpu_torch.preprocess -c CFG --device cpu`'s main
    (parselmouth on the native NCCF library, backend 'auto') against the
    JAX package's preprocess_from_config on a copy of the same wavs; then
    the port's AudioDataset loads the store and its trainer takes one CPU
    step on it."""
    root, cfg = store
    got, cfg_path, args = _copy(root, "port_native", cfg)
    ref, _, _ = _copy(root, "jax_native", cfg)
    entry.main(["-c", str(cfg_path), "--device", "cpu"])
    jargs = JDotDict({**args, "data": {**args["data"],
                                      "train_path": str(ref / "train"),
                                      "valid_path": str(ref / "val")}})
    jpreprocess.preprocess_from_config(jargs)
    _same_store(got, ref)
    assert _files(got / "train" / "skip") == ["2/silent.wav"]
    assert not (got / "train" / "audio" / "2" / "silent.wav").exists()
    # units are written before the f0 check, as in JAX: the skipped file's too
    assert len(_files(got / "train" / "units")) == 5
    assert len(_files(got / "train" / "f0")) == 4

    data = AudioDataset(str(got / "train"), 1.0, BLOCK, SR, n_spk=2)
    assert len(data) == 4
    state, saver = train_main.main(["-c", str(cfg_path), "--max-steps", "1",
                                    "--device", "cpu"])
    assert state.step == 1 and saver.global_step == 1
    assert os.path.isfile(os.path.join(args["env"]["expdir"],
                                       "log_values.jsonl"))


def test_preprocess_dio_matches_jax(store):
    """`preprocess` with dio f0, use_vuv (unvoiced frames kept at 0) and one
    worker, against the JAX package's with its own extractors: the same
    store."""
    root, cfg = store
    got, _, _ = _copy(root, "port_dio", cfg)
    ref, _, _ = _copy(root, "jax_dio", cfg)
    d = cfg["data"]
    units = UnitsEncoder("hubertsoft", d["encoder_ckpt"], device="cpu")
    junits = JUnitsEncoder("hubertsoft", d["encoder_ckpt"], 16000, 320)
    for split, stats in (("train", True), ("val", False)):
        preprocess.preprocess(
            str(got / split), F0Extractor("dio", SR, BLOCK, 65, 800),
            VolumeExtractor(BLOCK), units, SR, BLOCK, gen_stats=stats,
            use_vuv=True, num_workers=1)
        jpreprocess.preprocess(
            str(ref / split), JF0Extractor("dio", SR, BLOCK, 65, 800),
            JVolumeExtractor(BLOCK), junits, SR, BLOCK, gen_stats=stats,
            use_vuv=True, num_workers=1)
    _same_store(got, ref)
    f0 = np.load(got / "train" / "f0" / "1" / "c0.npy")
    assert (f0 == 0).any() and (f0 > 0).mean() > 0.5
