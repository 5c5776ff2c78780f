"""PyTorch port, the native NCCF library (`ddsp_svc_tpu_torch/native/`) on
the host: its f0 and volume equal the JAX package's library bit for bit
(the same source built with the same flags on this machine), the cases of
tests/test_native.py for the port's copy, F0Extractor's 'native' and
'auto' backends against the torch device tracker, and a compiler that
cannot run raising instead of falling back."""
import threading

import numpy as np
import pytest

from ddsp_svc_tpu import native as jnative
from ddsp_svc_tpu_torch import native
from ddsp_svc_tpu_torch.data.features import F0Extractor
from ddsp_svc_tpu_torch.ops.volume import extract_volume_np
from torch_tmp import tmp_path  # noqa: F401  (removed when each test ends)


def _tone(f0, sr, dur):
    t = np.arange(int(sr * dur)) / sr
    return (0.5 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)


def _vibrato(sr, seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    inst = (180 + 60 * seed) * (1 + 0.02 * np.sin(2 * np.pi * 4 * t))
    x = 0.5 * np.sin(2 * np.pi * np.cumsum(inst) / sr)
    x[int(0.4 * len(x)): int(0.5 * len(x))] = 0.0  # a silent stretch
    return (x + 1e-3 * rng.standard_normal(len(x))).astype(np.float32)


@pytest.mark.parametrize("sr,hop,win", [(44100, 512.0, 2048),
                                        (16000, 256.0, 1024),
                                        (44100, 185.76, 2048)])
def test_native_f0_equals_jax_library(sr, hop, win):
    """The port's library against the JAX package's on the same audio:
    f0 and volume equal, at an integer and a fractional hop."""
    if not jnative.ensure_built():
        pytest.fail("the JAX package's native library does not build here")
    for seed in range(3):
        audio = _vibrato(sr, 1.3, seed)
        got = native.extract_f0_native(audio, sr, hop, 65, 800, win)
        ref = jnative.extract_f0_native(audio, sr, hop, 65, 800, win)
        assert got.shape == ref.shape == (int(len(audio) // hop) + 1,)
        assert np.array_equal(got, ref)
        assert (got > 0).mean() > 0.5 and (got == 0).any()
        assert np.array_equal(native.extract_volume_native(audio, hop),
                              jnative.extract_volume_native(audio, hop))


@pytest.mark.parametrize("f0_hz", [110.0, 220.0, 440.0])
def test_native_f0_pure_tone(f0_hz):
    sr, hop = 44100, 512.0
    audio = _tone(f0_hz, sr, 1.5)
    f0 = native.extract_f0_native(audio, sr, hop, 65, 800, 2048)
    assert f0.shape == (int(len(audio) // hop) + 1,)
    mid = f0[6:-6]
    voiced = mid[mid > 0]
    assert len(voiced) > 0.9 * len(mid)
    assert np.median(np.abs(voiced - f0_hz) / f0_hz) < 0.01


def test_native_f0_silence():
    f0 = native.extract_f0_native(np.zeros(44100, np.float32), 44100, 512.0,
                                  65, 800, 2048)
    assert (f0 == 0).all()


def test_native_volume_matches_numpy():
    rng = np.random.default_rng(0)
    audio = rng.standard_normal(44100).astype(np.float32)
    for hop in (512.0, 185.76):  # integer and fractional hop
        np.testing.assert_allclose(native.extract_volume_native(audio, hop),
                                   extract_volume_np(audio, hop), atol=1e-4)


@pytest.mark.parametrize("backend", ["native", "auto"])
def test_native_backend_agrees_with_torch_tracker(backend):
    """F0Extractor('parselmouth') on the library against the torch device
    tracker (on the CPU here): where both are voiced, median relative
    difference < 2 %. The frame contract (T // hop + 1, silence_front,
    uv_interp) is the extractor's own."""
    sr, hop = 44100, 512
    t = np.arange(sr * 2) / sr
    inst = 220 * (1 + 0.02 * np.sin(2 * np.pi * 4 * t))
    audio = (0.5 * np.sin(2 * np.pi * np.cumsum(inst) / sr)).astype(np.float32)
    nat = F0Extractor("parselmouth", sr, hop, 65, 800, backend=backend)
    assert nat.device is None  # host work: no device is resolved
    ref = F0Extractor("parselmouth", sr, hop, 65, 800, device="cpu").extract(audio)
    got = nat.extract(audio)
    assert got.shape == ref.shape == (len(audio) // hop + 1,)
    both = (got > 0) & (ref > 0)
    assert both.mean() > 0.8
    assert np.median(np.abs(got[both] - ref[both]) / ref[both]) < 0.02
    front = nat.extract(audio, silence_front=0.1)
    assert front.shape == got.shape and (front[:8] == 0).all()
    filled = nat.extract(np.concatenate([np.zeros(sr // 4, np.float32), audio]),
                         uv_interp=True)
    assert (filled >= 65).all()


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A compiler that cannot be found raises, through F0Extractor's 'auto'
    too: no fallback to the device tracker."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    audio = _tone(220.0, 16000, 0.5)
    with pytest.raises(RuntimeError, match="compiler"):
        native.extract_f0_native(audio, 16000, 256.0, 65, 800, 1024)
    ext = F0Extractor("parselmouth", 16000, 256, 65, 800, backend="auto")
    with pytest.raises(RuntimeError, match="compiler"):
        ext.extract(audio)
    assert native._lib is None and not list(tmp_path.iterdir())


def test_native_build_once_under_threads(monkeypatch, tmp_path):
    """Eight threads asking for the library at once into an empty build
    directory: one library is built and loaded, each gets the same f0."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    audio = _vibrato(16000, 0.6, 1)
    results, errors = [None] * 8, []

    def work(i):
        try:
            results[i] = native.extract_f0_native(audio, 16000, 256.0, 65, 800,
                                                  1024)
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    assert all(np.array_equal(r, results[0]) for r in results)
    assert [p.suffix for p in tmp_path.iterdir()] == [".so"]
