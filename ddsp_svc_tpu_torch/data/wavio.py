"""Host-side WAV I/O in numpy (a copy of `ddsp_svc_tpu/data/wavio.py`).

Reads PCM 8/16/24/32-bit and float32/float64 WAV into float32 in [-1, 1],
mixes stereo down, and writes PCM16 or float32. `load_audio` resamples
on load on the host's CPU with `ops.resample`, as the JAX package's
`_resample_host` does.
"""
from __future__ import annotations

import struct
import wave
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.resample import resample


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file. Returns (audio :: (T,) or (C, T) float32 in [-1,1], sr)."""
    with open(path, "rb") as f:
        return _read_wav_stream(f, name=path)


def read_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Read WAV from an in-memory byte string (HTTP request bodies)."""
    import io

    return _read_wav_stream(io.BytesIO(data), name="<bytes>")


def _read_wav_stream(f, name: str = "<stream>") -> Tuple[np.ndarray, int]:
    header = f.read(12)
    if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
        raise ValueError(f"not a RIFF/WAVE file: {name}")
    fmt = None
    data = None
    while True:
        chunk_hdr = f.read(8)
        if len(chunk_hdr) < 8:
            break
        cid, size = struct.unpack("<4sI", chunk_hdr)
        if cid == b"fmt ":
            fmt = f.read(size)
            if size % 2:
                f.read(1)
        elif cid == b"data":
            data = f.read(size)
            if size % 2:
                f.read(1)
        else:
            f.seek(size + (size % 2), 1)
    if fmt is None or data is None:
        raise ValueError(f"missing fmt/data chunk: {name}")
    audio_format, n_channels, sr, _, _, bits = struct.unpack(
        "<HHIIHH", fmt[:16]
    )
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]

    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            x = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
        elif bits == 8:
            x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        dtype = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(data, dtype=dtype).astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format code {audio_format}")

    if n_channels > 1:
        x = x.reshape(-1, n_channels).T
    return x, int(sr)


def write_wav(path: str, audio: np.ndarray, sr: int, subtype: str = "PCM_16") -> None:
    """Write mono/stereo WAV. subtype: 'PCM_16' or 'FLOAT'."""
    with open(path, "wb") as f:
        f.write(wav_bytes(audio, sr, subtype=subtype))


def wav_bytes(audio: np.ndarray, sr: int, subtype: str = "PCM_16") -> bytes:
    """Encode audio as in-memory WAV bytes (HTTP responses)."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[None, :]
    n_channels, t = audio.shape
    interleaved = audio.T.reshape(-1)
    if subtype == "PCM_16":
        pcm = np.clip(interleaved, -1.0, 1.0)
        pcm = (pcm * 32767.0).round().astype("<i2").tobytes()
        sampwidth, fmt_code = 2, 1
    elif subtype == "FLOAT":
        pcm = interleaved.astype("<f4").tobytes()
        sampwidth, fmt_code = 4, 3
    else:
        raise ValueError(f"unsupported subtype {subtype}")

    byte_rate = sr * n_channels * sampwidth
    block_align = n_channels * sampwidth
    return b"".join([
        b"RIFF",
        struct.pack("<I", 36 + len(pcm)),
        b"WAVE",
        b"fmt ",
        struct.pack("<IHHIIHH", 16, fmt_code, n_channels, sr,
                    byte_rate, block_align, sampwidth * 8),
        b"data",
        struct.pack("<I", len(pcm)),
        pcm,
    ])


def load_audio(
    path: str, sr: Optional[int] = None, mono: bool = True
) -> Tuple[np.ndarray, int]:
    """librosa.load-equivalent: read, mix down, resample to `sr` if given
    (on the CPU, whatever device the caller computes on)."""
    x, native_sr = read_wav(path)
    if mono and x.ndim > 1:
        x = x.mean(axis=0)
    if sr is not None and sr != native_sr:
        y = resample(torch.from_numpy(np.atleast_2d(x).astype(np.float32)),
                     native_sr, sr).numpy()
        x, native_sr = (y[0] if x.ndim == 1 else y), sr
    return x.astype(np.float32), native_sr


def get_duration(path: str, sr: Optional[int] = None) -> float:
    """Duration in seconds (header-only when possible)."""
    try:
        with wave.open(path, "rb") as w:
            return w.getnframes() / w.getframerate()
    except wave.Error:  # e.g. float-format WAVs the wave module can't parse
        x, native_sr = read_wav(path)
        return x.shape[-1] / native_sr
