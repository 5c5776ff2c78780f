"""Feature dataset and batch iterators for training, in numpy (a copy of
`ddsp_svc_tpu/data/dataset.py`, so both packages draw the same crops).

On-disk layout: `{root}/audio/{spk}/{name}.wav`, `units/{spk}/{name}.{i}.npy`,
`f0/...npy`, `volume/...npy`, with 1-based integer speaker directories.
Items are random frame-aligned crops of `waveform_sec` seconds (whole files
for validation), with a random augmented-unit variant (n_aunit); clips too
short for a crop are skipped. Batches are numpy dicts of fixed shape, from a
seeded per-epoch shuffle, so a resumed run draws the same batches.
"""
from __future__ import annotations

import os
import random
from typing import Dict, Iterator, List

import numpy as np

from .wavio import load_audio, get_duration


def traverse_dir(
    root_dir: str,
    extension: str,
    is_pure: bool = False,
    is_ext: bool = True,
    is_sort: bool = True,
) -> List[str]:
    """Recursive file listing (logger/utils.py:8-28 parity)."""
    out = []
    for root, _, files in os.walk(root_dir):
        for fname in files:
            if fname.endswith(extension):
                full = os.path.join(root, fname)
                path = os.path.relpath(full, root_dir) if is_pure else full
                if not is_ext:
                    path = path[: -(len(extension) + 1)]
                out.append(path)
    if is_sort:
        out.sort()
    return out


class AudioDataset:
    def __init__(
        self,
        path_root: str,
        waveform_sec: float,
        hop_size: int,
        sample_rate: int,
        load_all_data: bool = True,
        whole_audio: bool = False,
        n_spk: int = 1,
        n_aunit: int = 0,
        fp16: bool = False,
    ):
        self.path_root = path_root
        self.waveform_sec = waveform_sec
        self.hop_size = hop_size
        self.sample_rate = sample_rate
        self.whole_audio = whole_audio
        self.n_aunit = n_aunit
        self.paths = traverse_dir(
            os.path.join(path_root, "audio"), "wav", is_pure=True, is_ext=False
        )
        self.data_buffer: Dict[str, dict] = {}
        for rel in self.paths:
            path_audio = os.path.join(path_root, "audio", rel) + ".wav"
            duration = get_duration(path_audio)
            f0 = np.load(os.path.join(path_root, "f0", rel) + ".npy").astype(
                np.float32
            )[:, None]
            volume = np.load(os.path.join(path_root, "volume", rel) + ".npy").astype(
                np.float32
            )
            spk_name = os.path.dirname(rel)
            if not spk_name.isdigit():
                raise ValueError(
                    f" [x] speaker directory name must be a positive integer, got '{spk_name}'"
                )
            spk_id = int(spk_name)
            if spk_id < 1 or n_spk < spk_id:
                raise ValueError(" [x] spk_id must be within [1, n_spk]")
            entry = {
                "duration": duration,
                "f0": f0,
                "volume": volume,
                "spk_id": np.asarray([spk_id], dtype=np.int64),
            }
            if load_all_data:
                audio, _ = load_audio(path_audio, sr=sample_rate, mono=True)
                units = [
                    np.load(os.path.join(path_root, "units", rel) + f".{i}.npy").astype(
                        np.float16 if fp16 else np.float32
                    )
                    for i in range(1 + n_aunit)
                ]
                entry["audio"] = audio.astype(np.float16 if fp16 else np.float32)
                entry["units"] = units
            self.data_buffer[rel] = entry

    def __len__(self) -> int:
        return len(self.paths)

    def get_item(self, file_idx: int, rng: random.Random) -> Dict[str, np.ndarray]:
        # skip too-short clips by advancing (data_loaders.py:92-93)
        for _ in range(len(self.paths)):
            name = self.paths[file_idx]
            buf = self.data_buffer[name]
            if buf["duration"] >= self.waveform_sec + 0.1 or self.whole_audio:
                break
            file_idx = (file_idx + 1) % len(self.paths)
        name = self.paths[file_idx]
        buf = self.data_buffer[name]

        frame_resolution = self.hop_size / self.sample_rate
        duration = buf["duration"]
        waveform_sec = duration if self.whole_audio else self.waveform_sec
        idx_from = (
            0.0
            if self.whole_audio
            else rng.uniform(0, duration - waveform_sec - 0.1)
        )
        start_frame = int(idx_from / frame_resolution)
        units_frame_len = int(waveform_sec / frame_resolution)

        unit_idx = rng.randint(0, self.n_aunit)
        if "units" in buf:
            units = buf["units"][unit_idx]
            audio = buf["audio"]
        else:
            units = np.load(
                os.path.join(self.path_root, "units", name) + f".{unit_idx}.npy"
            ).astype(np.float32)
            audio, _ = load_audio(
                os.path.join(self.path_root, "audio", name) + ".wav",
                sr=self.sample_rate,
            )

        audio_seg = audio[
            start_frame * self.hop_size : (start_frame + units_frame_len) * self.hop_size
        ].astype(np.float32)
        return dict(
            audio=audio_seg,
            f0=buf["f0"][start_frame : start_frame + units_frame_len],
            volume=buf["volume"][start_frame : start_frame + units_frame_len],
            units=units[start_frame : start_frame + units_frame_len].astype(np.float32),
            spk_id=buf["spk_id"],
            name=name,
        )


class BatchIterator:
    """Shuffled epoch iterator producing stacked numpy batches with static
    shapes. Seeded + epoch-indexed for reproducible resume."""

    def __init__(self, dataset: AudioDataset, batch_size: int, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed

    def __len__(self) -> int:
        return max(1, len(self.dataset) // self.batch_size)

    def epoch(self, epoch_idx: int) -> Iterator[Dict[str, np.ndarray]]:
        rng = random.Random(f"{self.seed}:{epoch_idx}")
        order = list(range(len(self.dataset)))
        rng.shuffle(order)
        n_batches = len(self)
        for b in range(n_batches):
            idxs = [
                order[(b * self.batch_size + i) % len(order)]
                for i in range(self.batch_size)
            ]
            items = [self.dataset.get_item(i, rng) for i in idxs]
            yield {
                k: np.stack([it[k] for it in items])
                for k in ("audio", "f0", "volume", "units", "spk_id")
            } | {"name": [it["name"] for it in items]}


class PrefetchIterator:
    """Background-thread batch prefetch (the role of the reference's
    DataLoader workers/pin_memory, data_loaders.py:15-22): assembles the
    next batches on a host thread while the device runs the current step."""

    def __init__(self, inner: BatchIterator, depth: int = 2):
        self.inner = inner
        self.depth = depth

    def __len__(self) -> int:
        return len(self.inner)

    def epoch(self, epoch_idx: int) -> Iterator[Dict[str, np.ndarray]]:
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        sentinel = object()

        def producer():
            try:
                for batch in self.inner.epoch(epoch_idx):
                    q.put(batch)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()


def get_data_loaders(args, whole_audio: bool = False):
    """(train BatchIterator, valid AudioDataset) from config
    (data_loaders.py:12-24 parity)."""
    data_train = AudioDataset(
        args.data.train_path,
        waveform_sec=args.data.duration,
        hop_size=args.data.block_size,
        sample_rate=args.data.sampling_rate,
        load_all_data=bool(args.train.cache_all_data),
        whole_audio=whole_audio,
        n_spk=args.model.n_spk,
        n_aunit=args.data.n_aunit or 0,
        fp16=bool(args.train.cache_fp16),
    )
    data_valid = AudioDataset(
        args.data.valid_path,
        waveform_sec=args.data.duration,
        hop_size=args.data.block_size,
        sample_rate=args.data.sampling_rate,
        load_all_data=bool(args.train.cache_all_data),
        whole_audio=True,
        n_spk=args.model.n_spk,
        n_aunit=args.data.n_aunit or 0,
    )
    loader_train = BatchIterator(
        data_train, batch_size=int(args.train.batch_size), seed=0
    )
    if int(args.train.num_workers or 0) > 0:
        loader_train = PrefetchIterator(
            loader_train, depth=int(args.train.num_workers)
        )
    return loader_train, data_valid
