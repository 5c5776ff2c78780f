"""Streaming (real-time VC) settings profiles.

The port's own copy of `ddsp_svc_tpu/infer/stream_config.py`. The reference
GUI pickles a Config object and loads it on launch; here, as in the JAX
package, a profile is a named YAML file: readable, diffable, and safe to
load (yaml.safe_load builds plain data, where unpickling runs code).

    cfg = StreamConfig(block_time=0.5, spk_id=2)
    cfg.save("profiles", "stage-mic")      # -> profiles/stage-mic.yaml
    cfg2 = StreamConfig.load("profiles", "stage-mic")
    session = StreamingSession(core, **cfg2.session_kwargs())
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional


@dataclasses.dataclass
class StreamConfig:
    """One realtime-conversion settings profile (gui.py:143-158 fields)."""

    samplerate: int = 44100
    block_time: float = 0.3
    pitch_adjust: float = 0.0          # reference: f_pitch_change
    spk_id: int = 1
    spk_mix_dict: Optional[Dict[int, float]] = None
    use_enhancer: bool = True          # reference: use_vocoder_based_enhancer
    use_phase_vocoder: bool = True
    checkpoint_path: str = ""
    threshold_db: float = -45.0        # reference: threhold
    buffer_num: int = 2
    crossfade_time: float = 0.04
    pitch_extractor: str = "dio"       # reference: select_pitch_extractor
    use_spk_mix: bool = False
    sounddevices: List[str] = dataclasses.field(default_factory=lambda: ["", ""])
    pipeline_depth: int = 0            # 1 = one window in flight on the device

    # --- persistence ------------------------------------------------------

    @staticmethod
    def profile_path(directory: str, name: str = "default") -> str:
        return os.path.join(directory, f"{name}.yaml")

    def save(self, directory: str, name: str = "default") -> str:
        """Write this profile as <directory>/<name>.yaml; returns the path."""
        import yaml

        os.makedirs(directory, exist_ok=True)
        path = self.profile_path(directory, name)
        with open(path, "w") as f:
            yaml.safe_dump(dataclasses.asdict(self), f, sort_keys=True)
        return path

    @classmethod
    def load(cls, directory: str, name: str = "default") -> "StreamConfig":
        """Load a named profile; unknown keys are ignored (forward compat),
        missing keys keep their defaults (reference load-on-start
        semantics, gui.py:164-171)."""
        import yaml

        path = cls.profile_path(directory, name)
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in fields}
        if kwargs.get("spk_mix_dict"):
            kwargs["spk_mix_dict"] = {
                int(k): float(v) for k, v in kwargs["spk_mix_dict"].items()
            }
        return cls(**kwargs)

    @classmethod
    def list_profiles(cls, directory: str) -> List[str]:
        if not os.path.isdir(directory):
            return []
        return sorted(
            os.path.splitext(f)[0]
            for f in os.listdir(directory)
            if f.endswith(".yaml")
        )

    # --- session construction --------------------------------------------

    def session_kwargs(self) -> Dict:
        """Kwargs for StreamingSession(core, **kwargs)."""
        return dict(
            samplerate=self.samplerate,
            block_time=self.block_time,
            crossfade_time=self.crossfade_time,
            buffer_num=self.buffer_num,
            use_phase_vocoder=self.use_phase_vocoder,
            pipeline_depth=self.pipeline_depth,
            spk_id=self.spk_id,
            use_spk_mix=self.use_spk_mix,
            spk_mix_dict=self.spk_mix_dict,
            threshold_db=self.threshold_db,
            pitch_adjust=self.pitch_adjust,
            use_enhancer=self.use_enhancer,
            pitch_extractor_type=self.pitch_extractor,
        )
