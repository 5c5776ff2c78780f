"""Multi-device runs over torch.distributed: the process-group mesh and one
utterance's synthesizer and enhancer sharded over time (counterpart of
`ddsp_svc_tpu/parallel/`; data- and tensor-parallel training is not
ported)."""
from .mesh import Mesh, init_distributed, make_mesh
from .timeparallel import (TimeShard, make_time_parallel_enhancer,
                           make_time_parallel_forward, time_span)

__all__ = ["Mesh", "TimeShard", "init_distributed", "make_mesh",
           "make_time_parallel_enhancer", "make_time_parallel_forward",
           "time_span"]
