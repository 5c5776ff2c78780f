"""Multi-device runs over torch.distributed (counterpart of
`ddsp_svc_tpu/parallel/`): the process-group mesh, data- and
tensor-parallel training (the TP rules, the state cut to a rank's slices
and gathered back whole, each rank's batch rows) and one utterance's
synthesizer and enhancer sharded over time, causal models included."""
from .mesh import Mesh, init_distributed, make_mesh
from .sharding import (TP_RULES, GradBuffer, ModelShard, Shard,
                       batch_rows, full_state_dicts, param_shardings,
                       shard_batch, shard_train_state)
from .timeparallel import (TimeShard, make_time_parallel_enhancer,
                           make_time_parallel_forward, time_span)

__all__ = ["Mesh", "TP_RULES", "GradBuffer", "ModelShard", "Shard",
           "TimeShard", "batch_rows", "full_state_dicts",
           "init_distributed", "make_mesh", "make_time_parallel_enhancer",
           "make_time_parallel_forward", "param_shardings", "shard_batch",
           "shard_train_state", "time_span"]
