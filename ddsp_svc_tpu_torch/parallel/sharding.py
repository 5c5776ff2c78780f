"""Data- and tensor-parallel training over the ('data', 'model') mesh.

Counterpart of `ddsp_svc_tpu/parallel/sharding.py`. JAX writes sharding
specs and GSPMD inserts the collectives; PyTorch has no partitioner, so
here each rank holds its slices of the tensor-parallel parameters and the
model's layers call the collectives themselves (Megatron's pairing, so one
all-reduce closes each block):

  - `TP_RULES` name the PCmer's matmuls and the Unit2Control head, one
    rule for each of JAX's: the attention's to_q/to_k/to_v by output
    (head), to_out by input; the conv module's up-projection by output,
    each rank holding the matching rows of both GLU halves, its depthwise
    conv by channel, its down-projection by input; dense_out by output
    column. Everything else is replicated.
  - `ModelShard` is a rank's place on the model axis; a sharded block
    calls `enter` at its input (identity forward, all-reduce of the input
    gradient in backward), `reduce` at the output of a row-parallel matmul
    (all-reduce forward, identity backward; the bias added once after it)
    and `gather` after a column-parallel dense_out (a zero-padded buffer
    holding each rank's columns in its own slot, all-reduced; backward
    takes the rank's own slice). Gloo on CUDA tensors takes all_reduce and
    broadcast only, so every gather is such an all-reduce.
  - Batches shard over 'data': each rank takes rows [i*B/n, (i+1)*B/n) of
    the global batch (`shard_batch`), and the gradients are the mean of
    the ranks' (`GradBuffer`: one all-reduce of a flat buffer that every
    .grad is a view of), since every loss term is a per-item mean.
  - Checkpoints hold the single-device state (`full_state_dicts` gathers
    it), so a run saved under one mesh resumes under any other.
"""
from __future__ import annotations

import re
from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..nn.layers import WeightNormDense
from ..nn.pcmer import ConformerConvModule, SelfAttention


class Shard(NamedTuple):
    """A parameter cut over the 'model' axis along `dim`: 'block' gives
    rank i the i-th of n contiguous blocks; 'glu' the i-th block of each
    of the two halves (the up-projection's GLU pairs)."""
    dim: int
    layout: str = "block"


# (pattern over the port's parameter names, Shard); first match wins. One
# rule for each of ddsp_svc_tpu/parallel/sharding.py's, in its order.
TP_RULES = [
    # attention: column-parallel QKV (by head), row-parallel output
    (r".*attn\.to_q\.weight$", Shard(0)),
    (r".*attn\.to_k\.weight$", Shard(0)),
    (r".*attn\.to_v\.weight$", Shard(0)),
    (r".*attn\.to_q\.bias$", Shard(0)),
    (r".*attn\.to_k\.bias$", Shard(0)),
    (r".*attn\.to_v\.bias$", Shard(0)),
    (r".*attn\.to_out\.weight$", Shard(1)),
    # conformer conv module: column-parallel up (GLU halves paired),
    # depthwise conv by channel, row-parallel down
    (r".*local_mixer\.net\.2\.weight$", Shard(0, "glu")),
    (r".*local_mixer\.net\.2\.bias$", Shard(0, "glu")),
    (r".*local_mixer\.net\.4\.weight$", Shard(0)),
    (r".*local_mixer\.net\.4\.bias$", Shard(0)),
    (r".*local_mixer\.net\.6\.weight$", Shard(1)),
    # output head: column-parallel over the control parameters
    (r".*dec_post\.2\.weight_v$", Shard(0)),
    (r".*dec_post\.2\.weight_g$", Shard(0)),
    (r".*dec_post\.2\.bias$", Shard(0)),
]


def _rule(name: str) -> Optional[Shard]:
    for pattern, spec in TP_RULES:
        if re.match(pattern, name):
            return spec
    return None


def param_shardings(model: torch.nn.Module, mesh
                    ) -> Dict[str, Optional[Shard]]:
    """{parameter name: its Shard over 'model', or None: replicated}, by
    TP_RULES, with JAX's guard: a rule applies only where the model axis
    divides the cut dimension."""
    size = mesh.size("model")
    out = {}
    for name, p in model.named_parameters():
        spec = _rule(name)
        if spec is not None and (spec.dim >= p.ndim
                                 or p.shape[spec.dim] % size):
            spec = None
        out[name] = spec
    return out


def _local_index(full: int, spec: Shard, size: int, index: int
                 ) -> torch.Tensor:
    """The indices along spec.dim that rank `index` of `size` holds."""
    if spec.layout == "glu":
        return torch.arange(full).reshape(2, size, -1)[:, index].reshape(-1)
    return torch.arange(full).reshape(size, -1)[index]


def _autograd_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _Enter(torch.autograd.Function):
    """Identity forward; the input gradient all-reduced over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _autograd_all_reduce(grad, ctx.group), None


class _Reduce(torch.autograd.Function):
    """The partial sums all-reduced over the group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _autograd_all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    """Each rank's last-axis columns in its own slot of a zero buffer,
    all-reduced; backward takes the rank's own slice."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        n = x.shape[-1]
        ctx.cols = (index * n, (index + 1) * n)
        buf = x.new_zeros((*x.shape[:-1], n * size))
        buf[..., index * n:(index + 1) * n] = x
        dist.all_reduce(buf, group=group)
        return buf

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.cols
        return grad[..., lo:hi].contiguous(), None, None, None


class ModelShard:
    """A rank's place on the mesh's 'model' axis: its group, the axis size
    and its index. The sharded layers call enter, reduce and gather."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(x, self.group, self.size, self.index)


def _blocks(model: torch.nn.Module, shardings: Dict[str, Optional[Shard]]):
    """(module, its parameters' shardings) of every block that TP_RULES
    reach: the attentions, the conv modules and dense_out."""
    for prefix, m in model.named_modules():
        if isinstance(m, (SelfAttention, ConformerConvModule,
                          WeightNormDense)):
            specs = {name: shardings[f"{prefix}.{name}"]
                     for name, _ in m.named_parameters()
                     if _rule(f"{prefix}.{name}") is not None}
            yield prefix, m, specs


def _cut(t: torch.Tensor, spec: Shard, size: int, index: int
         ) -> torch.Tensor:
    idx = _local_index(t.shape[spec.dim], spec, size, index).to(t.device)
    return t.index_select(spec.dim, idx).contiguous()


@torch.no_grad()
def shard_train_state(state, mesh) -> None:
    """Cut `state.model` (and its optimizer's state, when it has any) to
    this rank's slices of the 'model' axis, in place, and tell each
    sharded block its ModelShard. A block is sharded whole or not at all
    (JAX's guard replicates a dense_out whose columns the axis does not
    divide, as combsub.yaml's 3 x 513); the attention's heads must divide
    by the axis. Nothing changes on a mesh of one model rank."""
    size, index = mesh.size("model"), mesh.index("model")
    if size == 1:
        return
    model, opt = state.model, state.optimizer
    shardings = param_shardings(model, mesh)
    shard = ModelShard(mesh.group("model"), size, index)
    params = dict(model.named_parameters())
    for prefix, m, specs in _blocks(model, shardings):
        if all(s is None for s in specs.values()):
            continue
        if any(s is None for s in specs.values()):
            raise ValueError(f"{prefix}: the model axis ({size}) divides "
                             "some of its parameters and not others")
        if isinstance(m, SelfAttention):
            if m.heads % size:
                raise ValueError(f"{prefix}: {m.heads} heads do not divide "
                                 f"by the model axis ({size})")
            m.heads //= size
        elif isinstance(m, ConformerConvModule):
            dw = m.net["4"]
            dw.groups = dw.in_channels = dw.out_channels = \
                dw.out_channels // size
        m.tp = shard
        for name, spec in specs.items():
            p = params[f"{prefix}.{name}"]
            p.data = _cut(p.data, spec, size, index)
            for k, v in opt.state.get(p, {}).items():
                if torch.is_tensor(v) and v.ndim:
                    opt.state[p][k] = _cut(v, spec, size, index)


def _gather_param(local: torch.Tensor, full_shape, spec: Shard,
                  shard: ModelShard) -> torch.Tensor:
    idx = _local_index(full_shape[spec.dim], spec, shard.size, shard.index)
    buf = local.new_zeros(full_shape)
    buf.index_copy_(spec.dim, idx.to(local.device), local)
    dist.all_reduce(buf, group=shard.group)
    return buf


@torch.no_grad()
def full_state_dicts(model: torch.nn.Module,
                     optimizer: Optional[torch.optim.Optimizer] = None
                     ) -> tuple:
    """(model state_dict, optimizer state_dict) of the single-device model
    that this rank's slices belong to: every sharded parameter and its
    optimizer state gathered over 'model' (collective: every rank calls
    it). Unsharded, the rank's own state dicts."""
    sd = model.state_dict()
    opt_sd = optimizer.state_dict() if optimizer is not None else {}
    order = ([p for g in optimizer.param_groups for p in g["params"]]
             if optimizer is not None else [])
    slot = {id(p): i for i, p in enumerate(order)}
    for prefix, m in model.named_modules():
        if getattr(m, "tp", None) is None:
            continue
        for name, p in m.named_parameters():
            spec = _rule(f"{prefix}.{name}")
            if spec is None:
                continue
            full = list(p.shape)
            full[spec.dim] *= m.tp.size
            sd[f"{prefix}.{name}"] = _gather_param(p.detach(), full, spec,
                                                   m.tp)
            i = slot.get(id(p))
            if i in opt_sd.get("state", {}):
                # a new dict: state_dict() shares the optimizer's own
                opt_sd["state"][i] = {
                    k: (_gather_param(v, full, spec, m.tp)
                        if torch.is_tensor(v) and v.ndim else v)
                    for k, v in opt_sd["state"][i].items()}
    return sd, opt_sd


def batch_rows(mesh, n: int, axis: str = "data") -> slice:
    """This rank's rows of an n-row global batch: [i*n/d, (i+1)*n/d) on
    the mesh axis of size d, which must divide n."""
    size, index = mesh.size(axis), mesh.index(axis)
    if n % size:
        raise ValueError(f"batch of {n} rows does not divide over the "
                         f"'{axis}' axis ({size})")
    step = n // size
    return slice(index * step, (index + 1) * step)


def shard_batch(batch: Dict, mesh, batch_axis: int = 0) -> Dict:
    """This rank's rows of every array (numpy or tensor) of a global batch;
    batch_axis=1 for a K-step dispatch's (K, B, ...) arrays."""
    out = {}
    for k, v in batch.items():
        rows = batch_rows(mesh, v.shape[batch_axis])
        out[k] = v[(slice(None),) * batch_axis + (rows,)]
    return out


class GradBuffer:
    """Every parameter's gradient as a view of one flat fp32 buffer, with
    trailing slots for `n_terms` logged terms (the loss), so that a
    data-parallel step's gradients and terms cross ranks in one all-reduce
    (`reduce`)."""

    def __init__(self, params: Sequence[torch.nn.Parameter],
                 n_terms: int = 1):
        self.params = list(params)
        n = sum(p.numel() for p in self.params)
        self.flat = torch.zeros(n + n_terms, device=self.params[0].device)
        self.views, at = [], 0
        for p in self.params:
            self.views.append(self.flat[at:at + p.numel()].view(p.shape))
            at += p.numel()
        self.terms = self.flat[n:]

    def attach(self) -> None:
        """Zero the buffer and make it every parameter's .grad, which
        backward then accumulates into in place."""
        self.flat.zero_()
        for p, v in zip(self.params, self.views):
            p.grad = v

    def reduce(self, mesh, *terms: torch.Tensor, axis: str = "data"
               ) -> torch.Tensor:
        """The terms (0-d) into their slots, then the buffer's mean over
        the mesh axis; returns the terms' means (a view, (n_terms,))."""
        self.terms.copy_(torch.stack([t.detach().reshape(())
                                      for t in terms]))
        dist.all_reduce(self.flat, group=mesh.group(axis))
        self.flat.div_(mesh.size(axis))
        return self.terms
