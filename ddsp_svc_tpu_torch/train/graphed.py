"""K optimizer steps per dispatch as replays of captured CUDA graphs.

The port's counterpart of `ddsp_svc_tpu/train/step.py::make_train_step_multi`
(and `make_train_step_pool`, `make_train_step_pool_multi`): where XLA runs
K steps as one compiled program, the card replays a captured step K times
from device-resident inputs, so the host issues a fixed handful of calls a
step in place of the eager step's ~1000 launches.

One graph of the whole step would freeze the loss's scale draw: the RSS
loss averages n_scale of 16 bucket sizes drawn per step on the host
(`models/losses.py::RSSLoss.draw`; JAX switches on the device). So a step
is
  A       the forward to the signal (with the pool, the crop gather
          first) from static inputs: the batch (or the pool's index
          arrays) and the noise excitation;
  L_i     one graph per bucket i: that bucket's loss and its gradient with
          respect to the signal (backward fed 1 / n_scale, as the mean
          feeds it), into the graph's own outputs;
  C       the model's backward from a static signal gradient, then the
          AdamW update (capturable: its step counts live on the card).
A and C share a memory pool and replay in their capture order; each L_i
has a pool of its own, since they replay in the draw's order. Per step the
host copies microbatch k into the static inputs (device to device), draws
the noise into its buffer with the step's generator, replays A, the drawn
L_i, sums their gradients into C's input in the order autograd sums them
in the eager step (the last drawn first) and their losses in the mean's
order, and replays C: the eager step's arithmetic, kernel for kernel.

Before the capture, every part runs once on a side stream (cuFFT plans,
the Bluestein tables of `ops/kernels.py::dft_tables`, the windows of
`ops/windows.py`, the optimizer's state), after which the parameters and
the optimizer state are put back as they were. The kernels' wrappers count
in Python, which a replay never runs: each graph's launches are recorded
at its capture (`kernels.captured_launches`) and added on every replay
(`kernels.add_launches`). A capture that fails raises; nothing falls back
to eager steps.

On a mesh (`mesh=`, train/step.py's data- and tensor-parallel step) C is
cut in two: C1, the backward into the flat gradient buffer
(`parallel.sharding.GradBuffer`, captured as every parameter's .grad),
then, eagerly between the replays, the one all-reduce of the gradients
and the loss over 'data', then C2, the AdamW update. The data-parallel
all-reduce stays outside the graphs, so it runs over NCCL and Gloo alike
(two Gloo ranks may share one card). The noise is drawn for the whole
batch into one buffer whose rows for this rank are the forward's input.
With more than one rank on the 'model' axis the tensor-parallel
collectives sit inside the captured forward and backward, which only NCCL
can capture: over Gloo the constructor raises.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

from ..models.losses import sss_loss
from ..ops import kernels
from ..parallel.sharding import batch_rows
from .step import (TrainState, draw_loss_idx, draw_noise, forward_signal,
                   grad_buffer, noise_generator)


def bucket_loss_grad(signal: torch.Tensor, audio: torch.Tensor, n_fft: int,
                     eps: float, scale: torch.Tensor):
    """One loss bucket: (sss loss, its gradient with respect to the signal
    for a backward fed `scale`, the mean's 1 / n_scale)."""
    sig = signal.detach().requires_grad_()
    loss = sss_loss(audio, sig, n_fft, eps)
    grad, = torch.autograd.grad(loss, sig, scale)
    return loss.detach(), grad


def combine_buckets(outs, idx, n_scale: int, grad_out: torch.Tensor
                    ) -> torch.Tensor:
    """The drawn buckets' (loss, grad) pairs as the eager RSS step combines
    them: the gradients summed into grad_out last drawn first (the order
    in which autograd's engine delivers the mean's branches to the signal),
    the losses summed in draw order and divided by n_scale (the mean).
    Returns the loss."""
    grad_out.copy_(outs[idx[-1]][1])
    for i in reversed(idx[:-1]):
        grad_out.add_(outs[i][1])
    loss = outs[idx[0]][0]
    for i in idx[1:]:
        loss = loss + outs[i][0]
    return loss / n_scale


class _Graph:
    """A captured CUDA graph and the kernel launches each replay makes."""

    def __init__(self, pool=None):
        self.graph = torch.cuda.CUDAGraph()
        self.pool = pool
        self.launches: dict = {}

    def capture(self, fn):
        with kernels.captured_launches() as self.launches:
            with torch.cuda.graph(self.graph, pool=self.pool):
                out = fn()
        return out

    def replay(self) -> None:
        self.graph.replay()
        kernels.add_launches(self.launches)


class GraphedTrainSteps:
    """train_steps on the card: __call__(staged) runs one step per leading
    index of the staged (K, ...) tensors (loader batches, or with a
    DevicePool its index dicts) and returns the (K,) losses. The graphs are
    captured at construction from the first staged item's shapes."""

    def __init__(self, state: TrainState, rss, staged: Dict[str, torch.Tensor],
                 pool=None, remat: bool = False, mesh=None):
        model, opt = state.model, state.optimizer
        if not all(g["capturable"] for g in opt.param_groups):
            raise ValueError("the graphed step needs a capturable optimizer "
                             "(train/step.py::create_optimizer on the card)")
        if (mesh is not None and mesh.size("model") > 1
                and dist.get_backend(mesh.group("model")) != "nccl"):
            raise ValueError(
                "a tensor-parallel step (n_model > 1) under a CUDA graph "
                "needs NCCL: its collectives sit inside the captured "
                "forward and backward, and Gloo's run on the host, which a "
                "graph cannot capture")
        self.state, self.rss, self.pool, self.mesh = state, rss, pool, mesh
        self.inputs = {k: v[0].clone() for k, v in staged.items()}
        self.scale = torch.full((), 1.0 / rss.n_scale,
                                device=self.inputs["spk_id"].device)
        f0 = self._f0()
        rows = f0.shape[0] * (1 if mesh is None else mesh.size("data"))
        self.noise_all = torch.empty((rows, f0.shape[1] * model.block_size),
                                     device=f0.device)
        self.noise = (self.noise_all if mesh is None
                      else self.noise_all[batch_rows(mesh, rows)])
        self.grads = None if mesh is None else grad_buffer(state)
        model.train()

        def forward():
            batch = pool.gather(self.inputs) if pool is not None \
                else self.inputs
            return batch, forward_signal(model, batch, self.noise, remat)

        def bucket(n_fft: int):
            return bucket_loss_grad(self.signal, self.batch["audio"], n_fft,
                                    rss.eps, self.scale)

        def backward():
            if self.grads is None:
                self.signal.backward(self.grad_signal)
                opt.step()
            else:  # C1: into the flat buffer, AdamW apart (C2)
                self.grads.flat.zero_()
                self.signal.backward(self.grad_signal)

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._warm_up(forward, bucket, backward)
        torch.cuda.current_stream().wait_stream(side)

        self.fwd = _Graph()
        self.batch, self.signal = self.fwd.capture(forward)
        self.buckets: List[_Graph] = []
        self.outs = []
        for n_fft in rss.buckets:
            g = _Graph()
            self.outs.append(g.capture(lambda: bucket(n_fft)))
            self.buckets.append(g)
        self.grad_signal = torch.zeros_like(self.signal)
        opt.zero_grad(set_to_none=True)
        if self.grads is not None:
            self.grads.attach()
        self.bwd = _Graph(pool=self.fwd.graph.pool())
        self.bwd.capture(backward)
        self.adamw = (None if self.grads is None
                      else _Graph(pool=self.fwd.graph.pool()))
        if self.adamw is not None:
            self.adamw.capture(opt.step)

    def _warm_up(self, forward, bucket, backward) -> None:
        """Every part once, eagerly; then the parameters and the optimizer
        state as they were (a fresh state is zeros, as AdamW makes it)."""
        model, opt = self.state.model, self.state.optimizer
        params = [p.detach().clone() for p in model.parameters()]
        saved = {p: {k: v.clone() for k, v in st.items()}
                 for p, st in opt.state.items()}
        draw_noise(model, self._f0(), noise_generator(
            self.state, self.scale.device), out=self.noise_all, mesh=self.mesh)
        self.batch, self.signal = forward()
        self.grad_signal = torch.zeros_like(self.signal)
        for n_fft in self.rss.buckets:
            self.grad_signal.add_(bucket(n_fft)[1])
        opt.zero_grad(set_to_none=True)
        if self.grads is not None:
            self.grads.attach()
        backward()
        if self.grads is not None:
            self.grads.reduce(self.mesh, self.grad_signal.sum())
            opt.step()
        opt.zero_grad(set_to_none=True)
        with torch.no_grad():
            for p, v in zip(model.parameters(), params):
                p.copy_(v)
            for p, st in opt.state.items():
                for k, v in st.items():
                    if p in saved:
                        v.copy_(saved[p][k])
                    else:
                        v.zero_()
        del self.batch, self.signal, self.grad_signal

    def _f0(self) -> torch.Tensor:
        """A tensor of the batch's (B, F) shape, for the noise's."""
        if self.pool is None:
            return self.inputs["f0"]
        return self.pool.frames.expand(self.inputs["feat_start"].shape[0], -1)

    def __call__(self, staged: Dict[str, torch.Tensor]) -> torch.Tensor:
        state, n = self.state, self.rss.n_scale
        losses = []
        for k in range(next(iter(staged.values())).shape[0]):
            for name, v in staged.items():
                self.inputs[name].copy_(v[k])
            draw_noise(state.model, self._f0(),
                       noise_generator(state, self.noise.device),
                       out=self.noise_all, mesh=self.mesh)
            idx = draw_loss_idx(state, self.rss)
            self.fwd.replay()
            for i in idx:
                self.buckets[i].replay()
            loss = combine_buckets(self.outs, idx, n, self.grad_signal)
            self.bwd.replay()
            if self.adamw is not None:
                loss = self.grads.reduce(self.mesh, loss)[0].clone()
                self.adamw.replay()
            losses.append(loss)
            state.step += 1
        return torch.stack(losses)
