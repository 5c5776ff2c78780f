"""Adversarial fine-tuning of the NSF-HiFiGAN enhancer.

Counterpart of `ddsp_svc_tpu/train/gan.py`: the HiFi-GAN objective (LSGAN
adversarial + feature matching + mel-reconstruction L1) with the two
alternating AdamW optimizers of the JAX `GanTrainer` (optax.adamw: b1 0.8,
b2 0.99, eps 1e-8, weight decay 1e-4):

    gan = GanTrainer(h, lr=2e-4, mel_weight=45.0)
    state = gan.create_state(generator, seed=0)
    logs = gan.step_d(state, batch)   # the discriminators
    logs = gan.step_g(state, batch)   # the generator

A step updates the state's modules in place and returns its loss terms as
0-d tensors on the device. The generator's SineGen rotations (`rand_ini`,
(B, 9) uniform with column 0 at 0) are drawn from the state's
torch.Generator unless the caller passes them (tests inject JAX's).

With a mesh (`GanTrainer(..., mesh=, mesh_axis="data")`, JAX's mesh= in
the port's form) the D and G steps run data-parallel: each rank's batch is
its rows of the global batch, rand_ini is drawn for the whole batch (every
rank the same draw) and sliced to them, and each step's gradients and loss
terms are averaged over the axis in one all-reduce before the step: the
parameters' .grad are views of one flat buffer per optimizer
(`parallel.GradBuffer`, its trailing slots the logged terms; every term is
a per-item mean). Parameters and both optimizers stay replicated.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from ..nn.discriminators import (MultiPeriodDiscriminator,
                                 MultiScaleDiscriminator, discriminator_loss,
                                 feature_loss, generator_loss)
from ..nn.layers import lecun_init_
from ..ops.spectral import log_mel_spectrogram
from ..parallel.sharding import GradBuffer, batch_rows

# optax.adamw's default, which the JAX GanTrainer inherits (torch's is 1e-2)
WEIGHT_DECAY = 1e-4


def create_optimizer(params, lr: float) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=lr, betas=(0.8, 0.99), eps=1e-8,
                             weight_decay=WEIGHT_DECAY)


def mel_of(h: dict, audio: torch.Tensor) -> torch.Tensor:
    """The enhancer's log-mel of (B, T) audio on the fp32 FFT route, (B,
    n_mels, frames)."""
    return log_mel_spectrogram(audio, h["sampling_rate"], h["n_fft"],
                               h["hop_size"], h["win_size"], h["num_mels"],
                               h["fmin"], h["fmax"])


@dataclass
class GanState:
    step: int  # D steps taken, as the JAX GanState counts
    generator: torch.nn.Module
    mpd: MultiPeriodDiscriminator
    msd: MultiScaleDiscriminator
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    rand_gen: torch.Generator
    # on a mesh, each optimizer's flat gradient buffer (made at its first
    # step)
    grads: Dict[str, GradBuffer] = field(default_factory=dict)

    def d_parameters(self):
        return [*self.mpd.parameters(), *self.msd.parameters()]


class GanTrainer:
    def __init__(self, h: dict, lr: float = 2e-4, mel_weight: float = 45.0,
                 fm_weight: float = 2.0, mesh=None, mesh_axis: str = "data"):
        self.h = h
        self.lr = lr
        self.mel_weight = mel_weight
        self.fm_weight = fm_weight
        self.mesh, self.mesh_axis = mesh, mesh_axis

    def create_state(self, generator: torch.nn.Module, seed: int = 0
                     ) -> GanState:
        """The discriminators drawn from `seed` (lecun-normal kernels, zero
        biases, as flax initialises them) on the generator's device, both
        optimizers, and the rand_ini generator seeded from `seed`."""
        device = next(generator.parameters()).device
        gen = torch.Generator().manual_seed(seed)
        mpd = lecun_init_(MultiPeriodDiscriminator(), gen).to(device)
        msd = lecun_init_(MultiScaleDiscriminator(), gen).to(device)
        d_params = [*mpd.parameters(), *msd.parameters()]
        return GanState(
            step=0, generator=generator.train(), mpd=mpd.train(),
            msd=msd.train(),
            g_opt=create_optimizer(generator.parameters(), self.lr),
            d_opt=create_optimizer(d_params, self.lr),
            rand_gen=torch.Generator(device=device).manual_seed(seed))

    def _rand_ini(self, state: GanState, batch) -> torch.Tensor:
        b = batch["mel"].shape[0]
        if self.mesh is not None:
            b *= self.mesh.size(self.mesh_axis)
        ri = torch.rand((b, 9), generator=state.rand_gen,
                        device=batch["mel"].device)
        ri[:, 0] = 0.0
        return ri

    def _generate(self, state: GanState, batch, rand_ini) -> torch.Tensor:
        """rand_ini: the whole batch's on a mesh (sliced to this rank's
        rows); drawn from the state's generator when None."""
        if rand_ini is None:
            rand_ini = self._rand_ini(state, batch)
        if self.mesh is not None:
            rand_ini = rand_ini[batch_rows(self.mesh, rand_ini.shape[0],
                                             self.mesh_axis)]
        return state.generator(batch["mel"], batch["f0"], rand_ini)

    def _apply(self, state: GanState, part: str, params, loss,
               logs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One step of the part's optimizer ('d' or 'g') on the gradients
        of loss with respect to params alone (left in their .grad); on a
        mesh the gradients and the logged terms averaged over its axis in
        one all-reduce first. Returns the logs."""
        logs = {k: v.detach() for k, v in logs.items()}
        if self.mesh is None:
            for p, g in zip(params, torch.autograd.grad(loss, params)):
                p.grad = g
        else:
            if part not in state.grads:
                state.grads[part] = GradBuffer(params, n_terms=len(logs))
            grads = state.grads[part]
            grads.attach()
            loss.backward(inputs=params)
            logs = dict(zip(logs, grads.reduce(
                self.mesh, *logs.values(), axis=self.mesh_axis).clone()))
        (state.d_opt if part == "d" else state.g_opt).step()
        return logs

    def step_d(self, state: GanState, batch: Dict[str, torch.Tensor],
               rand_ini: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
        """batch: {"mel": (B, F, M), "f0": (B, F), "audio": (B, T)} on the
        device. The generator runs without a graph (JAX's stop_gradient)."""
        y = batch["audio"]
        with torch.no_grad():
            y_hat = self._generate(state, batch, rand_ini)
        rs_p, gs_p, _, _ = state.mpd(y, y_hat)
        rs_s, gs_s, _, _ = state.msd(y, y_hat)
        loss = discriminator_loss(rs_p, gs_p)[0] + discriminator_loss(
            rs_s, gs_s)[0]
        logs = self._apply(state, "d", state.d_parameters(), loss,
                           {"d_loss": loss})
        state.step += 1
        return logs

    def step_g(self, state: GanState, batch: Dict[str, torch.Tensor],
               rand_ini: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
        """The generator's step: differentiated with respect to its
        parameters alone, so no discriminator weight gradient is formed. The
        real audio's mel and scores carry no graph."""
        y = batch["audio"]
        y_hat = self._generate(state, batch, rand_ini)
        with torch.no_grad():
            mel_ref = mel_of(self.h, y)
            _, fr_p = state.mpd.score(y)
            _, fr_s = state.msd.score(y)
        l_mel = (mel_of(self.h, y_hat) - mel_ref).abs().mean() \
            * self.mel_weight
        gs_p, fg_p = state.mpd.score(y_hat)
        gs_s, fg_s = state.msd.score(y_hat)
        l_fm = (feature_loss(fr_p, fg_p) + feature_loss(fr_s, fg_s)
                ) * self.fm_weight
        l_adv = generator_loss(gs_p)[0] + generator_loss(gs_s)[0]
        total = l_mel + l_fm + l_adv
        return self._apply(state, "g", list(state.generator.parameters()),
                           total, {"g_loss": total, "mel": l_mel,
                                   "fm": l_fm, "adv": l_adv})
