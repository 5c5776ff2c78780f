"""One rank of the port's multi-rank tests: time-parallel conversion and
mesh training.

Run by tests/test_torch_parallel.py and tests/test_torch_mesh_train.py
(the CPU over Gloo) and tests/test_torch_cuda.py (the card, over Gloo or
NCCL) as a fresh process per rank:

    python tests/torch_parallel_worker.py JOB WORLD RANK PORT OUT DEVICE BACKEND

JOB is a torch.save'd list of (name, case, kwargs) or (name, case, kwargs,
(n_data, n_model)). Each rank joins a BACKEND group of WORLD ranks at
127.0.0.1:PORT, runs every case in order (the same on every rank, so their
collectives pair up) on the case's mesh on DEVICE (all ranks on the data
axis when no shape is given; each shape's mesh made once) with its tensors
moved to DEVICE, and saves {name: result} (on the CPU) and its kernel
launch counts under '_launches' to OUT with its rank appended. Imports
torch and the port only, so that a rank starts fast.
"""
import os
import socket
import subprocess
import sys

import torch

from ddsp_svc_tpu_torch.infer.enhancer import Enhancer, NsfHifiGAN
from ddsp_svc_tpu_torch.infer.streaming import SvcCore
from ddsp_svc_tpu_torch.models.factory import build_model, make_bucketed_synth
from ddsp_svc_tpu_torch.ops import kernels as K
from ddsp_svc_tpu_torch.data.device_pool import gather_batch
from ddsp_svc_tpu_torch.models.losses import RSSLoss
from ddsp_svc_tpu_torch.nn.nsf_hifigan import generator_from_h
from ddsp_svc_tpu_torch.parallel import (full_state_dicts, init_distributed,
                                         make_mesh,
                                         make_time_parallel_forward,
                                         shard_batch, shard_train_state)
from ddsp_svc_tpu_torch.train.checkpoint import (host_payload,
                                                 restore_checkpoint,
                                                 write_payload)
from ddsp_svc_tpu_torch.train.gan import GanTrainer
from ddsp_svc_tpu_torch.train.step import (TrainState, create_optimizer,
                                           stage, train_step, train_steps)
from ddsp_svc_tpu_torch.utils.config import DotDict


def _synth(mesh, args, state):
    model = build_model(DotDict(args), device=mesh.device)
    model.load_state_dict(state)
    return model


def synth_forward(mesh, args, state, units, f0, volume, spk_id, noise,
                  valid_frames=None):
    """make_time_parallel_forward's signal."""
    fwd = make_time_parallel_forward(_synth(mesh, args, state), mesh)
    return fwd(units, f0, volume, spk_id, noise, valid_frames=valid_frames)


def bucketed(mesh, args, state, units, f0, volume, spk_id, noise=None,
             seed=None):
    """make_bucketed_synth(mesh=)'s signal, its noise injected or drawn from
    a generator of `seed` on the mesh's device."""
    run = make_bucketed_synth(_synth(mesh, args, state), mesh=mesh)
    gen = (None if seed is None
           else torch.Generator(device=mesh.device).manual_seed(seed))
    return run(units, f0, volume, spk_id, noise=noise, generator=gen)


def enhancer_forward(mesh, h, state, audio, f0_frames, rand_ini,
                     bf16_min_channels=0):
    """NsfHifiGAN(mesh=)'s output."""
    nsf = NsfHifiGAN(None, h=h, device=mesh.device, mesh=mesh,
                     bf16_min_channels=bf16_min_channels)
    nsf.model.load_state_dict(state)
    return nsf(audio, f0_frames, rand_ini=rand_ini)[0]


def enhance(mesh, h, state, audio, sample_rate, f0, hop_size, rand_ini):
    """Enhancer(mesh=).enhance's output."""
    enh = Enhancer("nsf-hifigan", None, h=h, device=mesh.device, mesh=mesh)
    enh.enhancer.model.load_state_dict(state)
    return enh.enhance(audio, sample_rate, f0, hop_size, rand_ini=rand_ini)[0]


def svc_window(mesh, model_path, audio, sample_rate, infer_kw):
    """SvcCore(mesh=).infer's window, then (rank 0) SvcCore().infer's."""
    out = {"mesh": torch.as_tensor(SvcCore(
        model_path, device=mesh.device, mesh=mesh).infer(
        audio, sample_rate, **infer_kw)[0])}
    if torch.distributed.get_rank() == 0:
        out["ref"] = torch.as_tensor(SvcCore(
            model_path, device=mesh.device).infer(
            audio, sample_rate, **infer_kw)[0])
    return out


def _train_state(mesh, args, state, lr, resume=None):
    """A TrainState of the model from `state` (or a checkpoint `resume`),
    cut to this rank's slices of the mesh."""
    model = _synth(mesh, args, state)
    st = TrainState(0, model, create_optimizer(model, lr))
    if resume is not None:
        st.step = restore_checkpoint(resume, model, st.optimizer)
    shard_train_state(st, mesh)
    return st


def _full(st):
    """The gathered single-device state (collective), on rank 0 only."""
    sd, opt = full_state_dicts(st.model, st.optimizer)
    if torch.distributed.get_rank():
        return None
    return {"model": sd, "opt": opt}


def mesh_steps(mesh, args, state, batches, noises, loss_idx, lr=1e-3,
               remat=False, save=None, resume=None):
    """train_step(mesh=) on each global batch (its rows cut here) with its
    whole-batch noise and the pinned loss buckets; save=(after step n,
    path) writes the gathered checkpoint from rank 0 there; resume: a
    checkpoint to start from (restored whole, then cut). Returns the
    losses, the gathered state (rank 0) and this rank's slices."""
    st = _train_state(mesh, args, state, lr, resume)
    losses = []
    for i, (batch, noise) in enumerate(zip(batches, noises)):
        losses.append(float(train_step(st, shard_batch(batch, mesh), _RSS,
                                       noise=noise, loss_idx=loss_idx,
                                       remat=remat, mesh=mesh)))
        if save is not None and save[0] == i + 1:
            payload = host_payload(st.step, st.model, st.optimizer)
            if torch.distributed.get_rank() == 0:
                write_payload(save[1], payload)
    return {"losses": losses, "full": _full(st),
            "local": dict(st.model.state_dict()), "step": st.step}


class _Pool:
    """The device pool's gather over given arrays (data/device_pool.py)."""

    def __init__(self, arrays, crop_frames, block):
        self.arrays = arrays
        self.frames = torch.arange(crop_frames, device=arrays["f0"].device)
        self.samples = torch.arange(crop_frames * block,
                                    device=arrays["f0"].device)

    def gather(self, idx):
        return gather_batch(self.arrays, idx, self.frames, self.samples)


def pool_steps(mesh, args, state, arrays, staged, crop_frames, lr=1e-3,
               seed=0):
    """One K-step dispatch (train_steps, the CPU's form) over the pool's
    staged (K, B) index arrays, this rank's rows cut on axis 1, the noise
    and loss buckets drawn from the step seeds."""
    st = _train_state(mesh, args, state, lr)
    st.seed = seed
    pool = _Pool(arrays, crop_frames, int(args["data"]["block_size"]))
    losses = train_steps(st, shard_batch(staged, mesh, batch_axis=1), _RSS,
                         pool=pool, mesh=mesh)
    return {"losses": losses, "full": _full(st)}


def graphed_steps(mesh, args, state, staged, lr=1e-3, seed=0):
    """(The card.) K eager steps of train_steps(mesh=) against one graphed
    dispatch (GraphedTrainSteps(mesh=)) from the same weights, batches and
    seeds, cuDNN deterministic: both runs' losses and gathered parameters,
    and whether they agree bit for bit; or the error the capture raised."""
    from ddsp_svc_tpu_torch.train.graphed import GraphedTrainSteps

    torch.backends.cudnn.deterministic = True
    local = shard_batch(staged, mesh, batch_axis=1)
    eager = _train_state(mesh, args, state, lr)
    graphed = _train_state(mesh, args, state, lr)
    eager.seed = graphed.seed = seed
    try:
        steps = GraphedTrainSteps(graphed, _RSS, local, mesh=mesh)
    except ValueError as e:
        return {"error": str(e)}
    le = train_steps(eager, local, _RSS, mesh=mesh)
    lg = steps(local)
    bitwise = torch.equal(le, lg) and all(
        torch.equal(p, q) for p, q in zip(eager.model.parameters(),
                                          graphed.model.parameters()))
    return {"eager": le, "graphed": lg, "bitwise": bitwise,
            "params": [p.detach().cpu() for p in eager.model.parameters()],
            "graphed_params": [p.detach().cpu()
                               for p in graphed.model.parameters()]}


def gan_steps(mesh, h, g_state, mpd_state, msd_state, batch, ri_d, ri_g,
              lr=2e-4):
    """One data-parallel D and one G step (GanTrainer(mesh=)) from the
    given weights on this rank's rows, rand_ini the whole batch's."""
    gen = generator_from_h(h).to(mesh.device)
    gen.load_state_dict(g_state)
    trainer = GanTrainer(h, lr=lr, mesh=mesh)
    st = trainer.create_state(gen, seed=0)
    st.mpd.load_state_dict(mpd_state)
    st.msd.load_state_dict(msd_state)
    rows = shard_batch(batch, mesh)
    logs = trainer.step_d(st, rows, rand_ini=ri_d)
    logs.update(trainer.step_g(st, rows, rand_ini=ri_g))
    return {"logs": {k: float(v) for k, v in logs.items()},
            "generator": dict(st.generator.state_dict())}


# the mesh-training cases' loss: tests/test_parallel.py's RSS range, two
# scales (pinned by the cases that pass loss_idx)
_RSS = RSSLoss(128, 512, n_scale=2)

CASES = {f.__name__: f for f in (synth_forward, bucketed, enhancer_forward,
                                 enhance, svc_window, mesh_steps, pool_steps,
                                 graphed_steps, gan_steps)}


class Ranks:
    """WORLD rank processes running one job (`start_ranks`)."""

    def __init__(self, procs, out: str, timeout: float):
        self.procs, self.out, self.timeout = procs, out, timeout

    def wait(self) -> list:
        """Each rank's results; raises with the ranks' output if one failed
        or the job outlived its timeout (every rank is then killed)."""
        failed = False
        for p in self.procs:
            try:
                p.wait(timeout=self.timeout)
            except subprocess.TimeoutExpired:
                for q in self.procs:
                    q.kill()
                p.wait()
                failed = True
            failed = failed or p.returncode != 0
        if failed:
            logs = []
            for r in range(len(self.procs)):
                with open(f"{self.out}.{r}.log", errors="replace") as f:
                    logs.append(f"--- rank {r} ---\n{f.read()[-4000:]}")
            raise RuntimeError("a rank failed:\n" + "\n".join(logs))
        return [torch.load(f"{self.out}.{r}", weights_only=False)
                for r in range(len(self.procs))]


def start_ranks(jobs, world: int, folder: str, device: str = "cpu",
                backend: str = "gloo", timeout: float = 600) -> Ranks:
    """Start `world` ranks of this script on `jobs` (written to `folder`),
    joined at a free port of 127.0.0.1, each writing its output to a log
    file beside its results (a pipe left unread could fill and stall a rank
    inside a collective)."""
    os.makedirs(folder, exist_ok=True)
    job, out = os.path.join(folder, "job.pt"), os.path.join(folder, "out")
    torch.save(jobs, job)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = []
    for r in range(world):
        with open(f"{out}.{r}.log", "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), job, str(world),
                 str(r), str(port), out, device, backend], env=env,
                stdout=log, stderr=subprocess.STDOUT))
    return Ranks(procs, out, timeout)


def _to(x, device):
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    return x


def main(job: str, world: int, rank: int, port: int, out: str, device: str,
         backend: str) -> None:
    torch.set_num_threads(1)
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    init_distributed(f"127.0.0.1:{port}", world, rank, backend=backend,
                     device=device)
    meshes = {}
    K.reset_launch_counts()
    results = {}
    for name, case, kwargs, *shape in torch.load(job, weights_only=False):
        shape = tuple(shape[0]) if shape else (world, 1)
        if shape not in meshes:  # collective: every rank, in job order
            meshes[shape] = make_mesh(*shape, device=device)
        mesh = meshes[shape]
        kwargs = {k: v if k.endswith("state") else _to(v, mesh.device)
                  for k, v in kwargs.items()}
        results[name] = _to(CASES[case](mesh, **kwargs), "cpu")
        print(f"rank {rank}: {name} done", flush=True)
    results["_launches"] = K.launch_counts()
    torch.distributed.destroy_process_group()
    torch.save(results, f"{out}.{rank}")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
         sys.argv[5], sys.argv[6], sys.argv[7])
