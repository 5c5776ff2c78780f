"""One rank of the port's time-parallel tests.

Run by tests/test_torch_parallel.py (the CPU over Gloo) and
tests/test_torch_cuda.py (the card, over Gloo or NCCL) as a fresh process
per rank:

    python tests/torch_parallel_worker.py JOB WORLD RANK PORT OUT DEVICE BACKEND

JOB is a torch.save'd list of (name, case, kwargs). Each rank joins a
BACKEND group of WORLD ranks at 127.0.0.1:PORT, builds a data-axis mesh on
DEVICE, runs every case in order (the same on every rank, so their
collectives pair up) with its tensors moved to DEVICE, and saves {name:
result} (on the CPU) and its kernel launch counts under '_launches' to OUT
with its rank appended. Imports torch and the port only, so that a rank
starts fast.
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
from ddsp_svc_tpu_torch.parallel import (init_distributed, make_mesh,
                                         make_time_parallel_forward)
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


CASES = {f.__name__: f for f in (synth_forward, bucketed, enhancer_forward,
                                 enhance, svc_window)}


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
    return x


def main(job: str, world: int, rank: int, port: int, out: str, device: str,
         backend: str) -> None:
    torch.set_num_threads(1)
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    init_distributed(f"127.0.0.1:{port}", world, rank, backend=backend,
                     device=device)
    mesh = make_mesh(device=device)
    K.reset_launch_counts()
    results = {}
    for name, case, kwargs in torch.load(job, weights_only=False):
        kwargs = {k: v if k == "state" else _to(v, mesh.device)
                  for k, v in kwargs.items()}
        results[name] = _to(CASES[case](mesh, **kwargs), "cpu")
        print(f"rank {rank}: {name} done", flush=True)
    results["_launches"] = K.launch_counts()
    torch.distributed.destroy_process_group()
    torch.save(results, f"{out}.{rank}")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
         sys.argv[5], sys.argv[6], sys.argv[7])
