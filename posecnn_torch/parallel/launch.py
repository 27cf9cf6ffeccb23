"""Multi-process launch: one process (rank) per device.

Port of `posecnn_tpu/parallel/launch.py` onto `torch.distributed`:

  * `initialize()` joins the ranks into one process group from
    POSECNN_COORDINATOR (host:port of rank 0's store), POSECNN_NUM_PROCESSES
    and POSECNN_PROCESS_ID, as JAX's `initialize` reads them. NCCL is the
    backend on CUDA, gloo on the CPU or when POSECNN_BACKEND (or the
    argument) asks for it: two ranks that share one GPU need gloo, since
    NCCL refuses them. With nothing set, or one process, it does nothing;
    a failed join raises, and nothing falls back to one process.
  * `rank_device` is the rank's device: cuda:<local rank>, or the device
    asked for when it names an index (ranks that share a GPU).
  * `global_batch_from_local` turns a rank's local shard and the
    replicated blobs into the step's batch; `DATA_SHARDED_KEYS` are the
    per-image keys, the train step's own list (`mesh.BATCH_KEYS`).
  * `run_ranks` starts N ranks of one command on this host with those
    variables set (the dry run, the tests, `chip_smoke.py` use it).
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

# the JAX package's DATA_SHARDED_KEYS (`launch.py:70-79`) lacks noise_sigma
# and chroma_dhls and adds data_gan and gan_z, which its step's
# batch_shardings does not shard; the port takes the step's set
from posecnn_torch.parallel.mesh import BATCH_KEYS as DATA_SHARDED_KEYS
from posecnn_torch.parallel.mesh import DATA_AXIS, Mesh, local_batch

ENV_VARS = ("POSECNN_COORDINATOR", "POSECNN_NUM_PROCESSES", "POSECNN_PROCESS_ID")
# seconds a rank waits for the others to join or to answer a collective
TIMEOUT_S = 600
# the directory that holds the package, put on each rank's PYTHONPATH
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _parse_address(address: str):
    host, sep, port = address.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"POSECNN_COORDINATOR {address!r}: expected host:port")
    return host, int(port)


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None, device=None) -> int:
    """Join the process group; returns the world size (1: nothing done).

    The arguments default to POSECNN_COORDINATOR, POSECNN_NUM_PROCESSES,
    POSECNN_PROCESS_ID and POSECNN_BACKEND. `device` is this rank's device:
    by default its card (`rank_device("cuda")`), the CPU only when asked for
    ("cpu"); NCCL on CUDA, gloo on the CPU, unless `backend` says
    otherwise. Raises ValueError on a partial or malformed setting,
    RuntimeError when the default card is asked for where CUDA is absent
    (nothing falls back to the CPU), and whatever `init_process_group`
    raises when the ranks cannot meet."""
    import torch
    import torch.distributed as dist

    env = os.environ
    coordinator_address = coordinator_address or env.get("POSECNN_COORDINATOR")
    if num_processes is None and env.get("POSECNN_NUM_PROCESSES"):
        num_processes = int(env["POSECNN_NUM_PROCESSES"])
    if process_id is None and env.get("POSECNN_PROCESS_ID"):
        process_id = int(env["POSECNN_PROCESS_ID"])
    if coordinator_address is None and num_processes is None and process_id is None:
        return 1
    if num_processes is not None and num_processes <= 1:
        return 1
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(f"a multi-process run needs all of {', '.join(ENV_VARS)}: got coordinator "
                         f"{coordinator_address!r}, processes {num_processes!r}, process id {process_id!r}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"POSECNN_PROCESS_ID {process_id} is not in [0, {num_processes})")
    host, port = _parse_address(coordinator_address)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(): no CUDA device for this rank; pass device='cpu' to join over gloo "
                               "on the CPU")
        device = rank_device("cuda")
    dev = torch.device(device)
    backend = backend or env.get("POSECNN_BACKEND") or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{host}:{port}", world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return num_processes


def shutdown() -> None:
    """Leave the process group, once every rank is done with it (a barrier,
    then `destroy_process_group`); nothing when there is none."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def local_rank() -> int:
    """This process's index among the ranks of its host: POSECNN_LOCAL_RANK,
    else POSECNN_PROCESS_ID (one host), else 0."""
    return int(os.environ.get("POSECNN_LOCAL_RANK", os.environ.get("POSECNN_PROCESS_ID", "0")))


def rank_device(device: str = "cuda") -> str:
    """This rank's device: `device` itself when it is the CPU or names an
    index (cuda:0: ranks that share one GPU), else cuda:<local rank>."""
    if device == "cuda":
        return f"cuda:{local_rank()}"
    return device


def global_batch_from_local(mesh: Mesh, batch: Dict, batch_keys: Optional[Sequence[str]] = None) -> Dict:
    """The step's batch from this rank's local shard (`launch.py:
    global_batch_from_local`): the blobs of `batch_keys` (default
    DATA_SHARDED_KEYS) are this rank's images; the replicated blobs are the
    global batch's, and the 'poses' rows, indexed by the global image,
    are moved to the local images (`mesh.local_batch`). The step then
    computes the global batch's function, as JAX's step on the assembled
    global arrays does."""
    return local_batch(mesh, batch, DATA_SHARDED_KEYS if batch_keys is None else batch_keys)


def process_local_batch_size(mesh: Mesh, global_batch: int) -> int:
    """This process's share of the global batch: one data row a process."""
    n = mesh.shape[DATA_AXIS]
    if global_batch % n:
        raise ValueError(f"a global batch of {global_batch} does not split over {n} data ranks")
    return global_batch // n


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(n: int, rank: int, port: int, backend: Optional[str] = None, base: Optional[Dict] = None) -> Dict:
    env = dict(os.environ if base is None else base)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    env.update(POSECNN_COORDINATOR=f"localhost:{port}", POSECNN_NUM_PROCESSES=str(n),
               POSECNN_PROCESS_ID=str(rank), POSECNN_LOCAL_RANK=str(rank))
    if backend:
        env["POSECNN_BACKEND"] = backend
    return env


def run_ranks(argv: Sequence[str], n: int, backend: Optional[str] = None, env: Optional[Dict] = None,
              timeout: Optional[float] = None, logs: Optional[Sequence[str]] = None, cwd: Optional[str] = None,
              on_start=None) -> List[int]:
    """Run `python argv...` as n ranks on this host (rank i with
    POSECNN_PROCESS_ID=i, all meeting at a free localhost port) and wait
    for them. Rank i's output goes to logs[i] (default: inherited). When a
    rank fails, the others are stopped (SIGTERM, then SIGKILL after 10 s);
    at `timeout` seconds all are. `on_start(procs)` is called once all
    have started. Returns the exit codes."""
    port = free_port()
    procs, files = [], []
    try:
        for r in range(n):
            out = open(logs[r], "w") if logs else None
            files.append(out)
            procs.append(subprocess.Popen([sys.executable, *argv], env=rank_env(n, r, port, backend, env), cwd=cwd,
                                          stdout=out, stderr=subprocess.STDOUT if out else None))
        if on_start is not None:
            on_start(procs)
        t_end = None if timeout is None else time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = any(p.returncode not in (None, 0) for p in procs)
            if failed or (t_end is not None and time.monotonic() > t_end):
                _stop(procs)
                break
            time.sleep(0.05)
        return [p.wait() for p in procs]
    finally:
        _stop(procs)
        for f in files:
            if f is not None:
                f.close()


def _stop(procs) -> None:
    live = [p for p in procs if p.poll() is None]
    for p in live:
        p.terminate()
    t_end = time.monotonic() + 10
    for p in live:
        try:
            p.wait(timeout=max(t_end - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
