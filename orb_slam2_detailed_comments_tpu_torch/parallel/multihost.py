"""Multi-process runtime for the sharded global bundle adjustment.

Counterpart of orb_slam2_detailed_comments_tpu/parallel/multihost.py. The
reference is a single process (its concurrency is three pthreads over
shared memory, System.cc:133-152); sharding the global BA over every
device of a deployment is beyond it. JAX spans processes with
jax.distributed.initialize and one mesh over every device of every
process. Here a rank is one process with one device, the ranks form
torch.distributed's default process group, and the sharded solvers
(parallel/distributed_ba.py, parallel/distributed_ba_grouped.py) sum
over it with all_reduce:

    from orb_slam2_detailed_comments_tpu_torch.parallel import multihost
    multihost.initialize("10.0.0.1:9876", num_processes=4, process_id=rank)
    mesh = multihost.global_ba_mesh("pt")
    cams, pts = distributed_global_ba_grouped(prob, cam, inv_s2, mesh)

Backends. A rank on a CUDA device sums its tensors over NCCL and polls the
stop flag of an interruptible solve over Gloo, on the host
("cpu:gloo,cuda:nccl", also what backend="nccl" gives such a rank), so
neither syncs with the device. A rank on the CPU takes Gloo. Ranks that
share one card pass backend="gloo": Gloo moves a CUDA tensor through host
memory, a host sync per sum. Nothing falls back: a backend that does not
initialise raises.

`run_ranks` spawns the ranks of one host as processes (the tests, the dry
run graft_entry.dryrun_multichip, examples/bench_scaling.py).
"""
from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               device="cuda", cpu_devices_per_process: Optional[int] = None) -> None:
    """Join this process to the default process group as rank `process_id`
    of `num_processes`. `coordinator` is "host:port" (TCP), or any init
    method torch.distributed takes ("file://...", "env://"); None reads
    MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE from the environment.
    backend=None picks it from `device` (module docstring); "nccl" on a
    CUDA rank adds Gloo for the host-side stop poll. A CUDA rank takes
    `device`'s index, or its rank modulo the visible cards.

    JAX's cpu_devices_per_process emulates several devices per process;
    a rank here is one device, so a value above 1 raises."""
    if cpu_devices_per_process is not None and cpu_devices_per_process > 1:
        raise ValueError(f"cpu_devices_per_process={cpu_devices_per_process}: a rank is one "
                         "device; start one process per device instead")
    dev = torch.device(device)
    if backend is None or (backend == "nccl" and dev.type == "cuda"):
        backend = "cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo"
    if coordinator is None:
        init_method = "env://"
    else:
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    kwargs = {}
    if num_processes is not None:
        kwargs = dict(world_size=num_processes, rank=process_id)
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else dist.get_rank() % torch.cuda.device_count())


class Mesh(NamedTuple):
    """The ranks of a process group, this rank's device and the axis the
    solver shards (JAX's 1-D Mesh over every device)."""
    axis: str
    device: torch.device
    group: object = None          # None: the default process group

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of every rank's `x` (JAX's psum): one
        all_reduce, issued on the calling thread's current CUDA stream."""
        x = x.contiguous()
        dist.all_reduce(x.view(-1), group=self.group)
        return x

    def any(self, flag: bool) -> bool:
        """True on every rank when `flag` is True on any: a stop poll all
        ranks agree on, over Gloo on the host (no device sync). Every group
        initialize() makes has Gloo; one with NCCL alone raises here."""
        t = torch.full((1,), int(bool(flag)), dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())


def global_ba_mesh(axis: str = "edge", device="cuda") -> Mesh:
    """The mesh over every rank of the default group. axis="edge" feeds the
    flat edge-sharded solver (parallel/distributed_ba.py), axis="pt" the
    grouped point-sharded one (parallel/distributed_ba_grouped.py).
    device="cuda" is the device initialize() set for this rank."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(axis, dev)


def make_global_array(x, mesh: Mesh, sharded: bool = True) -> torch.Tensor:
    """This rank's part of host-replicated data on its device: every rank
    holds all of `x` (the map is small beside its observations); a sharded
    array is split along its first axis, whose length the ranks divide."""
    x = np.ascontiguousarray(x)
    if sharded:
        n = x.shape[0] // mesh.size
        if n * mesh.size != x.shape[0]:
            raise ValueError(f"{x.shape[0]} rows do not split over {mesh.size} ranks")
        x = x[mesh.rank * n:(mesh.rank + 1) * n]
    return torch.from_numpy(np.ascontiguousarray(x)).to(mesh.device)


# ---------------------------------------------------------------------------
# ranks of one host as processes
# ---------------------------------------------------------------------------

def check_ranks_fit(device, backend: Optional[str], n: int) -> None:
    """Raise unless `n` ranks can run on `device` with `backend`: NCCL
    wants a card a rank, so more ranks than cards need backend="gloo"."""
    if torch.device(device).type == "cuda" and backend != "gloo":
        n_cards = torch.cuda.device_count()
        if n > n_cards:
            raise ValueError(f"{n} ranks over NCCL need {n} cards, {n_cards} visible; "
                             "pass backend='gloo' for ranks that share a card")


def _rank_main(fn, rank, n, init_method, backend, device, args, results):
    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        elif dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        initialize(init_method, n, rank, backend, dev)
        try:
            out = fn(dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:                         # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, n: int, args=(), backend: Optional[str] = None, device="cuda",
              timeout: float = 120.0):
    """Run fn(device, *args) on `n` ranks, each a spawned process joined to
    a default group of its own (a FileStore in a temporary directory), and
    return their results in rank order. `fn` is a module-level function;
    a CUDA rank without an index takes card rank % count. A rank that
    fails, or ranks still running after `timeout` s, raise here; every
    process is gone when this returns."""
    import multiprocessing as mp
    check_ranks_fit(device, backend, n)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, n, init_method, backend, str(device), args, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        out = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < n:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"a rank exited with code {dead[0]}") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{n - len(out)} of {n} ranks still running "
                                           f"after {timeout} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
                out[rank] = value
        finally:
            for p in procs:
                p.join(timeout=5.0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(n)]
