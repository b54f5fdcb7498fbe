"""The rank side of tests/test_torch_parallel.py: a module-level function a
spawned rank runs (parallel/multihost.run_ranks imports it by name), with
no jax and nothing of the JAX package, so a rank starts quickly.
"""
import torch

from orb_slam2_detailed_comments_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_detailed_comments_tpu_torch.optim.local_ba import BAProblem
from orb_slam2_detailed_comments_tpu_torch.parallel.distributed_ba import (
    distributed_global_ba, make_ba_mesh)
from orb_slam2_detailed_comments_tpu_torch.parallel.distributed_ba_grouped import (
    distributed_global_ba_grouped, make_grouped_mesh)


def _problem(arrays, device):
    return BAProblem(**{k: torch.from_numpy(v).to(device) for k, v in arrays.items()})


def sharded_solves(device, grouped, flat, cams, inv_s2, grouped_iters, flat_iters):
    """On every rank: the grouped solve ("gemm" and "dense", grouped_iters =
    (LM iterations, CG iterations)) of `grouped`, the flat edge-sharded one
    (flat_iters) of `flat` (cams: the two problems' camera parameters), and
    the grouped "gemm" solve under a stop check that fires on the last
    rank's second poll only. Returns each result as numpy, whether the
    stopped solve returned None and how often this rank polled."""
    gcam, fcam = (PinholeCamera(**c) for c in cams)
    inv_s2 = torch.as_tensor(inv_s2)
    gprob, fprob = _problem(grouped, device), _problem(flat, device)
    gmesh = make_grouped_mesh(device)
    out = {b: distributed_global_ba_grouped(gprob, gcam, inv_s2, gmesh, *grouped_iters,
                                            backend=b)
           for b in ("gemm", "dense")}
    out["flat"] = distributed_global_ba(fprob, fcam, inv_s2, make_ba_mesh(device), *flat_iters)
    polls = []

    def stop_check():
        polls.append(1)
        return gmesh.rank == gmesh.size - 1 and len(polls) > 1

    stopped = distributed_global_ba_grouped(gprob, gcam, inv_s2, gmesh, *grouped_iters,
                                            backend="gemm", stop_check=stop_check)
    res = {k: (c.numpy(), p.numpy()) for k, (c, p) in out.items()}
    return dict(res, stopped=stopped is None, polls=len(polls))
