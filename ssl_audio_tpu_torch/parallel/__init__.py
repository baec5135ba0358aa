"""Data parallelism of the port (counterpart of ssl_audio_tpu/parallel/mesh.py).

The JAX package shards the global batch over a 1-D 'data' mesh, and every
reduction over the batch axis becomes an all-reduce that GSPMD inserts: the
DDP gradient, the Barlow Twins correlation and its BatchNorm, SyncBatchNorm
and the fused block's moments.  Here it is PyTorch's idiom: one process per
GPU, launched by torchrun, each holding B / W rows of the global batch of B
and a replica of the parameters; the reductions are written out with
torch.distributed, between kernel launches.

`init_distributed` joins the process group from torchrun's environment
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL on the card
(each process binds cuda:LOCAL_RANK), gloo with `--device cpu`.  The JAX
package's single-process mesh over all local devices becomes one process
per GPU: a run on N cards is `torchrun --nproc_per_node N -m
ssl_audio_tpu_torch.main --distributed ...`.

Gradient convention.  Every rank computes the same global loss L (every
batch reduction is global).  The backward of the differentiable all-reduce
(`all_reduce_sum`) is an all-reduce of the incoming gradient, so each rank's
backward yields its share of the gradient of sum_ranks L = W L, and
`all_reduce_grads_` takes the mean over ranks: dL/dtheta, replicated.  The
fused conv block follows the same rule inside its autograd Function
(ops/fused_conv.py).  Outside a process group (a plain run) every helper
here returns its input or does nothing; inside one, world size 1 included,
every helper issues its collective.

The collectives are all_reduce and broadcast only (an all-gather is an
all-reduce of a zero-padded buffer): gloo refuses some others on CUDA
tensors, and a CUDA graph captures these with NCCL.
"""
from __future__ import annotations

import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0")) if is_distributed() else 0


def launched_world_size(cfg) -> int:
    """The world size a run of cfg will have: WORLD_SIZE under --distributed
    (1 when it is not set, which init_distributed refuses), else 1."""
    if is_distributed():
        return world_size()
    if getattr(cfg, "distributed", False):
        return int(os.environ.get("WORLD_SIZE", "1"))
    return 1


def init_distributed(cfg, backend: Optional[str] = None) -> None:
    """Join the process group torchrun describes (the JAX init_distributed,
    mesh.py:31-55).  Does nothing without cfg.distributed.  The device is
    cfg.device's type: the card unless "cpu" is asked for, and then
    cuda:LOCAL_RANK becomes the current device.  backend: "nccl" on the
    card and "gloo" on the CPU by default; gloo also takes CUDA tensors
    (several ranks on one card, which NCCL refuses).  Raises without
    torchrun's environment, without a card when the CPU was not asked for,
    and when the process group is already joined."""
    if not getattr(cfg, "distributed", False):
        return
    missing = [k for k in ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed needs torchrun's environment ({', '.join(missing)} not set): "
            "launch with torchrun --nproc_per_node N -m ssl_audio_tpu_torch.main "
            "--distributed ...")
    if is_distributed():
        raise RuntimeError("the process group is already initialised")
    dev = torch.device("cuda" if cfg.device is None else cfg.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--distributed found no CUDA device; pass --device cpu to "
                               "run the plain PyTorch path over gloo")
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))


def destroy() -> None:
    if is_distributed():
        dist.destroy_process_group()


def barrier() -> None:
    if is_distributed():
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """sum over ranks; its backward sums the incoming gradients over ranks
    (the module's gradient convention)."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of t over ranks, differentiable; t itself outside a process
    group."""
    return _AllReduceSum.apply(t) if is_distributed() else t


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """t summed over ranks in place (not differentiable)."""
    if is_distributed():
        dist.all_reduce(t)
    return t


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """(W * B, ...) from every rank's (B, ...), in rank order (the global
    batch's rows); t itself outside a process group.  Not differentiable.
    An all-reduce of a buffer that holds this rank's rows and zeros
    elsewhere: exact, since each element sums one value with zeros."""
    if not is_distributed():
        return t
    B = t.shape[0]
    out = torch.zeros((world_size() * B, *t.shape[1:]), dtype=t.dtype, device=t.device)
    out[rank() * B:(rank() + 1) * B] = t
    dist.all_reduce(out)
    return out


def batch_count(n_local: int) -> int:
    """The number of values a global-batch reduction runs over, from this
    rank's (every rank holds as many rows)."""
    return n_local * world_size()


def broadcast_(tensors: Iterable[torch.Tensor]) -> None:
    """Every tensor (parameters too) to rank 0's values, in place."""
    if not is_distributed():
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.detach(), src=0)


def all_reduce_grads_(optimizer: torch.optim.Optimizer) -> None:
    """The .grad of each of the optimizer's parameters to its mean over
    ranks, in place, as one flat all-reduce (parameters without a gradient
    are skipped; every rank has the same set)."""
    if not is_distributed():
        return
    grads = [p.grad for group in optimizer.param_groups for p in group["params"]
             if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat.div_(world_size())
    for g, f in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(f.view_as(g))
