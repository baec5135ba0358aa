"""The ranks of the port's data-parallel tests: `spawn(job, out_dir)` runs a
job on two gloo processes on the CPU (torch.multiprocessing.spawn) and
returns each rank's results.  This module imports torch and the port only,
so a rank starts without JAX; the tests compute the JAX side in their own
process and compare.

A job is {"checks": [(name, kwargs), ...], "vit_sizes": {...} or None,
"ports": [free ports]}.  Every check takes its inputs as the GLOBAL batch
(numpy), keeps this rank's contiguous rows and returns numpy arrays and
floats.  Checks named "main:*" call an entry point under --distributed in
the job's directory; each initialises and ends its own process group.
"""
from __future__ import annotations

import contextlib
import glob
import os
import socket
from types import SimpleNamespace

import numpy as np
import torch

WORLD = 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(job: dict, out_dir: str, world: int = WORLD, meanwhile=None) -> list:
    """Runs `job` on `world` gloo ranks, calling `meanwhile()` in this
    process while they run; -> [rank 0's results, rank 1's, ...]."""
    import torch.multiprocessing as mp

    job = {**job, "ports": [free_port() for _ in range(1 + len(job["checks"]))]}
    path = os.path.join(out_dir, "job.pt")
    torch.save(job, path)
    ctx = mp.spawn(_rank_main, args=(world, path, out_dir), nprocs=world, join=False)
    try:
        if meanwhile is not None:
            meanwhile()
    finally:
        while not ctx.join():
            pass
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def rows(a, rank: int, world: int):
    """This rank's contiguous rows of a global batch (numpy or tensor)."""
    B = a.shape[0] // world
    return a[rank * B:(rank + 1) * B]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _env(rank: int, world: int, port: int) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))


def _rank_main(rank: int, world: int, path: str, out_dir: str) -> None:
    from ssl_audio_tpu_torch import parallel

    torch.set_num_threads(1)
    job = torch.load(path, weights_only=False)
    if job.get("vit_sizes"):
        from ssl_audio_tpu_torch.models import vit

        vit._SIZES = dict(job["vit_sizes"])
    results = {}
    ports = iter(job["ports"])
    _env(rank, world, next(ports))
    parallel.init_distributed(SimpleNamespace(distributed=True, device="cpu"))
    try:
        for name, kwargs in job["checks"]:
            if not name.startswith("main:"):
                results[name] = CHECKS[name.split("#")[0]](rank, world, **kwargs)
    finally:
        parallel.destroy()
    for name, kwargs in job["checks"]:
        if name.startswith("main:"):
            _env(rank, world, next(ports))
            results[name] = run_main(**kwargs)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


# ------------------------------------------------------------------ checks

def check_batchnorm(rank, world, x, dy, weight, bias, running_mean, running_var):
    """models/batchnorm.py in training mode on this rank's rows: the output,
    the input's gradient, this rank's share of the parameters' and the
    running buffers; BatchNorm2d for a 4-D x, BatchNorm1d for a 2-D one."""
    from ssl_audio_tpu_torch.models.batchnorm import BatchNorm1d, BatchNorm2d

    bn = (BatchNorm2d if x.ndim == 4 else BatchNorm1d)(x.shape[1])
    with torch.no_grad():
        for name, v in (("weight", weight), ("bias", bias), ("running_mean", running_mean),
                        ("running_var", running_var)):
            getattr(bn, name).copy_(_t(v))
    bn.train()
    xl = _t(rows(x, rank, world)).requires_grad_(True)
    out = bn(xl)
    (out * _t(rows(dy, rank, world))).sum().backward()
    return {"out": _np(out), "dx": _np(xl.grad), "dweight": _np(bn.weight.grad),
            "dbias": _np(bn.bias.grad), "running_mean": _np(bn.running_mean),
            "running_var": _np(bn.running_var)}


def check_fused_block(rank, world, x, kernel, bias, gamma, beta, dpooled):
    """The fused block's autograd Function on this rank's rows: pooled, the
    global mean and var, dx and this rank's share of the four parameter
    gradients."""
    from ssl_audio_tpu_torch.ops.fused_conv import fused_conv1_bn_relu_pool

    args = [_t(rows(x, rank, world))] + [_t(a) for a in (kernel, bias, gamma, beta)]
    for a in args:
        a.requires_grad_(True)
    pooled, mean, var = fused_conv1_bn_relu_pool(*args)
    (pooled * _t(rows(dpooled, rank, world))).sum().backward()
    out = {"pooled": _np(pooled), "mean": _np(mean), "var": _np(var)}
    for name, a in zip(("dx", "dkernel", "dbias", "dgamma", "dbeta"), args):
        out[name] = _np(a.grad)
    return out


def check_bt_loss(rank, world, students, teachers, HSIC):
    """objectives/barlow.py with world_scale = world on this rank's rows: the
    loss and the gradients of this rank's rows."""
    from ssl_audio_tpu_torch.objectives.barlow import barlow_twins_loss

    zs = [_t(rows(z, rank, world)).requires_grad_(True) for z in students]
    zt = [_t(rows(z, rank, world)).requires_grad_(True) for z in teachers]
    loss = barlow_twins_loss(zs, zt, HSIC=HSIC, world_scale=float(world))
    loss.backward()
    return {"loss": float(loss), "dstudents": [_np(z.grad) for z in zs],
            "dteachers": [_np(z.grad) for z in zt]}


def check_mixup(rank, world, xs, alphas, us, n_memory):
    """augment/augmentations.py apply_mixup on this rank's rows, one call
    per entry of xs (the bank written each time): the mixed rows and the
    bank, count and position after each call."""
    from ssl_audio_tpu_torch.augment import augmentations as A

    state = A.init_mixup_state(n_memory, xs[0].shape[1:])
    out = []
    for x, alpha, u in zip(xs, alphas, us):
        idx = A.bank_index(_t(rows(u, rank, world)), state.count)
        mixed = A.apply_mixup(_t(rows(x, rank, world)), state, _t(rows(alpha, rank, world)),
                              idx)
        out.append({"mixed": _np(mixed), "bank": _np(state.bank), "count": int(state.count),
                    "pos": int(state.pos)})
    return out


def check_attention(rank, world, qkv, key_bias, dout, heads):
    """The fused attention's Function on this rank's rows (plain versions on
    the CPU): its output and input gradients."""
    from ssl_audio_tpu_torch.ops.fused_attention import fused_attention

    q = _t(rows(qkv, rank, world)).requires_grad_(True)
    kb = _t(rows(key_bias, rank, world)).requires_grad_(True)
    out = fused_attention(q, kb, heads)
    (out * _t(rows(dout, rank, world))).sum().backward()
    return {"out": _np(out), "dqkv": _np(q.grad), "dbias": _np(kb.grad)}


def check_steps(rank, world, kw, state_dict, steps, byol=False, stats=(-4.95, 5.855),
                world_scale=None):
    """Training steps on this rank's rows from `state_dict` (a TrainState's
    state_dict(), the same on every rank): each step {"wav": global (B, L),
    "draws": global StepDraws or None, "gen_seed": int (when draws is None),
    "views": global views to run on instead of the port's own (the port's
    are made first, the bank advances), "mask_ratio", "len_keep"}.  ->
    per step the metrics, the gap of the port's views to the given ones and
    the state_dict() after it.  world_scale: the loss's, W by default."""
    from ssl_audio_tpu_torch.config import default_config
    from ssl_audio_tpu_torch.train import steps as tsteps
    from ssl_audio_tpu_torch.train.state import init_train_state

    cfg = default_config(**kw, device="cpu")
    state = init_train_state(cfg, torch.Generator().manual_seed(0), niter_per_ep=2, byol=byol,
                             device="cpu")
    state.load_state_dict(state_dict)
    factory = tsteps.make_byol_train_step if byol else tsteps.make_train_step
    step = factory(cfg, world_scale=float(world if world_scale is None else world_scale),
                   frontend=tsteps.make_device_frontend(cfg, stats))
    apply_pair_views, given, gaps = tsteps.apply_pair_views, {}, []

    def replay(batch, aug, cfg_, draws):
        ours = apply_pair_views(batch, aug, cfg_, draws)
        if given.get("views") is None:
            return ours
        theirs = [_t(rows(v, rank, world)) for v in given["views"]]
        gaps.append(max(float((a - b).abs().max()) for a, b in zip(ours, theirs)))
        return theirs

    tsteps.apply_pair_views = replay
    out = []
    try:
        gen = None
        for s in steps:
            given["views"] = s.get("views")
            if s.get("draws") is None and gen is None:
                gen = torch.Generator().manual_seed(s["gen_seed"])
            metrics = step(state, _t(rows(s["wav"], rank, world)), gen=gen,
                           draws=s.get("draws"), mask_ratio=s.get("mask_ratio", 0.0),
                           len_keep=s.get("len_keep"))
            out.append({"metrics": {k: float(v) for k, v in metrics.items()},
                        "state": _cpu(state.state_dict())})
    finally:
        tsteps.apply_pair_views = apply_pair_views
    return {"steps": out, "view_gaps": gaps}


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def run_main(argv, cwd, byol=False, resume_glob=None):
    """main (or main_bt_byol) with --distributed in `cwd`, resumed from the
    one file `resume_glob` matches there when given -> its epoch losses,
    final train state and rows a batch."""
    from ssl_audio_tpu_torch import main, main_bt_byol

    entry = main_bt_byol.main if byol else main.main
    with contextlib.chdir(cwd):
        if resume_glob:
            (path,) = glob.glob(resume_glob)
            argv = [*argv, "--resume_path", path]
        trainer = entry(["--distributed", *argv])
    return {"losses": dict(trainer.epoch_losses), "state": _cpu(trainer.state.state_dict()),
            "batch_rows": trainer.loader.batch_size}


CHECKS = {"batchnorm": check_batchnorm, "fused_block": check_fused_block,
          "bt_loss": check_bt_loss, "mixup": check_mixup, "attention": check_attention,
          "steps": check_steps}
