"""Checkpoints and deterministic resume (port of
ssl_audio_tpu/utils/checkpoint.py; reference main.py:484-496, utils.py:37-46).

A checkpoint is one torch.save file, model_{epoch}.pt: the train state's
state_dict() ("model", "optimizer", "scheduler", "augment", "step"), the
epoch to start from on resume ("epoch") and the generators ("rng").  Every
file holds tensors, ints, floats, strings, lists, dicts and None only, so it
loads under torch.load(..., weights_only=True), and its "model" entry is a
state dict under the reference's names (encoder.*, head.*, predictor.*):
hear.conv.load_model and hear.vit.load_model read a training checkpoint's
encoder as they read a reference .pth.

Deterministic resume: the reference re-derives its randomness from the seed
on resume, so a resumed run draws other augmentations than an uninterrupted
one.  Here the Trainer's device generator and its host numpy generator
travel in the checkpoint, so (train k epochs, save, resume, train n - k) is
bit-identical to an uninterrupted n-epoch run where the device's kernels are
deterministic.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from ssl_audio_tpu_torch import parallel

_STATE_KEYS = ("model", "optimizer", "scheduler", "augment", "step")


def encode_rng(gen: torch.Generator, host_rng: np.random.Generator) -> dict:
    """(device generator, numpy PCG64 generator) -> {"device_generator": its
    state as a uint8 tensor, "host_pcg64": host_words(host_rng)}."""
    return {"device_generator": gen.get_state(), "host_pcg64": host_words(host_rng)}


def host_words(host_rng: np.random.Generator) -> list:
    """A numpy PCG64 generator -> six ints: the 128-bit state and increment
    split into 64-bit words (low first), has_uint32 and uinteger, the words
    the JAX encode_rng writes (and its `<checkpoint>.rng.npz` holds)."""
    st = host_rng.bit_generator.state
    if st["bit_generator"] != "PCG64":
        raise ValueError(f"only PCG64 host generators are stored, not {st['bit_generator']}")
    mask = (1 << 64) - 1

    def split128(v: int) -> list:
        return [v & mask, (v >> 64) & mask]

    return (split128(st["state"]["state"]) + split128(st["state"]["inc"])
            + [int(st["has_uint32"]), int(st["uinteger"])])


def decode_rng(tree: dict, device=None) -> tuple[torch.Generator, np.random.Generator]:
    """encode_rng's dict -> (a generator on `device` in the saved state, the
    host generator).  `device` must be of the type the state was saved from.
    A dict with "device_seed" in place of "device_generator" (a file
    converted from a JAX checkpoint, tools/convert_checkpoint.py) seeds a
    generator on any device with it."""
    gen = torch.Generator(device=device)
    if "device_generator" in tree:
        gen.set_state(tree["device_generator"])
    else:
        gen.manual_seed(int(tree["device_seed"]))
    w = [int(x) for x in tree["host_pcg64"]]
    host = np.random.default_rng(0)
    host.bit_generator.state = {
        "bit_generator": "PCG64",
        "state": {"state": w[0] | (w[1] << 64), "inc": w[2] | (w[3] << 64)},
        "has_uint32": w[4],
        "uinteger": w[5],
    }
    return gen, host


def _to_cpu(obj):
    """The same containers with every tensor copied to the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _save(path: str, payload: dict) -> None:
    """torch.save through a temporary file, so a crash mid-write leaves any
    earlier file at `path` whole."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(_to_cpu(payload), tmp)
    os.replace(tmp, path)


def _read(path: str) -> dict:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint file at {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint(path: str, state, epoch: int, rng: Optional[dict] = None) -> None:
    """Write `state` (a TrainState) with `epoch`, the epoch a resumed run
    starts at (the Trainer passes the finished epoch + 1, as JAX does), and
    encode_rng's dict.  In a process group every rank calls it, rank 0
    alone writes (the replicas are equal), and every rank returns once the
    file is there."""
    if parallel.rank() == 0:
        _save(path, {**state.state_dict(), "epoch": int(epoch), "rng": rng})
    parallel.barrier()


def load_checkpoint(path: str, state) -> tuple[object, int, Optional[dict]]:
    """Restore `state` in place from `path` -> (state, the epoch to start at,
    the rng dict or None).  FileNotFoundError for a missing file, ValueError
    for a file that is not a training checkpoint; the state's own errors
    where the file belongs to another configuration.  In a process group
    every rank reads the same file, after a barrier (rank 0 may have just
    written it)."""
    parallel.barrier()
    ck = _read(path)
    missing = [k for k in _STATE_KEYS + ("epoch",) if k not in ck]
    if missing:
        raise ValueError(f"{path} is not a training checkpoint: no {', '.join(missing)}")
    state.load_state_dict(ck)
    return state, int(ck["epoch"]), ck.get("rng")


def save_params_only(path: str, modules: nn.Module) -> None:
    """The modules' state dict alone, under "model"."""
    _save(path, {"model": modules.state_dict()})


def load_params_only(path: str, modules: nn.Module) -> nn.Module:
    modules.load_state_dict(_read(path)["model"], strict=True)
    return modules


def _layout_mismatches(want: dict, got: dict) -> list[str]:
    """Names, shapes and dtypes of `got` that differ from `want`."""
    out = [f"missing {k}" for k in want if k not in got]
    out += [f"unexpected {k}" for k in got if k not in want]
    for k in want:
        if k in got and (got[k].shape, got[k].dtype) != (want[k].shape, want[k].dtype):
            out.append(f"{k}: {tuple(got[k].shape)} {got[k].dtype}, this model "
                       f"{tuple(want[k].shape)} {want[k].dtype}")
    return out


def _same_training_layout(state, ck: dict) -> bool:
    """True where `ck` is a whole train state of this configuration: every
    state key, the same module names, shapes and dtypes, the same optimizer
    (its keys, groups and group sizes) and a scheduler where this run has one."""
    if not all(k in ck for k in _STATE_KEYS):
        return False
    if _layout_mismatches(state.modules.state_dict(), ck["model"]):
        return False
    mine = state.optimizer.state_dict()

    def groups(sd):
        return [(sorted(g), len(g["params"])) for g in sd["param_groups"]]

    return (sorted(mine) == sorted(ck["optimizer"])
            and groups(mine) == groups(ck["optimizer"])
            and (state.scheduler is None) == (ck["scheduler"] is None))


def _load_orbax_encoder(path: str, state):
    """load_encoder_checkpoint of a JAX Orbax directory: the encoder grafted
    from any layout weights.encoder_trees_from_jax accepts.  A whole train
    state goes to the port through tools/convert_checkpoint.py --to pt."""
    from ssl_audio_tpu_torch.utils import weights
    from ssl_audio_tpu_torch.utils.orbax import read_orbax_tree

    params, stats = weights.encoder_trees_from_jax(read_orbax_tree(path), path)
    try:
        weights.load_encoder_from_jax_(state.modules["encoder"], params, stats)
    except (KeyError, ValueError, TypeError) as e:
        raise ValueError(f"the checkpoint's encoder does not match the configured model "
                         f"({path}): {e}") from e
    return state


def load_encoder_checkpoint(path: str, state):
    """Restore `state` (a TrainState) from a checkpoint for its encoder.

    Where the file is a whole train state of this configuration, all of it
    is restored (a probe that wants the head has it).  Otherwise only the
    encoder is grafted from the file's "model" entry (a params-only file, a
    run with another head or optimizer, or a legacy DINO / BYOL-A state,
    whose online encoder.* is taken and its target.* left): its names,
    shapes and dtypes must equal the encoder's, else ValueError names the
    differences.  From a directory written by the JAX package (Orbax) only
    the encoder is grafted (utils/orbax.py; the layouts of weights.py
    encoder_trees_from_jax); it needs tensorstore, and where that is absent
    the ImportError gives the converter's command.
    FileNotFoundError for a missing file."""
    from ssl_audio_tpu_torch.utils.orbax import is_orbax_dir

    if is_orbax_dir(path):
        return _load_orbax_encoder(path, state)
    ck = _read(path)
    if _same_training_layout(state, ck):
        state.load_state_dict(ck)
        return state
    model = ck.get("model", ck)
    enc = {k[len("encoder."):]: v for k, v in model.items() if k.startswith("encoder.")}
    bad = _layout_mismatches(state.modules["encoder"].state_dict(), enc)
    if bad:
        raise ValueError(f"the checkpoint's encoder does not match the configured model "
                         f"({path}): " + "; ".join(bad[:8]) + (" ..." if len(bad) > 8 else ""))
    state.modules["encoder"].load_state_dict(enc, strict=True)
    return state
