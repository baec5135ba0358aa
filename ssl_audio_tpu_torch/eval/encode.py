"""Embedding extraction and the ViT's unit splitter (port of
ssl_audio_tpu/eval/encode.py; reference utils.py:278-314 encode_vit and
hear/sample/vit.py:109-126).

A (B, 1, F, T) clip batch is cut into (B*U, 1, F, unit) units and encoded
in one batched forward.  The reference pads time by unit - T % unit even
when T divides the unit, so such a clip gains a full unit of zeros (raw
zeros, padded after normalisation).  That unit is the same for every clip,
so it is forwarded once at batch 1 and its embedding broadcast.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ssl_audio_tpu_torch.utils import resolve_device


def pad_to_unit_multiple(x: torch.Tensor, unit_frames: int) -> torch.Tensor:
    """Zero-pad time by unit_frames - T % unit_frames: a whole unit when T
    already divides, as the reference pads (utils.py:283-285)."""
    return F.pad(x, (0, unit_frames - x.shape[-1] % unit_frames))


def _units(x: torch.Tensor, unit_frames: int) -> torch.Tensor:
    """(B, C, F, U*unit) -> (B*U, C, F, unit), unit by unit of each clip."""
    B, C, Fr, T = x.shape
    U = T // unit_frames
    return x.reshape(B, C, Fr, U, unit_frames).permute(0, 3, 1, 2, 4) \
        .reshape(B * U, C, Fr, unit_frames)


def encode_vit(apply_fn: Callable, x: torch.Tensor, unit_frames: int,
               use_cls: bool = True, patch_fbins: int = 4,
               embed_d: int = 768) -> torch.Tensor:
    """(B, 1, F, T) -> (B, D) with use_cls, else (B, patch_fbins * D): the
    mean over units.  apply_fn(xu, return_all) -> the CLS embedding (B', D)
    or all tokens (B', 1 + L, D).

    CLS: the mean of the units' CLS embeddings, the silent unit's included
    when T divides the unit.  Dense: the patch tokens as (time, freq * D)
    rows, the rows of padded frames removed (none when T divides the unit:
    the silent unit's rows are the tail the reference removes), averaged
    over time."""
    B, T_orig = x.shape[0], x.shape[-1]
    full_silent = T_orig % unit_frames == 0 and T_orig > 0
    if not full_silent:
        x = pad_to_unit_multiple(x, unit_frames)
    n_units = x.shape[-1] // unit_frames
    xu = _units(x, unit_frames)

    if use_cls:
        emb = apply_fn(xu, False).reshape(B, n_units, -1)
        if full_silent:
            zero = apply_fn(torch.zeros_like(xu[:1]), False)          # (1, D)
            return (emb.sum(dim=1) + zero) / (n_units + 1)
        return emb.mean(dim=1)

    tokens = apply_fn(xu, True)[:, 1:, :]                             # (B*U, L, D)
    t_per_unit = tokens.shape[1] // patch_fbins
    emb = tokens.reshape(B, n_units, patch_fbins, t_per_unit, embed_d) \
        .permute(0, 1, 3, 2, 4).reshape(B, n_units * t_per_unit, patch_fbins * embed_d)
    if not full_silent:
        # the padded frames' rows (utils.py:307-309)
        pad_frames = n_units * unit_frames - T_orig
        pad_emb_frames = int(t_per_unit * pad_frames / unit_frames)
        if pad_emb_frames > 0:
            emb = emb[:, :-pad_emb_frames]
    return emb.mean(dim=1)


def encode_lms_units(apply_fn: Callable, x: torch.Tensor,
                     unit_frames: int) -> torch.Tensor:
    """(B, 1, F, T) -> (B, U, D) per-unit CLS embeddings (HEAR encode_lms).
    When T divides the unit, U counts the silent unit too: its embedding,
    forwarded once at batch 1, is appended to every clip's units."""
    B = x.shape[0]
    if x.shape[-1] % unit_frames == 0 and x.shape[-1] > 0:
        xu = _units(x, unit_frames)
        emb = apply_fn(xu, False).reshape(B, xu.shape[0] // B, -1)
        zero = apply_fn(torch.zeros_like(xu[:1]), False)              # (1, D)
        return torch.cat([emb, zero.to(emb.dtype)[None].expand(B, 1, -1)], dim=1)
    xu = _units(pad_to_unit_multiple(x, unit_frames), unit_frames)
    return apply_fn(xu, False).reshape(B, xu.shape[0] // B, -1)


def extract_embeddings(forward: Callable, loader,
                       device=None) -> tuple[np.ndarray, np.ndarray]:
    """forward(batch on `device`) over a loader of (x, y) numpy batches ->
    (embeddings, targets) as numpy arrays (reference main.py:174-195).
    device None = the card: without one this raises unless the caller asks
    for "cpu"."""
    device = resolve_device(device)
    embs, targets = [], []
    for x, y in loader:
        out = forward(torch.as_tensor(np.asarray(x)).to(device))
        embs.append(out.detach().cpu().numpy())
        targets.append(np.asarray(y))
    return np.concatenate(embs), np.concatenate(targets)
