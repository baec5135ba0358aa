"""Fixed positional tables of the ViT (the port's own copy of
ssl_audio_tpu/ops/pos_embed.py; pure numpy, computed once when a model is
built).

  * get_2d_sincos_pos_embed: frequency-axis half and time-axis half of the
    channels, with an optional zero row for the CLS token;
  * get_sinusoid_encoding_table: the interleaved sin/cos 1-D table of the
    MAE decoder.
"""
from __future__ import annotations

import numpy as np


def _1d_sincos(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega                       # (D/2,)
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)  # (M, D)


def get_2d_sincos_pos_embed(embed_dim: int, grid_sizes, cls_token: bool = True) -> np.ndarray:
    """2-D sin-cos table over a (gH, gW) patch grid -> float32
    (gH*gW [+1], embed_dim); the first channel half encodes the time (w)
    position, the second the frequency (h) position."""
    gH, gW = grid_sizes
    grid_w_mesh, grid_h_mesh = np.meshgrid(np.arange(gW, dtype=np.float32),
                                           np.arange(gH, dtype=np.float32))
    assert embed_dim % 2 == 0
    pos = np.concatenate([_1d_sincos(embed_dim // 2, grid_w_mesh),
                          _1d_sincos(embed_dim // 2, grid_h_mesh)], axis=1)
    if cls_token:
        pos = np.concatenate([np.zeros((1, embed_dim)), pos], axis=0)
    return pos.astype(np.float32)


def get_sinusoid_encoding_table(n_position: int, d_hid: int, cls_token: bool = True) -> np.ndarray:
    """Interleaved sinusoid table: even channels sin, odd channels cos."""
    position = np.arange(n_position, dtype=np.float64)[:, None]
    dim_idx = np.arange(d_hid, dtype=np.float64)[None, :]
    angle = position / np.power(10000, 2.0 * np.floor(dim_idx / 2.0) / d_hid)
    table = np.zeros((n_position, d_hid))
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    if cls_token:
        table = np.concatenate([np.zeros((1, d_hid)), table], axis=0)
    return table.astype(np.float32)
