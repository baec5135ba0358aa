"""BYOL-A style log-mel augmentations as batched device ops (port of
ssl_audio_tpu/augment/augmentations.py).

Randomness is explicit.  Each augmentation is a *draw* (`draw_*`, from a
torch.Generator on the batch's device) and a deterministic *apply* that takes
the drawn parameters, so a test can hand the apply what another framework
drew.  The random entry points (`random_resize_crop`, `mixup_byola`,
`random_linear_fader`, `mix_gaussian_noise`) draw and apply.

  * random_resize_crop: zero "virtual crop canvas", input pasted in the
    centre, a crop of random scale, torch-bicubic (a = -0.75) resize with
    align_corners=True, expressed as two per-sample interpolation matrices
    whose taps are clamped to the crop; products in fp32 (TF32 is off for
    matmul by default, and stays off here).
  * mixup_byola: mixing with a random entry of a FIFO memory bank in the
    linear-power domain.  The bank is a ring buffer on the device, its count
    and write position device tensors, all written IN PLACE (the JAX
    package returns a new state).
  * random_linear_fader, mix_gaussian_noise, normalize_batch (unbiased std
    over axes (0, 2, 3)), running_norm.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ssl_audio_tpu_torch import parallel

TORCH_EPS = float(np.finfo(np.float32).eps)


# ---------------------------------------------------------------------------
# Bicubic resize-by-matrix
# ---------------------------------------------------------------------------

def _cubic_weights(t: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    """Cubic-convolution weights for taps at distances (1+t, t, 1-t, 2-t)
    (Keys, a = -0.75, torch's bicubic).  t in [0, 1) -> (..., 4)."""
    def k1(x):   # |x| <= 1
        return (a + 2.0) * x ** 3 - (a + 3.0) * x ** 2 + 1.0

    def k2(x):   # 1 < |x| < 2
        return a * x ** 3 - 5.0 * a * x ** 2 + 8.0 * a * x - 4.0 * a

    return torch.stack([k2(1.0 + t), k1(t), k1(1.0 - t), k2(2.0 - t)], dim=-1)


def _interp_matrix(out_size: int, canvas_size: int, start: torch.Tensor,
                   extent: torch.Tensor) -> torch.Tensor:
    """start, extent (B,) float32 -> (B, out_size, canvas_size) matrices M
    with M[b] @ canvas_axis == the 1-D bicubic resize (align_corners=True)
    of canvas[start : start + extent] to out_size.  Taps are clamped to the
    crop bounds, as torch's bicubic on the cropped tensor does."""
    start = start.float()[:, None]
    extent = extent.float()[:, None]
    u = torch.arange(out_size, dtype=torch.float32, device=start.device)[None, :]
    if out_size > 1:
        scale = (extent - 1.0) / max(out_size - 1, 1)
    else:
        scale = torch.zeros_like(extent)
    src = start + u * scale                               # (B, out)
    src0 = torch.floor(src)
    w = _cubic_weights(src - src0)                        # (B, out, 4)
    taps = src0[..., None] + torch.arange(-1.0, 3.0, device=start.device)
    taps = torch.minimum(torch.maximum(taps, start[..., None]),
                         (start + extent - 1.0)[..., None])
    taps = torch.round(taps).long()
    m = torch.zeros(start.shape[0], out_size, canvas_size, device=start.device)
    return m.scatter_add_(2, taps, w)                     # clamped taps coincide: add


def _canvas(lms: torch.Tensor, virtual_crop_scale) -> torch.Tensor:
    """(B, C, F, T) pasted into the centre of a zero canvas."""
    F_in, T_in = lms.shape[-2:]
    ch, cw = int(F_in * virtual_crop_scale[0]), int(T_in * virtual_crop_scale[1])
    y_off, x_off = (ch - F_in) // 2, (cw - T_in) // 2
    canvas = lms.new_zeros(*lms.shape[:-2], ch, cw)
    canvas[..., y_off:y_off + F_in, x_off:x_off + T_in] = lms
    return canvas


class CropBoxes(NamedTuple):
    """Per-sample crop boxes on the canvas, float32 (B,): top i, left j,
    height h, width w."""
    i: torch.Tensor
    j: torch.Tensor
    h: torch.Tensor
    w: torch.Tensor


def draw_crop_boxes(gen: torch.Generator, B: int, in_size: Tuple[int, int],
                    virtual_crop_scale=(1.0, 1.5), freq_scale=(0.6, 1.5),
                    time_scale=(0.6, 1.5), device=None) -> CropBoxes:
    """The reference's get_params: int() floors the scaled size; offsets are
    inclusive-uniform over the remaining room."""
    F_in, T_in = in_size
    ch, cw = int(F_in * virtual_crop_scale[0]), int(T_in * virtual_crop_scale[1])
    u = torch.rand(4, B, generator=gen, device=device)
    h = torch.floor((freq_scale[0] + u[0] * (freq_scale[1] - freq_scale[0])) * F_in).clamp(1, ch)
    w = torch.floor((time_scale[0] + u[1] * (time_scale[1] - time_scale[0])) * T_in).clamp(1, cw)
    i = torch.floor(u[2] * (ch - h + 1.0))
    j = torch.floor(u[3] * (cw - w + 1.0))
    return CropBoxes(i, j, h, w)


def resize_bicubic_crop(lms: torch.Tensor, boxes: CropBoxes, out_size: Tuple[int, int],
                        virtual_crop_scale=(1.0, 1.5)) -> torch.Tensor:
    """Deterministic crop + resize: lms (B, C, F, T) and per-sample boxes ->
    (B, C, out_size[0], out_size[1]), out[b, c] = My[b] @ canvas[b, c] @ Mx[b]^T."""
    canvas = _canvas(lms, virtual_crop_scale)
    my = _interp_matrix(out_size[0], canvas.shape[-2], boxes.i, boxes.h)
    mx = _interp_matrix(out_size[1], canvas.shape[-1], boxes.j, boxes.w)
    return torch.einsum("bhc,bkcw,bxw->bkhx", my, canvas, mx)


def random_resize_crop(gen: torch.Generator, lms: torch.Tensor,
                       out_size=(64, 96), virtual_crop_scale=(1.0, 1.5),
                       freq_scale=(0.6, 1.5), time_scale=(0.6, 1.5)) -> torch.Tensor:
    """Batched RandomResizeCrop; independent boxes per sample."""
    boxes = draw_crop_boxes(gen, lms.shape[0], lms.shape[-2:], virtual_crop_scale,
                            freq_scale, time_scale, device=lms.device)
    return resize_bicubic_crop(lms, boxes, out_size, virtual_crop_scale)


# ---------------------------------------------------------------------------
# MixupBYOLA with a ring-buffer memory bank on the device
# ---------------------------------------------------------------------------

@dataclass
class MixupState:
    """FIFO memory bank of past (pre-augmentation) log-mels: bank
    (n_memory, C, F, T), count = valid entries, pos = next write position,
    both 0-d int32 tensors on the bank's device (JAX's MixupState), updated
    in place, so a step captured in a CUDA graph advances them at every
    replay and nothing is read back to the host.  A checkpoint holds them as
    ints."""
    bank: torch.Tensor
    count: torch.Tensor
    pos: torch.Tensor

    def state_dict(self) -> dict:
        return {"bank": self.bank, "count": int(self.count), "pos": int(self.pos)}

    def load_state_dict(self, sd: dict) -> None:
        """Copies the bank, count and pos into this state's tensors (their
        device stays)."""
        self.bank.copy_(sd["bank"])
        self.count.fill_(int(sd["count"]))
        self.pos.fill_(int(sd["pos"]))


def init_mixup_state(n_memory: int, shape, device=None) -> MixupState:
    return MixupState(bank=torch.zeros(n_memory, *shape, device=device),
                      count=torch.zeros((), dtype=torch.int32, device=device),
                      pos=torch.zeros((), dtype=torch.int32, device=device))


def log_mixup_exp(xa: torch.Tensor, xb: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    x = alpha * torch.exp(xa) + (1.0 - alpha) * torch.exp(xb)
    return torch.log(x + TORCH_EPS)


def bank_index(u: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """floor(u * max(count, 1)): a bank entry ~ U{0, count - 1} per sample
    (0 when the bank is empty, where the mix is not used)."""
    return torch.floor(u * count.clamp(min=1)).long()


def draw_mixup(gen: torch.Generator, B: int, count: torch.Tensor, ratio: float = 0.2,
               device=None):
    """(alpha (B, 1, 1, 1) = ratio * U(0, 1), idx (B,) ~ U{0, count - 1})."""
    alpha = ratio * torch.rand(B, 1, 1, 1, generator=gen, device=device)
    u = torch.rand(B, generator=gen, device=device)
    return alpha, bank_index(u, count)


def apply_mixup(x: torch.Tensor, state: MixupState, alpha: torch.Tensor,
                idx: torch.Tensor, update_bank: bool = True) -> torch.Tensor:
    """mixed_i = log((1 - a_i) e^{x_i} + a_i e^{bank[idx_i]} + eps); an empty
    bank passes x through (JAX's where(count > 0, mixed, x)).  With
    update_bank the batch is then written into the ring buffer at rows
    (pos + arange(B)) % n, in place.  In a process group x is this rank's
    rows and the bank is replicated state written with the global batch,
    as in JAX: the ranks' rows are gathered in rank order before the write,
    B counts the global batch, and an index may pick any global row."""
    out = torch.where(state.count > 0, log_mixup_exp(x, state.bank[idx], 1.0 - alpha), x)
    if update_bank:
        xs = parallel.gather_rows(x.detach())
        n, B = state.bank.shape[0], xs.shape[0]
        if B > n:
            raise ValueError(f"batch {B} larger than the mixup bank {n}")
        rows = (state.pos + torch.arange(B, device=x.device)) % n
        state.bank[rows] = xs.to(state.bank.dtype)
        state.count.copy_(torch.clamp(state.count + B, max=n))
        state.pos.copy_((state.pos + B) % n)
    return out


def mixup_byola(gen: torch.Generator, x: torch.Tensor, state: MixupState,
                ratio: float = 0.2, update_bank: bool = True) -> torch.Tensor:
    alpha, idx = draw_mixup(gen, x.shape[0], state.count, ratio, device=x.device)
    return apply_mixup(x, state, alpha, idx, update_bank)


# ---------------------------------------------------------------------------
# RandomLinearFader / MixGaussianNoise / NormalizeBatch
# ---------------------------------------------------------------------------

def draw_fader(gen: torch.Generator, B: int, gain: float = 1.0, device=None) -> torch.Tensor:
    """(B, 2) ramp ends ~ gain * U(-1, 1)."""
    return gain * (2.0 * torch.rand(B, 2, generator=gen, device=device) - 1.0)


def apply_linear_fader(lms: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Add a per-sample linear gain ramp from ends[:, 0] to ends[:, 1]."""
    head, tail = ends[:, 0:1], ends[:, 1:2]
    u = torch.linspace(0.0, 1.0, lms.shape[-1], device=lms.device)[None, :]
    return lms + (head + (tail - head) * u)[:, None, None, :]


def random_linear_fader(gen: torch.Generator, lms: torch.Tensor, gain: float = 1.0):
    return apply_linear_fader(lms, draw_fader(gen, lms.shape[0], gain, lms.device))


def draw_gaussian_noise(gen: torch.Generator, shape, ratio: float = 0.2, device=None):
    """(lambd (B, 1, 1, 1) = ratio * U(0, 1), field ~ N(0, 1) of `shape`)."""
    lambd = ratio * torch.rand(shape[0], 1, 1, 1, generator=gen, device=device)
    return lambd, torch.randn(*shape, generator=gen, device=device)


def apply_gaussian_noise(lms: torch.Tensor, lambd: torch.Tensor,
                         field: torch.Tensor) -> torch.Tensor:
    """log((1 - lambd) e^lms + e^(lambd * field) + eps)."""
    return torch.log((1.0 - lambd) * torch.exp(lms) + torch.exp(lambd * field) + TORCH_EPS)


def mix_gaussian_noise(gen: torch.Generator, lms: torch.Tensor, ratio: float = 0.2):
    return apply_gaussian_noise(lms, *draw_gaussian_noise(gen, lms.shape, ratio, lms.device))


def global_mean(x: torch.Tensor, dim, correction: int = 0) -> torch.Tensor:
    """sum over `dim` / (count - correction), keepdim.  Where `dim` holds
    the batch axis 0, over the global batch in a process group (one
    all-reduce of the sum; parallel/)."""
    count, s = math.prod(x.shape[d] for d in dim), x.sum(dim=dim, keepdim=True)
    if 0 in dim:
        count, s = parallel.batch_count(count), parallel.all_reduce_sum(s)
    return s / (count - correction)


def normalize_batch(x: torch.Tensor, dim=(0, 2, 3)) -> torch.Tensor:
    """Per-batch standardisation with the unbiased std (two passes), over
    the global batch."""
    mean = global_mean(x, dim)
    std = torch.sqrt(global_mean((x - mean) ** 2, dim, correction=1)).clamp_min(TORCH_EPS)
    return (x - mean) / std


# ---------------------------------------------------------------------------
# RunningNorm (streaming statistics, frozen after max_update calls)
# ---------------------------------------------------------------------------

@dataclass
class RunningNormState:
    mu: torch.Tensor          # mean, the shape of one reduced sample
    s2: torch.Tensor          # running mean of the squared deviation
    n: torch.Tensor           # updates so far: a 0-d int32 tensor on mu's device

    def state_dict(self) -> dict:
        return {"mu": self.mu, "s2": self.s2, "n": int(self.n)}

    def load_state_dict(self, sd: dict) -> None:
        """Copies into this state's tensors, in place (their device stays)."""
        self.mu.copy_(sd["mu"])
        self.s2.copy_(sd["s2"])
        self.n.fill_(int(sd["n"]))


def init_running_norm_state(shape, device=None) -> RunningNormState:
    z = torch.zeros(*shape, device=device)
    return RunningNormState(mu=z, s2=z.clone(),
                            n=torch.zeros((), dtype=torch.int32, device=device))


def running_norm(x: torch.Tensor, state: RunningNormState, max_update: int,
                 dim=(1, 2)) -> torch.Tensor:
    """The reference's RunningNorm, its off-by-one incremental mean included
    (mu += (m - mu) / n with n incremented afterwards), frozen after
    max_update updates.  Updates `state` in place, on the device: every
    branch is a select, so a captured step updates it at every replay."""
    m = global_mean(x, dim)
    first, n = state.n == 0, state.n.clamp(min=1).float()
    mu = torch.where(first, m, state.mu + (m - state.mu) / n)
    d2 = global_mean((x - mu) ** 2, dim)
    s2 = torch.where(first, d2, state.s2 + (d2 - state.s2) / n)
    update = state.n < max_update
    state.mu.copy_(torch.where(update, mu, state.mu))
    state.s2.copy_(torch.where(update, s2, state.s2))
    state.n.add_(update.to(state.n.dtype))
    std = torch.sqrt(state.s2).clamp_min(TORCH_EPS)
    return (x - state.mu) / std
