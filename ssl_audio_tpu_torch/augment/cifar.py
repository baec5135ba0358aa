"""The CIFAR pair transform on the device (port of
ssl_audio_tpu/augment/cifar.py; reference utils/transforms.py:62-84
CifarPairTransform): RandomResizedCrop(32) -> hflip(0.5) ->
ColorJitter(0.4, 0.4, 0.4, 0.1) at 0.8 -> grayscale at 0.2 -> clip to
[0, 1] -> normalise -> NCHW.

The JAX function is copied, not torchvision's: the bilinear resample as
per-image (out, in) matrices with the align_corners=False mapping (so the
crop is two products), round for the crop's h and w and floor for its
corner, and the colour jitter in a fixed order (brightness, contrast,
saturation, then a hue rotation in YIQ space).

`draw_cifar_pair_views` draws every random number of a pair from a
torch.Generator: per image and view the 11 values of CIFAR_DRAWS, already
in their ranges; `apply_cifar_pair_views` is deterministic in them, so a
test can hand in the values JAX's keys give.  The uint8 batch is cast on
its device, and the resample products run in full fp32 there (TF32 would
move the views by ~1e-3).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch

from ssl_audio_tpu_torch.ops import no_tf32

CIFAR_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR_STD = (0.2023, 0.1994, 0.2010)
SIZE = 32
SCALE = (0.08, 1.0)                 # RandomResizedCrop's area range
RATIO = (3 / 4, 4 / 3)              # ... and its aspect range (log-uniform)
JITTER = (0.4, 0.4, 0.4, 0.1)       # brightness, contrast, saturation, hue
P_FLIP, P_JITTER, P_GRAY = 0.5, 0.8, 0.2
# the draws of one view of one image, in this order: the crop's area scale,
# log aspect and its corner's two uniforms; the flip's uniform; whether to
# jitter; the four jitter factors (hue as the rotation's fraction of a
# turn); the grayscale's uniform
CIFAR_DRAWS = ("area", "log_ratio", "i", "j", "flip", "jitter", "brightness", "contrast",
               "saturation", "hue", "gray")


@dataclass
class CifarPairDraws:
    """values: (B, 2, 11), per image, per view, the CIFAR_DRAWS values."""
    values: torch.Tensor


def draw_cifar_pair_views(gen: torch.Generator, batch_size: int,
                          device=None) -> CifarPairDraws:
    """The random numbers of cifar_pair_views for `batch_size` images, from
    `gen` (a generator on `device`), as JAX draws them: uniforms over each
    value's range."""
    b, c, s, h = JITTER
    ranges = {"area": SCALE, "log_ratio": (math.log(RATIO[0]), math.log(RATIO[1])),
              "brightness": (1 - b, 1 + b), "contrast": (1 - c, 1 + c),
              "saturation": (1 - s, 1 + s), "hue": (-h, h)}
    lo, hi = (torch.tensor([ranges.get(n, (0.0, 1.0))[k] for n in CIFAR_DRAWS], device=device)
              for k in (0, 1))
    u = torch.rand(batch_size, 2, len(CIFAR_DRAWS), generator=gen, device=device)
    return CifarPairDraws(lo + u * (hi - lo))


@contextlib.contextmanager
def _fp32_products():
    """cuBLAS and cuDNN in full fp32 (no TF32) inside."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with no_tf32():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _linear_matrix(out_size: int, in_size: int, start: torch.Tensor,
                   extent: torch.Tensor) -> torch.Tensor:
    """(B, out, in) bilinear-resample matrices over [start, start + extent)
    per image (start, extent: (B,)), torchvision's align_corners=False
    mapping."""
    u = torch.arange(out_size, dtype=torch.float32, device=start.device)
    scale = extent[:, None] / out_size
    src = start[:, None] + (u + 0.5) * scale - 0.5
    src = src.clamp(0.0, in_size - 1.0)
    s0 = torch.floor(src)
    t = src - s0
    taps = torch.stack([s0, (s0 + 1).clamp(0, in_size - 1)], dim=-1).long()
    w = torch.stack([1.0 - t, t], dim=-1)
    onehot = torch.nn.functional.one_hot(taps, in_size).to(w.dtype)     # (B, out, 2, in)
    return (w[..., None] * onehot).sum(dim=-2)


def _random_resized_crop(imgs: torch.Tensor, area_scale, log_ratio, ui, uj) -> torch.Tensor:
    """(B, H, W, C) -> (B, SIZE, SIZE, C): torchvision RandomResizedCrop's
    area scale and log-uniform aspect, h and w rounded and clipped, the
    corner floor(u * (H - h + 1))."""
    _, H, W, _ = imgs.shape
    target_area = (H * W) * area_scale
    aspect = torch.exp(log_ratio)
    w = torch.round(torch.sqrt(target_area * aspect)).clamp(1, W)
    h = torch.round(torch.sqrt(target_area / aspect)).clamp(1, H)
    i = torch.floor(ui * (H - h + 1.0))
    j = torch.floor(uj * (W - w + 1.0))
    My = _linear_matrix(SIZE, H, i, h)
    Mx = _linear_matrix(SIZE, W, j, w)
    return torch.einsum("byh,bhwc,bxw->byxc", My, imgs, Mx)


def _rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    return torch.stack([y, y, y], dim=-1)


def _color_jitter(img: torch.Tensor, brightness, contrast, saturation, hue) -> torch.Tensor:
    """(B, H, W, 3) with per-image factors (B,): brightness, contrast,
    saturation, then the hue rotation of the chroma in YIQ space, in this
    fixed order."""
    def per_image(f):
        return f[:, None, None, None]

    img = img * per_image(brightness)
    mean = _rgb_to_gray(img)[..., :1].mean(dim=(1, 2, 3))
    img = (img - per_image(mean)) * per_image(contrast) + per_image(mean)
    gray = _rgb_to_gray(img)
    img = gray + (img - gray) * per_image(saturation)
    theta = hue * 2 * math.pi
    y = _rgb_to_gray(img)[..., 0]
    i = 0.596 * img[..., 0] - 0.274 * img[..., 1] - 0.322 * img[..., 2]
    q = 0.211 * img[..., 0] - 0.523 * img[..., 1] + 0.312 * img[..., 2]
    c, s = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    i2, q2 = c * i - s * q, s * i + c * q
    r = y + 0.956 * i2 + 0.621 * q2
    g = y - 0.272 * i2 - 0.647 * q2
    b = y - 1.106 * i2 + 1.703 * q2
    return torch.stack([r, g, b], dim=-1)


def _normalise_nchw(v: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(CIFAR_MEAN, device=v.device)
    std = torch.tensor(CIFAR_STD, device=v.device)
    return ((v - mean) / std).permute(0, 3, 1, 2).contiguous()


def _one_view(imgs: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] and (B, 11) draws -> the normalised view (B, 3,
    SIZE, SIZE)."""
    col = {name: d[:, k] for k, name in enumerate(CIFAR_DRAWS)}
    v = _random_resized_crop(imgs, col["area"], col["log_ratio"], col["i"], col["j"])

    def where(u, p, a, b):
        return torch.where((u < p)[:, None, None, None], a, b)

    v = where(col["flip"], P_FLIP, v.flip(2), v)
    v = where(col["jitter"], P_JITTER, _color_jitter(v, col["brightness"], col["contrast"],
                                                      col["saturation"], col["hue"]), v)
    v = where(col["gray"], P_GRAY, _rgb_to_gray(v), v)
    return _normalise_nchw(v.clamp(0.0, 1.0))


def apply_cifar_pair_views(images_u8: torch.Tensor,
                           draws: CifarPairDraws) -> list[torch.Tensor]:
    """(B, 32, 32, 3) uint8 images and their draws -> [view 1, view 2], each
    (B, 3, 32, 32) fp32 on the images' device."""
    imgs = images_u8.to(torch.float32) / 255.0
    with _fp32_products():
        return [_one_view(imgs, draws.values[:, k]) for k in range(2)]


def cifar_pair_views(gen: torch.Generator, images_u8: torch.Tensor) -> list[torch.Tensor]:
    """Draw from `gen` and apply, in one call."""
    draws = draw_cifar_pair_views(gen, images_u8.shape[0], images_u8.device)
    return apply_cifar_pair_views(images_u8, draws)


def cifar_eval_batch(images_u8: torch.Tensor) -> torch.Tensor:
    """(B, 32, 32, 3) uint8 -> normalised (B, 3, 32, 32) fp32, no
    augmentation (the kNN monitor's input)."""
    return _normalise_nchw(images_u8.to(torch.float32) / 255.0)
