"""FLOPs and parameter counts of an encoder (port of
ssl_audio_tpu/utils/flops.py; the reference's utils/flops.py wraps the
deepspeed profiler, JAX's reads XLA's cost analysis).

    python -m ssl_audio_tpu_torch.utils.flops --model_type vit_base

The count is taken from the module's structure, never from what ran:
2 x the multiply-adds of every Conv2d and Linear at the shapes one forward
gives them, plus a ViT's two attention products per block (2 N^2 C
multiply-adds for N tokens of width C).  torch.utils.flop_counter would see
neither the convolution inside the fused block's autograd Function nor the
products inside the attention kernel, so the forward that is measured is
the plain one (fused block and fused attention off, on the `meta` device:
shapes only, no arithmetic), and the count is the same on the CPU and on
the card whichever path a run takes.  Elementwise work, normalisation and
pooling are not counted, so the number is below XLA's for the same model.
"""
from __future__ import annotations

from typing import Iterable

import torch
from torch import nn


def count_params(params) -> int:
    """Elements of a module's parameters, or of an iterable / dict of
    tensors (JAX: of the params tree)."""
    if isinstance(params, nn.Module):
        params = params.parameters()
    elif isinstance(params, dict):
        params = params.values()
    return sum(p.numel() for p in params)


def forward_macs(model: nn.Module, x: torch.Tensor, **kwargs) -> int:
    """Multiply-adds of one forward of `model` on x: every Conv2d and Linear
    from its output's shape, and each ViT block's two attention products
    from the tokens it is handed."""
    macs = []

    def conv(mod, inp, out):
        macs.append(out.numel() * (mod.in_channels // mod.groups) * mod.weight[0, 0].numel())

    def linear(mod, inp, out):
        macs.append(out.numel() * mod.in_features)

    def attention(mod, inp, out):
        B, N, C = inp[0].shape
        macs.append(2 * B * N * N * C)

    hooks = [m.register_forward_hook(conv if isinstance(m, nn.Conv2d) else linear)
             for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear))]
    hooks += [blk.register_forward_hook(attention) for blk in getattr(model, "blocks", [])]
    try:
        with torch.no_grad():
            model(x, **kwargs)
    finally:
        for h in hooks:
            h.remove()
    return sum(macs)


def model_flops(cfg, batch_size: int = 2, train: bool = False) -> dict:
    """FLOPs and parameters of one encoder forward on a (B, 1, n_mels,
    crop_frames) batch ((B, 3, 32, 32) for cifar10), as JAX's model_flops
    reports them; train runs the forward in train mode (batch statistics,
    the same products)."""
    from ssl_audio_tpu_torch.train.state import build_encoder

    with torch.device("meta"):                 # shapes only: nothing allocated or drawn
        enc, dim = build_encoder(cfg.replace(fused_conv=False, pool_reorder=False,
                                             fused_attention=False, remat=False))
    enc = enc.to("meta").train(train)          # the tables made from numpy too
    shape = (3, 32, 32) if cfg.dataset == "cifar10" else (1, cfg.n_mels, cfg.crop_frames)
    flops = 2.0 * forward_macs(enc, torch.zeros(batch_size, *shape, device="meta"))
    return {"model_type": cfg.model_type, "params": count_params(enc),
            "flops_per_batch": flops, "flops_per_sample": flops / batch_size,
            "embed_dim": dim}


def main(argv=None):
    from ssl_audio_tpu_torch.config import config_from_args

    cfg = config_from_args(argv)
    info = model_flops(cfg)
    gf = info["flops_per_sample"] / 1e9
    print(f"{info['model_type']}: params={info['params']/1e6:.2f}M "
          f"flops/sample={gf:.3f} GFLOPs embed_dim={info['embed_dim']}")
    return info


if __name__ == "__main__":
    main()
