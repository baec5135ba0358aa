"""Ops of the port: the log-mel frontend (mel.py, kernel in mel_kernel.py),
the fused first conv block, forward and backward (fused_conv.py), the fused
ViT attention, forward and backward (fused_attention.py), the fixed
position tables (pos_embed.py), and the nvcc build and ctypes binding of the
kernels (_build.py).  Each kernel wrapper counts its launches, the fp32 and
the bf16 instantiations apart (`launches`, `launches_bf16`; the log-mel
kernel is fp32 only); launch_counts() reads every counter, the bf16 ones
under "<name>_bf16", and zero_launch_counts() resets them.  A CUDA graph's
capture runs the wrappers but no kernel: train/steps.py takes the counts its
capture saw back off (set_launch_counts) and adds them at every replay
(add_launch_counts)."""
from __future__ import annotations

import torch


def no_tf32():
    """Context in which cuDNN convolutions run in full fp32.  cuDNN takes
    fp32 convolutions through TF32 by default (about three decimal digits),
    which the fp32 HEAR embedding contract does not allow; the other cuDNN
    flags keep their current values."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def _counted():
    from ssl_audio_tpu_torch.ops import fused_attention, fused_conv

    return {"fused_conv1_fwd": fused_conv.fused_conv1_fwd_cuda,
            "fused_conv1_bwd": fused_conv.fused_conv1_bwd_cuda,
            "fused_conv1_dx": fused_conv.fused_conv1_dx_cuda,
            "fused_attention_fwd": fused_attention.fused_attention_fwd_cuda,
            "fused_attention_bwd": fused_attention.fused_attention_bwd_cuda}


def launch_counts() -> dict[str, int]:
    """Every kernel instantiation's launch counter."""
    from ssl_audio_tpu_torch.ops.mel_kernel import log_mel_cuda

    counted = _counted()
    return {"log_mel_folded": log_mel_cuda.launches["folded"],
            "log_mel_unfolded": log_mel_cuda.launches["unfolded"],
            **{name: wrapper.launches for name, wrapper in counted.items()},
            **{f"{name}_bf16": wrapper.launches_bf16 for name, wrapper in counted.items()}}


def set_launch_counts(counts: dict[str, int]) -> None:
    """Every counter to its value in `counts` (launch_counts()'s keys)."""
    from ssl_audio_tpu_torch.ops.mel_kernel import log_mel_cuda

    for key in log_mel_cuda.launches:
        log_mel_cuda.launches[key] = counts[f"log_mel_{key}"]
    for name, wrapper in _counted().items():
        wrapper.launches = counts[name]
        wrapper.launches_bf16 = counts[f"{name}_bf16"]


def add_launch_counts(delta: dict[str, int]) -> None:
    now = launch_counts()
    set_launch_counts({k: now[k] + delta[k] for k in now})


def zero_launch_counts() -> None:
    set_launch_counts(dict.fromkeys(launch_counts(), 0))
