"""Ops of the port: the log-mel frontend (mel.py, kernel in mel_kernel.py),
the fused first conv block (fused_conv.py) and the kernel builder
(_build.py)."""
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
