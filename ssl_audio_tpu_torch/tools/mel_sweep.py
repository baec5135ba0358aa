"""Where the log-mel kernel's time goes: its time on the card against the
number of DFT basis rows K it walks, for Hann windows of 200 to 1024
samples (folded and unfolded), at one 512-window chunk of the HEAR
timestamp path.

    python3 -m ssl_audio_tpu_torch.tools.mel_sweep

The slope over K is the cost of one step of the DFT loop for the whole
launch, the intercept the fixed part (staging, mel product, log, launch);
a jump where the shared memory a block needs stops two blocks fitting on an
SM shows the kernel's dependence on occupancy.
"""
from __future__ import annotations

import json

import torch

from ssl_audio_tpu_torch.tools.serving import cuda_ms, smi_line


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the sweep is a device measurement")
    from ssl_audio_tpu_torch.ops.mel import MelSpec
    from ssl_audio_tpu_torch.ops.mel_kernel import kernel_operands, log_mel_cuda

    smi = smi_line()
    gen = torch.Generator().manual_seed(0)
    wav = (0.3 * torch.randn(512, 15200, generator=gen)).to("cuda")
    for win in (200, 300, 400, 600, 800, 1024):
        for fold in (None, False):
            spec = MelSpec(win_length=win)
            ops = kernel_operands(spec, fold)
            print(json.dumps({
                "win_length": win, "fold": ops.fold, "K": ops.basis_c.shape[0],
                "smem_bytes": ops.smem_bytes(),
                "ms": cuda_ms(lambda: log_mel_cuda(wav, spec, fold=fold), iters=30),
                "card": smi}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
