"""Device and host times of the fused attention kernels of whichever
ssl_audio_tpu_torch package is first on the path, by this checkout's
timers: an A/B of two checkouts in one process each, in turns.

    PYTHONPATH=<root> python3 <this checkout>/ssl_audio_tpu_torch/tools/attention_ab.py \
        [--label parent] [--seed 0]

At the ViT-B step's shapes, qkv (128, 25, 2304) and the token-drop
teacher's (128, 7, 2304), 12 heads: fused_attention_{fwd,bwd}_cuda timed by
device_ms (warm, and with the L2 flushed between launches) and host_ms,
and by the older cuda_ms, all from this file's sibling tools/serving.py
loaded by path (so an older checkout's kernels are timed by the same
code), and the timer's floor (device_ms of a one-element fill).  Prints one
JSON line with the package's path and the times.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
from pathlib import Path

import torch


def _timers():
    spec = importlib.util.spec_from_file_location(
        "_attention_ab_timers", Path(__file__).resolve().with_name("serving.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_ab: needs a CUDA device")
    import ssl_audio_tpu_torch
    from ssl_audio_tpu_torch.ops import fused_attention as fa

    t = _timers()
    gen = torch.Generator().manual_seed(args.seed)
    B, H, C = 128, 12, 768
    row = {"label": args.label, "package": str(Path(ssl_audio_tpu_torch.__file__).parent),
           "card": t.smi_line()}
    # the timer's floor: one launch of a one-element fill between its events
    one = torch.zeros(1, device="cuda")
    row["floor_ms"] = t.device_ms(one.zero_)
    for N in (25, 7):
        qkv = torch.randn(B, N, 3 * C, generator=gen).cuda()
        bias = torch.zeros(B, N).cuda()
        dout = torch.randn(B, N, C, generator=gen).cuda()
        for kind, fn in (("fwd", lambda: fa.fused_attention_fwd_cuda(qkv, bias, H)),
                         ("bwd", lambda: fa.fused_attention_bwd_cuda(qkv, bias, dout, H))):
            row[f"N={N} {kind}"] = {"ms_cold": t.device_ms(fn, cold=True),
                                    "ms_warm": t.device_ms(fn),
                                    "host_ms": t.host_ms(fn),
                                    "cuda_events_ms": t.cuda_ms(fn)}
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
