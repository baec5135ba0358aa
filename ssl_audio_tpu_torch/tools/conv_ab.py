"""Device times of the fused conv kernels of whichever ssl_audio_tpu_torch
package is first on the path, by this checkout's timers: an A/B of two
checkouts in one process each, in turns.

    PYTHONPATH=<root> python3 <this checkout>/ssl_audio_tpu_torch/tools/conv_ab.py \
        [--label parent] [--seed 0]

Times, by device_ms (warm, and with the L2 flushed between launches) and
the older cuda_ms, all from this file's sibling tools/serving.py loaded by
path (so an older checkout's kernels are timed by the same code):
  fwd_eval    the eval forward at one serving chunk, x (512, 64, 96);
  fwd_stats   the statistics-mode forward at one view of the training step,
              x (128, 64, 96);
  bwd         the backward's reductions at the same view;
  dx          the dx kernel at the same view;
and, from one torch.profiler trace of each call, the device time of every
kernel it launches (the per-launch split).  The inputs are seeded and
quantised to 0.5 so windows tie; pooled and its cotangent are handed over
in the layout the checkout's forward writes.  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
from pathlib import Path

import torch


def _timers():
    spec = importlib.util.spec_from_file_location(
        "_conv_ab_timers", Path(__file__).resolve().with_name("serving.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def conv_inputs(gen: torch.Generator, B: int, H: int = 64, W: int = 96, C: int = 64):
    """Seeded x (quantised to 0.5), wk, bias, gamma (a quarter negative, one
    0), beta on the card."""
    x = torch.round(torch.randn(B, H, W, generator=gen) * 2) / 2
    wk = 0.3 * torch.randn(9, C, generator=gen)
    bias = 0.1 * torch.randn(C, generator=gen)
    gamma = 1.0 + 0.3 * torch.randn(C, generator=gen)
    gamma[: C // 4] *= -1.0
    gamma[C // 2] = 0.0
    beta = 0.2 * torch.randn(C, generator=gen)
    return [t.cuda() for t in (x, wk, bias, gamma, beta)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_ab: needs a CUDA device")
    import ssl_audio_tpu_torch
    from ssl_audio_tpu_torch.ops import fused_conv as fc

    t = _timers()
    gen = torch.Generator().manual_seed(args.seed)
    row = {"label": args.label, "package": str(Path(ssl_audio_tpu_torch.__file__).parent),
           "card": t.smi_line()}
    one = torch.zeros(1, device="cuda")
    row["floor_ms"] = t.device_ms(one.zero_)

    x, wk, bias, gamma, beta = conv_inputs(gen, 512)
    mean = (0.5 * torch.randn(64, generator=gen)).cuda()
    r = torch.rsqrt((0.5 + torch.rand(64, generator=gen)).cuda() + 1e-5)
    stats = torch.stack([mean, r, beta]).contiguous()
    cases = {"fwd_eval": lambda: fc.fused_conv1_fwd_cuda(x, wk, bias, gamma, stats)}

    xt, wkt, biast, gammat, betat = conv_inputs(gen, 128)
    with torch.no_grad():
        pooled, mt, vt = fc.fused_conv1_bn_relu_pool(xt[..., None], wkt.reshape(3, 3, 1, 64),
                                                     biast, gammat, betat)
    rt = torch.rsqrt(vt + 1e-5)
    # the cotangent in the layout of the forward's output, as the Function hands it over
    dp = torch.empty_like(pooled).copy_(torch.randn(pooled.shape, generator=gen).cuda())
    bwd_args = (xt, wkt, biast, gammat, mt, rt, pooled, dp)
    sums = fc.fused_conv1_bwd_cuda(*bwd_args)
    n = float(xt.numel())
    cases["fwd_stats"] = lambda: fc.fused_conv1_fwd_cuda(xt, wkt, biast, gammat)
    cases["bwd"] = lambda: fc.fused_conv1_bwd_cuda(*bwd_args)
    cases["dx"] = lambda: fc.fused_conv1_dx_cuda(*bwd_args, sums[0], sums[1], n)
    for name, fn in cases.items():
        row[name] = {"ms_cold": t.device_ms(fn, cold=True), "ms_warm": t.device_ms(fn),
                     "cuda_events_ms": t.cuda_ms(fn), "per_launch_ms": t.per_launch_ms(fn)}
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
