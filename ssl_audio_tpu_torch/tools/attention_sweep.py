"""Device times of the fused attention kernels for every number of heads per
block, at the ViT-B step's shapes, on the card.

    python3 -m ssl_audio_tpu_torch.tools.attention_sweep [--seed 0] [--batch 128]

For qkv (B, 25, 2304) and the token-drop teacher's (B, 7, 2304), 12 heads
of 64: for each divisor G of 12 whose blocks fit, the forward and backward
kernels launched with G heads per block (ops/fused_attention.py plan_for),
held against the plain versions, and timed by tools/serving.py device_ms,
warm and with the
L2 flushed between launches (cold).  One JSON line per (shape, G) and a
last line with plan()'s choice for each shape beside the fastest G.
"""
from __future__ import annotations

import argparse
import json

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_sweep: needs a CUDA device")
    from ssl_audio_tpu_torch.ops import fused_attention as fa
    from ssl_audio_tpu_torch.tools.serving import device_ms, smi_line

    print(smi_line())
    gen = torch.Generator().manual_seed(args.seed)
    B, H, hd = args.batch, 12, 64
    C = H * hd
    best = {}
    for N in (25, 7):
        qkv = torch.randn(B, N, 3 * C, generator=gen).cuda()
        bias = torch.zeros(B, N).cuda()
        dout = torch.randn(B, N, C, generator=gen).cuda()
        out_p = fa.fused_attention_fwd_plain(qkv, bias, H)
        dqkv_p, _ = fa.fused_attention_bwd_plain(qkv, bias, dout, H)
        for G in (g for g in range(1, H + 1) if H % g == 0):
            try:
                pf = fa.plan_for(B, N, H, hd, False, G)
                pb = fa.plan_for(B, N, H, hd, True, G)
            except ValueError as e:             # G heads do not fit a block
                print(json.dumps({"N": N, "G": G, "skipped": str(e)}))
                continue
            err_f = float((fa._launch_fwd(qkv, bias, H, pf) - out_p).abs().max())
            err_b = float((fa._launch_bwd(qkv, bias, dout, H, pb)[0] - dqkv_p).abs().max())
            row = {"N": N, "G": G, "fwd_smem": pf.smem, "bwd_smem": pb.smem,
                   "warps": [pf.warps, pb.warps], "fwd_max_abs_err": err_f,
                   "bwd_max_abs_err": err_b}
            for kind, fn in (("fwd", lambda: fa._launch_fwd(qkv, bias, H, pf)),
                             ("bwd", lambda: fa._launch_bwd(qkv, bias, dout, H, pb))):
                row[f"{kind}_ms_warm"] = device_ms(fn)
                row[f"{kind}_ms_cold"] = device_ms(fn, cold=True)
                key = (N, kind)
                if key not in best or row[f"{kind}_ms_cold"] < best[key][1]:
                    best[key] = (G, row[f"{kind}_ms_cold"])
            print(json.dumps(row))
    print(json.dumps({"fastest_cold": {f"N={n} {k}": g for (n, k), g in best.items()},
                      "plan": {f"N={n} {k}": fa.plan(B, n, H, hd, k == "bwd").heads_per_block
                               for (n, k) in best}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
