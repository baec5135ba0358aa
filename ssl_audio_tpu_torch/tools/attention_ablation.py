"""Where the fused attention kernels' time goes: their device time at the
ViT-B step's shapes as they are, and with parts of the source cut out --
the zeroing of the tiles' padding ("no_padding"), the staging of q, k, v
and dO ("no_staging"), the FMA sums of the scores and dP ("no_score_fma"),
the per-warp work ("no_compute"), or all of it ("empty": launch, barriers,
the bias row and, in the backward, the dK and dV stores).  Each variant is built by
nvcc from an edited copy of csrc/fused_attention.cu under
build/kernels/ablation/ and swapped in for the kernels' library; the cut
variants compute wrong results and only their times mean anything.

    python3 -m ssl_audio_tpu_torch.tools.attention_ablation [--heads_per_block G ...]

One JSON line per variant: device ms per launch (tools/serving.py
device_ms, warm) of the forward and backward at qkv (128, 25, 2304) and
(128, 7, 2304), with plan()'s heads per block and with each G given.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from ssl_audio_tpu_torch.tools.serving import device_ms, smi_line

_RETURN_AT = {
    "padding": ["__device__ __forceinline__ void zero_rows("],
    "staging": ["__device__ __forceinline__ void copy_chunks(",
                "__device__ __forceinline__ void convert_chunks("],
    "compute": ["__device__ __forceinline__ void softmax_tile(",
                "__device__ __forceinline__ void ds_tile(",
                "__device__ __forceinline__ void rows_times(",
                "__device__ __forceinline__ void bwd_keys("],
    "scores": ["__device__ __forceinline__ void fma_block_t("],
}
VARIANTS = {"full": [], "no_padding": ["padding"], "no_staging": ["staging"],
            "no_score_fma": ["scores"], "no_compute": ["compute"],
            "empty": ["padding", "staging", "compute"]}


def _cut(src: str, opening: str) -> str:
    """Return at once from the function whose definition starts with
    `opening` (its body's first line follows the first "{\\n" after it)."""
    if src.count(opening) != 1:
        raise SystemExit(f"the source no longer has {opening.strip()!r} once")
    at = src.index("{\n", src.index(opening)) + 2
    return src[:at] + "  return;\n" + src[at:]


def build_variant(name: str) -> ctypes.CDLL:
    from ssl_audio_tpu_torch.ops import _build
    from ssl_audio_tpu_torch.ops.fused_attention import _SIGNATURES

    src = (_build.CSRC / "fused_attention.cu").read_text()
    for part in VARIANTS[name]:
        for opening in _RETURN_AT[part]:
            src = _cut(src, opening)
    out = _build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"attention_{name}.cu").write_text(src)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                    str(out / f"attention_{name}.so"), str(out / f"attention_{name}.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / f"attention_{name}.so"))
    for entry, argtypes in _SIGNATURES.items():
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--heads_per_block", type=int, nargs="*", default=[4])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the ablation is a device measurement")
    from ssl_audio_tpu_torch.ops import _build
    from ssl_audio_tpu_torch.ops import fused_attention as fa

    smi = smi_line()
    gen = torch.Generator().manual_seed(0)
    B, H, hd = 128, 12, 64
    cases = {}
    for N in (25, 7):
        qkv = torch.randn(B, N, 3 * H * hd, generator=gen).cuda()
        bias = torch.zeros(B, N).cuda()
        dout = torch.randn(B, N, H * hd, generator=gen).cuda()
        for G in [None, *args.heads_per_block]:
            pf = fa.plan(B, N, H, hd, False) if G is None else fa.plan_for(B, N, H, hd, False, G)
            pb = fa.plan(B, N, H, hd, True) if G is None else fa.plan_for(B, N, H, hd, True, G)
            tag = f"N={N} G={pf.heads_per_block}/{pb.heads_per_block}"
            cases[f"{tag} fwd"] = (lambda q=qkv, b=bias, p=pf: fa._launch_fwd(q, b, H, p))
            cases[f"{tag} bwd"] = (lambda q=qkv, b=bias, d=dout, p=pb:
                                   fa._launch_bwd(q, b, d, H, p))
    for name in VARIANTS:
        _build._libs["fused_attention.cu"] = build_variant(name)
        print(json.dumps({"variant": name, "card": smi,
                          **{case: device_ms(fn) for case, fn in cases.items()}}))
    _build._libs.pop("fused_attention.cu")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
