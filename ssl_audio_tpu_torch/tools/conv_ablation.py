"""Where the fused conv kernels' time goes: their device time at the main
path's shapes as they are, and with parts of the source cut out -- the input
patch loads ("no_loads": load_patch, and the backward's pooled / dpooled
loads), the conv FMA chains ("no_fma": conv_at returns the bias plus one
input), the output stores of the forward ("no_stores"), the halving
exchanges of the warp reductions ("no_reduce"), the backward's
channel-free Gram and A2 sums ("no_taps"), or all of them ("empty": launch,
weights to shared memory, the channel loop's selects and epilogue, the
partial-sum stores and the reduction kernel).  Each variant is built by nvcc from
edited copies of csrc/fused_conv_fwd.cu, fused_conv_bwd.cu and
fused_conv_common.cuh under build/kernels/ablation/ and swapped in for the
kernels' libraries; the cut variants compute wrong results and only their
times mean anything.

    python3 -m ssl_audio_tpu_torch.tools.conv_ablation

One JSON line per variant: device ms per call (tools/serving.py device_ms,
warm, and cold for the full kernels) of the eval forward at one serving
chunk (512, 64, 96), the statistics forward and the backward at one view of
the training step (128, 64, 96).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from ssl_audio_tpu_torch.tools.conv_ab import conv_inputs
from ssl_audio_tpu_torch.tools.serving import device_ms, smi_line

# (file, opening of the function, what its body does instead).  A cut keeps
# the data its callers read defined and dependent on the thread (a constant
# would let the compiler fold the rest of the work away): the loads become
# values made from the group's cell count, the reductions a plain sum into
# the first value, the stores happen only for a value no output takes.
_CUTS = {
    "loads": [("fused_conv_common.cuh", "__device__ __forceinline__ void load_patch(",
               "for (int a = 0; a < 4; ++a)\n    for (int k = 0; k < PW; ++k) "
               "p[a][k] = 0.25f * (gr.n + a - k);\n  return;"),
              ("fused_conv_bwd.cu", "__device__ __forceinline__ void load_cells(",
               "for (int k = 0; k < CELLS; ++k) {\n    pl[k] = 0.5f * (n - k);\n"
               "    dl[k] = 0.25f * (k + 1);\n  }\n  return;")],
    "fma": [("fused_conv_common.cuh", "__device__ __forceinline__ float conv_at(",
             "return bias + p[r][col];")],
    "stores": [("fused_conv_fwd.cu", "__device__ __forceinline__ void store_cells(",
                "if (sel[0] != 1.5e-38f) return;")],
    "reduce": [("fused_conv_common.cuh", "__device__ __forceinline__ int warp_reduce_scatter(",
                "for (int i = 1; i < N; ++i) v[0] += v[i];\n  return 0;")],
    "taps": [("fused_conv_bwd.cu", "__device__ __forceinline__ void tap_sums(", "return;")],
}
VARIANTS = {"full": [], "no_loads": ["loads"], "no_fma": ["fma"], "no_stores": ["stores"],
            "no_reduce": ["reduce"], "no_taps": ["taps"],
            "empty": ["loads", "fma", "stores", "reduce", "taps"]}
FILES = ("fused_conv_common.cuh", "fused_conv_fwd.cu", "fused_conv_bwd.cu")


def _cut(src: str, opening: str, ret: str) -> str:
    """Return at once from the function whose definition starts with
    `opening` (its body's first line follows the first "{\\n" after it)."""
    if src.count(opening) != 1:
        raise SystemExit(f"the source no longer has {opening.strip()!r} once")
    at = src.index("{\n", src.index(opening)) + 2
    return src[:at] + f"  {ret}\n" + src[at:]


def build_variant(name: str) -> dict[str, ctypes.CDLL]:
    """The variant's libraries, keyed by the source names _build.load takes."""
    from ssl_audio_tpu_torch.ops import _build
    from ssl_audio_tpu_torch.ops.fused_conv import _BWD_SIGNATURES, _SIGNATURES

    srcs = {f: (_build.CSRC / f).read_text() for f in FILES}
    for part in VARIANTS[name]:
        for f, opening, ret in _CUTS[part]:
            srcs[f] = _cut(srcs[f], opening, ret)
    out = _build.BUILD_DIR / "ablation" / f"conv_{name}"
    out.mkdir(parents=True, exist_ok=True)
    for f, text in srcs.items():
        (out / f).write_text(text)
    libs = {}
    for f, sigs in (("fused_conv_fwd.cu", _SIGNATURES), ("fused_conv_bwd.cu", _BWD_SIGNATURES)):
        so = out / f.replace(".cu", ".so")
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(out / f)],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        for entry, argtypes in sigs.items():
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        libs[f] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the ablation is a device measurement")
    from ssl_audio_tpu_torch.ops import _build
    from ssl_audio_tpu_torch.ops import fused_conv as fc

    smi = smi_line()
    gen = torch.Generator().manual_seed(args.seed)
    x, wk, bias, gamma, beta = conv_inputs(gen, 512)
    stats = torch.stack([torch.zeros(64), torch.ones(64), torch.zeros(64)]).cuda()
    xt, wkt, biast, gammat, betat = conv_inputs(gen, 128)
    with torch.no_grad():
        pooled, mt, vt = fc.fused_conv1_bn_relu_pool(xt[..., None], wkt.reshape(3, 3, 1, 64),
                                                     biast, gammat, betat)
    rt = torch.rsqrt(vt + 1e-5)
    dp = torch.randn_like(pooled)
    cases = {"fwd_eval (512, 64, 96)": lambda: fc.fused_conv1_fwd_cuda(x, wk, bias, gamma, stats),
             "fwd_stats (128, 64, 96)": lambda: fc.fused_conv1_fwd_cuda(xt, wkt, biast, gammat),
             "bwd (128, 64, 96)": lambda: fc.fused_conv1_bwd_cuda(xt, wkt, biast, gammat, mt, rt,
                                                                  pooled, dp)}
    for name in VARIANTS:
        _build._libs.update(build_variant(name))
        row = {"variant": name, "card": smi,
               **{case: device_ms(fn) for case, fn in cases.items()}}
        if name == "full":
            row.update({f"{case} cold": device_ms(fn, cold=True) for case, fn in cases.items()})
        print(json.dumps(row), flush=True)
    for f in ("fused_conv_fwd.cu", "fused_conv_bwd.cu"):
        _build._libs.pop(f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
