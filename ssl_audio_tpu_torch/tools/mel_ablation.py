"""Where the log-mel kernel's time goes: its time on the card at the paths'
shapes as it is, and with parts of its source removed -- two of its three
TF32 passes ("one_pass"), or the mel product's inner loop ("no_mel").  Each
variant is built by nvcc from an edited copy of csrc/log_mel.cu under
build/kernels/ablation/ and swapped in for the kernel's library; the
variants compute wrong log-mels and only their times mean anything.

    python3 -m ssl_audio_tpu_torch.tools.mel_ablation

One JSON line per variant: ms per launch (the best of three CUDA-event means
of 20 launches) for one HEAR chunk (512 x 15,200 samples), folded and
unfolded, a scene request's clips (16 x 160,000), and the training crop (128
x 160,000 samples -> 96 frames), folded and unfolded.
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from ssl_audio_tpu_torch.tools.serving import cuda_ms, seeded_clips, smi_line

_PASSES = ["  mma_tf32(d, al, __float_as_uint(b.x), __float_as_uint(b.y));\n",
           "  mma_tf32(d, ah, __float_as_uint(b.z), __float_as_uint(b.w));\n"]
_MEL = ["      for (int f = lo; f < hi; ++f) sum = fmaf(prow[f], wm[f], sum);\n"]
VARIANTS = {"full": [], "one_pass": _PASSES, "no_mel": _MEL}


def build_variant(name: str) -> ctypes.CDLL:
    """The kernel's library built from its source without VARIANTS[name]."""
    from ssl_audio_tpu_torch.ops import _build
    from ssl_audio_tpu_torch.ops.mel_kernel import _SIGNATURES

    src = (_build.CSRC / "log_mel.cu").read_text()
    for line in VARIANTS[name]:
        if src.count(line) != 1:
            raise SystemExit(f"variant {name}: the source no longer has {line.strip()!r}")
        src = src.replace(line, "")
    out = _build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(src)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
                    str(out / f"{name}.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / f"{name}.so"))
    for entry, argtypes in _SIGNATURES.items():
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the ablation is a device measurement")
    from ssl_audio_tpu_torch.ops import _build
    from ssl_audio_tpu_torch.ops.mel import MelSpec
    from ssl_audio_tpu_torch.ops.mel_kernel import log_mel_cuda

    smi = smi_line()
    gen = torch.Generator().manual_seed(0)
    chunk = seeded_clips(gen, 512, 15200).to("cuda")
    clips = seeded_clips(gen, 128, 160000).to("cuda")
    scene = clips[:16].contiguous()
    starts = torch.randint(0, 905, (128,), generator=gen, dtype=torch.int32).to("cuda")
    hear, train = MelSpec(win_length=400), MelSpec(win_length=1024)
    shapes = {"chunk_folded": lambda: log_mel_cuda(chunk, hear, None),
              "chunk_unfolded": lambda: log_mel_cuda(chunk, hear, False),
              "scene_folded": lambda: log_mel_cuda(scene, hear, None),
              "cropped_folded": lambda: log_mel_cuda(clips, train, None, starts, 96),
              "cropped_unfolded": lambda: log_mel_cuda(clips, train, False, starts, 96)}
    for name in VARIANTS:
        _build._libs["log_mel.cu"] = build_variant(name)
        print(json.dumps({"variant": name, "card": smi, **{
            shape: min(cuda_ms(fn) for _ in range(3)) for shape, fn in shapes.items()}}))
    _build._libs.pop("log_mel.cu")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
