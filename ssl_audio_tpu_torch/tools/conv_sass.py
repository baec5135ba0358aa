"""Instruction counts of the fused conv kernels' channel loops, from the SASS
of the libraries the port builds (cuobjdump from the CUDA toolkit beside
nvcc): what the card issues per channel and group of cells.

    python3 -m ssl_audio_tpu_torch.tools.conv_sass

For each kernel of csrc/fused_conv_fwd.cu and fused_conv_bwd.cu, prints one
JSON line with its instruction count and, for its largest loop (the walk
over the channels; found as the longest backward branch), the loop's
instructions and the counts of its most frequent opcodes.
"""
from __future__ import annotations

import collections
import json
import re
import subprocess
from pathlib import Path

_INSTR = re.compile(r"\s+/\*([0-9a-f]{4,5})\*/\s+(.*?);")
_BRANCH = re.compile(r"BRA .*?(0x[0-9a-f]+)")


def opcode(text: str) -> str:
    """The opcode of one SASS instruction, without predicate and modifiers."""
    return re.sub(r"^@!?U?P\w+\s+", "", text).split()[0].split(".")[0]


def loops(sass: str) -> dict[str, dict]:
    """Per function: its instruction count and its longest loop's opcodes."""
    out = {}
    for body in re.split(r"\n\s+Function : ", sass)[1:]:
        name = body.split("\n")[0].strip()
        instrs = [(int(m.group(1), 16), m.group(2).strip())
                  for m in map(_INSTR.match, body.split("\n")) if m]
        best = []
        for addr, text in instrs:
            b = _BRANCH.search(text)
            if b and int(b.group(1), 16) < addr:
                lo = int(b.group(1), 16)
                loop = [t for a, t in instrs if lo <= a <= addr]
                if len(loop) > len(best):
                    best = loop
        ops = collections.Counter(opcode(t) for t in best)
        out[name] = {"instructions": len(instrs), "loop_instructions": len(best),
                     "loop_opcodes": dict(ops.most_common(12))}
    return out


def main() -> int:
    from ssl_audio_tpu_torch.ops import _build

    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    for source in ("fused_conv_fwd.cu", "fused_conv_bwd.cu"):
        lib = _build._compile(source)
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
        for name, row in loops(sass).items():
            print(json.dumps({"source": source, "function": name, **row}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
