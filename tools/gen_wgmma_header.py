"""Write ``neural_enhanced_super_resolution_torch/csrc/wgmma_rs.cuh``.

    python3 tools/gen_wgmma_header.py

The header holds one inline-PTX wrapper per output width N of
``wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16`` with A in registers
and B read from shared memory through a matrix descriptor. N is an
immediate of the instruction and every one of the N/2 fp32 accumulators a
thread holds is an operand of its own, so each width is written out; this
script is the one place that spells them. WIDTHS are K1's tile widths
(``kernels/conv3x3.py:TILE_WIDTHS``); re-run after changing them.
"""

from __future__ import annotations

import os

WIDTHS = (8, 16, 32, 64, 80, 96, 128)
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "neural_enhanced_super_resolution_torch", "csrc",
    "wgmma_rs.cuh")


def _wrapper(n: int) -> str:
    regs = n // 2
    d = ", ".join(f"%{i}" for i in range(regs))
    a = ", ".join(f"%{regs + i}" for i in range(4))
    outs = ",\n        ".join(
        ", ".join(f'"+f"(d[{i}])' for i in range(j, min(j + 8, regs)))
        for j in range(0, regs, 8))
    return f"""
template <>
__device__ __forceinline__ void wgmma_rs<{n}>(float (&d)[{regs}],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{d}}}, {{{a}}}, %{regs + 4}, p, 1, 1, 0;\\n}}\\n"
      : {outs}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}}
"""


def main() -> None:
    body = "".join(_wrapper(n) for n in WIDTHS)
    text = f"""\
// Generated by tools/gen_wgmma_header.py; edit that script, not this file.
//
// wgmma_rs<N>(d, a, desc): d (64 x N fp32, N/2 a thread) += A (64 x 16
// bf16, this warp's 16 rows as an m16k16 ldmatrix fragment) * B (16 x N
// bf16, K-major, at the shared-memory descriptor desc). Asynchronous:
// fence before, commit and wait after (common.cuh). Widths: {WIDTHS}.
#pragma once

#include <stdint.h>

namespace nesr {{

template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t desc);
{body}
}}  // namespace nesr
"""
    with open(OUT, "w") as f:
        f.write(text)


if __name__ == "__main__":
    main()
