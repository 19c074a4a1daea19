"""Write ``neural_enhanced_super_resolution_torch/csrc/wgmma.cuh``.

    python3 tools/gen_wgmma_header.py

The header holds inline-PTX wrappers of
``wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16``, one per form and
output width N. N is an immediate of the instruction and every one of the
N/2 fp32 accumulators a thread holds is an operand of its own, so each
width is written out; this script is the one place that spells them.

Forms (B is always read from shared memory through a matrix descriptor):

* ``wgmma_rs<N>``: A from registers, B K-major. K1's tile widths
  (``kernels/conv3x3.py:TILE_WIDTHS``).
* ``wgmma_rs_tb<N>``: A from registers, B transposed (MN-major: N
  contiguous), as K3 reads V for P V. K3's narrow head dims.
* ``wgmma_ss<N>``: A and B from shared memory, B K-major, as K3 computes
  S = Q K^T. K3's key tiles.
* ``wgmma_ss_tb<N>``: A and B from shared memory, B transposed, as K3's
  wide form computes P V on a 128-column slice.
* ``wgmma_rs_s8<N>``: ``m64nNk32.s32.s8.s8``, A (int8) from registers,
  B (int8) K-major, int32 accumulators; K4's tile widths. The 8-bit form
  takes no scale or transpose immediates, and its A fragment fills the
  same four registers as the bf16 k16 one (PTX ISA: 32 bytes a row).

Re-run after changing a width list.
"""

from __future__ import annotations

import os

FORMS = {  # name: (A in registers, B transposed, widths)
    "wgmma_rs": (True, False, (8, 16, 32, 64, 80, 96, 128)),
    "wgmma_rs_tb": (True, True, (16, 32, 64, 128)),
    "wgmma_ss": (False, False, (64,)),
    "wgmma_ss_tb": (False, True, (128,)),
}
# The int8 form: (widths); A from registers, B K-major, s32 accumulators.
S8_WIDTHS = (8, 16, 32, 64, 80, 96, 128)
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "neural_enhanced_super_resolution_torch", "csrc",
    "wgmma.cuh")


def _wrapper(name: str, rs: bool, tb: bool, n: int) -> str:
    regs = n // 2
    d = ", ".join(f"%{i}" for i in range(regs))
    outs = ",\n        ".join(
        ", ".join(f'"+f"(d[{i}])' for i in range(j, min(j + 8, regs)))
        for j in range(0, regs, 8))
    if rs:
        a_decl = "const uint32_t (&a)[4]"
        a_ops = "{" + ", ".join(f"%{regs + i}" for i in range(4)) + "}"
        a_ins = '"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3])'
        nxt = regs + 4
        imms = f"1, 1, {int(tb)}"          # scale-a, scale-b, trans-b
    else:
        a_decl = "uint64_t a_desc"
        a_ops = f"%{regs}"
        a_ins = '"l"(a_desc)'
        nxt = regs + 1
        imms = f"1, 1, 0, {int(tb)}"       # scale-a, scale-b, trans-a, -b
    return f"""
template <>
__device__ __forceinline__ void {name}<{n}>(float (&d)[{regs}],
    {a_decl}, uint64_t b_desc, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{nxt + 1}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{d}}}, {a_ops}, %{nxt}, p, {imms};\\n}}\\n"
      : {outs}
      : {a_ins}, "l"(b_desc), "r"(scale_d));
}}
"""


def _wrapper_s8(n: int) -> str:
    regs = n // 2
    d = ", ".join(f"%{i}" for i in range(regs))
    outs = ",\n        ".join(
        ", ".join(f'"+r"(d[{i}])' for i in range(j, min(j + 8, regs)))
        for j in range(0, regs, 8))
    a_ops = "{" + ", ".join(f"%{regs + i}" for i in range(4)) + "}"
    return f"""
template <>
__device__ __forceinline__ void wgmma_rs_s8<{n}>(int (&d)[{regs}],
    const uint32_t (&a)[4], uint64_t b_desc, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 "
      "{{{d}}}, {a_ops}, %{regs + 4}, p;\\n}}\\n"
      : {outs}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(scale_d));
}}
"""


def main() -> None:
    decls, bodies = [], []
    for name, (rs, tb, widths) in FORMS.items():
        a_decl = "const uint32_t (&a)[4]" if rs else "uint64_t a_desc"
        decls.append(f"""
// widths {widths}
template <int N>
__device__ void {name}(float (&d)[N / 2], {a_decl},
                       uint64_t b_desc, int scale_d = 1);""")
        bodies += [_wrapper(name, rs, tb, n) for n in widths]
    decls.append(f"""
// widths {S8_WIDTHS}
template <int N>
__device__ void wgmma_rs_s8(int (&d)[N / 2], const uint32_t (&a)[4],
                            uint64_t b_desc, int scale_d = 1);""")
    bodies += [_wrapper_s8(n) for n in S8_WIDTHS]
    text = f"""\
// Generated by tools/gen_wgmma_header.py; edit that script, not this file.
//
// d (64 x N fp32, N/2 a thread) = (scale_d ? d : 0) + A (64 x 16 bf16) *
// B (16 x N bf16). A from registers (_rs: this warp's 16 rows as an m16k16
// ldmatrix fragment) or from shared memory (_ss: a K-major descriptor);
// B from shared memory by descriptor, K-major, or transposed (_tb: N
// contiguous). _rs_s8: d (64 x N int32) += A (64 x 32 int8) * B (32 x N
// int8), A from registers, B K-major. Asynchronous: fence before, commit
// and wait after (common.cuh).
#pragma once

#include <stdint.h>

namespace nesr {{
{"".join(decls)}
{"".join(bodies)}
}}  // namespace nesr
"""
    with open(OUT, "w") as f:
        f.write(text)


if __name__ == "__main__":
    main()
