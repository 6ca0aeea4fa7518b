// Warp-level tensor-core helpers shared by the decode bodies
// (decode_split.cuh: K1/K9 and K3's decode items) and the w4a16 products
// (int4mm.cu: K5/K6): mma.sync m16n8k16 with bf16 operands and f32
// accumulators, and ldmatrix. Fragment layout of m16n8k16 (lane = 4 * gid
// + tig): A (16 x 16, row-major) a0 = (row gid, k 2tig..2tig+1), a1 = (row
// gid + 8, same k), a2 = (row gid, k 2tig+8..+9), a3 = (row gid + 8, same);
// B (16 x 8) b0 = (k 2tig..2tig+1, column gid), b1 = (k 2tig+8..+9, same);
// D (16 x 8, f32) d0, d1 = (row gid, columns 2tig, 2tig+1), d2, d3 = (row
// gid + 8, same). A register holds two bf16, the lower k in its low half.
#pragma once

#include <stdint.h>

namespace rt {

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

}  // namespace rt
