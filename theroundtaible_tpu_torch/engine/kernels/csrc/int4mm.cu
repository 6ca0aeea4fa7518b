// K5 and K6: w4a16 decode products, the packed int4 weight dequantized in
// registers inside the product, so device memory streams the packed bytes.
//
// Replace the TPU kernels theroundtaible_tpu/engine/pallas/int4mm.py
// _mm_pack_out (kernel _mm_out_kernel) and _mm_pack_contract (kernel
// _mm_contract_kernel). The weight packs two signed nibbles per int8 byte
// along its last axis (byte k: element 2k in the low nibble, 2k+1 in the
// high one) with one scale in the activation dtype T per gp packed bytes.
// A weight value is T(nibble) * T(scale) rounded to T; products and sums
// are f32 (the JAX kernels' `low * srep` and preferred_element_type=f32).
//
// K5 (mm_pack_out): x [M, C] . unpack(q4 [C, P], s4 [C, P/gp]) ->
// out [M, 2P] f32 - every per-layer projection at decode (M <= 64). K6
// (mm_pack_contract): x [M, 2Cp] . unpack(q4 [N, Cp], s4 [N, Cp/gp])^T ->
// out [M, N] f32 - the lm head, packed along the contracted E. Bound on
// this card: bytes. At Llama-3-8B width and M = 3 a layer's seven K5
// products read 116 MB of packed weight and scales (0.035 ms at 3.35
// TB/s) and the head 279 MB (0.084 ms), at 6 flops per weight byte.
//
// bf16 (the serving dtype) runs on the tensor cores, mma.sync m16n8k16
// (mma.cuh): the dequantized weight is A (16 weight rows or columns x 16
// contracted values), x^T is B (16 contracted values x 8 rows of x), f32
// sums; 1-8 rows take one n-tile of B, up to 64 rows NT = 2, 4 or 8
// n-tiles that reuse the same A registers, so every call reads the weight
// once. The contracted order inside an m16n8k16 step is free (the same
// permutation on A and B), which the two layouts below use. Dequant is
// exact: lop3 puts (nibble ^ 8) | 0x4300 in each half of a bf16x2 (136 +
// n), fma.rn.bf16x2 subtracts 136 (exact) and a second one multiplies by
// the scale pair, rounding once to nearest: bf16(n * s), as
// models/common.dequant_int4. Only how the f32 sums are taken changes
// (their order and the tensor core's alignment of the addends); a call
// gives the same bits every time (no float atomics).
//
// K5 bf16 (mm_pack_out_tc_kernel): a block of 4 warps owns 128 packed
// bytes (256 output columns) and one split of C; a ring of kOutStages
// stages of 32 C rows x 128 bytes, cp.async into shared memory (16-byte
// chunks XOR-swizzled by row so the fragment reads are conflict-free), 12
// KB in flight per block. A packed byte holds two adjacent OUTPUT columns
// but an A register two CONTRACTED values of one column, so a lane reads
// one 4-byte word from each of the 4 C rows of its k pairs and pairs rows
// c and c+1 byte by byte with prmt (each row dequantized with its own
// scale, a bf16x2 scale pair): byte j of the lane's word gives the A rows
// gid (low nibble's column) and gid + 8 (high nibble's) of the warp's
// column tile j, four tiles per warp. (Dequantizing a stage into shared
// memory and reading A with ldmatrix.trans instead took 2.5x as long in an
// ablation build.) x's split rows are staged once as bf16 (rows padded to
// 16 mod 64 elements: conflict-free 8-byte B reads). Scales go straight
// to registers one stage ahead, prefetched into L2 a ring ahead. C is
// split so the grid fills the SMs (kernels/int4mm.out_plan): each split
// writes its partial sums to its slice of an f32 workspace, counts itself
// on its column tile's int counter, and the last block of a tile adds the
// slices in split order (kSumBatch loads in flight) and resets the
// counter: one launch, where a second summing kernel (the f32 body's)
// costs a launch per product on a host-bound decode step for ~6% less
// device time. The wrapper allocates the zeroed counters; the kernel
// allocates nothing.
//
// K6 bf16 (mm_pack_contract_tc_kernel): each warp owns 16 vocab rows at a
// time, 8 warps a block, two blocks per SM walking the vocab tiles.
// A byte's two nibbles are two contracted values, so A comes straight
// from a lane's 16-byte loads (rows gid and gid + 8, one scale each; two
// chunks in flight per lane): word w of a load gives four bf16x2 (w >> 0,
// 4, 8, 12 masked to nibbles 0 and 16: elements (e0, e0+4), (e0+1, e0+5),
// (e0+2, e0+6), (e0+3, e0+7)) for two k16 steps, x is staged in shared
// memory as bf16 in that order ([x0 x4 x1 x5 x2 x6 x3 x7] per 8 values,
// XOR-swizzled by the lane's k quarter) so one 16-byte read gives both
// steps' B fragments. x is staged in pieces of E when all M rows do not
// fit 64 KB.
//
// f32 x keeps the CUDA-core bodies (mm_pack_out_kernel, sum_splits_kernel,
// mm_pack_contract_kernel): a bf16 mma cannot take f32 x without changing
// what is computed, and TF32 would drop digits.
#include "mma.cuh"
#include "paged_common.cuh"

namespace rt {
namespace {

// --- f32: the CUDA-core bodies ---

constexpr int kMT = 4;          // rows of x per pass
constexpr int kColThreads = 32;  // K5: threads along the packed columns
constexpr int kRowWarps = 8;     // K5: warps along C
constexpr int kThreads = kColThreads * kRowWarps;
constexpr int kTileBytes = kColThreads * 16;  // K5: packed columns / block
constexpr int kRedStride = kColThreads + 1;   // K5: padded reduction rows
constexpr int kMaxRows = 1024;                // K5: C rows per split, max
constexpr int kUnroll = 4;                    // weight loads in flight
constexpr int kChunk = 36;                    // K6: padded 32-value chunk

// Byte j (0..3) of a word as its two signed nibbles.
__device__ __forceinline__ int lo_nibble(unsigned w, int j) {
  return static_cast<int>(w << (28 - 8 * j)) >> 28;
}
__device__ __forceinline__ int hi_nibble(unsigned w, int j) {
  return static_cast<int>(w << (24 - 8 * j)) >> 28;
}

// K5's shared memory: the split's x rows, then the tree's hand-over
// buffer (half the warps' 32 sums per thread, rows padded to 33).
__host__ __device__ inline size_t out_smem_bytes(int rows) {
  return sizeof(float) * ((size_t)kMT * rows +
                          (size_t)(kRowWarps / 2) * 32 * kRedStride);
}

// A block owns 512 packed columns (32 threads x 16 bytes) and a range of C
// rows split over its 8 warps; a thread's 16-byte load covers 32 output
// columns, which it accumulates for 4 rows of x (staged as f32) in
// registers. The warps' partial sums meet in a fixed-order tree through
// shared memory; M > 4 loops over 4-row passes.
__global__ void __launch_bounds__(kThreads)
mm_pack_out_kernel(const float* __restrict__ x, const int8_t* __restrict__ q4,
                   const float* __restrict__ s4, float* __restrict__ dst,
                   int M, int C, int P, int gp, int rows) {
  const int tx = threadIdx.x % kColThreads;
  const int ty = threadIdx.x / kColThreads;
  const int byte0 = (blockIdx.x * kColThreads + tx) * 16;
  const int c0 = blockIdx.y * rows;
  const int nrows = min(C - c0, rows);
  const int ng = P / gp;
  extern __shared__ __align__(16) float smem[];
  float* x_sm = smem;                  // [kMT][rows]
  float* red = smem + kMT * rows;      // [kRowWarps / 2][32][kRedStride]
  // This split's slice of the workspace (the output itself when C is not
  // split).
  float* part = dst + (size_t)blockIdx.y * M * 2 * P;

  for (int m0 = 0; m0 < M; m0 += kMT) {
    for (int i = threadIdx.x; i < kMT * rows; i += kThreads) {
      const int m = i / rows, c = i % rows;
      x_sm[i] = (m0 + m < M && c < nrows)
                    ? x[(size_t)(m0 + m) * C + c0 + c] : 0.f;
    }
    __syncthreads();

    float acc[kMT][32];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[m][e] = 0.f;

    if (byte0 < P) {
      for (int r0 = ty; r0 < nrows; r0 += kRowWarps * kUnroll) {
        uint4 raw[kUnroll];
        float sc[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int r = r0 + u * kRowWarps;
          if (r < nrows) {
            const size_t row = (size_t)(c0 + r);
            raw[u] = *reinterpret_cast<const uint4*>(q4 + row * P + byte0);
            sc[u] = s4[row * ng + byte0 / gp];
          } else {
            raw[u] = make_uint4(0u, 0u, 0u, 0u);
            sc[u] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int r = min(r0 + u * kRowWarps, rows - 1);
          float xv[kMT];
#pragma unroll
          for (int m = 0; m < kMT; ++m) xv[m] = x_sm[m * rows + r];
          const unsigned w[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float wl = static_cast<float>(lo_nibble(w[i], j)) * sc[u];
              const float wh = static_cast<float>(hi_nibble(w[i], j)) * sc[u];
              const int e = 2 * (4 * i + j);
#pragma unroll
              for (int m = 0; m < kMT; ++m) {
                acc[m][e] += xv[m] * wl;
                acc[m][e + 1] += xv[m] * wh;
              }
            }
          }
        }
      }
    }

    // The 8 warps' partial sums meet in a fixed-order tree, one row of x
    // at a time: warps [h, 2h) hand theirs to warps [0, h) through
    // red[w][e][tx] (conflict-free: tx is the fastest index), and warp 0
    // ends with the block's sums and writes its 32 columns per thread.
    // The tree's last barrier also ends every read of x_sm for this pass.
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
#pragma unroll
      for (int h = kRowWarps / 2; h >= 1; h /= 2) {
        if (ty >= h && ty < 2 * h) {
#pragma unroll
          for (int e = 0; e < 32; ++e)
            red[((ty - h) * 32 + e) * kRedStride + tx] = acc[m][e];
        }
        __syncthreads();
        if (ty < h) {
#pragma unroll
          for (int e = 0; e < 32; ++e)
            acc[m][e] += red[(ty * 32 + e) * kRedStride + tx];
        }
        __syncthreads();
      }
      if (ty == 0 && byte0 < P && m0 + m < M) {
        float4* d = reinterpret_cast<float4*>(
            part + (size_t)(m0 + m) * 2 * P + 2 * byte0);
#pragma unroll
        for (int e = 0; e < 32; e += 4)
          d[e / 4] = make_float4(acc[m][e], acc[m][e + 1], acc[m][e + 2],
                                 acc[m][e + 3]);
      }
    }
  }
}

// K5 f32's second pass: out[i] = the splits' partial sums at i, added in
// split order (n = M * 2P, a multiple of 4).
__global__ void __launch_bounds__(kThreads)
sum_splits_kernel(const float* __restrict__ work, float* __restrict__ out,
                  int n, int splits) {
  const int n4 = n / 4;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += gridDim.x * kThreads) {
    float4 acc = reinterpret_cast<const float4*>(work)[i];
    for (int k = 1; k < splits; ++k) {
      const float4 v =
          reinterpret_cast<const float4*>(work + (size_t)k * n)[i];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    reinterpret_cast<float4*>(out)[i] = acc;
  }
}

// One warp per output row n at a time, warps striding over N; a lane loads
// 16 packed bytes (32 contracted values) per 512-byte step, four steps in
// flight, and the warp reduces its 4 rows' sums with shuffles. x (4 rows
// at a time) is staged as f32, each 32-value chunk padded to 36 so a
// quarter-warp's float4 reads hit distinct banks.
__global__ void __launch_bounds__(kThreads)
mm_pack_contract_kernel(const float* __restrict__ x,
                        const int8_t* __restrict__ q4,
                        const float* __restrict__ s4, float* __restrict__ out,
                        int M, int N, int Cp, int gp) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int E = 2 * Cp, chunks = Cp / 16, ng = Cp / gp;
  extern __shared__ __align__(16) float xs[];  // [kMT][chunks][kChunk]
  const int warps = gridDim.x * (kThreads / 32);

  for (int m0 = 0; m0 < M; m0 += kMT) {
    __syncthreads();  // the previous pass's readers are done
    for (int i = threadIdx.x; i < kMT * E; i += kThreads) {
      const int m = i / E, e = i % E;
      xs[(m * chunks + e / 32) * kChunk + e % 32] =
          m0 + m < M ? x[(size_t)(m0 + m) * E + e] : 0.f;
    }
    __syncthreads();

    for (int n = blockIdx.x * (kThreads / 32) + warp; n < N; n += warps) {
      const int8_t* row = q4 + (size_t)n * Cp;
      const float* srow = s4 + (size_t)n * ng;
      float acc[kMT];
#pragma unroll
      for (int m = 0; m < kMT; ++m) acc[m] = 0.f;
      for (int b0 = lane * 16; b0 < Cp; b0 += 32 * 16 * kUnroll) {
        uint4 raw[kUnroll];
        float sc[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int b = b0 + u * 32 * 16;
          if (b < Cp) {
            raw[u] = *reinterpret_cast<const uint4*>(row + b);
            sc[u] = srow[b / gp];
          } else {
            raw[u] = make_uint4(0u, 0u, 0u, 0u);
            sc[u] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int b = b0 + u * 32 * 16;
          if (b >= Cp) break;
          const unsigned w[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
          float wv[32];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              wv[8 * i + 2 * j] =
                  static_cast<float>(lo_nibble(w[i], j)) * sc[u];
              wv[8 * i + 2 * j + 1] =
                  static_cast<float>(hi_nibble(w[i], j)) * sc[u];
            }
          }
#pragma unroll
          for (int m = 0; m < kMT; ++m) {
            const float* xc = xs + (m * chunks + b / 16) * kChunk;
#pragma unroll
            for (int e = 0; e < 32; e += 4) {
              const float4 xv = *reinterpret_cast<const float4*>(xc + e);
              acc[m] += xv.x * wv[e] + xv.y * wv[e + 1] + xv.z * wv[e + 2] +
                        xv.w * wv[e + 3];
            }
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const float v = warp_sum(acc[m]);
        if (lane == 0 && m0 + m < M) out[(size_t)(m0 + m) * N + n] = v;
      }
    }
  }
}

// --- bf16: the tensor-core bodies ---

// d = a * b + c on bf16x2, rounded once to nearest.
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The signed nibbles at bits 0-3 and 16-19 of w, times the bf16x2 scale
// pair s2, as bf16x2 (low half from bits 0-3): lop3 makes (n ^ 8) | 0x4300
// = bf16(136 + n) in each half, the first fma subtracts 136 (exact), the
// second multiplies by the scale and rounds once (+ -0 keeps a zero's
// sign): bf16(n * s), bit for bit models/common.dequant_int4.
__device__ __forceinline__ uint32_t dequant2(uint32_t w, uint32_t s2) {
  uint32_t v;
  // f(a, b, c) = b ? a ^ c : c with b the nibble mask, c = 0x4308 x 2.
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n"
      : "=r"(v) : "r"(w), "r"(0x000f000fu), "r"(0x43084308u));
  v = fma_bf16x2(v, 0x3f803f80u, 0xc308c308u);  // v * 1 - 136
  return fma_bf16x2(v, s2, 0x80008000u);        // n * s + -0
}

// Bytes j of a and b side by side: byte 0 <- a.j, byte 2 <- b.j (bytes 1
// and 3 are copies that dequant2's mask drops).
__device__ __forceinline__ uint32_t pair_bytes(uint32_t a, uint32_t b,
                                               int j) {
  return __byte_perm(a, b, j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12));
}

__device__ __forceinline__ uint32_t load_scale(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

constexpr int kOutThreads = 128;    // K5 bf16: 4 warps
constexpr int kOutBytes = 128;      // K5 bf16: packed bytes per block
constexpr int kOutStageRows = 32;   // K5 bf16: C rows per ring stage
constexpr int kOutStages = 4;       // K5 bf16: ring depth
constexpr int kOutStageBytes = kOutStageRows * kOutBytes;
constexpr int kSumBatch = 8;        // K5 bf16: split slices read at once

// K5 bf16's x row stride (elements) for `rows` C rows per split: 16 mod
// 64, so a half-warp's 8-byte B reads (4 rows of x x 4 k quarters) hit
// distinct banks.
__host__ __device__ inline int out_x_stride(int rows) {
  return (rows + 63) / 64 * 64 + 16;
}

__host__ __device__ inline size_t out_tc_smem_bytes(int nt, int rows) {
  return (size_t)kOutStages * kOutStageBytes +
         (size_t)8 * nt * out_x_stride(rows) * 2;
}

template <int NT>
__global__ void __launch_bounds__(kOutThreads)
mm_pack_out_tc_kernel(const __nv_bfloat16* __restrict__ x,
                      const int8_t* __restrict__ q4,
                      const __nv_bfloat16* __restrict__ s4,
                      float* __restrict__ out, float* __restrict__ work,
                      int* __restrict__ counters, int M, int C, int P,
                      int gp, int rows) {
  extern __shared__ __align__(128) uint8_t out_tc_smem[];
  uint8_t* ring = out_tc_smem;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(
      out_tc_smem + kOutStages * kOutStageBytes);
  __shared__ int is_last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int byte0 = blockIdx.x * kOutBytes;
  const int split = blockIdx.y, splits = gridDim.y;
  const int c0 = split * rows;
  const int nrows = min(rows, C - c0);
  const int nst = (nrows + kOutStageRows - 1) / kOutStageRows;
  const int XS = out_x_stride(rows);
  const int ng = P / gp;

  // Stage st's 32 rows x 128 bytes: thread t copies 16-byte chunks t and t
  // + 128 (row = chunk / 8); chunk c of row r lands at c ^ 2 * (r / 4 % 4).
  auto load_stage = [&](int st) {
    if (st < nst) {
      uint8_t* slot = ring + (st % kOutStages) * kOutStageBytes;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int id = tid + k * kOutThreads;
        const int r = id / 8, ch = id % 8;
        const int row = st * kOutStageRows + r;
        const int byte = byte0 + ch * 16;
        const bool ok = row < nrows && byte < P;
        const int swz = (ch ^ ((r >> 1) & 6)) * 16;
        cp_async16(smem_u32(slot + r * kOutBytes + swz),
                   ok ? q4 + (size_t)(c0 + row) * P + byte : q4, ok ? 16 : 0);
      }
      if (tid < kOutStageRows) {   // this stage's scale rows, into L2
        const int row = st * kOutStageRows + tid;
        if (row < nrows)
          prefetch_l2(s4 + (size_t)(c0 + row) * ng + byte0 / gp);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kOutStages - 1; ++st) load_stage(st);

  // x's split rows as bf16, zero past C and past M (Mpad = 8 * NT rows).
  if ((C & 7) == 0) {
    const int vecs = nst * kOutStageRows / 8;
    for (int i = tid; i < 8 * NT * vecs; i += kOutThreads) {
      const int m = i / vecs, v = i % vecs;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && 8 * v < nrows)
        val = *reinterpret_cast<const uint4*>(x + (size_t)m * C + c0 + 8 * v);
      *reinterpret_cast<uint4*>(xs + m * XS + 8 * v) = val;
    }
  } else {
    const int n = nst * kOutStageRows;
    for (int i = tid; i < 8 * NT * n; i += kOutThreads) {
      const int m = i / n, c = i % n;
      xs[m * XS + c] = (m < M && c < nrows) ? x[(size_t)m * C + c0 + c]
                                            : __float2bfloat16(0.f);
    }
  }

  // The lane's column bytes (4 of the warp's 32) and their scale group.
  const int lane_byte = byte0 + 32 * warp + 4 * gid;
  const bool lane_cols = lane_byte < P;
  const int group = lane_cols ? lane_byte / gp : 0;
  // Its word in a stage row: chunk 2 * warp + gid / 4, XOR 2 * tig (its
  // rows 16 kb + 4 tig + i all have r / 4 % 4 == tig).
  const int woff = (((2 * warp + gid / 4) ^ (2 * tig)) * 16) + (gid % 4) * 4;

  // The scale pairs of stage st: [kb][0] = rows 4 tig, 4 tig + 1 of k16
  // block kb, [kb][1] = rows 4 tig + 2, + 3, as bf16x2.
  auto load_scales = [&](int st, uint32_t (&sp)[2][2]) {
#pragma unroll
    for (int kb = 0; kb < 2; ++kb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = st * kOutStageRows + 16 * kb + 4 * tig + 2 * h + i;
          v[i] = (lane_cols && st < nst && row < nrows)
                     ? load_scale(s4 + (size_t)(c0 + row) * ng + group) : 0u;
        }
        sp[kb][h] = v[0] | (v[1] << 16);
      }
  };

  float acc[NT][4][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][j][e] = 0.f;

  uint32_t sc[2][2], sc_next[2][2];
  load_scales(0, sc);
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kOutStages - 2>();
    __syncthreads();  // stage st landed; every read of stage st - 1 done
    load_stage(st + kOutStages - 1);
    load_scales(st + 1, sc_next);
    const uint8_t* slot = ring + (st % kOutStages) * kOutStageBytes;
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      const int r0 = 16 * kb + 4 * tig;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = *reinterpret_cast<const uint32_t*>(
            slot + (r0 + i) * kOutBytes + woff);
      uint2 b[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        b[nt] = *reinterpret_cast<const uint2*>(
            xs + (nt * 8 + gid) * XS + st * kOutStageRows + r0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t p01 = pair_bytes(w[0], w[1], j);
        const uint32_t p23 = pair_bytes(w[2], w[3], j);
        const uint32_t a[4] = {dequant2(p01, sc[kb][0]),
                               dequant2(p01 >> 4, sc[kb][0]),
                               dequant2(p23, sc[kb][1]),
                               dequant2(p23 >> 4, sc[kb][1])};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(acc[nt][j], a, b[nt].x, b[nt].y);
      }
    }
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      sc[kb][0] = sc_next[kb][0];
      sc[kb][1] = sc_next[kb][1];
    }
  }
  cp_async_wait<0>();

  // D of tile j: (row gid, col 2 tig) = low-nibble column of byte lane_byte
  // + j for x row 2 tig, (row gid + 8) its high-nibble column: 8
  // contiguous output columns per x row, two float4s.
  float* dst = splits > 1 ? work + (size_t)split * M * 2 * P : out;
  if (lane_cols) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = nt * 8 + 2 * tig + h;
        if (m < M) {
          float4* d = reinterpret_cast<float4*>(dst + (size_t)m * 2 * P +
                                                2 * lane_byte);
          d[0] = make_float4(acc[nt][0][h], acc[nt][0][2 + h],
                             acc[nt][1][h], acc[nt][1][2 + h]);
          d[1] = make_float4(acc[nt][2][h], acc[nt][2][2 + h],
                             acc[nt][3][h], acc[nt][3][2 + h]);
        }
      }
  }
  if (splits == 1) return;

  // The last split block of this column tile to finish adds the slices in
  // split order and resets the tile's counter for the next launch.
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(counters + blockIdx.x, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (tid == 0) counters[blockIdx.x] = 0;
  const int cols4 = min(kOutBytes, P - byte0) / 2;  // float4s per x row
  const size_t slice = (size_t)M * 2 * P;
  for (int i = tid; i < M * cols4; i += kOutThreads) {
    const float* src =
        work + (size_t)(i / cols4) * 2 * P + 2 * byte0 + 4 * (i % cols4);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    // kSumBatch slices' loads in flight, added in split order.
    for (int k0 = 0; k0 < splits; k0 += kSumBatch) {
      float4 v[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u)
        if (k0 + u < splits)
          v[u] = __ldcg(reinterpret_cast<const float4*>(
              src + (k0 + u) * slice));
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u)
        if (k0 + u < splits) {
          s.x += v[u].x;
          s.y += v[u].y;
          s.z += v[u].z;
          s.w += v[u].w;
        }
    }
    *reinterpret_cast<float4*>(out + (src - work)) = s;
  }
}

constexpr int kConThreads = 256;  // K6 bf16: 8 warps, a vocab tile each
constexpr int kConUnroll = 2;     // K6 bf16: chunks in flight per lane

// K6 bf16's staged x: `piece` contracted values of 8 * NT rows as bf16.
__host__ __device__ inline size_t contract_tc_smem_bytes(int nt, int piece) {
  return (size_t)piece * 8 * nt * 2;
}

// Two blocks per SM up to 4 n-tiles (ptxas otherwise caps the registers
// lower and spills).
template <int NT>
__global__ void __launch_bounds__(kConThreads, NT <= 4 ? 2 : 1)
mm_pack_contract_tc_kernel(const __nv_bfloat16* __restrict__ x,
                           const int8_t* __restrict__ q4,
                           const __nv_bfloat16* __restrict__ s4,
                           float* __restrict__ out, int M, int N, int Cp,
                           int gp, int piece) {
  extern __shared__ __align__(128) uint4 con_tc_xs[];  // [piece/8][NT][8]
  uint4* xs = con_tc_xs;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int E = 2 * Cp, ng = Cp / gp;
  const int pieces = (E + piece - 1) / piece;
  const int vtiles = (N + 15) / 16;
  const int per_round = gridDim.x * (kConThreads / 32);
  const int rounds = (vtiles + per_round - 1) / per_round;

  // Piece p of x: unit (u, m) = x[m][e..e+8), e = p * piece + 8u, as
  // [x0 x4 x1 x5 x2 x6 x3 x7] at ((u * NT + m / 8) * 8 + (m % 8 ^ 2 (u / 4
  // % 4))); zero past E and past M.
  auto stage = [&](int p) {
    const int units = piece / 8;
    for (int i = tid; i < units * 8 * NT; i += kConThreads) {
      const int u = i / (8 * NT), m = i % (8 * NT);
      const int e = p * piece + 8 * u;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && e < E) {
        const uint4 r =
            *reinterpret_cast<const uint4*>(x + (size_t)m * E + e);
        v = make_uint4(__byte_perm(r.x, r.z, 0x5410),
                       __byte_perm(r.x, r.z, 0x7632),
                       __byte_perm(r.y, r.w, 0x5410),
                       __byte_perm(r.y, r.w, 0x7632));
      }
      xs[(u * NT + m / 8) * 8 + ((m % 8) ^ (2 * ((u >> 2) & 3)))] = v;
    }
  };
  if (pieces == 1) {
    stage(0);
    __syncthreads();
  }

  for (int round = 0; round < rounds; ++round) {
    const int vt = (round * gridDim.x + blockIdx.x) * (kConThreads / 32) + warp;
    const int n0 = vt * 16 + gid, n1 = n0 + 8;
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

    for (int p = 0; p < pieces; ++p) {
      if (pieces > 1) {
        __syncthreads();  // every read of the previous piece done
        stage(p);
        __syncthreads();
      }
      if (vt >= vtiles) continue;
      const int bp = p * piece / 2;  // the piece's first packed byte
      const int nch = (min(piece, E - p * piece) + 127) / 128;
      // Chunk ci: the lane's 16 bytes at bp + 64 ci + 16 tig of rows n0 and
      // n1, each with its scale (zero past N and past Cp).
      auto fetch = [&](int ci, uint4 (&raw)[2], uint32_t (&sc)[2]) {
        const int b = bp + 64 * ci + 16 * tig;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = r ? n1 : n0;
          if (n < N && b < Cp) {
            raw[r] = __ldg(reinterpret_cast<const uint4*>(
                q4 + (size_t)n * Cp + b));
            const uint32_t s = load_scale(s4 + (size_t)n * ng + b / gp);
            sc[r] = s | (s << 16);
          } else {
            raw[r] = make_uint4(0u, 0u, 0u, 0u);
            sc[r] = 0u;
          }
        }
      };
      uint4 raw[kConUnroll][2];
      uint32_t sc[kConUnroll][2];
#pragma unroll
      for (int u = 0; u < kConUnroll; ++u)
        if (u < nch) fetch(u, raw[u], sc[u]);
      for (int c0 = 0; c0 < nch; c0 += kConUnroll) {
#pragma unroll
        for (int u = 0; u < kConUnroll; ++u) {
          const int ci = c0 + u;
          if (ci >= nch) break;
          const uint4 cur[2] = {raw[u][0], raw[u][1]};
          const uint32_t s2[2] = {sc[u][0], sc[u][1]};
          if (ci + kConUnroll < nch) fetch(ci + kConUnroll, raw[u], sc[u]);
          const uint32_t w0[4] = {cur[0].x, cur[0].y, cur[0].z, cur[0].w};
          const uint32_t w1[4] = {cur[1].x, cur[1].y, cur[1].z, cur[1].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            uint32_t r0[4], r1[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              r0[k] = dequant2(w0[q] >> (4 * k), s2[0]);
              r1[k] = dequant2(w1[q] >> (4 * k), s2[1]);
            }
            const int u8 = 16 * ci + 4 * tig + q;
            const uint32_t a_lo[4] = {r0[0], r1[0], r0[1], r1[1]};
            const uint32_t a_hi[4] = {r0[2], r1[2], r0[3], r1[3]};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const uint4 b = xs[(u8 * NT + nt) * 8 + (gid ^ (2 * tig))];
              mma_bf16(acc[nt], a_lo, b.x, b.y);
              mma_bf16(acc[nt], a_hi, b.z, b.w);
            }
          }
        }
      }
    }
    if (vt >= vtiles) continue;
    // D: (row gid, col 2 tig) = vocab n0, x row 2 tig; row gid + 8 = n1.
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = nt * 8 + 2 * tig + h;
        if (m >= M) continue;
        if (n0 < N) out[(size_t)m * N + n0] = acc[nt][h];
        if (n1 < N) out[(size_t)m * N + n1] = acc[nt][2 + h];
      }
  }
}

int sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess || n < 1)
    return 132;
  return n;
}

// f32 K5 with C in parts of `rows` rows (a multiple of 8, at most
// kMaxRows): one part writes `out` directly; more write their slices of
// `work` ([splits, M, 2P] f32), which sum_splits_kernel adds into `out`.
int launch_out_f32(const void* x, const void* q4, const void* s4, float* out,
                   float* work, int M, int C, int P, int gp, int rows,
                   int device, cudaStream_t stream) {
  if (rows % kRowWarps || rows > kMaxRows) return cudaErrorInvalidValue;
  const int used = (C + rows - 1) / rows;
  const dim3 grid((P + kTileBytes - 1) / kTileBytes, used);
  const size_t smem = out_smem_bytes(rows);
  auto kernel = mm_pack_out_kernel;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(q4),
      static_cast<const float*>(s4), used > 1 ? work : out, M, C, P, gp,
      rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || used == 1) return err;
  const int n = M * 2 * P;
  const int blocks =
      min((n / 4 + kThreads - 1) / kThreads, 4 * sm_count(device));
  sum_splits_kernel<<<blocks, kThreads, 0, stream>>>(work, out, n, used);
  return cudaGetLastError();
}

template <int NT>
int launch_out_tc(const void* x, const void* q4, const void* s4, float* out,
                  float* work, int* counters, int M, int C, int P, int gp,
                  int rows, cudaStream_t stream) {
  const int splits = (C + rows - 1) / rows;
  const dim3 grid((P + kOutBytes - 1) / kOutBytes, splits);
  const size_t smem = out_tc_smem_bytes(NT, rows);
  auto kernel = mm_pack_out_tc_kernel<NT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kOutThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q4),
      static_cast<const __nv_bfloat16*>(s4), out, work, counters, M, C, P,
      gp, rows);
  return cudaGetLastError();
}

template <int NT>
int launch_contract_tc(const void* x, const void* q4, const void* s4,
                       float* out, int M, int N, int Cp, int gp, int blocks,
                       int piece, cudaStream_t stream) {
  const size_t smem = contract_tc_smem_bytes(NT, piece);
  auto kernel = mm_pack_contract_tc_kernel<NT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kConThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q4),
      static_cast<const __nv_bfloat16*>(s4), out, M, N, Cp, gp, piece);
  return cudaGetLastError();
}

// n-tiles of 8 rows a tensor-core block carries: 1, 2, 4 or 8.
inline int n_tiles(int M) {
  const int t = (M + 7) / 8;
  return t <= 1 ? 1 : t <= 2 ? 2 : t <= 4 ? 4 : 8;
}

}  // namespace
}  // namespace rt

extern "C" {

// Launches K5 on `stream` (a cudaStream_t) of `device`: x [M, C] (dtype
// 0 f32, 1 bf16), q4 [C, P] int8, s4 [C, P/gp] in x's dtype, out [M, 2P]
// f32, C in parts of `rows` rows (kernels/int4mm.out_plan; bf16 a multiple
// of 32, f32 of 8 and at most 1024). With more than one part, `work` is a
// [parts, M, 2P] f32 workspace and (bf16) `counters` P/128 rounded up
// zeroed int32 that the launch leaves zeroed. P and gp multiples of 16, M
// at most 64. Returns a cudaError_t code, 0 on success; the launches are
// asynchronous.
int rt_mm_pack_out(const void* x, const void* q4, const void* s4, void* out,
                   void* work, void* counters, int M, int C, int P, int gp,
                   int rows, int dtype, int device, void* stream) {
  if (M < 1 || M > 64 || C < 1 || P < 16 || P % 16 || gp < 16 || gp % 16 ||
      P % gp || rows < 1)
    return cudaErrorInvalidValue;
  const bool split = rows < C;
  if (split && (!work || (dtype == rt::kBF16 && !counters)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(work);
  int* n = static_cast<int*>(counters);
  if (dtype == rt::kF32)
    return rt::launch_out_f32(x, q4, s4, o, w, M, C, P, gp, rows, device, s);
  if (dtype != rt::kBF16 || rows % rt::kOutStageRows)
    return cudaErrorInvalidValue;
  switch (rt::n_tiles(M)) {
    case 1:
      return rt::launch_out_tc<1>(x, q4, s4, o, w, n, M, C, P, gp, rows, s);
    case 2:
      return rt::launch_out_tc<2>(x, q4, s4, o, w, n, M, C, P, gp, rows, s);
    case 4:
      return rt::launch_out_tc<4>(x, q4, s4, o, w, n, M, C, P, gp, rows, s);
    default:
      return rt::launch_out_tc<8>(x, q4, s4, o, w, n, M, C, P, gp, rows, s);
  }
}

// Launches K6 on `stream` of `device`: x [M, 2Cp], q4 [N, Cp] int8,
// s4 [N, Cp/gp] in x's dtype, out [M, N] f32, `blocks` blocks
// (kernels/int4mm.contract_plan); bf16 stages x in pieces of `piece`
// contracted values (a multiple of 128). Cp and gp multiples of 16, M at
// most 64.
int rt_mm_pack_contract(const void* x, const void* q4, const void* s4,
                        void* out, int M, int N, int Cp, int gp, int blocks,
                        int piece, int dtype, int device, void* stream) {
  if (M < 1 || M > 64 || N < 1 || Cp < 16 || Cp % 16 || gp < 16 ||
      gp % 16 || Cp % gp || blocks < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == rt::kF32) {
    const size_t smem = sizeof(float) * rt::kMT * (Cp / 16) * rt::kChunk;
    auto kernel = rt::mm_pack_contract_kernel;
    err = rt::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, rt::kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q4),
        static_cast<const float*>(s4), o, M, N, Cp, gp);
    return cudaGetLastError();
  }
  if (dtype != rt::kBF16 || piece < 128 || piece % 128)
    return cudaErrorInvalidValue;
  switch (rt::n_tiles(M)) {
    case 1:
      return rt::launch_contract_tc<1>(x, q4, s4, o, M, N, Cp, gp, blocks,
                                       piece, s);
    case 2:
      return rt::launch_contract_tc<2>(x, q4, s4, o, M, N, Cp, gp, blocks,
                                       piece, s);
    case 4:
      return rt::launch_contract_tc<4>(x, q4, s4, o, M, N, Cp, gp, blocks,
                                       piece, s);
    default:
      return rt::launch_contract_tc<8>(x, q4, s4, o, M, N, Cp, gp, blocks,
                                       piece, s);
  }
}
}
