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
// out [M, 2P] f32 - every per-layer projection at decode (M <= 64). Bound
// on this card: bytes. At Llama-3-8B width, M = 3, a projection reads 2 to
// 29 MB of packed weight and does 4 flops per weight byte per row.
// Design (simple first): a block owns 512 packed columns (32 threads x 16
// bytes) and a range of C rows split over its 8 warps; a thread's 16-byte
// load covers 32 output columns, both columns of each byte, which it
// accumulates for 4 rows of x (staged in shared memory as f32) in
// registers, 4 weight rows' loads in flight at once. The 8 warps' partial
// sums meet in a fixed-order tree through shared memory (warps 4-7 into
// 0-3, 2-3 into 0-1, 1 into 0). C is split across blocks so the grid
// covers the SMs twice (k/v_proj have only 512 packed columns; the caller
// picks the number of splits): each split writes its partial sums to its
// own slice of a workspace, and a second kernel adds the slices in split
// order. No atomics, so a call gives the same bits every time. M > 4
// loops over 4-row tiles, re-reading the weight. Tensor cores (mma with
// the dequantized tile in registers) and TMA staging are later work.
//
// K6 (mm_pack_contract): x [M, 2Cp] . unpack(q4 [N, Cp], s4 [N, Cp/gp])^T
// -> out [M, N] f32 - the lm head, packed along the contracted E. Bound:
// bytes (the Llama-3-8B head is 263 MB packed + 16 MB of scales). Design:
// one warp per output row n at a time, warps striding over N; a lane
// loads 16 packed bytes (32 contracted values) per 512-byte step, four
// steps in flight, and the warp reduces its 4 rows' sums with shuffles.
// x (4 rows at a time) is staged in shared memory as f32, each 32-value
// chunk padded to 36 so a quarter-warp's float4 reads hit distinct banks;
// x's even and odd columns are read in place.
#include "paged_common.cuh"

namespace rt {
namespace {

constexpr int kMT = 4;          // rows of x per pass
constexpr int kColThreads = 32;  // K5: threads along the packed columns
constexpr int kRowWarps = 8;     // K5: warps along C
constexpr int kThreads = kColThreads * kRowWarps;
constexpr int kTileBytes = kColThreads * 16;  // K5: packed columns / block
constexpr int kTileCols = 2 * kTileBytes;     // K5: output columns / block
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
mm_pack_out_kernel(const T* __restrict__ x, const int8_t* __restrict__ q4,
                   const T* __restrict__ s4, float* __restrict__ dst, int M,
                   int C, int P, int gp, int rows) {
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
                    ? to_f32(x[(size_t)(m0 + m) * C + c0 + c]) : 0.f;
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
            sc[u] = to_f32(s4[row * ng + byte0 / gp]);
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
              const float wl =
                  round_to<T>(static_cast<float>(lo_nibble(w[i], j)) * sc[u]);
              const float wh =
                  round_to<T>(static_cast<float>(hi_nibble(w[i], j)) * sc[u]);
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

// K5's second pass: out[i] = the splits' partial sums at i, added in split
// order (n = M * 2P, a multiple of 4).
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
mm_pack_contract_kernel(const T* __restrict__ x,
                        const int8_t* __restrict__ q4,
                        const T* __restrict__ s4, float* __restrict__ out,
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
          m0 + m < M ? to_f32(x[(size_t)(m0 + m) * E + e]) : 0.f;
    }
    __syncthreads();

    for (int n = blockIdx.x * (kThreads / 32) + warp; n < N; n += warps) {
      const int8_t* row = q4 + (size_t)n * Cp;
      const T* srow = s4 + (size_t)n * ng;
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
            sc[u] = to_f32(srow[b / gp]);
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
              wv[8 * i + 2 * j] = round_to<T>(
                  static_cast<float>(lo_nibble(w[i], j)) * sc[u]);
              wv[8 * i + 2 * j + 1] = round_to<T>(
                  static_cast<float>(hi_nibble(w[i], j)) * sc[u]);
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

int sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess || n < 1)
    return 132;
  return n;
}

// K5 with C in `splits` parts (rows per part a multiple of 8, at most
// kMaxRows): one split writes `out` directly; more write their slices of
// `work` ([splits, M, 2P] f32), which sum_splits_kernel adds into `out`.
template <typename T>
int launch_out(const void* x, const void* q4, const void* s4, float* out,
               float* work, int M, int C, int P, int gp, int splits,
               int device, cudaStream_t stream) {
  int rows = (C + splits - 1) / splits;
  rows = (rows + kRowWarps - 1) / kRowWarps * kRowWarps;
  if (rows > kMaxRows) return cudaErrorInvalidValue;
  const int used = (C + rows - 1) / rows;
  const dim3 grid((P + kTileBytes - 1) / kTileBytes, used);
  const size_t smem = out_smem_bytes(rows);
  auto kernel = mm_pack_out_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q4),
      static_cast<const T*>(s4), used > 1 ? work : out, M, C, P, gp, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || used == 1) return err;
  const int n = M * 2 * P;
  const int blocks =
      min((n / 4 + kThreads - 1) / kThreads, 4 * sm_count(device));
  sum_splits_kernel<<<blocks, kThreads, 0, stream>>>(work, out, n, used);
  return cudaGetLastError();
}

template <typename T>
int launch_contract(const void* x, const void* q4, const void* s4,
                    float* out, int M, int N, int Cp, int gp, int device,
                    cudaStream_t stream) {
  const int blocks =
      min((N + kThreads / 32 - 1) / (kThreads / 32), 4 * sm_count(device));
  const size_t smem = sizeof(float) * kMT * (Cp / 16) * kChunk;
  auto kernel = mm_pack_contract_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q4),
      static_cast<const T*>(s4), out, M, N, Cp, gp);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rt

extern "C" {

// Launches K5 on `stream` (a cudaStream_t) of `device`: x [M, C] (dtype
// 0 f32, 1 bf16), q4 [C, P] int8, s4 [C, P/gp] in x's dtype, out [M, 2P]
// f32, C in `splits` parts of at most 1024 rows, `work` a [splits, M, 2P]
// f32 workspace when splits > 1. P and gp multiples of 16. Returns a
// cudaError_t code, 0 on success; the launches are asynchronous.
int rt_mm_pack_out(const void* x, const void* q4, const void* s4, void* out,
                   void* work, int M, int C, int P, int gp, int splits,
                   int dtype, int device, void* stream) {
  if (M < 1 || C < 1 || P < 16 || P % 16 || gp < 16 || gp % 16 ||
      P % gp || splits < 1 || splits > C || (splits > 1 && !work))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(work);
  switch (dtype) {
    case rt::kF32:
      return rt::launch_out<float>(x, q4, s4, o, w, M, C, P, gp, splits,
                                   device, s);
    case rt::kBF16:
      return rt::launch_out<__nv_bfloat16>(x, q4, s4, o, w, M, C, P, gp,
                                           splits, device, s);
  }
  return cudaErrorInvalidValue;
}

// Launches K6 on `stream` of `device`: x [M, 2Cp], q4 [N, Cp] int8,
// s4 [N, Cp/gp] in x's dtype, out [M, N] f32. Cp and gp multiples of 16.
int rt_mm_pack_contract(const void* x, const void* q4, const void* s4,
                        void* out, int M, int N, int Cp, int gp, int dtype,
                        int device, void* stream) {
  if (M < 1 || N < 1 || Cp < 16 || Cp % 16 || gp < 16 || gp % 16 ||
      Cp % gp)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (dtype) {
    case rt::kF32:
      return rt::launch_contract<float>(x, q4, s4, o, M, N, Cp, gp, device,
                                        s);
    case rt::kBF16:
      return rt::launch_contract<__nv_bfloat16>(x, q4, s4, o, M, N, Cp, gp,
                                                device, s);
  }
  return cudaErrorInvalidValue;
}
}
