// K2: causal chunk attention at per-row offsets straight off the KV page pool.
//
// Replaces the TPU kernel theroundtaible_tpu/engine/pallas/attention.py
// paged_prefill_attention (kernel _paged_prefill_kernel, math
// _prefill_accumulate, bounds _prefill_blk_bounds): q [B,T,H,D] (pre-scaled,
// rope'd) whose row i sits at absolute position offsets[b] + i, against the
// pools [P,ps,K,D] through the page table [B,pp]. The caller has scattered
// this chunk's K/V already; pages below a row's offset may be aliased donor
// pages and are only read. Mask: kv_pos <= q_pos, kv_pos < kv_valid and,
// with a window, kv_pos > q_pos - window. Logit softcap.
//
// Bound on this card: a full 2048-token chunk does ~4*H*D flops per
// attended (query, key) pair against 2*K*D values read per key, well above
// the bytes line, so a long chunk is bound by operations; a short chunk over
// a long cached prefix is bound by the pages read.
//
// Design (simple first): one block per (q tile, kv head, row), 256 threads.
// A tile is BQ consecutive chunk rows times the kv head's `group` query
// heads, at most 64 query rows, kept in shared memory as f32. The block
// walks the tile's pages lo..hi through the table (the TPU kernel's
// bounds) in sub-blocks of BK <= 32 keys, skipping sub-blocks past the
// tile's causal frontier, past kv_valid, or wholly outside the window, and
// tiles made only of the bucket's pad rows. Per
// sub-block: K and V are staged in shared memory (live cells only - stale
// cells past kv_valid are never loaded), each thread computes a 2x4 tile of
// (row, key) scores on CUDA cores from float4 shared-memory reads, one warp
// per row runs the online-softmax update with f32 m/l and the finite mask
// value, and each thread accumulates a (D/32)x8 tile of the output in
// registers. Tensor-core products (mma/wgmma), TMA staging and warp
// specialisation are later work.
//
// Quantized pools (K4, paged_common.cuh): each thread stages whole 16-byte
// payload vectors with their scale, dequantized (rounded to T) into the
// same f32 sub-block.
#include "paged_common.cuh"

namespace rt {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;  // G * BQ query rows per block
constexpr int kMaxBK = 32;    // keys per staged sub-block (one per lane)

struct Tile {
  int bq;  // chunk rows per tile
  int bk;  // keys per staged sub-block
};

__host__ __device__ inline Tile pick_tile(int G, int ps, int T) {
  int bq = 1;
  while (bq * 2 * G <= kMaxRows && bq < T) bq *= 2;
  return Tile{bq, ps < kMaxBK ? ps : kMaxBK};
}

__host__ __device__ inline size_t prefill_smem_floats(int G, int D, int ps,
                                                      int T) {
  const Tile tile = pick_tile(G, ps, T);
  const size_t R = (size_t)G * tile.bq;
  return R * D                      // q rows
         + (size_t)tile.bk * (D + 4)  // K sub-block (padded rows)
         + (size_t)tile.bk * D        // V sub-block
         + R * (tile.bk + 1)          // scores, then p (padded rows)
         + 3 * R;                     // m, l, alpha
}

// Stages keys/values [kv0, kv0 + BK) of one page (cell offset c0) into the
// f32 sub-block; cells at or past `valid` stage as zeros and are never
// loaded.
template <typename T, int D, int BITS>
__device__ __forceinline__ void stage_sub_block(
    const void* __restrict__ k_pool, const void* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    size_t page, int c0, int kv0, int valid, int BK, int ps, int K, int kh,
    int SG, float* k_sm, float* v_sm) {
  constexpr int KS = D + 4;
  if constexpr (BITS == kBitsNone) {
    constexpr int N = Vec<T>::N;
    for (int i = threadIdx.x; i < BK * (D / N); i += kThreads) {
      const int c = i / (D / N), d = (i % (D / N)) * N;
      float kx[N], vx[N];
      if (kv0 + c < valid) {
        const size_t off = ((page * ps + c0 + c) * K + kh) * D + d;
        Vec<T>::load(static_cast<const T*>(k_pool) + off, kx);
        Vec<T>::load(static_cast<const T*>(v_pool) + off, vx);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < N; e += 4) {
        *reinterpret_cast<float4*>(k_sm + c * KS + d + e) =
            make_float4(kx[e], kx[e + 1], kx[e + 2], kx[e + 3]);
        *reinterpret_cast<float4*>(v_sm + c * D + d + e) =
            make_float4(vx[e], vx[e + 1], vx[e + 2], vx[e + 3]);
      }
    }
  } else {
    using Q = QuantRow<BITS, D>;
    for (int i = threadIdx.x; i < BK * Q::VR; i += kThreads) {
      const int c = i / Q::VR, v = i % Q::VR, d = v * Q::EV;
      float kx[Q::EV], vx[Q::EV];
      if (kv0 + c < valid) {
        const size_t cell = (page * ps + c0 + c) * K + kh;
        uint4 raw;
        float sc;
        load_qvec<BITS, D>(static_cast<const int8_t*>(k_pool), k_scale, cell,
                           v, SG, raw, sc);
        dequant16<T, BITS>(raw, sc, kx);
        load_qvec<BITS, D>(static_cast<const int8_t*>(v_pool), v_scale, cell,
                           v, SG, raw, sc);
        dequant16<T, BITS>(raw, sc, vx);
      } else {
#pragma unroll
        for (int e = 0; e < Q::EV; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < Q::EV; e += 4) {
        *reinterpret_cast<float4*>(k_sm + c * KS + d + e) =
            make_float4(kx[e], kx[e + 1], kx[e + 2], kx[e + 3]);
        *reinterpret_cast<float4*>(v_sm + c * D + d + e) =
            make_float4(vx[e], vx[e + 1], vx[e + 2], vx[e + 3]);
      }
    }
  }
}

template <typename T, int D, int BITS>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q, const void* __restrict__ k_pool,
                     const void* __restrict__ v_pool,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int* __restrict__ table,
                     const int* __restrict__ offsets,
                     const int* __restrict__ kv_valid, T* __restrict__ out,
                     int Tq, int H, int K, int ps, int pp, int BQ, int BK,
                     int window, float softcap, int SG) {
  const int tile = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int R = G * BQ;  // rows r = g * BQ + i: head kh*G+g, chunk row t0+i
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  constexpr int N = Vec<T>::N;
  constexpr int KS = D + 4;  // padded K row: conflict-free float4 row reads
  const int PS = BK + 1;     // padded score row

  extern __shared__ __align__(16) float smem[];
  float* q_sm = smem;            // [R][D]
  float* k_sm = q_sm + R * D;    // [BK][KS]
  float* v_sm = k_sm + BK * KS;  // [BK][D]
  float* p_sm = v_sm + BK * D;   // [R][PS] scores, then p
  float* m_sm = p_sm + R * PS;   // [R]
  float* l_sm = m_sm + R;        // [R]
  float* a_sm = l_sm + R;        // [R]

  const int t0 = tile * BQ;
  const int offs = offsets[b];
  const int valid = kv_valid[b];
  const int q_start = offs + t0;
  const int q_last = q_start + BQ - 1;

  for (int i = tid; i < R * (D / N); i += kThreads) {
    const int r = i / (D / N), d = (i % (D / N)) * N;
    const int g = r / BQ, t = t0 + r % BQ;
    float x[N];
    if (t < Tq) {
      Vec<T>::load(q + (((size_t)b * Tq + t) * H + (size_t)kh * G + g) * D
                   + d, x);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) q_sm[r * D + d + e] = x[e];
  }
  for (int r = tid; r < R; r += kThreads) {
    m_sm[r] = kMaskValue;
    l_sm[r] = 0.f;
  }

  // Score tile of a thread: 2 rows x 4 keys (rows rg, rg+RG; keys cg +
  // j*CG), reading q and K as float4 along D.
  const int CG = BK / 4, RG = kThreads / CG;
  const int cg = tid % CG, rg = tid / CG;
  // Output tile of a thread: TR rows x 8 columns (two float4 runs, at
  // d0 and D/2 + d0, so neighbouring threads read neighbouring words).
  constexpr int CGV = D / 8, RGV = kThreads / CGV, TR = kMaxRows / RGV;
  const int cgv = tid % CGV, rgv = tid / CGV;
  const int d0 = cgv * 4, d1 = D / 2 + cgv * 4;
  float acc[TR][8];
#pragma unroll
  for (int j = 0; j < TR; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;

  // _prefill_blk_bounds: the tile's causal/valid frontier page and the
  // window's first page. A tile whose first row is already at or past
  // kv_valid holds only bucket padding (rows the caller drops): it reads
  // nothing and writes zeros.
  const int hi = q_start < valid
                     ? min(min(floor_div(q_last, ps), (valid - 1) / ps),
                           pp - 1)
                     : -1;
  const int lo = window > 0 ? max(0, floor_div(q_start - window + 1, ps)) : 0;
  const int* row_table = table + (size_t)b * pp;
  __syncthreads();

  for (int j = lo; j <= hi; ++j) {
    const size_t page = (size_t)row_table[j];
    for (int c0 = 0; c0 < ps; c0 += BK) {
      const int kv0 = j * ps + c0;
      // Every cell masked for every row of the tile: causal/valid frontier
      // passed (keys only grow from here), or wholly below the window.
      if (kv0 > q_last || kv0 >= valid) break;
      if (window > 0 && kv0 + BK - 1 <= q_start - window) continue;

      stage_sub_block<T, D, BITS>(k_pool, v_pool, k_scale, v_scale, page, c0,
                                  kv0, valid, BK, ps, K, kh, SG, k_sm, v_sm);
      __syncthreads();

      {
        float s[2][4];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
        const float* qr0 = q_sm + min(rg, R - 1) * D;
        const float* qr1 = q_sm + min(rg + RG, R - 1) * D;
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
          const float4 a0 = *reinterpret_cast<const float4*>(qr0 + d);
          const float4 a1 = *reinterpret_cast<const float4*>(qr1 + d);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float4 k4 = *reinterpret_cast<const float4*>(
                k_sm + (cg + c * CG) * KS + d);
            s[0][c] += a0.x * k4.x + a0.y * k4.y + a0.z * k4.z + a0.w * k4.w;
            s[1][c] += a1.x * k4.x + a1.y * k4.y + a1.z * k4.z + a1.w * k4.w;
          }
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int r = rg + a * RG;
          if (r < R) {
            const int q_pos = q_start + r % BQ;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int col = cg + c * CG;
              const int pos = kv0 + col;
              const bool keep = pos <= q_pos && pos < valid &&
                                (window <= 0 || pos > q_pos - window);
              p_sm[r * PS + col] =
                  keep ? apply_softcap(s[a][c], softcap) : kMaskValue;
            }
          }
        }
      }
      __syncthreads();

      for (int r = warp; r < R; r += kWarps) {
        const float s = lane < BK ? p_sm[r * PS + lane] : kMaskValue;
        const float m_prev = m_sm[r];
        const float m_new = fmaxf(m_prev, warp_max(s));
        const float p =
            (lane < BK && kv0 + lane < valid) ? expf(s - m_new) : 0.f;
        const float sum = warp_sum(p);
        if (lane < BK) p_sm[r * PS + lane] = round_to<T>(p);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          a_sm[r] = alpha;
          l_sm[r] = l_sm[r] * alpha + sum;
          m_sm[r] = m_new;
        }
      }
      __syncthreads();

#pragma unroll
      for (int a = 0; a < TR; ++a) {
        const float alpha = a_sm[min(rgv + a * RGV, R - 1)];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[a][e] *= alpha;
      }
      for (int c = 0; c < BK; ++c) {
        const float4 v0 = *reinterpret_cast<const float4*>(v_sm + c * D + d0);
        const float4 v1 = *reinterpret_cast<const float4*>(v_sm + c * D + d1);
#pragma unroll
        for (int a = 0; a < TR; ++a) {
          const float p = p_sm[min(rgv + a * RGV, R - 1) * PS + c];
          acc[a][0] += p * v0.x; acc[a][1] += p * v0.y;
          acc[a][2] += p * v0.z; acc[a][3] += p * v0.w;
          acc[a][4] += p * v1.x; acc[a][5] += p * v1.y;
          acc[a][6] += p * v1.z; acc[a][7] += p * v1.w;
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int r = rgv + a * RGV;
    const int t = t0 + r % BQ;
    if (r < R && t < Tq) {
      const float inv = 1.f / fmaxf(l_sm[r], 1e-30f);
      T* o = out + (((size_t)b * Tq + t) * H + (size_t)kh * G + r / BQ) * D;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[d0 + e] = from_f32<T>(acc[a][e] * inv);
        o[d1 + e] = from_f32<T>(acc[a][4 + e] * inv);
      }
    }
  }
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* table;
  const int* offsets;
  const int* kv_valid;
  void* out;
  int B, Tq, H, K, ps, pp, window;
  float softcap;
  int G;  // scale groups per cell (quantized pools)
};

template <typename T, int D, int BITS>
int launch(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.K;
  const Tile tl = pick_tile(G, a.ps, a.Tq);
  const size_t smem = sizeof(float) * prefill_smem_floats(G, D, a.ps, a.Tq);
  auto kernel = paged_prefill_kernel<T, D, BITS>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + tl.bq - 1) / tl.bq, a.K, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), a.k_pool, a.v_pool, a.k_scale, a.v_scale,
      a.table, a.offsets, a.kv_valid, static_cast<T*>(a.out), a.Tq, a.H, a.K,
      a.ps, a.pp, tl.bq, tl.bk, a.window, a.softcap, a.G);
  return cudaGetLastError();
}

template <typename T, int D>
int dispatch_bits(int bits, const Args& a, cudaStream_t stream) {
  switch (bits) {
    case kBitsNone: return launch<T, D, kBitsNone>(a, stream);
    case 8: return launch<T, D, 8>(a, stream);
    case 4: return launch<T, D, 4>(a, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int dispatch_d(int D, int bits, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 64: return dispatch_bits<T, 64>(bits, a, stream);
    case 128: return dispatch_bits<T, 128>(bits, a, stream);
    case 256: return dispatch_bits<T, 256>(bits, a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace rt

extern "C" {

// Dynamic shared memory one block of the prefill kernel takes (bytes).
long long rt_paged_prefill_smem_bytes(int G, int D, int ps, int T) {
  return (long long)(sizeof(float) * rt::prefill_smem_floats(G, D, ps, T));
}

// Launches K2 on `stream` (a cudaStream_t) of `device`. kv_bits 0: the
// pools hold T; 8 or 4: int8 payload pools with f32 scales [P,ps,K,G]
// (K4). Returns a cudaError_t code, 0 on success; the launch itself is
// asynchronous.
int rt_paged_prefill(const void* q, const void* k_pool, const void* v_pool,
                     const float* k_scale, const float* v_scale,
                     const int* table, const int* offsets,
                     const int* kv_valid, void* out, int B, int T, int H,
                     int K, int D, int ps, int pp, int window, float softcap,
                     int dtype, int kv_bits, int G, int device,
                     void* stream) {
  if (B < 1 || T < 1 || K < 1 || H % K != 0 || H / K > rt::kMaxGroup ||
      ps < 1 || pp < 1 || !rt::quant_args_ok(kv_bits, D, G) ||
      (kv_bits != rt::kBitsNone && (k_scale == nullptr || v_scale == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const rt::Args a{q, k_pool, v_pool, k_scale, v_scale, table, offsets,
                   kv_valid, out, B, T, H, K, ps, pp, window, softcap, G};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32: return rt::dispatch_d<float>(D, kv_bits, a, s);
    case rt::kBF16: return rt::dispatch_d<__nv_bfloat16>(D, kv_bits, a, s);
  }
  return cudaErrorInvalidValue;
}
}
