// K8: causal attention of a prefill chunk against the position-aligned
// (contiguous) KV cache.
//
// Replaces the TPU kernel theroundtaible_tpu/engine/pallas/attention.py:216
// flash_prefill_attention (kernel _prefill_kernel, math _prefill_accumulate,
// bounds _prefill_blk_bounds): q [B,T,H,D] (pre-scaled, rope'd) whose row i
// sits at absolute position offsets[b] + i, against the caches [N,S,K,D],
// where batch row b reads cache row rows[b] in place (rows == arange(B) is
// the TPU kernel's own call). The caller has written this chunk's K/V into
// the cache already. Mask: kv_pos <= q_pos, kv_pos < kv_valid and, with a
// window, kv_pos > q_pos - window. Logit softcap. Any T >= 1 and any S: the
// TPU gate's multiples of 8 do not apply, so the bucket the engine shrinks
// at the cache end still runs here.
//
// Bound on this card: a long chunk does ~4*H*D flops per attended (query,
// key) pair against 2*K*D values read per key, well above the bytes line,
// so it is bound by operations; a short chunk over a long cached prefix is
// bound by the cells read.
//
// Design: K2's (paged_prefill.cu) without the page table. One block per
// (q tile, kv head, row), 256 threads. A tile is BQ consecutive chunk rows
// times the kv head's `group` query heads, at most 64 query rows, kept in
// shared memory as f32. The block walks the tile's positions from the
// window's first (0 without a window) to its causal/valid frontier
// (_prefill_blk_bounds) in sub-blocks of 32 keys, addressed directly as
// base + ((slot * S + pos) * K + kh) * D; positions past the frontier are
// never loaded (a reused slot holds the previous occupant's K/V there).
// Per sub-block: K and V staged in shared memory, each thread computes a
// 2x4 tile of (row, key) scores on CUDA cores from float4 shared-memory
// reads, one warp per row runs the online-softmax update with f32 m/l and
// the finite mask value, each thread accumulates a (D/32)x8 tile of the
// output in registers. Pad rows of a bucket (q_pos >= kv_valid) are written
// as 0, here and in the plain version, so the two agree on the whole
// output; a tile made only of pad rows walks nothing. A row index outside
// [0, N) traps: the launch fails and the next synchronisation raises.
// Tensor-core products, TMA staging and warp specialisation are later work.
#include "paged_common.cuh"

namespace rt {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;  // G * BQ query rows per block
constexpr int kBK = 32;       // keys per staged sub-block (one per lane)

__host__ __device__ inline int pick_bq(int G, int T) {
  int bq = 1;
  while (bq * 2 * G <= kMaxRows && bq < T) bq *= 2;
  return bq;
}

__host__ __device__ inline size_t flash_smem_floats(int G, int D, int T) {
  const size_t R = (size_t)G * pick_bq(G, T);
  return R * D                  // q rows
         + (size_t)kBK * (D + 4)  // K sub-block (padded rows)
         + (size_t)kBK * D        // V sub-block
         + R * (kBK + 1)          // scores, then p (padded rows)
         + 3 * R;                 // m, l, alpha
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                     const T* __restrict__ v_cache,
                     const int* __restrict__ rows,
                     const int* __restrict__ offsets,
                     const int* __restrict__ kv_valid, T* __restrict__ out,
                     int Tq, int H, int K, int S, int n_rows, int BQ,
                     int window, float softcap) {
  constexpr int BK = kBK;
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
  constexpr int PS = BK + 1;  // padded score row

  extern __shared__ __align__(16) float smem[];
  float* q_sm = smem;            // [R][D]
  float* k_sm = q_sm + R * D;    // [BK][KS]
  float* v_sm = k_sm + BK * KS;  // [BK][D]
  float* p_sm = v_sm + BK * D;   // [R][PS] scores, then p
  float* m_sm = p_sm + R * PS;   // [R]
  float* l_sm = m_sm + R;        // [R]
  float* a_sm = l_sm + R;        // [R]

  const int slot = rows[b];
  if (slot < 0 || slot >= n_rows) __trap();
  const int t0 = tile * BQ;
  const int q_start = offsets[b] + t0;
  const int q_last = q_start + BQ - 1;
  const int valid = min(kv_valid[b], S);

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

  const int CG = BK / 4, RG = kThreads / CG;
  const int cg = tid % CG, rg = tid / CG;
  constexpr int CGV = D / 8, RGV = kThreads / CGV, TR = kMaxRows / RGV;
  const int cgv = tid % CGV, rgv = tid / CGV;
  const int d0 = cgv * 4, d1 = D / 2 + cgv * 4;
  float acc[TR][8];
#pragma unroll
  for (int j = 0; j < TR; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;

  // _prefill_blk_bounds at key granularity: the window's first position
  // and the tile's causal/valid frontier. A tile whose first row is at or
  // past kv_valid holds only bucket padding: it reads nothing.
  const int lo = window > 0 ? max(0, q_start - window + 1) : 0;
  const int end = q_start < valid ? min(q_last + 1, valid) : 0;
  const size_t head = (size_t)slot * S * K * D + (size_t)kh * D;
  __syncthreads();

  for (int kv0 = lo; kv0 < end; kv0 += BK) {
    for (int i = tid; i < BK * (D / N); i += kThreads) {
      const int c = i / (D / N), d = (i % (D / N)) * N;
      float kx[N], vx[N];
      if (kv0 + c < end) {
        const size_t off = head + (size_t)(kv0 + c) * K * D + d;
        Vec<T>::load(k_cache + off, kx);
        Vec<T>::load(v_cache + off, vx);
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
      const float s = p_sm[r * PS + lane];
      const float m_prev = m_sm[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = kv0 + lane < end ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      p_sm[r * PS + lane] = round_to<T>(p);
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

#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int r = rgv + a * RGV;
    const int t = t0 + r % BQ;
    if (r < R && t < Tq) {
      // Pad rows (q_pos >= kv_valid) are 0.
      const float inv =
          q_start + r % BQ < valid ? 1.f / fmaxf(l_sm[r], 1e-30f) : 0.f;
      T* o = out + (((size_t)b * Tq + t) * H + (size_t)kh * G + r / BQ) * D;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[d0 + e] = from_f32<T>(acc[a][e] * inv);
        o[d1 + e] = from_f32<T>(acc[a][4 + e] * inv);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const int* rows, const int* offsets, const int* kv_valid,
           void* out, int B, int Tq, int H, int K, int S, int n_rows,
           int window, float softcap, cudaStream_t stream) {
  const int G = H / K;
  const int bq = pick_bq(G, Tq);
  const size_t smem = sizeof(float) * flash_smem_floats(G, D, Tq);
  auto kernel = flash_prefill_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + bq - 1) / bq, K, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), rows, offsets, kv_valid,
      static_cast<T*>(out), Tq, H, K, S, n_rows, bq, window, softcap);
  return cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k_cache, const void* v_cache,
               const int* rows, const int* offsets, const int* kv_valid,
               void* out, int B, int Tq, int H, int K, int S, int n_rows,
               int window, float softcap, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k_cache, v_cache, rows, offsets, kv_valid, out,
                           B, Tq, H, K, S, n_rows, window, softcap, stream);
    case 128:
      return launch<T, 128>(q, k_cache, v_cache, rows, offsets, kv_valid,
                            out, B, Tq, H, K, S, n_rows, window, softcap,
                            stream);
    case 256:
      return launch<T, 256>(q, k_cache, v_cache, rows, offsets, kv_valid,
                            out, B, Tq, H, K, S, n_rows, window, softcap,
                            stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace rt

extern "C" {

// Dynamic shared memory one block of the prefill kernel takes (bytes).
long long rt_flash_prefill_smem_bytes(int G, int D, int T) {
  return (long long)(sizeof(float) * rt::flash_smem_floats(G, D, T));
}

// Launches K8 on `stream` (a cudaStream_t) of `device`. The caches are
// [n_rows, S, K, D]; batch row b reads cache row rows[b]. Returns a
// cudaError_t code, 0 on success; the launch itself is asynchronous.
int rt_flash_prefill(const void* q, const void* k_cache, const void* v_cache,
                     const int* rows, const int* offsets,
                     const int* kv_valid, void* out, int B, int T, int H,
                     int K, int D, int S, int n_rows, int window,
                     float softcap, int dtype, int device, void* stream) {
  if (B < 1 || T < 1 || K < 1 || H % K != 0 || H / K > rt::kMaxGroup ||
      S < 1 || n_rows < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return rt::dispatch_d<float>(D, q, k_cache, v_cache, rows, offsets,
                                   kv_valid, out, B, T, H, K, S, n_rows,
                                   window, softcap, s);
    case rt::kBF16:
      return rt::dispatch_d<__nv_bfloat16>(D, q, k_cache, v_cache, rows,
                                           offsets, kv_valid, out, B, T, H,
                                           K, S, n_rows, window, softcap, s);
  }
  return cudaErrorInvalidValue;
}
}
