// K9: single-position decode attention against the position-aligned
// (contiguous) KV cache.
//
// Replaces the TPU kernel theroundtaible_tpu/engine/pallas/attention.py:1339
// ragged_decode_attention (kernel _decode_kernel, math _decode_accumulate):
// q [B,1,H,D] (pre-scaled, rope'd) against the caches [N,S,K,D], where batch
// row b reads cache row rows[b] in place (the engine passes the batch's slot
// ids; rows == arange(B) is the TPU kernel's own call). kv_valid [B] includes
// this step, so the query position is kv_valid-1 and causality reduces to
// kv_pos < kv_valid. Sliding window (kv_pos > kv_valid-1-window) and logit
// softcap.
//
// Bound on this card: device-memory bytes. Each row reads the K and V cells
// of its valid prefix for every kv head (B * valid * K * D * 2 values) and
// does 4 flops per value read, far below the ~295 flops/byte the H100 needs
// before compute limits. With one block per (kv head, row) the serving case
// (B=3, K=8) runs 24 blocks on 132 SMs, each walking its row in order, so
// the kernel sits well above its bound; split-KV over positions is later
// work.
//
// Design: K1's (paged_decode.cu) without the page table. One block per
// (kv head, row), 256 threads, holding the kv head's `group` query rows in
// shared memory. The block walks positions [lo, valid) of its cache row
// (lo = valid - window with a window, else 0) in staged tiles of 64 tokens
// (32 in f32): the tile's K and V rows are copied to shared memory with
// coalesced 16-byte loads addressed directly as
// base + ((slot * S + pos) * K + kh) * D, while the next tile's loads are
// already in flight in registers. The cache is read in its [N,S,K,D]
// layout: the TPU kernel's [B,K,S,D] transpose is a BlockSpec need, and a
// transposed copy per layer per step would cost more than the attention.
// Per tile: scores from shared memory, one warp per query head runs the
// online-softmax update (f32 m/l, the finite mask value), each thread
// accumulates its columns of the PV sums in registers. Cells at or past
// kv_valid are never loaded (a reused slot holds the previous occupant's
// K/V there). A row index outside [0, N) traps: the launch fails and the
// next synchronisation raises.
#include "paged_common.cuh"

namespace rt {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
constexpr int tile_tokens() { return 128 / sizeof(T); }

template <typename T, int D>
struct Layout {
  static constexpr int N = Vec<T>::N;           // elements per 16 bytes
  static constexpr int TK = tile_tokens<T>();
  static constexpr int KS = D + N;              // padded K row (elements)
  static constexpr int LPT = TK * (D / N) / kThreads;  // vectors per thread
  static size_t bytes(int G) {
    return sizeof(T) * (size_t)TK * (KS + D)
           + sizeof(float) * ((size_t)G * D + (size_t)G * TK + 3 * G);
  }
};

// One tile of K (or V) rows of cache row `row` (already offset to the
// slot and the kv head) into registers.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ row,
                                          int kv0, int end, int K,
                                          uint4* regs) {
  using L = Layout<T, D>;
#pragma unroll
  for (int it = 0; it < L::LPT; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int c = i / (D / L::N), v = i % (D / L::N);
    const int pos = kv0 + c;
    regs[it] = pos < end
                   ? *reinterpret_cast<const uint4*>(
                         row + (size_t)pos * K * D + v * L::N)
                   : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_tile(T* sm, int stride,
                                           const uint4* regs) {
  using L = Layout<T, D>;
#pragma unroll
  for (int it = 0; it < L::LPT; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int c = i / (D / L::N), v = i % (D / L::N);
    *reinterpret_cast<uint4*>(sm + c * stride + v * L::N) = regs[it];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
ragged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                     const T* __restrict__ v_cache,
                     const int* __restrict__ rows,
                     const int* __restrict__ kv_valid, T* __restrict__ out,
                     int H, int K, int S, int n_rows, int window,
                     float softcap) {
  using L = Layout<T, D>;
  constexpr int N = L::N, TK = L::TK, KS = L::KS;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / K;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_sm = reinterpret_cast<T*>(smem);              // [TK][KS]
  T* v_sm = k_sm + TK * KS;                          // [TK][D]
  float* q_sm = reinterpret_cast<float*>(v_sm + TK * D);  // [G][D]
  float* s_sm = q_sm + G * D;                        // [G][TK] scores, p
  float* m_sm = s_sm + G * TK;                       // [G] running max
  float* l_sm = m_sm + G;                            // [G] running sum
  float* a_sm = l_sm + G;                            // [G] tile rescale

  const int slot = rows[b];
  if (slot < 0 || slot >= n_rows) __trap();

  // GQA: query head h reads kv head h / G, so this block's heads are
  // kh*G .. kh*G+G-1.
  const T* q_row = q + ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) q_sm[i] = to_f32(q_row[i]);
  for (int g = tid; g < G; g += kThreads) {
    m_sm[g] = kMaskValue;
    l_sm[g] = 0.f;
  }
  constexpr int GS = kThreads / D;
  const int d = tid % D, g0 = tid / D;
  constexpr int ACC = (kMaxGroup + GS - 1) / GS;
  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = 0.f;

  const int valid = kv_valid[b];
  const int end = min(valid, S);               // first position not read
  const int lo = window > 0 ? max(0, valid - window) : 0;
  const size_t head = (size_t)slot * S * K * D + (size_t)kh * D;
  const T* k_row = k_cache + head;
  const T* v_row = v_cache + head;

  uint4 k_regs[L::LPT], v_regs[L::LPT];
  if (lo < end) {
    load_tile<T, D>(k_row, lo, end, K, k_regs);
    load_tile<T, D>(v_row, lo, end, K, v_regs);
  }
  for (int kv0 = lo; kv0 < end; kv0 += TK) {
    __syncthreads();  // the previous tile's readers are done
    store_tile<T, D>(k_sm, KS, k_regs);
    store_tile<T, D>(v_sm, D, v_regs);
    __syncthreads();
    if (kv0 + TK < end) {  // the next tile's loads fly during this one
      load_tile<T, D>(k_row, kv0 + TK, end, K, k_regs);
      load_tile<T, D>(v_row, kv0 + TK, end, K, v_regs);
    }

    for (int i = tid; i < G * TK; i += kThreads) {
      const int g = i / TK, c = i % TK;
      const int pos = kv0 + c;
      float s = kMaskValue;
      if (pos < end) {
        const T* kr = k_sm + c * KS;
        const float* q_g = q_sm + g * D;
        float dot = 0.f;
#pragma unroll 4
        for (int v = 0; v < D; v += N) {
          float kx[N];
          Vec<T>::load(kr + v, kx);
#pragma unroll
          for (int e = 0; e < N; ++e) dot += q_g[v + e] * kx[e];
        }
        if (window <= 0 || pos > valid - 1 - window)
          s = apply_softcap(dot, softcap);
      }
      s_sm[i] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* s_row = s_sm + g * TK;
      float mx = kMaskValue;
      for (int c = lane; c < TK; c += 32) mx = fmaxf(mx, s_row[c]);
      mx = warp_max(mx);
      const float m_prev = m_sm[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < TK; c += 32) {
        const float p = kv0 + c < end ? expf(s_row[c] - m_new) : 0.f;
        sum += p;
        s_row[c] = round_to<T>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_sm[g] = alpha;
        l_sm[g] = l_sm[g] * alpha + sum;
        m_sm[g] = m_new;
      }
    }
    __syncthreads();

    const int live = min(TK, end - kv0);
#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      const int g = g0 + j * GS;
      if (g < G) acc[j] *= a_sm[g];
    }
    for (int c = 0; c < live; ++c) {
      const float v = to_f32(v_sm[c * D + d]);
#pragma unroll
      for (int j = 0; j < ACC; ++j) {
        const int g = g0 + j * GS;
        if (g < G) acc[j] += s_sm[g * TK + c] * v;
      }
    }
  }
  __syncthreads();

  T* out_row = out + ((size_t)b * H + (size_t)kh * G) * D;
#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    const int g = g0 + j * GS;
    if (g < G)
      out_row[g * D + d] = from_f32<T>(acc[j] / fmaxf(l_sm[g], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const int* rows, const int* kv_valid, void* out, int B, int H,
           int K, int S, int n_rows, int window, float softcap,
           cudaStream_t stream) {
  const size_t smem = Layout<T, D>::bytes(H / K);
  auto kernel = ragged_decode_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(K, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), rows, kv_valid, static_cast<T*>(out),
      H, K, S, n_rows, window, softcap);
  return cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k_cache, const void* v_cache,
               const int* rows, const int* kv_valid, void* out, int B, int H,
               int K, int S, int n_rows, int window, float softcap,
               cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k_cache, v_cache, rows, kv_valid, out, B, H, K,
                           S, n_rows, window, softcap, stream);
    case 128:
      return launch<T, 128>(q, k_cache, v_cache, rows, kv_valid, out, B, H,
                            K, S, n_rows, window, softcap, stream);
    case 256:
      return launch<T, 256>(q, k_cache, v_cache, rows, kv_valid, out, B, H,
                            K, S, n_rows, window, softcap, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace rt

extern "C" {

// Dynamic shared memory one block of the decode kernel takes (bytes), the
// larger of the bf16 and f32 layouts.
long long rt_ragged_decode_smem_bytes(int G, int D) {
  size_t f = 0, h = 0;
  switch (D) {
    case 64: f = rt::Layout<float, 64>::bytes(G);
             h = rt::Layout<__nv_bfloat16, 64>::bytes(G); break;
    case 128: f = rt::Layout<float, 128>::bytes(G);
              h = rt::Layout<__nv_bfloat16, 128>::bytes(G); break;
    case 256: f = rt::Layout<float, 256>::bytes(G);
              h = rt::Layout<__nv_bfloat16, 256>::bytes(G); break;
    default: return -1;
  }
  return (long long)(f > h ? f : h);
}

// Launches K9 on `stream` (a cudaStream_t) of `device`. The caches are
// [n_rows, S, K, D]; batch row b reads cache row rows[b]. Returns a
// cudaError_t code, 0 on success; the launch itself is asynchronous.
int rt_ragged_decode(const void* q, const void* k_cache, const void* v_cache,
                     const int* rows, const int* kv_valid, void* out, int B,
                     int H, int K, int D, int S, int n_rows, int window,
                     float softcap, int dtype, int device, void* stream) {
  if (B < 1 || K < 1 || H % K != 0 || H / K > rt::kMaxGroup || S < 1 ||
      n_rows < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return rt::dispatch_d<float>(D, q, k_cache, v_cache, rows, kv_valid,
                                   out, B, H, K, S, n_rows, window, softcap,
                                   s);
    case rt::kBF16:
      return rt::dispatch_d<__nv_bfloat16>(D, q, k_cache, v_cache, rows,
                                           kv_valid, out, B, H, K, S, n_rows,
                                           window, softcap, s);
  }
  return cudaErrorInvalidValue;
}
}
