// K1: single-position decode attention straight off the KV page pool.
//
// Replaces the TPU kernel theroundtaible_tpu/engine/pallas/attention.py
// paged_decode_attention (kernel _paged_decode_kernel, math
// _decode_accumulate): q [B,1,H,D] (pre-scaled, rope'd) against the pools
// [P,ps,K,D] through the page table [B,pp]; kv_valid [B] includes this step,
// so the query position is kv_valid-1. Sliding window and logit softcap.
//
// Bound on this card: device-memory bytes. Each row reads the K and V cells
// of its valid prefix for every kv head (B * valid * K * D * 2 values) and
// does 4 flops per value read, far below the ~295 flops/byte the H100 needs
// before compute limits.
//
// Design (simple first): one block per (kv head, row), 256 threads. The
// block holds the kv head's `group` query rows in shared memory, reads its
// own table entries, and walks only the positions of pages lo..hi (hi = the
// frontier page, lo = the window bound) - pages past the frontier are never
// read. It walks them in tiles of 64 tokens (32 in f32): the tile's K and V
// rows are copied to shared memory with coalesced 16-byte loads, each row
// through its own table entry, while the next tile's loads are already in
// flight in registers. Per tile: each thread computes (query head, token)
// scores from shared memory, one warp per query head runs the online-softmax
// update (f32 m/l and the finite mask value of the TPU kernel), and each
// thread accumulates its columns of the PV sums in registers. Cells at or
// past kv_valid are never loaded: stale cells of the frontier page may hold
// anything (NaN included) and contribute exactly 0. Split-KV over pages
// (more blocks than K * B), TMA staging and tensor-core products are later
// work.
//
// Quantized pools (K4, paged_common.cuh): the tile's int8/int4 payload
// vectors and their scales are loaded into registers instead, and
// dequantized into the same shared-memory tile in T while stored.
#include "paged_common.cuh"

namespace rt {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Tokens per staged tile: 64 rows of bf16 or 32 rows of f32, so every
// thread moves D/32 sixteen-byte vectors of K and as many of V per tile.
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

template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ pool,
                                          const int* __restrict__ row_table,
                                          int kv0, int end, int ps, int K,
                                          int kh, uint4* regs) {
  using L = Layout<T, D>;
#pragma unroll
  for (int it = 0; it < L::LPT; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int c = i / (D / L::N), v = i % (D / L::N);
    const int pos = kv0 + c;
    if (pos < end) {
      const size_t page = (size_t)row_table[pos / ps];
      regs[it] = *reinterpret_cast<const uint4*>(
          pool + ((page * ps + pos % ps) * K + kh) * D + v * L::N);
    } else {
      regs[it] = make_uint4(0u, 0u, 0u, 0u);
    }
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

// K4 staging of a tile: payload vectors and scales per thread.
template <typename T, int D, int BITS>
struct QTile {
  using Q = QuantRow<BITS, D>;
  static constexpr int TK = tile_tokens<T>();
  static constexpr int LPT =
      BITS == kBitsNone ? 1 : (TK * Q::VR + kThreads - 1) / kThreads;
};

template <typename T, int D, int BITS>
__device__ __forceinline__ void load_qtile(const int8_t* __restrict__ pool,
                                           const float* __restrict__ scale,
                                           const int* __restrict__ row_table,
                                           int kv0, int end, int ps, int K,
                                           int kh, int G, uint4* regs,
                                           float* sregs) {
  using QT = QTile<T, D, BITS>;
  constexpr int VR = QuantRow<BITS, D>::VR;
#pragma unroll
  for (int it = 0; it < QT::LPT; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int c = i / VR, v = i % VR;
    const int pos = kv0 + c;
    if (i < QT::TK * VR && pos < end) {
      const size_t page = (size_t)row_table[pos / ps];
      load_qvec<BITS, D>(pool, scale, (page * ps + pos % ps) * K + kh, v, G,
                         regs[it], sregs[it]);
    } else {
      regs[it] = make_uint4(0u, 0u, 0u, 0u);
      sregs[it] = 0.f;
    }
  }
}

template <typename T, int D, int BITS>
__device__ __forceinline__ void store_qtile(T* sm, int stride,
                                            const uint4* regs,
                                            const float* sregs) {
  using QT = QTile<T, D, BITS>;
  using Q = QuantRow<BITS, D>;
  constexpr int N = Vec<T>::N;
#pragma unroll
  for (int it = 0; it < QT::LPT; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (i < QT::TK * Q::VR) {
      const int c = i / Q::VR, v = i % Q::VR;
      float x[Q::EV];
      dequant16<T, BITS>(regs[it], sregs[it], x);
      T* dst = sm + c * stride + v * Q::EV;
#pragma unroll
      for (int e = 0; e < Q::EV; e += N) {
        alignas(16) T pack[N];
#pragma unroll
        for (int u = 0; u < N; ++u) pack[u] = from_f32<T>(x[e + u]);
        *reinterpret_cast<uint4*>(dst + e) =
            *reinterpret_cast<const uint4*>(pack);
      }
    }
  }
}

// One tile's K and V loads into registers: native rows, or (K4) payload
// vectors and their scales.
template <typename T, int D, int BITS, int LPT>
__device__ __forceinline__ void load_kv(
    const void* __restrict__ k_pool, const void* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ row_table, int kv0, int end, int ps, int K,
    int kh, int SG, uint4 (&k_regs)[LPT], uint4 (&v_regs)[LPT],
    float (&ks_regs)[LPT], float (&vs_regs)[LPT]) {
  if constexpr (BITS == kBitsNone) {
    load_tile<T, D>(static_cast<const T*>(k_pool), row_table, kv0, end, ps, K,
                    kh, k_regs);
    load_tile<T, D>(static_cast<const T*>(v_pool), row_table, kv0, end, ps, K,
                    kh, v_regs);
  } else {
    load_qtile<T, D, BITS>(static_cast<const int8_t*>(k_pool), k_scale,
                           row_table, kv0, end, ps, K, kh, SG, k_regs,
                           ks_regs);
    load_qtile<T, D, BITS>(static_cast<const int8_t*>(v_pool), v_scale,
                           row_table, kv0, end, ps, K, kh, SG, v_regs,
                           vs_regs);
  }
}

template <typename T, int D, int BITS>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const void* __restrict__ k_pool,
                    const void* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ table,
                    const int* __restrict__ kv_valid, T* __restrict__ out,
                    int H, int K, int ps, int pp, int window, float softcap,
                    int SG) {
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

  // GQA: query head h reads kv head h / G, so this block's heads are
  // kh*G .. kh*G+G-1.
  const T* q_row = q + ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) q_sm[i] = to_f32(q_row[i]);
  for (int g = tid; g < G; g += kThreads) {
    m_sm[g] = kMaskValue;
    l_sm[g] = 0.f;
  }
  // PV outputs of this thread: column d of heads g0, g0 + GS, ...
  constexpr int GS = kThreads / D;
  const int d = tid % D, g0 = tid / D;
  constexpr int ACC = (kMaxGroup + GS - 1) / GS;
  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = 0.f;

  const int valid = kv_valid[b];
  const int hi = valid > 0 ? min((valid - 1) / ps, pp - 1) : -1;
  const int lo = window > 0 ? max(0, floor_div(valid - window, ps)) : 0;
  const int end = min(valid, (hi + 1) * ps);  // first position not read
  const int* row_table = table + (size_t)b * pp;

  // The tile loads in registers: native rows, or (K4) payload + scales.
  constexpr int LPT = BITS == kBitsNone ? L::LPT : QTile<T, D, BITS>::LPT;
  uint4 k_regs[LPT], v_regs[LPT];
  float ks_regs[LPT], vs_regs[LPT];
  if (lo * ps < end)
    load_kv<T, D, BITS>(k_pool, v_pool, k_scale, v_scale, row_table, lo * ps,
                        end, ps, K, kh, SG, k_regs, v_regs, ks_regs,
                        vs_regs);
  for (int kv0 = lo * ps; kv0 < end; kv0 += TK) {
    __syncthreads();  // the previous tile's readers are done
    if constexpr (BITS == kBitsNone) {
      store_tile<T, D>(k_sm, KS, k_regs);
      store_tile<T, D>(v_sm, D, v_regs);
    } else {
      store_qtile<T, D, BITS>(k_sm, KS, k_regs, ks_regs);
      store_qtile<T, D, BITS>(v_sm, D, v_regs, vs_regs);
    }
    __syncthreads();
    // the next tile's loads fly during this one
    if (kv0 + TK < end)
      load_kv<T, D, BITS>(k_pool, v_pool, k_scale, v_scale, row_table,
                          kv0 + TK, end, ps, K, kh, SG, k_regs, v_regs,
                          ks_regs, vs_regs);

    // Scores: (query head g, token c) pairs, K rows from shared memory.
    for (int i = tid; i < G * TK; i += kThreads) {
      const int g = i / TK, c = i % TK;
      const int pos = kv0 + c;
      float s = kMaskValue;
      if (pos < end) {
        const T* k_row = k_sm + c * KS;
        const float* q_g = q_sm + g * D;
        float dot = 0.f;
#pragma unroll 4
        for (int v = 0; v < D; v += N) {
          float kx[N];
          Vec<T>::load(k_row + v, kx);
#pragma unroll
          for (int e = 0; e < N; ++e) dot += q_g[v + e] * kx[e];
        }
        if (window <= 0 || pos > valid - 1 - window)
          s = apply_softcap(dot, softcap);
      }
      s_sm[i] = s;
    }
    __syncthreads();

    // Online-softmax update, one warp per query head.
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

    // PV from shared memory: this thread's column d of its heads.
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

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* table;
  const int* kv_valid;
  void* out;
  int B, H, K, ps, pp, window;
  float softcap;
  int G;  // scale groups per cell (quantized pools)
};

template <typename T, int D, int BITS>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = Layout<T, D>::bytes(a.H / a.K);
  auto kernel = paged_decode_kernel<T, D, BITS>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.K, a.B), kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), a.k_pool, a.v_pool, a.k_scale, a.v_scale,
      a.table, a.kv_valid, static_cast<T*>(a.out), a.H, a.K, a.ps, a.pp,
      a.window, a.softcap, a.G);
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

// Dynamic shared memory one block of the decode kernel takes (bytes), the
// larger of the bf16 and f32 layouts; the tile does not depend on ps.
long long rt_paged_decode_smem_bytes(int G, int D, int ps) {
  (void)ps;
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

// Launches K1 on `stream` (a cudaStream_t) of `device`. kv_bits 0: the
// pools hold T; 8 or 4: int8 payload pools with f32 scales [P,ps,K,G]
// (K4). Returns a cudaError_t code, 0 on success; the launch itself is
// asynchronous.
int rt_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                    const float* k_scale, const float* v_scale,
                    const int* table, const int* kv_valid, void* out, int B,
                    int H, int K, int D, int ps, int pp, int window,
                    float softcap, int dtype, int kv_bits, int G, int device,
                    void* stream) {
  if (B < 1 || K < 1 || H % K != 0 || H / K > rt::kMaxGroup || ps < 1 ||
      pp < 1 || !rt::quant_args_ok(kv_bits, D, G) ||
      (kv_bits != rt::kBitsNone && (k_scale == nullptr || v_scale == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const rt::Args a{q, k_pool, v_pool, k_scale, v_scale, table, kv_valid, out,
                   B, H, K, ps, pp, window, softcap, G};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32: return rt::dispatch_d<float>(D, kv_bits, a, s);
    case rt::kBF16: return rt::dispatch_d<__nv_bfloat16>(D, kv_bits, a, s);
  }
  return cudaErrorInvalidValue;
}
}
