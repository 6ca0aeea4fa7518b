// K3: mixed prefill/decode attention over a flat token buffer, straight off
// the KV page pool.
//
// Replaces the TPU kernel theroundtaible_tpu/engine/pallas/attention.py:1160
// ragged_paged_attention (kernel _ragged_kernel, math _prefill_accumulate,
// bounds _prefill_blk_bounds): q [T,H,D] (pre-scaled, rope'd) is cut into
// 8-row blocks; block qb belongs to sequence seq = seq_of_block[qb] and its
// row i sits at absolute position query_offsets[seq] + block_qstart[qb] + i.
// Each block attends its sequence's pages [P,ps,K,D] through tables[seq]
// with the causal mask kv_pos <= q_pos, kv_pos < kv_valid[seq] and, with a
// window, kv_pos > q_pos - window; logit softcap. A row at or past
// kv_valid[seq] is a pad row (7 of every decode block's 8, the inert
// blocks' tails): it is written as 0, and a block made only of pad rows
// reads nothing.
//
// Bound on this card: a prefill chunk of the buffer does ~4*H*D flops per
// attended (query, key) pair against 2*K*D values read per key once, so a
// buffer carrying a long chunk is bound by operations; decode rows alone
// would be bound by the pages read. At Llama-3-8B width (H=32, K=8, D=128)
// a 1000-row chunk is ~8 GFLOP against ~40 MB of pages.
//
// Design (simple first; K2's tile loop with K1's staging): one block per
// (q block, kv head), 256 threads. The block holds the kv head's `group`
// query heads of its 8 rows (group * 8 <= 128 query rows) in shared memory
// as f32, reads its own sequence, start and frontier, and walks the
// positions of pages lo..hi through its table (the TPU grid's sequential
// page axis becomes this loop) in sub-blocks of BK <= 32 keys, skipping
// sub-blocks wholly below the window and stopping at the causal/valid
// frontier. Each sub-block's K and V (live cells only - cells at or past
// kv_valid are never loaded, so NaN there reaches no row) are staged in
// shared memory, and the next sub-block's 16-byte loads are already in
// flight in registers while the current one computes. Per sub-block each
// thread computes a 2x4 tile of (row, key) scores on CUDA cores from
// float4 shared-memory reads, one warp per row runs the online-softmax
// update with f32 m/l and the finite mask value, p rounded to v's dtype,
// and each thread accumulates a (rows/RGV)x8 tile of the output in
// registers; l is clamped at 1e-30 at the end. Tensor-core products
// (mma/wgmma), TMA staging, split-KV for long decode rows and packing
// decode rows densely (7 of 8 rows of a decode block are pad) are later
// work.
//
// Quantized pools (K4, paged_common.cuh): the sub-block's registers hold
// whole 16-byte payload vectors and their scales instead, dequantized
// (rounded to T) into the same f32 sub-block when stored.
#include "paged_common.cuh"

namespace rt {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockQ = 8;   // RAGGED_BLOCK_Q: flat-buffer rows per q block
constexpr int kMaxBK = 32;   // keys per staged sub-block (one per lane)

__host__ __device__ inline int sub_block(int ps) {
  return ps < kMaxBK ? ps : kMaxBK;
}

__host__ __device__ inline size_t ragged_smem_floats(int G, int D, int ps) {
  const size_t R = (size_t)G * kBlockQ;
  const int BK = sub_block(ps);
  return R * D                     // q rows
         + (size_t)BK * (D + 4)    // K sub-block (padded rows)
         + (size_t)BK * D          // V sub-block
         + R * (BK + 1)            // scores, then p (padded rows)
         + 3 * R;                  // m, l, alpha
}

// Sixteen bytes of T widened to f32 (bf16 -> f32 is a 16-bit shift).
template <typename T>
struct Widen;
template <>
struct Widen<float> {
  __device__ __forceinline__ static void run(const uint4& v, float* o) {
    o[0] = __uint_as_float(v.x); o[1] = __uint_as_float(v.y);
    o[2] = __uint_as_float(v.z); o[3] = __uint_as_float(v.w);
  }
};
template <>
struct Widen<__nv_bfloat16> {
  __device__ __forceinline__ static void run(const uint4& v, float* o) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Sixteen-byte vectors of one staged sub-block each thread moves per pool:
// native rows, or (K4) payload vectors.
template <typename T, int D, int BITS>
struct Stage {
  static constexpr int N = Vec<T>::N;
  static constexpr int VR = BITS == kBitsNone ? D / N
                                              : QuantRow<BITS, D>::VR;
  static constexpr int LPT = (kMaxBK * VR + kThreads - 1) / kThreads;
};

// Loads the K/V cells [kv0, kv0 + BK) of one page into registers (with
// each payload vector's scale when quantized); cells at or past `valid`
// read nothing and stage as zeros.
template <typename T, int D, int BITS>
__device__ __forceinline__ void load_sub_block(
    const void* __restrict__ k_pool, const void* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    size_t page, int kv0, int valid, int BK, int ps, int K, int kh, int SG,
    uint4* kr, uint4* vr, float* ksr, float* vsr) {
  using S = Stage<T, D, BITS>;
  const int cell0 = kv0 % ps;
#pragma unroll
  for (int it = 0; it < S::LPT; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int c = i / S::VR, v = i % S::VR;
    if (c < BK && kv0 + c < valid) {
      if constexpr (BITS == kBitsNone) {
        const size_t off = ((page * ps + cell0 + c) * K + kh) * D + v * S::N;
        kr[it] = *reinterpret_cast<const uint4*>(
            static_cast<const T*>(k_pool) + off);
        vr[it] = *reinterpret_cast<const uint4*>(
            static_cast<const T*>(v_pool) + off);
      } else {
        const size_t cell = (page * ps + cell0 + c) * K + kh;
        load_qvec<BITS, D>(static_cast<const int8_t*>(k_pool), k_scale, cell,
                           v, SG, kr[it], ksr[it]);
        load_qvec<BITS, D>(static_cast<const int8_t*>(v_pool), v_scale, cell,
                           v, SG, vr[it], vsr[it]);
      }
    } else {
      kr[it] = make_uint4(0u, 0u, 0u, 0u);
      vr[it] = make_uint4(0u, 0u, 0u, 0u);
      ksr[it] = vsr[it] = 0.f;
    }
  }
}

template <typename T, int D, int BITS>
__device__ __forceinline__ void store_sub_block(float* k_sm, float* v_sm,
                                                int BK, const uint4* kr,
                                                const uint4* vr,
                                                const float* ksr,
                                                const float* vsr) {
  using S = Stage<T, D, BITS>;
  constexpr int KS = D + 4;
  constexpr int EV = BITS == kBitsNone ? S::N : QuantRow<BITS, D>::EV;
#pragma unroll
  for (int it = 0; it < S::LPT; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int c = i / S::VR, v = (i % S::VR) * EV;
    if (c < BK) {
      float kx[EV], vx[EV];
      if constexpr (BITS == kBitsNone) {
        Widen<T>::run(kr[it], kx);
        Widen<T>::run(vr[it], vx);
      } else {
        dequant16<T, BITS>(kr[it], ksr[it], kx);
        dequant16<T, BITS>(vr[it], vsr[it], vx);
      }
#pragma unroll
      for (int e = 0; e < EV; e += 4) {
        *reinterpret_cast<float4*>(k_sm + c * KS + v + e) =
            make_float4(kx[e], kx[e + 1], kx[e + 2], kx[e + 3]);
        *reinterpret_cast<float4*>(v_sm + c * D + v + e) =
            make_float4(vx[e], vx[e + 1], vx[e + 2], vx[e + 3]);
      }
    }
  }
}

// Scores of NR rows (r, r + RG) against keys cg, cg + CG, cg + 2CG, cg + 3CG
// of the staged sub-block, masked and softcapped into p_sm.
template <int D, int NR>
__device__ __forceinline__ void score_rows(const float* q_sm,
                                           const float* k_sm, float* p_sm,
                                           int r, int RG, int cg, int CG,
                                           int PS, int q_start, int kv0,
                                           int valid, int window,
                                           float softcap) {
  constexpr int KS = D + 4;
  float s[NR][4];
#pragma unroll
  for (int a = 0; a < NR; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 qa[NR];
#pragma unroll
    for (int a = 0; a < NR; ++a)
      qa[a] = *reinterpret_cast<const float4*>(q_sm + (r + a * RG) * D + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 k4 =
          *reinterpret_cast<const float4*>(k_sm + (cg + c * CG) * KS + d);
#pragma unroll
      for (int a = 0; a < NR; ++a)
        s[a][c] += qa[a].x * k4.x + qa[a].y * k4.y + qa[a].z * k4.z +
                   qa[a].w * k4.w;
    }
  }
#pragma unroll
  for (int a = 0; a < NR; ++a) {
    const int row = r + a * RG;
    const int q_pos = q_start + row % kBlockQ;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = cg + c * CG;
      const int pos = kv0 + col;
      const bool keep = pos <= q_pos && pos < valid &&
                        (window <= 0 || pos > q_pos - window);
      p_sm[row * PS + col] = keep ? apply_softcap(s[a][c], softcap)
                                  : kMaskValue;
    }
  }
}

template <typename T, int D, int MAXR, int BITS>
__global__ void __launch_bounds__(kThreads)
ragged_paged_kernel(const T* __restrict__ q, const void* __restrict__ k_pool,
                    const void* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const int* __restrict__ seq_of_block,
                    const int* __restrict__ block_qstart,
                    const int* __restrict__ query_offsets,
                    const int* __restrict__ kv_valid, T* __restrict__ out,
                    int H, int K, int ps, int pp, int window,
                    float softcap, int SG) {
  const int qb = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / K;
  const int R = G * kBlockQ;  // rows r = g * 8 + i: head kh*G+g, row qb*8+i
  const int BK = sub_block(ps);
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

  // The per-block indirection of the flat buffer: this block's sequence.
  const int seq = seq_of_block[qb];
  const int q_start = query_offsets[seq] + block_qstart[qb];
  const int valid = kv_valid[seq];
  const int t0 = qb * kBlockQ;

  for (int i = tid; i < R * (D / N); i += kThreads) {
    const int r = i / (D / N), d = (i % (D / N)) * N;
    float x[N];
    Vec<T>::load(q + ((size_t)(t0 + r % kBlockQ) * H + (size_t)kh * G +
                      r / kBlockQ) * D + d, x);
#pragma unroll
    for (int e = 0; e < N; ++e) q_sm[r * D + d + e] = x[e];
  }
  for (int r = tid; r < R; r += kThreads) {
    m_sm[r] = kMaskValue;
    l_sm[r] = 0.f;
  }

  // Score tile of a thread: rows rg + k*RG, keys cg + j*CG.
  const int CG = BK / 4, RG = kThreads / CG;
  const int cg = tid % CG, rg = tid / CG;
  // Output tile of a thread: TR rows x 8 columns (two float4 runs, at d0
  // and D/2 + d0, so neighbouring threads read neighbouring words).
  constexpr int CGV = D / 8, RGV = kThreads / CGV, TR = MAXR / RGV;
  const int cgv = tid % CGV, rgv = tid / CGV;
  const int d0 = cgv * 4, d1 = D / 2 + cgv * 4;
  float acc[TR][8];
#pragma unroll
  for (int j = 0; j < TR; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;

  // _prefill_blk_bounds at sub-block grain: from the window's first
  // sub-block (0 without a window) up to the block's causal frontier,
  // kv_valid and the table's end. A block whose first row is at or past
  // kv_valid holds only pad rows and reads nothing.
  const int start =
      window > 0 ? max(0, floor_div(q_start - window + 1, BK) * BK) : 0;
  const int end = q_start < valid
                      ? min(min(q_start + kBlockQ, valid), pp * ps)
                      : 0;
  const int* row_table = tables + (size_t)seq * pp;

  constexpr int LPT = Stage<T, D, BITS>::LPT;
  uint4 kr[LPT], vr[LPT];
  float ksr[LPT], vsr[LPT];
  if (start < end)
    load_sub_block<T, D, BITS>(k_pool, v_pool, k_scale, v_scale,
                               (size_t)row_table[start / ps], start, valid,
                               BK, ps, K, kh, SG, kr, vr, ksr, vsr);
  for (int kv0 = start; kv0 < end; kv0 += BK) {
    __syncthreads();  // the previous sub-block's readers are done
    store_sub_block<T, D, BITS>(k_sm, v_sm, BK, kr, vr, ksr, vsr);
    __syncthreads();
    const int next = kv0 + BK;
    if (next < end)  // the next sub-block's loads fly during this one
      load_sub_block<T, D, BITS>(k_pool, v_pool, k_scale, v_scale,
                                 (size_t)row_table[next / ps], next, valid,
                                 BK, ps, K, kh, SG, kr, vr, ksr, vsr);

    for (int r = rg; r < R; r += 2 * RG) {
      if (r + RG < R)
        score_rows<D, 2>(q_sm, k_sm, p_sm, r, RG, cg, CG, PS, q_start, kv0,
                         valid, window, softcap);
      else
        score_rows<D, 1>(q_sm, k_sm, p_sm, r, RG, cg, CG, PS, q_start, kv0,
                         valid, window, softcap);
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
  }
  __syncthreads();  // l_sm of a block that walked nothing

#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int r = rgv + a * RGV;
    if (r < R) {
      const int i = r % kBlockQ;
      const bool real = q_start + i < valid;
      const float inv = real ? 1.f / fmaxf(l_sm[r], 1e-30f) : 0.f;
      T* o = out + ((size_t)(t0 + i) * H + (size_t)kh * G + r / kBlockQ) * D;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[d0 + e] = from_f32<T>(real ? acc[a][e] * inv : 0.f);
        o[d1 + e] = from_f32<T>(real ? acc[a][4 + e] * inv : 0.f);
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
  const int* tables;
  const int* seq_of_block;
  const int* block_qstart;
  const int* query_offsets;
  const int* kv_valid;
  void* out;
  int T, H, K, ps, pp, window;
  float softcap;
  int G;  // scale groups per cell (quantized pools)
};

template <typename T, int D, int MAXR, int BITS>
int launch(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.K;
  const size_t smem = sizeof(float) * ragged_smem_floats(G, D, a.ps);
  auto kernel = ragged_paged_kernel<T, D, MAXR, BITS>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.T / kBlockQ, a.K);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), a.k_pool, a.v_pool, a.k_scale, a.v_scale,
      a.tables, a.seq_of_block, a.block_qstart, a.query_offsets, a.kv_valid,
      static_cast<T*>(a.out), a.H, a.K, a.ps, a.pp, a.window, a.softcap,
      a.G);
  return cudaGetLastError();
}

template <typename T, int D, int MAXR>
int dispatch_bits(int bits, const Args& a, cudaStream_t stream) {
  switch (bits) {
    case kBitsNone: return launch<T, D, MAXR, kBitsNone>(a, stream);
    case 8: return launch<T, D, MAXR, 8>(a, stream);
    case 4: return launch<T, D, MAXR, 4>(a, stream);
  }
  return cudaErrorInvalidValue;
}

// The accumulator tile is sized for the smallest of 32/64/128 query rows
// that holds group * 8.
template <typename T, int D>
int dispatch_rows(int bits, const Args& a, cudaStream_t stream) {
  const int rows = a.H / a.K * kBlockQ;
  if (rows <= 32) return dispatch_bits<T, D, 32>(bits, a, stream);
  if (rows <= 64) return dispatch_bits<T, D, 64>(bits, a, stream);
  return dispatch_bits<T, D, 128>(bits, a, stream);
}

template <typename T>
int dispatch_d(int D, int bits, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 64: return dispatch_rows<T, 64>(bits, a, stream);
    case 128: return dispatch_rows<T, 128>(bits, a, stream);
    case 256: return dispatch_rows<T, 256>(bits, a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace rt

extern "C" {

// Dynamic shared memory one block of the ragged kernel takes (bytes).
long long rt_ragged_smem_bytes(int G, int D, int ps) {
  return (long long)(sizeof(float) * rt::ragged_smem_floats(G, D, ps));
}

// Launches K3 on `stream` (a cudaStream_t) of `device`. kv_bits 0: the
// pools hold T; 8 or 4: int8 payload pools with f32 scales [P,ps,K,G]
// (K4). Returns a cudaError_t code, 0 on success; the launch itself is
// asynchronous.
int rt_ragged_paged(const void* q, const void* k_pool, const void* v_pool,
                    const float* k_scale, const float* v_scale,
                    const int* tables, const int* seq_of_block,
                    const int* block_qstart, const int* query_offsets,
                    const int* kv_valid, void* out, int T, int H, int K,
                    int D, int ps, int pp, int window, float softcap,
                    int dtype, int kv_bits, int G, int device,
                    void* stream) {
  const int bk = rt::sub_block(ps);
  if (T < rt::kBlockQ || T % rt::kBlockQ || K < 1 || H % K != 0 ||
      H / K > rt::kMaxGroup || ps < 4 || bk % 4 || ps % bk || pp < 1 ||
      !rt::quant_args_ok(kv_bits, D, G) ||
      (kv_bits != rt::kBitsNone && (k_scale == nullptr || v_scale == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const rt::Args a{q, k_pool, v_pool, k_scale, v_scale, tables,
                   seq_of_block, block_qstart, query_offsets, kv_valid, out,
                   T, H, K, ps, pp, window, softcap, G};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32: return rt::dispatch_d<float>(D, kv_bits, a, s);
    case rt::kBF16: return rt::dispatch_d<__nv_bfloat16>(D, kv_bits, a, s);
  }
  return cudaErrorInvalidValue;
}
}
