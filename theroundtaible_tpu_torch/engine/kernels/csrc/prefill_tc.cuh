// The prefill mainloop shared by K2 (paged_prefill.cu), K8
// (flash_prefill.cu) and K3's prefill tiles (ragged_paged.cu): causal
// attention of a tile of query rows at consecutive positions against KV
// cells that an addressing policy locates; the tile's rows (TileRows) are
// a batch row's chunk rows for K2/K8 and a run of K3's flat buffer.
//
// Counterpart of theroundtaible_tpu/engine/pallas/attention.py:105
// _prefill_accumulate, which the TPU's contiguous (_prefill_kernel) and
// paged (_paged_prefill_kernel) prefill kernels share: the two differ only
// in how a kv cell is addressed, so the math lives here once and each
// kernel source supplies its policy (paged_common.cuh, shared with the
// decode body decode_split.cuh):
//
// - PagedKV (K2): position pos of batch row b is cell
//   (table[b][pos >> log2 ps] * ps + pos % ps) * K + kh of the pools
//   [P,ps,K,D] (ps a power of two);
// - SlotKV (K8): cell (rows[b] * S + pos) * K + kh of the caches [N,S,K,D];
//   a row index outside [0, N) traps (the launch fails and the next
//   synchronisation raises). Pad rows (q_pos >= kv_valid) are written 0.
//
// q [B,T,H,D] is pre-scaled and rope'd; row i of batch row b sits at
// absolute position offsets[b] + i. Mask: kv_pos <= q_pos, kv_pos <
// kv_valid and, with a window, kv_pos > q_pos - window. Logit softcap. f32
// running max/sum with the finite mask value kMaskValue, p rounded to the
// working type before the PV product, the output divided by max(l, 1e-30).
// Cells at or past kv_valid are never loaded: a reused slot or a stale page
// holds another occupant's K/V (NaN included) there.
//
// Bound on this card: a long chunk does 4*H*D operations per attended
// (query, key) pair against 2*K*D values read per key, far above the bytes
// line, so it is bound by operations - on the tensor cores, 989 TFLOP/s in
// bf16 against 67 outside them. A short chunk over a long cached prefix is
// bound by the cells read.
//
// bf16: prefill_tc_kernel, on the tensor cores. One block per (q tile, kv
// head, batch row): two consumer warpgroups and one producer warpgroup.
// - A consumer warpgroup owns 64 query rows, the kv head's G query heads
//   times BQ = 64 / G chunk rows (rows r = g * BQ + i; rows past G * BQ or
//   past T are padding of the MMA and are never written): wgmma's M. The
//   block's two warpgroups take consecutive chunk rows and share every K/V
//   tile, so a tile is read once per 128 query rows. The tile depends on G,
//   D and T only, never on K or B, so a kv head's blocks do the same work
//   however many kv heads a launch holds (K10c holds each rank's output to
//   the one-device output bit for bit).
// - The producer (setmaxnreg down) walks the block's key tiles of 64
//   positions - from the window's first to the causal/valid frontier,
//   _prefill_blk_bounds' walk - into a ring of bf16 K and V tiles (three
//   stages, two at D = 256), full/empty mbarriers between it and the
//   consumers. bf16 cells come by 16-byte cp.async through the policy's
//   address (a page-table gather; a tile may span pages when ps < 64),
//   positions past the frontier zero-filled without a read; a stage is
//   signalled once its copies have landed and been fenced for wgmma, the
//   next tile's copies already in flight. Quantized pools (K4) are
//   dequantized in registers exactly as the CUDA-core body does
//   (paged_common.cuh load_qvec/dequant16, rounded to bf16) into the same
//   tile, so the consumers' math is the bf16 path's.
// - Tiles are stored in wgmma's 128-byte-swizzled layout so that they can
//   be copied as whole rows: a warp moves 2-4 whole rows of key cells per
//   copy. (In the no-swizzle core-matrix layout a warp's copy gathers 8
//   rows x 64 bytes, and the producer, not the tensor cores, set the pace
//   on this card.) K is read K-major (S = Q.K^T) and V as the transposed B
//   operand (O += P.V) of the same tile.
// - Per tile, each consumer warpgroup: S = Q.K^T by wgmma m64n64k16 (Q
//   loaded once into shared memory), f32 in registers; softcap, mask (only
//   on tiles that cross the causal, valid or window edge of its rows) and
//   the online softmax in registers (exp2 on the special-function unit,
//   row max and sum by quad shuffles; no score round trip through shared
//   memory, no block-wide barrier); p rounded to bf16 in registers as
//   wgmma's A operand; O += P.V by wgmma m64nDk16 from registers, left in
//   flight while the next tile's S product is issued. A warpgroup skips
//   tiles wholly masked for its rows and the O rescale when no row's max
//   moved; a block made only of a bucket's pad rows reads nothing and
//   writes zeros.
// - Blocks are issued heaviest q tile first (the last chunk rows walk the
//   most keys), which cuts the tail of the last wave.
// - ptxas compiles the consumers within the launch's 168 registers per
//   thread, setmaxnreg or not (its spill reports): they fit at D <= 128; at
//   D = 256 the 128-register O accumulator spills.
//
// f32: prefill_simt_kernel, the CUDA-core body. The tensor cores would
// round f32 inputs to TF32 (about three decimal digits), and the f32
// kernels are held to 1e-4 of their plain versions. One block per (q tile,
// kv head, batch row), 256 threads, tiles of at most 64 query rows kept in
// shared memory as f32, keys in sub-blocks of 32: each thread computes a
// 2x4 tile of scores from float4 reads, one warp per row runs the online
// softmax, each thread accumulates a (D/32)x8 tile of the output. This is
// a dispatch on dtype, not a fallback: a bf16 launch runs only the tensor
// core body.
#pragma once

#include <type_traits>

#include "paged_common.cuh"

namespace rt {

// One launch's operands. `index` is the page table [B, pp] (PagedKV) or
// the cache row of each batch row [B] (SlotKV); SG is the number of scale
// groups per cell of a quantized pool.
struct PrefillArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* index;
  const int* offsets;
  const int* kv_valid;
  void* out;
  int B, Tq, H, K;
  int ps, pp;     // PagedKV; ps = 1 << ps_shift
  int ps_shift;
  int S, n_rows;  // SlotKV
  int window;
  float softcap;
  int SG;
};

// The query rows of a tile: row i < n is flat row row0 + i of q and of the
// output viewed as [rows, H, D], at absolute position pos0 + i. K2/K8: chunk
// rows t0 .. of batch row b (row0 = b * T + t0, pos0 = offsets[b] + t0);
// K3: a tile of one run of the flat buffer (ragged_paged.cu).
struct TileRows {
  size_t row0;
  int pos0, n;
};

// ---------------------------------------------------------------------------
// f32: the CUDA-core body.

constexpr int kSimtThreads = 256;
constexpr int kSimtWarps = kSimtThreads / 32;
constexpr int kSimtRows = 64;  // G * BQ query rows per block
constexpr int kSimtBK = 32;    // keys per staged sub-block (one per lane)

__host__ __device__ inline int simt_bq(int G, int T) {
  int bq = 1;
  while (bq * 2 * G <= kSimtRows && bq < T) bq *= 2;
  return bq;
}

// Dynamic shared memory of a block of R = G * BQ <= kSimtRows query rows.
__host__ __device__ inline size_t simt_smem_rows(size_t R, int D) {
  return sizeof(float) * (R * D                         // q rows
                          + (size_t)kSimtBK * (D + 4)   // K (padded rows)
                          + (size_t)kSimtBK * D         // V
                          + R * (kSimtBK + 1)           // scores, then p
                          + 3 * R);                     // m, l, alpha
}

__host__ __device__ inline size_t simt_smem_bytes(int G, int D, int T) {
  return simt_smem_rows((size_t)G * simt_bq(G, T), D);
}

// Stages positions [kv0, kv0 + 32) into the f32 sub-block; positions at or
// past `end` stage as zeros and are never loaded.
template <class KV, int D, int BITS>
__device__ __forceinline__ void simt_stage(const PrefillArgs& a,
                                           const KV& kv, int kv0, int end,
                                           float* k_sm, float* v_sm) {
  constexpr int KS = D + 4;
  if constexpr (BITS == kBitsNone) {
    constexpr int N = Vec<float>::N;
    for (int i = threadIdx.x; i < kSimtBK * (D / N); i += kSimtThreads) {
      const int c = i / (D / N), d = (i % (D / N)) * N;
      float kx[N], vx[N];
      if (kv0 + c < end) {
        const size_t off = kv.cell(kv0 + c) * D + d;
        Vec<float>::load(static_cast<const float*>(a.k) + off, kx);
        Vec<float>::load(static_cast<const float*>(a.v) + off, vx);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) kx[e] = vx[e] = 0.f;
      }
      *reinterpret_cast<float4*>(k_sm + c * KS + d) =
          make_float4(kx[0], kx[1], kx[2], kx[3]);
      *reinterpret_cast<float4*>(v_sm + c * D + d) =
          make_float4(vx[0], vx[1], vx[2], vx[3]);
    }
  } else {
    using Q = QuantRow<BITS, D>;
    for (int i = threadIdx.x; i < kSimtBK * Q::VR; i += kSimtThreads) {
      const int c = i / Q::VR, v = i % Q::VR, d = v * Q::EV;
      float kx[Q::EV], vx[Q::EV];
      if (kv0 + c < end) {
        const size_t cell = kv.cell(kv0 + c);
        uint4 raw;
        float sc;
        load_qvec<BITS, D>(static_cast<const int8_t*>(a.k), a.k_scale, cell,
                           v, a.SG, raw, sc);
        dequant16<float, BITS>(raw, sc, kx);
        load_qvec<BITS, D>(static_cast<const int8_t*>(a.v), a.v_scale, cell,
                           v, a.SG, raw, sc);
        dequant16<float, BITS>(raw, sc, vx);
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

// One block of the CUDA-core body: the rows `w` (at most BQ) of kv head kh's
// G query heads, keys walked up to the frontier of a full BQ rows. Zero pad
// rows (ZERO_PAD): rows at or past `valid` are written 0.
template <class KV, int D, int BITS, bool ZERO_PAD>
__device__ __forceinline__ void simt_tile(const PrefillArgs& a, const KV& kv,
                                          const TileRows& w, int kh, int BQ,
                                          int valid) {
  const int H = a.H;
  const int G = H / a.K;
  const int R = G * BQ;  // rows r = g * BQ + i: head kh*G+g, tile row i
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  constexpr int BK = kSimtBK;
  constexpr int N = Vec<float>::N;
  constexpr int KS = D + 4;  // padded K row: conflict-free float4 row reads
  constexpr int PS = BK + 1;  // padded score row

  extern __shared__ __align__(16) float simt_smem[];
  float* q_sm = simt_smem;       // [R][D]
  float* k_sm = q_sm + R * D;    // [BK][KS]
  float* v_sm = k_sm + BK * KS;  // [BK][D]
  float* p_sm = v_sm + BK * D;   // [R][PS] scores, then p
  float* m_sm = p_sm + R * PS;   // [R]
  float* l_sm = m_sm + R;        // [R]
  float* a_sm = l_sm + R;        // [R]

  const int q_start = w.pos0;
  const int q_last = q_start + BQ - 1;
  const float* q = static_cast<const float*>(a.q);
  __syncthreads();  // a previous tile of this block is done with the smem

  for (int i = tid; i < R * (D / N); i += kSimtThreads) {
    const int r = i / (D / N), d = (i % (D / N)) * N;
    const int g = r / BQ, t = r % BQ;
    float x[N] = {0.f, 0.f, 0.f, 0.f};
    if (t < w.n)
      Vec<float>::load(
          q + ((w.row0 + t) * H + (size_t)kh * G + g) * D + d, x);
    *reinterpret_cast<float4*>(q_sm + r * D + d) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
  for (int r = tid; r < R; r += kSimtThreads) {
    m_sm[r] = kMaskValue;
    l_sm[r] = 0.f;
  }

  // Score tile of a thread: 2 rows x 4 keys (rows rg, rg+RG; keys cg +
  // j*CG), reading q and K as float4 along D.
  constexpr int CG = BK / 4, RG = kSimtThreads / CG;
  const int cg = tid % CG, rg = tid / CG;
  // Output tile of a thread: TR rows x 8 columns (two float4 runs, at
  // d0 and D/2 + d0, so neighbouring threads read neighbouring words).
  constexpr int CGV = D / 8, RGV = kSimtThreads / CGV, TR = kSimtRows / RGV;
  const int cgv = tid % CGV, rgv = tid / CGV;
  const int d0 = cgv * 4, d1 = D / 2 + cgv * 4;
  float acc[TR][8];
#pragma unroll
  for (int j = 0; j < TR; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;

  // _prefill_blk_bounds at sub-block granularity: from the window's first
  // position to the tile's causal/valid frontier `end`. A tile whose first
  // row is at or past kv_valid holds only bucket padding: it reads nothing.
  const int end = q_start < valid ? min(q_last + 1, valid) : 0;
  const int lo = a.window > 0 ? max(0, q_start - a.window + 1) : 0;
  __syncthreads();

  for (int kv0 = lo / BK * BK; kv0 < end; kv0 += BK) {
    simt_stage<KV, D, BITS>(a, kv, kv0, end, k_sm, v_sm);
    __syncthreads();

    {
      float s[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
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
      for (int h = 0; h < 2; ++h) {
        const int r = rg + h * RG;
        if (r < R) {
          const int q_pos = q_start + r % BQ;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = cg + c * CG;
            const int pos = kv0 + col;
            const bool keep = pos <= q_pos && pos < valid &&
                              (a.window <= 0 || pos > q_pos - a.window);
            p_sm[r * PS + col] =
                keep ? apply_softcap(s[h][c], a.softcap) : kMaskValue;
          }
        }
      }
    }
    __syncthreads();

    for (int r = warp; r < R; r += kSimtWarps) {
      const float s = p_sm[r * PS + lane];
      const float m_prev = m_sm[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = kv0 + lane < end ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      p_sm[r * PS + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_sm[r] = alpha;
        l_sm[r] = l_sm[r] * alpha + sum;
        m_sm[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int h = 0; h < TR; ++h) {
      const float alpha = a_sm[min(rgv + h * RGV, R - 1)];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[h][e] *= alpha;
    }
    for (int c = 0; c < BK; ++c) {
      const float4 v0 = *reinterpret_cast<const float4*>(v_sm + c * D + d0);
      const float4 v1 = *reinterpret_cast<const float4*>(v_sm + c * D + d1);
#pragma unroll
      for (int h = 0; h < TR; ++h) {
        const float p = p_sm[min(rgv + h * RGV, R - 1) * PS + c];
        acc[h][0] += p * v0.x; acc[h][1] += p * v0.y;
        acc[h][2] += p * v0.z; acc[h][3] += p * v0.w;
        acc[h][4] += p * v1.x; acc[h][5] += p * v1.y;
        acc[h][6] += p * v1.z; acc[h][7] += p * v1.w;
      }
    }
    __syncthreads();
  }

  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int h = 0; h < TR; ++h) {
    const int r = rgv + h * RGV;
    const int t = r % BQ;
    if (r < R && t < w.n) {
      const bool pad = ZERO_PAD && q_start + t >= valid;
      const float inv = pad ? 0.f : 1.f / fmaxf(l_sm[r], 1e-30f);
      float* o = out + ((w.row0 + t) * H + (size_t)kh * G + r / BQ) * D;
      *reinterpret_cast<float4*>(o + d0) =
          make_float4(acc[h][0] * inv, acc[h][1] * inv, acc[h][2] * inv,
                      acc[h][3] * inv);
      *reinterpret_cast<float4*>(o + d1) =
          make_float4(acc[h][4] * inv, acc[h][5] * inv, acc[h][6] * inv,
                      acc[h][7] * inv);
    }
  }
}

// Grid (q tile of BQ chunk rows, kv head, batch row).
template <class KV, int D, int BITS>
__global__ void __launch_bounds__(kSimtThreads)
prefill_simt_kernel(const PrefillArgs a, int BQ) {
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const KV kv(a, b, kh);
  const int t0 = blockIdx.x * BQ;
  const TileRows w{(size_t)b * a.Tq + t0, a.offsets[b] + t0,
                   min(BQ, a.Tq - t0)};
  simt_tile<KV, D, BITS, KV::kZeroPadRows>(a, kv, w, kh, BQ,
                                           kv.clamp_valid(a.kv_valid[b]));
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core body.

constexpr int kTcRows = 64;       // query rows per consumer warpgroup
constexpr int kTcConsumers = 2;   // consumer warpgroups per block
constexpr int kTcThreads = 128 * (kTcConsumers + 1);
constexpr int kTcBK = 64;         // keys per staged tile
// A barrier wait this long (~9 s) means a broken pipeline: trap, so the
// launch fails and the next synchronisation raises, instead of hanging.
constexpr long long kWaitTrapCycles = 1ll << 34;

template <int D>
struct TcShape {
  static constexpr int kStages = D >= 256 ? 2 : 3;
  static constexpr int kQBytes = kTcConsumers * kTcRows * D * 2;
  static constexpr int kTileBytes = kTcBK * D * 2;  // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  // + mbarriers, + slack to align the tiles to 1024 bytes (the swizzle's
  // period)
  static constexpr int kBytes =
      kQBytes + kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

// setmaxnreg split of a block's 384 x 168 registers: the producer gives
// registers up (more for the dequantizing producer), the consumers take them.
template <int BITS>
struct TcRegs {
  static constexpr int kProducer = BITS == kBitsNone ? 40 : 72;
  static constexpr int kConsumer = BITS == kBitsNone ? 232 : 216;
  static_assert(128 * kProducer + 128 * kTcConsumers * kConsumer <=
                    kTcThreads * 168,
                "setmaxnreg split exceeds the block's registers");
};

inline size_t tc_smem_bytes(int D) {
  switch (D) {
    case 64: return TcShape<64>::kBytes;
    case 128: return TcShape<128>::kBytes;
    case 256: return TcShape<256>::kBytes;
  }
  return 0;
}

// Dynamic shared memory of a launch at (G, D, T), whichever body its dtype
// takes: the gates decline by it.
inline size_t prefill_smem_bytes(int G, int D, int T) {
  const size_t simt = simt_smem_bytes(G, D, T), tc = tc_smem_bytes(D);
  return simt > tc ? simt : tc;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > kWaitTrapCycles) __trap();
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy (wgmma) reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}


template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving register accesses across the asynchronous
// MMAs that read or write them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Tiles of 64 rows x D bf16 columns (Q, K, V) are stored in wgmma's
// 128-byte-swizzled layout: atoms of 64 columns (64 rows x 128 bytes = 8
// KB, 1024-byte aligned), the 16-byte chunk c of row r at chunk (c ^ r) % 8
// of the row. A warp moves two to four whole rows (D/8 chunks each) per
// copy - row-contiguous reads of device memory - and its shared-memory
// stores hit every bank once.
constexpr int kTileRows = 64;
constexpr int kAtomBytes = kTileRows * 128;
static_assert(kTcRows == kTileRows && kTcBK == kTileRows,
              "Q, K and V tiles are 64 rows");

__device__ __forceinline__ int sw128_offset(int r, int c) {
  return (c >> 3) * kAtomBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma descriptor of a 128-byte-swizzled operand at shared address
// `addr`: lbo and sbo are the byte strides of its atoms along the
// leading dimension and of its 8-row groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand (Q as A, K as B of S = Q.K^T), its k16 slice kk: atom kk
// / 4, 32 bytes further per slice inside the atom.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * kAtomBytes + (kk & 3) * 32, 16, 1024);
}

// MN-major operand (V as the transposed B of O += P.V), keys 16kk .. 16kk
// + 15: 16 rows of 128 bytes further per slice, N's atoms kAtomBytes apart.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 16 * 128, kAtomBytes, 1024);
}

#define RT_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define RT_D16(i) RT_D4(i), RT_D4(i + 4), RT_D4(i + 8), RT_D4(i + 12)
#define RT_D32(i) RT_D16(i), RT_D16(i + 16)

// S[64 x 64] = (scale_d ? S : 0) + A[64 x 16] * B[16 x 64]; A and B K-major
// in shared memory (descriptors a, b).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RT_D32(0)
      : "l"(a), "l"(b), "r"(scale_d));
}

// O[64 x N] += A[64 x 16] * B[16 x N] with A (p, bf16) in registers and B
// the transposed (MN-major) operand in shared memory: wgmma_rs_nN.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RT_D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : RT_D32(0), RT_D32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : RT_D32(0), RT_D32(32), RT_D32(64), RT_D32(96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef RT_D32
#undef RT_D16
#undef RT_D4

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 64) {
    wgmma_rs_n64(d, a, b);
  } else if constexpr (D == 128) {
    wgmma_rs_n128(d, a, b);
  } else {
    wgmma_rs_n256(d, a, b);
  }
}

// 2^x on the special-function unit (flushing denormals, as the softmax of
// the flash kernels does); exp2f's slower path handles denormal results.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The producer warpgroup: key tiles n_lo .. n_lo + n_kv - 1 into the stage
// ring. bf16 tiles arrive by cp.async; a stage is signalled full once its
// copies have landed (the next tile's copies already in flight) and been
// fenced for wgmma. Quantized tiles are dequantized in registers.
template <class KV, int D, int BITS>
__device__ __forceinline__ void tc_producer(const PrefillArgs& a,
                                            const KV& kv, uint8_t* stages,
                                            uint32_t full0, uint32_t empty0,
                                            int n_lo, int n_kv, int end) {
  using S = TcShape<D>;
  const int pt = threadIdx.x - 128 * kTcConsumers;
  for (int it = 0; it < n_kv; ++it) {
    const int stage = it % S::kStages;
    const int k0 = (n_lo + it) * kTcBK;
    mbar_wait(empty0 + 8 * stage, ((it / S::kStages) & 1) ^ 1);
    uint8_t* k_sm = stages + stage * S::kStageBytes;
    uint8_t* v_sm = k_sm + S::kTileBytes;
    if constexpr (BITS == kBitsNone) {
      const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k);
      const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v);
      const uint32_t k_dst = smem_u32(k_sm), v_dst = smem_u32(v_sm);
#pragma unroll 4
      for (int i = pt; i < kTcBK * D / 8; i += 128) {
        const int row = i / (D / 8), c = i % (D / 8);
        const int pos = k0 + row;
        const bool load = pos < end;
        const size_t off = load ? kv.cell(pos) * D + 8 * c : 0;
        const int dst = sw128_offset(row, c);
        cp_async16(k_dst + dst, kp + off, load ? 16 : 0);
        cp_async16(v_dst + dst, vp + off, load ? 16 : 0);
      }
      cp_async_commit();
      if (it > 0) {
        cp_async_wait<1>();
        fence_async_smem();
        mbar_arrive(full0 + 8 * ((it - 1) % S::kStages));
      }
    } else {
      using Q = QuantRow<BITS, D>;
      for (int i = pt; i < kTcBK * Q::VR; i += 128) {
        const int row = i / Q::VR, v = i % Q::VR;
        const int pos = k0 + row;
        float kx[Q::EV], vx[Q::EV];
        if (pos < end) {
          const size_t cell = kv.cell(pos);
          uint4 raw;
          float sc;
          load_qvec<BITS, D>(static_cast<const int8_t*>(a.k), a.k_scale,
                             cell, v, a.SG, raw, sc);
          dequant16<__nv_bfloat16, BITS>(raw, sc, kx);
          load_qvec<BITS, D>(static_cast<const int8_t*>(a.v), a.v_scale,
                             cell, v, a.SG, raw, sc);
          dequant16<__nv_bfloat16, BITS>(raw, sc, vx);
        } else {
#pragma unroll
          for (int e = 0; e < Q::EV; ++e) kx[e] = vx[e] = 0.f;
        }
#pragma unroll
        for (int u = 0; u < Q::EV / 8; ++u) {
          const int dst = sw128_offset(row, (v * Q::EV) / 8 + u);
          const float* x = kx + 8 * u;
          const float* y = vx + 8 * u;
          *reinterpret_cast<uint4*>(k_sm + dst) =
              make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                         pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
          *reinterpret_cast<uint4*>(v_sm + dst) =
              make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]),
                         pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7]));
        }
      }
      fence_async_smem();
      mbar_arrive(full0 + 8 * stage);
    }
  }
  if constexpr (BITS == kBitsNone) {
    if (n_kv > 0) {
      cp_async_wait<0>();
      fence_async_smem();
      mbar_arrive(full0 + 8 * ((n_kv - 1) % S::kStages));
    }
  }
}

// One consumer warpgroup: 64 query rows (G heads x BQ chunk rows from
// chunk row tw0) against every staged tile, then the epilogue. Thread
// (warp w, lane) holds rows r0 = 16w + lane/4 and r1 = r0 + 8 of wgmma's
// accumulators: columns 8j + 2*(lane%4) + {0,1} in registers 4j + {0,1}
// (r0) and 4j + {2,3} (r1).
template <int D, bool ZERO_PAD>
__device__ __forceinline__ void tc_consumer(const PrefillArgs& a,
                                            uint8_t* q_sm, uint8_t* stages,
                                            uint32_t full0, uint32_t empty0,
                                            int n_lo, int n_kv,
                                            const TileRows& w, int kh, int BQ,
                                            int valid) {
  using S = TcShape<D>;
  constexpr float kLog2e = 1.4426950408889634f;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int G = a.H / a.K;
  const int window = a.window;
  const float softcap = a.softcap;

  // Q rows r = g * BQ + i: head kh*G + g, row i of `w`; rows past G * BQ
  // or past w.n are zeros.
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  for (int i = tid; i < kTcRows * D / 8; i += 128) {
    const int r = i / (D / 8), c = i % (D / 8);
    const int g = r / BQ, t = r % BQ;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < G * BQ && t < w.n)
      x = *reinterpret_cast<const uint4*>(
          q + ((w.row0 + t) * a.H + (size_t)kh * G + g) * D + 8 * c);
    *reinterpret_cast<uint4*>(q_sm + sw128_offset(r, c)) = x;
  }
  fence_async_smem();
  named_bar_sync(1 + wg, 128);

  // This warpgroup's real rows and their positions; `live` is false when
  // it has none, or only a bucket's pad rows.
  const int n_rows = w.n;
  const int wq_first = w.pos0, wq_last = w.pos0 + n_rows - 1;
  const bool live = n_rows > 0 && wq_first < valid;
  const int r0 = warp * 16 + lane / 4, r1 = r0 + 8;
  const int qpos0 = wq_first + r0 % BQ, qpos1 = wq_first + r1 % BQ;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = kMaskValue, m1 = kMaskValue, l0 = 0.f, l1 = 0.f;
  const uint32_t q_addr = smem_u32(q_sm);
  int pv_stage = -1;  // stage of the PV product in flight, if any

  for (int it = 0; it < n_kv; ++it) {
    const int stage = it % S::kStages;
    const int k0 = (n_lo + it) * kTcBK;
    mbar_wait(full0 + 8 * stage, (it / S::kStages) & 1);
    // Every cell masked for every row: past the causal or valid frontier,
    // or wholly below the window.
    const bool skip = !live || k0 > wq_last || k0 >= valid ||
                      (window > 0 && k0 + kTcBK - 1 <= wq_first - window);
    const uint32_t k_addr = smem_u32(stages + stage * S::kStageBytes);
    const uint32_t v_addr = k_addr + S::kTileBytes;
    float s[32];
    if (!skip) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s, kmajor_desc(q_addr, kk), kmajor_desc(k_addr, kk), kk);
      wgmma_commit();
    }
    // The previous tile's PV product ran under this tile's S product being
    // issued; wait for it (groups complete in order), then free its stage.
    // Only with three stages or more: the producer signals a tile once it
    // has issued the next, into the stage this warpgroup would still hold.
    if (pv_stage >= 0) {
      if (skip) {
        wgmma_wait<0>();
      } else {
        wgmma_wait<1>();
      }
      fence_regs(o);
      mbar_arrive(empty0 + 8 * pv_stage);
      pv_stage = -1;
    }
    if (skip) {
      mbar_arrive(empty0 + 8 * stage);
    } else {
      wgmma_wait<0>();
      fence_regs(s);

      if (softcap > 0.f) {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = softcap * tanhf(s[i] / softcap);
      }
      // Only a tile crossing the causal, valid or window edge of these
      // rows evaluates the mask.
      const bool edge = !(k0 + kTcBK - 1 <= wq_first && k0 + kTcBK <= valid &&
                          (window <= 0 || k0 > wq_last - window));
      if (edge) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int pos = k0 + 8 * j + 2 * quad + e;
            const bool in = pos < valid;
            const bool keep0 = in && pos <= qpos0 &&
                               (window <= 0 || pos > qpos0 - window);
            const bool keep1 = in && pos <= qpos1 &&
                               (window <= 0 || pos > qpos1 - window);
            s[4 * j + e] = keep0 ? s[4 * j + e] : kMaskValue;
            s[4 * j + 2 + e] = keep1 ? s[4 * j + 2 + e] : kMaskValue;
          }
        }
      }
      float mx0 = kMaskValue, mx1 = kMaskValue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float alpha0 = ex2((m0 - mn0) * kLog2e);
      const float alpha1 = ex2((m1 - mn1) * kLog2e);
      const bool rescale = __any_sync(0xffffffffu, mn0 != m0 || mn1 != m1);
      m0 = mn0;
      m1 = mn1;
      // exp(s - m) = 2^(s log2e - m log2e) in one FFMA per cell; a row
      // still at the mask value (every cell so far masked) gets 0 for its
      // masked cells instead of 1, which the row's first real score wipes
      // out (alpha = 0) either way.
      const float ml0 = mn0 == kMaskValue ? 0.f : mn0 * kLog2e;
      const float ml1 = mn1 == kMaskValue ? 0.f : mn1 * kLog2e;
      // p: exp(s - m) (cells past kv_valid 0), summed unrounded into l and
      // rounded to bf16 as the PV product's A operand: keys 16kk.. of
      // register block kk are s[8kk .. 8kk + 7].
      uint32_t pa[4][4];
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = !edge || k0 + 8 * j + 2 * quad + e < valid;
          p[e] = in ? ex2(fmaf(s[4 * j + e], kLog2e, -ml0)) : 0.f;
          p[2 + e] = in ? ex2(fmaf(s[4 * j + 2 + e], kLog2e, -ml1)) : 0.f;
        }
        sum0 += p[0] + p[1];
        sum1 += p[2] + p[3];
        pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
      if (rescale) {  // no row of the warp moved its max: alpha is 1
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= alpha0;
          o[4 * j + 1] *= alpha0;
          o[4 * j + 2] *= alpha1;
          o[4 * j + 3] *= alpha1;
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk)
        wgmma_rs<D>(o, pa[kk], mnmajor_desc(v_addr, kk));
      wgmma_commit();
      if constexpr (S::kStages > 2) {
        pv_stage = stage;
      } else {
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(empty0 + 8 * stage);
      }
    }
  }
  if (pv_stage >= 0) {
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(empty0 + 8 * pv_stage);
  }

#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? r1 : r0;
    const int t = r % BQ;
    if (r >= G * BQ || t >= w.n) continue;
    const int q_pos = h ? qpos1 : qpos0;
    const bool zero = !live || (ZERO_PAD && q_pos >= valid);
    const float inv = zero ? 0.f : 1.f / fmaxf(h ? l1 : l0, 1e-30f);
    __nv_bfloat16* row =
        out + ((w.row0 + t) * a.H + (size_t)kh * G + r / BQ) * D + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
  }
}

// The dynamic shared memory of the tensor-core body, aligned to 1024 bytes
// (the swizzle's period).
__device__ __forceinline__ uint8_t* tc_smem_base() {
  extern __shared__ __align__(16) uint8_t tc_raw[];
  const uint32_t raw = smem_u32(tc_raw);
  return tc_raw + (((raw + 1023) & ~1023u) - raw);
}

// One block of the tensor-core body: the rows of `tile` (at most
// kTcConsumers * BQ, BQ per consumer warpgroup) of kv head kh's G query
// heads, against the key tiles from the window's first position to the
// tile's causal/valid frontier (_prefill_blk_bounds' walk); none when the
// tile holds only pad rows. Every thread of the block calls it.
template <class KV, int D, int BITS, bool ZERO_PAD>
__device__ __forceinline__ void tc_tile(const PrefillArgs& a, const KV& kv,
                                        const TileRows& tile, int kh, int BQ,
                                        int valid) {
  using S = TcShape<D>;
  uint8_t* tc_smem = tc_smem_base();
  const int q_first = tile.pos0;
  const int q_last = tile.pos0 + tile.n - 1;
  const int end = q_first < valid ? min(q_last + 1, valid) : 0;
  const int n_lo = (a.window > 0 ? max(0, q_first - a.window + 1) : 0) /
                   kTcBK;
  const int n_kv = end > 0 ? (end - 1) / kTcBK - n_lo + 1 : 0;

  uint8_t* q_sm = tc_smem;
  uint8_t* stages = tc_smem + S::kQBytes;
  const uint32_t full0 = smem_u32(stages + S::kStages * S::kStageBytes);
  const uint32_t empty0 = full0 + 8 * S::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full0 + 8 * s, 128);
      mbar_init(empty0 + 8 * s, 128 * kTcConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kTcConsumers) {
    setmaxnreg_dec<TcRegs<BITS>::kProducer>();
    tc_producer<KV, D, BITS>(a, kv, stages, full0, empty0, n_lo, n_kv, end);
  } else {
    setmaxnreg_inc<TcRegs<BITS>::kConsumer>();
    const int wg = threadIdx.x / 128;
    const TileRows w{tile.row0 + (size_t)wg * BQ, tile.pos0 + wg * BQ,
                     min(BQ, tile.n - wg * BQ)};
    tc_consumer<D, ZERO_PAD>(a, q_sm + wg * kTcRows * D * 2, stages, full0,
                             empty0, n_lo, n_kv, w, kh, BQ, valid);
  }
}

// Grid: one block per (q tile, kv head, batch row), q tiles of
// kTcConsumers * BQ chunk rows, heaviest (last) tile first.
template <class KV, int D, int BITS>
__global__ void __launch_bounds__(kTcThreads, 1)
prefill_tc_kernel(const PrefillArgs a, int BQ, int n_tiles) {
  const int per_tile = a.K * a.B;
  const int tile = n_tiles - 1 - (int)(blockIdx.x / per_tile);
  const int kh = blockIdx.x % a.K;
  const int b = (blockIdx.x / a.K) % a.B;
  const KV kv(a, b, kh);
  const int t0 = tile * kTcConsumers * BQ;
  const TileRows rows{(size_t)b * a.Tq + t0, a.offsets[b] + t0,
                      min(t0 + kTcConsumers * BQ, a.Tq) - t0};
  tc_tile<KV, D, BITS, KV::kZeroPadRows>(a, kv, rows, kh, BQ,
                                         kv.clamp_valid(a.kv_valid[b]));
}

// Launches one prefill on `stream`: the tensor-core body for bf16, the
// CUDA-core body for f32. Returns a cudaError_t code.
template <class KV, typename T, int D, int BITS>
int launch_prefill(const PrefillArgs& a, cudaStream_t stream) {
  const int G = a.H / a.K;
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    const int bq = simt_bq(G, a.Tq);
    const size_t smem = simt_smem_bytes(G, D, a.Tq);
    auto kernel = prefill_simt_kernel<KV, D, BITS>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Tq + bq - 1) / bq, a.K, a.B);
    kernel<<<grid, kSimtThreads, smem, stream>>>(a, bq);
  } else {
    const int bq = kTcRows / G;
    const int n_tiles =
        (a.Tq + kTcConsumers * bq - 1) / (kTcConsumers * bq);
    const size_t smem = TcShape<D>::kBytes;
    auto kernel = prefill_tc_kernel<KV, D, BITS>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const long long blocks = (long long)n_tiles * a.K * a.B;
    if (blocks > 0x7fffffffll) return cudaErrorInvalidConfiguration;
    kernel<<<(unsigned)blocks, kTcThreads, smem, stream>>>(a, bq, n_tiles);
  }
  return cudaGetLastError();
}

}  // namespace rt
