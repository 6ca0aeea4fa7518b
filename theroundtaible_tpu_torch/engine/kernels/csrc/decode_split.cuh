// The split-KV decode body shared by K1 (paged_decode.cu), K9
// (ragged_decode.cu) and K3's decode items (ragged_paged.cu): one query
// position per work item against KV cells that an addressing policy
// locates (paged_common.cuh PagedKV / SlotKV); the item's q and output row
// is its batch row (BatchItem) or a row of K3's flat buffer.
//
// Counterpart of theroundtaible_tpu/engine/pallas/attention.py:631
// _decode_accumulate, which the TPU's contiguous (_decode_kernel) and paged
// (_paged_decode_kernel) decode kernels share: the two differ only in how a
// kv cell is addressed, so the math lives here once. q [B,1,H,D] is
// pre-scaled and rope'd; kv_valid [B] includes this step, so the query sits
// at position kv_valid - 1. Mask: kv_pos < kv_valid and, with a window,
// kv_pos > kv_valid - 1 - window. Scores in f32, softcap before the mask,
// the finite mask value kMaskValue, p rounded to the working type before
// the PV product, l summed from the unrounded p and floored at 1e-30 at the
// end. Cells at or past kv_valid are never loaded: a reused slot or a stale
// page holds another occupant's K/V (NaN included) there.
//
// Bound on this card: device-memory bytes. A row reads the K and V cells of
// its window for every kv head and does 4 * G operations per value read,
// far below the ~295 operations per byte the H100 needs before compute
// limits. What sets the pace is how many bytes are in flight: ~2.3 MB keep
// 3.35 TB/s busy at ~0.7 us of latency.
//
// Design: split-KV over fixed spans of absolute positions.
// - Split j covers positions [j * CHUNK, (j + 1) * CHUNK), aligned to
//   position 0. CHUNK is a compile-time constant of (dtype, D): 32 KB of K
//   (and 32 KB of V) per split - 128 positions in bf16 at D = 128. It never
//   depends on H, K, B, the pages or the cache length, so a kv head's
//   splits do the same work however many heads or rows a launch holds: a
//   rank's shard under K10a/K10b equals the one-device slice bit for bit,
//   and K1 and K9 give the same bits on the same cells.
// - Grid (kv head, row, split), 128 threads, the split index slowest so
//   that the live first splits of every row are dispatched first. The
//   split count comes from host-known shapes (the table's pp * ps, or the
//   cache length S); a block past its row's frontier, or wholly below its
//   window, exits at once. No host read of kv_valid: a launch can be
//   captured in a CUDA graph.
// - A live block issues every 16-byte cp.async of its split at once - K in
//   one group, V in a second - positions outside [window start, kv_valid)
//   zero-filled without a read, loads q while they fly, and works on K as
//   soon as it lands while V is still in flight. Quantized pools (K4) copy
//   the int8/int4 payload and the f32 scales the same way and dequantize
//   from shared memory into the working-type tile the products read
//   (paged_common.cuh dequant16, rounded to the working type), so the math
//   past it is the unquantized path's.
// - Products sized to G (1-16 query heads). bf16 (and quantized pools
//   under a bf16 q): mma.sync m16n8k16 with G padded to 16 rows - each warp
//   computes S = q.K^T for a quarter of the split's keys and O = P.V for a
//   quarter of D over all of them, so a split's products are 64 mma per
//   warp and no warp's partial sums meet another's. On the CUDA cores the
//   same products are a chain of ~2,000 dependent instructions per thread
//   at 1-3 warps per scheduler, which sets a split's latency (PERF.md
//   measures both). f32 keeps them (split_simt), exact (no TF32): one key
//   per thread (two at D = 64, two or four threads per key at D >= 128)
//   and all G heads for S, one warp per head for the softmax, key groups x
//   16-byte columns for O, the groups' partial sums added in a fixed
//   order.
// - Each live split writes its (m, l, acc[G][D]) in f32 to a workspace. A
//   second kernel, launched on the same stream by the same C entry as a
//   programmatic dependent (it may launch before the split kernel ends),
//   merges each (row, query head)'s live splits in ascending split order
//   (no float atomics: two identical calls give the same bits) and writes
//   the output in q's dtype. It recomputes the live splits from kv_valid,
//   the window and CHUNK exactly as the split kernel does.
#pragma once

#include <type_traits>

#include "paged_common.cuh"

namespace rt {

// One decode launch's operands. `index` is the page table [B, pp] (PagedKV)
// or the cache row of each batch row [B] (SlotKV); SG is the number of
// scale groups per cell of a quantized pool; ws is the f32 workspace of
// B * K * n_splits * G * (D + 2) floats.
struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* index;
  const int* kv_valid;
  void* out;
  float* ws;
  int B, H, K;
  int ps, pp;     // PagedKV; ps = 1 << ps_shift
  int ps_shift;
  int S, n_rows;  // SlotKV
  int window;
  float softcap;
  int SG;
  int n_splits;   // set by launch_decode
  // K3 (ragged_paged.cu): the flat buffer's per-block metadata; a decode
  // item of sequence b reads q and writes its output at its block's row.
  const int* seq_of_block;
  const int* block_qstart;
  const int* query_offsets;
  int n_blocks;
};

// Which row of q [rows,H,D] and of the output a work item b reads and
// writes, and whether b has work at all. K1/K9: batch row b, always
// (BatchItem); K3's decode items are found in its flat buffer
// (ragged_paged.cu RaggedItem). Every thread of a block constructs it.
struct BatchItem {
  size_t row;
  bool live;
  __device__ __forceinline__ BatchItem(const DecodeArgs&, int b)
      : row(b), live(true) {}
};

constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecHeads = 4;          // query heads per O = P.V pass
constexpr int kSplitBytes = 32768;    // bytes of K (and of V) per split

// Programmatic dependent launch (sm_90): the split kernel lets the combine
// launch early; the combine waits for the split grid's completion and
// memory before it reads the workspace.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The split of (T, D) and the CUDA-core (f32) body's layout.
template <typename T, int D>
struct DecShape {
  static constexpr int N = Vec<T>::N;   // elements per 16 bytes
  static constexpr int NV = D / N;      // 16-byte vectors per row
  static constexpr int CHUNK = kSplitBytes / (D * (int)sizeof(T));
  // S = q.K^T: threads per key and keys per thread.
  static constexpr int TPK = CHUNK >= kDecThreads ? 1 : kDecThreads / CHUNK;
  static constexpr int KPT = CHUNK >= kDecThreads ? CHUNK / kDecThreads : 1;
  // K rows padded by TPK vectors: the lanes of one 16-byte load phase read
  // distinct banks.
  static constexpr int KS = D + N * TPK;
  // O = P.V: key groups (a thread owns one 16-byte column of one group).
  static constexpr int KG = kDecThreads / NV;
  static_assert(NV % TPK == 0, "a key's vectors split evenly");
  static_assert(kDecThreads % NV == 0 && CHUNK % KG == 0, "PV layout");
  static_assert(KG * kDecHeads * D * 4 <= CHUNK * KS * (int)sizeof(T),
                "the PV partial sums fit in the K tile");
};

// The bf16 (tensor-core) body's layout: mma.sync m16n8k16 with the G query
// heads padded to 16 rows. Warp w computes S = q.K^T for keys
// [w * KW, (w + 1) * KW) of the split and O = P.V for columns
// [w * DW, (w + 1) * DW) over all its keys, so no warp's partial sums meet
// another's. K, V and P rows are padded by 16 bytes: the 8 rows of a
// fragment load fall in distinct banks.
template <int D>
struct MmaShape {
  static constexpr int CHUNK = DecShape<__nv_bfloat16, D>::CHUNK;
  static constexpr int KS = D + 8;                  // K and V rows
  static constexpr int PS = CHUNK + 8;              // P rows
  static constexpr int KW = CHUNK / kDecWarps;      // keys per warp (S)
  static constexpr int NT = KW / 8;                 // its n-tiles
  static constexpr int DW = D / kDecWarps;          // columns per warp (O)
  static constexpr int NTD = DW / 8;                // its n-tiles
  static_assert(KW % 8 == 0 && NTD % 2 == 0 && CHUNK % 16 == 0, "tiles");
};

// Dynamic shared memory of one split block (bytes). f32: the K and V tiles,
// q and the scores in f32, m and l. bf16: the K and V tiles, P in bf16,
// each warp's row maxima and sums (a quantized pool dequantizes V into the
// K tile once S is done, so it has no V tile). Quantized pools add the raw
// payload and scales of both.
template <typename T, int D>
inline size_t decode_smem_bytes(int G, int bits, int SG) {
  size_t bytes;
  if constexpr (std::is_same<T, float>::value) {
    using S = DecShape<T, D>;
    bytes = sizeof(T) * (size_t)S::CHUNK * (S::KS + D) +
            sizeof(float) * ((size_t)G * D + (size_t)G * S::CHUNK +
                             2 * kMaxGroup);
  } else {
    using M = MmaShape<D>;
    bytes = 2 * ((size_t)M::CHUNK * M::KS * (bits == kBitsNone ? 2 : 1) +
                 16 * M::PS) +
            sizeof(float) * 2 * kDecWarps * 16;
  }
  if (bits != kBitsNone)
    bytes += 2 * (size_t)DecShape<T, D>::CHUNK *
             (D * bits / 8 + sizeof(float) * SG);
  return bytes;
}

// This block's rows of positions [c0, c0 + CHUNK) of one pool into `dst`
// (row stride `stride`) by 16-byte cp.async; positions outside
// [first, last) zero-filled without a read.
template <class KV, typename T, int D>
__device__ __forceinline__ void stage_rows(const KV& kv, const void* pool,
                                           T* dst, int stride, int c0,
                                           int first, int last) {
  using S = DecShape<T, D>;
  const T* base = static_cast<const T*>(pool);
#pragma unroll 4
  for (int i = threadIdx.x; i < S::CHUNK * S::NV; i += kDecThreads) {
    const int c = i / S::NV, v = i % S::NV;
    const int pos = c0 + c;
    const uint32_t to = smem_u32(dst + c * stride + v * S::N);
    if (pos >= first && pos < last)
      cp_async16(to, base + kv.cell(pos) * D + v * S::N, 16);
    else
      cp_async16(to, base, 0);
  }
}

// K4: the payload vectors and scales of the same positions, raw.
template <class KV, typename T, int D, int BITS>
__device__ __forceinline__ void stage_qrows(const KV& kv, const void* pool,
                                            const float* scale, int SG,
                                            uint8_t* raw, float* sc, int c0,
                                            int first, int last) {
  using S = DecShape<T, D>;
  using Q = QuantRow<BITS, D>;
  const int8_t* base = static_cast<const int8_t*>(pool);
#pragma unroll 4
  for (int i = threadIdx.x; i < S::CHUNK * Q::VR; i += kDecThreads) {
    const int c = i / Q::VR, v = i % Q::VR;
    const int pos = c0 + c;
    const uint32_t to = smem_u32(raw + c * Q::DP + v * 16);
    if (pos >= first && pos < last)
      cp_async16(to, base + kv.cell(pos) * Q::DP + v * 16, 16);
    else
      cp_async16(to, base, 0);
  }
  for (int i = threadIdx.x; i < S::CHUNK * SG; i += kDecThreads) {
    const int c = i / SG, g = i % SG;
    const int pos = c0 + c;
    const uint32_t to = smem_u32(sc + i);
    if (pos >= first && pos < last)
      cp_async4(to, scale + kv.cell(pos) * SG + g, 4);
    else
      cp_async4(to, scale, 0);
  }
}

// K4: dequantize a staged split into the working-type tile (zero-filled
// cells have payload 0 and scale 0, so they stay 0).
template <typename T, int D, int BITS>
__device__ __forceinline__ void dequant_rows(const uint8_t* raw,
                                             const float* sc, int SG, T* dst,
                                             int stride) {
  using S = DecShape<T, D>;
  using Q = QuantRow<BITS, D>;
  constexpr int N = S::N;
  for (int i = threadIdx.x; i < S::CHUNK * Q::VR; i += kDecThreads) {
    const int c = i / Q::VR, v = i % Q::VR;
    const uint4 r = *reinterpret_cast<const uint4*>(raw + c * Q::DP + v * 16);
    float x[Q::EV];
    dequant16<T, BITS>(r, sc[c * SG + (v * Q::EV) / (D / SG)], x);
    T* out = dst + c * stride + v * Q::EV;
#pragma unroll
    for (int e = 0; e < Q::EV; e += N) {
      alignas(16) T pack[N];
#pragma unroll
      for (int u = 0; u < N; ++u) pack[u] = from_f32<T>(x[e + u]);
      *reinterpret_cast<uint4*>(out + e) =
          *reinterpret_cast<const uint4*>(pack);
    }
  }
}

// The window's first position and the frontier of row b: cells [lo, end)
// are attended. Split j is live iff it overlaps them.
struct DecodeRow {
  int valid, end, lo;
  template <class KV>
  __device__ __forceinline__ DecodeRow(const DecodeArgs& a, const KV& kv,
                                       int b)
      : valid(a.kv_valid[b]),
        end(kv.clamp_valid(valid)),
        lo(a.window > 0 ? max(0, valid - a.window) : 0) {}
};

// The positions a live split loads: [first, last) of [c0, c0 + CHUNK).
struct Span {
  int c0, first, last;
};

// Stages a split: K (cp.async group 1), then V (group 2) - their payload and
// scales on a quantized pool. Returns with every copy in flight.
template <class KV, typename T, int D, int BITS>
__device__ __forceinline__ void stage_split(const DecodeArgs& a, const KV& kv,
                                            const Span& sp, T* k_sm,
                                            T* v_sm, int ks, int vs,
                                            uint8_t* raw) {
  constexpr int CHUNK = DecShape<T, D>::CHUNK;
  if constexpr (BITS == kBitsNone) {
    stage_rows<KV, T, D>(kv, a.k, k_sm, ks, sp.c0, sp.first, sp.last);
    cp_async_commit();
    stage_rows<KV, T, D>(kv, a.v, v_sm, vs, sp.c0, sp.first, sp.last);
    cp_async_commit();
  } else {
    constexpr int DP = QuantRow<BITS, D>::DP;
    float* ksc = reinterpret_cast<float*>(raw + 2 * CHUNK * DP);
    stage_qrows<KV, T, D, BITS>(kv, a.k, a.k_scale, a.SG, raw, ksc, sp.c0,
                                sp.first, sp.last);
    cp_async_commit();
    stage_qrows<KV, T, D, BITS>(kv, a.v, a.v_scale, a.SG, raw + CHUNK * DP,
                                ksc + CHUNK * a.SG, sp.c0, sp.first,
                                sp.last);
    cp_async_commit();
  }
}

// K4: the staged K (v = false) or V (v = true) payload, dequantized.
template <typename T, int D, int BITS>
__device__ __forceinline__ void dequant_split(const DecodeArgs& a,
                                              const uint8_t* raw, bool v,
                                              T* dst, int stride) {
  constexpr int CHUNK = DecShape<T, D>::CHUNK;
  constexpr int DP = QuantRow<BITS, D>::DP;
  const float* sc = reinterpret_cast<const float*>(raw + 2 * CHUNK * DP);
  dequant_rows<T, D, BITS>(raw + (v ? CHUNK * DP : 0),
                           sc + (v ? CHUNK * a.SG : 0), a.SG, dst, stride);
}

// f32: the CUDA-core body. S = q.K^T gives each thread one key (two at
// D = 64, two or four threads per key at D >= 128) and all G heads, K read
// once from shared memory per key; the softmax takes one warp per head;
// O = P.V splits the keys into groups across the block and D across lanes
// in 16-byte columns, four heads per pass, the groups' partial sums added
// in a fixed order. No TF32: f32 stays exact.
template <class KV, int D, int BITS>
__device__ __forceinline__ void split_simt(const DecodeArgs& a, const KV& kv,
                                           size_t row, int kh, const Span& sp,
                                           size_t split) {
  using T = float;
  using S = DecShape<T, D>;
  constexpr int N = S::N, NV = S::NV, CHUNK = S::CHUNK, TPK = S::TPK,
                KPT = S::KPT, KS = S::KS, KG = S::KG;
  const int c0 = sp.c0, first = sp.first, last = sp.last;
  const int G = a.H / a.K;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_sm = reinterpret_cast<T*>(smem);                    // [CHUNK][KS]
  T* v_sm = k_sm + CHUNK * KS;                             // [CHUNK][D]
  float* q_sm = reinterpret_cast<float*>(v_sm + CHUNK * D);  // [G][D]
  float* p_sm = q_sm + G * D;               // [G][CHUNK] scores, then p
  float* m_sm = p_sm + G * CHUNK;           // [kMaxGroup]
  float* l_sm = m_sm + kMaxGroup;           // [kMaxGroup]
  uint8_t* raw = reinterpret_cast<uint8_t*>(l_sm + kMaxGroup);

  stage_split<KV, T, D, BITS>(a, kv, sp, k_sm, v_sm, KS, D, raw);
  // GQA: query head h reads kv head h / G, so this block's heads are
  // kh*G .. kh*G+G-1.
  const T* q = static_cast<const T*>(a.q) + (row * a.H + (size_t)kh * G) * D;
  for (int i = tid; i < G * D; i += kDecThreads) q_sm[i] = q[i];
  cp_async_wait<1>();
  __syncthreads();
  if constexpr (BITS != kBitsNone) {
    dequant_split<T, D, BITS>(a, raw, false, k_sm, KS);
    __syncthreads();
  }
  // S = q.K^T: key c of this thread (TPK threads per key, each a strided
  // share of its vectors), all G heads; masked cells take kMaskValue after
  // the softcap.
  {
    const int part = tid % TPK, key0 = tid / TPK;
#pragma unroll 1
    for (int kk = 0; kk < KPT; ++kk) {
      const int c = key0 + kk * (kDecThreads / TPK);
      const T* kr = k_sm + c * KS;
      float s[kMaxGroup];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) s[g] = 0.f;
#pragma unroll 2
      for (int vi = 0; vi < NV / TPK; ++vi) {
        const int v = vi * TPK + part;
        float kx[N];
        Vec<T>::load(kr + v * N, kx);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < G) {
            const float4* qg =
                reinterpret_cast<const float4*>(q_sm + g * D + v * N);
#pragma unroll
            for (int e = 0; e < N; e += 4) {
              const float4 qv = qg[e / 4];
              s[g] += qv.x * kx[e] + qv.y * kx[e + 1] + qv.z * kx[e + 2] +
                      qv.w * kx[e + 3];
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
        for (int o = 1; o < TPK; o <<= 1)
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
      }
      const int pos = c0 + c;
      const bool live = pos >= first && pos < last;
      if (part == 0) {
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < G)
            p_sm[g * CHUNK + c] =
                live ? apply_softcap(s[g], a.softcap) : kMaskValue;
      }
    }
  }
  __syncthreads();

  // Softmax of the split's scores, one warp per head: m, l (unrounded p),
  // and p rounded to the working type in place.
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int g = warp; g < G; g += kDecWarps) {
      float* srow = p_sm + g * CHUNK;
      float mx = kMaskValue;
#pragma unroll
      for (int c = lane; c < CHUNK; c += 32) mx = fmaxf(mx, srow[c]);
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int c = lane; c < CHUNK; c += 32) {
        const float p = expf(srow[c] - mx);
        sum += p;
        srow[c] = round_to<T>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        m_sm[g] = mx;
        l_sm[g] = sum;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (BITS != kBitsNone) {
    dequant_split<T, D, BITS>(a, raw, true, v_sm, D);
    __syncthreads();
  }

  // O = P.V: column vc (16 bytes) of key group kg, kDecHeads heads per
  // pass; the groups' partial sums meet in the (now free) K tile and are
  // added in group order.
  float* ws_acc = a.ws + split * G * D;
  float* red = reinterpret_cast<float*>(smem);  // [KG][kDecHeads][D]
  const int vc = tid % NV, kg = tid / NV;
  for (int g0 = 0; g0 < G; g0 += kDecHeads) {
    float acc[kDecHeads][N];
#pragma unroll
    for (int h = 0; h < kDecHeads; ++h)
#pragma unroll
      for (int e = 0; e < N; ++e) acc[h][e] = 0.f;
#pragma unroll 4
    for (int i = 0; i < CHUNK / KG; ++i) {
      const int c = kg + i * KG;
      float vx[N];
      Vec<T>::load(v_sm + c * D + vc * N, vx);
#pragma unroll
      for (int h = 0; h < kDecHeads; ++h) {
        if (g0 + h < G) {
          const float p = p_sm[(g0 + h) * CHUNK + c];
#pragma unroll
          for (int e = 0; e < N; ++e) acc[h][e] += p * vx[e];
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kDecHeads; ++h) {
      float4* dst = reinterpret_cast<float4*>(
          red + (kg * kDecHeads + h) * D + vc * N);
#pragma unroll
      for (int e = 0; e < N; e += 4)
        dst[e / 4] = make_float4(acc[h][e], acc[h][e + 1], acc[h][e + 2],
                                 acc[h][e + 3]);
    }
    __syncthreads();
    for (int i = tid; i < kDecHeads * D; i += kDecThreads) {
      const int h = i / D, d = i % D;
      if (g0 + h < G) {
        float sum = 0.f;
#pragma unroll
        for (int k2 = 0; k2 < KG; ++k2)
          sum += red[(k2 * kDecHeads + h) * D + d];
        ws_acc[(g0 + h) * D + d] = sum;
      }
    }
    __syncthreads();
  }
  if (tid < G) {
    float* ws_ml = a.ws + (size_t)a.B * a.K * a.n_splits * G * D;
    reinterpret_cast<float2*>(ws_ml)[split * G + tid] =
        make_float2(m_sm[tid], l_sm[tid]);
  }
}


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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bf16: the tensor-core body (MmaShape). Lane (gid = lane / 4, tig =
// lane % 4) of an m16n8k16 fragment holds rows gid and gid + 8 - query heads
// kh*G + gid (+ 8); rows past G are zero and never written.
// - S = q.K^T: the A fragments of q straight from device memory into
//   registers (loaded while K lands), B from the K tile's rows, f32 sums.
// - The split's row max and sum (of the unrounded p) meet across the four
//   warps in shared memory, added in warp order; p rounded to bf16 is
//   written to the P tile.
// - O = P.V: A by ldmatrix from P, B by ldmatrix.trans from the V tile;
//   each warp writes its columns of the f32 partial sums straight to the
//   workspace.
template <class KV, int D, int BITS>
__device__ __forceinline__ void split_mma(const DecodeArgs& a, const KV& kv,
                                          size_t row, int kh, const Span& sp,
                                          size_t split) {
  using T = __nv_bfloat16;
  using M = MmaShape<D>;
  constexpr int CHUNK = M::CHUNK, KS = M::KS, PS = M::PS, KW = M::KW,
                NT = M::NT, DW = M::DW, NTD = M::NTD;
  const int G = a.H / a.K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_sm = reinterpret_cast<T*>(smem);                    // [CHUNK][KS]
  // A quantized pool's V is dequantized into the K tile once S is done.
  T* v_sm = BITS == kBitsNone ? k_sm + CHUNK * KS : k_sm;  // [CHUNK][KS]
  T* p_sm = k_sm + CHUNK * KS * (BITS == kBitsNone ? 2 : 1);  // [16][PS]
  float* row_max = reinterpret_cast<float*>(p_sm + 16 * PS);  // [4][16]
  float* row_sum = row_max + kDecWarps * 16;                  // [4][16]
  uint8_t* raw = reinterpret_cast<uint8_t*>(row_sum + kDecWarps * 16);

  stage_split<KV, T, D, BITS>(a, kv, sp, k_sm, v_sm, KS, KS, raw);
  // q's A fragments: rows gid and gid + 8 of this kv head's G heads.
  const uint32_t* q = reinterpret_cast<const uint32_t*>(
      static_cast<const T*>(a.q) + (row * a.H + (size_t)kh * G) * D);
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int w = (kk * 16 + tig * 2) / 2;
    qa[kk][0] = gid < G ? q[gid * D / 2 + w] : 0u;
    qa[kk][1] = gid + 8 < G ? q[(gid + 8) * D / 2 + w] : 0u;
    qa[kk][2] = gid < G ? q[gid * D / 2 + w + 4] : 0u;
    qa[kk][3] = gid + 8 < G ? q[(gid + 8) * D / 2 + w + 4] : 0u;
  }
  cp_async_wait<1>();
  __syncthreads();
  if constexpr (BITS != kBitsNone) {
    dequant_split<T, D, BITS>(a, raw, false, k_sm, KS);
    __syncthreads();
  }

  // S = q.K^T over this warp's keys.
  float s[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const T* kr = k_sm + (warp * KW + nt * 8 + gid) * KS + kk * 16 + tig * 2;
      mma_bf16(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
               *reinterpret_cast<const uint32_t*>(kr + 8));
    }
  }
  // Softcap, mask, and the row maxima of this warp's keys.
  float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pos = sp.c0 + warp * KW + nt * 8 + tig * 2 + (e & 1);
      s[nt][e] = pos >= sp.first && pos < sp.last
                     ? apply_softcap(s[nt][e], a.softcap)
                     : kMaskValue;
      mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  if (tig == 0) {
    row_max[warp * 16 + gid] = mx[0];
    row_max[warp * 16 + gid + 8] = mx[1];
  }
  __syncthreads();
  float m[2] = {kMaskValue, kMaskValue};
#pragma unroll
  for (int w = 0; w < kDecWarps; ++w) {
    m[0] = fmaxf(m[0], row_max[w * 16 + gid]);
    m[1] = fmaxf(m[1], row_max[w * 16 + gid + 8]);
  }
  // p = exp(s - m): summed unrounded, stored rounded to bf16.
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float pr[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pr[e] = expf(s[nt][e] - m[e / 2]);
      l[e / 2] += pr[e];
    }
    const int c = warp * KW + nt * 8 + tig * 2;
    *reinterpret_cast<uint32_t*>(p_sm + gid * PS + c) =
        pack_bf16x2(pr[0], pr[1]);
    *reinterpret_cast<uint32_t*>(p_sm + (gid + 8) * PS + c) =
        pack_bf16x2(pr[2], pr[3]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (tig == 0) {
    row_sum[warp * 16 + gid] = l[0];
    row_sum[warp * 16 + gid + 8] = l[1];
  }
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (BITS != kBitsNone) {
    dequant_split<T, D, BITS>(a, raw, true, v_sm, KS);
    __syncthreads();
  }

  // O = P.V over all the split's keys, this warp's columns.
  float o[NTD][4];
#pragma unroll
  for (int nt = 0; nt < NTD; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  const int d0 = warp * DW;
#pragma unroll 4
  for (int kk = 0; kk < CHUNK / 16; ++kk) {
    uint32_t pa[4];
    ldmatrix_x4(pa, smem_u32(p_sm + (lane % 16) * PS + kk * 16 +
                             (lane / 16) * 8));
#pragma unroll
    for (int np = 0; np < NTD / 2; ++np) {
      const int mi = lane / 8, r = lane % 8;
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, smem_u32(v_sm + (kk * 16 + (mi & 1) * 8 + r) * KS +
                                     d0 + np * 16 + (mi >> 1) * 8));
      mma_bf16(o[2 * np], pa, vb[0], vb[1]);
      mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
    }
  }
  float* ws_acc = a.ws + split * G * D;
#pragma unroll
  for (int nt = 0; nt < NTD; ++nt) {
    const int d = d0 + nt * 8 + tig * 2;
    if (gid < G)
      *reinterpret_cast<float2*>(ws_acc + gid * D + d) =
          make_float2(o[nt][0], o[nt][1]);
    if (gid + 8 < G)
      *reinterpret_cast<float2*>(ws_acc + (gid + 8) * D + d) =
          make_float2(o[nt][2], o[nt][3]);
  }
  if (tid < G) {
    float mm = kMaskValue, ll = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      mm = fmaxf(mm, row_max[w * 16 + tid]);
      ll += row_sum[w * 16 + tid];
    }
    float* ws_ml = a.ws + (size_t)a.B * a.K * a.n_splits * G * D;
    reinterpret_cast<float2*>(ws_ml)[split * G + tid] = make_float2(mm, ll);
  }
}

// Grid (kv head, row, split): split j's (m, l, acc) of kv head kh's G query
// heads of row b into the workspace. The split index varies slowest, so the
// blocks of the first splits - live for every row - are dispatched first
// and the dead tail of the grid last.
template <class KV, class Item, typename T, int D, int BITS>
__global__ void __launch_bounds__(kDecThreads)
decode_split_kernel(const DecodeArgs a) {
  // The combine may launch once every block has started; it waits for
  // this grid to finish.
  griddep_launch_dependents();
  constexpr int CHUNK = DecShape<T, D>::CHUNK;
  const int kh = blockIdx.x, b = blockIdx.y, j = blockIdx.z;
  const KV kv(a, b, kh);
  const DecodeRow row(a, kv, b);
  const int c0 = j * CHUNK;
  if (c0 >= row.end || c0 + CHUNK <= row.lo) return;
  const Item item(a, b);
  if (!item.live) return;
  const Span sp{c0, max(c0, row.lo), min(c0 + CHUNK, row.end)};
  const size_t split = ((size_t)b * a.K + kh) * a.n_splits + j;
  if constexpr (std::is_same<T, float>::value)
    split_simt<KV, D, BITS>(a, kv, item.row, kh, sp, split);
  else
    split_mma<KV, D, BITS>(a, kv, item.row, kh, sp, split);
}

// Grid (query head of the group, kv head, row): the live splits' partials
// of query head kh * G + g of row b, merged in ascending split order into
// the output [B,1,H,D]. Batches of up to kDecThreads splits: the block loads
// their (m, l) at once, takes the running max, and each thread adds its
// columns' partial sums split after split (the first batch's rescale is
// exp(kMaskValue - m) = 0; one batch covers 16k positions in bf16 at
// D = 128). Launched as a programmatic dependent of the split kernel: it
// waits for that grid's writes before reading the workspace.
template <class KV, class Item, typename T, int D>
__global__ void __launch_bounds__(kDecThreads)
decode_combine_kernel(const DecodeArgs a) {
  constexpr int CHUNK = DecShape<T, D>::CHUNK;
  const int g = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const Item item(a, b);
  if (!item.live) return;
  const KV kv(a, b, kh);
  const DecodeRow row(a, kv, b);
  const int G = a.H / a.K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Live splits: those the split kernel did not skip.
  const int j_lo = row.lo / CHUNK;
  const int j_hi = row.end > 0 ? (row.end - 1) / CHUNK : -1;
  const size_t base = ((size_t)b * a.K + kh) * a.n_splits;
  const float2* ws_ml = reinterpret_cast<const float2*>(
      a.ws + (size_t)a.B * a.K * a.n_splits * G * D);
  const float* ws_acc = a.ws + (base * G + g) * D;
  __shared__ float w_sm[kDecThreads], l_sm[kDecThreads];
  __shared__ float wmax[kDecWarps], scale_sm;
  constexpr int DT = (D + kDecThreads - 1) / kDecThreads;
  float acc[DT];
#pragma unroll
  for (int e = 0; e < DT; ++e) acc[e] = 0.f;
  float m = kMaskValue, l = 0.f;
  griddep_wait();
  for (int j0 = j_lo; j0 <= j_hi; j0 += kDecThreads) {
    const int n = min(kDecThreads, j_hi - j0 + 1);
    const float2 ml = tid < n ? ws_ml[(base + j0 + tid) * G + g]
                              : make_float2(kMaskValue, 0.f);
    const float wm = warp_max(ml.x);
    if (lane == 0) wmax[warp] = wm;
    __syncthreads();
    float m_new = m;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) m_new = fmaxf(m_new, wmax[w]);
    w_sm[tid] = tid < n ? expf(ml.x - m_new) : 0.f;
    l_sm[tid] = ml.y;
    if (tid == 0) scale_sm = expf(m - m_new);
    m = m_new;
    __syncthreads();
    const float scale = scale_sm;
    l *= scale;
#pragma unroll
    for (int e = 0; e < DT; ++e) acc[e] *= scale;
    // kBatch splits' partial sums loaded at once, then added in order.
    constexpr int kBatch = 8;
    for (int j1 = 0; j1 < n; j1 += kBatch) {
      float part[kBatch][DT];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float* src = ws_acc + (size_t)(j0 + j1 + u) * G * D;
#pragma unroll
        for (int e = 0; e < DT; ++e) {
          const int d = tid + e * kDecThreads;
          part[u][e] = j1 + u < n && d < D ? src[d] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (j1 + u < n) {
          const float w = w_sm[j1 + u];
          l += w * l_sm[j1 + u];
#pragma unroll
          for (int e = 0; e < DT; ++e) acc[e] += w * part[u][e];
        }
      }
    }
    __syncthreads();
  }
  T* out = static_cast<T*>(a.out) + (item.row * a.H + (size_t)kh * G + g) * D;
#pragma unroll
  for (int e = 0; e < DT; ++e) {
    const int d = tid + e * kDecThreads;
    if (d < D) out[d] = from_f32<T>(acc[e] / fmaxf(l, 1e-30f));
  }
}

// Launches the split kernel and the combine on `stream`. Returns a
// cudaError_t code.
template <class KV, typename T, int D, int BITS, class Item = BatchItem>
int launch_decode(DecodeArgs a, cudaStream_t stream) {
  constexpr int CHUNK = DecShape<T, D>::CHUNK;
  a.n_splits = (KV::span(a) + CHUNK - 1) / CHUNK;
  const size_t smem = decode_smem_bytes<T, D>(a.H / a.K, BITS, a.SG);
  auto split = decode_split_kernel<KV, Item, T, D, BITS>;
  cudaError_t err = allow_smem(split, smem);
  if (err != cudaSuccess) return err;
  if (a.n_splits > 65535) return cudaErrorInvalidConfiguration;
  split<<<dim3(a.K, a.B, a.n_splits), kDecThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.H / a.K, a.K, a.B);
  cfg.blockDim = dim3(kDecThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_combine_kernel<KV, Item, T, D>, a);
}

// The split length of (dtype, D), for the wrappers' workspace; 0 when the
// pair is not instantiated.
inline int decode_chunk(int dtype, int D) {
  const int size = dtype == kF32 ? 4 : dtype == kBF16 ? 2 : 0;
  if (!size || (D != 64 && D != 128 && D != 256)) return 0;
  return kSplitBytes / (D * size);
}

// The largest dynamic shared memory a split block takes at (G, D), over
// both dtypes and the unquantized, int8 and int4 (groups of 32) pools: the
// gates decline by it. -1 for a D that is not instantiated.
template <typename T, int D>
inline size_t decode_smem_max(int G) {
  size_t m = decode_smem_bytes<T, D>(G, kBitsNone, 0);
  const size_t q8 = decode_smem_bytes<T, D>(G, 8, 1);
  const size_t q4 = decode_smem_bytes<T, D>(G, 4, D / 32);
  if (q8 > m) m = q8;
  if (q4 > m) m = q4;
  return m;
}

inline long long decode_smem_bytes_any(int G, int D) {
  size_t f = 0, h = 0;
  switch (D) {
    case 64: f = decode_smem_max<float, 64>(G);
             h = decode_smem_max<__nv_bfloat16, 64>(G); break;
    case 128: f = decode_smem_max<float, 128>(G);
              h = decode_smem_max<__nv_bfloat16, 128>(G); break;
    case 256: f = decode_smem_max<float, 256>(G);
              h = decode_smem_max<__nv_bfloat16, 256>(G); break;
    default: return -1;
  }
  return (long long)(f > h ? f : h);
}

}  // namespace rt
