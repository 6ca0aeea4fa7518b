// K3: mixed prefill/decode attention over a flat token buffer, straight off
// the KV page pool.
//
// Replaces the TPU kernel theroundtaible_tpu/engine/pallas/attention.py:1160
// ragged_paged_attention (kernel _ragged_kernel, math _prefill_accumulate,
// bounds _prefill_blk_bounds): q [T,H,D] (pre-scaled, rope'd) is cut into
// 8-row blocks; block qb belongs to sequence seq = seq_of_block[qb] and its
// row i sits at absolute position query_offsets[seq] + block_qstart[qb] + i.
// Each row attends its sequence's pages [P,ps,K,D] through tables[seq]
// with the causal mask kv_pos <= q_pos, kv_pos < kv_valid[seq] and, with a
// window, kv_pos > q_pos - window; logit softcap. A row at or past
// kv_valid[seq] is a pad row (7 of every decode block's 8, the inert
// blocks' tails): it is written as 0.
//
// Bound on this card: a prefill chunk of the buffer does ~4*H*D flops per
// attended (query, key) pair against 2*K*D values read per key once, so a
// buffer carrying a long chunk is bound by operations; decode rows alone
// would be bound by the pages read. At Llama-3-8B width (H=32, K=8, D=128)
// a 1000-row chunk is ~8 GFLOP against ~40 MB of pages.
//
// Design: a launcher over the two attention bodies of K1/K2, each with the
// paged addressing policy (PagedKV, b = the sequence) and a row mapping of
// the flat buffer. The buffer's work (attention.py ragged_tiles is its
// plain model):
// - A run is a maximal stretch of consecutive blocks of one sequence whose
//   block_qstart steps by 8; a block at block_qstart 0 always starts one
//   (every inert block is a run of its own).
// - A decode item: the sequence's first run in the buffer, when its only
//   real row is its first (query position kv_valid - 1) and the sequence
//   holds more than one key tile (64 cells). It runs on the split-KV body of
//   decode_split.cuh (mma.sync in bf16, CUDA cores in f32, then the
//   combine): grid (kv head, sequence, split), so the grid grows with the
//   sequences, not the blocks.
// - Every other run is cut from its start into prefill tiles of
//   2 * (64 / G) rows (the last one shorter) on prefill_tc.cuh's body: in
//   bf16 the wgmma mainloop (a producer warpgroup staging swizzled bf16 K/V
//   tiles of 64 positions by cp.async, dequantizing int8/int4 pages in
//   registers; two consumer warpgroups of 64 / G rows each), in f32 the
//   CUDA-core body twice, once per half. Pad rows are written 0. A bf16
//   tile whose only real row is its first over at most 64 cells (an inert
//   block, a decode row of a short sequence) skips the mainloop, whose
//   fixed cost would dominate it: one warp per query head on the CUDA
//   cores (single_row).
// The grid of the tile kernel is (block, kv head), last block first (the
// last tiles of a run walk the most keys). A block reads the metadata of
// up to 384 blocks around it at once to find its run's first block and the
// next run's, and takes the tile that starts inside its 8 rows, if any
// (tiles are at least 8 rows high for every G up to 16, so at most one
// does); a block of a decode item writes its pad rows as 0; every other
// block exits. No launch reads anything back to the host: the grids follow
// from T, S, K and the table's span, so a call can be captured in a CUDA
// graph. Tile heights depend on G and the run alone and the decode splits
// on (dtype, D) alone, so a rank's kv heads under K10d do the same work as
// their slice of a one-device launch, bit for bit.
#include "decode_split.cuh"
#include "prefill_tc.cuh"

namespace rt {
namespace {

constexpr int kBlockQ = 8;  // RAGGED_BLOCK_Q: flat-buffer rows per block
// Blocks past a tile's first block that the tile can reach: tiles are at
// most 2 * 64 = 128 rows.
constexpr int kLookAhead = kTcConsumers * kTcRows / kBlockQ;

// The flat buffer's metadata.
struct RaggedMeta {
  const int* seq_of_block;   // [nb]
  const int* block_qstart;   // [nb]
  const int* query_offsets;  // [S]
  const int* kv_valid;       // [S]
  int nb;
};

// Its four loads are issued together (no short-circuit between them).
__device__ __forceinline__ bool starts_run(const int* seq, const int* qs,
                                           int j) {
  const int i = max(j - 1, 0);
  const int s0 = seq[i], s1 = seq[j], q0 = qs[i], q1 = qs[j];
  return j == 0 || q1 == 0 || s0 != s1 || q0 + kBlockQ != q1;
}

// Block qb's run: its first block, and the first block of the next run
// (capped at qb + kLookAhead + 1, past every tile of qb, and at nb). The
// whole block calls it; sm: two shared ints.
__device__ __forceinline__ void find_run(const int* seq, const int* qs,
                                         int nb, int qb, int* sm, int& first,
                                         int& next) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    sm[0] = -1;
    sm[1] = min(nb, qb + kLookAhead + 1);
  }
  __syncthreads();
  if (tid < kLookAhead) {
    const int j = qb + 1 + tid;
    if (j < nb && starts_run(seq, qs, j)) atomicMin(sm + 1, j);
  }
  // Block 0 starts a run, so the walk down ends.
  for (int top = qb;; top -= blockDim.x) {
    const int j = top - tid;
    const bool hit = j >= 0 && starts_run(seq, qs, j);
    if (hit) atomicMax(sm, j);
    if (__syncthreads_or(hit)) break;
  }
  first = sm[0];
  next = sm[1];
}

// The first block of sequence s below `limit` (limit when there is none).
// The whole block calls it; sm: one shared int.
__device__ __forceinline__ int first_block(const int* seq, int s, int limit,
                                           int* sm) {
  if (threadIdx.x == 0) *sm = limit;
  __syncthreads();
  for (int base = 0; base < limit; base += blockDim.x) {
    const int j = base + threadIdx.x;
    const bool hit = j < limit && seq[j] == s;
    if (hit) atomicMin(sm, j);
    if (__syncthreads_or(hit)) break;
  }
  const int found = *sm;
  __syncthreads();
  return found;
}

// decode_split.cuh's work item of sequence b: its decode item, if it has
// one, at its first block's first row.
struct RaggedItem {
  size_t row;
  bool live;
  __device__ __forceinline__ RaggedItem(const DecodeArgs& a, int b)
      : row(0), live(false) {
    __shared__ int sm;
    const int valid = a.kv_valid[b];
    if (valid <= kTcBK) return;
    const int b0 = first_block(a.seq_of_block, b, a.n_blocks, &sm);
    if (b0 == a.n_blocks) return;
    live = a.query_offsets[b] + a.block_qstart[b0] == valid - 1;
    row = (size_t)kBlockQ * b0;
  }
};

// Zeroes kv head kh's query heads of rows [row0, row0 + n).
template <typename T>
__device__ __forceinline__ void zero_rows(const PrefillArgs& a, size_t row0,
                                          int n, int kh, int D) {
  const int G = a.H / a.K;
  const int per_row = G * D / Vec<T>::N;  // 16-byte vectors
  T* out = static_cast<T*>(a.out);
  for (int i = threadIdx.x; i < n * per_row; i += blockDim.x) {
    const size_t r = row0 + i / per_row;
    *reinterpret_cast<uint4*>(out + (r * a.H + (size_t)kh * G) * D +
                              (i % per_row) * Vec<T>::N) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// Which tile block qb holds, if any (false: nothing to attend). A block of
// a decode item writes its pad rows as 0 first.
template <typename T>
__device__ __forceinline__ bool block_tile(const PrefillArgs& a,
                                           const RaggedMeta& m, int qb,
                                           int kh, int D, int BQ, int* sm,
                                           TileRows& tile, int& s) {
  // The sequence's loads fly while the block looks for its run.
  s = m.seq_of_block[qb];
  const int offset = m.query_offsets[s], valid = m.kv_valid[s];
  int first, next;
  find_run(m.seq_of_block, m.block_qstart, m.nb, qb, sm, first, next);
  const int p0 = offset + m.block_qstart[first];
  // A decode item: the run's only real row is its first, the sequence
  // holds more than one key tile, and no block of s comes before the run.
  if (p0 == valid - 1 && valid > kTcBK &&
      first_block(m.seq_of_block, s, first, sm + 2) == first) {
    const int i0 = qb == first ? 1 : 0;  // the run's first row is real
    zero_rows<T>(a, (size_t)kBlockQ * qb + i0, kBlockQ - i0, kh, D);
    return false;
  }
  const int th = kTcConsumers * BQ;
  const int rel = kBlockQ * (qb - first);  // block qb's first row in the run
  const int t0 = (rel + th - 1) / th * th;
  if (t0 >= rel + kBlockQ) return false;
  tile = TileRows{(size_t)kBlockQ * first + t0, p0 + t0,
                  min(th, kBlockQ * (next - first) - t0)};
  return true;
}

// Values [c0, c0 + n) of cell `cell` (n divides a payload vector's values),
// as f32 (dequantized and rounded to T on a quantized pool).
template <typename T, int D, int BITS, int n>
__device__ __forceinline__ void cell_values(const void* pool,
                                            const float* scale, int SG,
                                            size_t cell, int c0, float* x) {
  if constexpr (BITS == kBitsNone && n == Vec<T>::N) {
    Vec<T>::load(static_cast<const T*>(pool) + cell * D + c0, x);
  } else if constexpr (BITS == kBitsNone) {
    const T* p = static_cast<const T*>(pool) + cell * D + c0;
#pragma unroll
    for (int e = 0; e < n; ++e) x[e] = to_f32(p[e]);
  } else {
    using Q = QuantRow<BITS, D>;
    uint4 raw;
    float sc;
    load_qvec<BITS, D>(static_cast<const int8_t*>(pool), scale, cell,
                       c0 / Q::EV, SG, raw, sc);
    float all[Q::EV];
    dequant16<T, BITS>(raw, sc, all);
#pragma unroll
    for (int e = 0; e < n; ++e) x[e] = all[c0 % Q::EV + e];
  }
}

// A tile whose only real row is its first, over at most kTcBK cells: a
// decode row of a short sequence, or an inert block (one cell). The
// tensor-core pipeline's fixed cost (a 64-row Q tile, a staged key tile,
// two wgmma and their barriers) would dominate it, so one warp per query
// head runs it on the CUDA cores, D / 32 columns per lane: a warp sum per
// key for the scores (the keys' loads in flight together), p rounded to
// T for the PV product and l from the unrounded p, as in the mainloop.
// The tile's other rows are written 0.
template <typename T, int D, int BITS>
__device__ __forceinline__ void single_row(const PrefillArgs& a,
                                           const PagedKV& kv,
                                           const TileRows& tile, int kh,
                                           int valid) {
  constexpr int kCols = D / 32;  // columns per lane
  const int G = a.H / a.K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lo = a.window > 0 ? max(0, tile.pos0 - a.window + 1) : 0;
  const T* q = static_cast<const T*>(a.q);
  T* out = static_cast<T*>(a.out);
  for (int g = warp; g < G; g += blockDim.x / 32) {
    const size_t col = (tile.row0 * a.H + (size_t)kh * G + g) * D +
                       lane * kCols;
    float qv[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) qv[e] = to_f32(q[col + e]);
    // Scores: key pos's lands in lane pos % 32 of sc[pos / 32].
    float sc[2] = {kMaskValue, kMaskValue};
#pragma unroll 8
    for (int pos = lo; pos < valid; ++pos) {
      float x[kCols];
      cell_values<T, D, BITS, kCols>(a.k, a.k_scale, a.SG, kv.cell(pos),
                                  lane * kCols, x);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < kCols; ++e) dot += qv[e] * x[e];
      dot = apply_softcap(warp_sum(dot), a.softcap);
      if (lane == pos % 32) {
        if (pos < 32)
          sc[0] = dot;
        else
          sc[1] = dot;
      }
    }
    const float mx = warp_max(fmaxf(sc[0], sc[1]));
    float p[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pos = lane + 32 * h;
      p[h] = pos >= lo && pos < valid ? expf(sc[h] - mx) : 0.f;
    }
    const float l = warp_sum(p[0] + p[1]);
    float acc[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[e] = 0.f;
#pragma unroll 8
    for (int pos = lo; pos < valid; ++pos) {
      const float w = round_to<T>(
          __shfl_sync(0xffffffffu, pos < 32 ? p[0] : p[1], pos % 32));
      float x[kCols];
      cell_values<T, D, BITS, kCols>(a.v, a.v_scale, a.SG, kv.cell(pos),
                                  lane * kCols, x);
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[e] += w * x[e];
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int e = 0; e < kCols; ++e)
      out[col + e] = from_f32<T>(acc[e] * inv);
  }
  zero_rows<T>(a, tile.row0 + 1, tile.n - 1, kh, D);
}

// bf16 and f16: the tile on the tensor-core body; a tile whose only real
// row is its first over at most kTcBK cells on the CUDA cores (single_row).
template <typename T, int D, int BITS>
__global__ void __launch_bounds__(kTcThreads, 1)
ragged_tc_kernel(const PrefillArgs a, const RaggedMeta m, int BQ) {
  __shared__ int sm[3];
  const int qb = m.nb - 1 - (int)(blockIdx.x / a.K);
  const int kh = blockIdx.x % a.K;
  TileRows tile;
  int s;
  if (!block_tile<T>(a, m, qb, kh, D, BQ, sm, tile, s)) return;
  const PagedKV kv(a, s, kh);
  const int valid = kv.clamp_valid(m.kv_valid[s]);
  if (tile.pos0 == valid - 1 && valid <= kTcBK) {
    single_row<T, D, BITS>(a, kv, tile, kh, valid);
    return;
  }
  tc_tile<PagedKV, T, D, BITS, true>(a, kv, tile, kh, BQ, valid);
}

// f32: the tile on the CUDA-core body, one half (BQ rows) after the other.
template <int D, int BITS>
__global__ void __launch_bounds__(kSimtThreads)
ragged_simt_kernel(const PrefillArgs a, const RaggedMeta m, int BQ) {
  __shared__ int sm[3];
  const int qb = m.nb - 1 - (int)(blockIdx.x / a.K);
  const int kh = blockIdx.x % a.K;
  TileRows tile;
  int s;
  if (!block_tile<float>(a, m, qb, kh, D, BQ, sm, tile, s)) return;
  const PagedKV kv(a, s, kh);
  const int valid = kv.clamp_valid(m.kv_valid[s]);
  for (int h = 0; h < kTcConsumers && h * BQ < tile.n; ++h) {
    const TileRows half{tile.row0 + (size_t)h * BQ, tile.pos0 + h * BQ,
                        min(BQ, tile.n - h * BQ)};
    simt_tile<PagedKV, D, BITS, true>(a, kv, half, kh, BQ, valid);
  }
}

// Static shared memory of the tile kernels and the decode item's search,
// on top of the bodies' dynamic shared memory.
constexpr size_t kScanBytes = 64;

template <typename T, int D>
size_t tile_smem_bytes(int G) {
  if constexpr (std::is_same<T, float>::value)
    return simt_smem_rows((size_t)G * (kTcRows / G), D);
  else
    return TcShape<D>::kBytes;
}

template <typename T, int D, int BITS>
int launch(const PrefillArgs& p, const RaggedMeta& m, const DecodeArgs& d,
           cudaStream_t stream) {
  const int G = p.H / p.K;
  const int bq = kTcRows / G;
  const size_t smem = tile_smem_bytes<T, D>(G);
  const unsigned blocks = (unsigned)m.nb * p.K;
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    auto kernel = ragged_simt_kernel<D, BITS>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kSimtThreads, smem, stream>>>(p, m, bq);
  } else {
    auto kernel = ragged_tc_kernel<T, D, BITS>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kTcThreads, smem, stream>>>(p, m, bq);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_decode<PagedKV, T, D, BITS, RaggedItem>(d, stream);
}

template <typename T, int D>
int dispatch_bits(int bits, const PrefillArgs& p, const RaggedMeta& m,
                  const DecodeArgs& d, cudaStream_t stream) {
  switch (bits) {
    case kBitsNone: return launch<T, D, kBitsNone>(p, m, d, stream);
    case 8: return launch<T, D, 8>(p, m, d, stream);
    case 4: return launch<T, D, 4>(p, m, d, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int dispatch_d(int D, int bits, const PrefillArgs& p, const RaggedMeta& m,
               const DecodeArgs& d, cudaStream_t stream) {
  switch (D) {
    case 64: return dispatch_bits<T, 64>(bits, p, m, d, stream);
    case 128: return dispatch_bits<T, 128>(bits, p, m, d, stream);
    case 256: return dispatch_bits<T, 256>(bits, p, m, d, stream);
  }
  return cudaErrorInvalidValue;
}

template <int D>
size_t smem_any(int G) {
  const size_t f = tile_smem_bytes<float, D>(G);
  const size_t h = tile_smem_bytes<__nv_bfloat16, D>(G);
  return (f > h ? f : h) + kScanBytes;
}

}  // namespace
}  // namespace rt

extern "C" {

// Shared memory one block of K3 takes (bytes): the largest of its tile
// bodies (bf16 and f32) and of its decode split blocks, over unquantized,
// int8 and int4 pools; neither depends on ps.
long long rt_ragged_smem_bytes(int G, int D, int ps) {
  (void)ps;
  if (G < 1 || G > rt::kMaxGroup) return -1;
  size_t tile;
  switch (D) {
    case 64: tile = rt::smem_any<64>(G); break;
    case 128: tile = rt::smem_any<128>(G); break;
    case 256: tile = rt::smem_any<256>(G); break;
    default: return -1;
  }
  const long long dec = rt::decode_smem_bytes_any(G, D) + rt::kScanBytes;
  return (long long)tile > dec ? (long long)tile : dec;
}

// Positions per decode split of (dtype, D): the wrapper sizes the
// workspace by it.
int rt_ragged_chunk(int dtype, int D) { return rt::decode_chunk(dtype, D); }

// Launches K3 on `stream` (a cudaStream_t) of `device`: the prefill tiles,
// then the decode items' split kernel and combine. ps a power of two; S
// sequences (tables [S, pp], query_offsets and kv_valid [S]). kv_bits 0:
// the pools hold T; 8 or 4: int8 payload pools with f32 scales [P,ps,K,G]
// (K4). `ws`: f32 workspace of S * K * ceil(pp * ps / chunk) * (H / K) *
// (D + 2) floats. Returns a cudaError_t code, 0 on success; the launches
// are asynchronous.
int rt_ragged_paged(const void* q, const void* k_pool, const void* v_pool,
                    const float* k_scale, const float* v_scale,
                    const int* tables, const int* seq_of_block,
                    const int* block_qstart, const int* query_offsets,
                    const int* kv_valid, void* out, float* ws, int T, int H,
                    int K, int D, int ps, int pp, int S, int window,
                    float softcap, int dtype, int kv_bits, int G, int device,
                    void* stream) {
  if (T < rt::kBlockQ || T % rt::kBlockQ || K < 1 || H % K != 0 ||
      H / K > rt::kMaxGroup || ps < 1 || (ps & (ps - 1)) || pp < 1 ||
      S < 1 || ws == nullptr || !rt::quant_args_ok(kv_bits, D, G) ||
      (kv_bits != rt::kBitsNone && (k_scale == nullptr || v_scale == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int shift = 0;
  while ((1 << shift) < ps) ++shift;
  rt::PrefillArgs p{};
  p.q = q;
  p.k = k_pool;
  p.v = v_pool;
  p.k_scale = k_scale;
  p.v_scale = v_scale;
  p.index = tables;
  p.kv_valid = kv_valid;
  p.out = out;
  p.B = S;
  p.Tq = T;
  p.H = H;
  p.K = K;
  p.ps = ps;
  p.pp = pp;
  p.ps_shift = shift;
  p.window = window;
  p.softcap = softcap;
  p.SG = G;
  const rt::RaggedMeta m{seq_of_block, block_qstart, query_offsets, kv_valid,
                         T / rt::kBlockQ};
  rt::DecodeArgs d{};
  d.q = q;
  d.k = k_pool;
  d.v = v_pool;
  d.k_scale = k_scale;
  d.v_scale = v_scale;
  d.index = tables;
  d.kv_valid = kv_valid;
  d.out = out;
  d.ws = ws;
  d.B = S;
  d.H = H;
  d.K = K;
  d.ps = ps;
  d.pp = pp;
  d.ps_shift = shift;
  d.window = window;
  d.softcap = softcap;
  d.SG = G;
  d.seq_of_block = seq_of_block;
  d.block_qstart = block_qstart;
  d.query_offsets = query_offsets;
  d.n_blocks = T / rt::kBlockQ;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32: return rt::dispatch_d<float>(D, kv_bits, p, m, d, st);
    case rt::kBF16:
      return rt::dispatch_d<__nv_bfloat16>(D, kv_bits, p, m, d, st);
    case rt::kF16:
      return rt::dispatch_d<__half>(D, kv_bits, p, m, d, st);
  }
  return cudaErrorInvalidValue;
}
}
