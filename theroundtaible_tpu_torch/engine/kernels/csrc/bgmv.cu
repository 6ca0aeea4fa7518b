// K7: grouped LoRA BGMV (batched gather matrix-vector product), the
// per-row adapter delta of the multi-LoRA persona path at decode, added in
// place into the projections' f32 base products.
//
// Replaces the TPU kernel theroundtaible_tpu/engine/pallas/lora.py _bgmv
// (kernel _bgmv_kernel) and the f32 add its caller makes. For each target t
// of a group (up to three projections that read the same x: q/k/v, or
// gate/up, or one of o_proj, down_proj), each row i and its adapter slot
// id = ids[i] (slot 0 is the all-zero base adapter):
//
//   xa     = x[i] . a_t[id]^T      (contract C; f32 sums, rounded to T)
//   y_t[i] += xa . b_t[id]         (contract r in rank order, f32)
//
// ids [M] int32, x [M, C], a_t [S, r, C], b_t [S, r, O_t] in one dtype T
// (bf16 or f32), y_t [M, O_t] f32, M <= 64 (decode rows; prefill rows
// take the grouped einsums of engine/lora.py). xa is rounded to x's dtype
// before the second product, as the TPU kernel's `xa.astype(x.dtype)`;
// fl(y + delta) is one rounding, so the in-place add gives the bits of a
// separate `delta + y`. Base rows are skipped: their delta is exactly zero
// because slot 0 is (the store keeps it so), and their y is untouched.
//
// Bound on this card: bytes, and in practice latency. A group moves each
// distinct nonzero adapter's rows, r x (C + O_t) values per target, x, and
// y read and written once: at Llama-3-8B width, rank 8, three personas and
// M = 3 that is 0.2-1.4 MB per group, ~5 MB per layer, ~1.5 us at 3.35
// TB/s. Across a decode step's layers every call's stacks come from HBM
// (three personas over 32 layers are ~126 MB against a 50 MB L2).
//
// Design (two launches per group, the second a programmatic dependent
// launch of the first):
//
// - Shrink, grid (C split, adapter lane, target): 256 threads own a slice
//   of 128 16-byte vectors of C (1024 bf16 / 512 f32 values, four per
//   lane), so C = 4096 is 4 splits and 14336 is 14 - the split count
//   depends on C and the dtype only, so a column shard (same C) sums xa
//   exactly as one device does. Lane a of a block takes the a-th distinct
//   nonzero id of the rows (order of first appearance; warp 0 finds it
//   from the ids with match/ballot, so the host never reads them): base
//   rows are skipped, rows sharing an adapter share one read of its A
//   slice. Warp w reads rank rows w, w + 8, ... (eight 16-byte loads in
//   flight per lane), dots them with each of the adapter's rows of x and
//   writes the warp's sum to an f32 workspace [target, split, row, rank].
// - Expand, grid (column tile of 32 16-byte vectors, group of 4 rows,
//   target): a warp per row, a lane per 16-byte vector of O. Launched with
//   programmatic stream serialization, it loads its lane's first 8 B rows
//   and y before it waits for the shrink grid; then the warp adds the
//   splits of xa (lanes over (rank row, every 32/r-th split) in split
//   order, then a butterfly: one fixed order, no float atomics), rounds xa
//   to T, sums xa[k] * b[k] over k in order and writes y + delta: one
//   owner per (row, column), so no atomics.
//
// Ablation builds on the card (`chip_compare.py --lora-variants`; numbers
// in PERF.md) chose four vectors of C per shrink lane, eight B rows
// prefetched per expand lane, the expand's programmatic launch, and its
// launch bounds (one block per SM: with the default bounds ptxas holds the
// bf16 expand to 64 registers and spills). A first design, whose last
// shrink block of each adapter added the splits behind an int ticket, was
// slower: the fence and the atomic round trip sat on the critical path.
//
// The TPU grid (O/bo, M) with the row innermost, which let an unchanged id
// skip a DMA, is not carried over: on this card the reuse comes from
// grouping the rows by adapter inside each block.
#include "paged_common.cuh"

namespace rt {
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxTargets = 3;
constexpr int kMaxRows = 64;
constexpr int kMaxRank = 512;
constexpr int kShrinkThreads = 256;
constexpr int kShrinkWarps = kShrinkThreads / 32;
constexpr int kLaneVecs = 4;       // 16-byte vectors of C per lane
constexpr int kSliceVecs = 32 * kLaneVecs;  // per shrink block
constexpr int kRankUnroll = 2;     // rank rows a warp loads before it sums
constexpr int kExpandThreads = 128;
constexpr int kExpandRows = kExpandThreads / 32;  // a warp per row
constexpr int kPrefetch = 8;       // B rows a lane loads before the wait

template <typename T>
struct GroupArgs {
  const int* ids;
  const T* x;
  const T* a[kMaxTargets];
  const T* b[kMaxTargets];
  float* y[kMaxTargets];
  int O[kMaxTargets];
  int M, C, r, splits;
  float* part;  // [targets, splits, M, r]: each C slice's partial xa
};

// Element t of a per-target field, selected without a dynamically
// indexed parameter array.
template <typename P>
__device__ __forceinline__ P pick(const P (&v)[kMaxTargets], int t) {
  return t == 0 ? v[0] : (t == 1 ? v[1] : v[2]);
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Sixteen loaded bytes as f32 values (Vec<T>::load's conversion).
template <typename T>
__device__ __forceinline__ void widen(const uint4& v, float* out);
template <>
__device__ __forceinline__ void widen<float>(const uint4& v, float* out) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}
template <>
__device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& v,
                                                     float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// The block's adapter: the `lane`-th distinct nonzero id among ids[0, M) in
// order of first appearance (0 when there are fewer), with the rows that
// carry it in `rows` and their count in `n_rows`. Warp 0 decides (lane l
// holds rows l and l + 32); every thread of the block returns the id.
__device__ __forceinline__ int find_adapter(const int* __restrict__ ids,
                                            int M, int lane, int* rows,
                                            int* n_rows) {
  __shared__ int found;
  if (threadIdx.x < 32) {
    const int l = threadIdx.x;
    const int lo = l < M ? ids[l] : 0;
    const int hi = l + 32 < M ? ids[l + 32] : 0;
    // A row is a first appearance when no earlier row holds its id. Every
    // lane takes part in each warp collective (none behind a && or ?:).
    bool hi_seen = false;
    for (int j = 0; j < 32; ++j) hi_seen |= __shfl_sync(kFull, lo, j) == hi;
    const unsigned same_lo = __match_any_sync(kFull, lo);
    const unsigned same_hi = __match_any_sync(kFull, hi);
    const bool first_lo = lo != 0 && __ffs(same_lo) - 1 == l;
    const bool first_hi = hi != 0 && !hi_seen && __ffs(same_hi) - 1 == l;
    unsigned long long m =
        __ballot_sync(kFull, first_lo) |
        (static_cast<unsigned long long>(__ballot_sync(kFull, first_hi))
         << 32);
    for (int n = 0; n < lane && m; ++n) m &= m - 1;
    const int pos = m ? __ffsll(static_cast<long long>(m)) - 1 : 0;
    const int held = __shfl_sync(kFull, pos < 32 ? lo : hi, pos % 32);
    const int id = m ? held : 0;
    const unsigned long long carry =
        __ballot_sync(kFull, id != 0 && lo == id) |
        (static_cast<unsigned long long>(
             __ballot_sync(kFull, id != 0 && hi == id))
         << 32);
    if (l == 0) {
      found = id;
      int n = 0;
      for (unsigned long long c = carry; c; c &= c - 1)
        rows[n++] = __ffsll(static_cast<long long>(c)) - 1;
      *n_rows = n;
    }
  }
  __syncthreads();
  return found;
}

template <typename T>
__global__ void __launch_bounds__(kShrinkThreads)
bgmv_shrink_kernel(const GroupArgs<T> g) {
  // The expand may launch once every block has started; it waits for this
  // grid to finish before it reads the partial sums.
  griddep_launch_dependents();
  constexpr int V = Vec<T>::N;
  __shared__ int rows[kMaxRows];
  __shared__ int n_rows_s;
  const int split = blockIdx.x, t = blockIdx.z;
  const int id = find_adapter(g.ids, g.M, blockIdx.y, rows, &n_rows_s);
  if (id == 0) return;
  const int n_rows = n_rows_s;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nvec = g.C / V;
  const int j0 = split * kSliceVecs + lane;  // vector j0 + 32 v of C
  const T* a = pick(g.a, t) + static_cast<size_t>(id) * g.r * g.C;
  float* part =
      g.part + (static_cast<size_t>(t) * g.splits + split) * g.M * g.r;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int k0 = warp; k0 < g.r; k0 += kShrinkWarps * kRankUnroll) {
    uint4 av[kRankUnroll][kLaneVecs];
#pragma unroll
    for (int u = 0; u < kRankUnroll; ++u) {
      const int k = k0 + u * kShrinkWarps;
#pragma unroll
      for (int v = 0; v < kLaneVecs; ++v) {
        const int jv = j0 + 32 * v;
        av[u][v] = k < g.r && jv < nvec
                       ? load16(a + static_cast<size_t>(k) * g.C +
                                static_cast<size_t>(jv) * V)
                       : zero;
      }
    }
    for (int n = 0; n < n_rows; ++n) {
      const int i = rows[n];
      uint4 xv[kLaneVecs];
#pragma unroll
      for (int v = 0; v < kLaneVecs; ++v) {
        const int jv = j0 + 32 * v;
        xv[v] = jv < nvec ? load16(g.x + static_cast<size_t>(i) * g.C +
                                   static_cast<size_t>(jv) * V)
                          : zero;
      }
#pragma unroll
      for (int u = 0; u < kRankUnroll; ++u) {
        float s = 0.f;
#pragma unroll
        for (int v = 0; v < kLaneVecs; ++v) {
          float xf[V], af[V];
          widen<T>(xv[v], xf);
          widen<T>(av[u][v], af);
#pragma unroll
          for (int e = 0; e < V; ++e) s = fmaf(xf[e], af[e], s);
        }
        s = warp_sum(s);
        const int k = k0 + u * kShrinkWarps;
        if (lane == 0 && k < g.r) part[i * g.r + k] = s;
      }
    }
  }
}

// xa[k] of a row in the expand: from lane k's sum (`narrow`, up to 32 rank
// rows; every lane takes part), else the splits' partials added in order.
template <typename T>
__device__ __forceinline__ float xa_at(bool narrow, float xl,
                                       const float* part, size_t stride,
                                       int splits, int k) {
  if (narrow) return __shfl_sync(kFull, xl, k);
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += __ldcg(part + sp * stride + k);
  return round_to<T>(s);
}

// Bounds of one block per SM: with the default ones ptxas holds the bf16
// body to 64 registers and spills its prefetched B rows.
template <typename T>
__global__ void __launch_bounds__(kExpandThreads, 1)
bgmv_expand_kernel(const GroupArgs<T> g) {
  constexpr int V = Vec<T>::N;
  const int t = blockIdx.z;
  const int O = pick(g.O, t);
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.y * kExpandRows + threadIdx.x / 32;
  const int o0 = blockIdx.x * 32 * V;  // the warp's first column
  if (i >= g.M || o0 >= O) return;
  const int id = g.ids[i];
  if (id == 0) return;
  const int o = o0 + lane * V;
  const bool live = o < O;  // the last tile of a width may be partial
  const T* b = pick(g.b, t) + static_cast<size_t>(id) * g.r * O + o;
  float* y = pick(g.y, t) + static_cast<size_t>(i) * O + o;

  // Before the shrink has finished: this lane's first B rows and y (the
  // stacks and the base product are complete before the shrink starts).
  uint4 pre[kPrefetch];
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k)
    pre[k] = live && k < g.r ? load16(b + static_cast<size_t>(k) * O)
                             : make_uint4(0u, 0u, 0u, 0u);
  float yv[V];
#pragma unroll
  for (int v = 0; v < V; v += 4) {
    const float4 f = live ? *reinterpret_cast<const float4*>(y + v)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    yv[v] = f.x;
    yv[v + 1] = f.y;
    yv[v + 2] = f.z;
    yv[v + 3] = f.w;
  }
  griddep_wait();

  // xa of row i: the splits' partial sums added in a fixed order. Up to 32
  // rank rows, lane (q, k) = (lane / R, lane % R) adds splits q, q + 32/R,
  // ... of rank row k (R: r rounded up to a power of two), then the lanes
  // of one k meet in a butterfly, and lane k holds xa[k]; past 32 rank
  // rows every lane adds each rank row's splits in order.
  const float* part = g.part + (static_cast<size_t>(t) * g.splits * g.M +
                                i) * g.r;
  const size_t stride = static_cast<size_t>(g.M) * g.r;
  const bool narrow = g.r <= 32;
  float xl = 0.f;
  if (narrow) {
    int R = 1;
    while (R < g.r) R *= 2;
    const int k = lane % R;
    float s = 0.f;
    if (k < g.r)
      for (int sp = lane / R; sp < g.splits; sp += 32 / R)
        s += __ldcg(part + sp * stride + k);
    for (int d = R; d < 32; d *= 2) s += __shfl_xor_sync(kFull, s, d);
    xl = round_to<T>(s);
  }

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k) {
    if (k < g.r) {
      float bv[V];
      widen<T>(pre[k], bv);
      const float s = xa_at<T>(narrow, xl, part, stride, g.splits, k);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(s, bv[v], acc[v]);
    }
  }
  for (int k = kPrefetch; k < g.r; ++k) {
    float bv[V];
    if (live) {
      Vec<T>::load(b + static_cast<size_t>(k) * O, bv);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) bv[v] = 0.f;
    }
    const float s = xa_at<T>(narrow, xl, part, stride, g.splits, k);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = fmaf(s, bv[v], acc[v]);
  }
  if (!live) return;
#pragma unroll
  for (int v = 0; v < V; v += 4)
    *reinterpret_cast<float4*>(y + v) =
        make_float4(yv[v] + acc[v], yv[v + 1] + acc[v + 1],
                    yv[v + 2] + acc[v + 2], yv[v + 3] + acc[v + 3]);
}

template <typename T>
int launch(const GroupArgs<T>& g, int targets, int lanes,
           cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  int o_max = 0;
  for (int t = 0; t < targets; ++t) o_max = g.O[t] > o_max ? g.O[t] : o_max;
  bgmv_shrink_kernel<T>
      <<<dim3(g.splits, lanes, targets), kShrinkThreads, 0, stream>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((o_max / V + 31) / 32,
                     (g.M + kExpandRows - 1) / kExpandRows, targets);
  cfg.blockDim = dim3(kExpandThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, bgmv_expand_kernel<T>, g);
}

template <typename T>
int run(const void* ids, const void* x, const void* const* a,
        const void* const* b, void* const* y, const int* O, int targets,
        int M, int C, int r, int S, int splits, void* part,
        cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  if (C % V || splits != (C / V + kSliceVecs - 1) / kSliceVecs)
    return cudaErrorInvalidValue;
  GroupArgs<T> g = {};
  g.ids = static_cast<const int*>(ids);
  g.x = static_cast<const T*>(x);
  for (int t = 0; t < targets; ++t) {
    if (O[t] < 1 || O[t] % V || !a[t] || !b[t] || !y[t])
      return cudaErrorInvalidValue;
    g.a[t] = static_cast<const T*>(a[t]);
    g.b[t] = static_cast<const T*>(b[t]);
    g.y[t] = static_cast<float*>(y[t]);
    g.O[t] = O[t];
  }
  g.M = M;
  g.C = C;
  g.r = r;
  g.splits = splits;
  g.part = static_cast<float*>(part);
  // Slot 0 is the base adapter: at most min(M, S - 1) distinct others.
  const int lanes = M < S - 1 ? M : S - 1;
  if (lanes < 1) return cudaSuccess;
  return launch<T>(g, targets, lanes, stream);
}

}  // namespace
}  // namespace rt

extern "C" {

// Launches K7 on `stream` (a cudaStream_t) of `device` for a group of
// `targets` (1-3) projections sharing x: ids [M] int32 with every id in
// [0, S) and slot 0 all zeros, x [M, C], a_t [S, r, C] and b_t [S, r, O_t]
// in one dtype (0 f32, 1 bf16), y_t [M, O_t] f32, updated in place (y_t +=
// delta_t); 1 <= M <= 64, 1 <= r <= 512, C and every O_t multiples of the
// 16-byte vector width (4 f32 or 8 bf16 values). `splits` must be
// ceil(C / (128 x that width)): the caller sizes the workspace `part`, f32
// [targets, splits, M, r], with it. Unused targets' pointers may be null.
// The ids are not checked on the device: the caller built them on the host
// and checked their range there. Returns a cudaError_t code, 0 on success;
// the launches are asynchronous.
int rt_bgmv_add(const void* ids, const void* x, const void* a0,
                const void* a1, const void* a2, const void* b0,
                const void* b1, const void* b2, void* y0, void* y1, void* y2,
                int o0, int o1, int o2, int targets, int M, int C, int r,
                int S, int splits, int dtype, void* part, int device,
                void* stream) {
  if (targets < 1 || targets > rt::kMaxTargets || M < 1 ||
      M > rt::kMaxRows || C < 1 || r < 1 || r > rt::kMaxRank || S < 1 ||
      !part)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* a[rt::kMaxTargets] = {a0, a1, a2};
  const void* b[rt::kMaxTargets] = {b0, b1, b2};
  void* y[rt::kMaxTargets] = {y0, y1, y2};
  const int O[rt::kMaxTargets] = {o0, o1, o2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return rt::run<float>(ids, x, a, b, y, O, targets, M, C, r, S, splits,
                            part, s);
    case rt::kBF16:
      return rt::run<__nv_bfloat16>(ids, x, a, b, y, O, targets, M, C, r, S,
                                    splits, part, s);
  }
  return cudaErrorInvalidValue;
}
}
