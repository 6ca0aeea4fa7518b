// K7: grouped LoRA BGMV (batched gather matrix-vector product), the
// per-row adapter delta of the multi-LoRA persona path at decode.
//
// Replaces the TPU kernel theroundtaible_tpu/engine/pallas/lora.py _bgmv
// (kernel _bgmv_kernel). For every row i of x, with its adapter slot
// id = ids[i] (slot 0 is the all-zero base adapter):
//
//   xa    = x[i] . a_t[id]^T      (contract C; f32 sums, rounded to T)
//   out_i = xa . b_s[id]          (contract r; f32 products and sums)
//
// ids [M] int32, x [M, C], a_t [S, r, C], b_s [S, r, O] in one dtype T
// (bf16 or f32), out [M, O] f32, M <= 64 (decode rows; prefill rows take
// the grouped einsums of engine/lora.py). xa is rounded to x's dtype
// before the second product, as the TPU kernel's `xa.astype(x.dtype)`.
//
// Bound on this card: bytes, and in practice launch latency. A call moves
// the distinct adapters' rows, r x (C + O) values each, plus x and out:
// at Llama-3-8B width, r = 8, three personas and M = 3 that is 0.28-1.08
// MB, 0.08-0.32 us at 3.35 TB/s, ~45 us over the 224 calls of a 32-layer
// decode step, against a launch cost of a few microseconds per call.
//
// Design (simple first; the TPU grid (O/bo, M) with the row innermost,
// which let an unchanged id skip the DMA, is not carried over): one block
// of 256 threads per (row, output tile of 256 x V columns), V values per
// 16-byte vector. The block loads its row's id itself (no scalar
// prefetch). Phase 1: threads stride over C in 16-byte vectors and
// accumulate up to 8 rank rows of xa at a time; warps reduce with a
// butterfly shuffle, the 8 warps' partial sums are added in warp order
// through shared memory, so the sum's order is fixed and a call gives the
// same bits every time. Each output tile recomputes xa (C x r FMAs, from
// L2 after the first tile). Phase 2: each thread owns V output columns and
// sums xa[k] * b[id, k, o] over k in f32, then writes them as float4s.
#include "paged_common.cuh"

namespace rt {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRank = 512;
constexpr int kRChunk = 8;  // rank rows of xa accumulated per pass over C

template <typename T>
__global__ void __launch_bounds__(kThreads)
bgmv_kernel(const int* __restrict__ ids, const T* __restrict__ x,
            const T* __restrict__ a_t, const T* __restrict__ b_s,
            float* __restrict__ out, int C, int r, int O) {
  constexpr int V = Vec<T>::N;
  __shared__ float partial[kWarps][kRChunk];
  __shared__ float xa[kMaxRank];
  const int i = blockIdx.x;
  const int id = ids[i];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* xr = x + static_cast<size_t>(i) * C;
  const T* a = a_t + static_cast<size_t>(id) * r * C;
  const int nvec = C / V;

  // Phase 1: xa = x[i] . a_t[id]^T, kRChunk rank rows per pass.
  for (int r0 = 0; r0 < r; r0 += kRChunk) {
    const int nr = min(kRChunk, r - r0);
    float acc[kRChunk];
#pragma unroll
    for (int k = 0; k < kRChunk; ++k) acc[k] = 0.f;
    for (int j = threadIdx.x; j < nvec; j += kThreads) {
      float xv[V];
      Vec<T>::load(xr + static_cast<size_t>(j) * V, xv);
#pragma unroll
      for (int k = 0; k < kRChunk; ++k) {
        if (k < nr) {
          float av[V];
          Vec<T>::load(a + static_cast<size_t>(r0 + k) * C +
                           static_cast<size_t>(j) * V,
                       av);
          float s = 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v) s = fmaf(xv[v], av[v], s);
          acc[k] += s;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kRChunk; ++k) acc[k] = warp_sum(acc[k]);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kRChunk; ++k) partial[warp][k] = acc[k];
    }
    __syncthreads();
    if (threadIdx.x < nr) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += partial[w][threadIdx.x];
      xa[r0 + threadIdx.x] = round_to<T>(s);
    }
    __syncthreads();
  }

  // Phase 2: this thread's V output columns, sum over k of xa[k] * b.
  const int o = (blockIdx.y * kThreads + threadIdx.x) * V;
  if (o >= O) return;
  const T* b = b_s + static_cast<size_t>(id) * r * O + o;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int k = 0; k < r; ++k) {
    float bv[V];
    Vec<T>::load(b + static_cast<size_t>(k) * O, bv);
    const float s = xa[k];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = fmaf(s, bv[v], acc[v]);
  }
  float4* dst = reinterpret_cast<float4*>(out + static_cast<size_t>(i) * O +
                                          o);
#pragma unroll
  for (int v = 0; v < V; v += 4)
    dst[v / 4] = make_float4(acc[v], acc[v + 1], acc[v + 2], acc[v + 3]);
}

template <typename T>
int launch(const void* ids, const void* x, const void* a_t, const void* b_s,
           float* out, int M, int C, int r, int O, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  if (C % V || O % V) return cudaErrorInvalidValue;
  const dim3 grid(M, (O / V + kThreads - 1) / kThreads);
  bgmv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const int*>(ids), static_cast<const T*>(x),
      static_cast<const T*>(a_t), static_cast<const T*>(b_s), out, C, r, O);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rt

extern "C" {

// Launches K7 on `stream` (a cudaStream_t) of `device`: ids [M] int32 with
// every id in [0, S), x [M, C], a_t [S, r, C], b_s [S, r, O] in one dtype
// (0 f32, 1 bf16), out [M, O] f32; 1 <= M <= 64, 1 <= r <= 512, C and O
// multiples of the 16-byte vector width (4 f32 or 8 bf16 values). The ids
// are not checked on the device: the caller built them on the host and
// checked their range there. Returns a cudaError_t code, 0 on success; the
// launch is asynchronous.
int rt_bgmv(const void* ids, const void* x, const void* a_t, const void* b_s,
            void* out, int M, int C, int r, int O, int S, int dtype,
            int device, void* stream) {
  if (M < 1 || M > 64 || C < 1 || O < 1 || r < 1 || r > rt::kMaxRank ||
      S < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (dtype) {
    case rt::kF32:
      return rt::launch<float>(ids, x, a_t, b_s, o, M, C, r, O, s);
    case rt::kBF16:
      return rt::launch<__nv_bfloat16>(ids, x, a_t, b_s, o, M, C, r, O, s);
  }
  return cudaErrorInvalidValue;
}
}
