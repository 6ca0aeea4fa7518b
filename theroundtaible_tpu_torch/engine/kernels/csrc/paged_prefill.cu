// K2: causal chunk attention at per-row offsets straight off the KV page
// pool.
//
// Replaces the TPU kernel theroundtaible_tpu/engine/pallas/attention.py:374
// paged_prefill_attention (kernel _paged_prefill_kernel, math
// _prefill_accumulate, bounds _prefill_blk_bounds): q [B,T,H,D] (pre-scaled,
// rope'd) whose row i sits at absolute position offsets[b] + i, against the
// pools [P,ps,K,D] through the page table [B,pp]. The caller has scattered
// this chunk's K/V already; pages below a row's offset may be aliased donor
// pages and are only read. Rows past a row's real length are garbage the
// caller drops (a q tile made only of them is written 0).
//
// Bound on this card: a long chunk by operations (4*H*D per attended
// (query, key) pair against 2*K*D values read per key); a short chunk over
// a long cached prefix by the pages read.
//
// Design: the mainloop of prefill_tc.cuh with the paged addressing policy
// (PagedKV: cell (table[b][pos / ps] * ps + pos % ps) * K + kh): in bf16
// on the tensor cores by wgmma, K/V tiles of 64 positions - gathered
// through the table, several pages to a tile when ps < 64 - staged by a
// producer warpgroup with cp.async, two consumer warpgroups of 64 query
// rows each; in f32 the CUDA-core body, since the tensor cores would round
// f32 to TF32. Quantized pools (K4): the producer dequantizes the int8 /
// int4 payload (paged_common.cuh load_qvec/dequant16, rounded to the
// working type) into the same tile, so the math past it is the
// unquantized path's.
#include "prefill_tc.cuh"

namespace rt {
namespace {

template <typename T, int D>
int dispatch_bits(int bits, const PrefillArgs& a, cudaStream_t stream) {
  switch (bits) {
    case kBitsNone: return launch_prefill<PagedKV, T, D, kBitsNone>(a, stream);
    case 8: return launch_prefill<PagedKV, T, D, 8>(a, stream);
    case 4: return launch_prefill<PagedKV, T, D, 4>(a, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int dispatch_d(int D, int bits, const PrefillArgs& a, cudaStream_t stream) {
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

// Dynamic shared memory one block of the prefill kernel takes (bytes), the
// larger of the bf16 and f32 bodies'.
long long rt_paged_prefill_smem_bytes(int G, int D, int ps, int T) {
  (void)ps;
  return (long long)rt::prefill_smem_bytes(G, D, T);
}

// Launches K2 on `stream` (a cudaStream_t) of `device`; ps a power of two.
// kv_bits 0: the pools hold T; 8 or 4: int8 payload pools with f32 scales
// [P,ps,K,G] (K4). Returns a cudaError_t code, 0 on success; the launch
// itself is asynchronous.
int rt_paged_prefill(const void* q, const void* k_pool, const void* v_pool,
                     const float* k_scale, const float* v_scale,
                     const int* table, const int* offsets,
                     const int* kv_valid, void* out, int B, int T, int H,
                     int K, int D, int ps, int pp, int window, float softcap,
                     int dtype, int kv_bits, int G, int device,
                     void* stream) {
  if (B < 1 || T < 1 || K < 1 || H % K != 0 || H / K > rt::kMaxGroup ||
      ps < 1 || (ps & (ps - 1)) || pp < 1 ||
      !rt::quant_args_ok(kv_bits, D, G) ||
      (kv_bits != rt::kBitsNone && (k_scale == nullptr || v_scale == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  rt::PrefillArgs a{};
  a.q = q;
  a.k = k_pool;
  a.v = v_pool;
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.index = table;
  a.offsets = offsets;
  a.kv_valid = kv_valid;
  a.out = out;
  a.B = B;
  a.Tq = T;
  a.H = H;
  a.K = K;
  a.ps = ps;
  a.pp = pp;
  while ((1 << a.ps_shift) < ps) ++a.ps_shift;
  a.window = window;
  a.softcap = softcap;
  a.SG = G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
#if RT_WITH_BASE
    case rt::kF32: return rt::dispatch_d<float>(D, kv_bits, a, s);
    case rt::kBF16: return rt::dispatch_d<__nv_bfloat16>(D, kv_bits, a, s);
#endif
#if RT_WITH_F16
    case rt::kF16: return rt::dispatch_d<__half>(D, kv_bits, a, s);
#endif
  }
  return cudaErrorInvalidValue;
}
}
