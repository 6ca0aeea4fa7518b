// K8: causal attention of a prefill chunk against the position-aligned
// (contiguous) KV cache.
//
// Replaces the TPU kernel theroundtaible_tpu/engine/pallas/attention.py:216
// flash_prefill_attention (kernel _prefill_kernel, math _prefill_accumulate,
// bounds _prefill_blk_bounds): q [B,T,H,D] (pre-scaled, rope'd) whose row i
// sits at absolute position offsets[b] + i, against the caches [N,S,K,D],
// where batch row b reads cache row rows[b] in place (rows == arange(B) is
// the TPU kernel's own call). The caller has written this chunk's K/V into
// the cache already. Any T >= 1 and any S: the TPU gate's multiples of 8 do
// not apply, so the bucket the engine shrinks at the cache end still runs
// here. Pad rows of a bucket (q_pos >= kv_valid) are written 0, here and in
// the plain version, so the two agree on the whole output.
//
// Bound on this card: a long chunk by operations (4*H*D per attended
// (query, key) pair against 2*K*D values read per key); a short chunk over
// a long cached prefix by the cells read.
//
// Design: the mainloop of prefill_tc.cuh - K2's - with the slot addressing
// policy (SlotKV: cell (rows[b] * S + pos) * K + kh; a row index outside
// [0, N) traps, so the launch fails and the next synchronisation raises):
// in bf16 on the tensor cores by wgmma, K/V tiles of 64 positions staged
// by a producer warpgroup with cp.async, two consumer warpgroups of 64
// query rows each; in f32 the CUDA-core body, since the tensor cores would
// round f32 to TF32. Positions past the frontier are never loaded (a reused
// slot holds the previous occupant's K/V there).
#include "prefill_tc.cuh"

namespace rt {
namespace {

template <typename T>
int dispatch_d(int D, const PrefillArgs& a, cudaStream_t stream) {
  switch (D) {
    case 64: return launch_prefill<SlotKV, T, 64, kBitsNone>(a, stream);
    case 128: return launch_prefill<SlotKV, T, 128, kBitsNone>(a, stream);
    case 256: return launch_prefill<SlotKV, T, 256, kBitsNone>(a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace rt

extern "C" {

// Dynamic shared memory one block of the prefill kernel takes (bytes), the
// larger of the bf16 and f32 bodies'.
long long rt_flash_prefill_smem_bytes(int G, int D, int T) {
  return (long long)rt::prefill_smem_bytes(G, D, T);
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
  rt::PrefillArgs a{};
  a.q = q;
  a.k = k_cache;
  a.v = v_cache;
  a.index = rows;
  a.offsets = offsets;
  a.kv_valid = kv_valid;
  a.out = out;
  a.B = B;
  a.Tq = T;
  a.H = H;
  a.K = K;
  a.S = S;
  a.n_rows = n_rows;
  a.window = window;
  a.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32: return rt::dispatch_d<float>(D, a, s);
    case rt::kBF16: return rt::dispatch_d<__nv_bfloat16>(D, a, s);
    case rt::kF16: return rt::dispatch_d<__half>(D, a, s);
  }
  return cudaErrorInvalidValue;
}
}
