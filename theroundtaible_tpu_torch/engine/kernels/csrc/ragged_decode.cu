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
// of its window for every kv head (B * valid * K * D * 2 values) and does
// 4 * G operations per value read, far below the ~295 operations per byte
// the H100 needs before compute limits.
//
// Design: K1's split-KV body (decode_split.cuh) with the slot addressing
// policy (SlotKV: cell (rows[b] * S + pos) * K + kh): one work item per
// (split of CHUNK positions, kv head, row), every cell of the split in
// flight at once by cp.async, then a combine kernel that merges the splits
// in order.
// The splits are the same spans of absolute positions as K1's, so K1 and
// K9 are one computation. The cache is read in its [N,S,K,D] layout: the
// TPU kernel's [B,K,S,D] transpose is a BlockSpec need, and a transposed
// copy per layer per step would cost more than the attention. Cells at or
// past kv_valid are never loaded (a reused slot holds the previous
// occupant's K/V there). A row index outside [0, N) traps: the launch fails
// and the next synchronisation raises.
#include "decode_split.cuh"

namespace rt {
namespace {

template <typename T>
int dispatch_d(int D, const DecodeArgs& a, cudaStream_t s) {
  switch (D) {
    case 64: return launch_decode<SlotKV, T, 64, kBitsNone>(a, s);
    case 128: return launch_decode<SlotKV, T, 128, kBitsNone>(a, s);
    case 256: return launch_decode<SlotKV, T, 256, kBitsNone>(a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace rt

extern "C" {

// Dynamic shared memory one split block takes (bytes), the larger of the
// bf16 and f32 bodies'.
long long rt_ragged_decode_smem_bytes(int G, int D) {
  return rt::decode_smem_bytes_any(G, D);
}

// Positions per split of (dtype, D): the wrapper sizes the workspace by it.
int rt_ragged_decode_chunk(int dtype, int D) {
  return rt::decode_chunk(dtype, D);
}

// Launches K9 on `stream` (a cudaStream_t) of `device`: the split kernel,
// then the combine. The caches are [n_rows, S, K, D]; batch row b reads
// cache row rows[b]. `ws`: f32 workspace of B * K * ceil(S / chunk) *
// (H / K) * (D + 2) floats. Returns a cudaError_t code, 0 on success; the
// launches are asynchronous.
int rt_ragged_decode(const void* q, const void* k_cache, const void* v_cache,
                     const int* rows, const int* kv_valid, void* out,
                     float* ws, int B, int H, int K, int D, int S,
                     int n_rows, int window, float softcap, int dtype,
                     int device, void* stream) {
  if (B < 1 || K < 1 || H % K != 0 || H / K > rt::kMaxGroup || S < 1 ||
      n_rows < 1 || ws == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  rt::DecodeArgs a{};
  a.q = q;
  a.k = k_cache;
  a.v = v_cache;
  a.index = rows;
  a.kv_valid = kv_valid;
  a.out = out;
  a.ws = ws;
  a.B = B;
  a.H = H;
  a.K = K;
  a.S = S;
  a.n_rows = n_rows;
  a.window = window;
  a.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
#if RT_WITH_BASE
    case rt::kF32: return rt::dispatch_d<float>(D, a, s);
    case rt::kBF16: return rt::dispatch_d<__nv_bfloat16>(D, a, s);
#endif
#if RT_WITH_F16
    case rt::kF16: return rt::dispatch_d<__half>(D, a, s);
#endif
  }
  return cudaErrorInvalidValue;
}
}
