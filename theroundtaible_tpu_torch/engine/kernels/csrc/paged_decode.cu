// K1: single-position decode attention straight off the KV page pool.
//
// Replaces the TPU kernel theroundtaible_tpu/engine/pallas/attention.py
// paged_decode_attention (kernel _paged_decode_kernel, math
// _decode_accumulate): q [B,1,H,D] (pre-scaled, rope'd) against the pools
// [P,ps,K,D] through the page table [B,pp]; kv_valid [B] includes this step,
// so the query position is kv_valid-1. Sliding window and logit softcap.
//
// Bound on this card: device-memory bytes. Each row reads the K and V cells
// of its window for every kv head (B * valid * K * D * 2 values) and does
// 4 * G operations per value read, far below the ~295 operations per byte
// the H100 needs before compute limits.
//
// Design: the split-KV body of decode_split.cuh with the paged addressing
// policy (PagedKV: cell (table[b][pos / ps] * ps + pos % ps) * K + kh, ps a
// power of two): one work item per (split of CHUNK positions, kv head,
// row), every page of the split in flight at once by cp.async - several
// pages to a split when ps < CHUNK - products on the tensor cores in bf16
// (mma.sync) and the CUDA cores in f32, then a combine kernel that merges
// the splits in order. Pages past the frontier are never read, nor are the
// stale cells of the frontier page (NaN included). Quantized pools (K4):
// the split stages the int8/int4 payload and its f32 scales [P,ps,K,G] and
// dequantizes them from shared memory (paged_common.cuh dequant16, rounded
// to the working type) into the tile the products read.
#include "decode_split.cuh"

namespace rt {
namespace {

template <typename T, int D>
int dispatch_bits(int bits, const DecodeArgs& a, cudaStream_t stream) {
  switch (bits) {
    case kBitsNone: return launch_decode<PagedKV, T, D, kBitsNone>(a, stream);
    case 8: return launch_decode<PagedKV, T, D, 8>(a, stream);
    case 4: return launch_decode<PagedKV, T, D, 4>(a, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int dispatch_d(int D, int bits, const DecodeArgs& a, cudaStream_t stream) {
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

// Dynamic shared memory one split block takes (bytes), the largest over
// the bf16 and f32 bodies on unquantized, int8 and int4 pools; the split
// does not depend on ps.
long long rt_paged_decode_smem_bytes(int G, int D, int ps) {
  (void)ps;
  return rt::decode_smem_bytes_any(G, D);
}

// Positions per split of (dtype, D): the wrapper sizes the workspace by it.
int rt_paged_decode_chunk(int dtype, int D) {
  return rt::decode_chunk(dtype, D);
}

// Launches K1 on `stream` (a cudaStream_t) of `device`: the split kernel,
// then the combine. ps a power of two. kv_bits 0: the pools hold T; 8 or 4:
// int8 payload pools with f32 scales [P,ps,K,G] (K4). `ws`: f32 workspace
// of B * K * ceil(pp * ps / chunk) * (H / K) * (D + 2) floats. Returns a
// cudaError_t code, 0 on success; the launches are asynchronous.
int rt_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                    const float* k_scale, const float* v_scale,
                    const int* table, const int* kv_valid, void* out,
                    float* ws, int B, int H, int K, int D, int ps, int pp,
                    int window, float softcap, int dtype, int kv_bits, int G,
                    int device, void* stream) {
  if (B < 1 || K < 1 || H % K != 0 || H / K > rt::kMaxGroup || ps < 1 ||
      (ps & (ps - 1)) || pp < 1 || ws == nullptr ||
      !rt::quant_args_ok(kv_bits, D, G) ||
      (kv_bits != rt::kBitsNone && (k_scale == nullptr || v_scale == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  rt::DecodeArgs a{};
  a.q = q;
  a.k = k_pool;
  a.v = v_pool;
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.index = table;
  a.kv_valid = kv_valid;
  a.out = out;
  a.ws = ws;
  a.B = B;
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
    case rt::kF32: return rt::dispatch_d<float>(D, kv_bits, a, s);
    case rt::kBF16: return rt::dispatch_d<__nv_bfloat16>(D, kv_bits, a, s);
    case rt::kF16: return rt::dispatch_d<__half>(D, kv_bits, a, s);
  }
  return cudaErrorInvalidValue;
}
}
