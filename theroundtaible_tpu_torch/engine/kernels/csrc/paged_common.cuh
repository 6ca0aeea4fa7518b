// Shared device helpers of the hand-written kernels (paged_decode.cu,
// paged_prefill.cu, ragged_paged.cu, flash_prefill.cu, ragged_decode.cu,
// int4mm.cu, bgmv.cu), K4's dequantizing tile load, the KV addressing
// policies and the cp.async helpers among them. Plain C interface,
// built by engine/kernels/build.py with
// `nvcc -gencode arch=compute_90a,code=sm_90a -shared`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace rt {

// The finite masked-logit sentinel of engine/models/common.py MASK_VALUE.
// A block that is fully masked for a row gives p = exp(MASK - MASK) = 1 per
// cell; the row's first real score later wipes those cells through
// alpha = exp(MASK - m) = 0. With -inf the same block would give NaN.
constexpr float kMaskValue = -2.3819763e38f;

// Query heads that share one kv head (GQA group) a block can hold.
constexpr int kMaxGroup = 16;

enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

// The 16-bit working types (bf16, f16) run the tensor-core bodies, f32 the
// CUDA-core ones.
template <typename T>
constexpr bool kHalfWidth = !std::is_same<T, float>::value;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// Two f32 values rounded to a 16-bit type, lo in the low half: an mma or
// wgmma operand register.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// p is rounded to the value dtype before the PV product, as the TPU kernels
// do (`p.astype(v.dtype)`), so bf16 errors match theirs.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Sixteen-byte vector load of a row segment, widened to f32.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Vec<__half> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __half* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// --- K4: in-kernel dequant of quantized KV pages ---
//
// Replaces the TPU kernels' theroundtaible_tpu/engine/pallas/attention.py
// _dequant_kv (called in _prefill_accumulate and _decode_accumulate): a
// quantized pool holds an int8 payload [P,ps,K,Dp] (Dp = D for int8, D/2
// for int4: two signed nibbles per byte, the even element in the LOW
// nibble) beside f32 scales [P,ps,K,G], one per cell and group of D/G
// values. K1-K3 stage each cell's payload with 16-byte loads (128 B of a
// D=128 cell for int8, 64 B for int4) plus its scales, and dequantize
// while staging: value = float(q) * scale in f32, rounded to the compute
// dtype - `_dequant_kv` exactly - before it reaches shared memory in the
// layout the unquantized path uses, so the math past the staging is
// unchanged and shared memory per block does not grow. Decode is bound by
// bytes, and a quantized cell moves D + 4 (int8) or D/2 + 4G (int4) bytes
// instead of 2D. kBitsNone instantiates the unquantized staging.
constexpr int kBitsNone = 0;

template <int BITS, int D>
struct QuantRow {  // BITS 8 or 4 (kBitsNone: sizes of 0, never loaded)
  static constexpr int EV = BITS == 8 ? 16 : 32;  // values per 16 bytes
  static constexpr int DP = D * BITS / 8;         // payload bytes per cell
  static constexpr int VR = DP / 16;              // 16-byte vectors per cell
};

// Vector v of cell `cell` (= (page * ps + offset) * K + kv head): its 16
// payload bytes and the scale of their group (a group spans a whole
// number of vectors: the gate kv_quant_decline_reason checks it).
template <int BITS, int D>
__device__ __forceinline__ void load_qvec(const int8_t* __restrict__ pool,
                                          const float* __restrict__ scale,
                                          size_t cell, int v, int G,
                                          uint4& raw, float& s) {
  using Q = QuantRow<BITS, D>;
  raw = *reinterpret_cast<const uint4*>(pool + cell * Q::DP + v * 16);
  s = scale[cell * G + (v * Q::EV) / (D / G)];
}

// The EV values of 16 payload bytes with scale s, each rounded to T.
// Arithmetic shifts sign-extend: int8 byte j of a word is
// (w << (24 - 8j)) >> 24; its low nibble (w << (28 - 8j)) >> 28, its
// high nibble (w << (24 - 8j)) >> 28 - the (q << 4) >> 4 and q >> 4 of
// kv_quant.unpack_int4.
template <typename T, int BITS>
__device__ __forceinline__ void dequant16(const uint4& raw, float s,
                                          float* out) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (BITS == 8) {
        const int q = static_cast<int>(w[i] << (24 - 8 * j)) >> 24;
        out[4 * i + j] = round_to<T>(static_cast<float>(q) * s);
      } else {
        const int lo = static_cast<int>(w[i] << (28 - 8 * j)) >> 28;
        const int hi = static_cast<int>(w[i] << (24 - 8 * j)) >> 28;
        out[8 * i + 2 * j] = round_to<T>(static_cast<float>(lo) * s);
        out[8 * i + 2 * j + 1] = round_to<T>(static_cast<float>(hi) * s);
      }
    }
  }
}

// Host check of a launch's quantization arguments: int8 has one group, an
// int4 group spans whole 16-byte payload vectors (32 values).
inline bool quant_args_ok(int bits, int D, int G) {
  if (bits == kBitsNone) return true;
  if (G < 1 || D % G) return false;
  if (bits == 8) return G == 1 && D % 16 == 0;
  return bits == 4 && (D / G) % 32 == 0;
}

// Python's floor division (the bounds arithmetic of the TPU kernels uses it
// on numerators that can be negative).
__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ float apply_softcap(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Programmatic dependent launch (sm_90): a primary kernel (K1/K9's split,
// K7's shrink) lets its dependent (the combine, the expand) launch early;
// the dependent waits for the primary grid's completion and memory before
// it reads the workspace.
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// --- KV addressing policies of the attention bodies ---
//
// prefill_tc.cuh (K2/K8) and decode_split.cuh (K1/K9) each hold their math
// once; a kernel source instantiates it with the policy that locates kv
// cell (batch row b, position pos, kv head kh). Each is built from the
// launch's args struct, whatever its type, through the fields `index`
// (the page table [B, pp] or the cache row of each batch row [B]), `K`,
// `ps`, `pp`, `ps_shift` (PagedKV) and `S`, `n_rows` (SlotKV).
//
// - PagedKV: cell (table[b][pos >> log2 ps] * ps + pos % ps) * K + kh of
//   the pools [P,ps,K,D] (ps a power of two);
// - SlotKV: cell (rows[b] * S + pos) * K + kh of the caches [N,S,K,D]; a
//   row index outside [0, N) traps (the launch fails and the next
//   synchronisation raises).
struct PagedKV {
  static constexpr bool kZeroPadRows = false;
  const int* row_table;
  int shift, ps, pp, K, kh;  // ps = 1 << shift
  template <class Args>
  __device__ __forceinline__ PagedKV(const Args& a, int b, int kh_)
      : row_table(a.index + (size_t)b * a.pp), shift(a.ps_shift), ps(a.ps),
        pp(a.pp), K(a.K), kh(kh_) {}
  // Positions the table covers (host side: the decode split count).
  template <class Args>
  static int span(const Args& a) { return a.pp * a.ps; }
  // Positions past the table are never addressed.
  __device__ __forceinline__ int clamp_valid(int valid) const {
    return min(valid, pp * ps);
  }
  __device__ __forceinline__ size_t cell(int pos) const {
    return (((size_t)row_table[pos >> shift] << shift) + (pos & (ps - 1))) *
               K + kh;
  }
};

struct SlotKV {
  static constexpr bool kZeroPadRows = true;
  size_t first;  // the row's first cell / K
  int S, K, kh;
  template <class Args>
  __device__ __forceinline__ SlotKV(const Args& a, int b, int kh_)
      : S(a.S), K(a.K), kh(kh_) {
    const int slot = a.index[b];
    if (slot < 0 || slot >= a.n_rows) __trap();
    first = (size_t)slot * a.S;
  }
  template <class Args>
  static int span(const Args& a) { return a.S; }
  __device__ __forceinline__ int clamp_valid(int valid) const {
    return min(valid, S);
  }
  __device__ __forceinline__ size_t cell(int pos) const {
    return (first + pos) * K + kh;
  }
};

// --- asynchronous copies (K1/K2/K8/K9 staging) ---

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 zero-fills the
// destination without reading the source.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes (a scale), likewise.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sets the dynamic shared memory a launch needs above the 48 KB default.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rt

// Each kernel source is its own shared library (one translation unit), so
// these definitions appear once per library.
extern "C" {
// cudaGetErrorString for the wrappers' messages.
const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
// Shared memory a block may opt into on `device` (bytes); -1 on error.
int rt_max_smem_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}
}
