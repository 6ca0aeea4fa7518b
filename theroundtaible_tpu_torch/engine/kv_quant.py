"""Quantized KV pages - int8 (and grouped int4) paged-pool storage
(counterpart of theroundtaible_tpu/engine/kv_quant.py).

The one definition of the page-cell quantization contract every seam
shares:

- **Storage**: a quantized pool keeps its [P, page_size, K, Dp] layout
  with an int8 payload (Dp = D for int8, D/2 packed nibbles for int4, the
  even element in the LOW nibble) and a parallel per-layer scale pool
  [P, page_size, K, G] float32: one symmetric absmax scale per cell (one
  token, one kv head) per group (G = 1 for int8, D/group for int4). A
  token's write computes its own scale from its own values, so writes
  never requantize neighbours and gather/scatter round trips are stable.
- **Write seam**: `quantize_cells` at every K/V write (paged_forward's
  per-layer writes, the engine's gather-view scatter).
- **Read seam**: the CUDA kernels K1-K3 dequantize each staged tile
  in-kernel (kernels/csrc/paged_common.cuh, K4), so decode streams the
  payload plus scales; the plain versions and the gather view
  dequantize at the gather through `dequantize_cells`, the same math.
- **Accounting**: `cell_bytes_per_token` and `page_ratio` size the pool
  at the bf16 byte budget.

Rounding is torch.round (half to even, as jnp.round), scales are f32:
payloads and scales equal the JAX package's bit for bit.
`ROUNDTABLE_KV_QUANT=0` restores bf16 pools.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Optional

import torch

# Default int4 group along D (>= 4 groups per 128-wide head).
DEFAULT_INT4_GROUP = 32


@dataclass(frozen=True)
class KVQuantSpec:
    """Static description of a quantized page pool. `bits` is 8 or 4;
    `group` is the int4 scale group along D (ignored for int8, where the
    whole D axis is one group)."""

    bits: int = 8
    group: int = DEFAULT_INT4_GROUP

    @property
    def dtype_name(self) -> str:
        return "int8" if self.bits == 8 else "int4"

    def packed_dim(self, head_dim: int) -> int:
        """Payload width Dp of a D-wide head."""
        return head_dim if self.bits == 8 else head_dim // 2

    def num_groups(self, head_dim: int) -> int:
        """Scale groups G per cell (the scale pool's minor dim)."""
        if self.bits == 8:
            return 1
        return head_dim // self.effective_group(head_dim)

    def effective_group(self, head_dim: int) -> int:
        """The actual int4 group: the largest even divisor of D that is
        <= `group` (int8 returns D)."""
        if self.bits == 8:
            return head_dim
        g = min(self.group, head_dim)
        while g > 1 and (head_dim % g or g % 2):
            g -= 1
        return max(g, 2)

    def cell_bytes(self, head_dim: int) -> float:
        """Resident bytes per KV cell: payload + float32 scales."""
        return self.packed_dim(head_dim) + 4.0 * self.num_groups(head_dim)


def bf16_cell_bytes(head_dim: int, dtype_bytes: int = 2) -> float:
    return float(head_dim * dtype_bytes)


def cell_bytes_per_token(cfg: Any, spec: Optional[KVQuantSpec],
                         dtype_bytes: int = 2) -> float:
    """KV bytes one cached token costs this model under `spec` (None = the
    unquantized layout): layers x (K + V) x kv_heads x per-cell bytes."""
    per_cell = (spec.cell_bytes(cfg.head_dim) if spec is not None
                else bf16_cell_bytes(cfg.head_dim, dtype_bytes))
    return cfg.num_layers * 2 * cfg.num_kv_heads * per_cell


def page_ratio(spec: KVQuantSpec, head_dim: int,
               dtype_bytes: int = 2) -> float:
    """How many quantized pages fit the byte budget of one unquantized
    page - the pool-sizing multiplier (>= 1). int8 at D=128: ~1.94x."""
    return bf16_cell_bytes(head_dim, dtype_bytes) / spec.cell_bytes(
        head_dim)


def resolve_spec(kv_quant: Any) -> tuple[Optional[KVQuantSpec],
                                         Optional[str]]:
    """(spec, decline_reason) from the `kv_quant:` config value.

    Accepts "int8" / "int4", {"bits": 8|4, "group": n}, or falsy (off).
    The ROUNDTABLE_KV_QUANT kill switch (=0) wins over any config; the
    reason records which gate fired."""
    from .engine import env_flag
    if not kv_quant or kv_quant == "none":
        return None, "disabled:config"
    if not env_flag(None, "ROUNDTABLE_KV_QUANT"):
        return None, "disabled:env"
    if isinstance(kv_quant, str):
        if kv_quant not in ("int8", "int4"):
            raise ValueError(
                f"kv_quant must be none|int8|int4, got {kv_quant!r}")
        return KVQuantSpec(bits=8 if kv_quant == "int8" else 4), None
    if isinstance(kv_quant, dict):
        bits = int(kv_quant.get("bits", 8))
        if bits not in (8, 4):
            raise ValueError(f"kv_quant.bits must be 8 or 4, got {bits}")
        group = int(kv_quant.get("group", DEFAULT_INT4_GROUP))
        if group < 2:
            raise ValueError(f"kv_quant.group must be >= 2, got {group}")
        return KVQuantSpec(bits=bits, group=group), None
    raise ValueError(
        f"kv_quant must be a string or mapping, got {type(kv_quant)}")


# --- the quantize/dequantize pair ---


def quantize_cells(x: torch.Tensor, spec: KVQuantSpec):
    """K or V values [..., D] -> (payload int8 [..., Dp], scales f32
    [..., G]): one symmetric absmax scale per cell per group."""
    d = x.shape[-1]
    g = spec.effective_group(d)
    n_groups = spec.num_groups(d)
    xg = x.float().reshape(*x.shape[:-1], n_groups, g)
    absmax = xg.abs().amax(dim=-1)
    qmax = 127.0 if spec.bits == 8 else 7.0
    s = torch.clamp(absmax, min=1e-8) / qmax
    q = torch.clamp(torch.round(xg / s[..., None]), -qmax, qmax)
    q = q.to(torch.int8).reshape(*x.shape[:-1], d)
    if spec.bits == 4:
        q2 = q.reshape(*x.shape[:-1], d // 2, 2)
        even, odd = q2[..., 0].to(torch.int32), q2[..., 1].to(torch.int32)
        # the int32 -> int8 cast wraps the high bit, as JAX's astype does
        q = (((odd & 0xF) << 4) | (even & 0xF)).to(torch.int8)
    return q, s


def unpack_int4(q: torch.Tensor) -> torch.Tensor:
    """[..., D/2] packed int8 -> [..., D] int4 values as int8 (even
    element from the LOW nibble); arithmetic shifts sign-extend both."""
    lo = torch.bitwise_left_shift(q, 4) >> 4
    hi = q >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*q.shape[:-1],
                                                 q.shape[-1] * 2)


def dequantize_cells(q: torch.Tensor, s: torch.Tensor, spec: KVQuantSpec,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """(payload [..., Dp], scales [..., G]) -> values [..., D] in `dtype`:
    float(q) * scale in f32, rounded once to `dtype` - the math K4 runs on
    each staged tile."""
    if spec.bits == 4:
        q = unpack_int4(q)
    d = q.shape[-1]
    n_groups = s.shape[-1]
    xg = q.float().reshape(*q.shape[:-1], n_groups, d // n_groups)
    return (xg * s.float()[..., None]).reshape(q.shape).to(dtype)


# --- dispatch counters (the JAX package's test-visibility counters) ---

_lock = threading.Lock()
_kernel_dispatches = 0
_fallback_dispatches = 0


def reset_test_counters() -> None:
    global _kernel_dispatches, _fallback_dispatches
    with _lock:
        _kernel_dispatches = 0
        _fallback_dispatches = 0


def note_quant_dispatch(kernel: bool) -> None:
    """One serving dispatch consumed quantized pages: dequant inside the
    kernels (pool-direct, ragged) or at the gather (the gather view)."""
    global _kernel_dispatches, _fallback_dispatches
    with _lock:
        if kernel:
            _kernel_dispatches += 1
        else:
            _fallback_dispatches += 1


def quant_dispatches() -> int:
    return _kernel_dispatches + _fallback_dispatches


def quant_kernel_dispatches() -> int:
    return _kernel_dispatches


def quant_fallback_dispatches() -> int:
    return _fallback_dispatches
