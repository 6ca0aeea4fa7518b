"""Build and load the hand-written CUDA kernels (engine/kernels/csrc/).

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into its
own shared library with a plain C interface, loaded with ctypes. Builds
happen at first use, into `engine/kernels/_build/` (git-ignored), one nvcc
process per source, all started together. A library's file name carries a
hash of its sources and flags, so an edited source never loads a stale
build. Nothing here runs at import time: the CPU tests import every module
of the package and have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("paged_decode", "paged_prefill", "ragged_paged", "flash_prefill",
           "ragged_decode", "int4mm", "bgmv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every exported function, per library; pointers and the stream
# are c_void_p so ctypes never truncates them to 32 bits.
_SIGNATURES = {
    "paged_decode": {
        "rt_paged_decode": ([_P] * 9 + [_I] * 7 + [_F] + [_I] * 4 + [_P],
                            _I),
        "rt_paged_decode_smem_bytes": ([_I, _I, _I], ctypes.c_longlong),
        "rt_paged_decode_chunk": ([_I, _I], _I),
    },
    "paged_prefill": {
        "rt_paged_prefill": ([_P] * 9 + [_I] * 8 + [_F] + [_I] * 4 + [_P],
                             _I),
        "rt_paged_prefill_smem_bytes": ([_I, _I, _I, _I],
                                        ctypes.c_longlong),
    },
    "ragged_paged": {
        "rt_ragged_paged": ([_P] * 12 + [_I] * 8 + [_F] + [_I] * 4 + [_P],
                            _I),
        "rt_ragged_smem_bytes": ([_I, _I, _I], ctypes.c_longlong),
        "rt_ragged_chunk": ([_I, _I], _I),
    },
    "flash_prefill": {
        "rt_flash_prefill": ([_P] * 7 + [_I] * 8 + [_F, _I, _I, _P], _I),
        "rt_flash_prefill_smem_bytes": ([_I, _I, _I], ctypes.c_longlong),
    },
    "ragged_decode": {
        "rt_ragged_decode": ([_P] * 7 + [_I] * 7 + [_F, _I, _I, _P], _I),
        "rt_ragged_decode_smem_bytes": ([_I, _I], ctypes.c_longlong),
        "rt_ragged_decode_chunk": ([_I, _I], _I),
    },
    "int4mm": {
        "rt_mm_pack_out": ([_P] * 5 + [_I] * 7 + [_P], _I),
        "rt_mm_pack_contract": ([_P] * 4 + [_I] * 6 + [_P], _I),
    },
    "bgmv": {
        "rt_bgmv": ([_P] * 5 + [_I] * 7 + [_P], _I),
    },
}
_COMMON_SIGNATURES = {
    "rt_error_string": ([_I], ctypes.c_char_p),
    "rt_max_smem_optin": ([_I], _I),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build at first use and need the "
        "CUDA toolkit (nvcc on PATH or under /usr/local/cuda)")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.{_digest(name)}.so"


def build_all() -> float:
    """Compile every missing library, one nvcc per source in parallel, and
    load them all. Returns the wall seconds this call spent building
    (0.0 when everything was already built). Raises with nvcc's output
    when a build fails."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return 0.0
        t0 = time.monotonic()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        running = []
        for name in SOURCES:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = BUILD_DIR / f"{name}.log"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            with open(log, "w") as fh:
                proc = subprocess.Popen(cmd, stdout=fh,
                                        stderr=subprocess.STDOUT)
            running.append((name, proc, tmp, out, log))
        failed = []
        for name, proc, tmp, out, log in running:
            if proc.wait() != 0:
                failed.append(f"{name}: {log.read_text()[-4000:]}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for name in SOURCES:
            _libs[name] = _load(name)
        return time.monotonic() - t0


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, (argtypes, restype) in {**_SIGNATURES[name],
                                    **_COMMON_SIGNATURES}.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building every kernel first
    if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name]
    return lib


def build_logs() -> dict[str, str]:
    """nvcc/ptxas output of the builds made by this checkout (registers,
    shared memory and spills per kernel), by source name."""
    logs = {}
    for name in SOURCES:
        log = BUILD_DIR / f"{name}.log"
        if log.exists():
            logs[name] = log.read_text()
    return logs


def check(rc: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if rc != 0:
        msg = library(SOURCES[0]).rt_error_string(rc)
        raise RuntimeError(
            f"{what} failed: cuda error {rc} ({msg.decode() if msg else '?'})")
