"""Build and load the hand-written CUDA kernels (engine/kernels/csrc/).

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into
shared libraries with a plain C interface, loaded with ctypes: one with
the f32 and bf16 bodies, and one with the f16 bodies alone
(`<name>_f16`), built only where a caller asks for f16 (`build_all(f16=
...)`; `library(name, dtype)` picks the one a dtype needs). Builds happen
at first use, into `engine/kernels/_build/` (git-ignored), one nvcc
process per library, all started together. A library's file name carries
a hash of its sources and flags, so an edited source never loads a stale
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
# The two libraries of a source: its f32 and bf16 bodies, its f16 bodies.
F16 = "_f16"
VARIANT_FLAGS = {"": ("-DRT_WITH_F16=0",), F16: ("-DRT_WITH_BASE=0",)}

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
        "rt_mm_pack_out": ([_P] * 6 + [_I] * 7 + [_P], _I),
        "rt_mm_pack_contract": ([_P] * 4 + [_I] * 8 + [_P], _I),
    },
    "bgmv": {
        "rt_bgmv_add": ([_P] * 11 + [_I] * 10 + [_P, _I, _P], _I),
    },
}
_COMMON_SIGNATURES = {
    "rt_error_string": ([_I], ctypes.c_char_p),
    "rt_max_smem_optin": ([_I], _I),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# Called once per library this process loads, as hook(name, seconds,
# cached): the nvcc build (when the library was not on disk) plus the
# ctypes load. engine/compile_watch.install() registers the build watch
# here.
_build_hooks: list = []


def add_build_hook(hook) -> None:
    if hook not in _build_hooks:
        _build_hooks.append(hook)


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


def _source(lib: str) -> str:
    """The source of a library name (`<source>` or `<source>_f16`)."""
    return lib[:-len(F16)] if lib.endswith(F16) else lib


def _flags(lib: str) -> tuple:
    return NVCC_FLAGS + VARIANT_FLAGS[F16 if lib.endswith(F16) else ""]


def _digest(lib: str) -> str:
    h = hashlib.sha256(" ".join(_flags(lib)).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{_source(lib)}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.{_digest(name)}.so"


def _wanted(f16) -> list[str]:
    """The libraries of every source: the f32/bf16 ones, with `f16` the
    f16 ones too, or with f16 == "only" those alone."""
    base = [] if f16 == "only" else list(SOURCES)
    return base + ([name + F16 for name in SOURCES] if f16 else [])


def build_all(f16=True) -> float:
    """Compile every missing library - the f32/bf16 ones, and with `f16`
    (the default) the f16 ones, or with f16="only" those alone - one nvcc
    per library in parallel, and load them. Returns the wall seconds this
    call spent building (0.0 when everything was already loaded). Raises
    with nvcc's output when a build fails."""
    wanted = _wanted(f16)
    if all(name in _libs for name in wanted):
        return 0.0
    with _lock:
        wanted = [name for name in wanted if name not in _libs]
        if not wanted:
            return 0.0
        t0 = time.monotonic()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        running = []
        for name in wanted:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = BUILD_DIR / f"{name}.log"
            cmd = [nvcc_path(), *_flags(name), "-o", str(tmp),
                   str(CSRC / f"{_source(name)}.cu")]
            with open(log, "w") as fh:
                proc = subprocess.Popen(cmd, stdout=fh,
                                        stderr=subprocess.STDOUT)
            running.append((name, proc, tmp, out, log))
        failed = []
        built: dict[str, float] = {}
        for name, proc, tmp, out, log in running:
            if proc.wait() != 0:
                failed.append(f"{name}: {log.read_text()[-4000:]}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
                built[name] = time.monotonic() - t0
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for name in wanted:
            t_load = time.monotonic()
            _libs[name] = _load(name)
            seconds = built.get(name, 0.0) + time.monotonic() - t_load
            for hook in list(_build_hooks):
                hook(name, seconds, name not in built)
        return time.monotonic() - t0


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, (argtypes, restype) in {**_SIGNATURES[_source(name)],
                                    **_COMMON_SIGNATURES}.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


def library(name: str, dtype=None) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu that holds the bodies of
    `dtype` (a torch dtype; None: the f32/bf16 one), building it (and the
    rest of its kind) first if needed."""
    import torch
    f16 = dtype == torch.float16
    key = name + F16 if f16 else name
    lib = _libs.get(key)
    if lib is None:
        build_all(f16="only" if f16 else False)
        lib = _libs[key]
    return lib


def build_logs() -> dict[str, str]:
    """nvcc/ptxas output of the builds made by this checkout (registers,
    shared memory and spills per kernel), by source name: the f32/bf16
    library's, then the f16 library's where it was built."""
    logs = {}
    for name in SOURCES:
        parts = [BUILD_DIR / f"{lib}.log" for lib in (name, name + F16)]
        text = "".join(p.read_text() for p in parts if p.exists())
        if text:
            logs[name] = text
    return logs


def check(rc: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if rc != 0:
        msg = library(SOURCES[0]).rt_error_string(rc)
        raise RuntimeError(
            f"{what} failed: cuda error {rc} ({msg.decode() if msg else '?'})")
