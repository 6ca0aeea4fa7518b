"""Safetensors reader (counterpart of theroundtaible_tpu/native/loader.py).

The JAX package parses the JSON header in Python and converts the payload
to float32 with a C++ library (native/rt_native.cc). torch holds every
safetensors dtype as it is, so the port needs no converter: every tensor
is handed out by name as a view of a private map of its bytes, without
copying the file. This is the port's only safetensors reader (the
`safetensors` package is not required).

Format: 8 bytes little-endian header length N, N bytes of JSON header
(name -> {"dtype", "shape", "data_offsets": [begin, end]}, plus an optional
"__metadata__"), then the payload; offsets are relative to the payload,
which starts at 8 + N. A header whose shape, dtype and offsets disagree,
or whose offsets run past the end of the file, is rejected with the file
and the tensor named.

`lcp`, the other function of the JAX module, lives in engine/kvcache.py.
"""

from __future__ import annotations

import json
import math
import mmap
import struct
from dataclasses import dataclass
from pathlib import Path

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "F64": torch.float64,
          "I64": torch.int64, "I32": torch.int32, "U8": torch.uint8,
          "I8": torch.int8}
_ELEM_SIZE = {"F32": 4, "F16": 2, "BF16": 2, "F64": 8, "I64": 8, "I32": 4,
              "U8": 1, "I8": 1}


@dataclass(frozen=True)
class TensorEntry:
    """Where one tensor lies: its file, dtype name, shape and the absolute
    byte range [begin, end) of its payload in that file."""
    path: Path
    dtype: str
    shape: tuple[int, ...]
    begin: int
    end: int


def read_header(path: str | Path) -> dict[str, TensorEntry]:
    """The tensors of one .safetensors file, from its header alone (the
    payload is not read). Raises ValueError naming the file (and the
    tensor) on a truncated file or a header that disagrees with itself
    or with the file's size; FileNotFoundError when it is absent."""
    path = Path(path)
    size = path.stat().st_size
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: truncated safetensors file "
                             f"({size} bytes, no header length)")
        (header_len,) = struct.unpack("<Q", head)
        if header_len > size - 8:
            raise ValueError(f"{path}: truncated safetensors file (header "
                             f"of {header_len} bytes, file of {size})")
        try:
            header = json.loads(f.read(header_len))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: unreadable safetensors header: "
                             f"{e}") from e
    base = 8 + header_len
    entries = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = meta.get("dtype")
        if dtype not in DTYPES:
            raise ValueError(f"{path}: tensor {name}: unsupported "
                             f"safetensors dtype {dtype!r}")
        shape = tuple(int(n) for n in meta["shape"])
        begin, end = (int(o) for o in meta["data_offsets"])
        nbytes = math.prod(shape) * _ELEM_SIZE[dtype]
        # a shape/offsets mismatch must fail loudly, not read the next
        # tensor's bytes as this one's tail
        if begin < 0 or end < begin or end - begin != nbytes:
            raise ValueError(
                f"{path}: tensor {name}: data_offsets {begin}:{end} "
                f"disagree with shape {list(shape)} ({dtype})")
        if base + end > size:
            raise ValueError(
                f"{path}: tensor {name}: data_offsets {begin}:{end} run "
                f"past the end of the file (truncated, {size} bytes)")
        entries[name] = TensorEntry(path, dtype, shape, base + begin,
                                    base + end)
    return entries


def index_safetensors(paths) -> dict[str, TensorEntry]:
    """name -> TensorEntry over every shard, from the headers alone, so a
    caller can read tensors in any order whatever the shard order."""
    index: dict[str, TensorEntry] = {}
    for path in paths:
        for name, entry in read_header(path).items():
            if name in index:
                raise ValueError(f"tensor {name} is in both "
                                 f"{index[name].path} and {path}")
            index[name] = entry
    return index


class SafetensorsReader:
    """Tensors of indexed shards, each a view of its own private map of
    the pages that hold it (copy-on-write, so torch gets a writable
    buffer and nothing is ever written back). The view keeps its map
    alive, and dropping the tensor unmaps it: a reader walking a 16 GB
    checkpoint keeps about one tensor's pages resident. (A map per shard
    whose tensors' pages are given back by madvise can still keep the
    whole shard resident: not every host honours MADV_DONTNEED on a
    private file map, and every host honours munmap.)"""

    def __init__(self, index: dict[str, TensorEntry]):
        self.index = index

    def get(self, name: str) -> torch.Tensor:
        """The tensor `name`, in its stored dtype and shape."""
        e = self.index[name]
        dtype = DTYPES[e.dtype]
        count = math.prod(e.shape)
        if count == 0:
            return torch.empty(e.shape, dtype=dtype)
        grain = mmap.ALLOCATIONGRANULARITY
        start = e.begin // grain * grain
        with open(e.path, "rb") as f:
            buf = mmap.mmap(f.fileno(), e.end - start,
                            access=mmap.ACCESS_COPY, offset=start)
        offset = e.begin - start
        if offset % _ELEM_SIZE[e.dtype] == 0:
            flat = torch.frombuffer(buf, dtype=dtype, count=count,
                                    offset=offset)
        else:
            # an element that straddles its alignment: one aligned copy
            flat = torch.frombuffer(buf, dtype=torch.uint8,
                                    count=e.end - e.begin,
                                    offset=offset).clone().view(dtype)
        return flat.view(e.shape)
