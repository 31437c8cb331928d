"""The safetensors file format, read and written with nothing but torch.

The port's loader cannot depend on the ``safetensors`` package, so this is
the format itself: an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` with an
optional ``"__metadata__"`` of strings), then the tensors' raw little-endian
bytes, offsets counted from the end of the header.

``SafetensorsFile`` memory-maps a file and reads one tensor at a time: the
tensor's byte range is viewed in the map and copied once, to the CPU or
straight to the requested device, so the host holds about one tensor (and
the page cache). ``get_slice`` copies only a range of one dimension (a
tensor-parallel rank's shard). ``shape`` reads the header only.

``save_file`` writes one file; ``ShardedWriter`` writes
``model-00001.safetensors``, ... of about ``max_shard_bytes`` each plus
``model.safetensors.index.json``, as multi-file exports do.
"""
from __future__ import annotations

import json
import mmap
import os
import struct
import sys
from typing import Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

DTYPES = {
    "BOOL": torch.bool,
    "U8": torch.uint8,
    "I8": torch.int8,
    "I16": torch.int16,
    "I32": torch.int32,
    "I64": torch.int64,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F32": torch.float32,
    "F64": torch.float64,
}
NAMES = {v: k for k, v in DTYPES.items()}
INDEX_NAME = "model.safetensors.index.json"
SINGLE_NAME = "model.safetensors"

if sys.byteorder != "little":  # the format's bytes are little-endian
    raise ImportError("safetensors_io reads and writes on little-endian hosts only")


def _as_tensor(value) -> torch.Tensor:
    """A CPU tensor of ``value`` (a tensor or a numpy array of a standard
    dtype; numpy has no bfloat16)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(value))


class SafetensorsFile:
    """One memory-mapped ``.safetensors`` file."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self._data_start = 8 + n
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        self._entries = header
        for name, entry in header.items():
            if entry["dtype"] not in DTYPES:
                raise ValueError(f"{path}: {name} has dtype {entry['dtype']}, "
                                 f"which the reader does not know")

    def keys(self):
        return self._entries.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self._entries[name]["shape"])

    def get(self, name: str, device=None) -> torch.Tensor:
        """The tensor ``name`` on ``device`` (the CPU by default), read from
        the map and copied once."""
        entry = self._entries[name]
        dtype, shape = DTYPES[entry["dtype"]], tuple(entry["shape"])
        begin, end = entry["data_offsets"]
        device = torch.device(device or "cpu")
        if end == begin:
            return torch.empty(shape, dtype=dtype, device=device)
        raw = torch.frombuffer(self._map, dtype=torch.uint8, count=end - begin,
                               offset=self._data_start + begin)
        # The bytes become the dtype on their own copy, whose storage is
        # aligned, wherever the offset falls in the file.
        raw = raw.clone() if device.type == "cpu" else raw.to(device)
        return raw.view(dtype).reshape(shape)

    def get_slice(self, name: str, dim: int, start: int, stop: int,
                  device=None) -> torch.Tensor:
        """``tensor[..., start:stop, ...]`` along ``dim`` on ``device``: the
        slice's bytes are gathered from the map into one host copy (a
        contiguous range for dim 0), then moved."""
        entry = self._entries[name]
        dtype, shape = DTYPES[entry["dtype"]], tuple(entry["shape"])
        if not 0 <= start <= stop <= shape[dim]:
            raise ValueError(f"{name}: slice [{start}, {stop}) of dim {dim} of {shape}")
        begin, end = entry["data_offsets"]
        device = torch.device(device or "cpu")
        out_shape = shape[:dim] + (stop - start,) + shape[dim + 1:]
        if end == begin or start == stop:
            return torch.empty(out_shape, dtype=dtype, device=device)
        itemsize = torch.empty((), dtype=dtype).element_size()
        outer = int(np.prod(shape[:dim], dtype=np.int64))
        inner = int(np.prod(shape[dim + 1:], dtype=np.int64)) * itemsize
        raw = torch.frombuffer(self._map, dtype=torch.uint8, count=end - begin,
                               offset=self._data_start + begin)
        part = raw.view(outer, shape[dim], inner)[:, start:stop].contiguous()
        if device.type != "cpu":
            part = part.to(device)
        return part.view(dtype).reshape(out_shape)

    def close(self) -> None:
        self._map.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _header(items: Iterable[Tuple[str, torch.Tensor]]) -> bytes:
    header: Dict[str, object] = {}
    offset = 0
    for name, t in items:
        if t.dtype not in NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    # Pad with spaces so the data starts on an 8-byte boundary.
    return raw + b" " * (-len(raw) % 8)


def save_file(tensors: Mapping[str, object], path: str) -> int:
    """Write ``tensors`` (torch tensors or numpy arrays) to ``path``; returns
    the bytes of tensor data written. Tensors are laid out largest element
    first, then by name, so every offset is a multiple of its element size."""
    items = sorted(((name, _as_tensor(v)) for name, v in tensors.items()),
                   key=lambda kv: (-kv[1].element_size(), kv[0]))
    header = _header(items)
    total = 0
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        for _, t in items:
            if t.numel():
                f.write(t.contiguous().reshape(-1).view(torch.uint8).numpy().data)
                total += t.numel() * t.element_size()
    return total


class ShardedWriter:
    """Writes tensors into shards of about ``max_shard_bytes`` as they are
    added, then the index: peak host memory stays about one shard."""

    def __init__(self, out_dir: str, max_shard_bytes: int):
        self.out_dir, self.max_shard_bytes = out_dir, max_shard_bytes
        os.makedirs(out_dir, exist_ok=True)
        self.weight_map: Dict[str, str] = {}
        self.shards: list = []
        self._pending: Dict[str, torch.Tensor] = {}
        self._pending_bytes = 0
        self.total_bytes = 0

    def add(self, name: str, value) -> None:
        t = _as_tensor(value)
        self._pending[name] = t
        self._pending_bytes += t.numel() * t.element_size()

    def flush_if_full(self) -> None:
        if self._pending_bytes > self.max_shard_bytes:
            self.flush()

    def flush(self) -> None:
        if not self._pending:
            return
        fname = f"model-{len(self.shards) + 1:05d}.safetensors"
        self.total_bytes += save_file(self._pending, os.path.join(self.out_dir, fname))
        self.shards.append(fname)
        for name in self._pending:
            self.weight_map[name] = fname
        self._pending, self._pending_bytes = {}, 0

    def close(self) -> None:
        """Flush the last shard and write the index."""
        self.flush()
        with open(os.path.join(self.out_dir, INDEX_NAME), "w") as f:
            json.dump({"metadata": {"total_size": self.total_bytes},
                       "weight_map": self.weight_map}, f)
