"""The port's safetensors reader and writer (``utils/safetensors_io.py``)
against the ``safetensors`` package, which the port does not use: files the
port writes read back equal in the package, and the package's files equal in
the port's reader, for every dtype (bfloat16 among them), header-only
shapes, and a sharded directory with its index.  Equality is exact (bits
and dtypes).  The package comparisons skip where it is missing."""
import json
import os

import numpy as np
import pytest
import torch

from chatts_tpu_torch.utils import safetensors_io as io


def _tensors():
    gen = torch.Generator().manual_seed(0)
    out = {
        "bf16": torch.randn((3, 5), generator=gen).to(torch.bfloat16),
        "f16": torch.randn((4, 2), generator=gen).half(),
        "f32": torch.randn((7,), generator=gen),
        "f64": torch.randn((2, 2, 2), generator=gen).double(),
        "i8": torch.randint(-128, 128, (9,), generator=gen, dtype=torch.int8),
        "u8": torch.randint(0, 256, (3, 3), generator=gen, dtype=torch.uint8),
        "i16": torch.randint(-1000, 1000, (5,), generator=gen, dtype=torch.int16),
        "i32": torch.randint(-2 ** 31, 2 ** 31 - 1, (4, 3), generator=gen, dtype=torch.int32),
        "i64": torch.randint(-2 ** 40, 2 ** 40, (3,), generator=gen, dtype=torch.int64),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5),
        "empty": torch.empty((0, 4)),
    }
    assert {t.dtype for t in out.values()} == set(io.DTYPES.values())
    return out


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_torch_safetensors_round_trip_every_dtype(tmp_path):
    tensors = _tensors()
    path = str(tmp_path / "x.safetensors")
    io.save_file(tensors, path)
    with io.SafetensorsFile(path) as f:
        assert set(f.keys()) == set(tensors) and f.metadata == {}
        for name, t in tensors.items():
            assert f.shape(name) == tuple(t.shape)
            _equal(f.get(name), t)


def test_torch_safetensors_writer_read_by_the_package(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    tensors = _tensors()
    path = str(tmp_path / "port.safetensors")
    io.save_file(tensors, path)
    loaded = st.load_file(path)
    assert set(loaded) == set(tensors)
    for name, t in tensors.items():
        _equal(loaded[name], t)


def test_torch_safetensors_reader_reads_the_package(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    tensors = _tensors()
    path = str(tmp_path / "package.safetensors")
    st.save_file(tensors, path, metadata={"k": "v"})
    with io.SafetensorsFile(path) as f:
        assert f.metadata == {"k": "v"}
        for name, t in tensors.items():
            assert f.shape(name) == tuple(t.shape)
            _equal(f.get(name), t)


def test_torch_safetensors_numpy_values_and_the_numpy_package(tmp_path):
    """numpy arrays write as their dtype; the package's numpy writer's files
    (the JAX package's route) read back equal."""
    stn = pytest.importorskip("safetensors.numpy")
    rng = np.random.default_rng(1)
    arrays = {"a": rng.normal(size=(4, 6)).astype(np.float16),
              "b": rng.integers(0, 2 ** 31, size=(5, 3)).astype(np.int32),
              "c": np.asfortranarray(rng.normal(size=(3, 4)).astype(np.float32))}
    ours = str(tmp_path / "ours.safetensors")
    io.save_file(arrays, ours)
    theirs = str(tmp_path / "theirs.safetensors")
    stn.save_file({k: np.ascontiguousarray(v) for k, v in arrays.items()}, theirs)
    for path in (ours, theirs):
        with io.SafetensorsFile(path) as f:
            for name, a in arrays.items():
                np.testing.assert_array_equal(f.get(name).numpy(), a)
    loaded = stn.load_file(ours)
    for name, a in arrays.items():
        np.testing.assert_array_equal(loaded[name], a)


def test_torch_safetensors_sharded_directory(tmp_path):
    """Shards of about ``max_shard_bytes`` as tensors are added, and an index
    mapping every name to its shard, which the package reads."""
    gen = torch.Generator().manual_seed(2)
    tensors = {f"layer.{i}.w": torch.randn((64, 64), generator=gen).to(torch.bfloat16)
               for i in range(6)}
    writer = io.ShardedWriter(str(tmp_path), max_shard_bytes=3 * 64 * 64 * 2 - 1)
    for name, t in tensors.items():
        writer.add(name, t)
        writer.flush_if_full()
    writer.close()
    assert writer.shards == ["model-00001.safetensors", "model-00002.safetensors"]
    with open(tmp_path / io.INDEX_NAME) as f:
        index = json.load(f)
    assert index["metadata"]["total_size"] == 6 * 64 * 64 * 2
    assert set(index["weight_map"]) == set(tensors)
    st = pytest.importorskip("safetensors.torch")
    for name, t in tensors.items():
        fname = os.path.join(tmp_path, index["weight_map"][name])
        with io.SafetensorsFile(fname) as f:
            _equal(f.get(name), t)
        _equal(st.load_file(fname)[name], t)


def test_torch_safetensors_refuses_unknown_dtypes(tmp_path):
    with pytest.raises(ValueError, match="no safetensors name"):
        io.save_file({"c": torch.zeros(2, dtype=torch.complex64)}, str(tmp_path / "c"))
