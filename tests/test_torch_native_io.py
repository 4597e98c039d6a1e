"""The port's native idx/bin reader (``umetrack_torch/data/native.py``, C++
in ``umetrack_torch/csrc/umetrack_io.cpp``): the five tests of
``tests/test_native_io.py`` against files written by the port's
``write_idxbin``, and ``FolderDataset``'s choice of reader on a synthetic
torch_data tree."""
import logging
import os

import numpy as np
import pytest

from umetrack_torch.data import FolderDataset, find_dataset
from umetrack_torch.data import native
from umetrack_torch.data.idxbin import write_idxbin
from umetrack_torch.utils.synthetic import write_torchdata_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_tensor_frames_match_python_reader(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.standard_normal((6, 5, 7)).astype(np.float32)
    write_idxbin(str(tmp_path / "x"), data)

    f = native.NativeIdxBin(str(tmp_path / "x.torch.idx"))
    assert len(f) == 6
    for i in range(6):
        np.testing.assert_array_equal(f[i], data[i])
    with pytest.raises(IndexError):
        f[6]
    f.close()


def test_msgpack_frames(tmp_path):
    objs = [{"a": [1, 2], "s": "hi"}, {"a": [3], "s": "yo"}]
    write_idxbin(str(tmp_path / "m"), objs, msgpack_objects=True)
    f = native.NativeIdxBin(str(tmp_path / "m.torch.idx"))
    assert f[0] == objs[0]
    assert f[1] == objs[1]
    f.close()


def test_prefetch_ring_complete_and_correct(tmp_path):
    rng = np.random.default_rng(1)
    data = rng.integers(0, 255, size=(40, 32, 48), dtype=np.uint8)
    write_idxbin(str(tmp_path / "r"), data)

    f = native.NativeIdxBin(str(tmp_path / "r.torch.idx"))
    seen = {}
    for idx, frame in f.iter_prefetched(n_threads=4, capacity=8):
        seen[idx] = frame.copy()
    assert sorted(seen) == list(range(40))
    for i, frame in seen.items():
        np.testing.assert_array_equal(frame, data[i])
    f.close()


def test_prefetch_ring_custom_order(tmp_path):
    data = np.arange(10 * 4, dtype=np.int32).reshape(10, 4)
    write_idxbin(str(tmp_path / "o"), data)
    f = native.NativeIdxBin(str(tmp_path / "o.torch.idx"))
    order = [7, 3, 1]
    got = dict(f.iter_prefetched(order=order, n_threads=2, capacity=2))
    assert sorted(got) == sorted(order)
    for i in order:
        np.testing.assert_array_equal(got[i], data[i])
    with pytest.raises(IndexError):
        next(f.iter_prefetched(order=[10]))
    f.close()


def test_early_abandon_no_hang(tmp_path):
    data = np.zeros((100, 64), np.float32)
    write_idxbin(str(tmp_path / "e"), data)
    f = native.NativeIdxBin(str(tmp_path / "e.torch.idx"))
    it = f.iter_prefetched(n_threads=2, capacity=4)
    next(it)
    it.close()  # must join workers without deadlock
    f.close()


def test_folder_dataset_native_equals_python(tmp_path, monkeypatch, caplog):
    """On a written corpus both readers give the same items; ``native=None``
    takes the native reader (logged), ``UMETRACK_NATIVE_IO=0`` the Python
    one; the library lands in the port's build folder, never in
    ``native/``."""
    folders = write_torchdata_corpus(str(tmp_path), n_train=2, n_test=0, t=2, device="cpu")
    fields = ["mono", "labels"]
    ours = FolderDataset(folders["training"], fields, native=True)
    plain = FolderDataset(folders["training"], fields, native=False)
    assert ours.native and not plain.native and len(ours) == len(plain) == 2
    for i in range(2):
        a, b = ours[i], plain[i]
        np.testing.assert_array_equal(a["mono"], b["mono"])
        assert a["mono"].dtype == np.uint8 and a["labels"] == b["labels"]
    path = native.library_path()
    assert os.path.isfile(path)
    assert os.path.dirname(path) == os.path.join(REPO, "umetrack_torch", "_build")
    with caplog.at_level(logging.INFO, logger="umetrack_torch.data.dataset"):
        monkeypatch.delenv("UMETRACK_NATIVE_IO", raising=False)
        found = find_dataset(str(tmp_path), fields)
        assert all(d.native for ds in found.values() for d in ds.datasets)
        monkeypatch.setenv("UMETRACK_NATIVE_IO", "0")
        assert not FolderDataset(folders["training"], fields).native
    assert "native reader" in caplog.text and "Python reader" in caplog.text


def test_reader_resolution_when_the_library_does_not_build(tmp_path, monkeypatch, caplog):
    """``native=True`` raises; ``native=None`` says so and reads in Python."""
    write_idxbin(str(tmp_path / "mono"), np.zeros((2, 3), np.uint8))

    def no_library():
        raise RuntimeError("g++ not found: the native library cannot be built")

    monkeypatch.setattr(native, "load_library", no_library)
    monkeypatch.delenv("UMETRACK_NATIVE_IO", raising=False)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        FolderDataset(str(tmp_path), ["mono"], native=True)
    with caplog.at_level(logging.INFO, logger="umetrack_torch.data.dataset"):
        ds = FolderDataset(str(tmp_path), ["mono"])
    assert not ds.native and len(ds) == 2
    assert "does not build" in caplog.text
