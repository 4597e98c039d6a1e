"""Port parity for the on-disk data path: the port's msgpack codec against
the ``msgpack`` package, idx/bin files exchanged with the JAX package both
ways, and dataset discovery, sharding and iteration in the same order."""
import math

import msgpack
import numpy as np
import pytest

from umetrack_tpu import data as jdata
from umetrack_tpu.utils.synthetic import make_torchdata_sample as jmake_sample
from umetrack_torch import data as pdata
from umetrack_torch.data import _msgpack, bundles
from umetrack_torch.utils.synthetic import make_torchdata_sample, write_torchdata_corpus


@pytest.fixture(scope="module")
def label_dict():
    _, labels = jmake_sample(rng_seed=2, t=3, render=False)
    return labels


EXTRAS = {
    "ints": [0, 1, -1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63, 2**64 - 1,
             -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
    "none": None, "bools": [True, False],
    "strs": ["", "a" * 31, "b" * 32, "é" * 200, "c" * 70000],
    "bins": [b"", b"\x00\x01" * 100, b"z" * 70000],
    "floats": [0.0, -1.5, 1e300, float("inf"), 3.0],
    "one_float": [2.5], "mixed": [1.5, 2, "x", None],
    "long_list": list(range(20)), "longer_list": list(range(70000)),
    "big_map": {f"k{i}": i for i in range(20)}, "empty": [{}, []],
    # lists of rows: all float64 (decoded at once), and what must not be
    "matrix": [[0.5 * i, -1.0 * i, 1e-3] for i in range(40)],
    "wide_matrix": [[float(i + j) for j in range(17)] for i in range(12)],
    "short_matrix": [[1.0, 2.0]] * 7,
    "int_in_last_row": [[1.0, 2.0]] * 9 + [[1.0, 2]],
    "ragged_rows": [[1.0, 2.0]] * 9 + [[1.0]],
    "empty_rows": [[]] * 9,
    "rows_then_scalar": [[1.0, 2.0]] * 9 + [3.0],
}


def test_msgpack_packb_is_byte_identical_to_the_package(label_dict):
    for obj in (label_dict, EXTRAS):
        assert _msgpack.packb(obj) == msgpack.packb(obj)


def test_msgpack_unpackb_reads_what_the_package_wrote(label_dict):
    for obj in (label_dict, EXTRAS):
        blob = msgpack.packb(obj)
        assert _msgpack.unpackb(blob) == msgpack.unpackb(blob)
        assert _msgpack.unpackb(memoryview(blob)) == msgpack.unpackb(blob)
    # float32 on the wire, and the package reads the port's bytes back
    assert _msgpack.unpackb(msgpack.packb([1.5, 2.25], use_single_float=True)) == [1.5, 2.25]
    assert msgpack.unpackb(_msgpack.packb(EXTRAS)) == msgpack.unpackb(msgpack.packb(EXTRAS))
    assert math.isnan(_msgpack.unpackb(_msgpack.packb(float("nan"))))


def test_msgpack_rejects_what_it_does_not_cover():
    with pytest.raises(TypeError):
        _msgpack.packb({"a": np.float32(1.0)})
    for too_big in (2**64, -2**63 - 1):
        with pytest.raises(OverflowError):
            _msgpack.packb(too_big)
    for whole in ([1.0, 2.0, 3.0], [[1.0, 2.0]] * 12, {"a": "xyz"}, [1, 2, 300]):
        with pytest.raises(ValueError, match="truncated"):
            _msgpack.unpackb(msgpack.packb(whole)[:-1])
    with pytest.raises(ValueError, match="trailing"):
        _msgpack.unpackb(msgpack.packb(1) + b"\x00")
    # extension types: flax's array type (1) is covered since the checkpoint
    # loader came; a malformed one, flax's other two and unknown ones raise
    with pytest.raises(ValueError, match="malformed array extension"):
        _msgpack.unpackb(msgpack.packb(msgpack.ExtType(1, b"x")))
    for code in (2, 3, 4, 127):
        with pytest.raises(ValueError, match="unsupported"):
            _msgpack.unpackb(msgpack.packb(msgpack.ExtType(code, b"x")))


@pytest.mark.parametrize("writer,reader", [(jdata, pdata), (pdata, jdata)],
                         ids=["jax_writes_port_reads", "port_writes_jax_reads"])
def test_idxbin_files_cross_read(tmp_path, label_dict, writer, reader):
    rng = np.random.default_rng(0)
    uniform = rng.integers(0, 255, size=(4, 2, 6, 8)).astype(np.uint8)
    ragged = [rng.normal(size=(n, 3)).astype(np.float32) for n in (2, 5, 1)]
    objs = [label_dict, {"a": [1, 2.5, "x"], "b": None}]
    writer.write_idxbin(str(tmp_path / "uniform"), uniform)
    writer.write_idxbin(str(tmp_path / "ragged"), ragged)
    writer.write_idxbin(str(tmp_path / "objs"), objs, msgpack_objects=True)

    f = reader.IdxBinFile.open(str(tmp_path / "uniform.torch.idx"))
    assert len(f) == 4 and f.shape == (4, 2, 6, 8) and f.dtype == np.uint8
    np.testing.assert_array_equal(f.read_all(), uniform)
    np.testing.assert_array_equal(f[2], uniform[2])
    f.close()
    f = reader.IdxBinFile.open(str(tmp_path / "ragged.torch.idx"))
    assert f.shape is None and f.dims == [(2, 3), (5, 3), (1, 3)]
    for i, a in enumerate(ragged):
        np.testing.assert_array_equal(f[i], a)
    f.close()
    f = reader.IdxBinFile.open(str(tmp_path / "objs.torch.idx")).preload()
    assert f.is_msgpack and [f[0], f[1]] == objs
    f.close()


def test_idxbin_files_are_byte_identical(tmp_path, label_dict):
    for pkg, name in ((jdata, "j"), (pdata, "p")):
        pkg.write_idxbin(str(tmp_path / name), [label_dict], msgpack_objects=True)
    for suffix in (".torch.idx", ".torch.bin"):
        assert (tmp_path / f"j{suffix}").read_bytes() == (tmp_path / f"p{suffix}").read_bytes()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """7 testing and 3 training sequences in two folders per split."""
    root = tmp_path_factory.mktemp("torch_data")
    write_torchdata_corpus(str(root / "a"), n_train=3, n_test=4, t=2, seed0=0, device="cpu")
    write_torchdata_corpus(str(root / "b"), n_train=0, n_test=3, t=2, seed0=100, device="cpu")
    (root / "a" / "stray").mkdir()
    return str(root)


def _key(item):
    return (item["mono"].tobytes(), msgpack.packb(item["labels"]))


def test_find_dataset_matches_jax(tree):
    ours = pdata.find_dataset(tree, ["mono", "labels"])
    ref = jdata.find_dataset(tree, ["mono", "labels"])
    assert {s.value: len(d) for s, d in ours.items()} == {"training": 3, "testing": 7}
    assert {s.value: len(d) for s, d in ref.items()} == {"training": 3, "testing": 7}
    assert pdata.find_torchdata_folders(tree, ["mono", "labels"]) == \
        jdata.find_torchdata_folders(tree, ["mono", "labels"])
    for split in pdata.Split:
        theirs = ref[jdata.Split(split.value)]
        for i in range(len(ours[split])):
            assert _key(ours[split][i]) == _key(theirs[i])


@pytest.mark.parametrize("kwargs", [
    dict(), dict(shuffle=True, seed=3), dict(distrib_info=(1, 3)),
    dict(distrib_info=(2, 3), pad_to_equal=False), dict(shuffle=True, seed=1, distrib_info=(0, 4)),
])
def test_sampler_matches_jax(kwargs):
    ours, ref = pdata.Sampler(7, **kwargs), jdata.Sampler(7, **kwargs)
    np.testing.assert_array_equal(ours.rank_indices(), ref.rank_indices())
    np.testing.assert_array_equal(ours.shard_for_worker(1, 2), ref.shard_for_worker(1, 2))


def test_iterate_dataset_same_items_same_order(tree):
    ours = pdata.find_dataset(tree, ["mono", "labels"], preload=True)[pdata.Split.TEST]
    ref = jdata.find_dataset(tree, ["mono", "labels"])[jdata.Split.TEST]
    for distrib in ((0, 1), (1, 2)):
        a = list(pdata.iterate_dataset(
            ours, pdata.Sampler(len(ours), distrib_info=distrib), transform=_key, num_threads=3))
        b = list(jdata.iterate_dataset(
            ref, jdata.Sampler(len(ref), distrib_info=distrib), transform=_key, num_threads=3))
        assert a == b and len(a) == (7 if distrib == (0, 1) else 4)


def test_prefetch_map_order_errors_and_early_close():
    assert list(pdata.prefetch_map(lambda x: x * x, iter(range(50)), 4, 3)) == [i * i for i in range(50)]

    def boom(x):
        if x == 5:
            raise KeyError("five")
        return x

    with pytest.raises(KeyError):
        list(pdata.prefetch_map(boom, iter(range(10)), 2, 2))
    gen = pdata.prefetch_map(lambda x: x, iter(range(1000)), 2, 2)
    assert next(gen) == 0
    gen.close()


def test_subsample_and_map_dataset():
    from umetrack_torch.data.dataset import map_dataset, subsample
    from umetrack_tpu.data.dataset import subsample as jsubsample

    base = list(range(20))
    assert [subsample(base, num=6)[i] for i in range(6)] == [jsubsample(base, num=6)[i] for i in range(6)]
    assert len(subsample(base, portion=0.25)) == 5
    mapped = map_dataset(lambda x: x + 1, base)
    assert len(mapped) == 20 and mapped[3] == 4
    with pytest.raises(ValueError):
        subsample(base)


def test_bundles_over_dataclasses_and_containers():
    import torch
    from umetrack_torch.data.transform import parse_raw_buffers

    raws = [parse_raw_buffers(*make_torchdata_sample(rng_seed=i, t=2)) for i in range(3)]
    batch = bundles.collate(raws)
    assert batch.images.shape == (3, 2, 2, 120, 160) and batch.images.dtype == np.uint8
    assert batch.hand_model.joint_rotation_axes.shape == (3, 22, 3)
    assert batch.hand_model.hand_scale.shape == (3,)
    on_dev = bundles.to_device(batch, "cpu")
    assert isinstance(on_dev.images, torch.Tensor) and on_dev.images.dtype == torch.uint8
    assert on_dev.hand_model.landmark_rest_bone_indices.dtype == torch.int64
    halves = bundles.map_fields(lambda a: a[:1], {"x": [np.arange(4), (np.ones(3), None)]})
    assert halves["x"][0].tolist() == [0] and halves["x"][1][1] is None
    only = bundles.map_fields(lambda a: a * 2, {"a": np.ones(2), "b": 3}, only_type=np.ndarray)
    assert only["b"] == 3 and only["a"].tolist() == [2.0, 2.0]
    cat = bundles.group([{"a": np.zeros(2)}, {"a": np.ones(3)}], np.concatenate)
    assert cat["a"].shape == (5,)
