"""The port's orbax checkpoints (``umetrack_torch/utils/{orbax,ocdbt}.py``)
against the JAX package's (orbax ``StandardCheckpointer``) and tensorstore
on the CPU: directories the JAX package writes load into the port bit for
bit, directories the port writes restore in the JAX package bit for bit,
tensorstore reads the port's OCDBT stores and the port reads tensorstore's
(multi-level B+trees, many versions, a merged per-process store), and
what the port does not read is refused by name."""
import json
import os
import shutil

import jax
import numpy as np
import pytest
import tensorstore as ts
import torch
from flax import serialization

from umetrack_tpu.models import init_model
from umetrack_tpu.models.config import ModelConfig as JModelConfig
from umetrack_tpu.utils.checkpoints import load_checkpoint as jload
from umetrack_tpu.utils.checkpoints import save_checkpoint as jsave
from umetrack_torch.models import ModelConfig, UmeTrackNet
from umetrack_torch.utils import ocdbt, orbax
from umetrack_torch.utils.checkpoints import load_checkpoint, save_checkpoint
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "synthetic.msgpack")
SMALL = dict(
    start_planes=8, backbone_blocks=(1, 1, 1, 1),
    n_image_feature_channels=12, n_memory_channels=6,
)


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _assert_state_dicts_equal(a, b):
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key]), key


@pytest.fixture(scope="module")
def variables():
    """name -> (flax variables as numpy, the port's config)."""
    jvars = jax.jit(lambda key: init_model(key, JModelConfig(**SMALL))[1])(jax.random.PRNGKey(3))
    with open(CKPT, "rb") as fp:
        full = serialization.msgpack_restore(fp.read())
    return {
        "small": (jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jvars), ModelConfig(**SMALL)),
        "synthetic": (full, ModelConfig()),
    }


@pytest.fixture(scope="module")
def jax_written(variables, tmp_path_factory):
    """name -> (orbax directory, .msgpack file), both written by the JAX package."""
    root = tmp_path_factory.mktemp("jax_written")
    out = {}
    for name, (tree, _) in variables.items():
        out[name] = (jsave(str(root / name), tree), jsave(str(root / f"{name}.msgpack"), tree))
    return out


@pytest.mark.parametrize("name", ["small", "synthetic"])
def test_port_reads_a_jax_written_directory_bit_for_bit(variables, jax_written, name):
    tree, cfg = variables[name]
    directory, msgpack_file = jax_written[name]
    assert os.path.isdir(os.path.join(directory, "ocdbt.process_0"))  # orbax's merged layout
    read = dict(_leaves(orbax.read_standard_checkpoint(directory)))
    want = dict(_leaves(tree))
    assert set(read) == set(want)
    if name == "synthetic":
        assert len(read) == 213
    for key in want:
        assert read[key].dtype == want[key].dtype and np.array_equal(read[key], want[key]), key
    _assert_state_dicts_equal(load_checkpoint(directory, cfg), load_checkpoint(msgpack_file, cfg))


def test_jax_restores_a_port_written_directory_bit_for_bit(variables, jax_written, tmp_path):
    tree, cfg = variables["synthetic"]
    path = save_checkpoint(str(tmp_path / "final"), load_checkpoint(CKPT, cfg))
    assert sorted(os.listdir(path)) == ["_CHECKPOINT_METADATA", "_METADATA", "d", "manifest.ocdbt"]
    template = jax.tree_util.tree_map(np.zeros_like, tree)
    restored = dict(_leaves(jax.tree_util.tree_map(np.asarray, jload(path, template))))
    want = dict(_leaves(tree))
    assert set(restored) == set(want)
    for key in want:
        assert restored[key].dtype == want[key].dtype and np.array_equal(restored[key], want[key]), key
    # tensorstore lists the same keys as for the directory orbax wrote

    def keys(directory):
        kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{directory}/"}).result()
        return sorted(kv.list().result())

    assert keys(path) == keys(jax_written["synthetic"][0])
    # stored zstd blocks: the arrays' bytes plus framing, more than orbax's compressed directory

    def disk_bytes(directory):
        return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(directory) for f in fs)

    n_bytes = sum(a.nbytes for a in want.values())
    assert n_bytes == 4_259_371 * 4
    assert n_bytes < disk_bytes(path) < n_bytes * 1.01
    assert disk_bytes(jax_written["synthetic"][0]) < n_bytes


def test_port_reads_back_what_it_wrote_and_overwrites(tmp_path):
    cfg = ModelConfig(**SMALL)
    first = UmeTrackNet(cfg).state_dict()
    torch.manual_seed(1)
    second = UmeTrackNet(cfg).state_dict()
    path = str(tmp_path / "step_0000010")
    save_checkpoint(path, first)
    _assert_state_dicts_equal(load_checkpoint(path, cfg), first)
    save_checkpoint(path, second)
    _assert_state_dicts_equal(load_checkpoint(path, cfg), second)
    assert os.listdir(tmp_path) == ["step_0000010"]  # no temporary or replaced directory left


def _rewrite(src, dst, edit_zarray=None, edit_metadata=None):
    """A copy of the port-written checkpoint ``src`` at ``dst`` with the
    first array's ``.zarray`` or the ``_METADATA`` edited."""
    store = ocdbt.OcdbtStore(src)
    items = {k: store.read(k) for k in store.list()}
    if edit_zarray:
        key = next(k for k in sorted(items) if k.endswith("/.zarray"))
        meta = json.loads(items[key])
        edit_zarray(meta)
        items[key] = json.dumps(meta).encode()
    ocdbt.write_store(dst, items)
    with open(os.path.join(src, orbax.METADATA)) as fp:
        meta = json.load(fp)
    if edit_metadata:
        edit_metadata(meta)
    with open(os.path.join(dst, orbax.METADATA), "w") as fp:
        json.dump(meta, fp)
    return dst


REFUSALS = {
    "zarr3": (dict(edit_metadata=lambda m: m.update(use_zarr3=True)), "zarr3"),
    "no_ocdbt": (dict(edit_metadata=lambda m: m.update(use_ocdbt=False)), "without OCDBT"),
    "blosc": (dict(edit_zarray=lambda m: m.update(compressor={"id": "blosc"})), "compressor 'blosc'"),
    "filters": (dict(edit_zarray=lambda m: m.update(filters=[{"id": "delta"}])), "filters"),
    "fortran_order": (dict(edit_zarray=lambda m: m.update(order="F")), "order 'F'"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS) + ["bad_crc"])
def test_what_is_not_read_is_refused_by_name(tmp_path, case):
    cfg = ModelConfig(**SMALL)
    src = save_checkpoint(str(tmp_path / "src"), UmeTrackNet(cfg).state_dict())
    if case == "bad_crc":
        path = os.path.join(src, "manifest.ocdbt")
        with open(path, "r+b") as fp:
            fp.seek(20)
            byte = fp.read(1)
            fp.seek(20)
            fp.write(bytes([byte[0] ^ 0x40]))
        target, match = src, "CRC-32C"
    else:
        kwargs, match = REFUSALS[case]
        target = _rewrite(src, str(tmp_path / case), **kwargs)
    with pytest.raises(ValueError, match=match):
        load_checkpoint(target, cfg)


def _tensorstore_items(root):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/"}).result()
    return {k.decode(): kv.read(k).result().value for k in kv.list().result()}


def test_port_reads_tensorstore_stores(tmp_path):
    """Interior B+tree nodes, inline and out-of-line values, 20 versions
    (older ones in a version-tree node), and a store merged from a
    per-process child, as orbax merges (``ocdbt_utils.py``)."""
    deep = str(tmp_path / "deep")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{deep}/",
                          "config": {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 8}}).result()
    for v in range(20):
        kv.write(f"k{v:03d}", b"x" * v).result()
    txn = ts.Transaction()
    for i in range(60):
        kv.with_transaction(txn).write(f"key/{i:04d}/abc", bytes([i]) * (i % 13)).result()
    txn.commit_async().result()
    merged = str(tmp_path / "merged")

    def spec(path, config=None):
        s = {"driver": "ocdbt", "base": {"driver": "file", "path": path}}
        if config:
            s.update(config=config, assume_config=True)
        return s

    context = ts.Context()
    child = ts.KvStore.open(spec(f"{merged}/ocdbt.process_0", {"max_inline_value_bytes": 8}),
                            context=context).result()
    for i in range(30):
        child.write(f"p.{i:03d}/0", bytes([i]) * (5 * i)).result()
    # copying a range needs both stores in one context, the child opened as it stands
    child = ts.KvStore.open(spec(f"{merged}/ocdbt.process_0"), context=context).result()
    parent = ts.KvStore.open(spec(merged, {"max_inline_value_bytes": 1024,
                                          "max_decoded_node_bytes": 100_000_000,
                                          "manifest_kind": "single"}), context=context).result()
    txn = ts.Transaction(atomic=True)
    child.experimental_copy_range_to(parent.with_transaction(txn)).result()
    txn.commit_async().result()
    for root in (deep, merged):
        want = _tensorstore_items(root)
        store = ocdbt.OcdbtStore(root)
        assert store.list() == sorted(want)
        assert all(store.read(k) == v for k, v in want.items())
    assert ocdbt.OcdbtStore(deep).height >= 2


@pytest.mark.parametrize("node_bytes", [ocdbt.MAX_DECODED_NODE_BYTES, 400, 250])
def test_tensorstore_reads_port_stores(tmp_path, node_bytes):
    rng = np.random.default_rng(node_bytes)
    items = {f"params.layer{i}.w/{suffix}": rng.bytes(int(rng.integers(0, 3000)))
             for i in range(60) for suffix in (".zarray", "0.0")}
    items.update({"a": b"", "ab": b"x" * 40, "abc": b"y" * 41})
    root = str(tmp_path / "store")
    ocdbt.write_store(root, items, max_decoded_node_bytes=node_bytes,
                      max_inline_value_bytes=40 if node_bytes < 1000 else 1024)
    assert _tensorstore_items(root) == items
    store = ocdbt.OcdbtStore(root)
    assert store.list() == sorted(items) and all(store.read(k) == v for k, v in items.items())
    assert (store.height > 0) == (node_bytes < 1000)


def test_tracker_on_directory_weights_equals_msgpack_weights(jax_written):
    """The batched tracker with weights loaded from the JAX package's
    directory and from its ``.msgpack`` file: the same poses."""
    from umetrack_torch.parallel.eval import make_batched_state
    from umetrack_torch.tracker import TrackerConfig
    from umetrack_torch.tracker.tracker import track_sequences_batched
    from umetrack_torch.utils.synthetic import make_sequences

    cfg = ModelConfig(**SMALL)
    rigs, seqs, hands = make_sequences(2, 3, seed=40, device="cpu")
    outs = []
    for path in jax_written["small"]:
        model = UmeTrackNet(cfg)
        model.load_state_dict(load_checkpoint(path, cfg))
        model.eval()
        res, _ = track_sequences_batched(model, TrackerConfig(), rigs, seqs,
                                         make_batched_state(model, 2, "cpu"), hands, device="cpu")
        outs.append(res)
    assert outs[0].valid.any()
    for field in ("joint_angles", "wrist_xfs", "valid"):
        assert torch.equal(getattr(outs[0], field), getattr(outs[1], field)), field


def test_a_killed_write_leaves_the_previous_checkpoint(tmp_path, monkeypatch):
    cfg = ModelConfig(**SMALL)
    sd = UmeTrackNet(cfg).state_dict()
    path = save_checkpoint(str(tmp_path / "final"), sd)

    def killed(*args, **kwargs):
        raise KeyboardInterrupt

    monkeypatch.setattr(orbax, "write_store", killed)
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(path, sd)
    assert os.listdir(tmp_path) == ["final"]
    _assert_state_dicts_equal(load_checkpoint(path, cfg), sd)
    shutil.rmtree(path)


def test_apps_take_a_directory(variables, jax_written):
    """``load_model_cli`` and ``run_training(init_checkpoint=...)`` take the
    JAX package's directory as they take its ``.msgpack`` file."""
    from umetrack_torch import config
    from umetrack_torch.apps import train as app
    from umetrack_torch.apps.common import load_model_cli

    directory, msgpack_file = jax_written["synthetic"]
    _assert_state_dicts_equal(load_model_cli(directory, device="cpu").state_dict(),
                              load_model_cli(msgpack_file, device="cpu").state_dict())
    _, cfg = variables["small"]
    directory, _ = jax_written["small"]
    # a learning rate of 0 leaves the parameters where the checkpoint put them
    train_cfg = config.Config(model=cfg, train=config.TrainConfig(learning_rate=0.0, batch_size=2,
                                                                  num_steps=1, log_every=1))
    state, _ = app.run_training(train_cfg, app.synthetic_batches(2, (96, 96), device="cpu"),
                                init_checkpoint=directory, device="cpu")
    loaded = load_checkpoint(directory, cfg)
    for name, value in state.model.named_parameters():
        assert torch.equal(value.detach(), loaded[name]), name
