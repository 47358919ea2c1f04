"""The port's TF-free tensor-bundle reader (`train/tf1_bundle.py`) against
TensorFlow: bundles written by `tf.raw_ops.SaveV2` (and merged by
`MergeV2Checkpoints`) run eagerly, read back by `read_bundle` bit for bit
as `tf.train.load_checkpoint` reads them, over dtypes, ranks, names and a
multi-block index, two shards and a `checkpoint` directory; the named
errors of what it cannot read; TF reading what `write_bundle` writes.

Eager TF only: graph mode (`disable_eager_execution`) would stay on for
the whole worker process and break TF tests that share it."""
import os
import struct

import numpy as np
import pytest
import tensorflow as tf

from dpig_tpu.train.tf1_import import load_tf1_variables
from dpig_tpu_torch.train import tf1_bundle as tb

DTYPES = (np.float32, np.float64, np.int32, np.int64)
SHAPES = ((), (3,), (2, 5), (3, 1, 4), (2, 3, 1, 5))


@pytest.fixture(scope="module", autouse=True)
def tf_eager():
    """TensorFlow runs eagerly here whatever an earlier test of this
    worker left on (tests/test_tf1_import.py turns graph mode on for the
    rest of its process), and as it was after this module."""
    from tensorflow.python.eager import context
    with context.eager_mode():
        yield


def _value(rng, dtype, shape):
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, shape, dtype=dtype,
                            endpoint=True)
    return rng.normal(0, 3, shape).astype(dtype)


def _cases(rng, n_filler=4000):
    """Every dtype at every rank, names with '/' and '.', long shared
    prefixes, and enough entries for more than one index data block."""
    out = {}
    for i, dtype in enumerate(DTYPES):
        for j, shape in enumerate(SHAPES):
            out[f"scope/Conv_{i}/weights.{j}"] = _value(rng, dtype, shape)
    out["Discriminator.BN2.moving_mean"] = _value(rng, np.float32, (7,))
    out["Discriminator.Output.W"] = _value(rng, np.float32, (12, 1))
    out["G/fully_connected_1/weights/Adam_1"] = _value(rng, np.float32, (4,))
    out["beta1_power"] = _value(rng, np.float32, ())
    long = "Encoder/G_encoder/" + "shared_prefix_" * 8
    for k in range(n_filler // 10):
        out[f"{long}{k:05d}/{'x' * (k % 40)}"] = _value(
            rng, DTYPES[k % 4], SHAPES[k % 5])
    for k in range(n_filler):                 # names that barely share
        out[f"f{rng.integers(1 << 62):x}/{rng.integers(1 << 62):x}/"
            f"{rng.integers(1 << 62):x}"] = _value(rng, DTYPES[k % 4], (2,))
    return out


def _save(prefix, tensors, slices=None):
    names = list(tensors)
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=names,
                      shape_and_slices=slices or [""] * len(names),
                      tensors=[tf.constant(tensors[n]) for n in names])
    return prefix


def _tf_read(path):
    reader = tf.train.load_checkpoint(path)
    return {n: np.asarray(reader.get_tensor(n))
            for n in reader.get_variable_to_shape_map()}


def _assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        g = got[n]
        assert g.dtype == w.dtype and g.shape == w.shape, n
        assert g.tobytes() == w.tobytes(), n


def _index_blocks(prefix):
    """How many data blocks the bundle's index table has."""
    with open(prefix + ".index", "rb") as f:
        data = f.read()
    index = tb._block(data, *tb._table_handles(data)[1], "index")
    return len(tb._block_entries(index, "index"))


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    rng = np.random.default_rng(0)
    tensors = _cases(rng)
    prefix = _save(str(tmp_path_factory.mktemp("b") / "model.ckpt"),
                   tensors)
    return prefix, tensors


def test_read_equals_tf_bit_for_bit(bundle):
    prefix, tensors = bundle
    want = _tf_read(prefix)
    _assert_bit_equal(tb.read_bundle(prefix, keep=None), want)
    _assert_bit_equal(want, {n: np.asarray(v) for n, v in tensors.items()})


def test_index_has_more_than_one_data_block(bundle):
    assert _index_blocks(bundle[0]) > 1


def test_default_filter_is_load_tf1_variables(bundle):
    """The JAX package's reader (TF, `load_tf1_variables`: no optimizer
    slots, no beta powers) and the port's default agree."""
    prefix, _ = bundle
    got = tb.read_bundle(prefix)
    assert "beta1_power" not in got
    assert "G/fully_connected_1/weights/Adam_1" not in got
    _assert_bit_equal(got, {n: np.asarray(v) for n, v in
                            load_tf1_variables(prefix).items()})


def test_two_shards_and_a_checkpoint_directory(tmp_path):
    rng = np.random.default_rng(1)
    parts = [_cases(rng, 0), {f"other/{k}": _value(rng, np.float64, (3, k))
                              for k in range(1, 6)}]
    tmp = tmp_path / "tmp"
    prefixes = [_save(str(tmp / f"part-{i:05d}-of-00002"), p)
                for i, p in enumerate(parts)]
    final = str(tmp_path / "ckpt" / "model.ckpt-7")
    tf.raw_ops.MergeV2Checkpoints(checkpoint_prefixes=prefixes,
                                  destination_prefix=final)
    assert os.path.exists(final + ".data-00001-of-00002")
    (tmp_path / "ckpt" / "checkpoint").write_text(
        'model_checkpoint_path: "model.ckpt-7"\n'
        'all_model_checkpoint_paths: "model.ckpt-7"\n')
    want = _tf_read(str(tmp_path / "ckpt"))
    assert len(want) == sum(len(p) for p in parts)
    _assert_bit_equal(tb.read_bundle(final, keep=None), want)
    _assert_bit_equal(tb.read_bundle(str(tmp_path / "ckpt"), keep=None),
                      want)


def test_tf_reads_what_write_bundle_writes(tmp_path):
    rng = np.random.default_rng(2)
    tensors = _cases(rng)
    prefix = tb.write_bundle(str(tmp_path / "w" / "model.ckpt"), tensors)
    assert _index_blocks(prefix) > 1
    want = {n: np.asarray(v) for n, v in tensors.items()}
    _assert_bit_equal(_tf_read(prefix), want)
    _assert_bit_equal(tb.read_bundle(prefix, keep=None), want)


def _data_block(prefix):
    """(offset, size) of the index file's first data block."""
    with open(prefix + ".index", "rb") as f:
        data = f.read()
    index = tb._block(data, *tb._table_handles(data)[1], "index")
    handle = tb._block_entries(index, "index")[0][1]
    off, p = tb._varint(handle, 0, len(handle))
    return off, tb._varint(handle, p, len(handle))[0]


def test_a_corrupted_tensor_raises_on_its_crc(tmp_path):
    prefix = _save(str(tmp_path / "m"), {"a": np.arange(64, dtype=np.float32),
                                         "b": np.ones(3, np.int64)})
    path = prefix + ".data-00000-of-00001"
    raw = bytearray(open(path, "rb").read())
    raw[17] ^= 0x40
    open(path, "wb").write(bytes(raw))
    with pytest.raises(tb.CorruptBundleError, match="a: CRC mismatch"):
        tb.read_bundle(prefix)
    with pytest.raises(tb.CorruptBundleError, match="CRC"):
        tb.read_bundle(prefix, keep=lambda n: n == "a")
    assert tb.read_bundle(prefix, keep=lambda n: n == "b")["b"].sum() == 3


def test_a_string_tensor_raises(tmp_path):
    prefix = str(tmp_path / "s")
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=["w", "words"],
                      shape_and_slices=["", ""],
                      tensors=[tf.constant([1.0]), tf.constant(["a", "bc"])])
    with pytest.raises(tb.UnsupportedDtypeError, match="words: dtype string"):
        tb.read_bundle(prefix)
    assert tb.read_bundle(prefix, keep=lambda n: n == "w")["w"][0] == 1.0


def test_a_compressed_block_raises(tmp_path):
    prefix = _save(str(tmp_path / "c"), {"a": np.ones(3, np.float32)})
    off, size = _data_block(prefix)
    raw = bytearray(open(prefix + ".index", "rb").read())
    raw[off + size] = 1                       # snappy
    open(prefix + ".index", "wb").write(bytes(raw))
    with pytest.raises(tb.CompressedBlockError, match="snappy"):
        tb.read_bundle(prefix)


def test_a_partitioned_variable_raises(tmp_path):
    prefix = str(tmp_path / "p")
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=["part", "whole"],
                      shape_and_slices=["6 2 0,3:-", ""],
                      tensors=[tf.zeros((3, 2)), tf.ones(2)])
    with pytest.raises(tb.PartitionedVariableError, match="part"):
        tb.read_bundle(prefix)


def test_a_big_endian_bundle_raises(tmp_path):
    """The header's endianness field set to BIG (1) in an otherwise valid
    table."""
    prefix = tb.write_bundle(str(tmp_path / "e"), {"a": np.ones(2)})
    off, size = _data_block(prefix)
    data = open(prefix + ".index", "rb").read()
    entries = tb._block_entries(data[off:off + size], "data")
    block = tb._BlockBuilder()
    header = entries[0][1] + b"\x10\x01"          # field 2 = BIG
    for key, value in [(b"", header)] + entries[1:]:
        block.add(key, value)
    with open(prefix + ".index", "wb") as f:
        index = tb._BlockBuilder()
        index.add(block.last, tb._write_block(f, block.finish()))
        handles = (tb._write_block(f, tb._BlockBuilder().finish())
                   + tb._write_block(f, index.finish()))
        f.write(handles + bytes(40 - len(handles))
                + struct.pack("<Q", tb.TABLE_MAGIC))
    with pytest.raises(tb.BigEndianBundleError):
        tb.read_bundle(prefix)


def test_not_a_bundle_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tb.read_bundle(str(tmp_path / "missing"))
    (tmp_path / "x.index").write_bytes(bytes(64))
    with pytest.raises(tb.CorruptBundleError, match="magic"):
        tb.read_bundle(str(tmp_path / "x"))
