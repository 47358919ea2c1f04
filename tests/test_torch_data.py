"""The port's tfrecord data path against the JAX package's: the record
framing and CRC, the tf.Example parser (native and plain), the encoder and
`build_pair_example`, the pair loader in every worker mode, shuffle
setting and host split, the end of a finite split in the testers, and a
model-1 CLI run on tfrecords. Records come from the JAX package's test
helper (`tests/test_data.py:make_example`, protobuf) and from the port's
`build_pair_example`. Everything here is exact: the same machine decodes
the same JPEGs with the same PIL, so batches are held bit for bit.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from dpig_tpu.data import loader as jloader
from dpig_tpu.data import pose_tools as jpose
from dpig_tpu.data import tfrecord as jtfrecord
from dpig_tpu.data.convert.builder import build_pair_example as jbuild
from dpig_tpu.data.proto import example_pb2 as pb
from dpig_tpu_torch import main as port_main
from dpig_tpu_torch.data import example, loader, native, tfrecord
from dpig_tpu_torch.data.synthetic import write_synthetic_tfrecords
from test_data import _jpeg_bytes, make_example

torch.set_num_threads(1)

H, W = 32, 16
PARSERS = ("native", "plain")


def _write(path, recs, writer=tfrecord.TFRecordWriter):
    with writer(str(path)) as w:
        for r in recs:
            w.write(r)
    return str(path)


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _peaks(rng, kp=18):
    return [[[float(rng.uniform(0, W - 1)), float(rng.uniform(0, H - 1)),
              0.9, k]] if k == 0 or rng.uniform() > 0.2 else []
            for k in range(kp)]


def _pair_kwargs(rng):
    """The JAX builder's arguments, and the port builder's: the masks and
    part boxes computed by the JAX package's pose_tools (not ported)."""
    kw = dict(name_0="a.jpg", name_1="b.jpg", image_raw_0=_jpeg_bytes(
        rng, H, W), image_raw_1=_jpeg_bytes(rng, H, W), peaks_0=_peaks(rng),
        peaks_1=_peaks(rng), height=H, width=W, label=1, id_0=3, id_1=3,
        cam_0=1, cam_1=4)
    port = dict(kw)
    for s in ("_0", "_1"):
        peaks = kw[f"peaks{s}"]
        port[f"masks{s}"] = {
            key: jpose.get_pose_mask(peaks, H, W, radius=r, mode="Solid")
            for r, key in ((4, "pose_mask_r4"), (7, "pose_mask_r6"))}
        port[f"part_bbox{s}"], port[f"part_vis{s}"] = jpose.get_part_bbox37(
            peaks, H, W, radius=6)
    return kw, port


# ------------------------------------------------------------ framing
def test_tfrecord_roundtrip_and_files_match_jax(tmp_path, rng):
    """Port writer -> both readers (native and plain, CRCs verified) and
    JAX's reader; JAX writer -> the port's; the two files are byte-equal."""
    recs = [make_example(rng) for _ in range(5)] + [b""]
    ours = _write(tmp_path / "ours.tfrecord", recs)
    theirs = _write(tmp_path / "theirs.tfrecord", recs,
                    jtfrecord.TFRecordWriter)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for native_scan in (True, False):
        assert list(tfrecord.read_records(ours, True, native_scan)) == recs
    assert list(jtfrecord.read_records(ours, verify_crc=True)) == recs
    mf = native.MmapRecordFile(theirs, verify_crc=True)
    assert [mf[i] for i in range(len(mf))] == recs
    assert tfrecord.list_shards(str(tmp_path), "our") == [ours]


def test_crc32c_native_matches_the_table_and_jax(rng):
    assert native.crc32c(b"123456789") == tfrecord.crc32c_plain(
        b"123456789") == 0xE3069283  # the CRC-32C check value
    for n in (0, 1, 7, 8, 9, 63, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tfrecord.masked_crc(data) == tfrecord.masked_crc_plain(
            data) == jtfrecord.masked_crc(data)


def test_corrupt_and_truncated_files_raise(tmp_path, rng):
    """A flipped payload byte fails the CRC, a truncated tail record
    raises in both readers. (The JAX package's native reader yields the
    truncated record short instead; its plain reader raises.)"""
    recs = [make_example(rng) for _ in range(3)]
    data = open(_write(tmp_path / "t.tfrecord", recs), "rb").read()
    cut = tmp_path / "cut.tfrecord"
    cut.write_bytes(data[:-10])
    bad = bytearray(data)
    bad[30] ^= 1
    flipped = tmp_path / "flip.tfrecord"
    flipped.write_bytes(bytes(bad))
    for native_scan in (True, False):
        with pytest.raises(IOError):
            list(tfrecord.read_records(str(cut), False, native_scan))
        with pytest.raises(IOError):
            list(tfrecord.read_records(str(flipped), True, native_scan))
        assert len(list(tfrecord.read_records(str(flipped), False,
                                              native_scan))) == 3
    assert len(list(jtfrecord.read_records(str(cut)))) == 3


def test_a_failed_host_build_raises_with_the_compiler_output(tmp_path,
                                                             monkeypatch):
    """No quiet fallback: a source g++ cannot build raises with g++'s
    message and leaves no library behind."""
    from dpig_tpu_torch.kernels import _build
    (tmp_path / "broken.cc").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match=r"g\+\+ failed for broken.cc"
                                            r"(.|\n)*error"):
        _build.load_host("broken")
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.endswith(".so")]


def test_count_records(tmp_path, rng):
    path = _write(tmp_path / "c.tfrecord", [make_example(rng)
                                            for _ in range(9)])
    assert tfrecord.count_records(path) == jtfrecord.count_records(path) == 9
    assert sum(1 for _ in tfrecord.read_records(path)) == 9


# -------------------------------------------------------------- parsing
@pytest.mark.parametrize("parser", PARSERS)
def test_parse_example_matches_jax(parser, rng):
    """Every key bit-equal to JAX's parse_example (x exactly in float32,
    masks, bbox, vis, rcv), dtypes too, at two shapes, on protobuf records
    and on the port's own; `pose_only` likewise."""
    for h, w in ((H, W), (48, 24)):
        for _ in range(3):
            rec = make_example(rng, h, w)
            _assert_batches_equal(
                loader.parse_example(rec, h, w, parser=parser),
                jloader.parse_example(rec, h, w))
            _assert_batches_equal(
                loader.parse_example(rec, h, w, fields="pose_only",
                                     parser=parser),
                jloader.parse_example(rec, h, w, fields="pose_only"))
    _, port_kw = _pair_kwargs(rng)
    rec = example.build_pair_example(**port_kw)
    _assert_batches_equal(loader.parse_example(rec, H, W, parser=parser),
                          jloader.parse_example(rec, H, W))


def test_build_pair_example_matches_the_jax_builder(rng):
    """The port's record parses (protobuf) to the same Example as the JAX
    package's `build_pair_example` on the same peaks, masks and boxes."""
    for _ in range(3):
        jax_kw, port_kw = _pair_kwargs(rng)
        ours = pb.Example.FromString(example.build_pair_example(**port_kw))
        assert ours == pb.Example.FromString(jbuild(**jax_kw))
    assert example.build_pair_example(**{**port_kw, "peaks_0": None}) is None


def test_encoder_matches_protobuf(rng):
    """Packed int64 (negatives and 10-byte varints), float (rounded from
    float64 as protobuf does) and bytes lists."""
    ints = rng.integers(-2 ** 63, 2 ** 63 - 1, 40, dtype=np.int64,
                        endpoint=True) >> rng.integers(0, 63, 40)
    floats = rng.standard_normal(9)
    rec = example.encode_example({"i": ("int64", ints),
                                  "f": ("float", floats),
                                  "b": ("bytes", [b"xy", b"", b"z"])})
    want = pb.Example()
    want.features.feature["i"].int64_list.value.extend(ints.tolist())
    want.features.feature["f"].float_list.value.extend(floats.tolist())
    want.features.feature["b"].bytes_list.value.extend([b"xy", b"", b"z"])
    assert pb.Example.FromString(rec) == want
    for parser in (native.parse_example_features,
                   example.parse_example_features_plain):
        got = parser(rec, [("i", 40), ("f", 9), ("b", 0), ("x", 3)])
        np.testing.assert_array_equal(got["i"], ints.astype(np.float32))
        np.testing.assert_array_equal(got["f"], floats.astype(np.float32))
        off, n = got["b"]
        assert rec[off:off + n] == b"xy" and got["x"] is None


def _duplicated():
    def one(vals, bts):
        ex = pb.Example()
        ex.features.feature["f"].float_list.value.extend(vals)
        ex.features.feature["b"].bytes_list.value.append(bts)
        return ex.SerializeToString()
    return one([1.0, 2.0], b"first") + one([7.0, 8.0, 9.0], b"second")


@pytest.mark.parametrize("parser", PARSERS)
def test_duplicate_keys_last_wins(parser):
    """proto3 map semantics, as protobuf and the JAX parser read them; a
    feature past its capacity gives its true count (an int)."""
    rec = _duplicated()
    merged = pb.Example.FromString(rec)
    assert list(merged.features.feature["f"].float_list.value) == [7, 8, 9]
    fn = (native.parse_example_features if parser == "native"
          else example.parse_example_features_plain)
    out = fn(rec, [("f", 8), ("b", 0)])
    np.testing.assert_array_equal(out["f"], [7.0, 8.0, 9.0])
    boff, blen = out["b"]
    assert rec[boff:boff + blen] == b"second"
    assert fn(rec, [("f", 2)])["f"] == 3


def _mutations(rng, rec, n):
    for trial in range(n):
        mut = bytearray(rec)
        for _ in range(rng.integers(1, 8)):
            mut[rng.integers(0, len(mut))] = rng.integers(0, 256)
        if trial % 4 == 0:
            mut = mut[:rng.integers(0, len(mut))]
        yield bytes(mut)


def test_native_parser_fuzz_agrees_with_plain(rng):
    """Byte-mutated and truncated records never crash the C++ parser, and
    its plain version gives the same result on every one, a clean
    IOError included; so do both of `parse_example`'s paths."""
    wanted = [("pose_peaks_0_rcv", 54), ("pose_peaks_1_rcv", 54),
              ("image_raw_0", 0), ("pose_mask_r4_0", 60),
              ("part_bbox_1", 148), ("part_vis_0", 37), ("label", 0)]
    outcomes = {"ok": 0, "IOError": 0}

    def run(fn, rec):
        try:
            return fn(rec, wanted)
        except IOError:
            return "IOError"

    rec = make_example(rng, 12, 6)
    for mut in _mutations(rng, rec, 1500):
        got = run(native.parse_example_features, mut)
        want = run(example.parse_example_features_plain, mut)
        outcomes["IOError" if got == "IOError" else "ok"] += 1
        if got == "IOError" or want == "IOError":
            assert got == want
            continue
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert got[k].tobytes() == v.tobytes(), k
            else:
                assert got[k] == v, k
    assert min(outcomes.values()) > 100, outcomes  # both kinds were seen
    for mut in _mutations(rng, rec, 40):
        results = []
        for parser in PARSERS:
            try:
                results.append(loader.parse_example(mut, 12, 6,
                                                    fields="pose_only",
                                                    parser=parser))
            except (IOError, ValueError) as e:
                results.append(type(e))
        if isinstance(results[0], dict):
            _assert_batches_equal(*results)
        else:
            assert results[0] == results[1]


# --------------------------------------------------------------- loader
def _dataset(tmp_path, rng, split="train", sizes=(12,), pickle_n=None):
    for i, n in enumerate(sizes):
        _write(tmp_path / f"Market1501_{split}_{i:05d}.tfrecord",
               [make_example(rng, H, W) for _ in range(n)])
    if pickle_n is not None:
        with open(tmp_path / f"pn_pairs_num_{split}.p", "wb") as f:
            pickle.dump(pickle_n, f, protocol=2)
    return str(tmp_path)


def _drain(ld, n=None):
    out = []
    try:
        while n is None or len(out) < n:
            out.append(next(ld))
    except StopIteration:
        pass
    return out


@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered",
                                                        "shuffled"])
@pytest.mark.parametrize("workers,mode", [(0, "thread"), (2, "thread"),
                                          (2, "process")],
                         ids=["0", "2threads", "2processes"])
def test_pair_loader_matches_jax(tmp_path, rng, shuffle, workers, mode):
    """The port's batches equal the JAX loader's bit for bit and in the
    same order (shuffled: the same seed gives the same order)."""
    d = _dataset(tmp_path, rng, sizes=(7, 5))
    kw = dict(batch_size=4, img_h=H, img_w=W, dataset="Market_train_data",
              shuffle=shuffle, seed=7, shuffle_buffer=6)
    want = _drain(jloader.TFRecordPairLoader(d, "train", **kw), 5)
    with loader.TFRecordPairLoader(d, "train", num_workers=workers,
                                   worker_mode=mode, **kw) as ld:
        got = _drain(ld, 5)
    assert len(got) == len(want) == (5 if shuffle else 3)
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)


@pytest.mark.parametrize("sizes,pickled", [((7,), 7), ((5,), None),
                                           ((5, 2), 7), ((5, 2), None)],
                         ids=["stride", "stride-count", "shards",
                              "shards-count"])
def test_pair_loader_host_split_matches_jax(tmp_path, rng, sizes, pickled):
    """host_count=2 with fewer shards than hosts (records dealt
    round-robin) and with a shard each (uneven), with and without the
    pair-count pickle: the per-host num_samples and batches are JAX's."""
    d = _dataset(tmp_path, rng, sizes=sizes, pickle_n=pickled)
    for host in range(2):
        kw = dict(batch_size=1, img_h=H, img_w=W, dataset="market",
                  shuffle=False, host_id=host, host_count=2)
        ref = jloader.TFRecordPairLoader(d, "train", **kw)
        ld = loader.TFRecordPairLoader(d, "train", **kw)
        assert ld.num_samples == ref.num_samples
        got, want = _drain(ld), _drain(ref)
        assert len(got) == len(want) == ld.num_samples
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)


def test_pair_count_pickle_holds_a_number(tmp_path, rng):
    """The py2 pickle is read as JAX reads it; one that names a callable
    is refused, not run."""
    d = _dataset(tmp_path, rng, sizes=(3,), pickle_n=3)
    ld = loader.TFRecordPairLoader(d, "train", batch_size=1, img_h=H,
                                   img_w=W)
    assert ld.num_samples == 3
    with open(tmp_path / "pn_pairs_num_train.p", "wb") as f:
        pickle.dump(print, f, protocol=2)
    with pytest.raises(pickle.UnpicklingError, match=r"\.print; expected"):
        loader.TFRecordPairLoader(d, "train", batch_size=1, img_h=H,
                                  img_w=W)


def test_pair_loader_pose_only_and_sticky_stop(tmp_path, rng):
    """fields='pose_only' batches are JAX's; after the end of a finite
    split every next() raises StopIteration, with and without prefetch."""
    d = _dataset(tmp_path, rng, split="test", sizes=(9,))
    kw = dict(batch_size=4, img_h=H, img_w=W, dataset="market",
              shuffle=False)
    for g, w in zip(_drain(loader.TFRecordPairLoader(
            d, "test", fields="pose_only", **kw)), _drain(
            jloader.TFRecordPairLoader(d, "test", fields="pose_only", **kw))):
        _assert_batches_equal(g, w)
    for workers in (0, 1):
        with loader.TFRecordPairLoader(d, "test", num_workers=workers,
                                       prefetch_batches=2, **kw) as ld:
            assert len(_drain(ld)) == 2  # the last 1 of 9 is dropped
            for _ in range(3):
                with pytest.raises(StopIteration):
                    next(ld)


def test_a_wrong_flavor_or_a_missing_feature_raises(tmp_path, rng):
    rec = make_example(rng)
    with pytest.raises(KeyError, match="wrong dataset flavor"):
        loader.parse_example(rec, H, W, mask_a="pose_mask_r8")
    with pytest.raises(ValueError, match="pose_peaks_0_rcv"):
        loader.parse_example(example.encode_example(
            {"label": ("int64", [1])}), H, W, fields="pose_only")
    with pytest.raises(ValueError, match="parser"):
        loader.parse_example(rec, H, W, parser="protobuf")


# ------------------------------------------------------- testers and CLI
SMALL = dict(img_H=H, img_W=W, batch_size=4, conv_hidden_num=16, z_num=16)


def test_tester_raises_at_the_end_of_the_split_as_jax_does(tmp_path):
    """10 test pairs, batches of 4: asked for 3 batches, model 12 writes
    2 and raises StopIteration, in the JAX package and in the port (its
    CLI here); asked for 2, the port's tree holds the same inputs as
    JAX's."""
    from dpig_tpu.apps.testers import ConditionalTransferTester
    from dpig_tpu.config import Config as JaxConfig
    d = str(tmp_path / "data" / "Market1501")
    write_synthetic_tfrecords(d, "test", 10, H, W, seed=4)
    kw = dict(batch_size=4, img_h=H, img_w=W, dataset="market",
              shuffle=False)
    jt = ConditionalTransferTester(JaxConfig(model_dir=str(tmp_path / "j"),
                                             **SMALL))
    flags = ["--model=12", "--is_train=false", "--platform=cpu",
             "--img_H=32", "--img_W=16", "--batch_size=4",
             "--conv_hidden_num=16", "--z_num=16",
             f"--data_dir={tmp_path / 'data'}", "--dataset=Market1501",
             "--num_worker=2"]
    with pytest.raises(StopIteration):
        jt.run(jloader.TFRecordPairLoader(d, "test", **kw), test_batch_num=3)
    with pytest.raises(StopIteration):
        port_main.main([*flags, "--test_batch_num=3",
                        f"--model_dir={tmp_path / 'p3'}"])
    for root in (tmp_path / "j" / "test_result",
                 tmp_path / "p3" / "test_result"):
        assert len(os.listdir(root / "G")) == 8
    port_main.main([*flags, "--test_batch_num=2",
                    f"--model_dir={tmp_path / 'p2'}"])
    from PIL import Image
    for sub in ("x", "x_target", "mask", "mask_target", "pose"):
        for f in sorted(os.listdir(tmp_path / "j" / "test_result" / sub)):
            a, b = (np.asarray(Image.open(r / "test_result" / sub / f))
                    for r in (tmp_path / "j", tmp_path / "p2"))
            np.testing.assert_array_equal(a, b, err_msg=f"{sub}/{f}")


def test_cli_model1_trains_on_tfrecords(tmp_path, monkeypatch):
    """`python -m dpig_tpu_torch.main --model=1` on a Market train split,
    no --synthetic_data: its fixed preview batch is the first batch of the
    JAX CLI's loader (the root main.py's make_loader, same flags), and
    the run writes its metrics and checkpoint."""
    import main as jax_main
    from dpig_tpu.config import get_config as jax_get_config
    from dpig_tpu_torch.train.harness import Trainer
    write_synthetic_tfrecords(str(tmp_path / "data" / "Market1501"),
                              "train", 12, H, W, seed=5, n_shards=2)
    flags = ["--model=1", "--img_H=32", "--img_W=16", "--batch_size=4",
             "--conv_hidden_num=16", "--z_num=16",
             f"--data_dir={tmp_path / 'data'}", "--dataset=Market1501",
             "--num_worker=2", "--max_step=2", "--log_step=1"]
    seen = []
    orig = Trainer._save_fixed_previews
    monkeypatch.setattr(Trainer, "_save_fixed_previews",
                        lambda self, b: (seen.append(b), orig(self, b)))
    port_main.main([*flags, "--platform=cpu",
                    f"--model_dir={tmp_path / 'm1'}"])
    ref = next(jax_main.make_loader(jax_get_config(
        [*flags, f"--model_dir={tmp_path / 'jax'}"])))
    _assert_batches_equal(seen[0], ref)
    with open(tmp_path / "m1" / "metrics.jsonl") as f:
        assert len(f.readlines()) == 2
    assert os.path.exists(tmp_path / "m1" / "ckpt" / "step_00000002" /
                          "state.pt")


# --------------------------------------------------------------- imports
def test_the_port_imports_no_protobuf_or_google_crc32c(tmp_path):
    """A fresh interpreter that reads, parses and batches a dataset
    through the port (and imports its CLI) has loaded neither
    google.protobuf nor google_crc32c (nor JAX)."""
    d = str(tmp_path)
    write_synthetic_tfrecords(d, "test", 4, H, W)
    code = (
        "import sys\n"
        "import dpig_tpu_torch.main\n"
        "from dpig_tpu_torch.data.loader import TFRecordPairLoader\n"
        f"b = next(TFRecordPairLoader({d!r}, 'test', 4, {H}, {W}, "
        "shuffle=False, num_workers=2))\n"
        "assert b['x'].shape == (4, 32, 16, 3)\n"
        "bad = [m for m in sys.modules if m == 'google_crc32c' or "
        "m.startswith('google.protobuf') or m.split('.')[0] in "
        "('jax', 'dpig_tpu')]\n"
        "print(bad)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
