"""The input pipeline: ``horovod_tpu_torch.training.data`` against
``horovod_tpu.training.data`` on the CPU.

Every array must equal the JAX package's exactly (``np.array_equal``): the
IDX reader (gz and raw), the loaders, ``build_vocab``,
``skipgram_batches``, and the shuffled orders and pixels of
``ShardedDataset`` and ``ImageFolderDataset`` — the port's per-rank batches
stacked over the ranks are the reference's rank-stacked batch (ROADMAP §C,
"a process is a rank"). Also: the texts of the missing-file and bad-depth
errors, ``prefetch_to_device`` on the CPU (order, dtype) and the
``HOROVOD_PREFETCH_DEPTH`` / ``HOROVOD_DATA_DIR`` knobs.
"""

import gzip
import os
import struct
import zipfile

import numpy as np
import pytest
import torch

from horovod_tpu.training import data as jdata
from horovod_tpu.utils import env as jenv
from horovod_tpu_torch.training import data as tdata
from horovod_tpu_torch.utils import env as tenv


def _write_idx(path, arr):
    codes = {np.dtype(np.uint8): 0x08, np.dtype(np.int8): 0x09,
             np.dtype(np.int16): 0x0B, np.dtype(np.int32): 0x0C,
             np.dtype(np.float32): 0x0D, np.dtype(np.float64): 0x0E}
    header = struct.pack(">HBB", 0, codes[arr.dtype], arr.ndim)
    header += struct.pack(f">{arr.ndim}I", *arr.shape)
    payload = header + arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)


@pytest.mark.parametrize("suffix", [".gz", ""])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32, np.float32,
                                   np.float64])
def test_read_idx_equals_the_reference(tmp_path, suffix, dtype):
    rng = np.random.RandomState(0)
    arr = (rng.rand(5, 3, 4) * 100).astype(dtype)
    path = str(tmp_path / f"a.idx{suffix}")
    _write_idx(path, arr)
    got = tdata.read_idx(path)
    want = jdata.read_idx(path)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want) and np.array_equal(got, arr)


@pytest.mark.parametrize("damage", ["magic", "truncated"])
def test_read_idx_damage_raises_the_reference_error(tmp_path, damage):
    path = str(tmp_path / "bad.idx")
    _write_idx(path, np.arange(12, dtype=np.uint8).reshape(3, 4))
    raw = open(path, "rb").read()
    raw = b"\x01" + raw[1:] if damage == "magic" else raw[:-3]
    open(path, "wb").write(raw)
    msgs = []
    for mod in (tdata, jdata):
        with pytest.raises(ValueError) as err:
            mod.read_idx(path)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def _mnist_dir(tmp_path, gz=True):
    rng = np.random.RandomState(1)
    arrays = {"train-images-idx3-ubyte": rng.randint(0, 256, (12, 28, 28)),
              "train-labels-idx1-ubyte": rng.randint(0, 10, 12),
              "t10k-images-idx3-ubyte": rng.randint(0, 256, (4, 28, 28)),
              "t10k-labels-idx1-ubyte": rng.randint(0, 10, 4)}
    for name, a in arrays.items():
        _write_idx(str(tmp_path / (name + (".gz" if gz else ""))),
                   a.astype(np.uint8))
    return str(tmp_path)


@pytest.mark.parametrize("gz", [True, False])
def test_load_mnist_equals_the_reference(tmp_path, gz):
    d = _mnist_dir(tmp_path, gz)
    got = tdata.load_mnist(d, download=False)
    want = jdata.load_mnist(d, download=False)
    for gpair, wpair in zip(got, want):
        for g, w in zip(gpair, wpair):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[0][0].shape == (12, 28, 28) and got[1][1].shape == (4,)


def test_missing_files_raise_file_not_found(tmp_path, monkeypatch):
    d = str(tmp_path / "empty")
    # download=False: the reference's text, byte for byte.
    msgs = []
    for mod in (tdata, jdata):
        with pytest.raises(FileNotFoundError) as err:
            mod.load_mnist(d, download=False)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    # The default: the port names the path and never downloads.
    for load in (tdata.load_mnist, tdata.load_text8):
        with pytest.raises(FileNotFoundError) as err:
            load(d)
        assert d in str(err.value)
        assert "does not download" in str(err.value)
    monkeypatch.setenv("HOROVOD_DATA_DIR", d)
    assert tdata.default_data_dir() == jdata.default_data_dir() == d
    with pytest.raises(FileNotFoundError, match="does not download"):
        tdata.load_mnist()


def test_text8_vocab_and_skipgrams_equal_the_reference(tmp_path):
    rng = np.random.RandomState(2)
    words = [f"w{int(i)}" for i in rng.zipf(1.5, size=400) % 50]
    with zipfile.ZipFile(tmp_path / "text8.zip", "w") as z:
        z.writestr("text8", " ".join(words))
    got = tdata.load_text8(str(tmp_path), max_words=300)
    assert got == jdata.load_text8(str(tmp_path), max_words=300)
    assert got == words[:300]
    t_ids, t_counts, t_w2i, t_i2w = tdata.build_vocab(got, 20)
    j_ids, j_counts, j_w2i, j_i2w = jdata.build_vocab(got, 20)
    assert np.array_equal(t_ids, j_ids) and t_ids.dtype == j_ids.dtype
    assert t_counts == j_counts and t_w2i == j_w2i and t_i2w == j_i2w
    for start in (0, 37):
        tg = tdata.skipgram_batches(t_ids, 16, 2, 1, start=start)
        jg = jdata.skipgram_batches(j_ids, 16, 2, 1, start=start)
        for _ in range(30):  # past the corpus's end: the window wraps
            for a, b in zip(next(tg), next(jg)):
                assert np.array_equal(a, b) and a.dtype == b.dtype
    for args in ((15, 2, 1), (16, 4, 1)):
        msgs = []
        for mod in (tdata, jdata):
            with pytest.raises(ValueError) as err:
                next(mod.skipgram_batches(t_ids, *args))
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("size,batch,drop", [(2, 4, True), (3, 5, True),
                                             (3, 4, False)])
def test_sharded_dataset_stacked_over_ranks_equals_the_reference(
        size, batch, drop):
    rng = np.random.RandomState(3)
    x = rng.rand(50, 3).astype(np.float32)
    y = np.arange(50, dtype=np.int32)
    tds = tdata.ShardedDataset([x, y], size, batch, seed=4,
                               drop_remainder=drop)
    jds = jdata.ShardedDataset([x, y], size, batch, seed=4,
                               drop_remainder=drop)
    assert tds.steps_per_epoch == jds.steps_per_epoch
    for epoch in (0, 1, 5):
        ranks = [list(tds.batches(epoch, rank=r)) for r in range(size)]
        want = list(jds.batches(epoch))
        assert all(len(r) == len(want) for r in ranks)
        for step, jb in enumerate(want):
            for j, arr in enumerate(jb):
                if drop:
                    got = np.stack([ranks[r][step][j] for r in range(size)])
                    assert np.array_equal(got, arr)
                else:  # the ragged last batch: compare rank by rank
                    for r in range(size):
                        assert np.array_equal(ranks[r][step][j], arr[r])


def test_sharded_dataset_defaults_to_this_ranks_batches():
    import horovod_tpu_torch as hvd

    x = np.arange(40, dtype=np.float32)
    ds = tdata.ShardedDataset([x], 1, 4, seed=1)
    hvd.init(device="cpu")
    try:
        mine = [b[0] for b in ds.batches(2)]
    finally:
        hvd.shutdown()
    assert all(np.array_equal(a, b[0]) for a, b in
               zip(mine, ds.batches(2, rank=0)))
    with pytest.raises(hvd.HorovodError, match="no shard"):
        next(ds.batches(0, rank=1))


def _image_tree(root, classes=3, per_class=5):
    from PIL import Image

    rng = np.random.RandomState(5)
    for c in range(classes):
        os.makedirs(os.path.join(root, f"c{c}"))
        for i in range(per_class):
            h, w = 20 + 3 * i, 24 + 2 * c
            px = rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8)
            Image.fromarray(px).save(os.path.join(root, f"c{c}", f"{i}.png"))
    open(os.path.join(root, "c0", "notes.txt"), "w").write("skip me")


@pytest.mark.parametrize("train", [True, False])
def test_image_folder_stacked_over_ranks_equals_the_reference(tmp_path,
                                                              train):
    _image_tree(str(tmp_path))
    kw = dict(size=2, batch_size=3, image_size=16, train=train, seed=6,
              workers=2)
    tds = tdata.ImageFolderDataset(str(tmp_path), **kw)
    jds = jdata.ImageFolderDataset(str(tmp_path), **kw)
    assert tds.classes == jds.classes and tds.samples == jds.samples
    assert tds.steps_per_epoch == jds.steps_per_epoch == 2
    for epoch in (0, 1):
        ranks = [list(tds.batches(epoch, rank=r)) for r in range(2)]
        for step, (jimgs, jlabels) in enumerate(jds.batches(epoch)):
            imgs = np.stack([ranks[r][step][0] for r in range(2)])
            labels = np.stack([ranks[r][step][1] for r in range(2)])
            assert imgs.dtype == jimgs.dtype == np.float32
            assert np.array_equal(imgs, jimgs)
            assert np.array_equal(labels, jlabels)


def test_image_folder_errors_are_the_references(tmp_path):
    (tmp_path / "none").mkdir()
    _image_tree(str(tmp_path / "few"), classes=1, per_class=2)
    for root, kw in ((tmp_path / "none", dict(size=1, batch_size=1)),
                     (tmp_path / "few", dict(size=3, batch_size=1)),
                     (tmp_path / "few", dict(size=1, batch_size=3))):
        msgs = []
        for mod in (tdata, jdata):
            with pytest.raises(ValueError) as err:
                mod.ImageFolderDataset(str(root), **kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


# -- prefetch_to_device and its knob ------------------------------------------

@pytest.fixture
def cpu_world():
    import horovod_tpu_torch as hvd

    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_prefetch_on_the_cpu_yields_the_batches_in_order(cpu_world, depth,
                                                         dtype):
    rng = np.random.RandomState(7)
    batches = [(rng.rand(4, 2).astype(np.float32),
                np.arange(4, dtype=np.int32) + i) for i in range(5)]
    it = tdata.prefetch_to_device(iter(batches), dtype=dtype, depth=depth)
    got = list(it)
    assert len(got) == 5 and it.pulled == 5
    for (x, y), (gx, gy) in zip(batches, got):
        assert gx.device.type == "cpu"
        want = torch.from_numpy(x)
        if dtype is not None:
            want = want.to(dtype)
        assert gx.dtype == want.dtype and torch.equal(gx, want)
        assert gy.dtype == torch.int32 and torch.equal(gy,
                                                       torch.from_numpy(y))


@pytest.mark.parametrize("depth", [0, -1, 1.5, "2"])
def test_a_bad_depth_raises_the_reference_text_at_the_call(cpu_world, depth):
    def never():
        raise AssertionError("the source was read")
        yield

    with pytest.raises(ValueError) as err:
        tdata.prefetch_to_device(never(), depth=depth)
    assert str(err.value) == (
        f"prefetch_to_device depth must be a positive integer, got "
        f"{depth!r}")


@pytest.mark.parametrize("raw", [None, "1", "4", "0", "-2", "x", "2.5"])
def test_prefetch_depth_knob_is_read_like_the_reference(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("HOROVOD_PREFETCH_DEPTH", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_PREFETCH_DEPTH", raw)

    def outcome(fn):
        try:
            return fn()
        except ValueError as e:
            return ("raises", str(e))

    assert outcome(tenv.prefetch_depth) == outcome(jenv.prefetch_depth)


def test_prefetch_reads_the_depth_knob(cpu_world, monkeypatch):
    monkeypatch.setenv("HOROVOD_PREFETCH_DEPTH", "3")
    it = tdata.prefetch_to_device(iter([(np.zeros(2),)] * 5))
    assert it.depth == 3
    next(it)
    assert it.pulled == 4  # depth batches ahead of the one handed out
    monkeypatch.setenv("HOROVOD_PREFETCH_DEPTH", "zero")
    with pytest.raises(ValueError, match="HOROVOD_PREFETCH_DEPTH"):
        tdata.prefetch_to_device(iter([]))
