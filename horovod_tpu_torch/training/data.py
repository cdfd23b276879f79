"""Input pipelines: real-dataset loaders and the per-rank sharding convention.

Counterpart of ``horovod_tpu/training/data.py``, all of it but the
download: the port reads datasets that are already on disk and never
fetches one (it raises ``FileNotFoundError`` naming the path instead).

* :func:`read_idx` / :func:`load_mnist` — the IDX file format (the real
  MNIST distribution format) with gzip support, in the shared dataset
  directory (:func:`default_data_dir`, ``HOROVOD_DATA_DIR``).
* :func:`load_text8` / :func:`build_vocab` / :func:`skipgram_batches` —
  the word2vec corpus path (the reference's ``build_dataset`` /
  ``generate_batch`` semantics).
* :class:`ShardedDataset` / :class:`ImageFolderDataset` — the per-rank
  sharding convention: rank i of a group owns a contiguous 1/size slice of
  the examples and reshuffles it every epoch with a per-rank seed. A
  process is a rank, so :meth:`~ShardedDataset.batches` yields THIS rank's
  batches (``rank=`` picks another); the reference's rank-stacked batch is
  the stack over ranks of the port's. The seeds are the reference's, so the
  orders, crops and flips are equal to its.
* :func:`prefetch_to_device` — the host-to-device copy of the next
  ``depth`` batches, from pinned buffers on a side stream, overlapping the
  step on the current one.
"""

from __future__ import annotations

import gzip
import os
import struct
import zipfile
from collections import deque
from typing import Iterator, Sequence

import numpy as np
import torch

from horovod_tpu_torch.core import state as _state
from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.utils import env as _env

_MNIST_FILES = {
    "x_train": "train-images-idx3-ubyte.gz",
    "y_train": "train-labels-idx1-ubyte.gz",
    "x_test": "t10k-images-idx3-ubyte.gz",
    "y_test": "t10k-labels-idx1-ubyte.gz",
}

_IDX_DTYPES = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
               0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}


def default_data_dir() -> str:
    """``$HOROVOD_DATA_DIR`` or ``~/.horovod_tpu/datasets``."""
    return os.environ.get(
        "HOROVOD_DATA_DIR",
        os.path.join(os.path.expanduser("~"), ".horovod_tpu", "datasets"))


def _open_maybe_gz(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def read_idx(path: str) -> np.ndarray:
    """Read one IDX-format array (the MNIST distribution format):
    2 zero bytes, a dtype code, a rank byte, big-endian uint32 dims, then
    row-major data. Transparently handles ``.gz``."""
    try:
        with _open_maybe_gz(path) as f:
            zeros, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
            if zeros != 0 or dtype_code not in _IDX_DTYPES:
                raise ValueError(f"{path} is not an IDX file "
                                 f"(magic {zeros:#x}/{dtype_code:#x}).")
            dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
            dtype = np.dtype(_IDX_DTYPES[dtype_code]).newbyteorder(">")
            data = np.frombuffer(f.read(), dtype=dtype)
    except (struct.error, OSError, EOFError) as e:
        # Truncated/corrupt file (e.g. an interrupted manual copy):
        # normalize to ValueError so callers' fallbacks engage.
        raise ValueError(f"{path} is truncated or corrupt: {e}") from e
    if data.size != int(np.prod(dims)):
        raise ValueError(f"{path}: expected {np.prod(dims)} elements, "
                         f"got {data.size}.")
    return data.reshape(dims).astype(data.dtype.newbyteorder("="))


def _fetch(name: str, data_dir: str | None, download: bool) -> str:
    """The path of dataset file ``name`` (or of its uncompressed sibling)
    under ``data_dir``; a missing file raises ``FileNotFoundError``."""
    base = data_dir or default_data_dir()
    path = os.path.join(base, name)
    # An uncompressed sibling counts too (user-provided data).
    for suffix in (".gz", ".zip"):
        if not os.path.exists(path) and path.endswith(suffix) \
                and os.path.exists(path[:-len(suffix)]):
            return path[:-len(suffix)]
    if not os.path.exists(path):
        if not download:
            raise FileNotFoundError(
                f"{path} not found and download=False. Place the file "
                f"there or pass a data_dir that has it.")
        raise FileNotFoundError(
            f"{path} not found. horovod_tpu_torch does not download "
            f"datasets: place the file there, point HOROVOD_DATA_DIR at a "
            f"directory that has it, or use the example's --synthetic "
            f"fallback.")
    return path


def load_mnist(data_dir: str | None = None, download: bool = True):
    """((x_train, y_train), (x_test, y_test)) — images uint8 (N, 28, 28),
    labels uint8 (N,): the ``keras.datasets.mnist.load_data()`` surface the
    reference's examples consume, read from IDX files. ``download`` keeps
    the reference's signature; the port never downloads."""
    arrays = {}
    for key, fname in _MNIST_FILES.items():
        arrays[key] = read_idx(_fetch(fname, data_dir, download))
    return ((arrays["x_train"], arrays["y_train"]),
            (arrays["x_test"], arrays["y_test"]))


def load_text8(data_dir: str | None = None, download: bool = True,
               max_words: int | None = None) -> list[str]:
    """The text8 corpus as a word list (``text8.zip`` or an uncompressed
    ``text8`` in the data directory)."""
    path = _fetch("text8.zip", data_dir, download)
    try:
        if path.endswith(".zip"):
            with zipfile.ZipFile(path) as z:
                text = z.read(z.namelist()[0]).decode("ascii")
        else:  # an uncompressed `text8` placed by the user
            with open(path) as f:
                text = f.read()
    except (zipfile.BadZipFile, OSError, UnicodeDecodeError) as e:
        raise ValueError(f"{path} is truncated or corrupt: {e}") from e
    words = text.split()
    return words[:max_words] if max_words else words


def build_vocab(words: Sequence[str], vocab_size: int):
    """Most-common-``vocab_size`` vocabulary; everything else is UNK id 0.

    Returns (ids, counts, word_to_id, id_to_word) — the reference's
    ``build_dataset``."""
    from collections import Counter

    counts = [["UNK", -1]]
    counts.extend(Counter(words).most_common(vocab_size - 1))
    word_to_id = {w: i for i, (w, _) in enumerate(counts)}
    ids = np.asarray([word_to_id.get(w, 0) for w in words], np.int32)
    counts[0][1] = int(np.sum(ids == 0))
    id_to_word = {i: w for w, i in word_to_id.items()}
    return ids, counts, word_to_id, id_to_word


def _generate_batch(data, batch_size: int, num_skips: int, skip_window: int,
                    data_index: int):
    """One sliding-window skip-gram batch (context positions cycle rather
    than random-sample): (centers, contexts, new_data_index). The
    reference's ``models/word2vec.py::generate_batch``, whose model is not
    ported yet (ROADMAP §A item 11)."""
    batch_size = batch_size // num_skips * num_skips
    span = 2 * skip_window + 1
    centers = np.empty((batch_size,), np.int32)
    contexts = np.empty((batch_size,), np.int32)
    if data_index + span > len(data):
        data_index = 0
    offsets = [o for o in range(span) if o != skip_window]
    for i in range(batch_size // num_skips):
        window_start = data_index
        for j in range(num_skips):
            centers[i * num_skips + j] = data[window_start + skip_window]
            contexts[i * num_skips + j] = data[
                window_start + offsets[j % len(offsets)]]
        data_index = (data_index + 1) % (len(data) - span + 1)
    return centers, contexts, data_index


def skipgram_batches(ids: np.ndarray, batch_size: int, num_skips: int,
                     skip_window: int, start: int = 0
                     ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Endless (centers, contexts) skip-gram batches; ``start`` offsets the
    window so each rank can stream its own region of the corpus."""
    if batch_size % num_skips != 0:
        raise ValueError("batch_size must be a multiple of num_skips.")
    if num_skips > 2 * skip_window:
        raise ValueError("num_skips cannot exceed 2*skip_window.")
    pos = start
    while True:
        centers, contexts, pos = _generate_batch(
            ids, batch_size, num_skips, skip_window, pos)
        yield centers, contexts


def _epoch_seed(seed: int, epoch: int, r: int) -> int:
    # A tuple of ints hashes the same in every process (no hash
    # randomisation for ints), so every rank derives the reference's seeds.
    return (seed, epoch, r).__hash__() & 0x7FFFFFFF


def _resolve_rank(rank: int | None, group: int, size: int) -> int:
    r = _state.rank(group) if rank is None else rank
    if not 0 <= r < size:
        raise HorovodError(
            f"rank {r} has no shard: the dataset is sharded over {size} "
            f"ranks (a process outside group {group} has no batches).")
    return r


class ImageFolderDataset:
    """ImageNet-style ``root/<class>/<image>`` directory pipeline, sharded
    per rank, decoded in the background.

    Classes are the sorted subdirectory names; rank i of the group owns a
    contiguous 1/size slice of the (once globally shuffled) file list,
    reshuffled per epoch with a per-rank seed. :meth:`batches` yields this
    rank's ``[(batch, H, W, 3) images, (batch,) labels]``, the decodes and
    augmentations running on a thread pool (PIL releases the GIL in its C
    decoder) with the NEXT batch decoding while the current one trains —
    pair with :func:`prefetch_to_device` to also overlap the copy.

    Train-time augmentation: random resized crop to ``image_size`` +
    horizontal flip (``train=True``) or resize-shortest-side + center crop
    (``train=False``), from the reference's seeds, so each rank's pixels
    equal that rank's row of the reference's batch. Pixels come back as
    float32 in [0, 1).
    """

    EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")

    def __init__(self, root: str, size: int, batch_size: int,
                 image_size: int = 224, train: bool = True, seed: int = 0,
                 workers: int = 8, group: int = 0):
        try:
            from PIL import Image  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "ImageFolderDataset needs Pillow for JPEG decode.") from e
        self.root = root
        self.classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        if not self.classes:
            raise ValueError(f"{root} has no class subdirectories.")
        self.class_to_id = {c: i for i, c in enumerate(self.classes)}
        samples = []
        for c in self.classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(self.EXTENSIONS):
                    samples.append((os.path.join(cdir, fname),
                                    self.class_to_id[c]))
        if len(samples) < size:
            raise ValueError(
                f"{len(samples)} images cannot shard over {size} ranks.")
        # Deterministic global shuffle ONCE so class directories don't
        # turn contiguous shards into single-class shards.
        rng = np.random.RandomState(seed)
        rng.shuffle(samples)
        self.samples = samples
        self.size = size
        self.batch_size = batch_size
        self.image_size = image_size
        self.train = train
        self.seed = seed
        self.workers = workers
        self.group = group
        per = len(samples) // size
        self.shards = [samples[i * per:(i + 1) * per] for i in range(size)]
        self.steps_per_epoch = per // batch_size
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"Shard of {per} images is smaller than one batch "
                f"({batch_size}).")

    def _load(self, path: str, rng: np.random.RandomState) -> np.ndarray:
        from PIL import Image

        s = self.image_size
        with Image.open(path) as im:
            im = im.convert("RGB")
            if self.train:
                # Random resized crop: area 20-100%, then resize to the
                # target; horizontal flip p=0.5.
                w, h = im.size
                area = w * h
                for _ in range(4):
                    target = area * rng.uniform(0.2, 1.0)
                    ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
                    cw = int(round(np.sqrt(target * ar)))
                    ch = int(round(np.sqrt(target / ar)))
                    if cw <= w and ch <= h:
                        x0 = rng.randint(0, w - cw + 1)
                        y0 = rng.randint(0, h - ch + 1)
                        im = im.crop((x0, y0, x0 + cw, y0 + ch))
                        break
                im = im.resize((s, s), Image.BILINEAR)
                if rng.rand() < 0.5:
                    im = im.transpose(Image.FLIP_LEFT_RIGHT)
            else:
                w, h = im.size
                scale = s * 1.15 / min(w, h)
                im = im.resize((max(s, int(w * scale)),
                                max(s, int(h * scale))), Image.BILINEAR)
                w, h = im.size
                x0, y0 = (w - s) // 2, (h - s) // 2
                im = im.crop((x0, y0, x0 + s, y0 + s))
            return np.asarray(im, np.float32) / 255.0

    def batches(self, epoch: int = 0, rank: int | None = None
                ) -> Iterator[list[np.ndarray]]:
        """One epoch of rank ``rank``'s ``[images, labels]`` batches
        (default: this process's rank in the dataset's group), the next
        batch decoding in the background while the caller trains on the
        current one."""
        from concurrent.futures import ThreadPoolExecutor

        me = _resolve_rank(rank, self.group, self.size)
        order = np.arange(len(self.shards[me]))
        np.random.RandomState(_epoch_seed(self.seed, epoch, me)).shuffle(
            order)
        # One augmentation stream for the whole group, drawn in the
        # reference's order (rank by rank within a step), so each rank's
        # child seeds are those of its row of the reference's batch.
        aug = np.random.RandomState(_epoch_seed(self.seed, epoch, -1))
        b = self.batch_size

        def submit(step, pool):
            """Queue this rank's decodes of one batch; return the buffers
            and futures."""
            imgs = np.empty((b, self.image_size, self.image_size, 3),
                            np.float32)
            labels = np.empty((b,), np.int32)
            jobs = []
            for r in range(self.size):
                children = [aug.randint(2 ** 31) for _ in range(b)]
                if r != me:
                    continue
                picks = order[step * b:(step + 1) * b]
                for j, (k, child) in enumerate(zip(picks, children)):
                    path, label = self.shards[me][k]
                    labels[j] = label
                    jobs.append((j, pool.submit(
                        self._load, path, np.random.RandomState(child))))
            return imgs, labels, jobs

        def collect(parts):
            imgs, labels, jobs = parts
            for j, fut in jobs:
                imgs[j] = fut.result()
            return [imgs, labels]

        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            parts = submit(0, pool)
            for step in range(self.steps_per_epoch):
                # Batch step+1's decodes enter the pool BEFORE batch
                # step is yielded, so they run while the caller trains.
                nxt = (submit(step + 1, pool)
                       if step + 1 < self.steps_per_epoch else None)
                yield collect(parts)
                parts = nxt


class Prefetcher:
    """The iterator :func:`prefetch_to_device` returns. On the card, each
    source batch is cast (``dtype``) into pinned host buffers and copied
    with ``non_blocking`` copies on :attr:`stream`, a side stream, and an
    event recorded after the copies; up to ``depth`` batches stay in flight
    ahead of the one handed out. Handing a batch out makes the consumer's
    current stream wait on its event and records that stream on its device
    tensors (the allocator then keeps them until the consumer's work is
    done); its pinned buffers are released once its event has completed.
    :attr:`pulled` counts the source batches taken so far. On the CPU the
    batches come through in order, as tensors, cast where asked."""

    def __init__(self, batches, device: torch.device, dtype, depth: int
                 ) -> None:
        self.device = device
        self.dtype = dtype
        self.depth = depth
        self.pulled = 0
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self._it = self._run(iter(batches))

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._it)

    def _host(self, a) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        dtype = (self.dtype if self.dtype is not None
                 and t.dtype.is_floating_point else t.dtype)
        if self.stream is None:
            return t.to(dtype)
        buf = torch.empty(t.shape, dtype=dtype, pin_memory=True)
        buf.copy_(t)
        return buf

    def _put(self, batch):
        host = [self._host(a) for a in batch]
        if self.stream is None:
            return host, host, None
        with torch.cuda.stream(self.stream):
            dev = [h.to(self.device, non_blocking=True) for h in host]
            event = torch.cuda.Event()
            event.record(self.stream)
        return dev, host, event

    def _run(self, it):
        pending: deque = deque()
        retired: deque = deque()  # (event, pinned buffers) still copying
        for batch in it:
            self.pulled += 1
            pending.append(self._put(batch))
            if len(pending) > self.depth:
                yield self._hand_out(pending.popleft(), retired)
        while pending:
            yield self._hand_out(pending.popleft(), retired)
        for event, _ in retired:  # the last copies, before their buffers go
            event.synchronize()

    def _hand_out(self, item, retired: deque) -> list:
        dev, host, event = item
        if event is None:
            return dev
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(event)
        for t in dev:
            t.record_stream(cur)
        retired.append((event, host))
        while retired and retired[0][0].query():
            retired.popleft()
        return dev


def prefetch_to_device(batches, group: int = 0, dtype=None,
                       depth: int | None = None) -> Prefetcher:
    """Overlap the host-to-device copy with compute: keep up to ``depth``
    batches' copies in flight while the caller trains on the current one.
    Wraps any iterator of batches (sequences of numpy arrays or CPU
    tensors: :class:`ShardedDataset` / :class:`ImageFolderDataset` output)
    and yields each as a list of tensors on the rank's device
    (``hvd.init``'s), in order. ``dtype`` (e.g. ``torch.bfloat16``) casts
    floating arrays before the copy, halving its bytes for bf16.

    ``depth`` (default 1, the classic double-buffer) is how many batches
    ahead of the consumer stay resident on the device; ``None`` defers to
    ``HOROVOD_PREFETCH_DEPTH``. A bad depth raises here, at the call, not
    at the first batch. ``group`` names the group whose rank's device the
    batches go to."""
    if depth is None:
        depth = _env.prefetch_depth()
    if not isinstance(depth, int) or depth < 1:
        raise ValueError(
            f"prefetch_to_device depth must be a positive integer, "
            f"got {depth!r}")
    _state.get_group(group)
    return Prefetcher(batches, _state.device(), dtype, depth)


class ShardedDataset:
    """The per-rank dataset-sharding convention.

    Rank i of the group owns the contiguous slice
    ``[i*N//size, (i+1)*N//size)`` of the examples. Every epoch each rank
    reshuffles ITS shard with a distinct seed (the reference's), and
    :meth:`batches` yields that rank's ``(batch, ...)`` arrays; stacked
    over the ranks they are the reference's rank-stacked batches.
    """

    def __init__(self, arrays: Sequence[np.ndarray], size: int,
                 batch_size: int, seed: int = 0,
                 drop_remainder: bool = True, group: int = 0):
        n = len(arrays[0])
        for a in arrays:
            if len(a) != n:
                raise ValueError("All arrays must share their first dim.")
        if n < size:
            raise ValueError(f"{n} examples cannot shard over {size} ranks.")
        self.arrays = [np.asarray(a) for a in arrays]
        self.size = size
        self.batch_size = batch_size
        self.seed = seed
        self.group = group
        per = n // size
        self.shards = [slice(i * per, (i + 1) * per) for i in range(size)]
        self.steps_per_epoch = (per // batch_size if drop_remainder
                                else -(-per // batch_size))
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"Shard of {per} examples is smaller than one batch "
                f"({batch_size}).")

    def batches(self, epoch: int = 0, rank: int | None = None
                ) -> Iterator[list[np.ndarray]]:
        """One epoch of rank ``rank``'s batches (default: this process's
        rank in the dataset's group): element j of the yielded list is
        arrays[j] batched as (batch, ...)."""
        me = _resolve_rank(rank, self.group, self.size)
        sl = self.shards[me]
        order = np.arange(sl.start, sl.stop)
        np.random.RandomState(_epoch_seed(self.seed, epoch, me)).shuffle(
            order)
        b = self.batch_size
        for step in range(self.steps_per_epoch):
            pick = order[step * b:(step + 1) * b]
            yield [a[pick] for a in self.arrays]
