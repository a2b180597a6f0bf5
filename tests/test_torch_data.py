"""The port's ``data/`` against the JAX package's.

- Every dataset kind the CLI loads gives the same items, byte for byte,
  with the same labels and length: the procedural and bundled sets
  (``synthetic``, ``shapes``, ``digits``, ``patches``), the file readers on
  files written here (MNIST idx, CIFAR-10 pickle, SVHN ``.mat``, STL-10
  binary, an image folder, a tar archive), and every ``AUG_STACKS`` entry
  with a seed.
- ``num_classes_of`` agrees on all of them; on a concatenation whose top
  class is only in its second member the port counts it, where the JAX
  function reads the first member only.
- ``DataLoader`` yields the JAX loader's batches over two epochs for the
  same seed, uint8 or normalised (both loaders' in-memory batches through
  the native batcher), and after ``skip_batches``; ``epochs()`` stops its
  thread when closed and raises a dataset's failure.
- ``data/native.py``: where ``native/libffc_batcher.so`` is absent the port
  builds ``native/ffc_batcher.cpp`` into its ``_build/`` and leaves
  ``native/`` as it found it; the batcher gives numpy's
  ``x * float32(1/127.5) - 1`` bit for bit (with the flip too), and the
  JAX package's shuffle; bad arguments raise ValueError; a failed build
  prints the compiler's message once and leaves the numpy path.
- ``load_dataset(download=True)`` fetches a missing dataset through the
  transport (``tests/test_torch_download.py`` runs the rest offline).
"""

from __future__ import annotations

import gzip
import io
import os
import pickle
import struct
import tarfile
import threading

import numpy as np
import pytest
from PIL import Image

import fastfourierconvolution_tpu.data.datasets as jds
import fastfourierconvolution_tpu.data.loader as jloader
import fastfourierconvolution_tpu.data.native as jnative
from fastfourierconvolution_tpu_torch.data import datasets as ds
from fastfourierconvolution_tpu_torch.data import download, loader, native


def assert_same_items(ours, theirs):
    assert len(ours) == len(theirs)
    for i in range(len(theirs)):
        (a, la), (b, lb) = ours[i], theirs[i]
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        assert a.tobytes() == b.tobytes() and la == lb, i
    assert ds.num_classes_of(ours) == jds.num_classes_of(theirs)


@pytest.mark.parametrize("name, size, channels", [
    ("synthetic", 16, 3), ("shapes", 16, 3), ("shapes", 12, 1), ("digits", 16, 3),
    ("digits", 12, 1), ("patches", 16, 3),
])
def test_named_datasets_match_jax(name, size, channels):
    ours = ds.load_dataset(name, "", size, channels)
    theirs = jds.load_dataset(name, "", size, channels)
    assert type(ours).__name__ == type(theirs).__name__
    assert hasattr(ours, "images") == hasattr(theirs, "images")
    assert_same_items(ours, theirs)


def _images(rng, n, h, w, c):
    return rng.randint(0, 256, (n, h, w, c), dtype=np.uint8)


def write_mnist(root, rng):
    raw = os.path.join(root, "MNIST", "raw")
    os.makedirs(raw)
    for split, n in (("train", 7), ("t10k", 3)):
        imgs = _images(rng, n, 28, 28, 1)[..., 0]
        with gzip.open(os.path.join(raw, f"{split}-images-idx3-ubyte.gz"), "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
        with open(os.path.join(raw, f"{split}-labels-idx1-ubyte"), "wb") as f:
            f.write(struct.pack(">II", 2049, n) + rng.randint(0, 10, n).astype(np.uint8).tobytes())


def write_cifar10(root, rng):
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        n = 2
        batch = {b"data": _images(rng, n, 3, 32, 32).reshape(n, -1),
                 b"labels": rng.randint(0, 10, n).tolist()}
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(batch, f)


def write_svhn(root, rng):
    from scipy.io import savemat

    n = 5
    savemat(os.path.join(root, "train_32x32.mat"),
            {"X": _images(rng, 32, 32, 3, n), "y": rng.randint(1, 11, (n, 1))})


def write_stl10(root, rng):
    base = os.path.join(root, "stl10_binary")
    os.makedirs(base)
    _images(rng, 4, 3, 96, 96).tofile(os.path.join(base, "train_X.bin"))
    rng.randint(1, 11, 4).astype(np.uint8).tofile(os.path.join(base, "train_y.bin"))


def _png_bytes(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def write_folder(root, rng):
    for cls, n in (("cat", 3), ("dog", 2), ("emu", 2)):
        os.makedirs(os.path.join(root, cls, "sub"))
        for i in range(n):
            where = os.path.join(root, cls, "sub" if i else "", f"{i}.png")
            Image.fromarray(_images(rng, 1, 20, 26, 3)[0]).save(where)


def write_tar(root, rng):
    path = os.path.join(root, "images.tar")
    with tarfile.open(path, "w") as tf:
        for name in ("a/0.png", "a/1.png", "b/0.png", "c/x/0.png"):
            data = _png_bytes(_images(rng, 1, 18, 14, 3)[0])
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return path


FILE_KINDS = {
    "mnist": (write_mnist, 28, 1),
    "cifar10": (write_cifar10, 32, 3),
    "svhn": (write_svhn, 32, 3),
    "stl10": (write_stl10, 96, 3),
    "folder": (write_folder, 16, 3),
    "tar": (write_tar, 16, 3),
}


@pytest.mark.parametrize("kind", sorted(FILE_KINDS))
def test_file_readers_match_jax(kind, tmp_path):
    write, size, channels = FILE_KINDS[kind]
    root = str(tmp_path)
    tar = write(root, np.random.RandomState(len(kind)))
    name = tar if kind == "tar" else kind
    for split in (("train", "test") if kind in ("mnist", "cifar10") else ("train",)):
        for image_size in (size, 12):
            ours = ds.load_dataset(name, root, image_size, channels, split=split)
            theirs = jds.load_dataset(name, root, image_size, channels, split=split)
            assert_same_items(ours, theirs)
    if kind in ("folder", "tar"):  # the lazy readers themselves
        make = (lambda m: m.ImageFolderDataset(root, channels=channels)) if kind == "folder" \
            else (lambda m: m.TarImageDataset(tar, channels=channels))
        ours, theirs = make(ds), make(jds)
        assert ours.class_to_idx == theirs.class_to_idx
        assert_same_items(ours, theirs)


@pytest.mark.parametrize("stack", sorted(jds.AUG_STACKS))
@pytest.mark.parametrize("channels", [3, 1])
def test_aug_stacks_match_jax(stack, channels):
    rng = np.random.RandomState(7)
    base = (_images(rng, 5, 22, 18, channels), rng.randint(0, 4, 5))
    ours = ds.apply_aug_stack(ds.ArrayDataset(*base), stack, 16, channels, seed=3)
    theirs = jds.apply_aug_stack(jds.ArrayDataset(*base), stack, 16, channels, seed=3)
    assert_same_items(ours, theirs)
    # a second pass re-samples the random transforms, in step too
    assert_same_items(ours, theirs)


def test_num_classes_of_takes_every_concat_member():
    rng = np.random.RandomState(0)
    low = ds.ArrayDataset(_images(rng, 4, 4, 4, 3), np.array([0, 1, 2, 1]))
    high = ds.ArrayDataset(_images(rng, 3, 4, 4, 3), np.array([0, 4, 1]))
    jlow, jhigh = (jds.ArrayDataset(d.images, d.labels) for d in (low, high))
    assert ds.num_classes_of(ds.ConcatDataset([low, high])) == 5
    assert jds.num_classes_of(jds.ConcatDataset([jlow, jhigh])) == 3  # undercounts
    assert ds.num_classes_of(ds.ConcatDataset([high, low])) == 5
    assert ds.num_classes_of(ds.ArrayDataset(low.images, np.zeros(4, np.int64))) == 0
    assert ds.num_classes_of(None) == 0


def _idx_bytes(arr):
    """An idx file's bytes: (N, 28, 28) images or (N,) labels, uint8."""
    if arr.ndim == 3:
        return struct.pack(">IIII", 2051, *arr.shape) + arr.tobytes()
    return struct.pack(">II", 2049, arr.shape[0]) + arr.tobytes()


def test_load_dataset_download_fetches_through_the_transport(tmp_path, monkeypatch):
    """A missing MNIST is fetched (every file through the transport, no URL
    opened) and read; without ``download`` it raises as before."""
    data = _images(np.random.RandomState(4), 3, 28, 28, 1)[..., 0]
    files = {"train-images-idx3-ubyte.gz": gzip.compress(_idx_bytes(data)),
             "train-labels-idx1-ubyte.gz": gzip.compress(_idx_bytes(np.arange(3, dtype=np.uint8))),
             "t10k-images-idx3-ubyte.gz": b"", "t10k-labels-idx1-ubyte.gz": b""}
    opened = []

    def transport(url):
        opened.append(url)
        return io.BytesIO(files[url.rsplit("/", 1)[1]])

    monkeypatch.setattr(download, "_default_transport", transport)
    monkeypatch.setenv("FFC_TPU_DOWNLOAD_NO_VERIFY", "1")
    with pytest.raises(FileNotFoundError):
        ds.load_dataset("mnist", str(tmp_path), 28, 1)
    got = ds.load_dataset("mnist", str(tmp_path), 28, 1, download=True)
    assert sorted(u.rsplit("/", 1)[1] for u in opened) == sorted(files)
    assert len(got) == 3 and got[2][1] == 2
    assert got[1][0][..., 0].tobytes() == data[1].tobytes()


def test_a_missing_package_is_named(monkeypatch):
    import importlib

    real = importlib.import_module

    def no_sklearn(name, *args):
        if name.startswith("sklearn"):
            raise ImportError("no module")
        return real(name, *args)

    monkeypatch.setattr(importlib, "import_module", no_sklearn)
    with pytest.raises(ImportError, match="'scikit-learn'"):
        ds.load_dataset("digits", "", 16)


def _batches(stream, n):
    return [next(stream) for _ in range(n)]


@pytest.mark.parametrize("raw", [True, False])
@pytest.mark.parametrize("lazy", [False, True])
def test_loader_matches_jax_over_two_epochs(raw, lazy, tmp_path):
    # both loaders' normalised in-memory batches go through the native
    # batcher, which multiplies by 1/127.5 (111 of the 256 levels round
    # otherwise than numpy's division)
    assert native.available() and jnative.available()
    if lazy:
        write_folder(str(tmp_path), np.random.RandomState(1))
        data = ds.ImageFolderDataset(str(tmp_path), size=8)
        jdata = jds.ImageFolderDataset(str(tmp_path), size=8)
        batch = 2
    else:
        data = ds.SyntheticDataset(n=37, size=8)
        jdata = jds.SyntheticDataset(n=37, size=8)
        batch = 8
    ours = loader.DataLoader(data, batch, seed=5, raw_uint8=raw)
    theirs = jloader.DataLoader(jdata, batch, seed=5, raw_uint8=raw)
    assert len(ours) == len(theirs)
    n = 2 * len(theirs)
    got, want = list(iter(ours)) + list(iter(ours)), list(iter(theirs)) + list(iter(theirs))
    assert len(got) == len(want) == n
    for (x, y), (jx, jy) in zip(got, want):
        assert x.dtype == jx.dtype == (np.uint8 if raw else np.float32)
        assert x.tobytes() == jx.tobytes() and np.array_equal(y, jy)


@pytest.mark.parametrize("skip", [0, 3, 4, 9])
def test_skip_batches_continues_the_jax_order(skip):
    data, jdata = ds.SyntheticDataset(n=37, size=4), jds.SyntheticDataset(n=37, size=4)
    ours = loader.DataLoader(data, 8, seed=11, raw_uint8=True)
    theirs = jloader.DataLoader(jdata, 8, seed=11, raw_uint8=True)
    straight = loader.DataLoader(data, 8, seed=11, raw_uint8=True)
    ours.skip_batches(skip)
    theirs.skip_batches(skip)
    stream, jstream, full = ours.epochs(), theirs.epochs(), straight.epochs()
    try:
        resumed, jresumed = _batches(stream, 6), _batches(jstream, 6)
        expected = _batches(full, skip + 6)[skip:]
    finally:
        for s in (stream, jstream, full):
            s.close()
    for (x, y), (jx, jy), (ex, ey) in zip(resumed, jresumed, expected):
        assert np.array_equal(x, jx) and np.array_equal(y, jy)
        assert np.array_equal(x, ex) and np.array_equal(y, ey)
    with pytest.raises(ValueError):
        ours.skip_batches(-1)


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "ffc-prefetch"]


def test_epochs_stops_its_thread_and_raises_a_failure():
    stream = loader.DataLoader(ds.SyntheticDataset(n=20, size=4), 4, seed=0).epochs()
    _batches(stream, 7)  # crosses an epoch boundary
    assert len(_prefetch_threads()) == 1
    stream.close()
    assert not _prefetch_threads()

    class Broken:  # a file-backed dataset whose files cannot be read
        def __len__(self):
            return 8

        def __getitem__(self, i):
            raise OSError("unreadable file")

    stream = loader.DataLoader(Broken(), 4, decode_threads=0).epochs()
    with pytest.raises(RuntimeError, match="prefetch thread failed") as info:
        next(stream)
    assert isinstance(info.value.__cause__, OSError)
    stream.close()
    assert not _prefetch_threads()


def test_loader_rejects_an_uneven_process_split():
    with pytest.raises(ValueError, match="divide evenly"):
        loader.DataLoader(ds.SyntheticDataset(n=8, size=4), 6, process_count=4)
    data = ds.SyntheticDataset(n=24, size=4)
    parts = [list(loader.DataLoader(data, 8, seed=2, process_index=i, process_count=2))
             for i in range(2)]
    whole = list(loader.DataLoader(data, 8, seed=2))
    for (x0, _), (x1, _), (x, _) in zip(*parts, whole):
        assert np.array_equal(np.concatenate([x0, x1]), x)


# --- the native batcher -----------------------------------------------------------------


def _fresh_native(monkeypatch):
    """``native`` as a process that has not loaded the library yet."""
    for name, value in (("_tried", False), ("_lib", None), ("_path", None)):
        monkeypatch.setattr(native, name, value)


def test_the_batcher_is_built_under_build_and_native_is_left_as_found(monkeypatch, tmp_path):
    before = sorted(os.listdir(native.NATIVE_DIR))
    _fresh_native(monkeypatch)
    monkeypatch.setattr(native, "PREBUILT", tmp_path / "absent.so")
    assert native.available()
    assert native.library_path() == native.built_path()
    assert native.library_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.parent.name == "fastfourierconvolution_tpu_torch"
    assert sorted(os.listdir(native.NATIVE_DIR)) == before
    images = _images(np.random.RandomState(5), 6, 5, 7, 3)
    idx = np.array([4, 0, 4, 2])
    scale = np.float32(1 / 127.5)
    want = images[idx].astype(np.float32) * scale - np.float32(1)
    for threads in (0, 1, 3):
        assert native.gather_normalize(images, idx, n_threads=threads).tobytes() == want.tobytes()
    assert (native.gather_normalize(images, idx, hflip=True).tobytes()
            == np.ascontiguousarray(want[:, :, ::-1]).tobytes())
    perm = native.shuffle_indices(1000, 17)
    assert perm.dtype == np.int64 and sorted(perm) == list(range(1000))
    assert np.array_equal(perm, jnative.shuffle_indices(1000, 17))
    assert not np.array_equal(perm, native.shuffle_indices(1000, 18))


def test_the_loader_asks_one_thread_per_4_mib(monkeypatch):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(6)))
    assert [native.loader_threads(n << 20) for n in (0, 1, 4, 12, 13, 100)] == [1, 1, 1, 3, 3, 6]


@pytest.mark.parametrize("call, message", [
    (lambda im: native.gather_normalize(im.astype(np.float32), [0]), "uint8"),
    (lambda im: native.gather_normalize(im[0], [0]), r"\(N, H, W, C\)"),
    (lambda im: native.gather_normalize(im[:, :, ::2], [0]), "C-contiguous"),
    (lambda im: native.gather_normalize(im, [[0]]), "1-d integer"),
    (lambda im: native.gather_normalize(im, [0.5]), "1-d integer"),
    (lambda im: native.gather_normalize(im, [0, 4]), r"in \[0, 4\)"),
    (lambda im: native.gather_normalize(im, [-1]), r"in \[0, 4\)"),
    (lambda im: native.gather_normalize(im, [0], n_threads=-2), "n_threads"),
    (lambda im: native.shuffle_indices(-1, 0), "n must be"),
    (lambda im: native.shuffle_indices(3, -1), "unsigned 64-bit"),
])
def test_bad_batcher_arguments_raise(call, message):
    images = np.zeros((4, 2, 6, 3), np.uint8)
    with pytest.raises(ValueError, match=message):
        call(images)


def test_a_failed_build_prints_once_and_leaves_numpy(monkeypatch, tmp_path, capsys):
    _fresh_native(monkeypatch)
    monkeypatch.setattr(native, "PREBUILT", tmp_path / "absent.so")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")
    images = _images(np.random.RandomState(6), 4, 3, 3, 3)
    assert native.gather_normalize(images, [1, 2]) is None
    assert native.shuffle_indices(5, 1) is None
    err = capsys.readouterr().err
    assert err.count("WARNING: the native batcher is unavailable") == 1 and "exited 1" in err
    data = ds.ArrayDataset(images, np.arange(4))
    x, _ = next(iter(loader.DataLoader(data, 2, seed=0)))
    assert x.dtype == np.float32 and x.shape == (2, 3, 3, 3)
