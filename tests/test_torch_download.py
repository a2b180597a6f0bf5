"""The port's ``data/download.py`` against the JAX package's tests
(``tests/test_download.py``), offline: each of its eight tests with the
port's ``fetch`` and ``load_dataset``, the transport a fake that serves
in-memory fixture bytes (no test opens a URL); and the port's manifest
equal to the JAX package's, entry for entry."""

import gzip
import hashlib
import io
import os
import pickle
import struct
import tarfile

import numpy as np
import pytest

import fastfourierconvolution_tpu.data.download as jdl
from fastfourierconvolution_tpu_torch.data import download as dl
from fastfourierconvolution_tpu_torch.data import load_dataset


def _idx_images(n=4, rows=8, cols=8):
    body = np.random.RandomState(0).randint(
        0, 256, (n, rows, cols), dtype=np.uint8
    )
    return struct.pack(">IIII", 2051, n, rows, cols) + body.tobytes()


def _idx_labels(n=4):
    return struct.pack(">II", 2049, n) + bytes(range(n))


def _mnist_fixture():
    """{filename: gzipped idx bytes} for a 4-image MNIST."""
    return {
        "train-images-idx3-ubyte.gz": gzip.compress(_idx_images()),
        "train-labels-idx1-ubyte.gz": gzip.compress(_idx_labels()),
        "t10k-images-idx3-ubyte.gz": gzip.compress(_idx_images()),
        "t10k-labels-idx1-ubyte.gz": gzip.compress(_idx_labels()),
    }


class FakeTransport:
    """urlopen-like: url -> BytesIO over fixture bytes, counting calls."""

    def __init__(self, by_name):
        self.by_name = by_name  # filename -> bytes
        self.calls = []

    def __call__(self, url):
        self.calls.append(url)
        name = url.rsplit("/", 1)[1]
        if name not in self.by_name:
            raise OSError(f"404 {url}")
        return io.BytesIO(self.by_name[name])


def _manifest_with_real_md5(name, files):
    """Clone the DOWNLOADS entry for ``name`` with each md5 replaced by
    the fixture's actual digest, so verification genuinely runs."""
    out = []
    for rf in dl.DOWNLOADS[name]:
        data = files[rf.filename]
        out.append(
            dl.RemoteFile(
                url=rf.url,
                filename=rf.filename,
                md5=hashlib.md5(data).hexdigest(),
                extract=rf.extract,
                subdir=rf.subdir,
            )
        )
    return tuple(out)


def test_fetch_mnist_end_to_end(tmp_path, monkeypatch):
    files = _mnist_fixture()
    monkeypatch.setitem(
        dl.DOWNLOADS, "mnist", _manifest_with_real_md5("mnist", files)
    )
    transport = FakeTransport(files)
    paths = dl.fetch("mnist", str(tmp_path), transport=transport, progress=False)
    assert len(paths) == 4
    assert all(os.path.exists(p) for p in paths)
    # landed in the torchvision layout the idx reader searches
    assert os.path.exists(
        tmp_path / "MNIST" / "raw" / "train-images-idx3-ubyte.gz"
    )
    ds = load_dataset("mnist", str(tmp_path), image_size=8, channels=1)
    img, label = ds[0]
    assert img.shape == (8, 8, 1) and img.dtype == np.uint8

    # idempotent: verified-present files are not refetched
    n_calls = len(transport.calls)
    dl.fetch("mnist", str(tmp_path), transport=transport, progress=False)
    assert len(transport.calls) == n_calls


def test_fetch_checksum_mismatch_raises(tmp_path, monkeypatch):
    files = _mnist_fixture()
    bad = tuple(
        dl.RemoteFile(rf.url, rf.filename, md5="0" * 32, subdir=rf.subdir)
        for rf in dl.DOWNLOADS["mnist"]
    )
    monkeypatch.setitem(dl.DOWNLOADS, "mnist", bad)
    with pytest.raises(dl.DownloadError, match="checksum mismatch"):
        dl.fetch(
            "mnist", str(tmp_path), transport=FakeTransport(files),
            progress=False,
        )
    # failed downloads must not publish partial files
    raw = tmp_path / "MNIST" / "raw"
    assert not any(raw.glob("*.gz"))

    # ... unless verification is explicitly waived
    monkeypatch.setenv("FFC_TPU_DOWNLOAD_NO_VERIFY", "1")
    dl.fetch(
        "mnist", str(tmp_path), transport=FakeTransport(files), progress=False
    )
    assert (raw / "train-images-idx3-ubyte.gz").exists()


def test_fetch_replaces_corrupt_existing_file(tmp_path, monkeypatch):
    files = _mnist_fixture()
    monkeypatch.setitem(
        dl.DOWNLOADS, "mnist", _manifest_with_real_md5("mnist", files)
    )
    raw = tmp_path / "MNIST" / "raw"
    raw.mkdir(parents=True)
    (raw / "train-images-idx3-ubyte.gz").write_bytes(b"garbage from a crash")
    transport = FakeTransport(files)
    dl.fetch("mnist", str(tmp_path), transport=transport, progress=False)
    got = (raw / "train-images-idx3-ubyte.gz").read_bytes()
    assert got == files["train-images-idx3-ubyte.gz"]


def test_fetch_network_failure_has_actionable_error(tmp_path, monkeypatch):
    monkeypatch.setitem(
        dl.DOWNLOADS, "mnist", _manifest_with_real_md5("mnist", _mnist_fixture())
    )
    with pytest.raises(dl.DownloadError, match="place the file manually"):
        dl.fetch(
            "mnist", str(tmp_path), transport=FakeTransport({}), progress=False
        )


def test_fetch_unknown_dataset():
    with pytest.raises(KeyError, match="no download manifest"):
        dl.fetch("celeba", "/tmp/none")


def _cifar_fixture():
    """cifar-10-python.tar.gz with 6 tiny pickle batches."""
    rng = np.random.RandomState(1)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
            d = {
                b"data": rng.randint(0, 256, (4, 3072), dtype=np.uint8),
                b"labels": [0, 1, 2, 3],
            }
            payload = pickle.dumps(d)
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(payload)
            tf.addfile(info, io.BytesIO(payload))
    return {"cifar-10-python.tar.gz": buf.getvalue()}


def test_fetch_cifar10_extracts_archive(tmp_path, monkeypatch):
    files = _cifar_fixture()
    monkeypatch.setitem(
        dl.DOWNLOADS, "cifar10", _manifest_with_real_md5("cifar10", files)
    )
    dl.fetch(
        "cifar10", str(tmp_path), transport=FakeTransport(files), progress=False
    )
    assert (tmp_path / "cifar-10-batches-py" / "data_batch_1").exists()
    ds = load_dataset("cifar10", str(tmp_path), image_size=32, channels=3)
    assert len(ds) == 20
    img, _ = ds[0]
    assert img.shape == (32, 32, 3)


def _flowers_fixture():
    """102flowers.tgz (flat jpg/ dir) + imagelabels.mat."""
    from PIL import Image
    from scipy.io import savemat

    rng = np.random.RandomState(2)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        for i in range(1, 7):
            img = Image.fromarray(
                rng.randint(0, 256, (12, 12, 3), dtype=np.uint8)
            )
            jb = io.BytesIO()
            img.save(jb, format="JPEG")
            info = tarfile.TarInfo(f"jpg/image_{i:05d}.jpg")
            info.size = jb.tell()
            jb.seek(0)
            tf.addfile(info, jb)
    mat = io.BytesIO()
    savemat(mat, {"labels": np.array([[1, 1, 2, 2, 3, 3]], np.uint8)})
    return {
        "102flowers.tgz": buf.getvalue(),
        "imagelabels.mat": mat.getvalue(),
    }


def test_fetch_flowers_arranges_class_folders(tmp_path, monkeypatch):
    files = _flowers_fixture()
    monkeypatch.setitem(
        dl.DOWNLOADS, "flowers", _manifest_with_real_md5("flowers", files)
    )
    dl.fetch(
        "flowers", str(tmp_path), transport=FakeTransport(files), progress=False
    )
    root = tmp_path / "flowers-102"
    assert sorted(os.listdir(root)) == ["class_001", "class_002", "class_003"]
    ds = load_dataset("flowers", str(tmp_path), image_size=12, channels=3)
    assert len(ds) == 6
    labels = sorted(ds[i][1] for i in range(6))
    assert labels == [0, 0, 1, 1, 2, 2]


def test_load_dataset_download_flag(tmp_path, monkeypatch):
    """load_dataset(download=True) fetches on FileNotFoundError and
    retries — the reference's dset.MNIST(..., download=True) shape."""
    files = _mnist_fixture()
    monkeypatch.setitem(
        dl.DOWNLOADS, "mnist", _manifest_with_real_md5("mnist", files)
    )
    monkeypatch.setattr(dl, "_default_transport", FakeTransport(files))

    with pytest.raises(FileNotFoundError):
        load_dataset("mnist", str(tmp_path), image_size=8, channels=1)
    ds = load_dataset(
        "mnist", str(tmp_path), image_size=8, channels=1, download=True
    )
    assert len(ds) == 4

    # unknown names never trigger a fetch attempt
    with pytest.raises(KeyError):
        load_dataset("nosuch", "", image_size=8, channels=1, download=True)


def test_the_manifest_is_the_jax_package_s():
    assert dl.DOWNLOADS.keys() == jdl.DOWNLOADS.keys()
    for name, files in jdl.DOWNLOADS.items():
        assert [vars(f) for f in dl.DOWNLOADS[name]] == [vars(f) for f in files], name
