"""Dataset acquisition, the JAX package's ``data/download.py``: the
``download=True`` branch of ``load_dataset`` and the ``download`` command.

A manifest of each named dataset's canonical source URLs and md5 sums (the
ones torchvision pins, entry for entry the JAX package's), an atomic
fetch-verify-extract pipeline and per-dataset post-extraction hooks that
arrange the files into the layouts the readers in :mod:`.datasets` take.

The transport is injectable: ``fetch(..., transport=...)`` takes any
``urlopen``-like callable (a URL to an object with ``read(n)``), which is
how the tests run the whole pipeline offline. Without one, ``fetch``
opens the URL with ``urllib``. ``FFC_TPU_DOWNLOAD_NO_VERIFY=1`` skips the
md5 check, for an upstream file that was republished.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import sys
import tarfile
import tempfile
import zipfile
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

__all__ = ["RemoteFile", "DOWNLOADS", "fetch", "DownloadError"]


class DownloadError(RuntimeError):
    """Raised when a dataset cannot be fetched or fails verification."""


@dataclass(frozen=True)
class RemoteFile:
    """One downloadable artifact of a dataset.

    ``extract``: None (use the file as-is; the idx readers consume .gz
    directly), 'tar' (tar/tar.gz/tgz), or 'zip'.  ``subdir``: directory
    under ``data_dir`` the file lands in (torchvision layout parity,
    e.g. MNIST/raw).
    """

    url: str
    filename: str
    md5: Optional[str] = None
    extract: Optional[str] = None
    subdir: str = ""


# Canonical sources, as pinned by torchvision (the reference's transport).
DOWNLOADS: Dict[str, Tuple[RemoteFile, ...]] = {
    "mnist": tuple(
        RemoteFile(
            url=f"https://ossci-datasets.s3.amazonaws.com/mnist/{fn}",
            filename=fn,
            md5=md5,
            subdir="MNIST/raw",
        )
        for fn, md5 in (
            ("train-images-idx3-ubyte.gz", "f68b3c2dcbeaaa9fbdd348bbdeb94873"),
            ("train-labels-idx1-ubyte.gz", "d53e105ee54ea40749a09fcbcd1e9432"),
            ("t10k-images-idx3-ubyte.gz", "9fb629c4189551a2d022fa330f9573f3"),
            ("t10k-labels-idx1-ubyte.gz", "ec29112dd5afa0611ce80d1b7f02629c"),
        )
    ),
    "fmnist": tuple(
        RemoteFile(
            url=(
                "http://fashion-mnist.s3-website.eu-central-1.amazonaws.com/"
                + fn
            ),
            filename=fn,
            md5=md5,
            subdir="FashionMNIST/raw",
        )
        for fn, md5 in (
            ("train-images-idx3-ubyte.gz", "8d4fb7e6c68d591d4c3dfef9ec88bf0d"),
            ("train-labels-idx1-ubyte.gz", "25c81989df183df01b3e8a0aad5dffbe"),
            ("t10k-images-idx3-ubyte.gz", "bef4ecab320f06d8554ea6380940ec79"),
            ("t10k-labels-idx1-ubyte.gz", "bb300cfdad3c16e7a12a480ee83cd310"),
        )
    ),
    "cifar10": (
        RemoteFile(
            url="https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz",
            filename="cifar-10-python.tar.gz",
            md5="c58f30108f718f92721af3b95e74349a",
            extract="tar",
        ),
    ),
    "svhn": (
        RemoteFile(
            url="http://ufldl.stanford.edu/housenumbers/train_32x32.mat",
            filename="train_32x32.mat",
            md5="e26dedcc434d2e4c54c9b2d4a06d8373",
        ),
        RemoteFile(
            url="http://ufldl.stanford.edu/housenumbers/test_32x32.mat",
            filename="test_32x32.mat",
            md5="eb5a983be6a315427106f1b164d9cef3",
        ),
    ),
    "stl10": (
        RemoteFile(
            url="http://ai.stanford.edu/~acoates/stl10/stl10_binary.tar.gz",
            filename="stl10_binary.tar.gz",
            md5="91f7769df0f17e558f3565bffb0c7dfb",
            extract="tar",
        ),
    ),
    "flowers": (
        RemoteFile(
            url=(
                "https://www.robots.ox.ac.uk/~vgg/data/flowers/102/"
                "102flowers.tgz"
            ),
            filename="102flowers.tgz",
            md5="52808999861908f626f3c1f4e79d11fa",
            extract="tar",
        ),
        RemoteFile(
            url=(
                "https://www.robots.ox.ac.uk/~vgg/data/flowers/102/"
                "imagelabels.mat"
            ),
            filename="imagelabels.mat",
            md5="e0620be6f572b9609742df49c70aed4d",
        ),
    ),
    "omniglot": (
        RemoteFile(
            url=(
                "https://raw.githubusercontent.com/brendenlake/omniglot/"
                "master/python/images_background.zip"
            ),
            filename="images_background.zip",
            md5="68d2efa1b9178cc56df9314c21c6e718",
            extract="zip",
        ),
    ),
    "food101": (
        RemoteFile(
            url="http://data.vision.ee.ethz.ch/cvl/food-101.tar.gz",
            filename="food-101.tar.gz",
            md5="85eeb15f3717b99a5da872d97d918f87",
            extract="tar",
        ),
    ),
    # load_cars in the reference actually trains on SUN397
    # (util/data_loader.py:83-132). 37 GB — listed for completeness.
    "cars": (
        RemoteFile(
            url=(
                "http://vision.princeton.edu/projects/2010/SUN/SUN397.tar.gz"
            ),
            filename="SUN397.tar.gz",
            md5="8ca2778205c41d23104230ba66911c7a",
            extract="tar",
        ),
    ),
}


def _md5(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _verify(path: str, want: Optional[str]) -> bool:
    if want is None or os.environ.get("FFC_TPU_DOWNLOAD_NO_VERIFY") == "1":
        return True
    return _md5(path) == want


def _default_transport(url: str):
    import urllib.request

    req = urllib.request.Request(
        url, headers={"User-Agent": "fastfourierconvolution-tpu/1.0"}
    )
    return urllib.request.urlopen(req, timeout=60)


def _download_one(
    rf: RemoteFile,
    dest_dir: str,
    transport: Callable,
    progress: bool,
) -> str:
    """Fetch one file to ``dest_dir`` atomically; return its path."""
    os.makedirs(dest_dir, exist_ok=True)
    dest = os.path.join(dest_dir, rf.filename)
    if os.path.exists(dest):
        if _verify(dest, rf.md5):
            return dest
        # stale/corrupt partial from a previous run: refetch
        os.remove(dest)
    try:
        resp = transport(rf.url)
    except Exception as e:  # urllib raises URLError/OSError subclasses
        raise DownloadError(
            f"cannot fetch {rf.url}: {e!r}. If this environment has no "
            f"network egress, place the file manually at {dest} "
            f"(md5 {rf.md5})."
        ) from e
    fd, tmp = tempfile.mkstemp(dir=dest_dir, suffix=".part")
    try:
        with os.fdopen(fd, "wb") as out:
            total = 0
            while True:
                block = resp.read(1 << 20)
                if not block:
                    break
                out.write(block)
                total += len(block)
                if progress:
                    print(
                        f"\r{rf.filename}: {total / 2**20:.1f} MiB",
                        end="",
                        file=sys.stderr,
                    )
        if progress:
            print(file=sys.stderr)
        if not _verify(tmp, rf.md5):
            raise DownloadError(
                f"checksum mismatch for {rf.filename}: expected {rf.md5}, "
                f"got {_md5(tmp)} (set FFC_TPU_DOWNLOAD_NO_VERIFY=1 to "
                f"accept a republished upstream file)"
            )
        os.replace(tmp, dest)  # atomic publish
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return dest


def _extract(path: str, dest_dir: str, kind: str) -> None:
    if kind == "tar":
        with tarfile.open(path) as tf:
            tf.extractall(dest_dir, filter="data")
    elif kind == "zip":
        with zipfile.ZipFile(path) as zf:
            zf.extractall(dest_dir)
    else:  # pragma: no cover - manifest is static
        raise ValueError(f"unknown extract kind {kind!r}")


def _arrange_flowers(data_dir: str) -> None:
    """102flowers.tgz extracts to a flat ``jpg/`` directory; arrange into
    per-class folders using imagelabels.mat so ImageFolderDataset (and
    the reference's Flowers102 label semantics) applies."""
    jpg_dir = os.path.join(data_dir, "jpg")
    labels_path = os.path.join(data_dir, "imagelabels.mat")
    if not (os.path.isdir(jpg_dir) and os.path.exists(labels_path)):
        return
    from scipy.io import loadmat

    labels = loadmat(labels_path)["labels"].reshape(-1)  # 1-based classes
    out_root = os.path.join(data_dir, "flowers-102")
    for i, lbl in enumerate(labels, start=1):
        src = os.path.join(jpg_dir, f"image_{i:05d}.jpg")
        if not os.path.exists(src):
            continue
        cls_dir = os.path.join(out_root, f"class_{int(lbl):03d}")
        os.makedirs(cls_dir, exist_ok=True)
        shutil.move(src, os.path.join(cls_dir, os.path.basename(src)))
    if os.path.isdir(jpg_dir) and not os.listdir(jpg_dir):
        os.rmdir(jpg_dir)


_POST_EXTRACT: Dict[str, Callable[[str], None]] = {
    "flowers": _arrange_flowers,
}


def fetch(
    name: str,
    data_dir: str,
    transport: Optional[Callable] = None,
    progress: bool = True,
) -> Sequence[str]:
    """Download + verify + extract every file of dataset ``name`` into
    ``data_dir`` (idempotent: present-and-verified files are skipped).
    Returns the list of downloaded file paths."""
    lname = name.lower()
    if lname not in DOWNLOADS:
        raise KeyError(
            f"no download manifest for dataset '{name}'; have "
            f"{sorted(DOWNLOADS)} (celeba/textures are local tar archives "
            f"in the reference — no canonical public URL)"
        )
    transport = transport or _default_transport
    paths = []
    for rf in DOWNLOADS[lname]:
        dest_dir = (
            os.path.join(data_dir, rf.subdir) if rf.subdir else data_dir
        )
        path = _download_one(rf, dest_dir, transport, progress)
        paths.append(path)
        if rf.extract:
            _extract(path, dest_dir, rf.extract)
    hook = _POST_EXTRACT.get(lname)
    if hook is not None:
        hook(data_dir)
    return paths
