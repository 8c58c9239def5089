"""Dataset loaders for the BASELINE configs (CIFAR-10, MNIST, AG-News).

The reference has no data layer at all — its demo synthesizes
``y = p·X`` batches inline (reference demo.py:52-59). The north-star
configs (BASELINE.md 1-3) name real datasets, so this module loads them
from their *standard on-disk formats*:

* CIFAR-10 — the original ``cifar-10-batches-py`` pickled batches, or a
  consolidated ``cifar10.npz``;
* MNIST — the classic IDX ``*-ubyte[.gz]`` files, or ``mnist.npz``;
* AG-News — ``train.csv``/``test.csv`` (class,title,description rows).

``download=True`` fetches the canonical archives when the environment
has network access. Air-gapped environments (like the TPU CI container,
which has zero egress) either provide ``data_dir`` with pre-fetched
files or opt into ``fallback="synthetic"``: a deterministic,
class-conditional surrogate with the exact shapes/dtypes of the real
dataset, clearly labelled in the returned metadata — convergence and
accuracy are measurable, but numbers from it must not be quoted as
real-dataset results.

One loader needs neither network nor staged files:
:func:`load_digits_real` — the UCI handwritten-digits images bundled
inside scikit-learn — giving the air-gapped container REAL bytes to
train on (tests/test_datasets.py::test_digits_real_federated_accuracy
holds a real-data accuracy bar on non-IID shards of it).
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
import urllib.request
from typing import Dict, Optional, Tuple

import numpy as np

Arrays = Dict[str, np.ndarray]

_CIFAR10_URL = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"
_MNIST_URLS = {
    "train_images": "https://storage.googleapis.com/cvdf-datasets/mnist/train-images-idx3-ubyte.gz",
    "train_labels": "https://storage.googleapis.com/cvdf-datasets/mnist/train-labels-idx1-ubyte.gz",
    "test_images": "https://storage.googleapis.com/cvdf-datasets/mnist/t10k-images-idx3-ubyte.gz",
    "test_labels": "https://storage.googleapis.com/cvdf-datasets/mnist/t10k-labels-idx1-ubyte.gz",
}

DEFAULT_CACHE = os.path.expanduser("~/.cache/baton_tpu_torch/datasets")


class DatasetUnavailable(RuntimeError):
    """Raised when a real dataset is not on disk and cannot be fetched."""


def _fetch(url: str, dest: str) -> str:
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    tmp = dest + ".part"
    urllib.request.urlretrieve(url, tmp)  # noqa: S310 — canonical dataset hosts
    os.replace(tmp, dest)
    return dest


# ======================================================================
# CIFAR-10


def load_cifar10(
    data_dir: Optional[str] = None,
    download: bool = False,
    fallback: Optional[str] = None,
    seed: int = 0,
) -> Tuple[Arrays, Arrays, Dict]:
    """Returns ``(train, test, info)`` with ``train/test = {"x": float32
    [N,32,32,3] in [0,1], "y": int32 [N]}``.

    Resolution order: ``cifar10.npz`` → ``cifar-10-batches-py/`` →
    (``download=True``) fetch official archive → (``fallback='synthetic'``)
    deterministic surrogate → raise :class:`DatasetUnavailable`.
    """
    data_dir = data_dir or os.path.join(DEFAULT_CACHE, "cifar10")
    npz = os.path.join(data_dir, "cifar10.npz")
    batches = os.path.join(data_dir, "cifar-10-batches-py")

    if os.path.exists(npz):
        z = np.load(npz)

        def norm(x):
            x = x.astype(np.float32)
            # uint8-stored archives hold 0..255; honor the [0,1] contract
            return x / 255.0 if x.max() > 1.5 else x

        return (
            {"x": norm(z["x_train"]), "y": z["y_train"].astype(np.int32)},
            {"x": norm(z["x_test"]), "y": z["y_test"].astype(np.int32)},
            {"name": "cifar10", "synthetic": False, "source": npz},
        )

    if not os.path.isdir(batches) and download:
        archive = os.path.join(data_dir, "cifar-10-python.tar.gz")
        try:
            if not os.path.exists(archive):
                _fetch(_CIFAR10_URL, archive)
            with tarfile.open(archive, "r:gz") as tf:
                tf.extractall(data_dir, filter="data")
        except Exception as exc:  # zero-egress / bad mirror
            if fallback != "synthetic":
                raise DatasetUnavailable(
                    f"CIFAR-10 download failed ({exc}); provide data_dir or "
                    "fallback='synthetic'"
                ) from exc

    if os.path.isdir(batches):
        def read_batch(fname):
            with open(os.path.join(batches, fname), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            return x, np.asarray(d[b"labels"])

        xs, ys = zip(*[read_batch(f"data_batch_{i}") for i in range(1, 6)])
        x_train = np.concatenate(xs).astype(np.float32) / 255.0
        y_train = np.concatenate(ys).astype(np.int32)
        x_test, y_test = read_batch("test_batch")
        return (
            {"x": x_train, "y": y_train},
            {"x": x_test.astype(np.float32) / 255.0,
             "y": y_test.astype(np.int32)},
            {"name": "cifar10", "synthetic": False, "source": batches},
        )

    if fallback == "synthetic":
        train = synthetic_image_classification(
            50_000, (32, 32, 3), 10, seed=seed)
        test = synthetic_image_classification(
            10_000, (32, 32, 3), 10, seed=seed + 1)
        return train, test, {"name": "cifar10", "synthetic": True,
                             "source": "synthetic-surrogate"}

    raise DatasetUnavailable(
        f"CIFAR-10 not found under {data_dir}; pass download=True (needs "
        "network) or fallback='synthetic'"
    )


# ======================================================================
# MNIST


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape)


_MNIST_STEMS = {
    "train_images": ("train-images-idx3-ubyte", "train-images.idx3-ubyte"),
    "train_labels": ("train-labels-idx1-ubyte", "train-labels.idx1-ubyte"),
    "test_images": ("t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"),
    "test_labels": ("t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"),
}


def load_mnist(
    data_dir: Optional[str] = None,
    download: bool = False,
    fallback: Optional[str] = None,
    seed: int = 0,
) -> Tuple[Arrays, Arrays, Dict]:
    """Returns ``(train, test, info)`` with ``x`` float32 [N,28,28,1]."""
    data_dir = data_dir or os.path.join(DEFAULT_CACHE, "mnist")
    npz = os.path.join(data_dir, "mnist.npz")
    if os.path.exists(npz):
        z = np.load(npz)
        def norm(x):
            x = x.astype(np.float32) / (255.0 if x.max() > 1.5 else 1.0)
            return x.reshape(x.shape[0], 28, 28, 1)
        return (
            {"x": norm(z["x_train"]), "y": z["y_train"].astype(np.int32)},
            {"x": norm(z["x_test"]), "y": z["y_test"].astype(np.int32)},
            {"name": "mnist", "synthetic": False, "source": npz},
        )

    def find(kind):
        for stem in _MNIST_STEMS[kind]:
            for suffix in (".gz", ""):
                p = os.path.join(data_dir, stem + suffix)
                if os.path.exists(p):
                    return p
        return None

    if find("train_images") is None and download:
        try:
            for kind, url in _MNIST_URLS.items():
                dest = os.path.join(data_dir, _MNIST_STEMS[kind][0] + ".gz")
                if not os.path.exists(dest):
                    _fetch(url, dest)
        except Exception as exc:
            if fallback != "synthetic":
                raise DatasetUnavailable(
                    f"MNIST download failed ({exc}); provide data_dir or "
                    "fallback='synthetic'"
                ) from exc

    if find("train_images") is not None:
        def split(kind_img, kind_lbl):
            x = _read_idx(find(kind_img)).astype(np.float32) / 255.0
            return {
                "x": x[..., None],
                "y": _read_idx(find(kind_lbl)).astype(np.int32),
            }
        return (
            split("train_images", "train_labels"),
            split("test_images", "test_labels"),
            {"name": "mnist", "synthetic": False, "source": data_dir},
        )

    if fallback == "synthetic":
        train = synthetic_image_classification(60_000, (28, 28, 1), 10, seed=seed)
        test = synthetic_image_classification(10_000, (28, 28, 1), 10, seed=seed + 1)
        return train, test, {"name": "mnist", "synthetic": True,
                             "source": "synthetic-surrogate"}

    raise DatasetUnavailable(
        f"MNIST not found under {data_dir}; pass download=True (needs "
        "network) or fallback='synthetic'"
    )


# ======================================================================
# AG-News (text classification, 4 classes)


def load_ag_news(
    data_dir: Optional[str] = None,
    max_len: int = 128,
    fallback: Optional[str] = None,
    seed: int = 0,
) -> Tuple[Arrays, Arrays, Dict]:
    """Returns ``(train, test, info)`` with ``x`` int32 [N, max_len]
    byte-tokenized text (:class:`ByteTokenizer`) and ``y`` int32 [N] in
    [0, 4). Expects ``train.csv``/``test.csv`` in the AG-News release
    format: ``"class","title","description"`` with classes 1-4."""
    data_dir = data_dir or os.path.join(DEFAULT_CACHE, "ag_news")
    train_csv = os.path.join(data_dir, "train.csv")
    test_csv = os.path.join(data_dir, "test.csv")
    tok = ByteTokenizer(max_len=max_len)

    if os.path.exists(train_csv) and os.path.exists(test_csv):
        def read(path):
            import csv

            xs, ys = [], []
            with open(path, newline="", encoding="utf-8") as f:
                for row in csv.reader(f):
                    if not row:
                        continue
                    label = int(row[0]) - 1
                    text = ". ".join(row[1:])
                    xs.append(tok.encode(text))
                    ys.append(label)
            return {"x": np.stack(xs), "y": np.asarray(ys, np.int32)}

        return (read(train_csv), read(test_csv),
                {"name": "ag_news", "synthetic": False, "source": data_dir,
                 "vocab_size": tok.vocab_size})

    if fallback == "synthetic":
        train = synthetic_text_classification(8_000, max_len, 4, tok, seed=seed)
        test = synthetic_text_classification(1_000, max_len, 4, tok, seed=seed + 1)
        return train, test, {"name": "ag_news", "synthetic": True,
                             "source": "synthetic-surrogate",
                             "vocab_size": tok.vocab_size}

    raise DatasetUnavailable(
        f"AG-News train.csv/test.csv not found under {data_dir}; "
        "fetch the release CSVs there or pass fallback='synthetic'"
    )


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: ids 0..255 are bytes, 256 is PAD.

    No merges, no external vocab files — deterministic, air-gap-safe,
    and adequate for classification fine-tunes (BASELINE config 3)."""

    PAD = 256

    def __init__(self, max_len: int = 128):
        self.max_len = max_len

    @property
    def vocab_size(self) -> int:
        return 257

    def encode(self, text: str) -> np.ndarray:
        raw = np.frombuffer(text.encode("utf-8")[: self.max_len], np.uint8)
        out = np.full((self.max_len,), self.PAD, np.int32)
        out[: raw.size] = raw
        return out

    def decode(self, ids) -> str:
        ids = np.asarray(ids)
        ids = ids[ids != self.PAD]
        return bytes(ids.astype(np.uint8)).decode("utf-8", errors="replace")

    def mask(self, ids) -> np.ndarray:
        """1.0 where a real token, 0.0 on padding — feeds attention bias
        / loss masks."""
        return (np.asarray(ids) != self.PAD).astype(np.float32)


# ======================================================================
# digits — REAL image data with zero egress


def load_digits_real(test_fraction: float = 0.2, seed: int = 0
                     ) -> Tuple[Arrays, Arrays, Dict]:
    """The UCI/NIST handwritten-digits dataset bundled INSIDE
    scikit-learn: 1797 real 8x8 grayscale digit images — the one real
    image dataset available in an air-gapped container. Returns
    ``(train, test, info)`` with ``x`` float32 [N, 8, 8, 1] in [0, 1]
    and ``y`` int32 [N], deterministically split.

    This exists so at least one recorded training run uses REAL bytes
    (every other loader needs network or pre-staged files and otherwise
    falls back to labelled synthetic surrogates). The loader contract is
    pinned in tests/test_datasets.py; the real-data accuracy bar lives
    with the canonical recipe (examples/10_real_digits.py, run by
    tests/test_examples.py::test_real_digits).
    """
    try:
        from sklearn.datasets import load_digits as _ld
    except ImportError as e:
        raise DatasetUnavailable("scikit-learn not installed") from e
    d = _ld()
    x = (d.data.astype(np.float32) / 16.0).reshape(-1, 8, 8, 1)
    y = d.target.astype(np.int32)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(y))
    x, y = x[order], y[order]
    n_test = int(len(y) * test_fraction)
    test = {"x": x[:n_test], "y": y[:n_test]}
    train = {"x": x[n_test:], "y": y[n_test:]}
    info = {
        "dataset": "sklearn_digits",
        "real": True,
        "n_train": len(train["y"]),
        "n_test": n_test,
        "source": "scikit-learn bundled data (UCI optical digits)",
    }
    return train, test, info


# ======================================================================
# deterministic synthetic surrogates (clearly labelled as such)


def synthetic_image_classification(
    n: int, shape: Tuple[int, ...], n_classes: int, seed: int = 0
) -> Arrays:
    """Class-conditional Gaussian images: per-class prototype + noise.
    Learnable (a CNN separates the classes), shaped like the real thing."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(0.5, 0.25, size=(n_classes,) + shape).astype(np.float32)
    y = rng.integers(0, n_classes, size=(n,)).astype(np.int32)
    x = protos[y] + rng.normal(0, 0.35, size=(n,) + shape).astype(np.float32)
    return {"x": np.clip(x, 0.0, 1.0), "y": y}


def synthetic_text_classification(
    n: int, max_len: int, n_classes: int, tok: ByteTokenizer, seed: int = 0
) -> Arrays:
    """Class-conditional token distributions over the byte vocab."""
    rng = np.random.default_rng(seed)
    class_words = [
        [f"w{c}_{i}" for i in range(12)] for c in range(n_classes)
    ]
    common = [f"the{i}" for i in range(8)]
    xs, ys = [], []
    for _ in range(n):
        c = int(rng.integers(0, n_classes))
        words = rng.choice(class_words[c] + common, size=12)
        xs.append(tok.encode(" ".join(words)))
        ys.append(c)
    return {"x": np.stack(xs), "y": np.asarray(ys, np.int32)}
