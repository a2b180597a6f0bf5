"""Generative metrics: FID, Inception Score, KID, precision/recall.

The port's copy of the JAX package's ``eval/metrics.py``: the same
formulas (torch-fidelity's metric_fid, metric_isc, metric_kid and
metric_prc), in float64 numpy, so that on the same feature arrays every
result equals the JAX package's. Only the input checks differ: they raise
``ValueError`` where the JAX package asserts. The features come from
``eval/pipeline.py``'s extractor on the device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

KEY_FID = "frechet_inception_distance"
KEY_ISC_MEAN = "inception_score_mean"
KEY_ISC_STD = "inception_score_std"
KEY_KID_MEAN = "kernel_inception_distance_mean"
KEY_KID_STD = "kernel_inception_distance_std"
KEY_PRC_PRECISION = "precision"
KEY_PRC_RECALL = "recall"
KEY_PRC_F_SCORE = "f_score"


def _matrix(features, name: str) -> np.ndarray:
    """``features`` as a float64 (N, D) array; raises if it is not 2-D."""
    features = np.asarray(features, dtype=np.float64)
    if features.ndim != 2:
        raise ValueError(f"{name} must be an (N, D) matrix, got shape {features.shape}")
    return features


# --- FID --------------------------------------------------------------------


def fid_features_to_statistics(features: np.ndarray) -> Dict[str, np.ndarray]:
    """{mu, sigma} of an (N, D) feature matrix
    (torch-fidelity's metric_fid.py:21-29)."""
    features = _matrix(features, "features")
    return {
        "mu": np.mean(features, axis=0),
        "sigma": np.cov(features, rowvar=False),
    }


def fid_statistics_to_metric(stat1, stat2) -> float:
    """Frechet distance via sum of sqrt eigenvalues of sigma1 @ sigma2
    (torch-fidelity's metric_fid.py:32-46 — eigvals, not sqrtm, with complex
    sqrt and real part)."""
    mu1, sigma1 = stat1["mu"], stat1["sigma"]
    mu2, sigma2 = stat2["mu"], stat2["sigma"]
    diff = mu1 - mu2
    tr_covmean = np.sum(
        np.sqrt(np.linalg.eigvals(sigma1.dot(sigma2)).astype("complex128")).real
    )
    return float(
        diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean
    )


def fid_features_to_metric(feat1: np.ndarray, feat2: np.ndarray) -> float:
    return fid_statistics_to_metric(
        fid_features_to_statistics(feat1), fid_features_to_statistics(feat2)
    )


# --- Inception Score --------------------------------------------------------


def isc_features_to_metric(
    features: np.ndarray,
    splits: int = 10,
    shuffle: bool = True,
    rng_seed: int = 2020,
) -> Dict[str, float]:
    """exp(mean KL) over ``splits`` chunks of softmaxed logits
    (torch-fidelity's metric_isc.py:16-39; same shuffle RNG protocol)."""
    features = _matrix(features, "features")
    n = features.shape[0]
    if shuffle:
        rng = np.random.RandomState(rng_seed)
        features = features[rng.permutation(n), :]

    # log-softmax, numerically stable
    shifted = features - features.max(axis=1, keepdims=True)
    log_p = shifted - np.log(np.exp(shifted).sum(axis=1, keepdims=True))
    p = np.exp(log_p)

    scores = []
    for i in range(splits):
        p_chunk = p[(i * n // splits) : ((i + 1) * n // splits), :]
        log_p_chunk = log_p[(i * n // splits) : ((i + 1) * n // splits), :]
        q = p_chunk.mean(axis=0, keepdims=True)
        kl = (p_chunk * (log_p_chunk - np.log(q))).sum(axis=1).mean()
        scores.append(np.exp(kl))
    return {
        KEY_ISC_MEAN: float(np.mean(scores)),
        KEY_ISC_STD: float(np.std(scores)),
    }


# --- KID --------------------------------------------------------------------


def _poly_kernel(x, y, degree=3, gamma=None, coef0=1.0):
    if gamma is None:
        gamma = 1.0 / x.shape[1]
    return (x @ y.T * gamma + coef0) ** degree


def _rbf_kernel(x, y, sigma):
    d2 = (
        np.sum(x**2, axis=1)[:, None]
        + np.sum(y**2, axis=1)[None, :]
        - 2 * x @ y.T
    )
    return np.exp(-d2 / (2 * sigma**2))


def _mmd2_unbiased(k_xx, k_yy, k_xy):
    """Unbiased MMD^2 estimator (torch-fidelity's metric_kid.py:40-93)."""
    m = k_xx.shape[0]
    diag_x = np.diagonal(k_xx)
    diag_y = np.diagonal(k_yy)
    kt_xx_sum = k_xx.sum() - diag_x.sum()
    kt_yy_sum = k_yy.sum() - diag_y.sum()
    k_xy_sum = k_xy.sum()
    return (
        kt_xx_sum / (m * (m - 1))
        + kt_yy_sum / (m * (m - 1))
        - 2 * k_xy_sum / (m * m)
    )


def kid_features_to_metric(
    feat1: np.ndarray,
    feat2: np.ndarray,
    subsets: int = 100,
    subset_size: int = 1000,
    degree: int = 3,
    gamma: Optional[float] = None,
    coef0: float = 1.0,
    kernel: str = "poly",
    rbf_sigma: float = 10.0,
    rng_seed: int = 2020,
) -> Dict[str, float]:
    """Polynomial-kernel MMD^2 over random subsets
    (torch-fidelity's metric_kid.py:96-134; defaults.py:20-26)."""
    feat1 = _matrix(feat1, "feat1")
    feat2 = _matrix(feat2, "feat2")
    n1, n2 = feat1.shape[0], feat2.shape[0]
    size = min(subset_size, n1, n2)
    rng = np.random.RandomState(rng_seed)
    scores = []
    for _ in range(subsets):
        x = feat1[rng.choice(n1, size, replace=False)]
        y = feat2[rng.choice(n2, size, replace=False)]
        if kernel == "poly":
            k_xx = _poly_kernel(x, x, degree, gamma, coef0)
            k_yy = _poly_kernel(y, y, degree, gamma, coef0)
            k_xy = _poly_kernel(x, y, degree, gamma, coef0)
        else:
            k_xx = _rbf_kernel(x, x, rbf_sigma)
            k_yy = _rbf_kernel(y, y, rbf_sigma)
            k_xy = _rbf_kernel(x, y, rbf_sigma)
        scores.append(_mmd2_unbiased(k_xx, k_yy, k_xy))
    return {
        KEY_KID_MEAN: float(np.mean(scores)),
        KEY_KID_STD: float(np.std(scores)),
    }


# --- improved precision / recall -------------------------------------------


def _cdist_chunk(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact pairwise Euclidean distances for one (rows x cols) tile."""
    d2 = (
        np.sum(a**2, axis=1)[:, None]
        + np.sum(b**2, axis=1)[None, :]
        - 2 * a @ b.T
    )
    np.clip(d2, 0, None, out=d2)
    return np.sqrt(d2)


def _knn_radii(x: np.ndarray, k: int, batch_size: int) -> np.ndarray:
    """Per-row distance to the k-th nearest *other* point of ``x``.

    Streaming equivalent of torch-fidelity's
    ``calc_cdist_*(x, x, batch_size).kthvalue(k + 1)``
    (metric_prc.py:16-40): the self-distance 0 occupies the smallest
    slot, so the (k+1)-th smallest including self is the k-th neighbor.
    Memory is bounded by one ``batch_size x batch_size`` tile — the full
    N x N matrix is never materialized.
    """
    n = x.shape[0]
    radii = np.empty(n, dtype=x.dtype)
    keep = min(k + 1, n)
    for i0 in range(0, n, batch_size):
        rows = x[i0 : i0 + batch_size]
        best = None  # running (k+1)-smallest distances per row
        for j0 in range(0, n, batch_size):
            d = _cdist_chunk(rows, x[j0 : j0 + batch_size])
            kd = min(keep, d.shape[1])
            part = np.partition(d, kd - 1, axis=1)[:, :kd]
            cand = part if best is None else np.concatenate(
                [best, part], axis=1
            )
            kc = min(keep, cand.shape[1])
            best = np.partition(cand, kc - 1, axis=1)[:, :kc]
        radii[i0 : i0 + batch_size] = np.sort(best, axis=1)[:, keep - 1]
    return radii


def _coverage(
    a: np.ndarray, b: np.ndarray, radii_b: np.ndarray, batch_size: int
) -> float:
    """Fraction of rows of ``a`` within some ``b`` point's k-NN radius —
    torch-fidelity's ``(cdist(a, b) <= dist_nn_b).any(dim=1)`` reduction
    (metric_prc.py:30-43, 63-65), tile-chunked."""
    hits_total = 0
    for i0 in range(0, a.shape[0], batch_size):
        rows = a[i0 : i0 + batch_size]
        h = np.zeros(rows.shape[0], dtype=bool)
        for j0 in range(0, b.shape[0], batch_size):
            d = _cdist_chunk(rows, b[j0 : j0 + batch_size])
            h |= np.any(d <= radii_b[j0 : j0 + batch_size][None, :], axis=1)
        hits_total += int(h.sum())
    return hits_total / a.shape[0]


def prc_features_to_metric(
    features_1: np.ndarray,
    features_2: np.ndarray,
    neighborhood: int = 3,
    batch_size: int = 10000,
    save_cpu_ram: bool = False,
) -> Dict[str, float]:
    """Improved precision/recall via k-NN radii
    (torch-fidelity's metric_prc.py:16-112, k=3).

    Convention (torch-fidelity's metric_prc.py:70): ``features_1`` is REAL,
    ``features_2`` is GENERATED. precision = fraction of generated
    samples inside some real sample's k-NN radius (metric_prc.py:63);
    recall = vice versa (metric_prc.py:65).

    All distance work is tiled at ``batch_size`` (torch-fidelity's
    metric_prc.py:16-40) and additionally streamed so the full N x N
    matrix is never materialized — strictly tighter than
    torch-fidelity's ``save_cpu_ram`` part-mode, so that flag is accepted
    for API parity but changes nothing (results are identical between
    torch-fidelity's two modes as well; only memory strategy differs).
    """
    del save_cpu_ram  # always memory-bounded; see docstring
    real = _matrix(features_1, "features_1")
    fake = _matrix(features_2, "features_2")
    if real.shape[1] != fake.shape[1]:
        raise ValueError(f"feature widths differ: {real.shape[1]} and {fake.shape[1]}")
    # torch-fidelity's kthvalue(k+1) hard-fails on feature sets with
    # n <= k rows (metric_prc.py:28,38); a silent degradation to the
    # max distance would report misleading PRC values
    for label, feats in (("features_1", real), ("features_2", fake)):
        if feats.shape[0] <= neighborhood:
            raise ValueError(
                f"PRC needs more than prc_neighborhood={neighborhood} "
                f"samples per input; {label} has only {feats.shape[0]} "
                f"(torch-fidelity's kthvalue(k+1) fails likewise)"
            )
    batch_size = max(1, int(batch_size))

    radii_real = _knn_radii(real, neighborhood, batch_size)
    radii_fake = _knn_radii(fake, neighborhood, batch_size)
    precision = _coverage(fake, real, radii_real, batch_size)
    recall = _coverage(real, fake, radii_fake, batch_size)
    # guard matches torch-fidelity's metric_prc.py:82
    f_score = 2 * precision * recall / max(1e-5, precision + recall)
    return {
        KEY_PRC_PRECISION: precision,
        KEY_PRC_RECALL: recall,
        KEY_PRC_F_SCORE: f_score,
    }
