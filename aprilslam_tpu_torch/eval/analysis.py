"""Offline error analytics: PCA, KMeans, regression and covariance over the
logged CSVs (port of ``aprilslam_tpu/eval/analysis.py``, in PyTorch on the
CPU).

* ``error_analysis``: standardize features -> PCA(2) -> KMeans(3) -> linear
  regression predicting the translation error with MSE/R^2 and feature
  importances; writes ``slam_clustered_data.csv``.
* ``covariance_report``: covariance of the logged parameters against the
  translation error (the polling monitor lives in viz/monitor.py).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass

import numpy as np
import torch

DEFAULT_FEATURES = [
    "Number_of_Nodes",
    "Average_Distance",
    "Est_X", "Est_Y", "Est_Z",
    "Est_Roll", "Est_Pitch", "Est_Yaw",
    "Rotation_Difference",
]
TARGET = "Translation_Difference"


def standardize(X: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    mu = torch.mean(X, dim=0)
    sd = torch.std(X, dim=0, correction=0) + 1e-12
    return (X - mu) / sd, mu, sd


def pca(X: torch.Tensor, n_components: int = 2) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (projected (N, k), components (k, D), explained variance).
    Each component's sign is the SVD's own, as in the JAX version."""
    Xc = X - torch.mean(X, dim=0)
    U, S, Vt = torch.linalg.svd(Xc, full_matrices=False)
    comps = Vt[:n_components]
    proj = Xc @ comps.T
    var = (S**2) / (X.shape[0] - 1)
    return proj, comps, var[:n_components] / torch.sum(var)


def kmeans(X: torch.Tensor, k: int = 3, iters: int = 50, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm. Returns (labels (N,), centers (k, D)).

    The initial centres are ``k`` distinct rows drawn by a
    ``torch.Generator`` seeded with ``seed``, where the JAX version draws
    them with ``jax.random.choice``: the clustering agrees with the JAX
    package's only up to a permutation of the labels."""
    gen = torch.Generator().manual_seed(seed)
    init_idx = torch.randperm(X.shape[0], generator=gen)[:k].to(X.device)
    centers = X[init_idx]
    ar = torch.arange(k, device=X.device)
    for _ in range(iters):
        d = torch.sum((X[:, None, :] - centers[None, :, :]) ** 2, dim=-1)  # (N, k)
        lab = torch.argmin(d, dim=-1)
        onehot = (lab[:, None] == ar[None, :]).to(X.dtype)  # (N, k)
        counts = onehot.sum(dim=0)
        sums = onehot.T @ X
        new_centers = sums / torch.clamp(counts, min=1.0)[:, None]
        centers = torch.where(counts[:, None] > 0, new_centers, centers)
    d = torch.sum((X[:, None, :] - centers[None, :, :]) ** 2, dim=-1)
    return torch.argmin(d, dim=-1), centers


def linear_regression(X: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Least squares with intercept (the minimum-norm solution, by SVD).
    Returns (coef (D,), intercept, [mse, r2])."""
    A = torch.cat([X, torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device)], dim=1)
    w = torch.linalg.lstsq(A, y[:, None], driver="gelsd").solution[:, 0]
    pred = A @ w
    mse = torch.mean((pred - y) ** 2)
    ss_res = torch.sum((y - pred) ** 2)
    ss_tot = torch.sum((y - torch.mean(y)) ** 2) + 1e-12
    r2 = 1.0 - ss_res / ss_tot
    return w[:-1], w[-1], torch.stack([mse, r2])


@dataclass
class ErrorAnalysisResult:
    labels: np.ndarray
    pca_proj: np.ndarray
    explained_variance: np.ndarray
    coefficients: dict
    mse: float
    r2: float
    output_csv: str | None


def error_analysis(
    csv_path: str,
    features: list[str] = DEFAULT_FEATURES,
    target: str = TARGET,
    n_clusters: int = 3,
    output_csv: str | None = None,
) -> ErrorAnalysisResult:
    """Run the full PCA+KMeans+regression pipeline over a logged CSV."""
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        raise ValueError(f"no rows in {csv_path}")
    feats = [c for c in features if c in rows[0]]
    X = np.asarray([[float(r[c]) for c in feats] for r in rows], dtype=np.float32)
    y = np.asarray([float(r[target]) for r in rows], dtype=np.float32)

    Xs, mu, sd = standardize(torch.from_numpy(X))
    proj, comps, ev = pca(Xs, 2)
    labels, centers = kmeans(Xs, n_clusters)
    coef, intercept, stats = linear_regression(Xs, torch.from_numpy(y))
    mse, r2 = float(stats[0]), float(stats[1])
    pj, lb = proj.numpy(), labels.numpy()

    out_path = None
    if output_csv:
        os.makedirs(os.path.dirname(output_csv) or ".", exist_ok=True)
        with open(output_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(list(rows[0].keys()) + ["PCA1", "PCA2", "Cluster"])
            for i, r in enumerate(rows):
                w.writerow(list(r.values()) + [round(float(pj[i, 0]), 6),
                                               round(float(pj[i, 1]), 6), int(lb[i])])
        out_path = output_csv

    return ErrorAnalysisResult(
        labels=lb,
        pca_proj=pj,
        explained_variance=ev.numpy(),
        coefficients={c: float(v) for c, v in zip(feats, coef.numpy())},
        mse=mse,
        r2=r2,
        output_csv=out_path,
    )


def covariance_report(csv_path: str, target: str = "Translation_Error") -> dict:
    """Covariance of each logged parameter with the error column
    (covarience.py:36-67 semantics, batch version)."""
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return {}
    cols = [c for c in rows[0] if c != target]
    X = torch.tensor([[float(r[c]) for c in cols] for r in rows], dtype=torch.float64)
    y = torch.tensor([float(r[target]) for r in rows], dtype=torch.float64)
    cov = ((X - X.mean(dim=0)) * (y - y.mean())[:, None]).mean(dim=0)
    return {c: float(v) for c, v in zip(cols, cov)}
