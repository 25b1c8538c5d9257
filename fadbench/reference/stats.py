"""Statistics and Fréchet distance of the benchmark's reference, in float64.

The mean and the unbiased (N - 1) covariance of a directory's rows, as
numpy.cov(rowvar=False) takes them, and the Fréchet distance by two
symmetric eigendecompositions, trace(sqrtm(S1 S2)) = sum sqrt(eig(S2^1/2 S1
S2^1/2)); frozen from
frechet_audio_distance_exported_tpu_torch/ops/stats.py
(calculate_embd_statistics_np, frechet_distance_eigh_np).
"""

from __future__ import annotations

import numpy as np
import torch


def mean_cov(rows: torch.Tensor):
    """[N, d] rows (any float dtype, any device) -> (mu [d], sigma [d, d]) in
    float64 NumPy."""
    x = rows.to(torch.float64)
    mu = x.mean(dim=0)
    xc = x - mu
    sigma = (xc.T @ xc) / (x.shape[0] - 1)
    return mu.cpu().numpy(), sigma.cpu().numpy()


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    def trace_sqrtm(a, b):
        w2, v2 = np.linalg.eigh(0.5 * (b + b.T))
        b_half = (v2 * np.sqrt(np.maximum(w2, 0.0))) @ v2.T
        inner = b_half @ a @ b_half
        return float(np.sum(np.sqrt(np.maximum(np.linalg.eigvalsh(0.5 * (inner + inner.T)), 0.0))))

    diff = np.asarray(mu1, np.float64) - np.asarray(mu2, np.float64)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * trace_sqrtm(sigma1, sigma2))
