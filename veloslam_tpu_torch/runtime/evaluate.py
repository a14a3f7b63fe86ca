"""Trajectory evaluation against ground truth (host, numpy).

A jax-free copy of `ate` and `interpolate_positions` from
veloslam_tpu/runtime/evaluate.py (importing the original imports jax
through the runtime package's __init__).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def umeyama_align(est: np.ndarray, ref: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform aligning est → ref (both (N, 3)).

    Returns (R (3,3), t (3,), s) minimizing ‖s·R·est + t − ref‖².
    """
    mu_e, mu_r = est.mean(0), ref.mean(0)
    xe, xr = est - mu_e, ref - mu_r
    cov = xr.T @ xe / len(est)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float((D * S.diagonal()).sum() / (xe ** 2).sum() * len(est)) \
        if with_scale else 1.0
    t = mu_r - s * R @ mu_e
    return R, t, s


def ate(est_pos: np.ndarray, ref_pos: np.ndarray,
        align: bool = True) -> Dict[str, float]:
    """Absolute trajectory error (RMSE/mean/median/max of position error)."""
    est, ref = np.asarray(est_pos, float), np.asarray(ref_pos, float)
    if est.shape != ref.shape:
        raise ValueError(f"shape mismatch {est.shape} vs {ref.shape}")
    if align and len(est) >= 3 and est.shape[1] == 3:
        R, t, s = umeyama_align(est, ref)
        est = est @ R.T * s + t
    e = np.linalg.norm(est - ref, axis=1)
    return {"rmse": float(np.sqrt(np.mean(e ** 2))),
            "mean": float(e.mean()), "median": float(np.median(e)),
            "max": float(e.max())}


def interpolate_positions(t_query_us: np.ndarray, t_ref_us: np.ndarray,
                          pos_ref: np.ndarray) -> np.ndarray:
    """Linear interpolation of a reference trajectory at query times."""
    out = np.empty((len(t_query_us), 3))
    for d in range(3):
        out[:, d] = np.interp(t_query_us.astype(float),
                              t_ref_us.astype(float), pos_ref[:, d])
    return out
