"""Latent-space clustering for branch pruning.

Behavior parity with the reference's `cluster_and_prune`
(the reference implementation's trainer/agent.py:412-503): average-linkage agglomerative
clustering under Poincaré geodesic distance, cut at the largest relative
jump in merge distance, Euclidean-mean centers clamped into the ball, and
~1/3 of each cluster's members randomly disabled.

Port of ``lapha_tpu/search/cluster.py``: the N×N geodesic matrix is the
port's ``ops.poincare_dist_matrix`` (PyTorch, float32) in place of the JAX
one; the agglomeration is the same Lance-Williams average-linkage update in
numpy — O(N²) per merge on a ≤10³-point set, negligible next to generation.
"""

from __future__ import annotations

import random as _random

import numpy as np
import torch

from ..ops import poincare_dist_matrix


def geodesic_matrix(points: np.ndarray) -> np.ndarray:
    """(N,H) ball points -> (N,N) float32 geodesic distances."""
    x = torch.from_numpy(np.asarray(points, np.float32))
    return poincare_dist_matrix(x, x).numpy()


def average_linkage_labels(D: np.ndarray) -> np.ndarray:
    """Agglomerate with average linkage; cut at the largest relative jump.

    Returns integer labels (N,). Mirrors the reference's cut rule: with m
    merge distances d_1..d_m, cut after merge argmax((d_{i+1}-d_i)/|d_i|)
    (1 merge -> keep it; 0 merges -> singletons), and if the cut would keep
    every point separate, force ~len/4 merges (agent.py:458-471).
    """
    N = D.shape[0]
    if N <= 1:
        return np.zeros(N, np.int64)

    # Lance-Williams average linkage over an active-cluster distance matrix
    M = D.astype(np.float64).copy()
    np.fill_diagonal(M, np.inf)
    sizes = np.ones(N)
    active = np.ones(N, bool)
    merges: list[tuple[int, int, float]] = []  # (a, b, dist): b merged into a

    for _ in range(N - 1):
        idx = np.argmin(np.where(active[:, None] & active[None, :], M, np.inf))
        a, b = divmod(int(idx), N)
        if not (active[a] and active[b]) or a == b:
            break
        d = float(M[a, b])
        merges.append((a, b, d))
        na, nb = sizes[a], sizes[b]
        new_row = (na * M[a] + nb * M[b]) / (na + nb)
        M[a], M[:, a] = new_row, new_row
        M[a, a] = np.inf
        sizes[a] = na + nb
        active[b] = False
        M[b], M[:, b] = np.inf, np.inf

    dists = np.array([m[2] for m in merges])
    if len(dists) == 0:
        cut = 0
    elif len(dists) == 1:
        cut = 1
    else:
        deltas = np.diff(dists)
        ratio = deltas / (np.abs(dists[:-1]) + 1e-8)
        cut = int(np.argmax(ratio)) + 1
        cut = min(cut, len(merges))
    if cut == 0 and len(merges) > 0:
        cut = min(max(1, (len(merges) + 1) // 4), len(merges))

    # replay first `cut` merges with union-find
    parent = np.arange(N)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b, _ in merges[:cut]:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    roots = np.array([find(i) for i in range(N)])
    _, labels = np.unique(roots, return_inverse=True)
    return labels


def frechet_center(points: np.ndarray) -> np.ndarray:
    """Euclidean mean clamped into the ball (reference agent.py:473-482)."""
    mean = points.mean(axis=0)
    norm = float(np.linalg.norm(mean)) + 1e-12
    max_norm = 1.0 - 1e-4
    if norm > max_norm:
        mean = mean * (max_norm / norm)
    return mean.astype(np.float32)


def cluster_and_select_disabled(
    points: np.ndarray,
    rng: _random.Random | None = None,
) -> tuple[np.ndarray, dict[int, np.ndarray], np.ndarray]:
    """Full prune pass on (N,H) ball points.

    Returns (labels (N,), centers {label: (H,)}, disabled (N,) bool) where
    per cluster of size n, n//3 random members are disabled (never all).
    """
    rng = rng or _random.Random()
    N = points.shape[0]
    if N == 0:
        return np.zeros(0, np.int64), {}, np.zeros(0, bool)
    if N == 1:
        return np.zeros(1, np.int64), {0: points[0].astype(np.float32)}, np.zeros(1, bool)

    D = geodesic_matrix(points)
    labels = average_linkage_labels(D)
    disabled = np.zeros(N, bool)
    centers: dict[int, np.ndarray] = {}
    for lab in np.unique(labels):
        members = np.where(labels == lab)[0]
        centers[int(lab)] = frechet_center(points[members])
        n = len(members)
        k = max(0, n // 3)
        if k >= n:
            k = n - 1
        if k > 0:
            chosen = rng.sample(list(members), k)
            disabled[np.asarray(chosen)] = True
    return labels, centers, disabled
