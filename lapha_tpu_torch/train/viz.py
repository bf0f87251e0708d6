"""Poincaré-disk tree visualization.

Port of ``lapha_tpu/train/viz.py``: a two-panel PNG per tree, nodes colored
by the geometric V and by v_pred, the root Möbius-translated to the disk
center, high-dim points reduced via logmap0 -> PCA (-> t-SNE when D > 2 and
there are enough points) -> expmap0, and edges drawn as geodesic arcs. The
geometry is the port's ``ops.hyperbolic`` on CPU tensors.

matplotlib and scikit-learn are optional, as in the JAX module: PCA falls
back to a slice of the tangent coordinates, t-SNE to an SVD projection,
and ``plot_tree_disk`` returns ``None`` on any failure (matplotlib absent
included): the plot is a side output of training.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..ops.hyperbolic import expmap0, logmap0, mobius_add


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _to_disk_2d(Y: np.ndarray, root_idx: int | None = None,
                rho_cap: float = 0.98, perplexity: int = 30) -> np.ndarray:
    """(N,D) ball points -> (N,2) disk points via tangent-space reduction:
    logmap0 to the tangent (root row zeroed) -> PCA to min(50, D, N-1) ->
    t-SNE(init="pca", learning_rate="auto", perplexity clamped to
    [5, N-1]) with an SVD-projection fallback -> re-center on the root ->
    rescale so the max tangent norm lands at atanh(rho_cap) -> expmap0; the
    root maps exactly to the disk center."""
    N, D = Y.shape
    T = np.array(logmap0(_t(Y)).numpy(), np.float64)  # tangent space
    if root_idx is not None:
        T[root_idx] = 0.0
    target = float(np.arctanh(min(0.999, rho_cap)))

    if D == 2:
        norms = np.linalg.norm(T, axis=-1)
        if norms.size and norms.max() > 1e-12:
            T = T * (target / norms.max())
        Y2 = expmap0(_t(T.astype(np.float32))).numpy()
        if root_idx is not None:
            Y2[root_idx] = 0.0
        return Y2

    m = int(min(50, D, max(2, N - 1)))
    try:
        from sklearn.decomposition import PCA

        red = (PCA(n_components=m, random_state=0).fit_transform(T)
               if m < D else T)
    except Exception:
        red = T[:, : min(50, D)]
    try:
        from sklearn.manifold import TSNE

        perpl = max(5, min(int(perplexity), max(2, N - 1)))
        Z2 = TSNE(n_components=2, init="pca", learning_rate="auto",
                  perplexity=perpl, verbose=False).fit_transform(red)
    except Exception:  # t-SNE unavailable / too few points: SVD projection
        try:
            _, _, Vt = np.linalg.svd(T, full_matrices=False)
            Z2 = T @ Vt[:2].T
        except Exception:
            Z2 = T[:, :2]
    Z2 = np.asarray(Z2, np.float64)
    if root_idx is not None:
        Z2 = Z2 - Z2[root_idx][None, :]
    else:
        Z2 = Z2 - Z2.mean(axis=0, keepdims=True)
    norms = np.linalg.norm(Z2, axis=1)
    s = target / norms.max() if norms.size and norms.max() > 1e-12 else 1.0
    Y2 = expmap0(_t((Z2 * s).astype(np.float32))).numpy()
    if root_idx is not None:
        Y2[root_idx] = 0.0
    return Y2


def _geodesic_arc(p: np.ndarray, q: np.ndarray, n: int = 24) -> np.ndarray:
    """Points along the hyperbolic geodesic between two disk points:
    p ⊕ expmap0(t · logmap0((-p) ⊕ q)) for t in [0, 1]."""
    mp = mobius_add(_t(-p)[None], _t(q)[None])[0]
    v = logmap0(mp[None])[0].numpy()
    ts = np.linspace(0, 1, n)[:, None]
    seg = expmap0(_t((ts * v[None]).astype(np.float32)))
    return mobius_add(_t(np.repeat(p[None], n, 0)), seg).numpy()


def plot_tree_disk(
    chains: list[list[dict]],
    root_step: Optional[dict],
    out_path: str,
    *,
    title: str = "tree",
) -> Optional[str]:
    """Render treeN_disk.png; returns its path, or None on any failure."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.patches import Circle

        steps = {}
        edges = []
        order = []
        if root_step is not None:
            steps[id(root_step)] = root_step
            order.append(id(root_step))
        for chain in chains:
            prev = id(root_step) if root_step is not None else None
            for st in chain:
                sid = id(st)
                if sid not in steps:
                    steps[sid] = st
                    order.append(sid)
                if prev is not None:
                    edges.append((prev, sid))
                prev = sid

        hids = []
        keep = []
        for sid in order:
            h = steps[sid].get("hid")
            if isinstance(h, (list, tuple)) and len(h) >= 2:
                hids.append(np.asarray(h, np.float32))
                keep.append(sid)
        if len(hids) < 2:
            return None
        Y = np.stack(hids)

        # Möbius-center on the root
        root_sid = order[0]
        if root_sid in keep:
            r = Y[keep.index(root_sid)]
            Y = mobius_add(_t(np.repeat(-r[None], len(Y), 0)), _t(Y)).numpy()
        ri = keep.index(root_sid) if root_sid in keep else None
        P2 = _to_disk_2d(Y, root_idx=ri)
        pos = {sid: P2[i] for i, sid in enumerate(keep)}

        v_geo = np.asarray([float(steps[s].get("v_target") or 0.0) for s in keep])
        v_pred = np.asarray([float(steps[s].get("v_pred") or 0.0) for s in keep])

        fig, axes = plt.subplots(1, 2, figsize=(11, 5.5))
        for ax, colors, name in ((axes[0], v_geo, "V (geometric)"),
                                 (axes[1], v_pred, "v_pred")):
            ax.add_patch(Circle((0, 0), 1.0, fill=False, color="gray", lw=1))
            for a, b in edges:
                if a in pos and b in pos:
                    arc = _geodesic_arc(pos[a], pos[b])
                    ax.plot(arc[:, 0], arc[:, 1], color="lightgray", lw=0.6, zorder=1)
            sc = ax.scatter(P2[:, 0], P2[:, 1], c=colors, cmap="viridis",
                            s=28, vmin=0.0, vmax=1.0, zorder=2)
            ax.set_xlim(-1.05, 1.05)
            ax.set_ylim(-1.05, 1.05)
            ax.set_aspect("equal")
            ax.set_title(f"{title}: {name}")
            ax.axis("off")
            fig.colorbar(sc, ax=ax, fraction=0.046)
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return out_path
    except Exception:
        return None
