"""Append-only latent store for MCTS tree embeddings.

Port of ``lapha_tpu/search/latent_bank.py`` (reference LatentBank,
the reference implementation's trainer/latent_bank.py:41-210 — add/index_select/
offload_to_cpu/reload_to_gpu/clear/stats): rows live in a preallocated
host buffer (they arrive on host anyway when the search loop reads v_pred).
Sized for num_sim×breadth ≈ 10³ rows × H ≤ 4096 — ~16 MB. ``index_select``
returns a float32 torch tensor (numpy when offloaded), as the JAX bank
returns a device array.
"""

from __future__ import annotations

import numpy as np
import torch


class LatentBank:
    def __init__(self, dim: int | None = None, capacity: int = 4096,
                 dtype=np.float32, normalize: bool = False):
        self.dim = dim
        self.capacity = int(capacity)
        self.dtype = dtype
        self.normalize = bool(normalize)
        self._buf: np.ndarray | None = None
        self._n = 0
        self._device_cache = None
        self._offloaded = False

    def __len__(self) -> int:
        return self._n

    def _ensure(self, dim: int):
        if self._buf is None:
            self.dim = dim
            self._buf = np.zeros((self.capacity, dim), self.dtype)
        elif dim != self.dim:
            raise ValueError(f"latent dim mismatch: bank {self.dim}, add {dim}")

    def add(self, rows) -> list[int] | int:
        """Append row(s); returns index (single row) or list of indices."""
        arr = np.asarray(rows, np.float32)
        single = arr.ndim == 1
        if single:
            arr = arr[None, :]
        self._ensure(arr.shape[-1])
        if self.normalize:
            norms = np.maximum(np.linalg.norm(arr, axis=-1, keepdims=True), 1e-12)
            arr = arr / norms
        k = arr.shape[0]
        while self._n + k > self._buf.shape[0]:
            self._buf = np.concatenate([self._buf, np.zeros_like(self._buf)], axis=0)
        idx = list(range(self._n, self._n + k))
        self._buf[self._n : self._n + k] = arr.astype(self.dtype)
        self._n += k
        self._device_cache = None
        return idx[0] if single else idx

    def index_select(self, indices):
        """Gather rows as a float32 tensor (numpy when offloaded)."""
        idx = np.asarray(indices, np.int64).reshape(-1)
        if self._n == 0:
            raise ValueError("empty bank")
        if (idx < 0).any() or (idx >= self._n).any():
            raise IndexError(f"indices out of range [0,{self._n})")
        rows = self._buf[idx].astype(np.float32)
        return rows if self._offloaded else torch.from_numpy(rows)

    def all_rows(self):
        return self.index_select(np.arange(self._n)) if self._n else np.zeros((0, self.dim or 0), np.float32)

    # lifecycle API kept for parity (host-resident store: offload is a no-op
    # flag that makes index_select return numpy instead of tensors)
    def offload_to_cpu(self):
        self._offloaded = True
        self._device_cache = None

    def reload_to_gpu(self):  # name kept for API familiarity; means "to device"
        self._offloaded = False

    reload_to_device = reload_to_gpu

    def clear(self):
        self._buf = None
        self._n = 0
        self._device_cache = None

    def stats(self) -> dict:
        return {
            "rows": self._n,
            "dim": self.dim,
            "capacity": 0 if self._buf is None else self._buf.shape[0],
            "bytes": 0 if self._buf is None else self._buf.nbytes,
            "offloaded": self._offloaded,
        }
