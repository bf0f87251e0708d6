"""Token-prefix KV cache store holding device tensors.

Port of ``lapha_tpu/engine/prefix_cache.py`` over the same token radix trie
(``lapha_tpu_torch.native``: the repo's C++ trie when built, else a
pure-Python one). Entries are per-sequence KV
slices keyed by their token ids, served by longest-prefix lookup and evicted
LRU under a byte budget.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F

from ..native import make_prefix_tree


class PrefixCacheStore:
    def __init__(self, max_bytes: int = 1_500_000_000, min_reuse: int = 64,
                 pad_to: int = 128):
        self.max_bytes = int(max_bytes)
        self.min_reuse = int(min_reuse)
        # slices are stored padded to a multiple of pad_to along the length
        # axis (the true length travels alongside), as in the JAX store
        self.pad_to = max(1, int(pad_to))
        self._entries: OrderedDict[int, dict] = OrderedDict()  # handle -> entry
        self._key_to_handle: dict[tuple, int] = {}
        self._trie = make_prefix_tree()
        self._next_handle = 0
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0

    def __len__(self):
        return len(self._entries)

    @property
    def nbytes(self):
        return self._bytes

    def _evict(self, handle: int) -> None:
        ent = self._entries.pop(handle, None)
        if ent is None:
            return
        self._bytes -= ent["bytes"]
        self._key_to_handle.pop(ent["key"], None)
        self._trie.remove(handle)

    def put(self, tokens: list[int], kv: tuple[torch.Tensor, torch.Tensor], h_sum=None) -> None:
        """kv: (k, v) of shape (layers, len, n_kv, head_dim), owned by the
        store from here on; padded to ``pad_to`` along the length axis.
        h_sum: optional (H,) final-hidden sum over these tokens."""
        key = tuple(int(t) for t in tokens)
        if not key:
            return
        k, v = kv
        pad_len = -(-len(key) // self.pad_to) * self.pad_to
        if k.shape[1] < pad_len:
            pad = (0, 0, 0, 0, 0, pad_len - k.shape[1])  # last dims first
            k, v = F.pad(k, pad), F.pad(v, pad)
        size = int(k.numel() * k.element_size() * 2)
        if size > self.max_bytes:
            return
        old = self._key_to_handle.get(key)
        if old is not None:
            self._evict(old)
        handle = self._next_handle
        self._next_handle += 1
        self._entries[handle] = {"key": key, "kv": (k, v), "bytes": size, "h_sum": h_sum}
        self._key_to_handle[key] = handle
        self._trie.insert(list(key), handle)
        self._bytes += size
        while self._bytes > self.max_bytes and self._entries:
            self._evict(next(iter(self._entries)))

    def longest_prefix(self, tokens: list[int], max_use: int | None = None,
                       allow_partial: bool = True):
        """Longest stored entry that is a prefix of ``tokens``: (k, v, plen,
        h_sum) or None. k/v are the full padded stored tensors and ``plen``
        how many leading slots are valid. ``max_use`` caps the reused length;
        ``allow_partial=False`` disables reusing part of an exact-match entry
        (collect_h0 engines need h_sum to cover exactly the reused tokens)."""
        toks = [int(t) for t in tokens]
        cap = len(toks) if max_use is None else min(len(toks), max_use)
        exact = self._key_to_handle.get(tuple(toks)) if allow_partial else None
        if exact is not None and cap >= self.min_reuse:
            hit, partial = (exact, cap), True
        else:
            hit, partial = self._trie.longest_prefix(toks, cap), False
        if hit is None or hit[1] < self.min_reuse:
            self.misses += 1
            return None
        handle, plen = hit
        ent = self._entries.pop(handle)  # LRU bump
        self._entries[handle] = ent
        self.hits += 1
        self.tokens_reused += plen
        k, v = ent["kv"]
        return k, v, plen, (None if partial else ent.get("h_sum"))

    def clear(self):
        for handle in list(self._entries):
            self._evict(handle)

    def stats(self) -> dict:
        return {"entries": len(self._entries), "bytes": self._bytes,
                "hits": self.hits, "misses": self.misses,
                "tokens_reused": self.tokens_reused}
