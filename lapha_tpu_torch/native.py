"""Token radix trie for the prefix cache.

Uses the compiled ``lapha_native.PrefixTree`` (built from the repo's
``native/`` sources, the same extension the JAX package uses) when it can be
imported, else a pure-Python trie with the same API and semantics (a copy of
``lapha_tpu/native.py``'s ``PyPrefixTree``, so this package needs nothing of
the JAX package). Nothing is compiled here.
"""

from __future__ import annotations

import os
import sys

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")


def _native_module():
    try:
        import lapha_native

        return lapha_native
    except ImportError:
        pass
    if os.path.isdir(_NATIVE_DIR) and _NATIVE_DIR not in sys.path:
        sys.path.append(_NATIVE_DIR)
        try:
            import lapha_native

            return lapha_native
        except ImportError:
            pass
    return None


class PyPrefixTree:
    """Token radix trie; same API as lapha_native.PrefixTree."""

    def __init__(self):
        self._root: dict = {}
        self._handles: dict[int, tuple] = {}

    def insert(self, tokens, handle: int) -> None:
        node = self._root
        for t in tokens:
            node = node.setdefault(int(t), {})
        old = node.get("__handle__")
        if old is not None:
            self._handles.pop(old, None)
        node["__handle__"] = handle
        self._handles[handle] = (tuple(int(t) for t in tokens), node)

    def longest_prefix(self, tokens, max_len: int = -1):
        cap = len(tokens) if max_len < 0 else min(len(tokens), max_len)
        node = self._root
        best = None
        for i in range(cap):
            node = node.get(int(tokens[i]))
            if node is None:
                break
            h = node.get("__handle__")
            if h is not None:
                best = (h, i + 1)
        return best

    def remove(self, handle: int) -> bool:
        ent = self._handles.pop(handle, None)
        if ent is None:
            return False
        ent[1].pop("__handle__", None)
        return True

    def __len__(self):
        return len(self._handles)


def make_prefix_tree():
    mod = _native_module()
    return mod.PrefixTree() if mod is not None else PyPrefixTree()
