"""Token radix trie for the prefix cache, and the scheduler's row allocator.

Uses the compiled ``lapha_native.PrefixTree`` and ``lapha_native.SlotAllocator``
(built from the repo's ``native/`` sources, the same extension the JAX
package uses) when they can be imported, else pure-Python versions with the
same API and semantics (copies of ``lapha_tpu/native.py``'s ``PyPrefixTree``
and ``PySlotAllocator``, so this package needs nothing of the JAX package).
Nothing is compiled here. The two allocators may hand out rows in different
orders.
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


class PySlotAllocator:
    """Free-list of row indices; same API as lapha_native.SlotAllocator."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._free = list(range(self.capacity - 1, -1, -1))

    def acquire(self, n: int = 1):
        if len(self._free) < n:
            return None
        return [self._free.pop() for _ in range(n)]

    def release(self, slots):
        for s in slots:
            s = int(s)
            if not 0 <= s < self.capacity:
                raise ValueError("slot out of range")
            self._free.append(s)

    def available(self) -> int:
        return len(self._free)


def make_prefix_tree():
    mod = _native_module()
    return mod.PrefixTree() if mod is not None else PyPrefixTree()


def make_slot_allocator(capacity: int):
    mod = _native_module()
    return mod.SlotAllocator(capacity) if mod is not None else PySlotAllocator(capacity)
