"""Host-side prefix cache: hashed prompt blocks -> physical KV pool blocks.

The serving analogue of Flex-PE's reuse story (100% time-multiplexed
hardware, up to 62x/371x fewer DMA reads): requests sharing a system
prompt should neither recompute nor re-store the shared KV. Sharing works
at the paged pool's block granularity — a full block of prompt tokens is
content-addressed by a *chain* hash (its own tokens AND every token before
it, since causal KV at position p depends on the whole prefix), so a hit
on block i guarantees the cached KV bytes are exactly what a cold prefill
would write.

This structure is pure host bookkeeping: it never touches device arrays.
The engine owns the physical pool, the per-block refcounts, and the block
tables; the cache maps chain keys to block ids, keeps LRU order over its
entries, and evicts only blocks the engine says nothing holds.

Eviction is entry-at-a-time LRU. Evicting a parent block can strand its
descendants (matching always walks from the root, so a child without its
parent is unreachable — never *wrong*); stranded entries age out through
the same LRU order, so the waste is transient.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Callable, List, Optional

import numpy as np


class PrefixCache:
    """Chain-hashed block lookup with LRU eviction over cached entries.

    One entry = one full block of prompt tokens = one physical pool block.
    The cache holds a logical reference on every cached block (the engine
    must not return a cached block to its free list); `evict_lru` releases
    that reference for the least-recently-used entry whose block no slot
    holds.
    """

    def __init__(self, block_size: int):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.block_size = block_size
        # key -> block id, in LRU order (oldest first); touched on match
        self._entries: "OrderedDict[str, int]" = OrderedDict()
        self._block_key: dict = {}  # block id -> key (reverse map)
        # cumulative stats
        self.hits = 0  # blocks matched
        self.misses = 0  # chain walks that stopped short of a full match
        self.insertions = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def block_keys(self, prompt) -> List[str]:
        """Chain keys for every *full* block of `prompt` (partial tail
        blocks are never cached). Works for token vectors and embeds-mode
        float prompts alike — the key is a digest over the block's bytes
        plus its parent's key. Integer prompts are normalized to int64
        first, so the same token sequence shares whether it arrives as a
        Python list, an int32 device array, or an int64 numpy array."""
        arr = np.asarray(prompt)
        if arr.dtype.kind in "iu":
            arr = arr.astype(np.int64, copy=False)
        bs = self.block_size
        keys: List[str] = []
        parent = b""
        for i in range(len(arr) // bs):
            h = hashlib.sha1(parent)
            h.update(arr[i * bs:(i + 1) * bs].tobytes())
            parent = h.digest()
            keys.append(parent.hex())
        return keys

    def match(self, keys: List[str]) -> List[int]:
        """Longest cached prefix of `keys`: block ids for keys[0..m), where
        m is the first miss. Matched entries are touched (become MRU)."""
        blocks: List[int] = []
        for key in keys:
            blk = self._entries.get(key)
            if blk is None:
                break
            self._entries.move_to_end(key)
            blocks.append(blk)
        self.hits += len(blocks)
        if len(blocks) < len(keys):
            self.misses += 1
        return blocks

    def peek(self, keys: List[str]) -> int:
        """Length of the longest cached prefix of `keys` WITHOUT touching
        LRU order or hit/miss counters — a pure read. The router's
        prefix-affinity policy uses this to ask every replica "how much
        of this prompt do you already hold?" without the probe itself
        perturbing any replica's eviction order or stats."""
        depth = 0
        for key in keys:
            if key not in self._entries:
                break
            depth += 1
        return depth

    def insert(self, key: str, block: int) -> bool:
        """Register `block` as the physical home of chain key `key`.
        Returns False (and caches nothing) if the key is already present —
        the first writer wins and later identical prefills keep their
        private copy — or if the block already backs another entry."""
        if key in self._entries or block in self._block_key:
            return False
        self._entries[key] = block
        self._block_key[block] = key
        self.insertions += 1
        return True

    def holds(self, block: int) -> bool:
        """True if `block` backs a cache entry (the engine must keep it
        out of the free list even with zero slot holders)."""
        return block in self._block_key

    def blocks(self):
        """All physical blocks currently backing cache entries."""
        return self._block_key.keys()

    def evict_lru(self, evictable: Callable[[int], bool]) -> Optional[int]:
        """Drop the least-recently-used entry whose block passes
        `evictable` (the engine's "no slot holds it" test) and return the
        reclaimed block id, or None when nothing can be evicted."""
        for key, blk in self._entries.items():
            if evictable(blk):
                del self._entries[key]
                del self._block_key[blk]
                self.evictions += 1
                return blk
        return None

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "insertions": self.insertions,
            "evictions": self.evictions,
        }
