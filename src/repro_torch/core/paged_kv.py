"""Paged posit KV cache: fixed-byte pages, block-hash prefix sharing, COW.

The port's copy of the reference's host allocator (src/repro/core/paged_kv.py),
numpy and hashlib only: the same operations give the same block tables,
digests, refcounts, LRU order and ``stats()``. The slot grid gives every slot
a dense ``S_max``-row KV strip; the paged layout replaces it with:

* **Fixed-byte pages.** A block (page) is ``page_bytes`` of K+V storage a
  layer, so its token capacity follows the code width: a p8 page holds 2x
  the tokens of a p16 page and 4x an f32 page of the same size.
* **Prefix sharing.** Full blocks written by prefill are content-addressed by
  a chained block hash over their token ids; a request whose prompt starts
  with a cached chain maps those blocks into its table and bumps refcounts.
* **Copy-on-write.** ``fork_slot`` aliases every block of a live request;
  the first write into a shared tail block gets a private copy
  (:meth:`PagedKVCache.ensure_writable`).
* **LRU reuse.** Hashed blocks that reach refcount 0 stay matchable in an
  LRU and are recycled only when the free list runs dry.

The device pools and the row writes live in ``models.transformer.
decode_step_paged`` and ``launch.paged_engine``. The reference's
``snapshot_meta``/``restore_meta`` are not ported yet (the port's engine has
no snapshot).
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

__all__ = ["PageGeometry", "PagedKVCache", "PoolExhausted", "PrefixMatch",
           "ROOT_DIGEST"]

#: Chain digest of the empty token prefix (the hash-chain anchor).
ROOT_DIGEST = hashlib.blake2b(b"repro/paged-kv/root", digest_size=16).hexdigest()


class PoolExhausted(RuntimeError):
    """No free block and no evictable (refcount-0) cached block left."""


def _chain(parent_digest: str, tokens) -> str:
    """Chained block hash: digest of (parent chain, this block's token ids).

    Content addressing must cover the *whole prefix*, not just the block's
    own tokens — KV codes at a position depend on every earlier token
    (causal attention), so two blocks holding the same 16 tokens after
    different prefixes hold different codes.
    """
    h = hashlib.blake2b(bytes.fromhex(parent_digest), digest_size=16)
    h.update(np.asarray(tokens, np.int32).tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class PageGeometry:
    """Byte-budgeted page layout for one KV cache.

    ``page_bytes`` is the per-layer K+V byte budget of one block; the token
    capacity ``block_tokens`` follows from the code width:

        block_tokens = page_bytes // (2 * n_kv * head_dim * code_bytes)

    so at a fixed page size, p8 codes (1 B) give 2x the tokens of p16 (2 B)
    and 4x of f32 (4 B) — the kv_bits-aware layout the paged capacity claim
    rests on.
    """

    n_layers: int
    n_kv: int
    head_dim: int
    code_bytes: int          # 1 = p8, 2 = p16/bf16, 4 = f32
    page_bytes: int = 16384

    def __post_init__(self):
        if self.code_bytes not in (1, 2, 4):
            raise ValueError(f"code_bytes must be 1|2|4, got {self.code_bytes}")
        if self.block_tokens < 1:
            raise ValueError(
                f"page_bytes {self.page_bytes} holds no tokens at "
                f"2*{self.n_kv}*{self.head_dim}*{self.code_bytes} B/token")

    @property
    def block_tokens(self) -> int:
        return self.page_bytes // (2 * self.n_kv * self.head_dim
                                   * self.code_bytes)

    def pool_bytes(self, n_blocks: int) -> int:
        """Device bytes of an ``n_blocks`` K+V pool (all layers)."""
        return (n_blocks * self.n_layers * 2 * self.n_kv * self.head_dim
                * self.block_tokens * self.code_bytes)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_tokens)

    def describe(self) -> str:
        """Config fingerprint line (the reference's snapshot check compares
        it: a snapshot taken under one page geometry never restores into
        another)."""
        return (f"paged(bt={self.block_tokens},L={self.n_layers},"
                f"kv={self.n_kv}x{self.head_dim},code_B={self.code_bytes},"
                f"page_B={self.page_bytes})")


@dataclasses.dataclass
class PrefixMatch:
    """Result of :meth:`PagedKVCache.match_prefix`."""

    bids: List[int]          # cached full blocks covering the prompt head
    n_tokens: int            # tokens covered (len(bids) * block_tokens)
    tail_digest: str         # chain digest after the matched blocks


class PagedKVCache:
    """Host-side allocator for one block pool (refcounts, hashes, tables).

    Block ids index the device pools ``(L, n_blocks, Hkv, bt, hd)``; the
    sentinel id ``n_blocks`` marks empty table entries (out of bounds on the
    device: the paged attention kernel drops a write through one and reads
    its rows as zeros).
    """

    def __init__(self, geom: PageGeometry, *, n_blocks: int, max_slots: int):
        if n_blocks < 1:
            raise ValueError(f"need at least one block, got {n_blocks}")
        self.geom = geom
        self.n_blocks = n_blocks
        self.max_slots = max_slots
        self.sentinel = n_blocks
        self.refcount = np.zeros((n_blocks,), np.int32)
        self.free: List[int] = list(range(n_blocks - 1, -1, -1))
        self.lru: "OrderedDict[int, None]" = OrderedDict()  # refcount-0, hashed
        self.tables: List[List[int]] = [[] for _ in range(max_slots)]
        # content addressing (hashed = immutable full prefill blocks only)
        self.by_hash: Dict[str, int] = {}
        self.hash_of: Dict[int, str] = {}
        self.parent_of: Dict[int, str] = {}
        self.tokens_of: Dict[int, Tuple[int, ...]] = {}
        # counters for the engine's metrics feed
        self.hits = 0            # admissions that reused >= 1 block
        self.hit_tokens = 0      # prompt tokens served from cache
        self.misses = 0
        self.cow_copies = 0

    # ------------------------------------------------------------- hashing --
    def chunk_digests(self, tokens) -> List[Tuple[str, Tuple[int, ...]]]:
        """(chain digest, chunk tokens) for every FULL block of ``tokens``."""
        bt = self.geom.block_tokens
        toks = [int(t) for t in tokens]
        out, parent = [], ROOT_DIGEST
        for i in range(len(toks) // bt):
            chunk = tuple(toks[i * bt:(i + 1) * bt])
            parent = _chain(parent, chunk)
            out.append((parent, chunk))
        return out

    def match_prefix(self, tokens) -> PrefixMatch:
        """Longest cached chain of full blocks covering the prompt head.

        Pure lookup — no refcounts move until :meth:`claim_blocks` (so a
        caller that cannot admit after all leaves the pool untouched).
        """
        bids: List[int] = []
        parent = ROOT_DIGEST
        for digest, _chunk in self.chunk_digests(tokens):
            bid = self.by_hash.get(digest)
            if bid is None:
                break
            bids.append(bid)
            parent = digest
        return PrefixMatch(bids=bids,
                           n_tokens=len(bids) * self.geom.block_tokens,
                           tail_digest=parent)

    # ---------------------------------------------------------- allocation --
    def available(self) -> int:
        """Blocks allocatable right now (free + evictable cached)."""
        return len(self.free) + len(self.lru)

    def alloc(self) -> int:
        """One writable block: free list first, then the LRU cached block
        (its hash entries are unregistered — the prefix it cached is gone)."""
        if self.free:
            bid = self.free.pop()
        elif self.lru:
            bid, _ = self.lru.popitem(last=False)       # least recently used
            self._unregister(bid)
        else:
            raise PoolExhausted(
                f"pool of {self.n_blocks} blocks exhausted "
                f"({int((self.refcount > 0).sum())} live)")
        self.refcount[bid] = 1
        return bid

    def claim_blocks(self, bids: List[int]) -> None:
        """Take a reference on cached blocks (prefix hit): refcount-0 blocks
        leave the LRU, everything else just bumps."""
        for bid in bids:
            if self.refcount[bid] == 0:
                self.lru.pop(bid, None)
            self.refcount[bid] += 1

    def _unregister(self, bid: int) -> None:
        digest = self.hash_of.pop(bid, None)
        if digest is not None and self.by_hash.get(digest) == bid:
            del self.by_hash[digest]
        self.parent_of.pop(bid, None)
        self.tokens_of.pop(bid, None)

    def release(self, bid: int) -> None:
        self.refcount[bid] -= 1
        if self.refcount[bid] < 0:
            raise AssertionError(f"block {bid} refcount underflow")
        if self.refcount[bid] == 0:
            if bid in self.hash_of:
                self.lru[bid] = None        # retained: future prefix hits
                self.lru.move_to_end(bid)
            else:
                self.free.append(bid)

    # ------------------------------------------------------- content index --
    def register_full_block(self, bid: int, digest: str, parent: str,
                            tokens: Tuple[int, ...]) -> None:
        """Publish a full prefill-written block for prefix reuse.

        First writer wins: if ``digest`` is already registered (two
        identical prompts admitted back to back), the newcomer stays
        private rather than stealing the address — both spellings decode
        identically, the duplicate just isn't shared onward.
        """
        if len(tokens) != self.geom.block_tokens:
            raise ValueError(
                f"only full blocks are content-addressed "
                f"({len(tokens)} != {self.geom.block_tokens} tokens)")
        if digest in self.by_hash:
            return
        self.by_hash[digest] = bid
        self.hash_of[bid] = digest
        self.parent_of[bid] = parent
        self.tokens_of[bid] = tuple(int(t) for t in tokens)

    # --------------------------------------------------------- slot tables --
    def begin_slot(self, slot: int, bids: List[int]) -> None:
        if self.tables[slot]:
            raise AssertionError(f"slot {slot} table not released")
        self.tables[slot] = list(bids)

    def append_block(self, slot: int) -> int:
        bid = self.alloc()
        self.tables[slot].append(bid)
        return bid

    def release_slot(self, slot: int) -> List[int]:
        """Drop the slot's references; returns the released block ids."""
        bids, self.tables[slot] = self.tables[slot], []
        for bid in bids:
            self.release(bid)
        return bids

    def fork_slot(self, src: int, dst: int) -> None:
        """Alias every block of ``src`` into ``dst`` (COW fork: refcounts
        bump, nothing is copied until one side writes)."""
        if self.tables[dst]:
            raise AssertionError(f"fork target slot {dst} not free")
        self.tables[dst] = list(self.tables[src])
        self.claim_blocks(self.tables[dst])

    def ensure_writable(self, slot: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write guard before appending into the slot's tail block.

        Shared tail (refcount > 1, or content-addressed — published blocks
        are immutable even at refcount 1, a future prefix hit must see the
        bytes the hash promised) -> allocate a private block, swap it into
        the table, drop one reference on the original, and return
        ``(src, dst)`` so the caller can issue the device copy.  Returns
        None when the tail is already private.
        """
        if not self.tables[slot]:
            return None
        src = self.tables[slot][-1]
        if self.refcount[src] <= 1 and src not in self.hash_of:
            return None
        dst = self.alloc()
        self.tables[slot][-1] = dst
        self.release(src)
        self.cow_copies += 1
        return src, dst

    def private_bids(self, slot: int) -> List[int]:
        """The slot's exclusively-owned, unpublished blocks (safe to scrub:
        zeroing them cannot corrupt another slot or a cached prefix)."""
        return [b for b in self.tables[slot]
                if self.refcount[b] == 1 and b not in self.hash_of]

    def device_table(self, width: int) -> np.ndarray:
        """(max_slots, width) int32 block table, sentinel-padded."""
        out = np.full((self.max_slots, width), self.sentinel, np.int32)
        for s, tab in enumerate(self.tables):
            if len(tab) > width:
                raise AssertionError(
                    f"slot {s} holds {len(tab)} blocks > table width {width}")
            out[s, :len(tab)] = tab
        return out

    # ----------------------------------------------------------- integrity --
    def stats(self) -> dict:
        live = int((self.refcount > 0).sum())
        return {"blocks": self.n_blocks, "live": live,
                "free": len(self.free), "cached": len(self.lru),
                "hits": self.hits, "misses": self.misses,
                "hit_tokens": self.hit_tokens, "cow_copies": self.cow_copies,
                "block_tokens": self.geom.block_tokens}

    def check_invariants(self) -> None:
        """Every block is in exactly one of {free, lru, live}; refcounts
        equal table references; hash index is bijective."""
        refs = np.zeros((self.n_blocks,), np.int32)
        for tab in self.tables:
            for bid in tab:
                refs[bid] += 1
        if not np.array_equal(refs, self.refcount):
            bad = np.nonzero(refs != self.refcount)[0][:8]
            raise AssertionError(
                f"refcount mismatch at blocks {bad.tolist()}: "
                f"tables say {refs[bad].tolist()}, "
                f"counts say {self.refcount[bad].tolist()}")
        free_set, lru_set = set(self.free), set(self.lru)
        if len(free_set) != len(self.free):
            raise AssertionError("duplicate block on the free list")
        if free_set & lru_set:
            raise AssertionError(f"blocks both free and cached: "
                                 f"{sorted(free_set & lru_set)[:8]}")
        live_set = set(np.nonzero(self.refcount > 0)[0].tolist())
        if live_set & (free_set | lru_set):
            raise AssertionError("live block on a reuse list")
        union = free_set | lru_set | live_set
        if union != set(range(self.n_blocks)):
            raise AssertionError(
                f"leaked blocks: {sorted(set(range(self.n_blocks)) - union)[:8]}")
        for bid in lru_set:
            if bid not in self.hash_of:
                raise AssertionError(f"unhashed block {bid} in LRU")
        for digest, bid in self.by_hash.items():
            if self.hash_of.get(bid) != digest:
                raise AssertionError(f"hash index out of sync at block {bid}")

    # convenience used by tests
    def seen_digests(self) -> Set[str]:
        return set(self.by_hash)
