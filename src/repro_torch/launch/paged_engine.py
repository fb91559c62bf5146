"""Paged continuous-batching engine: prefix-sharing posit KV over block pools.

The port of the reference's ``launch/paged_engine.py``. ``ContinuousBatching
Engine`` gives every slot a dense ``S_max`` KV strip; this subclass swaps the
strips for fixed-byte pages (``core.paged_kv``):

* the device cache is one block pool a layer ``(L, N, Hkv, bt, hd)`` and a
  block table ``(max_slots, W)`` shared by every layer; the decode-attention
  kernel reads the table itself (``kernels.posit_attention.ops.
  decode_attention_append_paged``) and writes each row's new K/V at
  ``table[b, lens[b] // bt]``, offset ``lens[b] % bt``;
* admission content-addresses every *full* prefill block by a chained blake2b
  over its token prefix: a request whose prompt starts with a cached chain
  claims those blocks (refcount + 1) instead of storing them again. Prefill
  always runs in full, so the shared bytes are the bytes a cold prefill would
  write: a warm admission decodes token for token like a cold one;
* :meth:`fork` clones a live request block for block; the first divergent
  write goes through copy-on-write in :meth:`_prepare_decode`;
* decode-written blocks are never hashed or shared (the decode path writes
  codes rounded from its own activations, not the codes a prefill of the
  same tokens writes).

Pages are budgeted in bytes, so p8 codes hold twice the tokens of p16 at one
page size. At qwen2.5-14b's full width (8 KV heads of 128) the reference's
default ``page_bytes`` of 2,048 is one token a page at p8; 32,768 is 16.

The decode step is captured in a CUDA graph as the slot grid's is, so
everything the graph reads is written in place between replays: the table
(``_push_table``), the pools (``_copy_span``, ``_copy_block``,
``_poison_block``) and the lengths. The reference's metrics gauges and its
``snapshot``/``restore`` are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.paged_kv import PagedKVCache, PageGeometry, PoolExhausted
from repro_torch.launch.engine import (ContinuousBatchingEngine, Request, _nar_code,
                                       require_prefill)
from repro_torch.models.transformer import attn_cfg, no_paged_path

__all__ = ["PagedContinuousBatchingEngine"]


def _copy_span(pool: torch.Tensor, one: torch.Tensor, bid: int, start: int, n: int) -> None:
    """Copy ``n`` KV rows from position ``start`` of a B=1 prefill cache
    ``one`` (L, 1, Hkv, S, hd) into block ``bid`` of ``pool``
    (L, N, Hkv, bt, hd), in place."""
    pool[:, bid, :, :n].copy_(one[:, 0, :, start:start + n])


def _copy_block(pool: torch.Tensor, src: int, dst: int) -> None:
    """Copy-on-write: clone block ``src`` into ``dst`` (all layers), in place."""
    pool[:, dst].copy_(pool[:, src])


def _poison_block(pool: torch.Tensor, bid: int, code, n: int) -> None:
    """Overwrite the first ``n`` rows of block ``bid`` with ``code``, in place."""
    pool[:, bid, :, :n].fill_(code)


class PagedContinuousBatchingEngine(ContinuousBatchingEngine):
    """The slot-grid engine with paged prefix-sharing KV storage.

    Same client surface and drivers as the grid. Extra knobs: ``page_bytes``
    (a layer's K+V bytes of one block) and ``n_blocks`` (the pool's size;
    default: the slot grid's byte budget, ``max_slots * S_max`` token rows).
    """

    def __init__(self, model, params, policy, *, max_slots: int, S_max: int,
                 page_bytes: int = 2048, n_blocks: Optional[int] = None, **kw):
        require_prefill(model)
        if model.decode_step_paged is None or model.init_paged_cache is None:
            raise ValueError(no_paged_path(model.cfg.family))
        fmt = policy.kv_cache
        code_bytes = (1 if fmt is not None and fmt.nbits == 8 else
                      2 if fmt is not None or policy.compute_dtype != "f32" else 4)
        acfg = attn_cfg(model.cfg)
        self.geom = PageGeometry(n_layers=model.cfg.n_layers, n_kv=acfg.n_kv,
                                 head_dim=acfg.head_dim, code_bytes=code_bytes,
                                 page_bytes=page_bytes)
        bt = self.geom.block_tokens
        # pad up: every slot must be able to hold S_max tokens exactly
        S_max = -(-S_max // bt) * bt
        self.table_width = S_max // bt
        self.n_blocks = (n_blocks if n_blocks is not None
                         else self.geom.blocks_for(max_slots * S_max))
        self.manager: Optional[PagedKVCache] = None   # built in _init_state
        super().__init__(model, params, policy, max_slots=max_slots, S_max=S_max, **kw)

    # ------------------------------------------------------------ state ------
    def _init_state(self, seed: int) -> None:
        """A fresh allocator; the base zeroes the pools (and the table, which
        is put back to all sentinels)."""
        self.manager = PagedKVCache(self.geom, n_blocks=self.n_blocks,
                                    max_slots=self.max_slots)
        super()._init_state(seed)
        self._table_dirty = True
        self._push_table()

    def _build_executables(self, policy) -> None:
        """The paged decode step, captured on a CUDA model. Prefill stays the
        slot grid's eager B=1 prefill, whose spans ``_prefill_into_slot``
        copies into pages. The capture's warm-up writes each live row's next
        position (past every holder's length; the step rewrites it)."""
        model = self.model
        c = self.cache
        self._bind_decode(lambda p, t, cache: model.decode_step_paged(p, t, cache, policy),
                          (c["lens"], c["pos"]))

    def _init_cache(self) -> dict:
        return self.model.init_paged_cache(self.max_slots, self.n_blocks,
                                           self.geom.block_tokens, self.table_width,
                                           self.policy)

    # ------------------------------------------------------------ admission --
    def _outstanding_growth(self) -> int:
        """Blocks the pool still owes admitted slots: each active request
        grows to ``lens + remaining`` rows (every decode step writes one
        token before sampling the next; the final sampled token is evicted
        unwritten), and the blocks beyond its table must stay claimable, or
        decode later dies on ``PoolExhausted`` mid-stream."""
        owed = 0
        for slot in range(self.max_slots):
            req = self.slot_req[slot]
            if not self.active[slot] or req is None:
                continue
            remaining = max(req.max_new_tokens - len(self.slot_tokens[slot]), 0)
            final_len = min(int(self.lens[slot]) + remaining, self.S_max)
            owed += max(0, self.geom.blocks_for(final_len) - len(self.manager.tables[slot]))
        return owed

    def _can_admit(self, req: Request) -> bool:
        """Block-budget gate: admit only when the pool can take the request's
        whole lifetime (prompt plus every token it may write) on top of the
        growth owed to admitted slots, so an admitted stream never ends
        ``cache_full``; queueing is the backpressure. Matched prefix blocks
        still held by a live slot cost nothing; matched blocks parked in the
        LRU cost like fresh ones. Copy-on-write copies (forks only) are not
        reserved."""
        match = self.manager.match_prefix(req.prompt)
        matched_live = sum(1 for b in match.bids if self.manager.refcount[b] > 0)
        need = self.geom.blocks_for(req.prompt_len + req.max_new_tokens - 1) - matched_live
        return need + self._outstanding_growth() <= self.manager.available()

    def _prefill_into_slot(self, req: Request, slot: int):
        """Prefix-matched admission: the full B=1 prefill (matched blocks hold
        exactly the bytes it writes), matched full blocks claimed by
        reference, the rest copied into fresh blocks, and fresh full blocks
        content-addressed for the next request."""
        mgr, bt = self.manager, self.geom.block_tokens
        match = mgr.match_prefix(req.prompt)
        tokens = torch.as_tensor(req.prompt, dtype=torch.int32, device=self.device)[None]
        logits, one = self.model.prefill(self.params, tokens, self.policy, S_max=self.S_max)
        row_len = int(one["lens"][0])
        mgr.claim_blocks(match.bids)
        mgr.begin_slot(slot, match.bids)
        if match.bids:
            mgr.hits += 1
            mgr.hit_tokens += match.n_tokens
        else:
            mgr.misses += 1
        digests = mgr.chunk_digests(req.prompt)
        parent = match.tail_digest
        kv, one_kv = self.cache["kv"], one["kv"]
        pos = match.n_tokens
        while pos < row_len:
            n = min(bt, row_len - pos)
            try:
                bid = mgr.append_block(slot)
            except PoolExhausted:
                mgr.release_slot(slot)   # unwind; the caller retries later
                raise
            for name in ("k", "v"):
                _copy_span(kv[name], one_kv[name], bid, pos, n)
            if n == bt:
                digest, chunk = digests[pos // bt]
                mgr.register_full_block(bid, digest, parent, chunk)
                parent = digest
            pos += n
        self._table_dirty = True
        self._push_table()
        return logits, row_len

    # --------------------------------------------------------------- decode ---
    def _prepare_decode(self, now: float) -> None:
        """Before the step: every active slot is about to write one token at
        ``table[slot, lens // bt]``, offset ``lens % bt``; make that target a
        private, existing block (a fresh block at a block boundary, a
        copy-on-write of a shared or published tail). Pool exhaustion evicts
        the slot as ``cache_full``: its pages come back to the pool."""
        mgr, bt = self.manager, self.geom.block_tokens
        kv = self.cache["kv"]
        for slot in range(self.max_slots):
            if not self.active[slot]:
                continue
            try:
                if len(mgr.tables[slot]) * bt <= int(self.lens[slot]):
                    mgr.append_block(slot)
                    self._table_dirty = True
                else:
                    cow = mgr.ensure_writable(slot)
                    if cow is not None:
                        for name in ("k", "v"):
                            _copy_block(kv[name], *cow)
                        self._table_dirty = True
            except PoolExhausted:
                self._evict(slot, now, "cache_full")
        self._push_table()

    def _push_table(self) -> None:
        """The allocator's tables into the device table, in place (the
        captured step reads its address)."""
        if self._table_dirty:
            self.cache["table"].copy_(
                torch.from_numpy(self.manager.device_table(self.table_width)))
            self._table_dirty = False

    # ------------------------------------------------------------- eviction ---
    def _release_slot(self, slot: int) -> None:
        self.manager.release_slot(slot)
        self._table_dirty = True
        self._push_table()

    def _quarantine(self, slot: int, now: float) -> None:
        """Evict a nonfinite-logit slot and zero its *private* blocks (code 0
        is exact 0.0). Shared blocks are only released: another slot's live
        prefix must not be scrubbed from under it."""
        private = self.manager.private_bids(slot)
        self._evict(slot, now, "numerics")      # releases the references
        kv = self.cache["kv"]
        for bid in private:
            for name in ("k", "v"):
                _poison_block(kv[name], bid, 0, self.geom.block_tokens)

    def inject_nar_into(self, slot: int, count: int) -> None:
        """Chaos hook: poison the slot's *tail* block only. Head blocks may be
        shared with healthy requests, so the tail is made private
        (copy-on-write) first and the fault stays in the slot it targets."""
        mgr, bt = self.manager, self.geom.block_tokens
        if not mgr.tables[slot]:
            return
        kv = self.cache["kv"]
        cow = mgr.ensure_writable(slot)
        if cow is not None:
            for name in ("k", "v"):
                _copy_block(kv[name], *cow)
            self._table_dirty = True
        bid = mgr.tables[slot][-1]
        occupied = int(self.lens[slot]) - (len(mgr.tables[slot]) - 1) * bt
        n = max(1, min(count, max(occupied, 1), bt))
        for name in ("k", "v"):
            _poison_block(kv[name], bid, _nar_code(kv[name]), n)
        self._push_table()

    # ----------------------------------------------------------------- fork ---
    def fork(self, rid: int, new_rid: int) -> int:
        """Clone a live request into a free slot, sharing every block
        (parallel sampling). The clone starts at the same position with the
        same emitted tokens; the first write on either side goes through
        copy-on-write in :meth:`_prepare_decode`. Returns ``new_rid``."""
        src = next((s for s in range(self.max_slots)
                    if self.active[s] and self.slot_req[s] is not None
                    and self.slot_req[s].rid == rid), None)
        if src is None:
            raise ValueError(f"fork: rid {rid} is not in flight")
        free = self.free_slots()
        if not free:
            raise PoolExhausted("fork: no free slot")
        dst = free[0]
        self.manager.fork_slot(src, dst)
        self.lens[dst] = self.lens[src]
        self.last_token[dst] = self.last_token[src]
        self.active[dst] = True
        self.slot_req[dst] = dataclasses.replace(self.slot_req[src], rid=new_rid)
        self.slot_tokens[dst] = list(self.slot_tokens[src])
        self.slot_token_times[dst] = list(self.slot_token_times[src])
        self.slot_admitted[dst] = self.slot_admitted[src]
        self._sync_lens()
        self._table_dirty = True
        self._push_table()
        return new_rid

    # ------------------------------------------------------------- accounting --
    def prefix_stats(self) -> dict:
        """Pool and sharing counters (``PagedKVCache.stats``)."""
        return self.manager.stats()
