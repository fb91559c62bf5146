"""The port's paged-KV host allocator (``repro_torch.core.paged_kv``) against
the reference's (``repro.core.paged_kv``), op for op.

Both allocators take the same operations in the same order (admissions with
prefix matching, decode growth, copy-on-write, forks, releases, and an
adversarial storm of all of them, as ``tests/test_paged_kv.py`` drives the
reference); after every operation they must hold the same block tables,
refcounts, free list, LRU order, hash index (digests, parents, tokens),
counters and ``stats()``, raise the same ``PoolExhausted``, and pass
``check_invariants``. The geometry's arithmetic and messages match too.
"""
import numpy as np
import pytest

from repro.core import paged_kv as ref
from repro_torch.core import paged_kv as port


def _pair(n_blocks=8, max_slots=4, bt=4):
    mk = lambda m: m.PagedKVCache(  # noqa: E731
        m.PageGeometry(n_layers=1, n_kv=1, head_dim=4, code_bytes=1, page_bytes=2 * 4 * bt),
        n_blocks=n_blocks, max_slots=max_slots)
    return mk(ref), mk(port)


def _state(mgr) -> dict:
    return {"tables": [list(map(int, t)) for t in mgr.tables],
            "refcount": mgr.refcount.tolist(), "free": list(mgr.free),
            "lru": list(mgr.lru), "by_hash": dict(mgr.by_hash), "hash_of": dict(mgr.hash_of),
            "parent_of": dict(mgr.parent_of), "tokens_of": dict(mgr.tokens_of),
            "stats": mgr.stats(), "table": mgr.device_table(16).tolist()}


def _same(a, b, invariants: bool = True) -> None:
    assert _state(a) == _state(b)
    if invariants:   # a bare alloc() holds a block no table references
        a.check_invariants()
        b.check_invariants()


def _admit(mgr, slot, tokens):
    """The paged engine's prefill bookkeeping minus the device copies: match,
    claim, append fresh blocks, content-address the full fresh ones."""
    bt = mgr.geom.block_tokens
    match = mgr.match_prefix(tokens)
    mgr.claim_blocks(match.bids)
    mgr.begin_slot(slot, match.bids)
    if match.bids:
        mgr.hits += 1
        mgr.hit_tokens += match.n_tokens
    else:
        mgr.misses += 1
    digests = mgr.chunk_digests(tokens)
    parent = match.tail_digest
    pos = match.n_tokens
    while pos < len(tokens):
        n = min(bt, len(tokens) - pos)
        try:
            bid = mgr.append_block(slot)
        except Exception:
            mgr.release_slot(slot)
            raise
        if n == bt:
            digest, chunk = digests[pos // bt]
            mgr.register_full_block(bid, digest, parent, chunk)
            parent = digest
        pos += n
    return match.bids, match.n_tokens, match.tail_digest


def _register(mgr, bid, tokens):
    """Publish ``bid`` under the digest of ``tokens`` as a first block."""
    digest, chunk = mgr.chunk_digests(tokens)[0]
    mgr.register_full_block(bid, digest, ref.ROOT_DIGEST, chunk)


def _both(pair, fn, invariants: bool = True):
    """``fn`` on each allocator; the same result or the same exception."""
    out = []
    for mgr in pair:
        try:
            res = fn(mgr)
            out.append(("ok", res.tolist() if isinstance(res, np.ndarray) else res))
        except (ref.PoolExhausted, port.PoolExhausted, AssertionError, ValueError) as e:
            out.append(("raised", type(e).__name__, str(e)))
    assert out[0] == out[1], out
    _same(*pair, invariants)
    return out[0]


def test_root_digest_and_chain_match():
    assert port.ROOT_DIGEST == ref.ROOT_DIGEST
    for toks in ([1, 2, 3, 4], list(range(40)), [0] * 16):
        assert port._chain(port.ROOT_DIGEST, toks) == ref._chain(ref.ROOT_DIGEST, toks)
    a, b = _pair(bt=4)
    toks = list(range(19))
    assert a.chunk_digests(toks) == b.chunk_digests(toks)


@pytest.mark.parametrize("n_kv,head_dim,code_bytes,page_bytes", [
    (2, 16, 1, 2048), (2, 16, 2, 2048), (2, 16, 4, 2048), (8, 128, 1, 2048),
    (8, 128, 1, 32768), (8, 128, 2, 32768), (2, 32, 1, 512)])
def test_geometry_matches(n_kv, head_dim, code_bytes, page_bytes):
    kw = dict(n_layers=3, n_kv=n_kv, head_dim=head_dim, code_bytes=code_bytes,
              page_bytes=page_bytes)
    g, h = ref.PageGeometry(**kw), port.PageGeometry(**kw)
    assert g.block_tokens == h.block_tokens and g.describe() == h.describe()
    for n in (0, 1, 7, 16, 17, 1055, 4 * 1056):
        assert g.blocks_for(n) == h.blocks_for(n)
    assert g.pool_bytes(264) == h.pool_bytes(264)


def test_geometry_of_the_full_size_pages():
    """qwen2.5-14b's KV heads at p8: the default 2,048 B page is one token,
    32,768 B sixteen; 264 blocks of 16 hold the 4-slot grid's 4 x 1,056 rows."""
    g = port.PageGeometry(n_layers=48, n_kv=8, head_dim=128, code_bytes=1, page_bytes=2048)
    assert g.block_tokens == 1
    g = port.PageGeometry(n_layers=48, n_kv=8, head_dim=128, code_bytes=1, page_bytes=32768)
    assert g.block_tokens == 16 and g.blocks_for(4 * 1056) == 264
    assert g.pool_bytes(264) == 264 * 48 * 32768


@pytest.mark.parametrize("kw,match", [
    (dict(code_bytes=3), "code_bytes"),
    (dict(n_kv=64, head_dim=128, code_bytes=4, page_bytes=64), "holds no tokens")])
def test_geometry_validation_matches(kw, match):
    base = dict(n_layers=1, n_kv=2, head_dim=16, code_bytes=1)
    msgs = []
    for m in (ref, port):
        with pytest.raises(ValueError, match=match) as e:
            m.PageGeometry(**{**base, **kw})
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_scripted_admit_fork_cow_release():
    """The reference test file's scripted sequences, op for op."""
    pair = _pair(n_blocks=8, max_slots=3, bt=4)
    _both(pair, lambda m: _admit(m, 0, list(range(10))))
    _both(pair, lambda m: _admit(m, 1, list(range(4))))       # prefix hit
    _both(pair, lambda m: m.ensure_writable(1))                # published tail: COW
    _both(pair, lambda m: m.ensure_writable(1))                # private now
    _both(pair, lambda m: m.fork_slot(1, 2))
    _both(pair, lambda m: m.ensure_writable(2))
    _both(pair, lambda m: m.private_bids(2))
    _both(pair, lambda m: m.release_slot(0))                   # published blocks park in the LRU
    _both(pair, lambda m: m.match_prefix(list(range(8)) + [99]).bids)
    _both(pair, lambda m: m.begin_slot(1, []))                 # table not released: raises
    _both(pair, lambda m: m.device_table(2))                   # too narrow: raises
    for _ in range(6):
        _both(pair, lambda m: m.append_block(2))               # runs the pool dry
    _both(pair, lambda m: _register(m, m.tables[2][-1], [7] * 4))
    _both(pair, lambda m: m.register_full_block(m.tables[2][-1], "00", ref.ROOT_DIGEST, (7,)))


def test_lru_recycling_and_first_writer_wins():
    pair = _pair(n_blocks=2, max_slots=2, bt=4)
    _both(pair, lambda m: _admit(m, 0, list(range(8))))
    _both(pair, lambda m: m.release_slot(0))
    _both(pair, lambda m: m.alloc(), False)                    # recycles the LRU head
    _both(pair, lambda m: m.match_prefix(list(range(8))).n_tokens, False)
    _both(pair, lambda m: m.release(0))
    _both(pair, lambda m: m.release(0), False)                 # underflow: raises
    pair = _pair(bt=4)
    _both(pair, lambda m: _admit(m, 0, list(range(4))))
    _both(pair, lambda m: _admit(m, 1, list(range(4))))
    _both(pair, lambda m: m.append_block(1))
    _both(pair, lambda m: _register(m, m.tables[1][-1], list(range(4))))  # first writer kept


@pytest.mark.parametrize("seed,n_blocks,max_slots,bt,vocab", [
    (0, 12, 4, 4, 3), (1, 12, 4, 4, 3), (2, 6, 3, 2, 2), (3, 20, 6, 3, 4), (4, 9, 4, 1, 3)])
def test_adversarial_op_order_matches(seed, n_blocks, max_slots, bt, vocab):
    """A random admit / append / fork / COW / release storm on both
    allocators, as the reference's invariant test drives its own: the same
    state after every operation, every exception alike, and each pool
    emptied at the end."""
    rng = np.random.default_rng(seed)
    pair = _pair(n_blocks=n_blocks, max_slots=max_slots, bt=bt)
    live = set()
    for _ in range(400):
        op = int(rng.integers(0, 6))
        free = [s for s in range(max_slots) if s not in live]
        try:
            if op == 0 and free:                               # admit (tiny vocab: hits)
                toks = [int(t) for t in rng.integers(0, vocab, size=int(rng.integers(1, 10)))]
                res = _both(pair, lambda m: _admit(m, free[0], toks))
                if res[0] == "ok":
                    live.add(free[0])
                else:
                    raise port.PoolExhausted
            elif op == 1 and live:                             # decode growth
                s = int(rng.choice(sorted(live)))
                if _both(pair, lambda m: m.append_block(s))[0] != "ok":
                    raise port.PoolExhausted
            elif op == 2 and live:                             # COW before a tail write
                s = int(rng.choice(sorted(live)))
                if _both(pair, lambda m: m.ensure_writable(s))[0] != "ok":
                    raise port.PoolExhausted
            elif op == 3 and live and free:                    # fork into a free slot
                s = int(rng.choice(sorted(live)))
                _both(pair, lambda m: m.fork_slot(s, free[0]))
                live.add(free[0])
            elif op == 4 and live:                             # eviction
                s = int(rng.choice(sorted(live)))
                _both(pair, lambda m: m.release_slot(s))
                live.remove(s)
            elif op == 5:                                      # pure lookups
                toks = [int(t) for t in rng.integers(0, vocab, size=12)]
                _both(pair, lambda m: (m.match_prefix(toks).bids, m.available(),
                                       m.private_bids(0), m.seen_digests()))
        except port.PoolExhausted:
            if live:                                           # the engine evicts someone
                s = int(rng.choice(sorted(live)))
                _both(pair, lambda m: m.release_slot(s))
                live.remove(s)
    for s in sorted(live):
        _both(pair, lambda m: m.release_slot(s))
    assert int((pair[1].refcount > 0).sum()) == 0
