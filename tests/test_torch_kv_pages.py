"""The port's paged KV bookkeeping (``ops/kv_pages.py``: ``PagePool``,
``BlockTable``, ``PrefixCache``) against the JAX package's.

The reference's own cases (from ``tests/test_engine.py``) run on the port's
copy; the parity cases drive seeded random op sequences (alloc / share /
free / adopt / append / release / cache insert / lookup / evict) through
both packages and require the same page ids, errors, refcounts and stats
at every step.  Exact comparisons: this is host bookkeeping with no
floating point."""

import numpy as np
import pytest

from consensus_tpu.ops import kv_pages as jax_kv
from consensus_tpu_torch.ops import kv_pages as port_kv
from consensus_tpu_torch.ops.kv_pages import (
    BlockTable,
    PagePool,
    PagePoolExhausted,
    PrefixCache,
)


class TestPagePool:
    def test_alloc_free_roundtrip(self):
        pool = PagePool(8, page_size=4)
        pages = pool.alloc(3, owner="a")
        assert len(set(pages)) == 3
        assert pool.in_use == 3 and pool.free_count == 5
        pool.free(pages)
        assert pool.in_use == 0 and pool.free_count == 8

    def test_exhaustion_is_all_or_nothing(self):
        pool = PagePool(4, page_size=4)
        pool.alloc(3, owner="a")
        with pytest.raises(PagePoolExhausted):
            pool.alloc(2, owner="b")
        # The failed alloc must not have consumed the last free page.
        assert pool.free_count == 1
        pool.alloc(1, owner="b")

    def test_double_free_raises(self):
        pool = PagePool(4)
        pages = pool.alloc(2)
        pool.free(pages)
        with pytest.raises(ValueError, match="double free|not allocated"):
            pool.free(pages)

    def test_foreign_page_free_raises(self):
        pool = PagePool(4)
        with pytest.raises(ValueError):
            pool.free([99])

    def test_no_aliasing_under_churn(self):
        """Interleaved alloc/free never hands one page to two live owners."""
        pool = PagePool(16, page_size=4)
        live = {}
        for step in range(200):
            if step % 3 == 2 and live:
                victim = sorted(live)[step % len(live)]
                pool.free(live.pop(victim))
            else:
                n = 1 + step % 3
                if n <= pool.free_count:
                    live[step] = pool.alloc(n, owner=step)
            held = [p for pages in live.values() for p in pages]
            assert len(held) == len(set(held))  # no page in two hands
            assert pool.in_use == len(held)
        assert pool.stats().high_water <= pool.num_pages

    def test_pages_for_tokens_ceil(self):
        pool = PagePool(8, page_size=16)
        assert pool.pages_for_tokens(0) == 0
        assert pool.pages_for_tokens(1) == 1
        assert pool.pages_for_tokens(16) == 1
        assert pool.pages_for_tokens(17) == 2

    # -- refcounted sharing (prefix cache) ---------------------------------

    def test_shared_page_survives_first_free(self):
        """free() drops one reference; the page rejoins the free list only
        when the LAST holder lets go."""
        pool = PagePool(8, page_size=4)
        pages = pool.alloc(2, owner="slot")
        pool.share(pages)  # cache pins them
        assert all(pool.refcount(p) == 2 for p in pages)
        pool.free(pages)  # slot retires
        assert pool.in_use == 2 and pool.free_count == 6
        assert all(pool.refcount(p) == 1 for p in pages)
        pool.free(pages)  # cache evicts
        assert pool.in_use == 0 and pool.free_count == 8

    def test_double_free_of_shared_page_still_raises(self):
        """Sharing must not launder a double free: once every reference is
        gone, another free raises exactly like the unshared case."""
        pool = PagePool(4, page_size=4)
        pages = pool.alloc(1)
        pool.share(pages)
        pool.free(pages)
        pool.free(pages)
        with pytest.raises(ValueError, match="double free|not allocated"):
            pool.free(pages)

    def test_share_free_page_raises(self):
        pool = PagePool(4, page_size=4)
        pages = pool.alloc(1)
        pool.free(pages)
        with pytest.raises(ValueError, match="cannot share a free page"):
            pool.share(pages)
        with pytest.raises(ValueError):
            pool.share([99])

    def test_freed_while_refcounted_page_is_not_reallocated(self):
        """A page another holder still references must never come back out
        of alloc() — the aliasing bug refcounting exists to prevent."""
        pool = PagePool(4, page_size=4)
        shared = pool.alloc(2, owner="a")
        pool.share(shared)
        pool.free(shared)  # one reference remains
        grabbed = pool.alloc(2, owner="b")  # only the 2 never-shared pages
        assert not (set(grabbed) & set(shared))
        with pytest.raises(PagePoolExhausted):
            pool.alloc(1, owner="c")

    def test_no_aliasing_under_churn_with_sharing(self):
        """Mixed private/shared churn keeps the invariant: at every step a
        page is either free, or held by exactly its current reference
        holders — never handed out twice."""
        pool = PagePool(16, page_size=4)
        private = {}  # step -> pages (one ref)
        shared = {}  # step -> pages (two refs: "slot" + "cache")
        for step in range(300):
            action = step % 5
            if action == 0 and pool.free_count >= 2:
                private[step] = pool.alloc(2, owner=step)
            elif action == 1 and pool.free_count >= 1:
                pages = pool.alloc(1, owner=step)
                pool.share(pages)
                shared[step] = pages
            elif action == 2 and private:
                pool.free(private.pop(sorted(private)[0]))
            elif action == 3 and shared:
                # Drop ONE of the two references; entry stays live.
                key = sorted(shared)[0]
                pool.free(shared[key])
                private[key] = shared.pop(key)
            elif action == 4 and private:
                pool.free(private.pop(sorted(private)[-1]))
            held = [
                p for pages in list(private.values()) + list(shared.values())
                for p in pages
            ]
            assert len(held) == len(set(held))
            assert pool.in_use == len(held)
            for pages in shared.values():
                assert all(pool.refcount(p) == 2 for p in pages)
        for pages in private.values():
            pool.free(pages)
        for pages in shared.values():
            pool.free(pages)
            pool.free(pages)
        assert pool.in_use == 0 and pool.free_count == 16

    def test_adopt_shared_requires_alignment_and_empty_table(self):
        pool = PagePool(8, page_size=4)
        donor = BlockTable(0)
        donor.append_tokens(pool, 8)
        table = BlockTable(1)
        with pytest.raises(ValueError, match="page-aligned"):
            table.adopt_shared(pool, donor.pages, 7)
        table.adopt_shared(pool, donor.pages, 8)
        assert table.num_tokens == 8 and table.pages == donor.pages
        with pytest.raises(ValueError, match="empty block table"):
            table.adopt_shared(pool, donor.pages, 8)
        # The adopter's release leaves the donor's reference intact.
        table.release(pool)
        assert pool.in_use == 2
        donor.release(pool)
        assert pool.in_use == 0


class TestBlockTable:
    def test_append_allocates_on_page_boundaries_only(self):
        pool = PagePool(8, page_size=4)
        table = BlockTable(0)
        assert len(table.append_tokens(pool, 3)) == 1  # first page
        assert table.append_tokens(pool, 1) == []  # fills page 0
        assert len(table.append_tokens(pool, 5)) == 2  # crosses into 2 more
        assert table.num_tokens == 9 and len(table.pages) == 3

    def test_write_cursor_tracks_last_token(self):
        pool = PagePool(8, page_size=4)
        table = BlockTable(0)
        table.append_tokens(pool, 5)
        page, offset = table.write_cursor(pool)
        assert page == table.pages[1] and offset == 0

    def test_release_returns_everything(self):
        pool = PagePool(8, page_size=4)
        table = BlockTable(0)
        table.append_tokens(pool, 9)
        table.release(pool)
        assert pool.in_use == 0 and table.num_tokens == 0

    def test_as_array_pads_and_bounds(self):
        pool = PagePool(8, page_size=4)
        table = BlockTable(0)
        table.append_tokens(pool, 6)
        arr = table.as_array(4)
        assert arr.tolist()[:2] == table.pages and set(arr.tolist()[2:]) == {-1}
        with pytest.raises(ValueError, match="max_blocks"):
            table.as_array(1)




class TestPrefixCache:
    def _cache(self, num_pages=16, max_pages=8, identity=("m", "dense")):
        pool = PagePool(num_pages, page_size=4)
        return pool, PrefixCache(pool, max_pages, identity=identity)

    def test_miss_then_hit_roundtrip(self):
        pool, cache = self._cache()
        tokens = list(range(8))
        assert cache.lookup(tokens) == ([], 0)
        pages = pool.alloc(2, owner="slot")
        assert cache.insert(tokens, pages)
        got_pages, got_tokens = cache.lookup(tokens + [99, 98])
        assert got_pages == pages and got_tokens == 8
        # Three holders now: slot, cache, and the lookup's adopter.
        assert all(pool.refcount(p) == 3 for p in pages)
        stats = cache.stats()
        assert stats["hits"] == 1 and stats["misses"] == 1
        assert stats["tokens_saved"] == 8

    def test_lookup_returns_longest_prefix(self):
        pool, cache = self._cache()
        short, long_ = list(range(4)), list(range(8))
        p_short = pool.alloc(1, owner="a")
        p_long = pool.alloc(2, owner="b")
        assert cache.insert(short, p_short)
        assert cache.insert(long_, p_long)
        pages, n = cache.lookup(long_ + [42])
        assert (pages, n) == (p_long, 8)
        # A stream sharing only the first page matches the short entry.
        pages, n = cache.lookup(short + [77, 77, 77, 77])
        assert (pages, n) == (p_short, 4)

    def test_unaligned_or_oversized_insert_rejected(self):
        pool, cache = self._cache(max_pages=1)
        pages = pool.alloc(2, owner="a")
        assert not cache.insert(list(range(7)), pages)  # unaligned
        assert not cache.insert(list(range(8)), pages)  # over budget
        assert not cache.insert([], [])  # empty
        assert pool.refcount(pages[0]) == 1  # no stray references taken

    def test_identity_partitions_the_keyspace(self):
        """Same token stream, different (tier, quant) identity — never the
        same entry: two tiers' KV bytes must not alias."""
        pool = PagePool(16, page_size=4)
        a = PrefixCache(pool, 8, identity=("m", "dense"))
        b = PrefixCache(pool, 8, identity=("m", "int8"))
        tokens = list(range(8))
        pages = pool.alloc(2, owner="x")
        assert a.insert(tokens, pages)
        assert b.lookup(tokens) == ([], 0)
        assert a.lookup(tokens)[1] == 8

    def test_lru_eviction_frees_cache_reference_only(self):
        pool, cache = self._cache(max_pages=2)
        first = pool.alloc(2, owner="a")
        assert cache.insert(list(range(8)), first)
        pool.free(first)  # slot retires; cache holds the last reference
        second = pool.alloc(2, owner="b")
        assert cache.insert(list(range(100, 108)), second)  # evicts first
        assert cache.stats()["evictions"] == 1
        assert cache.stats()["pages"] == 2
        # The evicted entry's pages went back to the free list...
        assert pool.in_use == 2
        # ...and the survivor is still servable.
        assert cache.lookup(list(range(100, 108)))[1] == 8

    def test_eviction_spares_pages_adopted_by_live_slots(self):
        pool, cache = self._cache(max_pages=2)
        first = pool.alloc(2, owner="a")
        assert cache.insert(list(range(8)), first)
        pool.free(first)
        adopted, n = cache.lookup(list(range(8)))  # a live slot adopts
        assert n == 8
        second = pool.alloc(2, owner="b")
        assert cache.insert(list(range(100, 108)), second)  # evicts entry
        # The entry is gone but the adopter's reference keeps pages alive.
        assert cache.lookup(list(range(8)))[1] == 0
        assert all(pool.refcount(p) == 1 for p in adopted)
        pool.free(adopted)
        assert pool.in_use == 2  # only the second entry's pages remain


# ---------------------------------------------------------------------------
# Parity with the JAX package: seeded random op sequences
# ---------------------------------------------------------------------------


def _pool_trace(kv, seed):
    """200 random pool/table ops; one record per op."""
    rng = np.random.default_rng(seed)
    pool = kv.PagePool(24, page_size=4)
    tables = [kv.BlockTable(i) for i in range(4)]
    held = []  # extra references taken with share()
    trace = []
    for _ in range(200):
        op = rng.choice(["alloc", "append", "release", "share", "free", "adopt", "cursor"])
        try:
            if op == "alloc":
                out = pool.alloc(int(rng.integers(1, 6)), owner="x")
                held.append(list(out))
            elif op == "append":
                t = tables[int(rng.integers(4))]
                out = t.append_tokens(pool, int(rng.integers(1, 11)))
            elif op == "release":
                t = tables[int(rng.integers(4))]
                t.release(pool)
                out = None
            elif op == "share":
                live = [p for p in range(24) if pool.refcount(p) > 0]
                out = [int(p) for p in rng.choice(live, size=min(2, len(live)), replace=False)] if live else []
                pool.share(out)
                held.append(list(out))
            elif op == "free":
                if held:
                    out = held.pop(int(rng.integers(len(held))))
                    pool.free(out)
                else:
                    out = pool.free([int(rng.integers(24))])
            elif op == "adopt":
                t = tables[int(rng.integers(4))]
                pages = pool.alloc(2)
                held.append(list(pages))
                t.adopt_shared(pool, pages, 8)
                out = list(t.pages)
            else:
                t = tables[int(rng.integers(4))]
                out = (t.write_cursor(pool), t.as_array(8).tolist())
            trace.append((op, "ok", repr(out)))
        except Exception as exc:  # noqa: BLE001 - the error type is the record
            trace.append((op, type(exc).__name__, str(exc)))
        trace.append(("stats", repr(pool.stats()), pool.in_use, pool.free_count,
                      [pool.refcount(p) for p in range(24)]))
    return trace


@pytest.mark.parametrize("seed", range(6))
def test_pool_and_tables_random_ops_match_jax(seed):
    port = _pool_trace(port_kv, seed)
    ref = _pool_trace(jax_kv, seed)
    assert port == ref
    assert any(rec[1] == "ok" for rec in port if rec[0] != "stats")


def _cache_trace(kv, seed):
    rng = np.random.default_rng(100 + seed)
    pool = kv.PagePool(32, page_size=4)
    cache = kv.PrefixCache(pool, 10, identity=("tiny", "dense", ("tp", 1)))
    prompts = [list(rng.integers(0, 9, size=int(rng.integers(4, 25)))) for _ in range(8)]
    slots = []
    trace = []
    for _ in range(120):
        op = rng.choice(["admit", "retire", "lookup", "clear"], p=[0.45, 0.3, 0.2, 0.05])
        try:
            if op == "admit":
                tokens = prompts[int(rng.integers(len(prompts)))]
                pages, cached = cache.lookup(tokens)
                table = kv.BlockTable(len(slots))
                if cached:
                    table.adopt_shared(pool, pages, cached)
                table.append_tokens(pool, len(tokens) - cached)
                slots.append((tokens, table))
                out = (pages, cached, list(table.pages))
            elif op == "retire" and slots:
                tokens, table = slots.pop(int(rng.integers(len(slots))))
                n = len(tokens) // pool.page_size
                out = cache.insert(tokens[: n * pool.page_size], table.pages[:n]) if n else None
                table.release(pool)
            elif op == "lookup":
                out = cache.lookup(prompts[int(rng.integers(len(prompts)))])
            elif op == "clear":
                cache.clear()
                out = None
            else:
                out = None
            trace.append((op, "ok", repr(out)))
        except Exception as exc:  # noqa: BLE001
            trace.append((op, type(exc).__name__, str(exc)))
        trace.append(("stats", repr(cache.stats()), repr(pool.stats())))
    return trace


@pytest.mark.parametrize("seed", range(4))
def test_prefix_cache_random_ops_match_jax(seed):
    port = _cache_trace(port_kv, seed)
    assert port == _cache_trace(jax_kv, seed)
    assert any("hits" in rec[1] and "'hits': 0" not in rec[1] for rec in port if rec[0] == "stats")


def test_page_pool_exhausted_is_the_same_contract():
    for kv in (port_kv, jax_kv):
        pool = kv.PagePool(3, page_size=2)
        with pytest.raises(kv.PagePoolExhausted):
            pool.alloc(4)
        assert pool.in_use == 0
