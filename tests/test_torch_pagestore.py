"""The port's fleet page store (``serve/pagestore.py``: PageStore,
PageStoreClient, chunked resumable shipping, integrity, leases, the disk
spill) against the JAX package's.

Tolerance: exact throughout.  The chained content keys of the port's
``PrefixCache`` under ``TorchBackend.kv_cache_identity()`` equal the JAX
keys under ``TPUBackend.kv_cache_identity()`` for the same tokens (random
token rows made from a seed with numpy); a run blob published by the JAX
store is admitted by the port's and back, also across a transport where
one package's client ships to the other package's store; a flipped bit
raises ``PageIntegrityError``; an expired lease aborts a fetch mid-transfer
in both packages alike; a spilled run is re-indexed from disk by a new
store of the other package."""

import numpy as np
import pytest

from consensus_tpu.obs.metrics import Registry as JaxRegistry
from consensus_tpu.ops import kv_pages as jax_kv
from consensus_tpu.serve import pagestore as jax_ps
from consensus_tpu_torch.obs.metrics import Registry
from consensus_tpu_torch.ops import kv_pages
from consensus_tpu_torch.serve import pagestore
from consensus_tpu_torch.serve.transport import LoopbackTransport

IDENTITY = ("tiny-llama3", "dense", ("tp", 1))


class _OneCacheEngine:
    def __init__(self, cache):
        self.prefix_caches = [cache]
        self.inner = None


def _donor(kv, tokens, identity=IDENTITY, page_size=4):
    pool = kv.PagePool(num_pages=64, page_size=page_size)
    cache = kv.PrefixCache(pool, max_pages=64, identity=identity)
    pages = pool.alloc(len(tokens) // page_size)
    assert cache.insert(tuple(tokens), pages)
    pool.free(pages)
    return cache


def _joiner(kv, identity=IDENTITY, page_size=4):
    return kv.PrefixCache(kv.PagePool(num_pages=64, page_size=page_size),
                          max_pages=64, identity=identity)


def _tokens(seed, n=16):
    return tuple(int(t) for t in np.random.RandomState(seed).randint(1, 128256, size=n))


def test_backend_identities_and_content_keys_equal_jax():
    import jax

    from consensus_tpu.backends.tpu import TPUBackend
    from consensus_tpu_torch.backends.torch_backend import TorchBackend
    from consensus_tpu_torch.models.convert import params_from_jax

    kw = dict(model="tiny-llama3", dtype="float32", max_context=64, base_seed=1)
    ref = TPUBackend(**kw)
    port = TorchBackend(params=params_from_jax(jax.tree.map(np.asarray, ref.params), ref.config),
                        device="cpu", **kw)
    assert port.kv_cache_identity() == ref.kv_cache_identity()
    for seed in range(4):
        tokens = _tokens(seed, n=4 * (seed + 2))
        got = _joiner(kv_pages, port.kv_cache_identity())._chain_keys(tokens)
        want = _joiner(jax_kv, ref.kv_cache_identity())._chain_keys(tokens)
        assert got == want and len(got) == seed + 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blob_published_by_either_store_is_admitted_by_the_other(seed):
    tokens = _tokens(seed)
    port_store = pagestore.PageStore(registry=Registry(), chunk_bytes=16)
    jax_store = jax_ps.PageStore(registry=JaxRegistry(), chunk_bytes=16)
    assert port_store.capture_cache(_donor(kv_pages, tokens)) == 1
    assert jax_store.capture_cache(_donor(jax_kv, tokens)) == 1
    port_runs, jax_runs = port_store.runs(), jax_store.runs()
    assert port_runs == jax_runs
    for src, dst in ((jax_store, pagestore.PageStore(registry=Registry())),
                     (port_store, jax_ps.PageStore(registry=JaxRegistry()))):
        ((identity, key),) = list(src._runs)
        blob = (pagestore if isinstance(src, pagestore.PageStore) else jax_ps)._serialize_run(
            src._runs[(identity, key)])
        dst.admit_blob(blob, jax_ps._content_hash(blob))
        assert dst.runs() == src.runs()
    assert pagestore._content_hash(b"x") == jax_ps._content_hash(b"x")


def test_port_client_ships_to_a_jax_store_and_a_jax_client_seeds_the_port():
    tokens = _tokens(5)
    hub = LoopbackTransport()
    jax_store = jax_ps.PageStore(registry=JaxRegistry(), transport=hub, chunk_bytes=8)
    port_client = pagestore.PageStoreClient(hub, "r0", registry=Registry(), chunk_bytes=8)
    assert port_client.capture_cache(_donor(kv_pages, tokens)) == 1
    joiner = _joiner(kv_pages)
    assert jax_store.client("r1").seed_engine(_OneCacheEngine(joiner)) == 1
    found, n_tokens = joiner.lookup(tokens)
    assert n_tokens == len(tokens) and len(found) == len(tokens) // 4


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_flipped_bit_raises_page_integrity_error(seed):
    rng = np.random.RandomState(seed)
    jax_store = jax_ps.PageStore(registry=JaxRegistry())
    jax_store.capture_cache(_donor(jax_kv, _tokens(seed)))
    ((run_key, run),) = list(jax_store._runs.items())
    blob = jax_ps._serialize_run(run)
    blob_hash = jax_ps._content_hash(blob)
    pos = int(rng.randint(len(blob) * 8))
    flipped = bytearray(blob)
    flipped[pos // 8] ^= 1 << (pos % 8)
    registry = Registry()
    store = pagestore.PageStore(registry=registry)
    with pytest.raises(pagestore.PageIntegrityError):
        store.admit_blob(bytes(flipped), blob_hash)
    with pytest.raises(pagestore.PageIntegrityError):
        store.admit_blob(blob[:-3], blob_hash)
    assert len(store) == 0
    assert "pagestore_integrity_rejects_total 2" in registry.to_prometheus()
    store.admit_blob(blob, blob_hash)
    assert len(store) == 1


def _lease_trace(ps, kv, registry):
    now = [0.0]
    store = ps.PageStore(registry=registry, lease_s=5.0, clock=lambda: now[0], chunk_bytes=8)
    assert store.capture_cache(_donor(kv, _tokens(9))) == 1
    client = store.client("joiner")
    meta = client._call("fetch", {"phase": "list"})["runs"][0]
    first = client._call("fetch", {"phase": "chunk", "identity": meta["identity"],
                                   "key": meta["key"], "index": 0})
    now[0] = 6.0
    trace = [meta["n_chunks"] > 1, first["ok"], len(store)]
    gone = client._call("fetch", {"phase": "chunk", "identity": meta["identity"],
                                  "key": meta["key"], "index": 1})
    trace += [gone["ok"], gone["reason"], client._fetch_blob(meta) is None,
              store.seed_engine(_OneCacheEngine(_joiner(kv)))]
    return trace


def test_expired_lease_aborts_the_fetch_as_in_jax():
    registries = (Registry(), JaxRegistry())
    port = _lease_trace(pagestore, kv_pages, registries[0])
    ref = _lease_trace(jax_ps, jax_kv, registries[1])
    assert port == ref == [True, True, 0, False, "gone", True, 0]
    assert "pagestore_fetch_aborts_total 1" in registries[0].to_prometheus()
    assert registries[0].to_prometheus() == registries[1].to_prometheus()


def test_disk_spill_is_reindexed_by_the_other_package(tmp_path):
    tokens = _tokens(11)
    spill = tmp_path / "pages"
    jax_store = jax_ps.PageStore(registry=JaxRegistry(), spill_dir=spill)
    assert jax_store.capture_cache(_donor(jax_kv, tokens)) == 1
    assert sorted(p.suffix for p in spill.iterdir()) == [".run"]
    port_store = pagestore.PageStore(registry=Registry(), spill_dir=spill)
    assert port_store.stats()["disk"] == jax_ps.PageStore(
        registry=JaxRegistry(), spill_dir=spill).stats()["disk"]
    joiner = _joiner(kv_pages)
    assert port_store.seed_engine(_OneCacheEngine(joiner)) == 1
    assert joiner.lookup(tokens)[1] == len(tokens)
    assert port_store.stats()["disk"]["restored"] == 1


def test_identity_mismatch_is_refused_in_both_packages():
    tokens = _tokens(12)
    counts = []
    for ps, kv, reg in ((pagestore, kv_pages, Registry()), (jax_ps, jax_kv, JaxRegistry())):
        store = ps.PageStore(registry=reg)
        store.capture_cache(_donor(kv, tokens))
        other = _joiner(kv, identity=("llama3-8b", "int8", ("tp", 1)))
        counts.append((store.seed_engine(_OneCacheEngine(other)), reg.to_prometheus()))
    assert counts[0] == counts[1]
    assert counts[0][0] == 0 and "pagestore_identity_rejects_total 1" in counts[0][1]
