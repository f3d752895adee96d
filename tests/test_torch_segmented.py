"""The segment-resident inverted tier (port slice 6b) against the JAX
package and against the port's RAM tier, on the CPU.

The reference matrix of ``tests/test_segmented_inverted.py`` and
``tests/test_segmented_e2e.py`` on the port: every filter of ``_FILTERS``
gives the same allow mask on a segment shard as on a RAM shard with the
same objects, and BM25 the same pages (scores within 1e-5 relative: float32
sums of the same terms in another order), also after a flush to segments,
after deletes and updates, after a restart from the checkpoint and after a
crash (the delta log replayed); the values facade, reindex, the "auto"
upgrade past its cutoff (alone and under concurrent writes), the search
operators, the WAND term cache under eviction, the collection's
aggregations and hybrid search. Beside it, the port's segment shard
against the JAX package's on the same objects: equal masks and pages,
scores within 1e-5; and a segment shard written by either package opens
in the other with the same answers.
"""

import json
import threading
import time

import numpy as np
import pytest

from weaviate_tpu.core.db import DB as JaxDB
from weaviate_tpu.core.shard import Shard as JaxShard
from weaviate_tpu.inverted.filters import Filter as JaxFilter
from weaviate_tpu.schema import config as jconfig
from weaviate_tpu.storage.objects import StorageObject as JaxObject
from weaviate_tpu_torch.core.db import DB
from weaviate_tpu_torch.core.shard import Shard
from weaviate_tpu_torch.inverted.filters import Filter, Where
from weaviate_tpu_torch.inverted.segmented import (
    SegmentedInvertedIndex,
    _ValuesFacade,
    make_inverted_index,
)
from weaviate_tpu_torch.monitoring.metrics import HYBRID_FALLBACK
from weaviate_tpu_torch.query.explorer import Explorer, QueryParams
from weaviate_tpu_torch.schema import config
from weaviate_tpu_torch.storage.objects import StorageObject
from weaviate_tpu_torch.storage.store import Store

RTOL = 1e-5
PKG = {"jax": (jconfig, JaxObject, JaxShard),
       "torch": (config, StorageObject, Shard)}


def _cfg(mod, storage: str):
    P, T = mod.Property, mod.DataType
    return mod.CollectionConfig(
        name="Doc",
        properties=[
            P(name="body", data_type=T.TEXT),
            P(name="cat", data_type=T.TEXT),
            P(name="tags", data_type=T.TEXT_ARRAY),
            P(name="views", data_type=T.INT),
            P(name="score", data_type=T.NUMBER),
            P(name="nums", data_type=T.INT_ARRAY),
            P(name="ok", data_type=T.BOOL),
            P(name="loc", data_type=T.GEO),
        ],
        vector_config=mod.FlatIndexConfig(distance="l2-squared",
                                          precision="fp32"),
        inverted_config=mod.InvertedIndexConfig(storage=storage),
    )


_WORDS = ["apple", "banana", "cherry", "quantum", "football", "election",
          "riverbank", "holiday", "syntax", "gravity"]
_CATS = ["news", "sports", "tech", "science"]


def _mk_objs(n: int, seed: int = 7, cls=StorageObject) -> list:
    rng = np.random.default_rng(seed)
    objs = []
    for i in range(n):
        props = {
            "body": " ".join(rng.choice(_WORDS, size=6).tolist()) + f" d{i}",
            "cat": _CATS[i % len(_CATS)],
            "tags": [_WORDS[i % 10], _WORDS[(i * 3 + 1) % 10]],
            "views": int(i * 10),
            "score": float(i) / 3.0,
            "nums": [int(i % 5), int(i % 7)],
            "ok": bool(i % 2),
        }
        if i % 4 == 0:
            props["loc"] = {"latitude": 50.0 + (i % 10) * 0.5,
                            "longitude": 13.0 + (i % 10) * 0.5}
        if i % 9 == 0:
            del props["views"]
        vec = np.zeros(8, np.float32)
        vec[i % 8] = 1.0
        objs.append(cls(uuid=f"00000000-0000-0000-0000-{i:012d}",
                        collection="Doc", properties=props, vector=vec))
    return objs


_FILTERS = [
    Where.eq("cat", "tech"),
    Where.eq("views", 100),
    Where.eq("score", 2.0),
    Where.eq("ok", True),
    Where.eq("tags", "apple"),
    Where.neq("cat", "news"),
    Where.neq("tags", "apple"),
    Where.gt("views", 200),
    Where.gte("views", 200),
    Where.lt("score", 5.0),
    Where.lte("views", 90),
    Where.gt("nums", 3),
    Where.like("cat", "s*"),
    Where.like("tags", "?anana"),
    Where.contains_any("tags", ["apple", "syntax"]),
    Where.contains_all("tags", ["apple", "banana"]),
    Where.is_null("views", True),
    Where.is_null("views", False),
    Where.is_null("loc", True),
    Where.gt("cat", "sports"),
    Where.and_(Where.eq("cat", "tech"), Where.gt("views", 100)),
    Where.or_(Where.eq("cat", "news"), Where.lt("views", 50)),
    Where.not_(Where.eq("cat", "tech")),
    Where.and_(Where.or_(Where.eq("ok", True), Where.gt("score", 8.0)),
               Where.not_(Where.is_null("views", True))),
    Filter("WithinGeoRange", ["loc"],
           {"latitude": 51.0, "longitude": 14.0, "distance": 200_000}),
]
_QUERIES = ["apple banana", "quantum", "election holiday", "d42",
            "missingterm"]


def _shard(pkg, path, storage, n=240, seed=7, **kw):
    mod, cls, shard_cls = PKG[pkg]
    if pkg == "torch":
        kw["device"] = "cpu"
    s = shard_cls(str(path), _cfg(mod, storage), **kw)
    if n:
        s.put_batch(_mk_objs(n, seed, cls))
    return s


def _flt(pkg, f):
    return f if pkg == "torch" else JaxFilter.from_dict(f.to_dict())


def _bm25(s, q, k=12, **kw):
    return s.inverted.bm25_search(q, k, doc_space=s._next_doc_id, **kw)


def _assert_parity(ram, seg, ram_pkg="torch", seg_pkg="torch"):
    """The reference's parity check: equal allow masks, BM25 pages equal as
    doc sets with scores within RTOL (order may differ among exact ties),
    and the filtered page."""
    for f in _FILTERS:
        m_ram = ram.allow_list(_flt(ram_pkg, f))
        m_seg = seg.allow_list(_flt(seg_pkg, f))
        n = min(len(m_ram), len(m_seg))
        np.testing.assert_array_equal(m_ram[:n], m_seg[:n],
                                      err_msg=str(f.to_dict()))
        assert not m_ram[n:].any() and not m_seg[n:].any()
    for q in _QUERIES:
        ids_r, sc_r = _bm25(ram, q)
        ids_s, sc_s = _bm25(seg, q)
        np.testing.assert_allclose(sorted(sc_r), sorted(sc_s), rtol=RTOL)
        assert set(ids_r.tolist()) == set(ids_s.tolist()), q
    tech = Where.eq("cat", "tech")
    ids_s, _ = _bm25(seg, "apple", 10,
                     allow_list=seg.allow_list(_flt(seg_pkg, tech)))
    ids_r, _ = _bm25(ram, "apple", 10,
                     allow_list=ram.allow_list(_flt(ram_pkg, tech)))
    assert set(ids_s.tolist()) == set(ids_r.tolist())


def _assert_same_pages(a, b, pkg_b="jax"):
    """Two segment shards of one object sequence: equal masks and BM25
    pages (ids in order, scores within RTOL)."""
    for f in _FILTERS:
        np.testing.assert_array_equal(a.allow_list(f),
                                      b.allow_list(_flt(pkg_b, f)))
    for q in _QUERIES:
        ia, sa = _bm25(a, q)
        ib, sb = _bm25(b, q)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_allclose(sa, sb, rtol=RTOL)


@pytest.fixture
def shards(tmp_path):
    opened = []

    def make(*args, **kw):
        s = _shard(*args, **kw)
        opened.append(s)
        return s

    yield make
    for s in opened:
        try:
            s.close()
        except Exception:  # noqa: BLE001 - already closed by the test
            pass


def _engine(s) -> str:
    """A shard's BM25 engine: the native WAND engine (a RAM index's
    ``native``, the segment tier's bounded ``_wand`` cache) or the dense
    path."""
    inv = s.inverted
    eng = inv._wand if getattr(inv, "segmented", False) else inv.native
    return "native" if eng is not None else "dense"


def _on_one_engine(build_jax, build_torch):
    """``build_jax(tag)`` -> a JAX shard and ``build_torch()`` -> a list of
    the port's shards, on one BM25 engine: where the JAX package's native
    engine did not come up, the port's shards are built with theirs off;
    where the port's did not, the JAX shard is built again with its own
    off (under ``tag`` "-dense"). Returns (jax shard, torch shards)."""
    j = build_jax("")
    with pytest.MonkeyPatch.context() as mp:
        if _engine(j) == "dense":
            mp.setenv("WEAVIATE_TPU_NATIVE_BM25", "off")
        ts = build_torch()
    if _engine(j) == "native" and any(_engine(t) == "dense" for t in ts):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("WEAVIATE_TPU_NATIVE_BM25", "off")
            j = build_jax("-dense")
    engines = {_engine(j)} | {_engine(t) for t in ts}
    assert len(engines) == 1, engines
    return j, ts


def _forced_off(monkeypatch, side):
    """``side``'s native BM25 engine does not come up (None: both do)."""
    if side is None:
        return
    from weaviate_tpu.inverted import native_bm25 as jnative
    from weaviate_tpu_torch.inverted import native_bm25 as tnative

    monkeypatch.setattr(jnative if side == "jax" else tnative,
                        "try_native_bm25", lambda k1, b: None)


def _segment_trio(shards, path):
    """(JAX segment shard, port's RAM shard, port's segment shard) of the
    same 240 objects, the two segment shards on one BM25 engine (the RAM
    shard beside the port's, on its engine)."""
    jseg, (ram, seg) = _on_one_engine(
        lambda tag: shards("jax", path / f"jseg{tag}", "segment"),
        lambda: [shards("torch", path / "ram", "ram"),
                 shards("torch", path / "seg", "segment")])
    return jseg, ram, seg


def _filter_and_bm25_parity(shards, path, flush):
    jseg, ram, seg = _segment_trio(shards, path)
    assert isinstance(seg.inverted, SegmentedInvertedIndex)
    assert not getattr(ram.inverted, "segmented", False)
    if flush:  # results from disk segments, not memtables
        seg.store.flush_all()
        jseg.store.flush_all()
    _assert_parity(ram, seg)
    _assert_same_pages(seg, jseg)
    return jseg, seg


@pytest.mark.parametrize("flush", [False, True])
def test_filter_and_bm25_parity(shards, tmp_path, flush):
    _filter_and_bm25_parity(shards, tmp_path, flush)


def _deletes_and_updates_parity(shards, path):
    jseg, ram, seg = _segment_trio(shards, path)
    victims = [f"00000000-0000-0000-0000-{i:012d}" for i in range(0, 240, 7)]
    for s in (ram, seg, jseg):
        assert s.delete(victims) == len(victims)
    ram.put_batch(_mk_objs(30, seed=99))
    seg.put_batch(_mk_objs(30, seed=99))
    jseg.put_batch(_mk_objs(30, seed=99, cls=JaxObject))
    _assert_parity(ram, seg)
    _assert_same_pages(seg, jseg)
    return jseg, seg


def test_deletes_and_updates_parity(shards, tmp_path):
    _deletes_and_updates_parity(shards, tmp_path)


def test_restart_from_checkpoint(tmp_path):
    d = tmp_path / "s"
    seg = _shard("torch", d, "segment", 150)
    flt = Where.and_(Where.eq("cat", "tech"), Where.gt("views", 100))
    before = (seg.allow_list(flt), _bm25(seg, "apple quantum", 10))
    space = seg._next_doc_id
    seg.close()
    seg2 = Shard(str(d), _cfg(config, "segment"), device="cpu")
    assert seg2.recovered_from == "checkpoint"
    assert seg2.inverted.doc_count == 150
    assert seg2.inverted.lens_counts["body"] == 150
    np.testing.assert_array_equal(before[0], seg2.allow_list(flt, space))
    ids2, sc2 = seg2.inverted.bm25_search("apple quantum", 10,
                                          doc_space=space)
    np.testing.assert_array_equal(before[1][0], ids2)
    np.testing.assert_allclose(before[1][1], sc2, rtol=1e-6)
    seg2.close()


def test_crash_recovery_replays_delta(tmp_path):
    import os

    d = tmp_path / "s"
    seg = _shard("torch", d, "segment", 80, sync_writes=False)
    seg.delete([f"00000000-0000-0000-0000-{i:012d}" for i in range(0, 80, 9)])
    expected = seg.allow_list(Where.neq("cat", "news"))
    space = seg._next_doc_id
    seg.flush()
    snap = os.path.join(str(d), "inverted.snap")
    if os.path.exists(snap):
        os.remove(snap)
    seg2 = Shard(str(d), _cfg(config, "segment"), device="cpu")
    assert seg2.recovered_from == "full"
    np.testing.assert_array_equal(
        expected, seg2.allow_list(Where.neq("cat", "news"), space))
    seg2.close()


def test_ram_residue_is_bounded_and_values_facade(shards, tmp_path):
    ram = shards("torch", tmp_path / "ram", "ram")
    seg = shards("torch", tmp_path / "seg", "segment")
    inv = seg.inverted
    assert not inv.postings and not inv.doc_lengths
    assert isinstance(inv.values, _ValuesFacade)
    assert set(inv.columnar.props) <= {"loc"}
    assert inv.native is None
    assert dict(ram.inverted.values.get("cat", {}).items()) == \
        dict(inv.values.get("cat", {}).items())
    assert inv.values["views"].get(10) == \
        ram.inverted.values.get("views", {}).get(10)
    assert inv.bm25_device_search("apple", 10, device="cpu") is None
    assert inv.stats()["storage"] == "segment"


def test_reindex_truncates_buckets(tmp_path):
    seg = _shard("torch", tmp_path / "s", "segment", 50)
    assert seg.reindex_inverted() == 50
    assert getattr(seg.inverted, "segmented", False)
    assert seg.inverted.doc_count == 50
    m = seg.allow_list(Where.eq("cat", "tech"))
    assert m.sum() == sum(1 for i in range(50) if _CATS[i % 4] == "tech")
    assert len(_bm25(seg, "apple", 10)[0]) > 0
    seg.close()


def _wait_segmented(sh, seconds):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline and \
            not getattr(sh.inverted, "segmented", False):
        time.sleep(0.02)
    return getattr(sh.inverted, "segmented", False)


def test_auto_storage_upgrades_past_cutoff(tmp_path):
    cfg = _cfg(config, "auto")
    cfg.inverted_config.segment_cutoff = 300
    d = str(tmp_path / "s")
    sh = Shard(d, cfg, device="cpu")
    sh.put_batch(_mk_objs(200))
    assert not getattr(sh.inverted, "segmented", False)
    sh.put_batch(_mk_objs(200, seed=31))
    sh.put_batch([o for o in _mk_objs(400, seed=55)
                  if int(o.uuid[-4:]) >= 200])
    assert _wait_segmented(sh, 60), "never upgraded"
    assert sh.inverted.doc_count == 400
    ram = _shard("torch", tmp_path / "ram", "ram", 200)
    ram.put_batch(_mk_objs(200, seed=31))
    ram.put_batch([o for o in _mk_objs(400, seed=55)
                   if int(o.uuid[-4:]) >= 200])
    _assert_parity(ram, sh)
    ram.close()
    sh.close()
    sh2 = Shard(d, cfg, device="cpu")
    assert getattr(sh2.inverted, "segmented", False)
    assert sh2.recovered_from == "checkpoint"
    assert sh2.allow_list(Where.eq("cat", "tech")).sum() == 100
    sh2.close()


def test_auto_upgrade_with_concurrent_writes(tmp_path):
    """Writes and deletes run while the migration does; each operation is
    recorded under one lock together with its application, so the list
    is the order the shard applied them in, and a RAM shard replays it.
    Every wait is a deadline-bounded poll."""
    cfg = _cfg(config, "auto")
    cfg.inverted_config.segment_cutoff = 200
    sh = Shard(str(tmp_path / "s"), cfg, device="cpu")
    base = _mk_objs(300)
    ops: list = []
    order = threading.Lock()

    def apply(kind, payload):
        with order:
            if kind == "put":
                sh.put_batch(base[payload[0]:payload[1]])
            elif kind == "putseed":
                seed, lo, hi = payload
                sh.put_batch(_mk_objs(300, seed=seed)[lo:hi])
            else:
                sh.delete(payload)
            ops.append((kind, payload))

    apply("put", (0, 199))
    err: list = []

    def writer():
        try:
            for i in range(24):
                apply("putseed", (200 + i, i * 8, i * 8 + 8))
                if i % 3 == 0:
                    apply("del", [o.uuid for o in
                                  _mk_objs(300, seed=200 + i)[i * 8:i * 8 + 2]])
        except Exception as e:  # noqa: BLE001
            err.append(e)

    t = threading.Thread(target=writer)
    t.start()
    apply("put", (199, 300))  # crosses the cutoff: the migration starts
    t.join(timeout=120)
    assert not t.is_alive() and not err, err
    assert _wait_segmented(sh, 120), "migration never landed"
    ram = _shard("torch", tmp_path / "ram", "ram", 0)
    for kind, payload in ops:
        if kind == "put":
            ram.put_batch(base[payload[0]:payload[1]])
        elif kind == "putseed":
            seed, lo, hi = payload
            ram.put_batch(_mk_objs(300, seed=seed)[lo:hi])
        else:
            ram.delete(payload)
    assert sh.inverted.doc_count == ram.inverted.doc_count
    # the same order of operations gives the same doc ids
    np.testing.assert_array_equal(sh.live_mask(sh._next_doc_id),
                                  ram.live_mask(ram._next_doc_id))
    _assert_parity(ram, sh)
    ram.close()
    sh.close()


def _search_operator_parity(shards, path):
    jseg, ram, seg = _segment_trio(shards, path)
    for q, kw in [("apple banana", dict(operator="And")),
                  ("apple banana cherry", dict(minimum_match=2)),
                  ("quantum zzzmissing", dict(operator="And"))]:
        ids_s, sc_s = _bm25(seg, q, 240, **kw)
        ids_r, _ = _bm25(ram, q, 240, **kw)
        ids_j, sc_j = _bm25(jseg, q, 240, **kw)
        assert set(ids_s) == set(ids_r), (q, kw)
        np.testing.assert_array_equal(ids_s, ids_j)
        np.testing.assert_allclose(sc_s, sc_j, rtol=RTOL)
        assert set(ids_r) <= set(_bm25(ram, q, 240)[0])
    return jseg, seg


def test_search_operator_parity(shards, tmp_path):
    _search_operator_parity(shards, tmp_path)


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_pages_follow_an_engine_that_did_not_come_up(shards, tmp_path,
                                                     monkeypatch, side):
    """One package's native engine forced off: every comparison with the
    JAX segment shard is built on the dense path on both sides and agrees
    page for page."""
    _forced_off(monkeypatch, side)
    for check, path in ((lambda p: _filter_and_bm25_parity(shards, p, True),
                         "filters"),
                        (lambda p: _deletes_and_updates_parity(shards, p),
                         "deletes"),
                        (lambda p: _search_operator_parity(shards, p),
                         "operators"),
                        (lambda p: _opens_across_packages(shards, p, "jax"),
                         "written_by_jax"),
                        (lambda p: _opens_across_packages(shards, p, "torch"),
                         "written_by_torch")):
        jseg, seg = check(tmp_path / path)
        assert _engine(jseg) == _engine(seg) == "dense", path


def test_wand_cache_eviction_and_invalidation(tmp_path, monkeypatch):
    monkeypatch.setenv("WEAVIATE_TPU_WAND_CACHE_MB", "0.001")
    seg = _shard("torch", tmp_path / "tiny", "segment")
    assert seg.inverted._wand is not None
    ram = _shard("torch", tmp_path / "ram", "ram")
    for q in ["apple banana", "quantum", "election holiday riverbank"]:
        assert set(_bm25(seg, q)[0].tolist()) == set(_bm25(ram, q)[0].tolist())
    st = seg.inverted.stats()["wand_cache"]
    assert st["bytes"] <= st["budget"] + 3 * 240 * 16
    seg.put_batch(_mk_objs(40, seed=77))
    ram.put_batch(_mk_objs(40, seed=77))
    assert set(_bm25(seg, "apple")[0].tolist()) == \
        set(_bm25(ram, "apple")[0].tolist())
    seg.close()
    ram.close()
    monkeypatch.setenv("WEAVIATE_TPU_WAND_CACHE_MB", "0")
    seg2 = _shard("torch", tmp_path / "dense", "segment")
    assert seg2.inverted._wand is None
    ram2 = _shard("torch", tmp_path / "ram2", "ram")
    assert set(_bm25(seg2, "apple banana")[0].tolist()) == \
        set(_bm25(ram2, "apple banana")[0].tolist())
    seg2.close()
    ram2.close()


def _opens_across_packages(shards, path, writer):
    """A segment shard written by ``writer`` opens in the other package and
    pages as a twin written by ``writer``, the two on one BM25 engine."""
    reader = "torch" if writer == "jax" else "jax"
    d = path / "s"
    victims = [f"00000000-0000-0000-0000-{i:012d}" for i in range(0, 200, 11)]
    a = _shard(writer, d, "segment", 200)
    a.delete(victims)
    a.close()
    opened = {}

    def build(pkg, tag=""):
        if pkg == reader:
            if pkg in opened:
                opened[pkg].close()
            s = shards(reader, d, "segment", 0)
            assert s.recovered_from == "checkpoint"
            assert getattr(s.inverted, "segmented", False)
        else:
            s = shards(writer, path / f"twin{tag}", "segment", 200)
            s.delete(victims)
        opened[pkg] = s
        return s

    j, (t,) = _on_one_engine(lambda tag: build("jax", tag),
                             lambda: [build("torch")])
    _assert_same_pages(t, j, "jax")
    return j, t


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_segmented_shard_opens_across_packages(shards, tmp_path, writer):
    _opens_across_packages(shards, tmp_path, writer)


def test_factory_follows_the_snapshot_header(tmp_path):
    """"auto" boots into the segment tier when the snapshot header says
    ``segmented``; "ram" stays RAM; no store gives the RAM index."""
    seg = _shard("torch", tmp_path / "s", "segment", 20)
    seg.close()
    snap = str(tmp_path / "s" / "inverted.snap")
    store = Store(str(tmp_path / "x"))
    for storage, want in (("auto", True), ("ram", False),
                          ("segment", True)):
        got = make_inverted_index(_cfg(config, storage), store,
                                  snapshot_path=snap)
        assert getattr(got, "segmented", False) is want
    assert not getattr(make_inverted_index(_cfg(config, "segment")),
                       "segmented", False)
    store.close()


# -- through the collection (tests/test_segmented_e2e.py) -------------------

D = 16


def _article_db(mod, db_cls, root, storage, **kw):
    db = db_cls(str(root), **kw)
    P, T = mod.Property, mod.DataType
    col = db.create_collection(mod.CollectionConfig(
        name="Article",
        properties=[P(name="title", data_type=T.TEXT),
                    P(name="category", data_type=T.TEXT),
                    P(name="views", data_type=T.INT)],
        vector_config=mod.FlatIndexConfig(distance="l2-squared",
                                          precision="fp32"),
        inverted_config=mod.InvertedIndexConfig(storage=storage)))
    cls = StorageObject if mod is config else JaxObject
    objs = []
    for i in range(90):
        vec = np.zeros(D, np.float32)
        vec[i % D] = 1.0
        objs.append(cls(
            uuid=f"00000000-0000-0000-0000-{i:012d}", collection="Article",
            properties={"title": f"{_WORDS[i % 6]} story {i}",
                        "category": ["news", "sports", "tech"][i % 3],
                        "views": i * 10}, vector=vec))
    col.put_batch(objs)
    return db, col


@pytest.mark.parametrize("storage", ["ram", "segment"])
def test_hybrid_filtered_sorted_aggregated(tmp_path, storage):
    dbs = {}

    def build(pkg, tag=""):
        if pkg in dbs:
            dbs[pkg][0].close()
        if pkg == "torch":
            dbs[pkg] = _article_db(config, DB, tmp_path / storage, storage,
                                   device="cpu")
        else:
            dbs[pkg] = _article_db(jconfig, JaxDB,
                                   tmp_path / f"j{storage}{tag}", storage)
        return dbs[pkg][1]._get_shard("shard0")

    # the hybrid pages' keyword legs on one BM25 engine
    _on_one_engine(lambda tag: build("jax", tag), lambda: [build("torch")])
    (db, col), (jdb, jcol) = dbs["torch"], dbs["jax"]
    if storage == "segment":
        assert getattr(col._get_shard("shard0").inverted, "segmented", False)
    q = np.zeros(D, np.float32)
    q[0] = 1.0
    res = col.hybrid_search(query="election", vector=q, alpha=0.6, k=10)
    jres = jcol.hybrid_search(query="election", vector=q, alpha=0.6, k=10)
    assert [o.uuid for o, _ in res] == [o.uuid for o, _ in jres]
    np.testing.assert_allclose([s for _, s in res], [s for _, s in jres],
                               rtol=RTOL)
    out = Explorer(db).get(QueryParams(
        collection="Article",
        filters=Where.and_(Where.eq("category", "tech"),
                           Where.gt("views", 100)),
        sort=[("views", "desc")], limit=5))
    views = [h.object.properties["views"] for h in out.hits]
    assert views == sorted(views, reverse=True) and len(views) == 5
    agg = col.aggregate(properties={"views": "numeric"},
                        flt=Where.eq("category", "news"))
    assert agg["meta"]["count"] == 30
    assert agg["properties"]["views"]["max"] == 870.0
    grouped = col.aggregate(properties={"views": "numeric"},
                            group_by="category")
    assert all(g["meta"]["count"] == 30 for g in grouped["groups"])
    hits = col.bm25_search("quantum", k=8)
    assert hits and all("quantum" in o.properties["title"] for o, _ in hits)
    # the device route declines on the segment tier and WAND answers
    before = HYBRID_FALLBACK.value(stage="sparse", reason="unsupported")
    dev = col.bm25_search("quantum", k=8, flt=Where.gt("views", 100),
                          device_scoring=True)
    wand = col.bm25_search("quantum", k=8, flt=Where.gt("views", 100))
    assert [o.uuid for o, _ in dev] == [o.uuid for o, _ in wand]
    after = HYBRID_FALLBACK.value(stage="sparse", reason="unsupported")
    assert after - before == (1 if storage == "segment" else 0)
    db.close()
    jdb.close()


def _agg_objs(cls):
    objs = []
    for i in range(120):
        props = {"cat": ["news", "sports", "tech"][i % 3],
                 "tags": [f"t{i % 4}", f"t{(i * 3 + 1) % 7}"],
                 "score": float(i % 11) / 3.0 - 1.0,
                 "nums": [i % 5, i % 7 + 10], "ok": bool(i % 2)}
        if i % 9 != 0:
            props["views"] = (i % 6) * 10
        vec = np.zeros(D, np.float32)
        vec[i % D] = 1.0
        objs.append(cls(uuid=f"00000000-0000-0000-0000-{i:012d}",
                        collection="Doc", properties=props, vector=vec))
    return objs


def test_aggregate_parity_ram_segment_and_jax(tmp_path):
    """The bucket-native aggregation answers as the RAM tier's value maps
    and as the JAX package's segment tier, at the JSON level."""
    spec = {"cat": "text", "tags": "text", "views": "numeric",
            "score": "numeric", "nums": "numeric", "ok": "boolean"}
    outs = {}
    for name, mod, db_cls, storage, kw in (
            ("ram", config, DB, "ram", dict(device="cpu")),
            ("segment", config, DB, "segment", dict(device="cpu")),
            ("jax", jconfig, JaxDB, "segment", {})):
        db = db_cls(str(tmp_path / name), **kw)
        P, T = mod.Property, mod.DataType
        col = db.create_collection(mod.CollectionConfig(
            name="Doc",
            properties=[P(name="cat", data_type=T.TEXT),
                        P(name="tags", data_type=T.TEXT_ARRAY),
                        P(name="views", data_type=T.INT),
                        P(name="score", data_type=T.NUMBER),
                        P(name="nums", data_type=T.INT_ARRAY),
                        P(name="ok", data_type=T.BOOL)],
            vector_config=mod.FlatIndexConfig(distance="l2-squared",
                                              precision="fp32"),
            inverted_config=mod.InvertedIndexConfig(storage=storage)))
        objs = _agg_objs(StorageObject if mod is config else JaxObject)
        col.put_batch(objs)
        col.delete([objs[7].uuid, objs[30].uuid])
        W = Where if mod is config else __import__(
            "weaviate_tpu.inverted.filters", fromlist=["Where"]).Where
        outs[name] = {
            "plain": col.aggregate(properties=spec),
            "filtered": col.aggregate(properties=spec,
                                      flt=W.eq("cat", "tech")),
            "range_filtered": col.aggregate(properties={"views": "numeric"},
                                            flt=W.gt("score", 0.5)),
            "grouped": col.aggregate(
                properties={"views": "numeric", "ok": "boolean"},
                group_by="cat"),
            "grouped_multi": col.aggregate(properties={"score": "numeric"},
                                           group_by="tags"),
            "grouped_int": col.aggregate(properties={"score": "numeric"},
                                         group_by="views"),
        }
        db.close()
    for key in outs["ram"]:
        ram = json.dumps(outs["ram"][key], sort_keys=True)
        assert json.dumps(outs["segment"][key], sort_keys=True) == ram, key
        assert json.dumps(outs["jax"][key], sort_keys=True) == ram, key
