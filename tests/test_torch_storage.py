"""Parity: weaviate_tpu_torch storage (objects, WAL, segments, buckets,
bitmaps) against the JAX package's on the same seeded records, on the CPU.

Both packages must write the same bytes (the on-disk formats are shared, so
a directory written by one opens in the other), read back the same values,
and open each other's files: a bucket's WAL tail replayed after a crash, its
flushed segments, and compacted segments, native merge and Python merge.
"""

import os
import time

import numpy as np
import pytest

from weaviate_tpu.storage import bitmaps as jbitmaps
from weaviate_tpu.storage import segment as jsegment
from weaviate_tpu.storage.objects import StorageObject as JaxObject
from weaviate_tpu.storage.store import Bucket as JaxBucket
from weaviate_tpu.storage.store import Store as JaxStore
from weaviate_tpu.storage.wal import WAL as JaxWAL
from weaviate_tpu_torch.storage import bitmaps
from weaviate_tpu_torch.storage import segment
from weaviate_tpu_torch.storage.objects import StorageObject
from weaviate_tpu_torch.storage.store import Bucket, Store
from weaviate_tpu_torch.storage.wal import WAL

STRATEGIES = ("replace", "set", "map", "roaringset", "inverted")


def _objects(rng, n=40, dims=16):
    out = []
    for i in range(n):
        props = {
            "title": f"doc {i} " + " ".join(
                rng.choice(["alpha", "beta", "gamma", "delta"], 3)),
            "views": int(rng.integers(0, 1000)),
            "score": float(rng.standard_normal()),
            "ok": bool(i % 2),
            "tags": [f"t{j}" for j in range(i % 4)],
            "nested": {"a": i, "b": [1.5, None, "x"]},
            "missing": None,
        }
        kw = dict(uuid=f"00000000-0000-4000-8000-{i:012d}", collection="Doc",
                  properties=props, doc_id=i, tenant="" if i % 3 else "t1",
                  creation_time_ms=1_700_000_000_000 + i,
                  update_time_ms=1_700_000_000_500 + i)
        if i % 5:
            kw["vector"] = rng.standard_normal(dims).astype(np.float32)
        if i % 7 == 0:
            kw["named_vectors"] = {
                "img": rng.standard_normal(8).astype(np.float32),
                "toks": rng.standard_normal((3, 4)).astype(np.float32)}
        if i == 11:
            kw["vector"] = rng.standard_normal((2, dims)).astype(np.float32)
        out.append(kw)
    return out


def _same_object(a, b):
    assert (a.uuid, a.collection, a.properties, a.doc_id, a.tenant,
            a.creation_time_ms, a.update_time_ms) == \
        (b.uuid, b.collection, b.properties, b.doc_id, b.tenant,
         b.creation_time_ms, b.update_time_ms)
    if a.vector is None:
        assert b.vector is None
    else:
        np.testing.assert_array_equal(a.vector, b.vector)
    assert a.named_vectors.keys() == b.named_vectors.keys()
    for k in a.named_vectors:
        np.testing.assert_array_equal(a.named_vectors[k], b.named_vectors[k])


def test_storage_object_bytes_identical_and_cross_decode():
    for kw in _objects(np.random.default_rng(0)):
        j, t = JaxObject(**kw), StorageObject(**kw)
        raw = t.to_bytes()
        assert raw == j.to_bytes()
        _same_object(JaxObject.from_bytes(raw), StorageObject.from_bytes(raw))
        assert StorageObject.extract_doc_id(raw) == kw["doc_id"]


def test_wal_bytes_identical_and_cross_replay(tmp_path):
    rng = np.random.default_rng(1)
    payloads = [rng.bytes(int(rng.integers(0, 300))) for _ in range(50)]
    paths = {}
    for name, cls in (("jax", JaxWAL), ("torch", WAL)):
        paths[name] = str(tmp_path / f"{name}.log")
        w = cls(paths[name])
        for p in payloads:
            w.append(p)
        w.close()
    with open(paths["jax"], "rb") as a, open(paths["torch"], "rb") as b:
        assert a.read() == b.read()
    # a torn tail from a crash is cut the same way by both
    for p in paths.values():
        with open(p, "ab") as f:
            f.write(b"\xff\xff\xff\x7f partial")
    assert list(WAL.replay(paths["jax"])) == payloads
    assert list(JaxWAL.replay(paths["torch"])) == payloads
    assert os.path.getsize(paths["jax"]) == os.path.getsize(paths["torch"])


def _value(strategy, rng, i):
    if strategy == "replace":
        return rng.bytes(int(rng.integers(1, 64)))
    if strategy == "set":
        return [b"m%d" % j for j in rng.integers(0, 20, 3)]
    if strategy == "map":
        return {b"k%d" % j: rng.bytes(4) for j in rng.integers(0, 10, 2)}
    if strategy == "roaringset":
        return np.unique(rng.integers(0, 5000, int(rng.integers(1, 40))))
    ids = np.unique(rng.integers(0, 3000, 5))
    return ids, np.full(len(ids), i % 7 + 1), np.full(len(ids), 12)


def _write(bucket, strategy, key, val):
    if strategy == "replace":
        bucket.put(key, val)
    elif strategy == "set":
        bucket.set_add(key, val)
    elif strategy == "map":
        for mk, mv in val.items():
            bucket.map_put(key, mk, mv)
    elif strategy == "roaringset":
        bucket.roaring_add(key, val)
    else:
        bucket.postings_put(key, *val)


def _remove(bucket, strategy, key, val):
    if strategy == "replace":
        bucket.delete(key)
    elif strategy == "set":
        bucket.set_remove(key, val[:1])
    elif strategy == "map":
        bucket.map_delete(key, next(iter(val)))
    elif strategy == "roaringset":
        bucket.roaring_remove(key, val[::2])
    else:
        bucket.postings_remove(key, val[0][:1])


def _drive(bucket, strategy, seed):
    """Puts, removes, two flushes and a compaction, then an unflushed tail
    left only in the WAL."""
    rng = np.random.default_rng(seed)
    keys = [b"key-%03d" % i for i in range(60)]
    for rnd in range(4):
        for i in rng.permutation(len(keys))[:30]:
            val = _value(strategy, rng, int(i))
            _write(bucket, strategy, keys[i], val)
            if rng.random() < 0.2:
                _remove(bucket, strategy, keys[i], val)
        if rnd == 1:
            bucket.flush_memtable()
        if rnd == 2:
            bucket.flush_memtable()
            bucket.compact()
    bucket._wal.flush()


def _read_all(bucket, strategy):
    out = {}
    for key, val in bucket.items():
        if strategy == "roaringset":
            out[key] = bucket.roaring_get(key).to_array().tolist()
        elif strategy == "inverted":
            out[key] = [a.tolist() for a in bucket.postings_get(key)]
        elif strategy == "set":
            out[key] = sorted(bucket.set_members(key))
        elif strategy == "map":
            out[key] = dict(bucket.map_items(key))
        else:
            out[key] = bucket.get(key)
    return out


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if not f.endswith(".tmp")}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_bucket_same_files_same_reads_and_cross_open(tmp_path, strategy):
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    bj, bt = JaxBucket(dj, strategy=strategy), Bucket(dt, strategy=strategy)
    _drive(bj, strategy, 7)
    _drive(bt, strategy, 7)
    want = _read_all(bj, strategy)
    assert want and _read_all(bt, strategy) == want
    # segments and WAL: the same bytes on disk
    assert _files(dt) == _files(dj)
    # crash (no close): each package replays the other's WAL tail over
    # the other's segments
    assert _read_all(Bucket(dj, strategy=strategy), strategy) == want
    assert _read_all(JaxBucket(dt, strategy=strategy), strategy) == want


def test_store_cross_open_after_close(tmp_path):
    rng = np.random.default_rng(3)
    objs = [StorageObject(**kw) for kw in _objects(rng, n=200)]
    d = str(tmp_path / "st")
    st = JaxStore(d)
    b = st.bucket("objects")
    for o in objs:
        b.put(o.doc_id.to_bytes(8, "big"), o.to_bytes())
    b.flush_memtable()
    for o in objs[::3]:
        b.delete(o.doc_id.to_bytes(8, "big"))
    st.close()
    port = Store(d)
    got = {int.from_bytes(k, "big"): StorageObject.from_bytes(v)
           for k, v in port.bucket("objects").items()}
    assert sorted(got) == [o.doc_id for i, o in enumerate(objs) if i % 3]
    for o in objs[1::3]:
        _same_object(got[o.doc_id], o)
    # and back: the port's writes read by the JAX store
    port.bucket("objects").put(b"extra", b"x")
    port.close()
    assert JaxStore(d).bucket("objects").get(b"extra") == b"x"


def _jax_native_merge(paths, out, strategy, attempts=20):
    """The JAX package's native merge. That package builds its library
    into one temporary file in its source tree, which test processes
    running side by side race for; the loser latches the library as
    unavailable for its whole process and the merge returns None. So on
    None its latched entry is dropped (module state only) and the merge
    retried, until the library the race's winner wrote is found."""
    from weaviate_tpu import native as jnative

    n = jsegment.native_merge(paths, out, strategy, True)
    for _ in range(attempts):
        if n is not None:
            break
        jnative._LIBS.pop("segment_merge", None)
        time.sleep(0.5)
        n = jsegment.native_merge(paths, out, strategy, True)
    assert n is not None, "the JAX package's native merge did not build"
    return n


@pytest.mark.parametrize("strategy", ("replace", "map", "set", "inverted"))
def test_segment_write_and_merges_identical(tmp_path, strategy):
    """DiskSegment.write gives the same bytes in both packages, and the
    port's native k-way merge equals its own Python merge and the JAX
    package's native merge."""
    rng = np.random.default_rng(4)
    paths = []
    for s in range(3):
        keys = sorted({b"k%04d" % i for i in rng.integers(0, 400, 120)})
        if strategy == "replace":
            items = [(k, None if rng.random() < 0.1 else rng.bytes(8))
                     for k in keys]
        elif strategy == "set":
            items = [(k, {b"a": True, b"b%d" % s: bool(rng.random() < .8)})
                     for k in keys]
        else:
            items = [(k, {b"m%d" % j: (None if rng.random() < 0.1
                                       else rng.bytes(3))
                          for j in rng.integers(0, 5, 2)}) for k in keys]
        pj = str(tmp_path / f"j{s}.db")
        pt = str(tmp_path / f"t{s}.db")
        jsegment.DiskSegment.write(pj, items)
        segment.DiskSegment.write(pt, items)
        assert open(pj, "rb").read() == open(pt, "rb").read()
        paths.append(pt)
    out_t = str(tmp_path / "merged_t.db")
    out_j = str(tmp_path / "merged_j.db")
    n = segment.native_merge(paths, out_t, strategy, True)
    assert n is not None, "the port's native merge did not build or run"
    assert _jax_native_merge(paths, out_j, strategy) == n
    assert open(out_t, "rb").read() == open(out_j, "rb").read()
    segs = [segment.DiskSegment(p) for p in paths]
    py = list(segment.merge_streams([s.items() for s in segs], strategy,
                                    drop_tombstones=True))
    assert list(segment.DiskSegment(out_t).items()) == py


def test_native_library_builds_outside_the_source_tree():
    from weaviate_tpu_torch import native

    native.load("segment_merge")
    path = native.library_path("segment_merge")
    assert os.path.exists(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert not any(f.endswith(".so") for f in os.listdir(
        os.path.dirname(native.__file__)))


def test_bitmaps_bytes_identical():
    rng = np.random.default_rng(5)
    for _ in range(10):
        a = np.unique(rng.integers(0, 200_000, int(rng.integers(1, 9000))))
        b = np.unique(rng.integers(0, 200_000, int(rng.integers(1, 9000))))
        ja, jb = jbitmaps.Bitmap(a), jbitmaps.Bitmap(b)
        ta, tb = bitmaps.Bitmap(a), bitmaps.Bitmap(b)
        assert ta.to_bytes() == ja.to_bytes()
        for op in ("union", "difference", "intersection"):
            assert getattr(ta, op)(tb).to_bytes() == \
                getattr(ja, op)(jb).to_bytes()
        assert bitmaps.Bitmap.from_bytes(ja.to_bytes()).to_array().tolist() \
            == a.tolist()
        layer = jbitmaps.BitmapLayer(jbitmaps.Bitmap(a), jbitmaps.Bitmap(b))
        tl = bitmaps.BitmapLayer.from_bytes(layer.to_bytes())
        assert tl.to_bytes() == layer.to_bytes()
        vals = rng.standard_normal(50) * 1e3
        np.testing.assert_array_equal(
            [bitmaps.RangeBitmap.encode(v) for v in vals],
            [jbitmaps.RangeBitmap.encode(v) for v in vals])
