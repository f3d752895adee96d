"""The multivector index (port slice 7a: MUVERA + exact MaxSim) against the
JAX package on the CPU.

- ``MuveraEncoder``'s random matrices against ``jax.random`` (threefry2x32,
  partitionable): the +-1 projection equal bit for bit; the Gaussians within
  1e-6 (XLA's float32 ``erf_inv`` polynomial evaluated in numpy: about one
  ulp apart), and the threefry draws themselves (split, bits, uniform,
  rademacher) equal bit for bit.
- ``encode_doc`` / ``encode_query`` on ragged seeded token sets: the bucket
  ids equal, the FDEs within 1e-6.
- ``maxsim_scores`` (the host MaxSim) on padded candidates against JAX's:
  within 1e-5; its mesh form raises.
- ``fused_flat_rerank`` (the FDE scan + B7a's plain version) against JAX's:
  ids equal, negated scores within 1e-5.
- ``MultiVectorIndex.search_multi`` with allow lists, after deletes and on
  the warm tier: ids equal, distances within 1e-5.
- The index's checkpoint (FDE corpus + token file) in both directions, and
  a multivector collection through ``DB``, written by either package and
  opened by the other.
"""

import numpy as np
import pytest
import torch

from weaviate_tpu.core.db import DB as JaxDB
from weaviate_tpu.index import multivector as jmv
from weaviate_tpu.modules import device as jdev
from weaviate_tpu.ops import device_beam as jbeam
from weaviate_tpu.schema import config as jconfig
from weaviate_tpu.storage.objects import StorageObject as JaxObject
from weaviate_tpu_torch.core.db import DB
from weaviate_tpu_torch.index import multivector as tmv
from weaviate_tpu_torch.modules import device as tdev
from weaviate_tpu_torch.ops import device_beam as tbeam
from weaviate_tpu_torch.ops import rerank as trerank
from weaviate_tpu_torch.schema import config
from weaviate_tpu_torch.storage.objects import StorageObject

GAUSS_TOL = 1e-6
FDE_TOL = 1e-6
TOL = 1e-5
DIMS, N_DOCS = 16, 120


def _sets(seed, n, d=DIMS, lo=1, hi=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(rng.integers(lo, hi + 1)), d)).astype(
        np.float32) for _ in range(n)]


@pytest.mark.parametrize("shape", [(10, 4, 128, 16), (2, 3, 32, 8),
                                   (3, 5, 17, 4), (20, 4, 768, 16)])
def test_muvera_matrices_match_jax_random(shape):
    r, ksim, d, dproj = shape
    j = jmv.MuveraEncoder(d, ksim, dproj, r)
    t = tmv.MuveraEncoder(d, ksim, dproj, r)
    assert t.proj.dtype == j.proj.dtype and t.proj.shape == j.proj.shape
    np.testing.assert_array_equal(t.proj, j.proj)
    np.testing.assert_allclose(t.gaussians, j.gaussians, rtol=GAUSS_TOL,
                               atol=GAUSS_TOL)
    assert t.fde_dim == j.fde_dim


def test_threefry_draws_match_jax_random():
    import jax

    key = jax.random.PRNGKey(tmv.MUVERA_SEED)
    assert tuple(int(x) for x in np.asarray(key)) == tmv._prng_key(
        tmv.MUVERA_SEED)
    for n in (2, 3, 5):
        want = np.asarray(jax.random.split(key, n))
        got = np.asarray(tmv._split(tmv._prng_key(tmv.MUVERA_SEED), n),
                         np.uint32)
        np.testing.assert_array_equal(got, want)
    k = tmv._prng_key(7)
    jk = jax.random.PRNGKey(7)
    np.testing.assert_array_equal(
        tmv._random_bits(k, (3, 5)), np.asarray(jax.random.bits(jk, (3, 5))))
    np.testing.assert_array_equal(
        tmv._uniform(k, (4, 33)), np.asarray(jax.random.uniform(jk, (4, 33))))
    np.testing.assert_array_equal(
        tmv._rademacher(k, (6, 7)),
        np.asarray(jax.random.rademacher(jk, (6, 7))))
    np.testing.assert_allclose(
        tmv._normal(k, (1000,)), np.asarray(jax.random.normal(jk, (1000,))),
        rtol=GAUSS_TOL, atol=GAUSS_TOL)


def test_encode_doc_and_query_match_jax():
    j = jmv.MuveraEncoder(DIMS, 4, 8, 6)
    t = tmv.MuveraEncoder(DIMS, 4, 8, 6)
    sets = _sets(1, 25, lo=1, hi=40)
    # the batched encoder against JAX's document loop, one set at a time
    np.testing.assert_allclose(t.encode_docs(sets),
                               np.stack([j.encode_doc(s) for s in sets]),
                               rtol=FDE_TOL, atol=FDE_TOL)
    for toks in sets:
        np.testing.assert_array_equal(t._bucket_ids(toks), j._bucket_ids(toks))
        np.testing.assert_allclose(t.encode_doc(toks), j.encode_doc(toks),
                                   rtol=FDE_TOL, atol=FDE_TOL)
        np.testing.assert_allclose(t.encode_query(toks),
                                   j.encode_query(toks), rtol=FDE_TOL,
                                   atol=FDE_TOL)


@pytest.mark.parametrize("tq,tmax", [(1, 3), (5, 8)])
def test_maxsim_scores_matches_jax(tq, tmax):
    rng = np.random.default_rng(11 + tq)
    q = rng.standard_normal((tq, DIMS)).astype(np.float32)
    toks = rng.standard_normal((9, tmax, DIMS)).astype(np.float32)
    mask = np.arange(tmax)[None, :] < rng.integers(0, tmax + 1, 9)[:, None]
    mask[0] = False                       # a candidate with no kept token
    toks[~mask] = 9.0                     # padding never scores
    got = tmv.maxsim_scores(q, toks, mask)
    np.testing.assert_allclose(got, np.asarray(jmv.maxsim_scores(
        q, toks, mask)), rtol=TOL, atol=TOL)
    assert got[0] == 0.0
    with pytest.raises(NotImplementedError, match="slice 11"):
        tmv.maxsim_scores(q, toks, mask, mesh=object())


@pytest.mark.parametrize("allow", [False, True])
def test_fused_flat_rerank_matches_jax(allow):
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    n, f, t, tq, fetch, k = 200, 24, 4, 3, 16, 8
    corpus = rng.standard_normal((n, f)).astype(np.float32)
    valid = rng.random(n) < 0.95
    q = rng.standard_normal((2, f)).astype(np.float32)
    tokens = rng.standard_normal((n, t, DIMS)).astype(np.float32)
    tmask = rng.random((n, t)) < 0.8
    qt = rng.standard_normal((2, tq, DIMS)).astype(np.float32)
    qm = np.ones((2, tq), bool)
    al = rng.random(n) < 0.5 if allow else None
    ji, jd = jbeam.fused_flat_rerank(
        jdev.MaxSimRerank(), jnp.asarray(q), jnp.asarray(corpus),
        jnp.asarray(valid), jnp.asarray(qt), jnp.asarray(qm),
        jnp.asarray(tokens), jnp.asarray(tmask), fetch=fetch, k=k,
        allow=None if al is None else jnp.asarray(al), metric="dot",
        precision="fp32")
    ti, td = tbeam.fused_flat_rerank(
        tdev.MaxSimRerank(), q, torch.from_numpy(corpus),
        torch.from_numpy(valid), qt, qm, torch.from_numpy(tokens),
        torch.from_numpy(tmask), fetch=fetch, k=k, allow=al, metric="dot",
        precision="fp32")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=TOL, atol=TOL)


def _pair(rescore_limit=0, module=None):
    def cfg(mod):
        kw = dict(precision="fp32", rescore_limit=rescore_limit, dproj=8,
                  repetitions=6, initial_capacity=256)
        if module:
            kw["rerank"] = mod.RerankModuleConfig(module=module, max_tokens=8)
        return mod.MultiVectorIndexConfig(**kw)

    j = jmv.MultiVectorIndex(DIMS, cfg(jconfig))
    t = tmv.MultiVectorIndex(DIMS, cfg(config), device="cpu")
    sets = _sets(2, N_DOCS)
    for idx in (j, t):
        idx.add_batch_multi(np.arange(N_DOCS), sets)
    return j, t, sets


def _same(jr, tr):
    np.testing.assert_array_equal(tr.ids, jr.ids)
    np.testing.assert_allclose(tr.dists, jr.dists, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("module", [None, "rerank-linear"])
def test_search_multi_matches_jax_with_allow_and_deletes(module):
    j, t, sets = _pair(rescore_limit=24, module=module)
    queries = [s + 0.05 for s in sets[:6]]
    launches = trerank.rerank_topk_cuda.launches
    for q in queries:
        _same(j.search_multi(q, 5), t.search_multi(q, 5))
    allow = np.arange(N_DOCS) % 3 != 0
    for q in queries:
        tr = t.search_multi(q, 5, allow_list=allow)
        _same(j.search_multi(q, 5, allow_list=allow), tr)
        assert allow[tr.ids[tr.ids >= 0]].all()
    gone = np.arange(0, N_DOCS, 4)
    j.delete(gone)
    t.delete(gone)
    for q in queries:
        tr = t.search_multi(q, 5)
        _same(j.search_multi(q, 5), tr)
        assert not np.isin(tr.ids, gone).any()
    # single-vector queries are 1-token sets
    flat = np.stack([s[0] for s in sets[:3]])
    _same(j.search(flat, 4), t.search(flat, 4))
    _same(j.search_by_distance(flat, 0.0), t.search_by_distance(flat, 0.0))
    # the warm tier serves from the host planes
    assert t.demote_device() > 0 and j.demote_device() > 0
    for q in queries[:3]:
        _same(j.search_multi(q, 5), t.search_multi(q, 5))
    assert t.promote_device() > 0 and j.promote_device() > 0
    _same(j.search_multi(queries[0], 5), t.search_multi(queries[0], 5))
    assert trerank.rerank_topk_cuda.launches == launches  # CPU: plain


def test_checkpoint_both_directions(tmp_path):
    j, t, sets = _pair()
    q = sets[3] + 0.1
    j.save_vectors(str(tmp_path / "j"), {"seq": 5})
    t.save_vectors(str(tmp_path / "t"), {"seq": 6})
    for path, seq, want in (("j", 5, j), ("t", 6, t)):
        jj = jmv.MultiVectorIndex(DIMS, j.config)
        tt = tmv.MultiVectorIndex(DIMS, t.config, device="cpu")
        assert jj.load_vectors(str(tmp_path / path)) == {"seq": seq}
        assert tt.load_vectors(str(tmp_path / path)) == {"seq": seq}
        ref = want.search_multi(q, 6)
        _same(ref, jj.search_multi(q, 6))
        _same(ref, tt.search_multi(q, 6))
    # half a checkpoint is no checkpoint
    (tmp_path / "t.tokens").unlink()
    fresh = tmv.MultiVectorIndex(DIMS, t.config, device="cpu")
    assert fresh.load_vectors(str(tmp_path / "t")) is None


def _mv_cfg(mod):
    P, T = mod.Property, mod.DataType
    return mod.CollectionConfig(
        name="Colbert", properties=[P("bucket", T.INT)],
        vector_config=mod.MultiVectorIndexConfig(
            precision="fp32", dproj=8, repetitions=6, initial_capacity=256))


def _mv_objects(cls, sets):
    out = []
    for i, s in enumerate(sets):
        u = f"{i:08x}-0000-4000-8000-{i:012x}"
        out.append(cls(uuid=u, collection="Colbert", vector=s,
                       properties={"bucket": i % 10}))
    return out


def test_multivector_collection_through_db(tmp_path):
    """A multivector collection in each package's DB, the same objects:
    the same uuids and distances, filtered or not; a JAX-written directory
    opens in the port and the reverse."""
    sets = _sets(5, 60, hi=6)
    jdb = JaxDB(str(tmp_path / "j"))
    tdb = DB(str(tmp_path / "t"), device="cpu")
    jcol = jdb.create_collection(_mv_cfg(jconfig))
    tcol = tdb.create_collection(_mv_cfg(config))
    jcol.put_batch(_mv_objects(JaxObject, sets))
    tcol.put_batch(_mv_objects(StorageObject, sets))
    q = sets[7] + 0.05

    def answers(col, flt=None):
        return [(o.uuid, d) for o, d in col.vector_search(q, 5, flt=flt)]

    from weaviate_tpu.inverted.filters import Where as JWhere
    from weaviate_tpu_torch.inverted.filters import Where

    for jf, tf in ((None, None), (JWhere.lt("bucket", 5),
                                  Where.lt("bucket", 5))):
        ja, ta = answers(jcol, jf), answers(tcol, tf)
        assert [u for u, _ in ta] == [u for u, _ in ja] and ja
        np.testing.assert_allclose([d for _, d in ta], [d for _, d in ja],
                                   rtol=TOL, atol=TOL)
    want = answers(jcol)
    jdb.close()
    tdb.close()
    # each package opens the other's directory
    t2 = DB(str(tmp_path / "j"), device="cpu")
    j2 = JaxDB(str(tmp_path / "t"))
    for db in (t2, j2):
        got = [(o.uuid, d) for o, d in
               db.get_collection("Colbert").vector_search(q, 5)]
        assert [u for u, _ in got] == [u for u, _ in want]
        np.testing.assert_allclose([d for _, d in got], [d for _, d in want],
                                   rtol=TOL, atol=TOL)
        db.close()
