"""Parity: the port's quantized scans and quantized flat index against the
JAX package's, on the CPU.

- ``bq_search`` (kernel Q1's plain version, taken for CPU tensors): ids and
  distances equal to JAX ``bq_search``, with a mask, a chunk smaller than N
  with a ragged tail, ``k`` past the live rows and many ties (D = 16 sign
  bits). Hamming distances are exact integers on both sides.
- ``sq_search`` (Q2's plain version) for l2-squared, dot and cosine:
  distances within rtol 1e-5, atol 1e-4 (float32 sums of the same bf16
  products in another order, and l2-squared's cancellation) and ids equal
  on >= 0.99 of the slots, every other id a near tie.
- The frontier gathers: BQ equal, SQ within the same tolerance.
- The kernels' order keys: ``keys_to_dists`` inverts the float -> key
  transform of ``csrc/quantized.cu`` (written here in numpy).
- The merge (``merge_partials``, the half of a search after the scan; CPU
  tensors take its plain version) over per-split partials as the scan
  leaves them (``split_partials_plain``) gives JAX ``bq_search``'s ids and
  distances exactly: ties, ``k`` = N, splits shorter than ``k``, a wholly
  masked split, one split, ``k`` = ``MAX_K``.
- ``QuantizedFlatIndex`` (``make_flat`` with BQ or SQ): the same ids as the
  JAX index, distances within 1e-5, before the quantizer is fitted (exact
  host route), after it, after deletes and under a filter, for cosine with
  scaled queries, and padded to k (the cases of
  ``tests/test_compression.py``).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from weaviate_tpu.index.flat import make_flat as jmake_flat
from weaviate_tpu.ops import quantized as jq
from weaviate_tpu.schema import config as jconfig
from weaviate_tpu_torch.compression import BinaryQuantizer, ScalarQuantizer
from weaviate_tpu_torch.index.flat import QuantizedFlatIndex, make_flat
from weaviate_tpu_torch.ops import quantized as tq
from weaviate_tpu_torch.ops.distance import MASK_DISTANCE
from weaviate_tpu_torch.schema import config

import probe_quantized as probe

# float32 sums of the same bf16 products in another order; l2-squared adds
# the cancellation of q.q - 2 q.x + x.x at |q|^2 of about 50 (a few ulps)
SQ_RTOL, SQ_ATOL = 1e-5, 1e-4
MIN_ID_AGREEMENT = 0.99


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _rows(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _bq_planes(n, d, b, seed=0):
    from weaviate_tpu.compression.quantizers import BinaryQuantizer as JBQ

    quant = JBQ(d, "l2-squared")
    enc = quant.encode(_rows(seed, n, d))
    q = np.asarray(quant.prep(_rows(seed + 1, b, d)))
    return q, enc["packed"], enc["popcount"]


@pytest.mark.parametrize("n,d,k,chunk,masked", [
    (3000, 64, 10, 0, 0.0),
    (3000, 64, 40, 700, 0.3),     # chunks of 700, a ragged tail of 200
    (1000, 16, 50, 300, 0.5),     # 16 bits: ties on nearly every slot
    (200, 25, 300, 64, 0.5),      # k past the rows and the live rows
    (500, 100, 20, 128, 1.0),     # everything masked
])
def test_bq_search_equals_jax(n, d, k, chunk, masked):
    import jax.numpy as jnp

    q, packed, pop = _bq_planes(n, d, 8)
    mask = np.random.default_rng(2).random(n) >= masked
    jd, ji = jq.bq_search(jnp.asarray(q), jnp.asarray(packed),
                          jnp.asarray(pop), jnp.asarray(mask), d, k, chunk)
    before = tq.bq_search.launches
    td, ti = tq.bq_search(torch.from_numpy(q.view(np.int32).copy()),
                          torch.from_numpy(packed.view(np.int32).copy()),
                          torch.from_numpy(pop), torch.from_numpy(mask), d,
                          k, chunk)
    assert tq.bq_search.launches == before  # CPU tensors: the plain version
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert ((ti.numpy() == -1) == (td.numpy() >= MASK_DISTANCE)).all()


def _sq_planes(n, d, metric, b=8, seed=3):
    from weaviate_tpu.compression.quantizers import ScalarQuantizer as JSQ

    rows = _rows(seed, n, d)
    q = rows[:b] + 0.1 * _rows(seed + 1, b, d)
    if metric in ("dot", "cosine"):
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    quant = JSQ(d, metric)
    quant.fit(rows)
    enc = quant.encode(rows)
    return q, enc["codes"], enc["dec_sqnorm"], quant.a, quant.s


@pytest.mark.parametrize("metric", ["l2-squared", "dot", "cosine"])
@pytest.mark.parametrize("chunk,masked", [(0, 0.0), (900, 0.3)])
def test_sq_search_matches_jax(metric, chunk, masked):
    import jax.numpy as jnp

    n, d, k = 2500, 48, 30
    q, codes, dsq, a, s = _sq_planes(n, d, metric)
    mask = np.random.default_rng(4).random(n) >= masked
    jd, ji = jq.sq_search(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(dsq),
                          jnp.float32(a), jnp.float32(s), jnp.asarray(mask),
                          metric, k, chunk)
    td, ti = tq.sq_search(torch.from_numpy(q), torch.from_numpy(codes),
                          torch.from_numpy(dsq), a, s, torch.from_numpy(mask),
                          metric, k, chunk)
    jd, ji, td, ti = np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy()
    np.testing.assert_allclose(td, jd, rtol=SQ_RTOL, atol=SQ_ATOL)
    same = ti == ji
    assert same.mean() >= MIN_ID_AGREEMENT, same.mean()
    # where ids differ, the two distances at that slot are a float tie
    np.testing.assert_allclose(td[~same], jd[~same], rtol=SQ_RTOL, atol=SQ_ATOL)


def test_frontier_gathers_match_jax():
    import jax.numpy as jnp

    q, packed, pop = _bq_planes(400, 70, 6)
    ids = np.random.default_rng(5).integers(0, 400, (6, 11)).astype(np.int32)
    jd = jq.bq_gather_distance(jnp.asarray(q), jnp.asarray(packed),
                               jnp.asarray(ids), jnp.asarray(pop), 70)
    td = tq.bq_gather_distance(torch.from_numpy(q.view(np.int32).copy()),
                               torch.from_numpy(packed.view(np.int32).copy()),
                               torch.from_numpy(ids), torch.from_numpy(pop),
                               70)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    for metric in ("l2-squared", "dot", "cosine"):
        q, codes, dsq, a, s = _sq_planes(400, 40, metric, b=6)
        jd = jq.sq_gather_distance(jnp.asarray(q), jnp.asarray(codes),
                                   jnp.asarray(ids), jnp.asarray(dsq),
                                   jnp.float32(a), jnp.float32(s), metric)
        td = tq.sq_gather_distance(torch.from_numpy(q),
                                   torch.from_numpy(codes),
                                   torch.from_numpy(ids),
                                   torch.from_numpy(dsq), a, s, metric)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=SQ_RTOL,
                                   atol=SQ_ATOL)


def test_order_keys_invert_to_the_distances():
    """The kernels write uint32 keys whose unsigned order is float order
    (``order_key`` in csrc/quantized.cu); the host maps the selected keys
    back to distances."""
    f = np.array([0.0, -0.0, 1.5, -1.5, 3e-39, -3e-39, MASK_DISTANCE, -7.25,
                  1e10, -1e10], np.float32)
    key = _order_keys(f).view(np.uint32)
    back = tq.keys_to_dists(torch.from_numpy(key.view(np.int32)))
    want = np.where(f == 0, np.float32(0.0), f)
    np.testing.assert_array_equal(back.numpy().view(np.uint32),
                                  want.view(np.uint32))
    order = np.argsort(key, kind="stable")
    assert (np.diff(f[order]) >= 0).all()
    assert tq._key_order(torch.from_numpy(key.view(np.int32))).tolist() == \
        key.astype(np.int64).tolist()


def test_scan_wrappers_check_their_inputs_on_the_cpu():
    """CPU tensors take the plain versions, whose launch counters stay; the
    kernels' argument checks refuse what they do not take; a search is one
    scan launch and one merge launch at any shape."""
    q, packed, pop = _bq_planes(50, 40, 2)
    qt = torch.from_numpy(q.view(np.int32).copy())
    pt = torch.from_numpy(packed.view(np.int32).copy())
    with pytest.raises(ValueError, match="words"):
        tq.bq_search_cuda(qt, pt, torch.from_numpy(pop), None, 70, 5)
    with pytest.raises(ValueError, match="k="):
        tq.bq_search_cuda(qt, pt, torch.from_numpy(pop), None, 40,
                          tq.MAX_K + 1)
    with pytest.raises(ValueError, match="metric"):
        tq.sq_search(torch.zeros(2, 8), torch.zeros((5, 8), dtype=torch.uint8),
                     torch.zeros(5), 0.0, 1.0, None, "manhattan", 3)
    plan = tq.scan_plan("bq", 2, 50, 5)
    lists = tq._lists(plan, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="cand_keys"):
        tq.bq_scan_cuda(qt, pt, torch.from_numpy(pop), None, 40, 5, plan,
                        torch.empty((1, 3, plan.cap), dtype=torch.int32),
                        lists[1])
    # the phase-quant and phase-pq searches: every query in one scan
    # launch; the code scans' CTAs hold all 256 queries
    assert tq.scan_plan("bq", 256, 10_002_432, 320) == (132, 75_776, 704)
    assert tq.scan_plan("sq", 256, 552_960, 200) == (131, 4_224, 544)
    assert tq.scan_plan("rq", 256, 550_000, 200) == (131, 4_224, 544)
    assert tq.scan_plan("pq", 256, 1_000_000, 40) == (131, 7_680, 384)
    # k = MAX_K: fewer splits keep the lists under LIST_BYTES
    big = tq.scan_plan("bq", 256, 10_002_432, tq.MAX_K)
    assert big.splits * 256 * big.cap * 8 <= tq.LIST_BYTES
    assert tq.search_launches() == {"scan": 1, "merge": 1}
    for kind, b, n, k in (("bq", 256, 10_002_432, 320),
                          ("sq", 256, 552_960, 200), ("bq", 257, 300, 4096),
                          ("sq", 53, 100_000, 10), ("pq", 257, 50_001, 4096),
                          ("rq", 1, 300, 10)):
        p = tq.scan_plan(kind, b, n, k)
        assert p.split_rows % tq.ROWS_TILE[kind] == 0
        assert (p.splits - 1) * p.split_rows < n <= p.splits * p.split_rows
        assert p.cap >= k + tq.ROWS_TILE[kind]


@pytest.mark.parametrize("b,n,k", [(0, 50, 5), (2, 0, 5), (2, 50, 0),
                                   (2, 50, tq.MAX_K + 1)],
                         ids=["no_queries", "no_rows", "k0", "k_over_max"])
def test_scan_plan_refuses_what_no_kernel_takes(b, n, k):
    # the plan is the first step of a search on the card: it refuses an
    # empty scan or a k outside [1, MAX_K] before anything is allocated
    for kind in ("bq", "sq", "pq", "rq"):
        with pytest.raises(ValueError, match="empty scan|k="):
            tq.scan_plan(kind, b, n, k)


def test_plan_reads_the_kernels_tiles_from_their_source():
    # the tiles and occupancy the plan uses are those csrc/quantized.cu
    # launches with: one definition each in the source
    src = (Path(tq.__file__).resolve().parents[1] / "csrc"
           / "quantized.cu").read_text()
    for name, value in (("kQT", tq.QUERY_TILE["bq"]),
                        ("kBqR", tq.ROWS_TILE["bq"]),
                        ("kBqCtasPerSm", tq.CTAS_PER_SM["bq"]),
                        ("kWgQT", tq.QUERY_TILE["sq"]),
                        ("kWgR", tq.ROWS_TILE["sq"]),
                        ("kWgCtasPerSm", tq.CTAS_PER_SM["sq"])):
        assert src.count(f"constexpr int {name} = {value};") == 1, name
    # Q2, Q3 and Q4 share the warp-specialized template's tiles
    for kind in ("pq", "rq"):
        assert tq.QUERY_TILE[kind] == tq.QUERY_TILE["sq"]
        assert tq.ROWS_TILE[kind] == tq.ROWS_TILE["sq"]
        assert tq.CTAS_PER_SM[kind] == tq.CTAS_PER_SM["sq"]
    assert "__launch_bounds__(kThreads, kBqCtasPerSm)" in src
    assert "__launch_bounds__(kWgThreads, kWgCtasPerSm)" in src


def _order_keys(f: np.ndarray) -> np.ndarray:
    """float32 -> the kernels' uint32 order keys as int32 (``order_key`` in
    csrc/quantized.cu: -0 as +0, negatives bit-flipped, others signed)."""
    u = f.astype(np.float32).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    key = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    return key.view(np.int32)


def _bq_keys(q, packed, mask, d):
    """Order keys [B, N] of the exact hamming distances, NONE_KEY where
    masked."""
    bits = lambda w: ((w[..., None] >> np.arange(32, dtype=np.uint32)) & 1
                      ).reshape(len(w), -1)[:, :d]  # noqa: E731
    ham = (bits(q)[:, None, :] != bits(packed)[None, :, :]).sum(-1)
    keys = _order_keys(ham.astype(np.float32))
    return torch.from_numpy(np.where(mask[None, :], keys, tq.NONE_KEY))


def _plan(kind, b, n, k, splits=None, split_rows=None, sms=None):
    if sms is not None:
        return tq.scan_plan(kind, b, n, k, sms)
    return tq.ScanPlan(splits, split_rows, k + tq.ROWS_TILE[kind])


@pytest.mark.parametrize("n,d,k,masked,plan", [
    # 16 bits: ties on nearly every slot, 8 splits
    (1000, 16, 50, 0.5, dict(sms=4)),
    # k = N, the tail masked; 4 splits of 64 rows
    (200, 25, 200, 0.3, dict(sms=2)),
    # every split shorter than k
    (700, 64, 100, 0.0, dict(splits=11, split_rows=64)),
    # split 1 wholly masked
    (1024, 40, 30, "split1", dict(splits=4, split_rows=256)),
    # one split
    (900, 70, 40, 0.2, dict(splits=1, split_rows=960)),
    # k = MAX_K over N > MAX_K
    (5000, 25, 4096, 0.1, dict(sms=8)),
    # every split's list full: k taken entries, no padding
    (1024, 64, 60, 0.0, dict(splits=4, split_rows=256)),
    # 6 bits: the k-th distance tied across every split, few of them kept
    (1024, 6, 45, 0.1, dict(splits=4, split_rows=256)),
], ids=["ties16", "k_eq_n", "splits_short_of_k", "masked_split",
        "one_split", "max_k", "every_split_full",
        "ties_at_kth_across_splits"])
def test_merge_of_split_partials_gives_jax_bq_search(n, d, k, masked, plan):
    """The half of a search that follows the scan: each split's k smallest
    (order key, row) in row order, as the scan leaves them, merged
    (``merge_partials``; CPU tensors take its plain version) give JAX
    ``bq_search``'s ids and distances: ties keep the lower row."""
    import jax.numpy as jnp

    q, packed, pop = _bq_planes(n, d, 8)
    rng = np.random.default_rng(5)
    if masked == "split1":
        mask = rng.random(n) >= 0.2
        mask[256:512] = False
    else:
        mask = rng.random(n) >= masked
    jd, ji = jq.bq_search(jnp.asarray(q), jnp.asarray(packed),
                          jnp.asarray(pop), jnp.asarray(mask), d, k, 0)
    sp = _plan("bq", len(q), n, k, **plan)
    assert sp.splits * sp.split_rows >= n > (sp.splits - 1) * sp.split_rows
    keys = _bq_keys(q, packed, mask, d)
    ck, cr = tq.split_partials_plain(keys, k, sp)
    assert ck.shape == (sp.splits, len(q), k)
    # each partial: taken keys first, in row order, then padding
    taken = ck != tq.NONE_KEY
    assert (cr[taken] >= 0).all() and (cr[~taken] == -1).all()
    assert (taken[..., :-1] | ~taken[..., 1:]).all()
    if masked == "split1":
        assert not taken[1].any()
    if masked == 0.0 and sp.split_rows >= k:
        assert taken.all()  # every split full
    if d == 6:
        # the k-th key sits in every split's list, kept from fewer
        jdn = np.array(jd)
        at_kth = ck == torch.from_numpy(_order_keys(jdn[:, k - 1]))[
            None, :, None]
        assert at_kth.any(-1).all()
        kept = (jdn == jdn[:, k - 1:k]).sum(1)
        assert (at_kth.sum((0, 2)).numpy() > kept).all()
    before = tq.merge_partials.launches
    td, ti = tq.merge_partials(ck, cr, k)
    assert tq.merge_partials.launches == before
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("old,new", [
    e for name in probe.COPIES for e in probe.COPIES[name]], ids=[
        f"{name}{i}" for name in probe.COPIES
        for i in range(len(probe.COPIES[name]))])
def test_probe_copies_apply_to_the_kernel_source(old, new):
    # probe_quantized.py's copies replace text the kernel source holds
    # exactly once, so a kernel edit that drops one fails here
    src = probe.SOURCE.read_text()
    assert src.count(old) == 1, repr(old)
    assert probe.edited([(old, new)]) != src


@pytest.mark.parametrize("old,new", [
    e for name in probe.MERGE_COPIES for e in probe.MERGE_COPIES[name]]
    + probe.MERGE_COUNTERS, ids=[
        f"{name}{i}" for name in probe.MERGE_COPIES
        for i in range(len(probe.MERGE_COPIES[name]))] + [
        f"merge_counters{i}" for i in range(len(probe.MERGE_COUNTERS))])
def test_probe_merge_copies_apply_to_the_kernel_source(old, new):
    # ``probe_quantized.py --merge``: its copies of the merge with a part
    # switched off and its clock64 copy replace text the kernel source holds
    # exactly once
    src = probe.SOURCE.read_text()
    assert src.count(old) == 1, repr(old)
    assert probe.edited([(old, new)]) != src
    # each copy's edits apply together
    for edits in [*probe.MERGE_COPIES.values(), probe.MERGE_COUNTERS]:
        probe.edited(edits)


# -- the quantized flat index -------------------------------------------------


def _clustered(seed, n, d, clusters=32, spread=0.15):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, d)).astype(np.float32)
    assign = rng.integers(0, clusters, size=n)
    return (centers[assign] + spread * rng.standard_normal((n, d))).astype(
        np.float32)


def _pair(kind, d, metric, **kw):
    jc = {"bq": jconfig.BQConfig, "sq": jconfig.SQConfig}[kind](**kw)
    tc = {"bq": config.BQConfig, "sq": config.SQConfig}[kind](**kw)
    j = jmake_flat(d, jconfig.FlatIndexConfig(distance=metric, quantizer=jc,
                                              search_chunk_size=1024))
    t = make_flat(d, config.FlatIndexConfig(distance=metric, quantizer=tc,
                                            search_chunk_size=1024),
                  device="cpu")
    assert isinstance(t, QuantizedFlatIndex)
    return j, t


def _same_results(jr, tr):
    np.testing.assert_array_equal(tr.ids, jr.ids)
    np.testing.assert_allclose(tr.dists, jr.dists, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind,metric", [
    ("bq", "l2-squared"), ("bq", "cosine"), ("bq", "dot"),
    ("sq", "l2-squared"), ("sq", "cosine"), ("sq", "dot"),
])
def test_quantized_flat_index_matches_jax(kind, metric):
    """After fit, after deletes and under a filter: JAX's ids."""
    n, d = 3000, 48
    corpus = _clustered(1, n, d)
    q = corpus[::97][:16] + 0.02 * _rows(2, 16, d)
    j, t = _pair(kind, d, metric, rescore_limit=40)
    for idx in (j, t):
        idx.add_batch(np.arange(n), corpus)
    assert t.quantizer.fitted and j.quantizer.fitted
    _same_results(j.search(q, 10), t.search(q, 10))
    gone = np.arange(0, n, 5)
    allow = np.arange(n) % 3 != 0
    for idx in (j, t):
        idx.delete(gone)
    jr, tr = j.search(q, 10, allow_list=allow), t.search(q, 10, allow)
    _same_results(jr, tr)
    live = tr.ids[tr.ids >= 0]
    assert allow[live].all() and not np.isin(live, gone).any()
    assert t.count() == j.count() == n - len(gone)
    assert t.stats() == j.stats()


def test_quantized_flat_prefit_exact_and_pads_to_k():
    """Below min_training the SQ index answers exactly from the host
    originals, padded to k, as JAX's does."""
    corpus = _rows(3, 50, 16)
    j, t = _pair("sq", 16, "l2-squared")
    for idx in (j, t):
        idx.add_batch(np.arange(50), corpus)
    assert not t.quantizer.fitted
    tr = t.search(corpus[:5], 1)
    np.testing.assert_array_equal(tr.ids[:, 0], np.arange(5))
    _same_results(j.search(corpus[:5], 3), t.search(corpus[:5], 3))
    j2, t2 = _pair("sq", 16, "l2-squared")
    for idx in (j2, t2):
        idx.add_batch(np.arange(5), corpus[:5])
    jr, tr = j2.search(corpus[:2], 10), t2.search(corpus[:2], 10)
    assert tr.ids.shape == (2, 10) and (tr.ids[:, 5:] == -1).all()
    _same_results(jr, tr)


@pytest.mark.parametrize("kind", ["bq", "sq"])
def test_quantized_flat_cosine_with_scaled_queries(kind):
    corpus = _clustered(4, 600, 32)
    j, t = _pair(kind, 32, "cosine")
    for idx in (j, t):
        idx.add_batch(np.arange(600), corpus)
    q = corpus[:8] * 3.0
    jr, tr = j.search(q, 1), t.search(q, 1)
    _same_results(jr, tr)
    if kind == "sq":
        np.testing.assert_array_equal(tr.ids[:, 0], np.arange(8))


@pytest.mark.parametrize("kind,floor", [("sq", 0.95), ("bq", 0.60)])
def test_quantized_flat_recall_floor(kind, floor):
    n, d, k = 3000, 64, 10
    corpus = _clustered(5, n, d)
    rng = np.random.default_rng(6)
    q = (corpus[rng.choice(n, 32, replace=False)]
         + 0.02 * rng.standard_normal((32, d))).astype(np.float32)
    t = make_flat(d, config.FlatIndexConfig(
        distance="l2-squared", quantizer=config.SQConfig(rescore_limit=80)
        if kind == "sq" else config.BQConfig(rescore_limit=150)),
        device="cpu")
    t.add_batch(np.arange(n), corpus)
    d2 = ((q[:, None, :] - corpus[None]) ** 2).sum(-1)
    want = np.argsort(d2, axis=1)[:, :k]
    got = t.search(q, k).ids
    r = np.mean([len(set(got[i]) & set(want[i])) / k for i in range(32)])
    assert r >= floor


def test_quantized_flat_warm_tier_serves_from_the_host_originals():
    corpus = _clustered(7, 800, 24)
    _, t = _pair("sq", 24, "l2-squared")
    t.add_batch(np.arange(800), corpus)
    q = corpus[:6] + 0.01
    want = t.search(q, 5)
    freed = t.demote_device()
    assert freed > 0 and not t.device_resident and t.hbm_bytes() == 0
    warm = t.search(q, 5)
    np.testing.assert_array_equal(warm.ids, want.ids)
    assert t.promote_device() == freed
    np.testing.assert_array_equal(t.search(q, 5).ids, want.ids)
    assert isinstance(BinaryQuantizer(8, "dot").encode_device(
        torch.zeros(1, 8))["packed"], torch.Tensor)
    assert ScalarQuantizer(8, "dot").min_training == 256


@pytest.mark.parametrize("kind,n,k", [("bq", 4_194_304, 320),
                                      ("sq", 550_000, 200),
                                      ("rq", 550_000, 200),
                                      ("pq", 1_000_000, 40)])
def test_merge_stages_the_phases_fullest_lists(kind, n, k):
    """The merge kernel stages a query's taken keys in shared memory
    (``merge_stage_cap``, from ``kMergeSmem`` of the source) whenever they
    fit: at the four scans' plans of phase ``quant``'s and ``pq``'s shapes
    (B = 256, 132 SMs) even lists with every split full fit, so the search
    never takes the streaming path; past the fit the capacity is the
    shared memory's."""
    src = (Path(tq.__file__).resolve().parents[1] / "csrc"
           / "quantized.cu").read_text()
    assert src.count(f"constexpr int kMergeSmem = {tq.MERGE_SMEM};") == 1
    plan = tq.scan_plan(kind, 256, n, k, 132)
    assert plan.splits <= tq.MERGE_MAX_SPLITS
    full = tq.merge_places([k] * plan.splits)
    assert full == plan.splits * (-(-k // 4) * 4)
    assert full <= tq.merge_stage_cap(plan.splits, k)
    # a split's places start at multiples of 4
    assert tq.merge_places([1, 2, 3, 4, 5]) == 4 + 4 + 4 + 4 + 8
    big = tq.merge_stage_cap(plan.splits, tq.MAX_K)
    assert big < plan.splits * tq.MAX_K and big % 4 == 0
