"""The HFresh index (port slice 7b) against the JAX package on the CPU.

- ``posting_topk_plain`` (kernel B9a's plain version) against the JAX
  program it replaces (``gather_distance`` at fp32, the valid/mask
  ``where``, ``lax.top_k`` of the negated distances) for every metric, on
  candidates with exact duplicate rows (ties), dead store rows, wholly
  masked query rows and k past the candidate count: columns equal,
  distances within 1e-5 + 1e-5 |d| (float32 sums in another order).
- Candidates drawn as postings (``posting_table``, ``posting_operands``):
  a numpy model of the kernels' three passes (the inverse, a count a
  posting in any order of the probes, then the scans and the scatter;
  scoring by posting tile in any order of the tiles, each pair's column
  by a binary search, replicas written twice; the select's radix passes
  over 64-bit keys with masked columns taken as the mask's key) equal to
  the plain version and the JAX program, and of the select alone against
  the plain version's stable sort; the operands as the index builds them
  against its probes and posting snapshot, the device table kept until
  the postings change.
- ``HFreshIndex`` against JAX's on each scenario of
  ``tests/test_hfresh_offload.py`` (its frozen-tenant case belongs to
  slice 9): after the same batches the centroids and postings are equal
  (host numpy code on the same float32 rows), searches give equal ids and
  distances within 1e-5 + 1e-5 |d|; a checkpoint written by either opens
  in the other; ``interop.hfresh_from_numpy`` answers as the JAX index.
  The JAX index's ``store.get`` is a numpy gather of the same rows in these
  tests (``_host_gather``): its device gather compiles once per id count.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import probe_hfresh
from weaviate_tpu.core.shard import Shard as JaxShard
from weaviate_tpu.index.hfresh import HFreshIndex as JaxHFresh
from weaviate_tpu.ops.distance import gather_distance as jgather
from weaviate_tpu.schema import config as jconfig
from weaviate_tpu.storage.objects import StorageObject as JaxObject
from weaviate_tpu_torch import interop
from weaviate_tpu_torch.core.shard import Shard, build_vector_index
from weaviate_tpu_torch.index.hfresh import HFreshIndex
from weaviate_tpu_torch.ops import hfresh as thf
from weaviate_tpu_torch.ops.distance import MASK_DISTANCE, METRICS
from weaviate_tpu_torch.schema import config
from weaviate_tpu_torch.storage.objects import StorageObject

TOL = dict(rtol=1e-5, atol=1e-5)


# -- B9a's plain version and the kernel's selection --------------------------


def _b9_inputs(seed, metric, b=20, n=120, d=12, c=64):
    """Queries, a corpus with exact duplicate rows, a valid mask with dead
    rows, and candidates drawn as postings: each query's candidates the
    sorted union (as np.unique gives) of the 3 postings it probes, padded
    to ``c`` columns and masked there. Posting 0 is probed by every query
    (more queries and rows than a scoring tile's), 1 and 2 share two rows (query 1 reaches
    them through both), 3 is empty (probed by query 2), 4 is probed by
    none; query 1's query equals corpus[3] and sees its twins; query 2 is
    wholly masked and a third of query 4's columns are off (an allow
    list). -> (q, corpus, valid, cand, mask, the numpy ``Postings``)."""
    rng = np.random.default_rng(seed)
    if metric == "hamming":
        corpus = rng.integers(0, 3, (n, d)).astype(np.float32)
        q = rng.integers(0, 3, (b, d)).astype(np.float32)
    else:
        corpus = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((b, d)).astype(np.float32)
    corpus[10:20] = corpus[3]            # duplicates: exact ties
    q[1] = corpus[3]
    if metric == "cosine":
        corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    valid = rng.random(n) < 0.85
    valid[3] = valid[12] = True
    postings = [rng.choice(n, 6, replace=False) for _ in range(12)]
    postings[0] = rng.choice(np.arange(60, n), thf.TILE_ROWS + 2,
                             replace=False)
    postings[1] = np.r_[3, 10, 11, 12, 40, 41]
    postings[2] = np.r_[40, 41, rng.choice(np.arange(50, 90), 4,
                                           replace=False)]
    postings[3] = np.empty(0, np.int64)
    probe = np.stack([np.r_[0, 5 + rng.choice(7, 2, replace=False)]
                      for _ in range(b)])
    probe[1, 1:] = (1, 2)
    probe[2, 1] = 3
    cand_lists = [np.unique(np.concatenate([postings[p] for p in row]))
                  for row in probe]
    cand = np.full((b, c), n - 1, np.int64)  # padding keeps a row sorted
    mask = np.zeros((b, c), bool)
    for i, ids in enumerate(cand_lists):
        assert len(ids) <= c
        cand[i, :len(ids)] = ids
        mask[i, :len(ids)] = True
    mask[2] = False                       # a wholly masked row
    mask[4, rng.random(c) < 1 / 3] = False
    q_t, cand_t, mask_t, posts = thf.posting_operands(
        q, cand, mask, probe, thf.posting_table(postings, n), n)
    np.testing.assert_array_equal(q_t.numpy(), q)
    np.testing.assert_array_equal(cand_t.numpy(), cand)
    np.testing.assert_array_equal(mask_t.numpy(), mask)
    return q, corpus, valid, cand, mask, posts


def _jax_b9(q, corpus, valid, cand, mask, k, metric):
    rows = jnp.asarray(np.clip(cand, 0, corpus.shape[0] - 1).astype(np.int32))
    dj = jgather(jnp.asarray(q), jnp.asarray(corpus), rows, metric)
    live = jnp.take(jnp.asarray(valid), rows)
    dj = jnp.where(jnp.asarray(mask) & live, dj, jnp.float32(MASK_DISTANCE))
    neg, sel = jax.lax.top_k(-dj, min(k, cand.shape[1]))
    return np.asarray(-neg), np.asarray(sel)


def _torch_b9(fn, q, corpus, valid, cand, mask, posts, k, metric):
    d, c = fn(torch.from_numpy(q), torch.from_numpy(corpus),
              torch.from_numpy(valid), torch.from_numpy(cand.astype(np.int32)),
              torch.from_numpy(mask), k, metric, posts)
    return d.numpy(), c.numpy()


@pytest.mark.parametrize("k", [5, 17, 1000])
@pytest.mark.parametrize("metric", METRICS)
def test_plain_matches_jax(metric, k):
    args = _b9_inputs(3, metric)
    jd, jc = _jax_b9(*args[:5], k, metric)
    td, tc = _torch_b9(thf.posting_topk, *args, k, metric)
    assert tc.dtype == np.int32 and td.dtype == np.float32
    assert tc.shape == jc.shape == (args[3].shape[0], min(k, 64))
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(td, jd, **TOL)
    assert (td[2] == MASK_DISTANCE).all()


def _order_key(d: np.ndarray) -> np.ndarray:
    """The kernel's 32-bit order-preserving bits of float32 distances (-0
    taken as +0)."""
    u = np.where(d == 0, np.float32(0), d).astype(np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _keys(dists: np.ndarray) -> np.ndarray:
    """The kernel's 64-bit keys of a [B, C] block: the distance's order
    bits, then the column."""
    b, c = dists.shape
    return (_order_key(dists).astype(np.uint64) << np.uint64(32)) \
        | np.arange(c, dtype=np.uint64)[None, :]


def _select(keys: np.ndarray, kk: int):
    """The select pass on one row's keys: the kk-th smallest by radix
    passes of 8 bits from the top, stopping at the first pass whose chosen
    bin holds exactly the keys still wanted; the keys not above it,
    each placed by its count of smaller kept keys. -> (kept keys in order,
    passes taken)."""
    prefix, pmask, want = np.uint64(0), np.uint64(0), kk
    passes = 0
    for shift in range(56, -8, -8):
        passes += 1
        sh = np.uint64(shift)
        live = keys[(keys & pmask) == prefix]
        hist = np.bincount(((live >> sh) & np.uint64(0xff)).astype(
            np.int64), minlength=256)
        cum = np.cumsum(hist)
        binv = int(np.searchsorted(cum, want))
        below = int(cum[binv - 1]) if binv else 0
        whole = below + int(hist[binv]) == want
        want -= below
        prefix |= np.uint64(binv) << sh
        pmask |= np.uint64(0xff) << sh
        if whole:
            if shift:
                prefix |= (np.uint64(1) << sh) - np.uint64(1)
            break
    sel = keys[keys <= prefix]
    assert len(sel) == kk
    rank = (sel[None, :] < sel[:, None]).sum(1)
    out = np.zeros(kk, np.uint64)
    out[rank] = sel
    return out, passes


def _unkey(keys: np.ndarray):
    """(distances, columns) of keys."""
    u = (keys >> np.uint64(32)).astype(np.uint32)
    bits = np.where(u & 0x80000000, u & 0x7fffffff, ~u).astype(np.uint32)
    return bits.view(np.float32), (keys & np.uint64(0xffffffff)).astype(
        np.int32)


def _b9a_model(dists: np.ndarray, k: int):
    """The kernel's select pass in numpy over a [B, C] distance block."""
    b, c = dists.shape
    kk = min(k, c)
    out_d = np.zeros((b, kk), np.float32)
    out_c = np.zeros((b, kk), np.int32)
    keys = _keys(dists)
    for r in range(b):
        out_d[r], out_c[r] = _unkey(_select(keys[r], kk)[0])
    return out_d, out_c


@pytest.mark.parametrize("k", [1, 10, 40, 64])
def test_kernel_selection_model_matches_plain(k):
    """Ties (duplicates and masked columns), -0 against +0, negative
    distances: the kernel's selection in numpy equals the stable sort."""
    q, corpus, valid, cand, mask, _ = _b9_inputs(5, "dot")
    dt = thf.gather_distance(torch.from_numpy(q), torch.from_numpy(corpus),
                             torch.from_numpy(cand), "dot")
    live = torch.from_numpy(valid)[torch.from_numpy(cand)]
    d = torch.where(torch.from_numpy(mask) & live, dt, MASK_DISTANCE).numpy()
    d[0, :6] = [0.0, -0.0, 0.0, -0.0, -1.5, -1.5]
    pd, pc = thf.smallest_k(torch.from_numpy(d), min(k, d.shape[1]))
    md, mc = _b9a_model(d, k)
    np.testing.assert_array_equal(mc, pc.numpy())
    np.testing.assert_array_equal(md, pd.numpy())


def _invert(posts, rng):
    """The inverse pass in numpy: a count a posting taken in a random
    order of the probes (the atomics' order), the exclusive scans of the
    counts and of each posting's tiles, each probe's query scattered to
    its place, each tile's posting. -> (qlist, qstart, tstart,
    tile_post)."""
    probe, (rows, off, _) = posts
    probe, off = probe.numpy().reshape(-1), off.numpy()
    nprobe = posts.probe.shape[1]
    cnt = np.zeros(len(off) - 1, np.int64)
    pos = np.zeros(len(probe), np.int64)
    for i in rng.permutation(len(probe)):
        pos[i] = cnt[probe[i]]
        cnt[probe[i]] += 1
    tiles = -(-cnt // thf.TILE_QUERIES) * -(-np.diff(off) // thf.TILE_ROWS)
    qstart = np.r_[0, np.cumsum(cnt)]
    tstart = np.r_[0, np.cumsum(tiles)]
    qlist = np.empty(len(probe), np.int64)
    qlist[qstart[probe] + pos] = np.arange(len(probe)) // nprobe
    return qlist, qstart, tstart, np.repeat(np.arange(len(cnt)), tiles)


def _tile(t, qstart, tstart, tile_post, off):
    """The scoring tile ``t`` as a CTA reads it: (first query slot,
    queries, first row, rows)."""
    post = tile_post[t]
    across = -(-(off[post + 1] - off[post]) // thf.TILE_ROWS)
    at = t - tstart[post]
    q0 = qstart[post] + thf.TILE_QUERIES * (at // across)
    r0 = off[post] + thf.TILE_ROWS * (at % across)
    return (q0, min(thf.TILE_QUERIES, qstart[post + 1] - q0), r0,
            min(thf.TILE_ROWS, off[post + 1] - r0))


def _b9a_two_pass_model(q, corpus, valid, cand, mask, posts, k, metric,
                        seed=0):
    """The kernels' passes in numpy. The inverse (``_invert``); scoring, a
    tile at a time in a random order: a (row, query) pair's distance is a
    function of the row and the query alone (here their entry in the [B,
    N] block over every row), its column the first of the query's sorted
    candidates (padding included) not below the row id, its key written
    there in a scratch of garbage; select: a column whose mask is off the
    mask's key, the others the scratch's.
    -> (distances, columns, slots written twice, tiles)."""
    b, c = cand.shape
    n = corpus.shape[0]
    every = torch.arange(n).expand(b, n)
    full = thf.gather_distance(torch.from_numpy(q), torch.from_numpy(corpus),
                               every, metric).numpy()
    rng = np.random.default_rng(seed)
    qlist, qstart, tstart, tile_post = _invert(posts, rng)
    rows, off = posts.table.rows.numpy(), posts.table.off.numpy()
    scratch = rng.integers(0, 2 ** 63, (b, c), dtype=np.int64).astype(
        np.uint64)
    written = np.zeros((b, c), np.int64)
    for t in rng.permutation(int(tstart[-1])):
        q0, nq, r0, nr = _tile(t, qstart, tstart, tile_post, off)
        for row in rows[r0:r0 + nr]:
            for qi in qlist[q0:q0 + nq]:
                dist = full[qi, row] if valid[row] else MASK_DISTANCE
                line = cand[qi]
                j = int(np.searchsorted(line, row, "left"))
                if j < c and line[j] == row:
                    scratch[qi, j] = _keys(np.float32([[dist]]))[0, 0] \
                        | np.uint64(j)
                    written[qi, j] += 1
    masked = _keys(np.full((b, c), MASK_DISTANCE, np.float32))
    keys = np.where(mask, scratch, masked)
    kk = min(k, c)
    out_d = np.zeros((b, kk), np.float32)
    out_c = np.zeros((b, kk), np.int32)
    for r in range(b):
        out_d[r], out_c[r] = _unkey(_select(keys[r], kk)[0])
    return out_d, out_c, int((written > 1).sum()), int(tstart[-1])


@pytest.mark.parametrize("k", [5, 17, 1000])
@pytest.mark.parametrize("metric", METRICS)
def test_two_pass_model_matches_plain_and_jax(metric, k):
    """The inverse, the scoring pass by posting tile and the select pass,
    in numpy, equal the plain version and the JAX program whatever the
    order of the probes' counts and of the tiles: a row reached through
    two postings of one query (written twice), a posting probed by every
    query (three tiles of queries by two of rows) and one probed by none,
    an empty posting, an allow list and dead rows, k past the columns and
    padding past each query's candidates, every metric."""
    args = _b9_inputs(3, metric)
    td, tc = _torch_b9(thf.posting_topk_plain, *args, k, metric)
    jd, jc = _jax_b9(*args[:5], k, metric)
    for seed in (0, 1):
        md, mc, twice, tiles = _b9a_two_pass_model(*args, k, metric, seed)
        assert twice > 0
        assert tiles >= 3 * 2 + 5
        np.testing.assert_array_equal(mc, tc)
        np.testing.assert_array_equal(mc, jc)
        np.testing.assert_allclose(md, td, **TOL)
        np.testing.assert_allclose(md, jd, **TOL)


def _check_cover(posts, probe, postings, cand, mask, n):
    """The operands describe the batch as the kernels need it: the table
    is the snapshot's CSR (rows clipped to [0, n)), the probes are the
    search's, each query's candidates (``cand`` [B, C] as the kernel gets
    them) ascending over the whole row, each row once where the mask is
    on, and every column with its mask on a row of a posting the query
    probes."""
    got_probe, (rows, off, max_len) = posts
    rows, off = rows.numpy(), off.numpy()
    assert len(off) == len(postings) + 1
    for i, ids in enumerate(postings):
        np.testing.assert_array_equal(rows[off[i]:off[i + 1]],
                                      np.clip(ids, 0, n - 1))
    assert max_len == max(map(len, postings))
    np.testing.assert_array_equal(got_probe.numpy(), probe)
    assert (np.diff(cand, axis=1) >= 0).all()
    for qi in range(len(cand)):
        union = np.concatenate([postings[p] for p in probe[qi]])
        assert np.isin(cand[qi][mask[qi]], union).all()
        assert (np.diff(cand[qi][mask[qi]]) > 0).all()


def test_posting_operands_on_the_index_snapshot(monkeypatch):
    """``posting_table`` and ``posting_operands`` as ``HFreshIndex.search``
    calls them: the table the snapshot's CSR and the probes the search's,
    every kept column a row of a posting its query probes; the table kept
    across searches and built again once the postings change."""
    from weaviate_tpu_torch.index import hfresh as index_mod

    rng = np.random.default_rng(6)
    corpus = _clustered(rng, 1200, 16, centres=12)
    t = HFreshIndex(16, config.HFreshIndexConfig(
        distance="l2-squared", max_posting_size=48, search_probe=6),
        device="cpu")
    t.add_batch(np.arange(1000, dtype=np.int64), corpus[:1000])
    seen, tables, calls = [], [], []
    real_ops, real_table = index_mod.posting_operands, index_mod.posting_table
    real_topk = index_mod.posting_topk

    def ops_spy(*a, **kw):
        seen.append(a)
        return real_ops(*a, **kw)

    def table_spy(*a, **kw):
        tables.append(a)
        return real_table(*a, **kw)

    def topk_spy(*a, **kw):
        calls.append(a)
        return real_topk(*a, **kw)

    monkeypatch.setattr(index_mod, "posting_operands", ops_spy)
    monkeypatch.setattr(index_mod, "posting_table", table_spy)
    monkeypatch.setattr(index_mod, "posting_topk", topk_spy)
    q = corpus[:40] + 0.1 * rng.standard_normal((40, 16)).astype(np.float32)
    for rnd in range(2):
        t.search(q, 10)
        t.search(q[:7], 10)
        qp, cand_np, mask_np, probe, table, n, dev = seen[-2]
        assert dev == torch.device("cpu")
        assert len(tables) == rnd + 1 and seen[-1][4] is table
        postings = tables[-1][0]
        assert tables[-1][1] == n
        cand, mask, posts = calls[-2][3], calls[-2][4], calls[-2][7]
        np.testing.assert_array_equal(cand.numpy(),
                                      np.clip(cand_np, 0, n - 1))
        np.testing.assert_array_equal(mask.numpy(), mask_np)
        np.testing.assert_array_equal(calls[-2][0].numpy(), qp)
        _check_cover(posts, probe, postings, cand.numpy(), mask.numpy(), n)
        assert posts.probe.dtype == cand.dtype == torch.int32
        assert (np.bincount(probe.reshape(-1)) > 1).any()  # shared postings
        t.add_batch(np.arange(1000, 1200, dtype=np.int64), corpus[1000:])
    t.search(q, 10)
    assert len(tables) == 3
    t.delete(np.arange(0, 50, dtype=np.int64))  # postings unchanged
    t.search(q, 10)
    assert len(tables) == 3


def test_routes_and_contract():
    """CPU tensors take the plain version, which checks the posting
    operands' shapes and ids; another device type raises; the launch plan
    keeps keys in shared memory while they fit."""
    args = _b9_inputs(1, "l2-squared")
    np.testing.assert_array_equal(
        _torch_b9(thf.posting_topk, *args, 7, "l2-squared")[1],
        _torch_b9(thf.posting_topk_plain, *args, 7, "l2-squared")[1])
    q, corpus, valid, cand, mask, posts = args
    nposts = posts.table.off.shape[0] - 1
    bad = [posts._replace(probe=torch.where(posts.probe == 3, nposts,
                                            posts.probe)),
           posts._replace(probe=posts.probe[1:]),
           posts._replace(probe=posts.probe.long()),
           posts._replace(table=posts.table._replace(max_len=3)),
           posts._replace(table=posts.table._replace(
               rows=posts.table.rows[1:]))]
    for b in bad:
        with pytest.raises(ValueError, match="B9a's posting"):
            _torch_b9(thf.posting_topk, q, corpus, valid, cand, mask, b, 7,
                      "l2-squared")
    with pytest.raises(ValueError, match="names no posting"):
        thf.posting_operands(np.zeros((1, 4), np.float32),
                             np.zeros((1, 3), np.int64),
                             np.ones((1, 3), bool), np.array([[0, nposts]]),
                             posts.table, 10)
    meta = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError, match="no posting top-k"):
        thf.posting_topk(meta, meta, meta, meta, meta, 1, "dot", posts)
    with pytest.raises(ValueError, match="unknown metric"):
        thf.posting_topk_cuda(meta, meta, meta, meta, meta, 1, "cos", posts)
    smem = 227 * 1024
    head = thf.head_bytes()
    assert head == 256 * 4 + 16 * 4
    assert thf.score_bytes(99) == 4 * thf.TILE_QUERIES * 100
    assert thf.invert_ints(5, 16, 33) == 3 * 5 + 2 + 2 * 16 + 16 * 2
    assert thf.posting_plan(1100, 768, 10, smem) == (
        True, True, head + 8 * 1100 + 8 * 10)
    big = (smem - head) // 8
    assert thf.posting_plan(big, 768, 10, smem)[:2] == (True, False)
    assert thf.posting_plan(big + 1, 768, 10, smem) == (
        False, True, head + 80)
    with pytest.raises(ValueError, match="shared memory"):
        thf.posting_plan(10, 70_000, 1, smem)


class _Lib:
    def __getattr__(self, name):
        fn = type("F", (), {})()
        setattr(self, name, fn)
        return fn


def test_packed_call_and_signatures_match_the_source():
    src = open(thf.__file__.rsplit("/", 2)[0] + "/csrc/hfresh.cu").read()
    ints = {n: int(v) for n, v in re.findall(
        r"^constexpr int (k\w+) = (\d+);", src, re.M)}
    assert thf._CALL.size == ints["kCallBytes"]
    call = re.search(r"struct PostingCall \{(.*?)\} a;", src, re.S).group(1)
    addrs, nums = call.split("int32_t")
    assert f"{len(addrs.split(','))}Q{len(nums.split(','))}i" in \
        thf._CALL.format
    assert "return 3LL * postings + 2 + 2LL * s + tiles_most(s, max_len);" \
        in src
    assert "static_cast<long long>(s) * ((max_len + kTileRows - 1) / " \
        "kTileRows);" in src
    assert (thf._BINS, thf._MISC) == (ints["kBins"], ints["kMisc"])
    assert thf.TILE_QUERIES == ints["kTileQueries"]
    assert thf.TILE_ROWS == ints["kThreads"] // 32 * ints["kWarpRows"]
    assert ints["kTileQueries"] * ints["kWarpRows"] == 32
    lib = thf.declare(_Lib())
    for fn in ("hfresh_posting_topk", "hfresh_device_info",
               "hfresh_error_string"):
        m = re.search(rf"(?m)^(?:int|const char\*) {fn}\(([^)]*)\)", src)
        assert len(lib.__dict__[fn].argtypes) == len(m.group(1).split(","))
    assert lib.hfresh_posting_topk.argtypes == [ctypes.c_char_p]


@pytest.mark.parametrize("copy", sorted(probe_hfresh.COPIES))
def test_probe_copies_apply_to_the_kernel_source(copy):
    """``probe_hfresh.py``'s copies replace text ``csrc/hfresh.cu`` holds
    exactly once, so a kernel edit that drops one fails here; a copy that
    changes the tile keeps a lane a (row, query) pair."""
    text = probe_hfresh.SOURCE.read_text()
    for old, _new in probe_hfresh.COPIES[copy]:
        assert text.count(old) == 1, repr(old)
    got = probe_hfresh.copies_of(text)[copy]
    assert got != text + probe_hfresh.common.APPENDED
    ints = {n: int(v) for n, v in re.findall(
        r"^constexpr int (k\w+) = (\d+);", got, re.M)}
    assert ints["kTileQueries"] * ints["kWarpRows"] == 32


# -- HFreshIndex against the JAX index ---------------------------------------


def _host_gather(j):
    """The JAX index's ``store.get`` as a numpy gather of its store's
    corpus: the same float32 rows its device gather returns, without one
    XLA compile per distinct id count (about 0.13 s each, some 300 a
    5,000-row build on the CPU). The index's code is unchanged."""
    j.store.get = lambda ids: np.asarray(j.store.snapshot()[0])[
        np.asarray(ids, np.int32)]
    return j


def _pair(d, **kw):
    return (_host_gather(JaxHFresh(d, jconfig.HFreshIndexConfig(**kw))),
            HFreshIndex(d, config.HFreshIndexConfig(**kw), device="cpu"))


def _add(pair, ids, vecs):
    for idx in pair:
        idx.add_batch(ids, vecs)


def _same_state(j, t, doc_posting=True):
    """Equal postings and centroids; cosine centroids within 1e-6: the
    stores normalise the rows on their devices, summing the squares in
    another order, and a split averages the stored rows. ``doc_posting``:
    also the doc -> posting map (a loaded index rebuilds it from the
    postings, deleted docs included, where a live one popped them)."""
    if t.metric == "cosine":
        np.testing.assert_allclose(t._centroids, j._centroids, rtol=0,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(t._centroids, j._centroids)
    assert len(t._postings) == len(j._postings)
    for a, b in zip(t._postings, j._postings):
        np.testing.assert_array_equal(a, b)
    if doc_posting:
        assert t._doc_posting == j._doc_posting
    assert t.stats() == j.stats()


def _same_search(j, t, q, k, **kw):
    jr, tr = j.search(q, k, **kw), t.search(q, k, **kw)
    np.testing.assert_array_equal(tr.ids, jr.ids)
    np.testing.assert_allclose(tr.dists, jr.dists, **TOL)
    return tr


def _clustered(rng, n, d, centres=50):
    c = rng.standard_normal((centres, d)).astype(np.float32) * 3
    return (c[rng.integers(0, centres, n)]
            + rng.standard_normal((n, d)).astype(np.float32))


def _recall(res, corpus, q, k=10):
    d2 = ((q[:, None, :] - corpus[None]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1)[:, :k]
    return sum(len(set(res.ids[i].tolist()) & set(gt[i].tolist()))
               for i in range(len(q))) / (len(q) * k)


@pytest.mark.parametrize("case", ["clustered", "random_wide_probe"])
def test_recall_scenarios_match_jax(case):
    rng = np.random.default_rng(0)
    n, d = 5000, 32
    if case == "clustered":
        corpus = _clustered(rng, n, d)
        kw = dict(distance="l2-squared", max_posting_size=128,
                  search_probe=8)
    else:
        corpus = rng.standard_normal((n, d)).astype(np.float32)
        kw = dict(distance="l2-squared", max_posting_size=128,
                  search_probe=16, replicas=3)
    j, t = _pair(d, **kw)
    for s in range(0, n, 500):
        _add((j, t), np.arange(s, s + 500, dtype=np.int64), corpus[s:s + 500])
    _same_state(j, t)
    q = corpus[:32] + 0.05 * rng.standard_normal((32, d)).astype(np.float32)
    res = _same_search(j, t, q, 10)
    assert t.count() == n
    assert _recall(res, corpus, q) >= (0.95 if case == "clustered" else 0.75)
    if case == "clustered":
        assert t.stats()["centroids"] > 10


def test_reassign_after_splits_matches_jax():
    rng = np.random.default_rng(5)
    kw = dict(distance="l2-squared", max_posting_size=24, min_posting_size=2,
              search_probe=1)
    j, t = _pair(8, **kw)
    for step in range(8):
        a = rng.standard_normal((40, 8)).astype(np.float32) * 0.2
        b = a + np.float32(step)
        ids_a = np.arange(step * 80, step * 80 + 40)
        _add((j, t), ids_a, a)
        _add((j, t), ids_a + 40, b)
    _same_state(j, t)
    good = 0
    for d in range(640):
        v = t._prep(t.store.get(np.asarray([d])))
        good += int(np.argmin(t._centroid_dists(v)[0])) == t._doc_posting[d]
    assert good / 640 >= 0.9
    _same_search(j, t, rng.standard_normal((16, 8)).astype(np.float32), 5)


@pytest.mark.parametrize("metric", METRICS)
def test_delete_and_filter_match_jax(metric):
    rng = np.random.default_rng(1)
    n, d = 600, 16
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    if metric == "hamming":
        corpus = np.round(corpus)
    j, t = _pair(d, distance=metric, max_posting_size=64)
    _add((j, t), np.arange(n, dtype=np.int64), corpus)
    _same_state(j, t)
    _same_search(j, t, corpus[:8], 3)
    for idx in (j, t):
        idx.delete(np.asarray([5, 6, 7]))
    res = _same_search(j, t, corpus[:8], 3)
    assert not np.isin(res.ids, [5, 6, 7]).any()
    allow = np.zeros(n, bool)
    allow[100:200] = True
    res = _same_search(j, t, corpus[140:160], 5, allow_list=allow)
    got = res.ids[res.ids >= 0]
    assert len(got) and ((got >= 100) & (got < 200)).all()
    # an allow list shorter than the id space clips as the JAX one does
    _same_search(j, t, corpus[:4], 4, allow_list=allow[:150])
    # search_by_distance: the bound applies after the top-k
    jr = j.search_by_distance(corpus[:4], 1.0, limit=50)
    tr = t.search_by_distance(corpus[:4], 1.0, limit=50)
    np.testing.assert_array_equal(tr.ids, jr.ids)
    np.testing.assert_allclose(tr.dists, jr.dists, **TOL)


def test_degenerate_duplicate_vectors_terminate_and_match_jax():
    d = 8
    j, t = _pair(d, distance="l2-squared", max_posting_size=16,
                 search_probe=2)
    dup = np.ones((100, d), np.float32)
    _add((j, t), np.arange(100, dtype=np.int64), dup)
    assert t.count() == 100
    _same_state(j, t)
    # every candidate ties: lower column (lower doc id) first, as JAX
    res = _same_search(j, t, np.ones((2, d), np.float32), 40)
    assert (res.ids >= 0).all()
    np.testing.assert_array_equal(res.ids[0], np.arange(40))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_roundtrip_across_packages(tmp_path, writer):
    rng = np.random.default_rng(2)
    n, d = 400, 16
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    kw = dict(distance="cosine", max_posting_size=64)
    j, t = _pair(d, **kw)
    _add((j, t), np.arange(n, dtype=np.int64), corpus)
    _same_state(j, t)
    t.delete(np.asarray([9]))
    j.delete(np.asarray([9]))
    path = str(tmp_path / "hf.ckpt")
    src = j if writer == "jax" else t
    assert src.save_vectors(path, {"seq": 42}) is True
    j2, t2 = _pair(d, **kw)
    for idx in (j2, t2):
        meta = idx.load_vectors(path)
        assert meta is not None and meta["seq"] == 42
    _same_state(j2, t2)
    _same_state(j, t2, doc_posting=False)
    _same_search(j, t2, corpus[:6], 5)
    _same_search(j2, t2, corpus[:6], 5)


def test_interop_hfresh_from_numpy():
    rng = np.random.default_rng(4)
    corpus = _clustered(rng, 1500, 24, centres=20)
    j = _host_gather(JaxHFresh(24, jconfig.HFreshIndexConfig(
        distance="manhattan", max_posting_size=64)))
    j.add_batch(np.arange(1500, dtype=np.int64), corpus)
    j.delete(np.arange(0, 1500, 13))
    jc, jv, _ = j.store.snapshot()
    t = interop.hfresh_from_numpy(
        j._centroids, j._postings, np.asarray(jc), np.asarray(jv),
        config.HFreshIndexConfig(distance="manhattan", max_posting_size=64),
        device="cpu")
    assert t.count() == j.count()
    _same_state(j, t, doc_posting=False)
    _same_search(j, t, corpus[:12], 10)


def test_build_vector_index_and_shard_checkpoint_match_jax(tmp_path):
    idx = build_vector_index(8, config.FlatIndexConfig(
        distance="l2-squared").as_type(config.HFreshIndexConfig, "hfresh"),
        device="cpu")
    assert isinstance(idx, HFreshIndex)
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((50, 8)).astype(np.float32)
    out = {}
    for name, shard_cls, obj_cls, cfg in (
            ("jax", JaxShard, JaxObject, jconfig),
            ("torch", Shard, StorageObject, config)):
        c = cfg.CollectionConfig(name="HF", vector_config=cfg.HFreshIndexConfig(
            distance="l2-squared"))
        kw = {} if name == "jax" else dict(device="cpu")
        s = shard_cls(str(tmp_path / name), c, **kw)
        s.put_batch([obj_cls(uuid=f"00000000-0000-0000-0000-{i:012d}",
                             collection="HF", properties={}, vector=vecs[i])
                     for i in range(50)])
        res = s.vector_search(vecs[9:12], k=3)
        assert res.ids[0][0] == 9
        s.close()
        s2 = shard_cls(str(tmp_path / name), c, **kw)
        assert s2.recovered_from == "checkpoint"
        res2 = s2.vector_search(vecs[9:12], k=3)
        np.testing.assert_array_equal(res2.ids, res.ids)
        s2.close()
        out[name] = res2
    np.testing.assert_array_equal(out["torch"].ids, out["jax"].ids)
    np.testing.assert_allclose(out["torch"].dists, out["jax"].dists, **TOL)
    # the JAX-written shard opens in the port
    s3 = Shard(str(tmp_path / "jax"), config.CollectionConfig(
        name="HF", vector_config=config.HFreshIndexConfig(
            distance="l2-squared")), device="cpu")
    assert s3.recovered_from == "checkpoint"
    np.testing.assert_array_equal(s3.vector_search(vecs[9:12], k=3).ids,
                                  out["jax"].ids)
    s3.close()
