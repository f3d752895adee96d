"""The code scans (Q2 ``sq_search``, Q3 ``pq_search``, Q4 ``rq_search``)
under the plans of their kernel, ``wg_scan_kernel`` in
``csrc/quantized.cu``, on the CPU against the JAX package.

The kernel holds all 256 queries of a CTA and walks a split of the rows in
128-row tiles; it leaves each split's k smallest (order key, row) in row
order in the lists of ``scan_plan``, and the merge takes them to k. The
plain model of those two halves (``split_partials_plain`` then
``merge_partials_plain``) runs here on the port's plain distances, at the
plan the card takes (as many splits as it has SMs) and at others, on integer
codes, codebooks and queries whose products are exact in any summation
order, with every row repeated, so that ties between equal rows decide many
slots. Its ids and distances equal JAX's ``sq_search``, ``pq_search`` and
``rq_search`` exactly: lower row first on ties, masked rows never taken,
-1 / MASK_DISTANCE past the live rows.

Also the query operand's layout (``code_query_blocks``): a step's 64
dimensions of a CTA's 256 queries in one contiguous block of 8 x 8 pieces.
"""

import numpy as np
import pytest
import torch

from weaviate_tpu.ops import quantized as jq
from weaviate_tpu_torch.ops import quantized as tq
from weaviate_tpu_torch.ops.distance import MASK_DISTANCE

B, N = 9, 1_500
METRICS = ("l2-squared", "dot", "cosine")


def _order_keys(dist: torch.Tensor) -> torch.Tensor:
    """The kernels' uint32 order keys of float32 distances, as int32 (-0 as
    +0, negatives bit-flipped, the others with the sign bit set)."""
    u = dist.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    u = torch.where(u == 0x80000000, 0, u)
    key = torch.where(u >= 0x80000000, (~u) & 0xFFFFFFFF, u | 0x80000000)
    return torch.where(key >= 1 << 31, key - (1 << 32), key).to(torch.int32)


def _repeated(rng, pool_rows: np.ndarray) -> np.ndarray:
    """N rows drawn from a small pool: each row has many exact twins."""
    return pool_rows[rng.integers(0, len(pool_rows), N)]


def _planes(kind: str, metric: str, seed: int):
    """Integer operands of one scan, exact in float32 whatever the order of
    the sums: (JAX arguments before the mask, the port's plain distances of
    every (query, row), [B, N])."""
    rng = np.random.default_rng(seed)
    if kind == "pq":
        m, dsub = 12, 4
        cb = rng.integers(-2, 3, (m, 256, dsub)).astype(np.float32)
        codes = _repeated(rng, rng.integers(0, 256, (40, m))).astype(
            np.uint8)
        q = rng.integers(-3, 4, (B, m * dsub)).astype(np.float32)
        dec = tq._pq_decode(torch.from_numpy(codes), torch.from_numpy(cb),
                            m * dsub)
        dsq = (dec * dec).sum(1).numpy()
        ip = tq._bf16_ip(torch.from_numpy(q), dec)
        jargs = (q, codes, cb, dsq)
    else:
        d = 64
        codes = _repeated(rng, rng.integers(0, 256, (40, d))).astype(
            np.uint8)
        q = rng.integers(-2, 3, (B, d)).astype(np.float32)
        c = torch.from_numpy(codes).float()
        if kind == "rq":
            lower = np.full(N, -4.0, np.float32)
            step = np.full(N, 0.5, np.float32)
            lower[::7] = -2.0  # rows of the same codes, other decodes
            dec = (torch.from_numpy(lower)[:, None]
                   + torch.from_numpy(step)[:, None] * c)
            ip = tq._rq_epilogue(tq._bf16_ip(torch.from_numpy(q), c),
                                 torch.from_numpy(q).sum(-1), torch.zeros(B),
                                 torch.from_numpy(lower)[None, :],
                                 torch.from_numpy(step)[None, :],
                                 torch.zeros(1, N), "dot")
            ip = -ip  # q . decode(x)
            jargs = (q, codes, lower, step)
        else:
            a, s = -4.0, 0.5
            dec = a + s * c
            ip = s * tq._bf16_ip(torch.from_numpy(q), c) \
                + a * torch.from_numpy(q).sum(-1)[:, None]
            jargs = (q, codes)
        dsq = (dec * dec).sum(1).numpy()
        if kind == "rq":
            jargs = jargs + (dsq,)
        else:
            jargs = jargs + (dsq, np.float32(-4.0), np.float32(0.5))
    qt = torch.from_numpy(q)
    dist = tq._metric_distance(ip, (qt * qt).sum(-1), torch.from_numpy(dsq),
                               metric)
    return jargs, dist


def _jax_search(kind, jargs, mask, metric, k):
    import jax.numpy as jnp

    args = tuple(jnp.asarray(a) for a in jargs)
    fn = {"sq": jq.sq_search, "pq": jq.pq_search, "rq": jq.rq_search}[kind]
    d, i = fn(*args, jnp.asarray(mask), metric, k, 512)
    return np.asarray(d), np.asarray(i)


# plans: the card's (132 SMs: a split a tile here), two SMs' (a few long
# splits), and explicit ones: every split shorter than k, one split
PLANS = {"card": dict(sms=132), "two_sms": dict(sms=2),
         "short_splits": dict(splits=12, split_rows=128),
         "one_split": dict(splits=1, split_rows=1_536)}


def _plan(kind, k, sms=None, splits=None, split_rows=None):
    if sms is not None:
        return tq.scan_plan(kind, B, N, k, sms)
    return tq.ScanPlan(splits, split_rows, k + tq.ROWS_TILE[kind])


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", ["pq", "rq", "sq"])
def test_split_partials_under_the_kernels_plan_give_jax(kind, metric, plan):
    k = 40
    jargs, dist = _planes(kind, metric, seed=len(kind) + len(metric))
    mask = np.random.default_rng(7).random(N) >= 0.2
    mask[256:384] = False  # a wholly masked tile
    jd, ji = _jax_search(kind, jargs, mask, metric, k)
    # ties between twin rows decide slots of the answer
    assert (np.diff(jd, axis=1) == 0).any()
    keys = torch.where(torch.from_numpy(mask)[None, :], _order_keys(dist),
                       tq.NONE_KEY)
    sp = _plan(kind, k, **PLANS[plan])
    assert sp.split_rows % tq.ROWS_TILE[kind] == 0
    assert (sp.splits - 1) * sp.split_rows < N <= sp.splits * sp.split_rows
    td, ti = tq.merge_partials_plain(*tq.split_partials_plain(keys, k, sp),
                                     k)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(td.numpy(), jd)


@pytest.mark.parametrize("kind", ["pq", "rq", "sq"])
def test_split_partials_past_the_live_rows_give_jax(kind):
    # k beyond the live rows: the answer pads with -1 / MASK_DISTANCE
    k = 300
    jargs, dist = _planes(kind, "l2-squared", seed=11)
    mask = np.zeros(N, bool)
    mask[np.random.default_rng(3).choice(N, 200, replace=False)] = True
    jd, ji = _jax_search(kind, jargs, mask, "l2-squared", k)
    keys = torch.where(torch.from_numpy(mask)[None, :], _order_keys(dist),
                       tq.NONE_KEY)
    sp = tq.scan_plan(kind, B, N, k, 132)
    td, ti = tq.merge_partials_plain(*tq.split_partials_plain(keys, k, sp),
                                     k)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(td.numpy(), jd)
    assert (ti.numpy()[:, 200:] == -1).all()
    assert (td.numpy()[:, 200:] >= MASK_DISTANCE).all()


@pytest.mark.parametrize("b,d", [(1, 64), (9, 100), (256, 768), (300, 25)])
def test_code_query_blocks_lay_a_step_out_contiguously(b, d):
    q = torch.from_numpy(np.random.default_rng(b).standard_normal(
        (b, d)).astype(np.float32))
    qb, _, _ = tq.sq_query_terms(q)
    blocks = tq.code_query_blocks(qb)
    tile, dp = tq.QUERY_TILE["sq"], qb.shape[1]
    tiles = -(-b // tile)
    assert blocks.shape == (tiles, dp // 8, tile, 8)
    assert blocks.is_contiguous() and blocks.dtype == torch.bfloat16
    # query i, dimension j sits at [i // tile][j // 8][i % tile][j % 8]
    i = torch.arange(b)[:, None]
    j = torch.arange(dp)[None, :]
    assert torch.equal(blocks[i // tile, j // 8, i % tile, j % 8], qb)
    # a CTA's step is one block of 8 x 256 x 8 values, zero past b
    flat = blocks.reshape(tiles, dp // 64, 8 * tile * 8)
    assert flat.shape[-1] * 2 == 32 * 1024
    pad = blocks.permute(0, 2, 1, 3).reshape(tiles * tile, dp)[b:]
    assert not pad.any()


# the bound the splits share needs 2 x splits >= k sub-streams, and acts
# from a split's second tile on: plans of 2-3 tiles a split, each with a k
# that lets the bound act
BOUNDED = {"six_splits_k10": (dict(splits=6, split_rows=256), 10),
           "four_splits_k8": (dict(splits=4, split_rows=384), 8),
           "six_splits_k12": (dict(splits=6, split_rows=256), 12)}


@pytest.mark.parametrize("case", list(BOUNDED))
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", ["pq", "rq", "sq"])
def test_split_partials_under_the_shared_bound_give_jax(kind, metric, case):
    """The splits' shared bound (``split_partials_bounded_plain``: a row
    is taken only if its (key, row) pair is below the largest of the
    sub-streams' least pairs taken) drops rows, and the merged answer is
    still JAX's exactly, twins' ties included."""
    plan_kw, k = BOUNDED[case]
    jargs, dist = _planes(kind, metric, seed=7 + len(kind))
    mask = np.random.default_rng(8).random(N) >= 0.1
    jd, ji = _jax_search(kind, jargs, mask, metric, k)
    assert (np.diff(jd, axis=1) == 0).any()
    keys = torch.where(torch.from_numpy(mask)[None, :], _order_keys(dist),
                       tq.NONE_KEY)
    sp = _plan(kind, k, **plan_kw)
    assert 2 * sp.splits >= k
    bounded = tq.split_partials_bounded_plain(keys, k, sp)
    plain = tq.split_partials_plain(keys, k, sp)
    # the bound dropped rows that were among some split's own k smallest
    assert not torch.equal(bounded[1], plain[1])
    td, ti = tq.merge_partials_plain(*bounded, k)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(td.numpy(), jd)


@pytest.mark.parametrize("bounded", [False, True], ids=["plain", "bounded"])
@pytest.mark.parametrize("kind", ["pq", "rq", "sq"])
def test_split_partials_hold_taken_entries_then_padding(kind, bounded):
    """The layout the merge kernel reads (``merge_partials``): each split's
    list holds its taken entries first, in row order and inside its split,
    then only ``NONE_KEY`` / -1 padding, so the taken count is the first
    padding slot."""
    k = 12
    _, dist = _planes(kind, "l2-squared", seed=21)
    mask = np.random.default_rng(9).random(N) >= 0.3
    mask[512:768] = False  # split 2 has no live row
    keys = torch.where(torch.from_numpy(mask)[None, :], _order_keys(dist),
                       tq.NONE_KEY)
    sp = _plan(kind, k, splits=6, split_rows=256)
    ck, cr = (tq.split_partials_bounded_plain(keys, k, sp) if bounded
              else tq.split_partials_plain(keys, k, sp))
    taken = ck != tq.NONE_KEY
    assert (taken[..., :-1] | ~taken[..., 1:]).all()
    assert ((cr >= 0) == taken).all()
    assert not taken[2].any()
    for s in range(sp.splits):
        rows = cr[s]
        inside = (rows >= s * sp.split_rows) & (rows < (s + 1) * sp.split_rows)
        assert (inside == taken[s]).all()
        step = rows[:, 1:] - rows[:, :-1]
        assert ((step > 0) | ~taken[s, :, 1:]).all()  # row order
    if not bounded:
        # a split with k live rows fills its list
        assert taken[0].all()


@pytest.mark.parametrize("case", ["every_split_full",
                                  "ties_at_kth_across_splits"])
def test_merge_of_full_and_tied_partials_gives_jax_sq_search(case):
    """The merge's plain version on lists the kernel reads at their
    extremes: every split's list full (k taken entries, no padding), and
    the k-th distance tied across splits (twin rows in several splits, only
    some of them kept): JAX ``sq_search``'s ids and distances exactly."""
    metric = "dot"
    k = 40 if case == "every_split_full" else 30
    jargs, dist = _planes("sq", metric, seed=31)
    mask = np.ones(N, bool) if case == "every_split_full" else (
        np.random.default_rng(4).random(N) >= 0.2)
    jd, ji = _jax_search("sq", jargs, mask, metric, k)
    keys = torch.where(torch.from_numpy(mask)[None, :], _order_keys(dist),
                       tq.NONE_KEY)
    sp = _plan("sq", k, splits=6, split_rows=256)
    ck, cr = tq.split_partials_plain(keys, k, sp)
    taken = ck != tq.NONE_KEY
    if case == "every_split_full":
        assert taken.all()
    else:
        # the k-th key sits in more splits' lists than it is kept from
        jdt = torch.from_numpy(jd.copy())
        kth = _order_keys(jdt)[:, k - 1]
        at_kth = ck == kth[None, :, None]
        splits_with = at_kth.any(-1).sum(0)
        kept = (jdt == jdt[:, k - 1:k]).sum(1)
        assert ((splits_with >= 2) & (at_kth.sum((0, 2)) > kept)).any()
    td, ti = tq.merge_partials(ck, cr, k)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(td.numpy(), jd)
