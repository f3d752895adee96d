"""Parity: the plain version of the fused L2 top-k kernel
(weaviate_tpu_torch/ops/fused_flat.py) against the JAX Pallas kernel
``pallas_flat_topk`` in interpret mode, at the cases of
tests/test_pallas_flat.py, plus the shape helpers against JAX's.

Both sides sum the same bf16-rounded products in float32 in another order:
distances agree to rtol 1e-4 / atol 1e-3 and ids are identical (the bucket
and tie rules are the same).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaviate_tpu.ops import pallas_flat as jp
from weaviate_tpu_torch.ops import fused_flat as tf

import probe_fused_flat as probe


def _data(n=4096, d=64, b=8, seed=0):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    q = corpus[:b] + 0.1 * rng.standard_normal((b, d)).astype(np.float32)
    sq = (corpus * corpus).sum(1).astype(np.float32)
    return q, corpus, sq


def _both(q, corpus, sq, mask, k, chunk_size, live_rows=None):
    jv, ji = jp.pallas_flat_topk(jnp.asarray(q), jnp.asarray(corpus),
                                 jnp.asarray(sq), jnp.asarray(mask), k,
                                 chunk_size=chunk_size, interpret=True,
                                 live_rows=live_rows)
    args = (torch.from_numpy(q), torch.from_numpy(corpus),
            torch.from_numpy(sq), torch.from_numpy(mask), k)
    tv, ti = tf.fused_flat_topk_reference(*args, chunk_size=chunk_size,
                                          live_rows=live_rows)
    return np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()


def _same(jv, ji, tv, ti):
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("case", [
    # (n, b, k, chunk, mask rows allowed, seed): the reference test cases
    (4096, 8, 10, 1024, None, 0),   # exact ids at fold 1
    (4096, 16, 2, 2048, None, 3),   # fold 16: strided bucket id math
    (2048, 8, 10, 512, 64, 0),      # mask excludes, blocks pad with -1
    (1024, 8, 5, 512, 0, 0),        # fully masked: sentinels only
])
def test_plain_matches_pallas_interpret(case):
    n, b, k, chunk, allowed, seed = case
    q, corpus, sq = _data(n=n, b=b, seed=seed)
    mask = np.ones(n, np.float32)
    if allowed is not None:
        mask[allowed:] = 0.0
    jv, ji, tv, ti = _both(q, corpus, sq, mask, k, chunk)
    _same(jv, ji, tv, ti)
    if allowed == 0:
        assert (ti == -1).all() and (tv >= tf.MASK_DISTANCE).all()
    elif allowed is not None:
        live = ti[ti >= 0]
        assert (live < allowed).all()


def test_fold16_path_is_taken_and_exact_at_top1():
    q, corpus, sq = _data(n=4096, b=16, seed=3)
    block, fold = tf.plan(torch.from_numpy(corpus), 2, 2048, None)
    assert (block, fold) == (2048, 16)
    tv, ti = tf.fused_flat_topk(torch.from_numpy(q), torch.from_numpy(corpus),
                                torch.from_numpy(sq),
                                torch.ones(4096, dtype=torch.bool), 2,
                                chunk_size=2048)
    assert (ti.numpy()[:, 0] == np.arange(16)).all()


def test_rejects_non_divisible_chunk():
    q, corpus, sq = _data(n=1000)
    mask = np.ones(1000, np.float32)
    with pytest.raises(ValueError, match="chunk"):
        jp.pallas_flat_topk(jnp.asarray(q), jnp.asarray(corpus),
                            jnp.asarray(sq), jnp.asarray(mask), 5,
                            chunk_size=512, interpret=True)
    for fn in (tf.fused_flat_topk, tf.fused_flat_topk_reference):
        with pytest.raises(ValueError, match="chunk"):
            fn(torch.from_numpy(q), torch.from_numpy(corpus),
               torch.from_numpy(sq), torch.from_numpy(mask), 5,
               chunk_size=512)


def test_cpu_wrapper_takes_plain_version_without_launching():
    q, corpus, sq = _data(n=2048, b=5, seed=7)
    args = (torch.from_numpy(q), torch.from_numpy(corpus),
            torch.from_numpy(sq), torch.rand(2048) > 0.2, 7)
    before = tf.fused_flat_topk.launches
    v, i = tf.fused_flat_topk(*args, chunk_size=1024, live_rows=1 << 20)
    pv, pi = tf.fused_flat_topk_reference(*args, chunk_size=1024,
                                          live_rows=1 << 20)
    assert tf.fused_flat_topk.launches == before
    assert torch.equal(v, pv) and torch.equal(i, pi)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    q, corpus, sq = map(torch.from_numpy, _data(n=2048, b=4))
    mask = torch.ones(2048, dtype=torch.bool)
    bad = [
        (q.double(), corpus, sq, mask, 5, 2048, 16),          # dtype
        (q, corpus.half(), sq, mask, 5, 2048, 16),            # corpus dtype
        (q, corpus.T.contiguous().T, sq, mask, 5, 2048, 16),  # layout
        (q, corpus, sq, mask[:100], 5, 2048, 16),             # mask shape
        (q, corpus, sq, mask, 65, 2048, 1),                   # k > 64
        (q, corpus, sq, mask, 10, 128, 16),                   # k > buckets
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tf.block_topk_cuda(*args)


def _jax_fold(block, k, live):
    """The fold-width rule as pallas_flat_topk writes it inline."""
    fold = 16
    while fold > 1 and (block // fold < k or fold * 64 * k * k > live):
        fold //= 2
    return fold


def test_shape_helpers_match_jax():
    for live in [0, 1, 3, 4, 15, 16, 17, 1000, 4096, 262143, 262144, 10**6]:
        assert tf.bucket_live(live) == jp.bucket_live(live)
    for n in [128, 256, 384, 1000, 1024, 2048, 4096, 6144, 1 << 20, 12288]:
        for chunk in [64, 128, 512, 1000, 2048, 131072]:
            assert tf.fits(n, chunk) == jp.fits(n, chunk)
            if jp.fits(n, chunk):
                assert tf._pick_block(n, chunk) == jp._pick_block(n, chunk)
    assert tf._BLOCK_LADDER == jp._BLOCK_LADDER
    for block in tf._BLOCK_LADDER:
        for k in [1, 2, 10, 64]:
            for live in [1, 100, 6400, 12800, 102400, 262144, 10**6]:
                if block < k:
                    continue
                assert tf.fold_width(block, k, live) == _jax_fold(block, k, live)
    with pytest.raises(ValueError):
        tf.fold_width(128, 129, 10**6)


@pytest.mark.parametrize("case", [
    # (n, b, k, chunk, mask rows allowed, seed): batches that leave a ragged
    # last query tile (65 = 64 + 1, 100 = 64 + 36), at fold 16 and fold 1
    (4096, 65, 10, 2048, None, 5),
    (4096, 100, 3, 2048, 3000, 6),
    (2048, 65, 10, 1024, 64, 7),
    (2048, 100, 5, 512, None, 8),
])
def test_plain_matches_pallas_interpret_ragged_batches(case):
    n, b, k, chunk, allowed, seed = case
    q, corpus, sq = _data(n=n, d=48, b=b, seed=seed)
    mask = np.ones(n, np.float32)
    if allowed is not None:
        mask[allowed:] = 0.0
    jv, ji, tv, ti = _both(q, corpus, sq, mask, k, chunk,
                           live_rows=1 << 20)
    _same(jv, ji, tv, ti)
    # the CPU wrapper takes the plain version, so it gives the same
    args = (torch.from_numpy(q), torch.from_numpy(corpus),
            torch.from_numpy(sq), torch.from_numpy(mask), k)
    wv, wi = tf.fused_flat_topk(*args, chunk_size=chunk, live_rows=1 << 20)
    assert torch.equal(wv, torch.from_numpy(tv))
    assert torch.equal(wi, torch.from_numpy(ti))


def test_variant_query_rejects_shapes_outside_the_contract():
    q = torch.zeros(4, 64)
    corpus = torch.zeros(2048, 64)
    bad = [
        (q, corpus, 0, 2048, 16),                  # k < 1
        (q, corpus, 65, 2048, 1),                  # k > MAX_K
        (q, corpus, 10, 1000, 1),                  # block off the ladder
        (q, corpus, 10, 4096, 1),                  # block > rows
        (q, torch.zeros(3000, 64), 10, 2048, 16),  # block does not divide
        (q, corpus, 10, 2048, 32),                 # fold > 16
        (q, corpus, 10, 2048, 3),                  # fold does not divide
        (q, corpus, 10, 128, 16),                  # k > buckets
        (torch.zeros(0, 64), corpus, 10, 2048, 16),  # empty batch
        (q, corpus.half(), 10, 2048, 16),          # corpus dtype
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tf.kernel_variant(*args)


def test_launch_counts_by_variant_and_reset():
    saved = (tf.fused_flat_topk.launches,
             dict(tf.fused_flat_topk.launches_by_variant))
    try:
        tf.reset_launches()
        assert tf.fused_flat_topk.launches == 0
        assert tf.fused_flat_topk.launches_by_variant == dict.fromkeys(
            tf.VARIANTS, 0)
        tf.count_launch("cluster")
        tf.count_launch("cluster")
        tf.count_launch("legacy")
        assert tf.fused_flat_topk.launches == 3
        assert tf.fused_flat_topk.launches_by_variant["cluster"] == 2
        assert tf.fused_flat_topk.launches_by_variant["legacy"] == 1
        with pytest.raises(KeyError):
            tf.count_launch("no-such-variant")
        tf.reset_launches()
        assert tf.fused_flat_topk.launches == 0
        assert set(tf.fused_flat_topk.launches_by_variant.values()) == {0}
    finally:
        tf.fused_flat_topk.launches = saved[0]
        tf.fused_flat_topk.launches_by_variant = saved[1]


@pytest.mark.parametrize("name", [*probe.EDITS, "counters"])
def test_probe_copies_apply_to_the_kernel_source(name):
    # each copy of probe_fused_flat.py replaces lines the kernel source
    # holds exactly once, so a kernel edit that drops one fails here
    edits = probe.COUNTERS if name == "counters" else probe.EDITS[name]
    src = probe.SOURCE.read_text()
    for old, _ in edits:
        assert src.count(old) == 1, f"{name}: {old!r}"
    assert (probe.edited(edits) == src) == (not edits)
