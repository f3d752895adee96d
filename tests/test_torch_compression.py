"""Parity: the port's compression layer (``weaviate_tpu_torch/compression``)
against the JAX package's, on the CPU.

- Encodings are bit-identical: ``pack_bits_host``, ``unpack_bits``, BQ and
  SQ ``encode``/``prep``, BQ's device encode (torch), and SQ ``fit``'s
  offset ``a`` and step ``s``.
- ``DeviceArraySet`` put, delete, growth, snapshot and detach/attach leave
  the same planes, valid mask, watermark, live count and capacity as the
  JAX set; ``HostVectorStore`` at the ``ram`` and ``ram16`` tiers the same
  originals.
- The disk tiers raise naming slice 9; PQ and RQ build through
  ``build_quantizer`` and ``make_flat`` and search as JAX's do (their
  parity in depth: ``tests/test_torch_pq_rq.py``); the metric checks of
  ``build_quantizer`` are JAX's.
- State carried across (``interop.py``): a JAX quantizer's ``state_dict``
  and a JAX code set's arrays build the port's equivalents.
"""

import numpy as np
import pytest
import torch

from weaviate_tpu.compression import quantizers as jq
from weaviate_tpu.compression import store as jstore
from weaviate_tpu.ops import quantized as jqops
from weaviate_tpu.schema import config as jconfig
from weaviate_tpu_torch import interop
from weaviate_tpu_torch.compression import (
    BinaryQuantizer,
    DeviceArraySet,
    HostVectorStore,
    ScalarQuantizer,
    build_quantizer,
)
from weaviate_tpu_torch.compression.store import raw_tier_dtype, to_numpy
from weaviate_tpu_torch.index.flat import make_flat
from weaviate_tpu_torch.ops import quantized as qops
from weaviate_tpu_torch.schema import config


def _vectors(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


@pytest.mark.parametrize("d", [25, 64, 100])
def test_pack_and_unpack_bits_match_jax(d):
    bits = np.random.default_rng(d).integers(0, 2, (37, d)).astype(np.uint32)
    packed = qops.pack_bits_host(bits)
    np.testing.assert_array_equal(packed, jqops.pack_bits_host(bits))
    assert packed.dtype == np.uint32
    t = qops.unpack_bits(torch.from_numpy(packed.view(np.int32)), d)
    j = np.asarray(jqops.unpack_bits(packed, d)).astype(np.float32)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), j)


@pytest.mark.parametrize("d", [25, 96])
def test_bq_encode_prep_and_device_encode_are_jax_bits(d):
    v = _vectors(1, 300, d)
    v[0] = 0.0  # sign of zero: not set
    v[1, ::2] = -0.0
    j = jq.BinaryQuantizer(d, "l2-squared")
    t = BinaryQuantizer(d, "l2-squared")
    je, te = j.encode(v), t.encode(v)
    for name in ("packed", "popcount"):
        assert te[name].dtype == je[name].dtype
        np.testing.assert_array_equal(te[name], je[name])
    dev = t.encode_device(torch.from_numpy(v))
    np.testing.assert_array_equal(dev["packed"].numpy().view(np.uint32),
                                  je["packed"])
    np.testing.assert_array_equal(dev["popcount"].numpy(), je["popcount"])
    np.testing.assert_array_equal(t.prep(v[:5], "cpu").numpy().view(np.uint32),
                                  np.asarray(j.prep(v[:5])))
    assert t.fields() == j.fields() and t.fitted and t.min_training == 0


@pytest.mark.parametrize("metric", ["l2-squared", "cosine"])
def test_sq_fit_and_encode_are_jax_bits(metric):
    v = _vectors(2, 900, 48) * 3.0 + 0.5
    if metric == "cosine":
        v /= np.linalg.norm(v, axis=1, keepdims=True)
    j, t = jq.ScalarQuantizer(48, metric), ScalarQuantizer(48, metric)
    j.fit(v)
    t.fit(v)
    assert (t.a, t.s) == (j.a, j.s) and t.fitted
    je, te = j.encode(v), t.encode(v)
    for name in ("codes", "dec_sqnorm"):
        assert te[name].dtype == je[name].dtype
        np.testing.assert_array_equal(te[name], je[name])
    assert t.state_dict() == j.state_dict()
    assert t.fields() == j.fields()
    # a degenerate sample: the step stays positive, as JAX's
    j.fit(np.ones((10, 48), np.float32))
    t.fit(np.ones((10, 48), np.float32))
    assert (t.a, t.s) == (j.a, j.s)


def _set_state(s):
    if isinstance(s, DeviceArraySet):
        arrays, valid = s._host_state or s._state
        planes = {name: to_numpy(a, s.fields[name][1])
                  for name, a in arrays.items()}
        valid = valid.numpy()
    else:
        hs = s._host_state
        planes = {name: np.asarray(a) for name, a in
                  (hs[0] if hs is not None else s._state[0]).items()}
        valid = np.asarray(hs[1] if hs is not None else s._state[1])
    return planes, valid, s.watermark, s.live_count, s.capacity


def _assert_same_set(t, j):
    tp, tv, *tm = _set_state(t)
    jp, jv, *jm = _set_state(j)
    assert tm == jm
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(t.host_valid_mask, j.host_valid_mask)
    for name in jp:
        assert tp[name].dtype == jp[name].dtype
        np.testing.assert_array_equal(tp[name], jp[name])


def test_device_array_set_ops_match_jax():
    """put (growing past the first page), delete, re-put, snapshot and
    detach/attach: the same state as the JAX set after every step."""
    bq = jq.BinaryQuantizer(40, "l2-squared")
    fields = bq.fields()
    j = jstore.DeviceArraySet(fields, capacity=100)
    t = DeviceArraySet(fields, capacity=100, device="cpu")
    _assert_same_set(t, j)
    v = _vectors(3, 6000, 40)
    steps = [("put", np.arange(0, 3000)), ("put", np.arange(3000, 6000)),
             ("delete", np.arange(0, 6000, 7)),
             ("put", np.arange(0, 70, 7)), ("delete", np.array([9000]))]
    for op, ids in steps:
        if op == "put":
            enc = bq.encode(v[ids])
            j.put(ids, enc)
            t.put(ids, enc)
        else:
            j.delete(ids)
            t.delete(ids)
        _assert_same_set(t, j)
    planes, valid = t.snapshot()
    assert planes["packed"].dtype == torch.int32 and valid.dtype == torch.bool
    nbytes = t.nbytes
    assert nbytes == j.nbytes
    assert t.detach() == j.detach() == nbytes
    assert not t.device_resident and t.nbytes == 0 and t.host_bytes == nbytes
    _assert_same_set(t, j)
    with pytest.raises(RuntimeError, match="attach"):
        t.put(np.array([1]), bq.encode(v[:1]))
    assert t.attach() == j.attach() == nbytes
    _assert_same_set(t, j)
    # the snapshot taken before stays one consistent generation
    assert planes["packed"].shape[0] == valid.shape[0] == t.capacity


@pytest.mark.parametrize("tier", ["ram", "ram16"])
def test_host_vector_store_matches_jax(tier):
    dtype = raw_tier_dtype(tier)
    j = jstore.HostVectorStore(24, capacity=10, dtype=dtype)
    t = HostVectorStore(24, capacity=10, dtype=dtype)
    v = _vectors(4, 5000, 24)
    for s in (j, t):
        s.put(np.arange(5000), v)
        s.delete(np.arange(0, 5000, 3))
        s.put(np.array([3, 6]), v[:2])
    for attr in ("capacity", "watermark", "live_count", "nbytes"):
        assert getattr(t, attr) == getattr(j, attr), attr
    np.testing.assert_array_equal(t.valid, j.valid)
    ids = np.array([0, 3, 6, 4999, 17])
    np.testing.assert_array_equal(t.get(ids), j.get(ids))
    assert t.get(ids).dtype == np.float32
    np.testing.assert_array_equal(t.sample(100, seed=5), j.sample(100, seed=5))
    for a, b in zip(t.all_live(), j.all_live()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tier", ["disk16", "disk8"])
def test_disk_tiers_raise_naming_slice_9(tier):
    with pytest.raises(NotImplementedError, match="slice 9"):
        raw_tier_dtype(tier)
    with pytest.raises(NotImplementedError, match="slice 9"):
        HostVectorStore(8, dtype=np.int8)
    cfg = config.FlatIndexConfig(quantizer=config.BQConfig(), raw_tier=tier)
    with pytest.raises(NotImplementedError, match="slice 9"):
        make_flat(8, cfg, device="cpu")


@pytest.mark.parametrize("qcfg", [config.PQConfig(), config.RQConfig()],
                         ids=["pq", "rq"])
def test_pq_and_rq_raise_naming_slice_4b(qcfg):
    """Once the routes that raised until slice 4b: PQ and RQ now build
    through ``build_quantizer`` (JAX's quantizer, fields and state) and
    ``make_flat``, whose index answers as JAX's ``make_flat`` does, and
    the scans and gathers exist."""
    jcfg = {"pq": jconfig.PQConfig, "rq": jconfig.RQConfig}[qcfg.kind]()
    t = build_quantizer(qcfg, 16, "l2-squared", device="cpu")
    j = jq.build_quantizer(jcfg, 16, "l2-squared")
    assert type(t).__name__ == type(j).__name__
    assert t.fields() == j.fields() and t.state_dict() == j.state_dict()
    v = _vectors(12, 600, 16)
    tidx = make_flat(16, config.FlatIndexConfig(
        distance="l2-squared", quantizer=qcfg), device="cpu")
    from weaviate_tpu.index.flat import make_flat as jmake_flat
    jidx = jmake_flat(16, jconfig.FlatIndexConfig(distance="l2-squared",
                                                  quantizer=jcfg))
    for idx in (tidx, jidx):
        idx.add_batch(np.arange(600), v)
    tr, jr = tidx.search(v[:6], 5), jidx.search(v[:6], 5)
    np.testing.assert_array_equal(tr.ids, jr.ids)
    np.testing.assert_allclose(tr.dists, jr.dists, rtol=1e-5, atol=1e-4)
    for fn in (qops.pq_search, qops.rq_search, qops.pq_gather_distance,
               qops.rq_gather_distance):
        assert callable(fn)


@pytest.mark.parametrize("kind,metric", [
    ("sq", "manhattan"), ("sq", "hamming"), ("bq", "hamming"),
    ("bq", "manhattan"), ("sq", "cosine"), ("pq", "hamming"),
    ("pq", "manhattan"), ("pq", "dot"), ("rq", "manhattan"),
    ("rq", "hamming"), ("rq", "cosine"),
])
def test_quantizer_metric_checks_match_jax(kind, metric):
    jc = {"bq": jconfig.BQConfig, "sq": jconfig.SQConfig,
          "pq": jconfig.PQConfig, "rq": jconfig.RQConfig}[kind]()
    tc = {"bq": config.BQConfig, "sq": config.SQConfig,
          "pq": config.PQConfig, "rq": config.RQConfig}[kind]()
    try:
        want = type(jq.build_quantizer(jc, 16, metric)).__name__
    except ValueError:
        with pytest.raises(ValueError):
            build_quantizer(tc, 16, metric)
        return
    assert type(build_quantizer(tc, 16, metric)).__name__ == want
    assert build_quantizer(None, 16, metric) is None


def test_interop_builds_the_ports_quantizer_and_code_set():
    v = _vectors(6, 5000, 33)
    jsq = jq.ScalarQuantizer(33, "dot")
    jsq.fit(v)
    tsq = interop.quantizer_from_state(jsq.state_dict())
    assert isinstance(tsq, ScalarQuantizer)
    assert tsq.state_dict() == jsq.state_dict()
    np.testing.assert_array_equal(tsq.encode(v)["codes"],
                                  jsq.encode(v)["codes"])
    jbq = jq.BinaryQuantizer(33, "cosine")
    tbq = interop.quantizer_from_state(jbq.state_dict(), config.BQConfig(
        rescore_limit=7))
    assert isinstance(tbq, BinaryQuantizer) and tbq.config.rescore_limit == 7
    with pytest.raises(ValueError, match="kind"):
        interop.quantizer_from_state({"kind": "zz", "dims": 3,
                                      "metric": "dot"})
    # PQ's and RQ's planes (codes; lower, step; decoded norms) cross too
    jpq = jq.ProductQuantizer(33, "l2-squared", jconfig.PQConfig(segments=11))
    jpq.fit(v[:1000])
    jrq = jq.RotationalQuantizer(33, "dot")
    jrq.fit(v)
    for quant in (jbq, jsq, jpq, jrq):
        j = jstore.DeviceArraySet(quant.fields(), capacity=5000)
        j.put(np.arange(5000), quant.encode(v))
        j.delete(np.arange(0, 5000, 9))
        planes, valid = j.snapshot()
        t = interop.array_set_from_numpy(
            quant.fields(), {k: np.asarray(a) for k, a in planes.items()},
            np.asarray(valid), j.watermark, j.live_count, device="cpu")
        _assert_same_set(t, j)
    with pytest.raises(ValueError, match="planes"):
        interop.array_set_from_numpy(jbq.fields(), {}, np.zeros(4096, bool),
                                     0, 0, device="cpu")
