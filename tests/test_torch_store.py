"""Parity: weaviate_tpu_torch/index/store.py DeviceVectorStore against the JAX
DeviceVectorStore — put, delete, growth, snapshot, warm tier, and checkpoints
that either package reads from the other — plus interop.store_from_numpy.

Masks and counts are compared exactly; stored rows and squared norms to
float32 rounding (rtol 1e-6), which normalized rows need: the two packages
sum a row's norm in another order.
"""

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from weaviate_tpu.compression.store import ResidencyMoved as JaxMoved
from weaviate_tpu.index.store import DeviceVectorStore as JaxStore
from weaviate_tpu_torch.compression.store import ResidencyMoved
from weaviate_tpu_torch.index.store import DeviceVectorStore
from weaviate_tpu_torch.interop import store_from_numpy

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(dtype="float32", normalized=False, dims=8):
    jd, td = DTYPES[dtype]
    return (JaxStore(dims, capacity=100, dtype=jd, normalized=normalized),
            DeviceVectorStore(dims, capacity=100, dtype=td,
                              normalized=normalized, device="cpu"))


def _writes(j, t, seed=0, dims=8):
    rng = np.random.default_rng(seed)
    for ids in (np.arange(0, 300), np.array([5, 4100, 17]),  # 4100 grows
                np.arange(290, 310)):                         # overwrite
        vecs = rng.standard_normal((len(ids), dims)).astype(np.float32)
        j.put(ids, vecs)
        t.put(ids, vecs)
    for ids in (np.array([3, 4, 5, 9999]), np.array([4, 300])):
        j.delete(ids)
        t.delete(ids)


def _as_np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _same_state(j, t):
    assert (t.capacity, t.watermark, t.live_count) == \
        (j.capacity, j.watermark, j.live_count)
    np.testing.assert_array_equal(t.host_valid_mask, j.host_valid_mask)
    jc, jv, js = j.snapshot()
    tc, tv, ts = t.snapshot()
    np.testing.assert_allclose(tc.float().numpy(), _as_np(jc), rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)
    for i in (0, 4, 5, 17, 299, 4100, 4101, 10**6):
        assert t.contains(i) == j.contains(i)
    ids = np.array([0, 17, 4100])
    np.testing.assert_allclose(t.get(ids), _as_np(j.get(ids)), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_writes_growth_and_snapshot_match(dtype, normalized):
    j, t = _pair(dtype, normalized)
    _writes(j, t)
    assert t.capacity == 8192  # 4096 doubled by the id 4100 write
    _same_state(j, t)
    with pytest.raises(ValueError):
        t.put(np.array([1]), np.zeros((1, 7), np.float32))


def test_snapshot_is_copy_on_write():
    _, t = _pair()
    t.put(np.arange(10), np.ones((10, 8), np.float32))
    corpus, valid, sq = t.snapshot()
    t.put(np.arange(5), np.zeros((5, 8), np.float32))
    t.delete(np.arange(5, 10))
    assert bool((corpus[:10] == 1).all()) and bool(valid[:10].all())
    assert t.snapshot()[0] is not corpus


def test_detach_attach_match():
    j, t = _pair()
    _writes(j, t, seed=1)
    assert t.nbytes == j.nbytes
    assert t.detach() == j.detach()
    assert not t.device_resident and not j.device_resident
    assert t.host_bytes == j.host_bytes and t.nbytes == 0
    assert t.detach() == 0
    with pytest.raises(ResidencyMoved):
        t.snapshot()
    with pytest.raises(JaxMoved):
        j.snapshot()
    with pytest.raises(ResidencyMoved):
        t.put(np.array([1]), np.zeros((1, 8), np.float32))
    np.testing.assert_array_equal(t.get(np.array([0, 17])),
                                  _as_np(j.get(np.array([0, 17]))))
    assert t.attach() == j.attach()
    assert t.device_resident and t.host_bytes == 0
    _same_state(j, t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_load(tmp_path, dtype):
    j, t = _pair(dtype, normalized=True)
    _writes(j, t, seed=2)
    jpath, tpath = str(tmp_path / "jax.ckpt"), str(tmp_path / "torch.ckpt")
    j.save(jpath, {"from": "jax"})
    t.save(tpath, {"from": "torch"})
    # JAX save -> port load, port save -> JAX load
    t2 = DeviceVectorStore(8, dtype=DTYPES[dtype][1], normalized=True,
                           device="cpu")
    assert t2.load(jpath) == {"from": "jax"}
    j2 = JaxStore(8, dtype=DTYPES[dtype][0], normalized=True)
    assert j2.load(tpath) == {"from": "torch"}
    _same_state(j, t2)
    _same_state(j2, t)
    # the two files hold the same fields, byte for byte but for meta and
    # the float32 rounding of normalized rows and their norms
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        ja, tb = msgpack.unpackb(a.read()), msgpack.unpackb(b.read())
    for field, raw in (("sqnorms", np.float32), ("corpus", np.float32 if
                                                  dtype == "float32" else np.int16)):
        x, y = (np.frombuffer(f.pop(field), raw) for f in (ja, tb))
        if raw is np.int16:  # bf16 bits: compare as bf16 values
            x, y = (torch.from_numpy(z.copy()).view(torch.bfloat16).float()
                    .numpy() for z in (x, y))
        np.testing.assert_allclose(y, x, rtol=1e-6, atol=1e-6)
    assert {**ja, "meta": None} == {**tb, "meta": None}


def test_load_refuses_absent_torn_and_foreign_files(tmp_path):
    _, t = _pair()
    assert t.load(str(tmp_path / "none")) is None
    torn = tmp_path / "torn"
    torn.write_bytes(b"\x81\xa7version\x01")
    assert t.load(str(torn)) is None
    other = DeviceVectorStore(4, device="cpu")
    other.put(np.arange(3), np.ones((3, 4), np.float32))
    other.save(str(tmp_path / "dims4"))
    assert t.load(str(tmp_path / "dims4")) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_store_from_numpy(dtype):
    j, t = _pair(dtype)
    _writes(j, t, seed=3)
    corpus, valid, sq = (np.asarray(a) for a in j.snapshot())
    s = store_from_numpy(corpus, valid, sq, j.watermark, j.live_count,
                         j.normalized, device="cpu")
    assert s.dtype == DTYPES[dtype][1]
    _same_state(j, s)
    with pytest.raises(ValueError):
        store_from_numpy(corpus[:100], valid[:100], sq[:100], 0, 0, False,
                         device="cpu")
