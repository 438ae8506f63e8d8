"""The Pallas-Triton bit-distance kernel (ops/pallas/hamming.py): interpret
mode against the plain XLA reference, and the flat scan's choice of
implementation (vectorstore.store.bit_scan)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from semadb_tpu.ops.distance import pairwise_bit_distance
from semadb_tpu.ops.pallas import hamming
from semadb_tpu.vectorstore import store

RNG = np.random.default_rng(11)


def _codes(b, n, w):
    q = RNG.integers(0, 2**32, (b, w), dtype=np.uint32)
    x = RNG.integers(0, 2**32, (n, w), dtype=np.uint32)
    x[0] = 0  # an all-zero code: jaccard's empty-union branch
    q[0] = 0
    return jnp.asarray(q), jnp.asarray(x)


@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
@pytest.mark.parametrize("w", [1, 4, 48])
@pytest.mark.parametrize("b,n", [(5, 7), (70, 300)])  # not tile multiples
def test_interpret_matches_plain(metric, w, b, n):
    """B and N that are not tile multiples exercise the masked edges."""
    q, x = _codes(b, n, w)
    got = hamming.pairwise_bit_distance_pallas(q, x, metric, interpret=True)
    want = pairwise_bit_distance(q, x, metric)
    assert got.shape == (b, n) and got.dtype == jnp.float32
    if metric == "hamming":
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-6)


def test_interpret_default_tiles():
    q, x = _codes(hamming.TILE_B + 3, hamming.TILE_N + 5, 4)
    got = hamming.pairwise_bit_distance_pallas(q, x, "hamming", interpret=True)
    np.testing.assert_array_equal(
        np.asarray(got), np.asarray(pairwise_bit_distance(q, x, "hamming"))
    )


def test_high_bit_words_count_as_unsigned():
    """Words with the top bit set are reinterpreted as negative int32 inside
    the kernel; their popcount must still be the unsigned one."""
    q = jnp.full((3, 2), 0xFFFFFFFF, jnp.uint32)
    x = jnp.asarray(np.array([[0, 0], [0x80000000, 1], [0xFFFFFFFF, 0xFFFFFFFF]], np.uint32))
    got = hamming.pairwise_bit_distance_pallas(q, x, "hamming", interpret=True)
    np.testing.assert_array_equal(np.asarray(got)[0], [64.0, 62.0, 0.0])


def test_unknown_metric_raises():
    q, x = _codes(2, 3, 1)
    with pytest.raises(ValueError, match="unknown bit distance"):
        hamming.pairwise_bit_distance_pallas(q, x, "cosine", interpret=True)


def test_bit_scan_takes_plain_path_off_gpu(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel must not run off the GPU")

    monkeypatch.setattr(hamming, "pairwise_bit_distance_pallas", boom)
    q, x = _codes(4, 9, 4)
    np.testing.assert_array_equal(
        np.asarray(store.bit_scan(q, x, "hamming")),
        np.asarray(pairwise_bit_distance(q, x, "hamming")),
    )


def test_bit_scan_takes_kernel_on_gpu(monkeypatch):
    calls = []

    def fake_kernel(q, x, metric):
        calls.append(metric)
        return jnp.zeros((q.shape[0], x.shape[0]), jnp.float32)

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(hamming, "pairwise_bit_distance_pallas", fake_kernel)
    q, x = _codes(4, 9, 4)
    store.bit_scan(q, x, "jaccard")
    assert calls == ["jaccard"]


def test_flat_bq_search_through_bit_scan():
    """The flat index's binary-quantized search ranks by the bit scan."""
    from semadb_tpu.index.flat import IndexFlat
    from semadb_tpu.models.quantizer import BinaryQuantizerParams, Quantizer
    from semadb_tpu.models.schema import VectorFlatParams

    vecs = RNG.standard_normal((400, 64)).astype(np.float32)
    idx = IndexFlat(VectorFlatParams(
        vector_size=64, distance_metric="euclidean",
        quantizer=Quantizer(type="binary", binary=BinaryQuantizerParams(
            distance_metric="hamming", trigger_threshold=100)),
    ))
    idx.insert_update_delete(zip(range(2, 402), vecs))
    assert idx.store.fitted
    d, ids = idx.search_batch(vecs[:5], 3)
    np.testing.assert_array_equal(ids[:, 0], np.arange(2, 7))
    assert (d[:, 0] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
def test_compiled_kernel_matches_plain_on_gpu(gpu, metric):
    q, x = _codes(1024, 100_000, 48)
    got = np.asarray(hamming.pairwise_bit_distance_pallas(q, x, metric))
    want = np.asarray(pairwise_bit_distance(q, x, metric))
    if metric == "hamming":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
