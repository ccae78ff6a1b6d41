"""The port's data pipeline (``repro_torch.data.pipeline``) against the
reference's: documents and batches bit for bit, the reference's three
iterator tests (``tests/test_runtime.py``) on the port, and a resume across
the packages."""
import json

import numpy as np
import pytest

from repro.data import pipeline as jp
from repro_torch.data import pipeline as tp


@pytest.mark.parametrize("seed,index", [(0, 0), (3, 7), (1000, 123456)])
def test_token_source_doc_is_bitwise_the_reference(seed, index):
    got = tp.TokenSource(1000, seed=seed).doc(index)
    want = jp.TokenSource(1000, seed=seed).doc(index)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_batches_are_bitwise_the_reference_over_several_steps(shard):
    kw = dict(vocab_size=300, seq_len=24, global_batch=8, num_microbatches=4, seed=5,
              shard_index=shard[0], shard_count=shard[1])
    got, want = tp.DataIterator(**kw), jp.DataIterator(**kw)
    for _ in range(5):
        b, w = next(got), next(want)
        assert b.keys() == w.keys() == {"tokens", "labels"}
        for k in b:
            assert b[k].dtype == w[k].dtype and b[k].shape == w[k].shape
            np.testing.assert_array_equal(b[k], w[k])
        # next-token labels
        np.testing.assert_array_equal(b["tokens"][..., 1:], b["labels"][..., :-1])
    assert got.state_dict() == want.state_dict()


def test_data_iterator_deterministic_and_resumable():
    it1 = tp.DataIterator(vocab_size=100, seq_len=16, global_batch=8, num_microbatches=2, seed=3)
    b1 = next(it1)
    state = it1.state_dict()
    b2 = next(it1)

    it2 = tp.DataIterator(vocab_size=100, seq_len=16, global_batch=8, num_microbatches=2, seed=3)
    next(it2)
    it2.load_state_dict(json.loads(json.dumps(state)))  # survives JSON
    b2b = next(it2)
    np.testing.assert_array_equal(b2["tokens"], b2b["tokens"])
    assert b1["tokens"].shape == (2, 4, 16)
    assert (b1["tokens"] >= 0).all() and (b1["tokens"] < 100).all()
    assert not np.array_equal(b1["tokens"], b2["tokens"])


def test_data_iterator_shards_disjoint():
    a = tp.DataIterator(vocab_size=50, seq_len=8, global_batch=8, num_microbatches=2, seed=1,
                        shard_index=0, shard_count=2)
    b = tp.DataIterator(vocab_size=50, seq_len=8, global_batch=8, num_microbatches=2, seed=1,
                        shard_index=1, shard_count=2)
    ba, bb = next(a), next(b)
    assert ba["tokens"].shape == (2, 2, 8)
    assert not np.array_equal(ba["tokens"], bb["tokens"])


def test_a_reference_cursor_resumes_the_port_bitwise():
    """The cursor a reference checkpoint carries (``extra["data_state"]``)
    resumes the port's iterator where the reference's would go on."""
    kw = dict(vocab_size=200, seq_len=32, global_batch=4, num_microbatches=2, seed=2)
    ref = jp.DataIterator(**kw)
    for _ in range(3):
        next(ref)
    port = tp.DataIterator(**kw)
    port.load_state_dict(json.loads(json.dumps(ref.state_dict())))
    for _ in range(2):
        np.testing.assert_array_equal(next(port)["tokens"], next(ref)["tokens"])
