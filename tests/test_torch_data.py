"""The port's data pipeline against ``repro.data``.

``SyntheticLMStream.batch_at`` of both packages equal bit for bit over
several steps, seeds, vocabularies and host shardings;
``PrefetchIterator``'s order, ``seek``, ``batch_at``, close and context
manager; and the reference's own ``TestData`` cases
(``tests/test_runtime.py``) on the port.
"""
import threading

import numpy as np
import pytest

from repro import data as jdata
from repro_torch import data as tdata

STEPS = (0, 1, 7, 63, 64, 1000)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("hosts", [(1, 0), (2, 0), (2, 1), (4, 3)],
                         ids=lambda h: f"host{h[1]}of{h[0]}")
@pytest.mark.parametrize("vocab", [50, 32000])
def test_batch_at_equals_the_reference_bit_for_bit(seed, hosts, vocab):
    num_hosts, host_id = hosts
    kw = dict(vocab_size=vocab, seq_len=24, global_batch=8, seed=seed,
              num_hosts=num_hosts, host_id=host_id)
    js = jdata.SyntheticLMStream(jdata.DataConfig(**kw))
    ts = tdata.SyntheticLMStream(tdata.DataConfig(**kw))
    assert ts.local_batch == js.local_batch == 8 // num_hosts
    np.testing.assert_array_equal(ts.unigram, js.unigram)
    np.testing.assert_array_equal(ts.shift, js.shift)
    for step in STEPS:
        (tx, ty), (jx, jy) = ts.batch_at(step), js.batch_at(step)
        assert tx.dtype == jx.dtype == np.int32
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


def test_iteration_equals_the_reference():
    kw = dict(vocab_size=100, seq_len=8, global_batch=4, seed=5)
    ti = iter(tdata.SyntheticLMStream(tdata.DataConfig(**kw)))
    ji = iter(jdata.SyntheticLMStream(jdata.DataConfig(**kw)))
    for _ in range(5):
        (tx, ty), (jx, jy) = next(ti), next(ji)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


def test_uneven_host_split_raises():
    with pytest.raises(ValueError, match="divide evenly"):
        tdata.SyntheticLMStream(tdata.DataConfig(vocab_size=10, seq_len=4,
                                                 global_batch=6,
                                                 num_hosts=4))


def _stream():
    return tdata.SyntheticLMStream(tdata.DataConfig(vocab_size=50,
                                                    seq_len=8,
                                                    global_batch=2))


def test_prefetch_order_seek_and_close():
    s = _stream()
    it = tdata.PrefetchIterator(s, start_step=3, daemon=False)
    try:
        got = [next(it) for _ in range(4)]
        assert [step for step, _ in got] == [3, 4, 5, 6]
        for step, (x, y) in got:
            np.testing.assert_array_equal(x, s.batch_at(step)[0])
            np.testing.assert_array_equal(y, s.batch_at(step)[1])
        it.seek(40)                    # buffered batches are dropped
        assert next(it)[0] == 40
        np.testing.assert_array_equal(it.batch_at(41)[0], s.batch_at(41)[0])
        np.testing.assert_array_equal(it.batch_at(2)[0], s.batch_at(2)[0])
        assert next(it)[0] == 3
    finally:
        it.close()
    it.thread.join(timeout=5)
    assert not it.thread.is_alive()
    it.close()                          # idempotent


def test_prefetch_context_manager_joins_the_worker():
    before = threading.active_count()
    with tdata.PrefetchIterator(_stream(), daemon=False) as it:
        assert it.batch_at(0)[0].shape == (2, 8)
        assert it.thread.is_alive()
    it.thread.join(timeout=5)
    assert not it.thread.is_alive()
    assert threading.active_count() <= before


def test_prefetch_serves_what_the_reference_serves():
    kw = dict(vocab_size=64, seq_len=8, global_batch=4, seed=1)
    with tdata.PrefetchIterator(tdata.SyntheticLMStream(
            tdata.DataConfig(**kw)), daemon=False) as ti, \
            jdata.PrefetchIterator(jdata.SyntheticLMStream(
                jdata.DataConfig(**kw)), daemon=False) as ji:
        for step in (0, 1, 2, 9, 10, 4):
            np.testing.assert_array_equal(ti.batch_at(step)[0],
                                          ji.batch_at(step)[0])


# ---------------------------------------------------------------------------
# the reference's TestData, on the port
# ---------------------------------------------------------------------------

def test_deterministic_replay():
    s = tdata.SyntheticLMStream(tdata.DataConfig(vocab_size=100, seq_len=16,
                                                 global_batch=8, seed=3))
    x1, y1 = s.batch_at(7)
    x2, y2 = s.batch_at(7)
    np.testing.assert_array_equal(x1, x2)
    np.testing.assert_array_equal(y1, y2)


def test_host_sharding_partitions_batch():
    h0, h1 = (tdata.SyntheticLMStream(tdata.DataConfig(
        vocab_size=100, seq_len=8, global_batch=8, num_hosts=2, host_id=h))
        for h in (0, 1))
    assert h0.local_batch == 4 and h1.local_batch == 4
    x0, _ = h0.batch_at(0)
    x1, _ = h1.batch_at(0)
    assert x0.shape == (4, 8)
    assert not np.array_equal(x0, x1)


def test_labels_are_next_tokens():
    s = tdata.SyntheticLMStream(tdata.DataConfig(vocab_size=50, seq_len=12,
                                                 global_batch=2))
    x, y = s.batch_at(0)
    np.testing.assert_array_equal(x[:, 1:], y[:, :-1])
