"""Host prefetch of the trainers (`interdiff_torch/utils/prefetch.py`)
against its contract and `interdiff_tpu/utils/prefetch.py`: the batches of
`threaded_batches` bitwise those of the source, in order, over a shuffling
`batch_iterator` whose dataset draws from the shared generator (1 or 2
workers, buffer 1 or 4, and 8 workers with a short switch interval); a
source that raises at item k delivers k items, then raises in the consumer;
a consumer that stops early stops the workers; `device_prefetch` yields every batch once, in order, placed on the CPU."""

import itertools
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.utils import prefetch as jprefetch  # noqa: E402
from interdiff_torch.cli.common import batch_iterator  # noqa: E402
from interdiff_torch.utils.prefetch import (  # noqa: E402
    WORKER_NAME,
    device_prefetch,
    place_batch,
    threaded_batches,
)

TIMEOUT = 30.0


class _JitterDataset:
    """Clips whose window jitter comes from the shared generator, as
    `data/behave.py::BehaveDataset` draws it."""

    def __init__(self, rng, n=37):
        self.rng = rng
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((3,), i, np.float32) + self.rng.standard_normal(
            3).astype(np.float32), "i": np.int64(i)}


def _collate(items):
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def _make(seed):
    rng = np.random.default_rng(seed)
    ds = _JitterDataset(rng)
    return lambda: batch_iterator(ds, _collate, batch_size=4, rng=rng)


def _consume(it, out: list, errors: list):
    try:
        for b in it:
            out.append(b)
    except Exception as e:  # noqa: BLE001 - handed to the test's thread
        errors.append(e)


def _bounded(it):
    """Drain ``it`` on a thread that must finish within TIMEOUT."""
    out, errors = [], []
    t = threading.Thread(target=_consume, args=(it, out, errors),
                         daemon=True)
    t.start()
    t.join(TIMEOUT)
    assert not t.is_alive(), "the consumer did not finish: a deadlock"
    return out, errors


def _assert_same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("num_workers,buffer", [(1, 1), (1, 4), (2, 1),
                                                (2, 4)])
def test_threaded_batches_are_the_sources_in_order(num_workers, buffer):
    want = list(_make(5)())
    got, errors = _bounded(threaded_batches(
        _make(5), num_workers=num_workers, buffer=buffer))
    assert not errors
    _assert_same(got, want)
    # the JAX package's threaded_batches gives the same stream
    _assert_same(list(jprefetch.threaded_batches(
        _make(5), num_workers=num_workers, buffer=buffer)), want)


def test_threaded_batches_under_many_workers_and_switches():
    want = list(_make(6)())
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got, errors = _bounded(threaded_batches(_make(6), num_workers=8,
                                                buffer=2))
    finally:
        sys.setswitchinterval(old)
    assert not errors
    _assert_same(got, want)


@pytest.mark.parametrize("num_workers", [1, 2])
def test_a_source_error_reaches_the_consumer(num_workers):
    k = 3

    def source():
        for i in range(10):
            if i == k:
                raise RuntimeError(f"clip {i} is broken")
            yield {"i": np.int64(i)}

    got, errors = _bounded(threaded_batches(source, num_workers=num_workers,
                                            buffer=2))
    assert [int(b["i"]) for b in got] == list(range(k))
    assert len(errors) == 1 and "clip 3 is broken" in str(errors[0])


def _no_workers_left() -> bool:
    """Whether every `threaded_batches` worker ends within TIMEOUT."""
    deadline = time.monotonic() + TIMEOUT
    while any(t.name == WORKER_NAME for t in threading.enumerate()):
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


@pytest.mark.parametrize("how", ["close", "raise"])
def test_a_consumer_that_stops_early_stops_the_workers(how):
    def endless():
        for i in itertools.count():
            yield {"i": np.int64(i)}

    assert _no_workers_left()  # those of the tests before
    it = threaded_batches(endless, num_workers=2, buffer=1)
    try:
        for b in it:
            if how == "raise" and int(b["i"]) == 2:
                raise KeyError("a step failed")
            if int(b["i"]) == 2:
                it.close()
    except KeyError:
        pass
    del it  # a raise leaves the generator to be collected
    assert _no_workers_left(), "the workers outlived their consumer"


@pytest.mark.parametrize("size", [1, 2, 50])
def test_device_prefetch_yields_every_batch_once_in_order(size):
    batches = list(_make(7)())
    placed = list(device_prefetch(iter(batches), size=size, device="cpu"))
    assert len(placed) == len(batches)
    for p, b in zip(placed, batches):
        assert set(p) == set(b)
        for k in b:
            assert isinstance(p[k], torch.Tensor)
            np.testing.assert_array_equal(p[k].numpy(), b[k])
    # an explicit place is called once a batch, in order
    seen = []
    out = list(device_prefetch(iter(batches), size=size,
                               place=lambda b: seen.append(b) or b))
    assert seen == out == batches


def test_place_batch_keeps_the_named_keys():
    b = next(iter(_make(8)()))
    placed = place_batch(b, "cpu", ["x"])
    assert list(placed) == ["x"]
    assert torch.equal(placed["x"], torch.from_numpy(b["x"]))
    # a batch of tensors (the correction trainers' callers may pass them)
    tensors = {k: torch.from_numpy(v) for k, v in b.items()}
    again = place_batch(tensors, "cpu")
    assert set(again) == set(b) and again["x"] is tensors["x"]
