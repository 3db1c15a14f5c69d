"""The port's time-series rings (utils/timeseries.py) against the JAX
package's.

Both packages' `Ring` and `RingSet` take the same seeded pushes
(timestamps with gaps and ties, values with repeats, enough samples to
wrap the ring) and must give equal samples, windows, newest samples,
means, quantiles, rates, bad fractions, lengths and snapshots, at
several windows and evaluation times, including empty windows (None).
Tolerance: none (both are the same float arithmetic in the same order).
"""

import threading
import time

import numpy as np
import pytest

from gubernator_tpu.utils import timeseries as jts
from gubernator_tpu_torch.utils import timeseries as pts

WINDOWS = (0.5, 3.0, 10.0, 47.5, 1e6)
QS = (0.0, 0.25, 0.5, 0.9, 0.99, 1.0)


def pushes(seed, n):
    """n (value, ts) pairs: timestamps rising in steps of 0-3 s (some
    ties), values drawn with repeats and a few large ones."""
    rng = np.random.default_rng(seed)
    ts = 1000.0 + np.cumsum(rng.choice([0.0, 0.25, 1.0, 3.0], n, p=[0.1, 0.3, 0.5, 0.1]))
    vals = np.where(rng.random(n) < 0.1, rng.random(n) * 1e6, rng.integers(0, 5, n) * 0.5)
    return [(float(v), float(t)) for v, t in zip(vals, ts)]


def reductions(ring, now):
    out = {"len": len(ring), "samples": ring.samples(), "last": ring.last()}
    for w in WINDOWS:
        out[("window", w)] = ring.window(w, now)
        out[("mean", w)] = ring.mean(w, now)
        out[("rate", w)] = ring.rate(w, now)
        out[("bad", w)] = ring.bad_fraction(lambda v: v > 1.0, w, now)
        for q in QS:
            out[("q", q, w)] = ring.quantile(q, w, now)
    return out


@pytest.mark.parametrize("seed,capacity,n", [
    (0, 720, 50),     # no wrap
    (1, 16, 50),      # wrapped three times
    (2, 1, 7),        # capacity one
    (3, 33, 33),      # exactly full
    (4, 64, 0),       # empty: every reduction None
    (5, 128, 1000),   # long wrap
])
def test_ring_reductions_match_jax(seed, capacity, n):
    """Samples, windows and every windowed reduction equal after the
    same pushes, evaluated before, at and after the newest sample."""
    jr, pr = jts.Ring(capacity), pts.Ring(capacity)
    data = pushes(seed, n)
    for i, (v, t) in enumerate(data):
        jr.push(v, t)
        pr.push(v, t)
        if i % 97 == 0:
            assert reductions(pr, t) == reductions(jr, t)
    end = data[-1][1] if data else 1000.0
    for now in (end - 5.0, end, end + 2.0, end + 1e5):
        assert reductions(pr, now) == reductions(jr, now)
    if not data:
        assert all(v is None for k, v in reductions(pr, end).items()
                   if isinstance(k, tuple) and k[0] != "window")


def test_ring_errors_match_jax():
    """A capacity below one and a quantile outside [0, 1] raise the same
    ValueError in both packages."""
    for bad in (0, -3):
        with pytest.raises(ValueError) as je:
            jts.Ring(bad)
        with pytest.raises(ValueError) as pe:
            pts.Ring(bad)
        assert str(pe.value) == str(je.value)
    jr, pr = jts.Ring(4), pts.Ring(4)
    for q in (-0.1, 1.5):
        with pytest.raises(ValueError) as je:
            jr.quantile(q, 10.0, 0.0)
        with pytest.raises(ValueError) as pe:
            pr.quantile(q, 10.0, 0.0)
        assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("window", [None, 300.0])
def test_ringset_snapshot_matches_jax(window):
    """RingSet names, get, lazy ring creation and snapshot (the windowed
    mean on the monotonic clock: samples well inside or well outside the
    window) equal."""
    base = time.monotonic()
    jset, pset = jts.RingSet(8), pts.RingSet(8)
    rng = np.random.default_rng(7)
    for name in ("serving_ok", "flush_p99_s", "page_demotes", "a", "z"):
        for _ in range(int(rng.integers(1, 12))):
            v = float(rng.random() * 3)
            ts = base - float(rng.choice([10_000.0, 50.0, 5.0]))
            jset.push(name, v, ts)
            pset.push(name, v, ts)
    assert pset.names() == jset.names()
    assert pset.get("missing") is None and jset.get("missing") is None
    assert pset.snapshot(window_s=window) == jset.snapshot(window_s=window)
    assert pset.ring("new").capacity == jset.ring("new").capacity == 8
    assert pset.snapshot() == jset.snapshot()


def test_ring_concurrent_pushes_lose_nothing():
    """Eight threads push into one ring (capacity above the total) while
    a reader reduces: every sample lands once, and a wrapped ring holds
    exactly its capacity."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for cap, per in ((8 * 400, 400), (100, 400)):
            ring = pts.Ring(cap)
            stop = threading.Event()

            def push(k, ring=ring, per=per):
                for i in range(per):
                    ring.push(float(k), float(k * per + i))

            def read(ring=ring):
                while not stop.is_set():
                    ring.mean(1e9, 1e9)

            reader = threading.Thread(target=read)
            reader.start()
            threads = [threading.Thread(target=push, args=(k,)) for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            stop.set()
            reader.join(timeout=30)
            assert not reader.is_alive() and not any(t.is_alive() for t in threads)
            assert len(ring) == min(cap, 8 * per) == len(ring.samples())
            if cap >= 8 * per:
                assert sorted(t for t, _ in ring.samples()) == [float(i) for i in range(8 * per)]
    finally:
        sys.setswitchinterval(old)
