"""The port's V1Service + DeviceEngine against the JAX package's.

One seeded request stream (duplicates inside a call, a key hot enough
to hit the wave cap, Gregorian items, invalid items, RESET_REMAINING and
DRAIN_OVER_LIMIT, negative and zero limits) goes through both services
on one frozen clock. Every response and the final `snapshot()` must be
equal. State also carries across: a JAX snapshot restored into the port
(and the port's back into a fresh JAX engine) keeps agreeing on further
requests. The port runs on the CPU here, so its decide is the plain
PyTorch version.
"""

import asyncio

import numpy as np
import pytest
import torch

from gubernator_tpu.api import keys as jkeys
from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.runtime.engine import DeviceEngine as JEngine
from gubernator_tpu.runtime.engine import EngineConfig as JConfig
from gubernator_tpu.service.server import ApiError as JApiError
from gubernator_tpu.service.server import V1Service as JService
from gubernator_tpu_torch.api.types import RateLimitReq
from gubernator_tpu_torch.runtime.engine import DeviceEngine, EngineConfig
from gubernator_tpu_torch.service.server import ApiError, V1Service

NOW = 1_753_700_000_000
NUM_GROUPS = 256
BATCH = 64


class Clock:
    def __init__(self):
        self.ms = NOW

    def __call__(self):
        return self.ms


def _jax_service(clock):
    eng = JEngine(
        JConfig(num_groups=NUM_GROUPS, batch_size=BATCH, batch_wait_s=0.002),
        now_fn=clock,
    )
    return JService(eng, now_fn=clock), eng


def _port_service(clock):
    eng = DeviceEngine(
        EngineConfig(
            num_groups=NUM_GROUPS, batch_size=BATCH, batch_wait_s=0.002,
            device="cpu",
        ),
        now_fn=clock,
    )
    return V1Service(eng, now_fn=clock), eng


def make_calls(seed, n_calls, n_items=120):
    """Request dicts per call: Zipf(1.1) keys bounded to 400, 70% token / 30%
    leaky, one hot key repeated past the wave cap, a few Gregorian and
    invalid items."""
    rng = np.random.default_rng(seed)
    calls = []
    for c in range(n_calls):
        items = []
        w = np.arange(1, 401, dtype=np.float64) ** -1.1
        ks = rng.choice(400, n_items, p=w / w.sum()) + 1
        for i in range(n_items):
            behavior = int(rng.choice([0] * 16 + [8, 32, 40]))
            duration = int(rng.choice([30, 1000, 60_000, 600_000]))
            if rng.random() < 0.04:
                behavior |= 4
                duration = int(rng.choice([0, 1, 2]))
            items.append(dict(
                name="rl",
                unique_key=f"acct:{int(ks[i])}",
                algorithm=int(rng.random() < 0.3),
                behavior=behavior,
                duration=duration,
                limit=int(rng.choice([-5, 0, 1, 10, 100, 1000])),
                hits=int(rng.choice([0, 1, 1, 2, 3, 5])),
                burst=int(rng.choice([0, 0, 20])),
            ))
        # one key hotter than max_waves (32) inside this call: the
        # engine carries its tail to the next flush
        items += [dict(name="rl", unique_key="hot", limit=1000, duration=60_000,
                       hits=1) for _ in range(40)]
        items.append(dict(name="", unique_key="no-namespace", hits=1))
        items.append(dict(name="rl", unique_key="weeks", hits=1, behavior=4,
                          duration=3, limit=5))
        order = rng.permutation(len(items))
        calls.append([items[j] for j in order])
    return calls


def _resp_tuple(r):
    return (int(r.status), int(r.limit), int(r.remaining), int(r.reset_time),
            r.error, dict(r.metadata))


def run_both(jsvc, psvc, clock, calls, advance=(0, 7, 900, 31_000)):
    for c, items in enumerate(calls):
        jr = asyncio.run(jsvc.get_rate_limits([JReq(**kw) for kw in items]))
        pr = asyncio.run(psvc.get_rate_limits([RateLimitReq(**kw) for kw in items]))
        assert len(jr) == len(pr) == len(items)
        for i, (a, b) in enumerate(zip(jr, pr)):
            assert _resp_tuple(b) == _resp_tuple(a), (c, i, items[i])
        clock.ms += advance[c % len(advance)]


def assert_snapshots_equal(js, ps):
    assert set(js) == set(ps)
    for f in js:
        if f == "key_strings":
            assert ps[f] == js[f]
            continue
        assert ps[f].dtype == js[f].dtype, f
        assert np.array_equal(ps[f], js[f]), f"snapshot column {f} diverged"


@pytest.fixture
def services():
    assert jkeys.native_enabled(), "the JAX package must hash with MurmurHash3"
    clock = Clock()
    jsvc, jeng = _jax_service(clock)
    psvc, peng = _port_service(clock)
    yield clock, jsvc, jeng, psvc, peng
    jeng.close()
    peng.close()


def test_same_stream_same_responses_and_snapshot(services):
    clock, jsvc, jeng, psvc, peng = services
    run_both(jsvc, psvc, clock, make_calls(1, 6))
    assert_snapshots_equal(jeng.snapshot(), peng.snapshot())
    st = peng.stats()
    assert st["waves"] > st["flushes"] > 6  # duplicates and the wave cap
    assert st["kernel_launches"] == 0  # CPU table: the plain version
    assert st["requests"] == 6 * 160


def test_state_carried_across_both_ways(services):
    clock, jsvc, jeng, psvc, peng = services
    calls = make_calls(2, 9)
    # JAX alone, then its snapshot into the port
    for items in calls[:3]:
        asyncio.run(jsvc.get_rate_limits([JReq(**kw) for kw in items]))
        clock.ms += 900
    peng.restore(jeng.snapshot())
    assert_snapshots_equal(jeng.snapshot(), peng.snapshot())
    run_both(jsvc, psvc, clock, calls[3:6])
    # the port's snapshot into a fresh JAX engine
    jsvc2, jeng2 = _jax_service(clock)
    try:
        jeng2.restore(peng.snapshot())
        run_both(jsvc2, psvc, clock, calls[6:])
        assert_snapshots_equal(jeng2.snapshot(), peng.snapshot())
    finally:
        jeng2.close()


def test_check_async_and_check_batch_alike(services):
    """The engine's own intake (one future per request, and the
    synchronous batch form) agrees with the JAX engine's."""
    clock, _jsvc, jeng, _psvc, peng = services
    items = make_calls(3, 1, n_items=60)[0]
    jf = [jeng.check_async(JReq(**kw)) for kw in items]
    pf = [peng.check_async(RateLimitReq(**kw)) for kw in items]
    for i, (a, b) in enumerate(zip(jf, pf)):
        assert _resp_tuple(b.result(timeout=30)) == _resp_tuple(a.result(timeout=30)), i
    clock.ms += 500
    jr = jeng.check_batch([JReq(**kw) for kw in items])
    pr = peng.check_batch([RateLimitReq(**kw) for kw in items])
    assert [_resp_tuple(r) for r in pr] == [_resp_tuple(r) for r in jr]
    assert_snapshots_equal(jeng.snapshot(), peng.snapshot())


def test_batch_too_large_is_refused_alike(services):
    _clock, jsvc, _jeng, psvc, _peng = services
    with pytest.raises(JApiError) as je:
        asyncio.run(jsvc.get_rate_limits([JReq(name="a", unique_key="b")] * 1001))
    with pytest.raises(ApiError) as pe:
        asyncio.run(psvc.get_rate_limits([RateLimitReq(name="a", unique_key="b")] * 1001))
    assert str(pe.value) == str(je.value)
    assert pe.value.grpc_code == je.value.grpc_code == "OUT_OF_RANGE"


def test_health_check_alike(services):
    _clock, jsvc, _jeng, psvc, _peng = services
    j = asyncio.run(jsvc.health_check())
    p = asyncio.run(psvc.health_check())
    assert (p.status, p.message, p.peer_count) == (j.status, j.message, j.peer_count)


def test_restore_refuses_wrong_size():
    clock = Clock()
    _psvc, peng = _port_service(clock)
    try:
        snap = peng.snapshot()
        small = {f: (v[:8] if f != "key_strings" else v) for f, v in snap.items()}
        with pytest.raises(ValueError):
            peng.restore(small)
    finally:
        peng.close()


def test_default_device_is_cuda():
    """EngineConfig defaults to the card; without one, construction
    raises instead of running on the CPU."""
    assert EngineConfig().device == "cuda"
    if torch.cuda.is_available():
        DeviceEngine(EngineConfig(num_groups=64)).close()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceEngine(EngineConfig(num_groups=64))


def test_closed_engine_answers_draining():
    clock = Clock()
    psvc, peng = _port_service(clock)
    peng.close()
    r = asyncio.run(psvc.get_rate_limits([RateLimitReq(name="a", unique_key="b", hits=1)]))
    assert r[0].error.startswith("UNAVAILABLE:")
