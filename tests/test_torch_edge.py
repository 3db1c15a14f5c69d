"""The port's serving core over wire bytes against the JAX package's.

`gubernator_tpu_torch.service.server.serve_get_rate_limits_bytes` (the
columnar edge, service/fastpath.py, then the object path over the
native parse) against `gubernator_tpu.service.grpc_service.
serve_get_rate_limits_bytes` on a JAX V1Service with its fast edge on
(as its daemon sets it for a node without a Loader), one JAX engine
per module, emptied before each test. The same bytes must give the same
response bytes, or the same whole-call error (ApiError and its gRPC
code), and the same table snapshot: seeded calls with Gregorian items
spliced back into columnar batches, validation errors, GLOBAL and
force-global items, items carrying metadata, empty and oversized calls,
GUBER_DISABLE_FAST_EDGE read per call; and the adversarial corpora of
tests/test_fastpath.py (:362-547). Tolerance: none (bytes).

Bytes whose item metadata (field 9) protobuf refuses (a malformed map
entry, a key or value that is not UTF-8) are INVALID_ARGUMENT from both
packages: the port walks field 9 of the calls its native parse flags
`slow` (`wire.metadata_ok`), which closed F-edge-1 (ROADMAP.md section
3). No input of the corpora gives different outcomes.
"""

import asyncio
import random

import numpy as np
import pytest
from test_torch_wire import adversarial_corpus, mutation_corpus

from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.runtime.engine import DeviceEngine as JEngine
from gubernator_tpu.runtime.engine import EngineConfig as JConfig
from gubernator_tpu.service import pb
from gubernator_tpu.service.grpc_service import serve_get_rate_limits_bytes as jserve
from gubernator_tpu.service.server import ApiError as JApiError
from gubernator_tpu.service.server import V1Service as JService
from gubernator_tpu_torch import wire
from gubernator_tpu_torch.runtime.engine import DeviceEngine, EngineConfig
from gubernator_tpu_torch.runtime.ici_engine import IciEngine, IciEngineConfig
from gubernator_tpu_torch.service.server import ApiError, V1Service, serve_get_rate_limits_bytes

NOW = 1_753_700_000_000
NUM_GROUPS = 256
BATCH = 64


class Clock:
    def __init__(self):
        self.ms = NOW

    def __call__(self):
        return self.ms


@pytest.fixture(scope="module")
def jax_service():
    clock = Clock()
    eng = JEngine(JConfig(num_groups=NUM_GROUPS, batch_size=BATCH, batch_wait_s=0.001),
                  now_fn=clock)
    svc = JService(eng, now_fn=clock)
    svc.fast_edge = True
    empty = eng.snapshot()
    try:
        yield svc, clock, empty
    finally:
        eng.close()


@pytest.fixture
def both(jax_service):
    """(JAX service, port service, clock): the JAX engine emptied, a
    fresh port engine on the CPU."""
    jsvc, clock, empty = jax_service
    jsvc.engine.restore(empty)
    jsvc.force_global = False
    clock.ms = NOW
    peng = DeviceEngine(EngineConfig(num_groups=NUM_GROUPS, batch_size=BATCH,
                                     batch_wait_s=0.001, device="cpu"), now_fn=clock)
    try:
        yield jsvc, V1Service(peng, now_fn=clock), clock
    finally:
        peng.close()


def outcome(serve, svc, data):
    """("ok", response bytes) or ("error", gRPC code) or, for any other
    exception, ("raised", its type name)."""
    try:
        return "ok", asyncio.run(serve(svc, data))
    except (ApiError, JApiError) as e:
        return "error", e.grpc_code
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return "raised", type(e).__name__


def to_bytes(reqs) -> bytes:
    msg = pb.pb.GetRateLimitsReq()
    for r in reqs:
        msg.requests.append(pb.req_to_pb(r))
    return msg.SerializeToString()


def random_call(rng, n):
    out = []
    for _ in range(n):
        behavior = rng.choice([0, 0, 0, 8, 32, 40, 2, 1])
        duration = rng.choice([100, 60_000])
        if rng.random() < 0.08:
            behavior |= 4
            duration = rng.choice([0, 1, 2, 5, 9])  # 9: not a calendar interval
        r = JReq(name=rng.choice(["rl", "rl", "café", ""]),
                 unique_key=rng.choice([f"k{rng.randrange(30)}", f"k{rng.randrange(30)}", ""]),
                 hits=rng.choice([0, 1, 2, 5]), limit=rng.choice([3, 10, 100]),
                 duration=duration, behavior=behavior, algorithm=rng.choice([0, 1]),
                 burst=rng.choice([0, 0, 4]))
        u = rng.random()
        if u < 0.05:
            r.metadata = {"traceparent": "00-1-2-01"}
        elif u < 0.1:
            r.created_at = NOW - 500
        out.append(r)
    return out


def assert_snapshots_equal(ps, js):
    for f in js:
        if f == "key_strings":
            assert ps[f] == js[f]
        else:
            assert np.array_equal(ps[f], js[f]), f


@pytest.mark.parametrize("seed,force_global", [(0, False), (1, False), (2, True)])
def test_edge_matches_jax(both, seed, force_global):
    jsvc, psvc, clock = both
    jsvc.force_global = psvc.force_global = force_global
    rng = random.Random(seed)
    col0 = psvc.engine.stats()["columnar_flushes"]
    for step in range(25):
        if rng.random() < 0.3:
            clock.ms += rng.choice([5, 700, 70_000, 3_600_000])
        n = rng.choice([1, 5, 20, 60])
        if step == 10:
            data = to_bytes([JReq(name="g", unique_key="k1", hits=1, limit=5, duration=1,
                                  behavior=4)] * 3)  # all Gregorian
        elif step == 11:
            data = to_bytes(random_call(rng, 1001))  # over MAX_BATCH_SIZE
        elif step == 12:
            data = b""
        else:
            data = to_bytes(random_call(rng, n))
        a = outcome(jserve, jsvc, data)
        b = outcome(serve_get_rate_limits_bytes, psvc, data)
        assert b == a, (seed, step)
    assert outcome(serve_get_rate_limits_bytes, psvc, to_bytes(random_call(rng, 1001))) == (
        "error", "OUT_OF_RANGE")
    assert psvc.engine.stats()["columnar_flushes"] > col0  # the edge served
    assert_snapshots_equal(psvc.engine.snapshot(), jsvc.engine.snapshot())


def test_gregorian_items_splice_into_a_columnar_call(both):
    """A mixed call: the columnar lanes are decided in one columnar
    flush, the Gregorian items through the object path, and the answers
    spliced back in request order (bytes equal to the JAX edge's)."""
    jsvc, psvc, _clock = both
    reqs = [JReq(name="m", unique_key=f"k{i}", hits=1, limit=10, duration=60_000)
            for i in range(6)]
    reqs.insert(2, JReq(name="m", unique_key="g", hits=2, limit=10, duration=1, behavior=4))
    reqs.append(JReq(name="m", unique_key="g2", hits=1, limit=10, duration=9, behavior=4))
    data = to_bytes(reqs)
    before = psvc.engine.stats()
    a = outcome(jserve, jsvc, data)
    b = outcome(serve_get_rate_limits_bytes, psvc, data)
    assert b == a and b[0] == "ok"
    st = psvc.engine.stats()
    assert st["columnar_flushes"] - before["columnar_flushes"] == 1
    assert st["flushes"] - before["flushes"] == 1  # the Gregorian items
    out = pb.pb.GetRateLimitsResp.FromString(b[1]).responses
    assert out[2].remaining == 8 and out[7].error  # interval 9 is refused per item


def test_disable_fast_edge_is_read_per_call(both, monkeypatch):
    jsvc, psvc, _clock = both
    data = to_bytes([JReq(name="d", unique_key="x", hits=1, limit=5, duration=1000)])
    monkeypatch.setenv("GUBER_DISABLE_FAST_EDGE", "1")
    assert outcome(serve_get_rate_limits_bytes, psvc, data) == outcome(jserve, jsvc, data)
    assert psvc.engine.stats()["columnar_flushes"] == 0
    monkeypatch.setenv("GUBER_DISABLE_FAST_EDGE", "")
    assert outcome(serve_get_rate_limits_bytes, psvc, data) == outcome(jserve, jsvc, data)
    assert psvc.engine.stats()["columnar_flushes"] == 1


def test_malformed_bytes_are_invalid_argument(both):
    """Huge length varints, invalid UTF-8 in a key, field 0 and field
    numbers past 2^29 - 1: INVALID_ARGUMENT from both packages, and
    normal traffic is served afterwards."""
    jsvc, psvc, _clock = both
    corpus = adversarial_corpus()
    for k in (0, 1, 2, 3, 4, 5):
        assert outcome(serve_get_rate_limits_bytes, psvc, corpus[k]) == (
            "error", "INVALID_ARGUMENT"), k
        assert outcome(jserve, jsvc, corpus[k]) == ("error", "INVALID_ARGUMENT"), k
    ok = corpus[10]
    assert outcome(serve_get_rate_limits_bytes, psvc, ok) == outcome(jserve, jsvc, ok)


@pytest.mark.parametrize("seed", [11, 12, 13, None])
def test_adversarial_corpora_match_jax(both, seed):
    """Every input of the wire-type mutation corpus (seed) or the fixed
    adversarial corpus (None): the same bytes or the same error from both
    packages, and the same table after the whole corpus. The inputs whose
    item metadata protobuf refuses (F-edge-1 in ROADMAP.md, now closed)
    are INVALID_ARGUMENT from both."""
    jsvc, psvc, _clock = both
    corpus = adversarial_corpus() if seed is None else mutation_corpus(seed)
    differ = []
    for k, data in enumerate(corpus):
        a = outcome(jserve, jsvc, data)
        b = outcome(serve_get_rate_limits_bytes, psvc, data)
        if a != b:
            differ.append((k, a, b))
            psvc.engine.restore(jsvc.engine.snapshot())
    assert differ == RECORDED_FAULTS.get(seed, [])
    assert_snapshots_equal(psvc.engine.snapshot(), jsvc.engine.snapshot())


# The inputs of each corpus on which the packages' outcomes differ
# (ROADMAP.md section 3); none since F-edge-1 was closed.
RECORDED_FAULTS: dict = {}


def _item(inner: bytes) -> bytes:
    return b"\x0a" + wire.varint(len(inner)) + inner


BASE_ITEM = (b"\x0a\x01n" + b"\x12\x01k" + b"\x18\x01" + b"\x20\x05" + b"\x28" + wire.varint(60_000))


@pytest.mark.parametrize("metadata", [
    b"\x4a\x01\xff",  # field 9: a map entry that is not a message
    b"\x4a\x07\x0a\x01a\x12\x02\xc3\x28",  # an entry whose value is not UTF-8
    b"\x4a\x04\x0a\x02\xed\xa0",  # a key that is a lone surrogate
    b"\x4a\x03\x0a\x05a",  # a key longer than its entry
    b"\x4a\x02\x00\x00",  # field 0 inside the entry
    b"\x4a\x02\x0c\x00",  # an end-group tag outside a group
    b"\x4a\x03\x0a\x01a" + b"\x4a\x01\x08",  # a good entry, then a truncated one
])
def test_bad_metadata_is_refused_by_both(both, metadata):
    """F-edge-1, closed: an item metadata map (field 9) that protobuf
    refuses is INVALID_ARGUMENT from both packages, and nothing is
    committed."""
    jsvc, psvc, _clock = both
    data = _item(BASE_ITEM + metadata)
    assert outcome(jserve, jsvc, data) == ("error", "INVALID_ARGUMENT")
    assert outcome(serve_get_rate_limits_bytes, psvc, data) == ("error", "INVALID_ARGUMENT")
    assert psvc.engine.stats()["requests"] == 0
    assert not wire.metadata_ok(data)


@pytest.mark.parametrize("metadata", [
    b"\x4a\x08\x0a\x01a\x12\x03\xc3\xa9z",  # UTF-8 key and value
    b"\x4a\x00",  # an empty entry: key and value ""
    b"\x4a\x05\x18\x07\x12\x01v",  # an unknown field beside the value
    b"\x4a\x04\x08\x01\x10\x02",  # key and value with a varint wire type: unknown fields
    b"\x48\x05",  # field 9 as a varint: an unknown field of the item
    b"\x4a\x06\x0b\x08\x01\x0c\x0a\x00",  # a group, then an empty key
])
def test_good_metadata_is_served_as_jax_serves_it(both, metadata):
    """Metadata protobuf accepts: both packages serve the item through
    the object path, with the same bytes."""
    jsvc, psvc, _clock = both
    data = _item(BASE_ITEM + metadata)
    assert wire.metadata_ok(data)
    want = outcome(jserve, jsvc, data)
    assert want[0] == "ok"
    assert outcome(serve_get_rate_limits_bytes, psvc, data) == want
    assert psvc.engine.stats()["columnar_flushes"] == 0  # metadata: object path


def test_mesh_edge_serves_columnar_and_refuses_global(jax_service):
    """IciEngine (8 CPU shards) behind the edge: a non-GLOBAL call is
    served columnar with the JAX edge's bytes (its DeviceEngine's), and
    a call with a GLOBAL item, no longer refused, is served columnar too:
    the GLOBAL item by the replica tier, with the bytes, replica stack
    and sharded table of the JAX IciEngine behind its fast edge."""
    from gubernator_tpu.runtime.ici_engine import IciEngine as JIciEngine
    from gubernator_tpu.runtime.ici_engine import IciEngineConfig as JIciConfig

    jsvc, clock, empty = jax_service
    jsvc.engine.restore(empty)
    clock.ms = NOW
    cfg = dict(num_groups=NUM_GROUPS, batch_size=BATCH, batch_wait_s=0.001, sync_wait_s=3600)
    eng = IciEngine(IciEngineConfig(devices=["cpu"] * 8, **cfg), now_fn=clock)
    psvc = V1Service(eng, now_fn=clock)
    jmesh = JIciEngine(JIciConfig(**cfg), now_fn=clock)
    jmsvc = JService(jmesh, now_fn=clock)
    jmsvc.fast_edge = True
    try:
        rng = random.Random(4)
        reqs = [r for r in random_call(rng, 30)
                if not r.behavior & 6 and not r.metadata and r.name and r.unique_key]
        data = to_bytes(reqs)
        want = outcome(jserve, jsvc, data)
        assert outcome(serve_get_rate_limits_bytes, psvc, data) == want
        assert eng.stats()["columnar_flushes"] == 1
        assert_snapshots_equal(eng.snapshot(), jsvc.engine.snapshot())
        assert outcome(jserve, jmsvc, data) == want
        before = eng.stats()["requests"]
        g = to_bytes([JReq(name="g", unique_key="a", hits=1, limit=5, duration=1000),
                      JReq(name="g", unique_key="b", hits=1, limit=5, duration=1000,
                           behavior=2)])
        got = outcome(serve_get_rate_limits_bytes, psvc, g)
        assert got[0] == "ok" and got == outcome(jserve, jmsvc, g)
        assert eng.stats()["requests"] == before + 2 and eng.stats()["columnar_flushes"] == 2
        assert np.array_equal(eng.ici_state.table.data.numpy(), np.asarray(jmesh.ici_state.table.data))
        assert np.array_equal(eng.ici_state.pending.numpy(), np.asarray(jmesh.ici_state.pending))
        ps, js = eng.snapshot(), jmesh.snapshot()
        for f in js:
            if f != "key_strings":  # JAX's replica split records no key strings
                assert np.array_equal(ps[f], js[f]), f
    finally:
        eng.close()
        jmesh.close()
