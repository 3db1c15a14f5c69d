"""The port's wire path (`gubernator_tpu_torch/wire.py` over its own
copy of the native code, `csrc/wirepath.cc`) against the JAX package's
(`gubernator_tpu/wire.py` over `native/wirepath.cc`) and protobuf.

The same seeded bytes go through both parses, field by field: requests
serialized by protobuf (multi-byte UTF-8 names, metadata, created_at
present, absent and zero), and adversarial bytes (the wire-type
mutation corpus and the invalid field numbers of tests/test_fastpath.py,
huge length varints). `build_responses` and the plain-Python encoder of
object answers (`encode_responses`) must give protobuf's bytes.
Tolerance: none (bytes and integers).
"""

import random

import numpy as np
import pytest

from gubernator_tpu import wire as jwire
from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.api.types import RateLimitResp as JResp
from gubernator_tpu.service import pb
from gubernator_tpu_torch import wire
from gubernator_tpu_torch.api.types import RateLimitResp

COLUMNS = ("hits", "limit", "duration", "algo", "behavior", "burst", "created_at",
           "has_created", "slow", "name_lens", "key_offsets")


def to_bytes(reqs) -> bytes:
    msg = pb.pb.GetRateLimitsReq()
    for r in reqs:
        msg.requests.append(pb.req_to_pb(r))
    return msg.SerializeToString()


def random_reqs(rng, n):
    names = ["rl", "café", "名前", "x" * 40, "a_b"]
    out = []
    for _ in range(n):
        r = JReq(
            name=rng.choice(names),
            unique_key=rng.choice(["k", "naïve_k", "acct:17", "🔑", "z" * 9]),
            hits=rng.choice([0, 1, -3, 2**40, -(2**63)]),
            limit=rng.choice([0, 10, -5, 2**62]),
            duration=rng.choice([0, 1, 60_000, 2**50]),
            algorithm=rng.choice([0, 1, 7]),
            behavior=rng.choice([0, 1, 2, 4, 8, 32, 63]),
            burst=rng.choice([0, 3, -1]),
        )
        u = rng.random()
        if u < 0.2:
            r.created_at = 0
        elif u < 0.5:
            r.created_at = 1_753_700_000_000 - rng.randrange(5000)
        if rng.random() < 0.1:
            r.metadata = {"traceparent": "00-ab-cd-01"}
        out.append(r)
    return out


def assert_columns_equal(p, j, tag):
    if j is None:
        assert p is None, tag
        return
    assert p is not None, tag
    assert p.n == j.n, tag
    for f in COLUMNS:
        a, b = getattr(p, f), getattr(j, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), (tag, f)
    n_key = int(j.key_offsets[-1])
    assert np.array_equal(p.key_data[:n_key], j.key_data[:n_key]), tag
    assert p.key_strings_all() == j.key_strings_all(), tag
    for i in range(j.n):
        assert p.name_key_parts(i) == j.name_key_parts(i), (tag, i)
        assert vars(wire.req_from_columns(p, i)) == vars(jwire.req_from_columns(j, i)), (tag, i)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parse_matches_jax(seed):
    rng = random.Random(seed)
    for step in range(40):
        data = to_bytes(random_reqs(rng, rng.randint(0, 30)))
        assert_columns_equal(wire.parse_requests(data), jwire.parse_requests(data),
                             f"seed {seed} step {step}")


def _tag(field: int, wt: int) -> bytes:
    return bytes([(field << 3) | wt])


def _varint(v: int) -> bytes:
    return wire.varint(v)


def mutation_corpus(seed, count=300):
    """tests/test_fastpath.py test_wire_type_mutation_fuzz's generator:
    randomized wire types on every field, group wire types included."""
    rng = random.Random(seed)
    out = []
    for _ in range(count):
        body = b""
        for _i in range(rng.randint(0, 4)):
            inner = b""
            for _f in range(rng.randint(0, 8)):
                field = rng.randint(1, 12)
                wt = rng.choice([0, 0, 0, 2, 2, 1, 5, rng.choice([3, 4])])
                inner += _tag(field, wt)
                if wt == 0:
                    inner += _varint(rng.choice([0, 1, 7, 2**31, 2**63, 2**64 - 1]))
                elif wt == 1:
                    inner += rng.randbytes(8)
                elif wt == 5:
                    inner += rng.randbytes(4)
                elif wt == 2:
                    if field in (1, 2) and rng.random() < 0.7:
                        payload = bytes(rng.choice(b"abcdefgh") for _ in range(rng.randint(0, 6)))
                    else:
                        payload = rng.randbytes(rng.randint(0, 12))
                    inner += _varint(len(payload)) + payload
            body += _tag(1, 2) + _varint(len(inner)) + inner
        out.append(body)
    return out


def adversarial_corpus():
    """Fixed hostile inputs: huge length varints, invalid UTF-8, field 0
    and field numbers past 2^29 - 1 (one aliasing field 2 under 32-bit
    truncation), wire-type confusion (a scalar as a length record that
    embeds a fake key record), truncations."""
    base = _tag(1, 2) + _varint(1) + b"n" + _tag(2, 2) + _varint(1) + b"k"

    def wrap(inner):
        return _tag(1, 2) + _varint(len(inner)) + inner

    fake = _tag(2, 2) + _varint(40) + b"x" * 40
    confused = base + _tag(3, 2) + _varint(len(fake)) + fake
    ok = to_bytes([JReq(name="u", unique_key="marker", duration=60000, limit=5, hits=1)])
    bad_utf8 = bytearray(ok)
    bad_utf8[bytes(ok).index(b"marker")] = 0xFF
    return [
        bytes([0x0A, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0x01, 0x01]),
        bytes(bad_utf8),
        wrap(base + b"\x00"),
        wrap(base + _varint(((1 << 32) + 2) << 3 | 2) + _varint(5) + b"alias"),
        b"\x00" + wrap(base),
        _varint((1 << 33) << 3 | 2) + _varint(0),
        wrap(confused),
        wrap(base)[:-1],
        wrap(base + _tag(3, 0) + b"\xff" * 11),
        wrap(base) * 3,
        ok,
        b"",
    ]


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_parse_matches_jax_on_mutations(seed):
    for k, data in enumerate(mutation_corpus(seed)):
        p = wire.parse_requests(data)
        assert_columns_equal(p, jwire.parse_requests(data), f"seed {seed} input {k}")
        if p is not None:  # the key-buffer invariant
            assert int(p.key_offsets[-1]) <= len(p.key_data)
            assert np.all(np.diff(p.key_offsets) >= 0)


def test_parse_matches_jax_on_adversarial_bytes():
    corpus = adversarial_corpus()
    for k, data in enumerate(corpus):
        assert_columns_equal(wire.parse_requests(data), jwire.parse_requests(data), k)
    # the malformed ones are refused, the confused one keeps its real key
    assert wire.parse_requests(corpus[0]) is None
    assert all(wire.parse_requests(corpus[k]) is None for k in (2, 3, 4, 5, 7))
    c = wire.parse_requests(corpus[6])
    assert c.n == 1 and c.key_string(0) == "n_k" and int(c.hits[0]) == 0
    assert wire.parse_requests(corpus[1]).slow[0] == 1  # invalid UTF-8: flagged


def test_name_key_parts_split_bytes_and_strict_decode():
    data = to_bytes([JReq(name="café", unique_key="naïve_k", hits=1)])
    c = wire.parse_requests(data)
    assert c.name_key_parts(0, errors="strict") == ("café", "naïve_k")
    raw = bytearray(data)
    raw[bytes(data).index("naïve".encode())] = 0xC3  # a lead byte, then 'a'
    c = wire.parse_requests(bytes(raw))
    assert c.slow[0] == 1
    with pytest.raises(UnicodeDecodeError):
        c.name_key_parts(0, errors="strict")


@pytest.mark.parametrize("seed", [0, 1])
def test_build_responses_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 7, 1000):
        cols = (
            rng.choice([0, 1, -1], n).astype(np.int8),
            rng.choice([0, 1, -5, 2**63 - 1, -(2**63)], n).astype(np.int64),
            rng.choice([0, 7, -1, 2**40], n).astype(np.int64),
            rng.choice([0, 1_753_700_000_000, -3], n).astype(np.int64),
        )
        assert wire.build_responses(*cols) == jwire.build_responses(*cols)


def _pb_bytes(kws):
    m = pb.pb.GetRateLimitsResp()
    for kw in kws:
        m.responses.append(pb.resp_to_pb(JResp(**kw)))
    return m.SerializeToString()


@pytest.mark.parametrize("seed", [0, 1])
def test_object_encoder_matches_protobuf(seed):
    """`encode_responses` (the object path's answers, error strings
    included) gives protobuf's SerializeToString bytes; single items and
    whole messages, zero fields omitted, negative values as ten-byte
    varints."""
    rng = random.Random(seed)
    for _ in range(300):
        kws = [dict(
            status=rng.choice([0, 1, 0, 2, -1]),
            limit=rng.choice([0, 1, -5, 2**63 - 1, -(2**63), 300]),
            remaining=rng.choice([0, 7, -1, 2**40]),
            reset_time=rng.choice([0, 1_753_700_000_000, -3]),
            error=rng.choice(["", "x", "field 'unique_key' cannot be empty", "é" * 200,
                              "UNAVAILABLE: engine draining; retry"]),
        ) for _ in range(rng.randint(0, 5))]
        assert wire.encode_responses([RateLimitResp(**kw) for kw in kws]) == _pb_bytes(kws)


def test_object_encoder_refuses_metadata():
    """Answers carry metadata under `stage_metadata` (stage_breakdown_us,
    decision_path): the encoder writes the map in sorted key order
    (protobuf's deterministic order), which protobuf decodes to the same
    message, and refuses an entry that is not str to str, as protobuf
    does."""
    md = {"stage_breakdown_us": "queue=1,assemble=20", "decision_path": "owner",
          "decision_staleness_ms": "0", "é": "", "": "v"}
    r = RateLimitResp(status=1, limit=5, remaining=2, reset_time=7, error="e", metadata=md)
    data = wire.encode_responses([r, RateLimitResp(metadata={"owner": "x"})])
    out = pb.pb.GetRateLimitsResp.FromString(data).responses
    assert dict(out[0].metadata) == md and dict(out[1].metadata) == {"owner": "x"}
    assert (out[0].status, out[0].limit, out[0].remaining, out[0].error) == (1, 5, 2, "e")
    # without the empty key (whose place protobuf's order leaves to its
    # own comparator), byte for byte protobuf's deterministic bytes
    md.pop("")
    want = pb.pb.GetRateLimitsResp()
    want.responses.append(pb.resp_to_pb(r))
    want.responses.append(pb.resp_to_pb(RateLimitResp(metadata={"owner": "x"})))
    assert wire.encode_responses([r, RateLimitResp(metadata={"owner": "x"})]) == \
        want.SerializeToString(deterministic=True)
    for bad in ({"owner": 5}, {7: "x"}):
        with pytest.raises(ValueError, match="metadata"):
            wire.encode_responses([RateLimitResp(metadata=bad)])


def test_native_and_encoded_runs_concatenate():
    """Native-built runs and encoded items frame independently: their
    concatenation is one valid message (the splice of merge_mixed)."""
    st = np.array([0, 1], np.int8)
    lim = np.array([5, 5], np.int64)
    rem = np.array([4, 0], np.int64)
    rst = np.array([10, 20], np.int64)
    data = (wire.build_responses(st, lim, rem, rst)
            + wire.encode_responses([RateLimitResp(error="bad")]))
    out = pb.pb.GetRateLimitsResp.FromString(data).responses
    assert [(r.status, r.remaining, r.error) for r in out] == [(0, 4, ""), (1, 0, ""), (0, 0, "bad")]
