"""The port's overload control plane (service/overload.py and the
engine's intake seams) against the JAX package's.

Governor: both packages' `IntakeGovernor`, fed one seeded script of
admits (tenants, queue depths, deadlines), queue waits, controller
clock steps and ladder levels, with the same `rng` and `now` sequences
and both packages' millisecond clocks frozen at one instant, must give
equal verdicts (the answer with its error, metadata and shed reason,
and the deadline it keeps) and equal `snapshot()`s after every step,
equal decision recorders and equal rendered
`gubernator_intake_shed_counter` lines. `RetryBudget` and
`request_deadline_ms` likewise. Ladder: both `OverloadManager`s under
the same scripted SLO rows, watchdog stalls and intake waits step
through the same levels, with equal `debug_info()`, level effects and
rendered level and transition lines.

Engine (64-256 groups, B <= 64, device cpu, against the JAX engine on
the same clock): expired deadlines through `check_async` and
`check_bulk` are refused with no flush; the pickup-time expiry too; a
mixed bulk serves its live member; armed and idle (the plane wired as
the JAX daemon wires it, threads running) on DeviceEngine flat and
paged and the 8-shard IciEngine, answers and tables equal the JAX
engine's and the unarmed port's, with no shed; with the plane off,
deadline metadata is inert; `cached_admission()` never scans; the
V1Service seams and scrape bridges on DeviceEngine and IciEngine.
Tolerance: none.
"""

import asyncio
import random
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.metrics import Metrics as JMetrics
from gubernator_tpu.metrics import wire_engine_telemetry as jwire
from gubernator_tpu.parallel import ici as jici
from gubernator_tpu.runtime import watchdog as jwatchdog
from gubernator_tpu.runtime.engine import DeviceEngine as JEngine
from gubernator_tpu.runtime.engine import EngineConfig as JConfig
from gubernator_tpu.runtime.engine import EngineMetrics as JEngineMetrics
from gubernator_tpu.runtime.ici_engine import IciEngine as JIciEngine
from gubernator_tpu.runtime.ici_engine import IciEngineConfig as JIciConfig
from gubernator_tpu.service import overload as jov
from gubernator_tpu.service import slo as jslo
from gubernator_tpu.service.admission import DecisionRecorder as JRecorder
from gubernator_tpu.service.server import V1Service as JService
from gubernator_tpu.utils import clock as jclock
from gubernator_tpu_torch.api.types import ERR_OVERLOADED, RateLimitReq, is_retryable_error
from gubernator_tpu_torch.metrics import Metrics, wire_engine_telemetry
from gubernator_tpu_torch.runtime.engine import DeviceEngine, EngineConfig
from gubernator_tpu_torch.runtime.ici_engine import IciEngine, IciEngineConfig
from gubernator_tpu_torch.runtime.watchdog import Watchdog
from gubernator_tpu_torch.service import overload as pov
from gubernator_tpu_torch.service import slo as pslo
from gubernator_tpu_torch.service.admission import DecisionRecorder
from gubernator_tpu_torch.service.server import V1Service
from gubernator_tpu_torch.utils import clock as pclock
from test_torch_engine import NOW, Clock, _resp_tuple, assert_snapshots_equal, make_calls

OVERLOAD_FAMILIES = ("gubernator_intake_shed_counter", "gubernator_overload_level",
                     "gubernator_overload_transitions")
FLAT = dict(num_groups=256, batch_size=64, batch_wait_s=0.002)
PAGED = dict(num_groups=256, batch_size=8, batch_wait_s=0.002, page_groups=16,
             page_budget=8, page_demote_interval_s=0)
ICI = dict(num_groups=64, ways=4, num_slots=256, replica_ways=4, batch_size=32,
           batch_wait_s=0.001, sync_wait_s=3600.0)


def family_lines(metrics, families=OVERLOAD_FAMILIES) -> list:
    return [ln for ln in metrics.render().decode().splitlines()
            if not ln.startswith("#") and ln.split("{")[0].split(" ")[0] in families]


def ring_entries(rec) -> list:
    return [{k: v for k, v in e.items() if k != "ts_ms"} for e in rec.snapshot()["ring"]]


@pytest.fixture
def frozen():
    """Both packages' millisecond clocks frozen at NOW."""
    with pclock.freeze(NOW) as pc, jclock.freeze(NOW) as jc:
        yield pc, jc


class Mono:
    """A shared fake monotonic clock (the governors' `now`)."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# RetryBudget and deadline metadata


@pytest.mark.parametrize("ratio,burst,seed", [(0.1, 10.0, 0), (0.5, 3.0, 1), (1.0, 1.0, 2),
                                              (0.0, 2.0, 3), (2.0, 0.1, 4)])
def test_retry_budget_matches_jax(ratio, burst, seed):
    """A seeded sequence of first attempts and retries: every try_spend
    verdict and snapshot equal."""
    p, j = pov.RetryBudget(ratio, burst), jov.RetryBudget(ratio, burst)
    rng = np.random.default_rng(seed)
    for _ in range(300):
        if rng.random() < 0.4:
            n = int(rng.integers(1, 12))
            p.record(n)
            j.record(n)
        else:
            cost = float(rng.choice([1.0, 0.5, 2.0]))
            assert p.try_spend(cost) == j.try_spend(cost)
        assert p.snapshot() == j.snapshot()


@pytest.mark.parametrize("md", [None, {}, {"deadline_ms": "1753700000123"},
                                {"deadline_ms": "1.7537e12"}, {"deadline_ms": "soon"},
                                {"deadline_ms": ""}, {"other": "1"}, {"deadline_ms": "-5"}])
def test_request_deadline_ms_matches_jax(md):
    preq = RateLimitReq(name="n", unique_key="k", metadata=dict(md) if md is not None else {})
    jreq = JReq(name="n", unique_key="k", metadata=dict(md) if md is not None else {})
    if md is None:
        preq.metadata = jreq.metadata = None
    assert pov.request_deadline_ms(preq) == jov.request_deadline_ms(jreq)
    assert pov.DEADLINE_MD_KEY == jov.DEADLINE_MD_KEY
    assert pov.ERR_DEADLINE_EXPIRED == jov.ERR_DEADLINE_EXPIRED
    assert pov.SHED_REASONS == jov.SHED_REASONS and pov.LEVEL_NAMES == jov.LEVEL_NAMES


# ---------------------------------------------------------------------------
# the intake governor

# name: (tenant weights, P(depth at or over the limit), P(a wait above
# target), levels set along the way, the reasons the script must reach)
GOVERNOR_SCENARIOS = {
    "codel": ([1.0], 0.0, 0.9, (), {"codel"}),
    "fair": ([0.85, 0.05, 0.05, 0.05], 0.0, 0.9, (), {"tenant", "codel"}),
    "brownout": ([0.8, 0.1, 0.1], 0.0, 0.3, (3,), {"brownout"}),
    "queue_full": ([0.5, 0.5], 0.4, 0.0, (), {"queue_full"}),
    "deadlines": ([0.3, 0.7], 0.1, 0.2, (), {"deadline_expired", "queue_full"}),
    "mixed": ([0.6, 0.2, 0.1, 0.1], 0.1, 0.6, (1, 3, 0, 2), {"deadline_expired", "queue_full",
                                                            "codel", "tenant"}),
}


def governor_pair(mono, seed, jax_kw=None, **kw):
    """Both governors with the same arguments; `jax_kw` are the JAX
    governor's settings that are module constants in the port (the test
    patches those to the same values)."""
    pm, jm = Metrics(), JMetrics()
    prec, jrec = DecisionRecorder(pm), JRecorder(jm)
    p = pov.IntakeGovernor(metrics=pm, recorder=prec, rng=random.Random(seed).random,
                           now=mono, **kw)
    j = jov.IntakeGovernor(metrics=jm, recorder=jrec, rng=random.Random(seed).random,
                           now=mono, **kw, **(jax_kw or {}))
    return (p, pm, prec), (j, jm, jrec)


@pytest.mark.parametrize("scenario", list(GOVERNOR_SCENARIOS))
def test_governor_verdicts_match_jax(frozen, monkeypatch, scenario):
    """Every admit verdict (answer, shed reason, retry_after_ms, kept
    deadline) and every snapshot equal along a seeded script; the
    recorders and the rendered shed counters equal at the end."""
    weights, p_full, p_slow, levels, want_reasons = GOVERNOR_SCENARIOS[scenario]
    mono = Mono()
    rng = np.random.default_rng(len(scenario))
    # three tracked tenants, fewer than the script's, so that the
    # fairness EWMA drops the lightest
    monkeypatch.setattr(pov, "TENANT_K", 3)
    (pg, pm, prec), (jg, jm, jrec) = governor_pair(mono, seed=len(scenario),
                                                   jax_kw=dict(tenant_k=3), limit=64,
                                                   target_ms=15.0)
    tenants = [f"tenant{i}" for i in range(len(weights))] + [""]
    w = np.asarray(weights + [0.02])
    level_at = {int(s): lv for s, lv in zip(np.linspace(300, 1800, len(levels)), levels)}
    seen = set()
    for step in range(2400):
        if step in level_at:
            pg.set_level(level_at[step])
            jg.set_level(level_at[step])
        u = rng.random()
        if u < 0.7:
            tenant = tenants[int(rng.choice(len(tenants), p=w / w.sum()))]
            depth = int(rng.integers(64, 90)) if rng.random() < p_full else int(rng.integers(0, 64))
            md = {}
            r = rng.random()
            if scenario in ("deadlines", "mixed") and r < 0.15:
                md["deadline_ms"] = str(NOW - int(rng.integers(0, 50)))
            elif r < 0.4:
                md["deadline_ms"] = str(NOW + int(rng.integers(1, 5000)))
            elif r < 0.45:
                md["deadline_ms"] = "garbage"
            kw = dict(name=tenant, unique_key=f"k{int(rng.integers(0, 50))}", hits=1,
                      limit=10, duration=60_000)
            pr, pdl = pg.admit(RateLimitReq(metadata=dict(md), **kw), depth)
            jr, jdl = jg.admit(JReq(metadata=dict(md), **kw), depth)
            assert pdl == jdl, step
            assert (pr is None) == (jr is None), step
            if pr is not None:
                assert _resp_tuple(pr) == _resp_tuple(jr), step
        elif u < 0.9:
            wait = float(rng.uniform(0.016, 0.2)) if rng.random() < p_slow \
                else float(rng.uniform(0.0, 0.014))
            pg.observe_wait(wait)
            jg.observe_wait(wait)
        else:
            mono.t += float(rng.choice([0.01, 0.05, 0.1, 0.3, 1.1]))
        ps = pg.snapshot()
        assert ps == jg.snapshot(), step
        assert pg.overloaded() == jg.overloaded()
        seen |= {k for k, v in ps["shed"].items() if v}
    assert want_reasons <= seen, seen
    assert prec.snapshot()["decisions"] == jrec.snapshot()["decisions"]
    assert ring_entries(prec) == ring_entries(jrec)
    lines = family_lines(pm)
    assert lines == family_lines(jm) and lines


def test_governor_shed_answers_are_typed(frozen):
    """A shed answer carries ERR_OVERLOADED (retryable), decision path
    `shed` and retry_after_ms; an expired deadline's is terminal and
    carries no retry_after_ms; both are equal to the JAX package's."""
    (pg, _pm, _pr), (jg, _jm, _jr) = governor_pair(Mono(), seed=0, limit=1)
    shed, _ = pg.admit(RateLimitReq(name="t", unique_key="k"), 1)
    jshed, _ = jg.admit(JReq(name="t", unique_key="k"), 1)
    assert _resp_tuple(shed) == _resp_tuple(jshed)
    assert shed.error == ERR_OVERLOADED and is_retryable_error(shed.error)
    assert shed.metadata == {"retry_after_ms": "40", "decision_path": "shed"}
    md = {"deadline_ms": str(NOW)}
    dead, dl = pg.admit(RateLimitReq(name="t", unique_key="k", metadata=dict(md)), 0)
    jdead, jdl = jg.admit(JReq(name="t", unique_key="k", metadata=dict(md)), 0)
    assert _resp_tuple(dead) == _resp_tuple(jdead) and dl is jdl is None
    assert dead.metadata == {"decision_path": "shed"} and not is_retryable_error(dead.error)


def test_fixed_settings_are_jax_defaults():
    """The port's fixed controller and ladder settings are the JAX
    package's defaults, the values its daemon runs with."""
    j = jov.IntakeGovernor()
    jm = jov.OverloadManager(SimpleNamespace(), j)
    assert (pov.CODEL_INTERVAL_S, pov.FAIRNESS_WINDOW_S, pov.RAMP_S, pov.P_BASE, pov.P_MAX,
            pov.HEAVY_SHARE, pov.TENANT_K, pov.ESCALATE_AFTER) == (
        j.interval_s, j.window_s, j.ramp_s, j.p_base, j.p_max, j.heavy_share, j.tenant_k,
        jm.escalate_after)


# ---------------------------------------------------------------------------
# the brownout ladder


class ScriptedSlo:
    def __init__(self, rows):
        self.rows = iter(rows)

    def evaluate(self):
        return next(self.rows)


class ScriptedWatchdog:
    def __init__(self, stalls):
        self.stalls = iter(stalls)

    def serving_stalled(self):
        return next(self.stalls)


LADDER_SCENARIOS = {
    # name: (escalate_after, hysteresis, P(SLO fast burn), P(stall), P(standing queue))
    "intake": (2, 4, 0.0, 0.0, None),
    "slo": (2, 8, 0.7, 0.0, 0.0),
    "stall": (1, 3, 0.0, 0.6, 0.0),
    "flapping": (3, 2, 0.3, 0.2, 0.3),
}


@pytest.mark.parametrize("scenario", list(LADDER_SCENARIOS))
def test_ladder_matches_jax(frozen, monkeypatch, scenario):
    """Both ladders under the same scripted signals: the same level after
    every step, the same effects, debug_info and rendered level and
    transition lines, and a climb to level 3 and back where the script
    holds pressure and then releases it (one level where it flaps)."""
    esc, hyst, p_slo, p_stall, p_queue = LADDER_SCENARIOS[scenario]
    rng = np.random.default_rng(len(scenario))
    steps = 160
    phase = np.arange(steps) < steps // 2  # pressure in the first half only
    slo_rows, stalls, slow = [], [], []
    for k in range(steps):
        burn = bool(phase[k] and rng.random() < p_slo)
        slo_rows.append([{"id": "flush-latency", "state": "fast_burn" if burn else "ok"},
                         {"id": "availability", "state": "exhausted" if burn and k % 3 == 0
                          else "ok"}])
        stalls.append(bool(phase[k] and rng.random() < p_stall))
        queue = phase[k] if p_queue is None else bool(phase[k] and rng.random() < p_queue)
        slow.append(queue)
    mono = Mono()
    (pg, pm, _), (jg, jm, _) = governor_pair(mono, seed=1, target_ms=15.0)
    psvc, jsvc = SimpleNamespace(metrics=pm), SimpleNamespace(metrics=jm)
    kw = dict(interval_s=0.1, hysteresis=hyst)
    monkeypatch.setattr(pov, "ESCALATE_AFTER", esc)
    pmgr = pov.OverloadManager(psvc, pg, slo=ScriptedSlo(slo_rows),
                               watchdog=ScriptedWatchdog(stalls), **kw)
    jmgr = jov.OverloadManager(jsvc, jg, slo=ScriptedSlo(slo_rows),
                               watchdog=ScriptedWatchdog(stalls), escalate_after=esc, **kw)
    levels = []
    for k in range(steps):
        wait = 0.05 if slow[k] else 0.001
        for g in (pg, jg):
            g.observe_wait(wait)
        mono.t += 0.1
        lv = pmgr.evaluate()
        assert lv == jmgr.evaluate() == pmgr.level == pg.snapshot()["level"], k
        assert pmgr.degrade_forwards() == jmgr.degrade_forwards()
        assert pmgr.debug_info() == jmgr.debug_info(), k
        levels.append(lv)
    pmgr.metrics_sync(pm)
    jmgr.metrics_sync(jm)
    assert family_lines(pm) == family_lines(jm)
    # the steady scripts climb to the top; the flapping one, whose bad
    # streaks keep breaking, climbs at least once; all recover
    assert max(levels) == (1 if scenario == "flapping" else 3) and levels[-1] == 0, levels


def test_ladder_thread_beats_and_stops():
    """start() beats `overload-ladder` and evaluates every interval;
    stop() joins it and unregisters the loop; the level gauge and the
    debug payload follow the ladder."""
    wd = Watchdog()
    m = Metrics()
    g = pov.IntakeGovernor(metrics=m)
    mgr = pov.OverloadManager(SimpleNamespace(metrics=m), g, watchdog=wd, interval_s=0.02)
    mgr.start()
    mgr.start()
    deadline = time.monotonic() + 10.0
    while not mgr._last_signals and time.monotonic() < deadline:
        time.sleep(0.01)
    assert "overload-ladder" in wd.beats()
    assert mgr._last_signals == {"slo_fast_burn": [], "serving_stalled": False,
                                 "intake_overloaded": False}
    t = mgr._thread
    mgr.stop()
    assert not t.is_alive() and "overload-ladder" not in wd.beats()
    mgr.metrics_sync(m)
    assert "gubernator_overload_level 0.0" in family_lines(m)


# ---------------------------------------------------------------------------
# the engine's intake


def expired():
    return {"deadline_ms": str(NOW - 5)}


def live():
    return {"deadline_ms": str(NOW + 60_000)}


def req_pair(key, md=None, **kw):
    d = dict(name="t", unique_key=key, hits=1, limit=10, duration=60_000, **kw)
    return RateLimitReq(metadata=dict(md or {}), **d), JReq(metadata=dict(md or {}), **d)


def armed_devices(clock, cfg=FLAT):
    """A port and a JAX DeviceEngine, each with a governor (its clock
    held still, so only depth and deadlines shed)."""
    peng = DeviceEngine(EngineConfig(device="cpu", **cfg), now_fn=clock)
    jeng = JEngine(JConfig(**cfg), now_fn=clock)
    mono = Mono()
    peng.overload = pov.IntakeGovernor(now=mono)
    jeng.overload = jov.IntakeGovernor(now=mono)
    return peng, jeng


@pytest.mark.parametrize("path", ["check_async", "check_bulk"])
def test_expired_deadlines_refused_with_no_flush(frozen, path):
    """Expired deadlines are refused at admit with the JAX package's
    answer: no flush, no wave, no kernel launch; counted as
    deadline_expired sheds."""
    clock = Clock()
    peng, jeng = armed_devices(clock)
    try:
        pairs = [req_pair(f"k{i}", expired()) for i in range(8)]
        if path == "check_async":
            pr = [peng.check_async(p).result(timeout=30) for p, _ in pairs]
            jr = [jeng.check_async(j).result(timeout=30) for _, j in pairs]
        else:
            pr = peng.check_bulk([p for p, _ in pairs]).result(timeout=30)
            jr = jeng.check_bulk([j for _, j in pairs]).result(timeout=30)
        assert [_resp_tuple(r) for r in pr] == [_resp_tuple(r) for r in jr]
        assert {r.error for r in pr} == {pov.ERR_DEADLINE_EXPIRED}
        st = peng.stats()
        assert st["flushes"] == st["waves"] == st["kernel_launches"] == 0
        assert jeng.metrics.batches == 0
        assert peng.overload.snapshot()["shed"] == jeng.overload.snapshot()["shed"]
        assert peng.overload.snapshot()["shed"]["deadline_expired"] == 8
    finally:
        peng.close()
        jeng.close()


def test_pickup_expiry_and_mixed_bulk(frozen):
    """Admitted alive, expired at pickup (the verdict forced, as the JAX
    package's test forces it): refused before any device work, through
    check_async and check_bulk, and the all-expired bulk resolves at
    once. Then a bulk of one expired and one live member serves the live
    one. Answers equal the JAX engine's at every step."""
    clock = Clock()
    peng, jeng = armed_devices(clock)
    try:
        for eng in (peng, jeng):
            eng.overload.deadline_expired = lambda dl: True
        p, j = req_pair("k", live())
        assert _resp_tuple(peng.check_async(p).result(timeout=30)) == \
            _resp_tuple(jeng.check_async(j).result(timeout=30))
        pairs = [req_pair(f"k{i}", live()) for i in range(4)]
        pr = peng.check_bulk([p for p, _ in pairs]).result(timeout=30)
        jr = jeng.check_bulk([j for _, j in pairs]).result(timeout=30)
        assert [_resp_tuple(r) for r in pr] == [_resp_tuple(r) for r in jr]
        assert {r.error for r in pr} == {pov.ERR_DEADLINE_EXPIRED}
        assert peng.stats()["flushes"] == jeng.metrics.batches == 0
        for eng in (peng, jeng):
            del eng.overload.deadline_expired
        (p0, j0), (p1, j1), (p2, j2) = (req_pair("dead", expired()), req_pair("live"),
                                        req_pair("later", live()))
        pr = peng.check_bulk([p0, p1, p2]).result(timeout=30)
        jr = jeng.check_bulk([j0, j1, j2]).result(timeout=30)
        assert [_resp_tuple(r) for r in pr] == [_resp_tuple(r) for r in jr]
        assert pr[0].error == pov.ERR_DEADLINE_EXPIRED
        assert pr[1].error == pr[2].error == "" and pr[1].remaining == 9
        assert peng.stats()["flushes"] == jeng.metrics.batches == 1
        assert peng.overload.snapshot()["shed"] == jeng.overload.snapshot()["shed"]
        assert_snapshots_equal(jeng.snapshot(), peng.snapshot())
    finally:
        peng.close()
        jeng.close()


def test_overload_off_ignores_deadlines_like_jax(frozen):
    """No governor: deadline metadata is inert, the request is served as
    any other, in both packages."""
    clock = Clock()
    peng = DeviceEngine(EngineConfig(device="cpu", **FLAT), now_fn=clock)
    jeng = JEngine(JConfig(**FLAT), now_fn=clock)
    try:
        assert peng.overload is None
        p, j = req_pair("k", expired())
        pr, jr = peng.check_batch([p])[0], jeng.check_batch([j])[0]
        assert _resp_tuple(pr) == _resp_tuple(jr)
        assert pr.error == "" and pr.remaining == 9
    finally:
        peng.close()
        jeng.close()


def test_cached_admission_never_scans():
    """cached_admission() returns None until a snapshot is cached and
    the cached snapshot after, without a scan of its own; the JAX
    engine's answers alike."""
    clock = Clock()
    peng = DeviceEngine(EngineConfig(device="cpu", **FLAT), now_fn=clock)
    jeng = JEngine(JConfig(**FLAT), now_fn=clock)
    try:
        scans = []
        scan = peng._admission_scan
        peng._admission_scan = lambda: (scans.append(1), scan())[1]
        p, j = req_pair("k")
        peng.check_batch([p])
        jeng.check_batch([j])
        assert peng.cached_admission() is None and jeng.cached_admission() is None
        assert scans == []
        snap = peng.admission_snapshot()
        jsnap = jeng.admission_snapshot()
        assert len(scans) == 1
        assert peng.cached_admission() is snap and len(scans) == 1
        assert snap == jsnap == jeng.cached_admission()
    finally:
        peng.close()
        jeng.close()


# ---------------------------------------------------------------------------
# the plane armed as the JAX daemon arms it

_JAX_ICI = {}


@pytest.fixture(scope="module")
def jax_ici():
    """The module's JAX IciEngine (about 6 s to build), closed at the
    end; `ici_pair` empties it before each use."""
    yield _JAX_ICI
    for eng, _clock, _empty in _JAX_ICI.values():
        eng.close()
    _JAX_ICI.clear()


def ici_pair(jax_ici):
    if "ici" not in jax_ici:
        clock = Clock()
        jeng = JIciEngine(JIciConfig(devices=jax.devices()[:8], **ICI), now_fn=clock)
        jax_ici["ici"] = (jeng, clock, jeng.snapshot())
    jeng, clock, empty = jax_ici["ici"]
    clock.ms = NOW
    jeng.restore(empty)
    jeng.ici_state = jici.create_ici_state(jeng.mesh, ICI["num_slots"], ICI["replica_ways"],
                                           layout="fused")
    jeng._home_rr = 0
    jeng.metrics = JEngineMetrics()
    jeng.metrics.hotkeys.configure(jeng.cfg.hotkeys_k)
    jeng.metrics.hotkeys.set_resolver(jeng.key_string)
    jeng._shard_decisions[:] = 0
    jeng._key_strings.clear()
    jeng.overload = None
    jeng.watchdog = None
    peng = IciEngine(IciEngineConfig(devices=["cpu"] * 8, **ICI), now_fn=clock)
    return peng, jeng, clock


def arm(svc, eng, ovmod, slomod, wd):
    """The JAX daemon's wiring (daemon.py, SLOs and overload): a
    watchdog on the engine, the SLO observatory, the
    governor on the engine and the ladder on the service, all started.
    On a loaded test machine a slow flush (a JAX compile) must not move
    the ladder or shed: the governor's controller clock is held still,
    the watchdog's stall deadline (`wd`) is long, and the sampler's
    first pass is an hour away."""
    eng.watchdog = wd
    svc.slo = slomod.SloObservatory(svc, interval_s=3600.0, watchdog=wd)
    gov = ovmod.IntakeGovernor(metrics=svc.metrics, recorder=svc.recorder, now=Mono())
    svc.overload = ovmod.OverloadManager(svc, gov, slo=svc.slo, watchdog=wd)
    eng.overload = gov
    wd.start()
    svc.slo.start()
    svc.overload.start()


def disarm(svc):
    svc.overload.stop()
    svc.slo.stop()
    svc.overload.watchdog.stop()


@pytest.mark.parametrize("kind", ["flat", "paged", "ici"])
def test_armed_idle_matches_jax_and_unarmed(jax_ici, frozen, kind):
    """The plane armed on both packages' services (and an unarmed port
    engine beside them): the same answers, tables and engine counters,
    no shed, the ladder at level 0, and equal shed, level and transition
    lines and tenant attribution."""
    if kind == "ici":
        peng, jeng, clock = ici_pair(jax_ici)
        off = IciEngine(IciEngineConfig(devices=["cpu"] * 8, **ICI), now_fn=clock)
    else:
        clock = Clock()
        cfg = FLAT if kind == "flat" else PAGED
        peng = DeviceEngine(EngineConfig(device="cpu", **cfg), now_fn=clock)
        jeng = JEngine(JConfig(**cfg), now_fn=clock)
        off = DeviceEngine(EngineConfig(device="cpu", **cfg), now_fn=clock)
    pm, jm = Metrics(), JMetrics()
    wire_engine_telemetry(pm, peng)
    jwire(jm, jeng)
    psvc = V1Service(peng, now_fn=clock, metrics=pm)
    jsvc = JService(jeng, now_fn=clock, metrics=jm)
    osvc = V1Service(off, now_fn=clock)
    arm(psvc, peng, pov, pslo, Watchdog(stall_ms=600_000))
    arm(jsvc, jeng, jov, jslo, jwatchdog.Watchdog(stall_ms=600_000))
    try:
        for c, items in enumerate(make_calls(91, 4, 60 if kind == "paged" else 100)):
            jr = asyncio.run(jsvc.get_rate_limits([JReq(**kw) for kw in items]))
            pr = asyncio.run(psvc.get_rate_limits([RateLimitReq(**kw) for kw in items]))
            orr = asyncio.run(osvc.get_rate_limits([RateLimitReq(**kw) for kw in items]))
            for i, (a, b, o) in enumerate(zip(jr, pr, orr)):
                assert _resp_tuple(b) == _resp_tuple(a) == _resp_tuple(o), (c, i)
            clock.ms += (0, 7, 900, 31_000)[c % 4]
        assert_snapshots_equal(jeng.snapshot(), peng.snapshot())
        assert_snapshots_equal(off.snapshot(), peng.snapshot())
        assert peng.stats() == off.stats()
        pi, ji = psvc.overload_debug_info(), jsvc.overload_debug_info()
        assert pi["level"] == ji["level"] == 0
        assert pi["intake"]["shed"] == ji["intake"]["shed"]
        assert set(pi["intake"]["shed"].values()) == {0}
        assert pi["intake"]["hot_tenants"] == ji["intake"]["hot_tenants"]
        assert pi["intake"]["hot_tenants"]
        assert family_lines(pm) == family_lines(jm)
        assert {"engine-pump", "overload-ladder", "slo-sampler"} <= set(peng.watchdog.beats())
    finally:
        disarm(psvc)
        disarm(jsvc)
        peng.close()
        off.close()
        if kind != "ici":
            jeng.close()


@pytest.mark.parametrize("kind", ["device", "ici"])
def test_v1service_overload_seam_matches_jax(jax_ici, frozen, monkeypatch, kind):
    """overload_debug_info() is {"enabled": false} and the bridge renders
    the same lines while nothing is set; then, with the plane set
    (threads not started), a call whose items are half expired: equal
    answers, decision counts, debug payloads (one ladder step each) and
    rendered shed, level and transition lines."""
    if kind == "ici":
        peng, jeng, clock = ici_pair(jax_ici)
    else:
        clock = Clock()
        peng = DeviceEngine(EngineConfig(device="cpu", **FLAT), now_fn=clock)
        jeng = JEngine(JConfig(**FLAT), now_fn=clock)
    try:
        psvc = V1Service(peng, now_fn=clock, metrics=Metrics())
        jsvc = JService(jeng, now_fn=clock, metrics=JMetrics())
        assert psvc.overload is None and peng.overload is None
        assert psvc.overload_debug_info() == jsvc.overload_debug_info() == {"enabled": False}
        assert family_lines(psvc.metrics) == family_lines(jsvc.metrics)
        mono = Mono()
        monkeypatch.setattr(pov, "ESCALATE_AFTER", 1)
        for svc, eng, mod, kw in ((psvc, peng, pov, {}), (jsvc, jeng, jov, {"escalate_after": 1})):
            gov = mod.IntakeGovernor(metrics=svc.metrics, recorder=svc.recorder, now=mono)
            svc.overload = mod.OverloadManager(svc, gov, **kw)
            eng.overload = gov
        items = [dict(name=f"t{i % 3}", unique_key=f"k{i}", hits=1, limit=5, duration=60_000,
                      metadata=expired() if i % 2 else {}) for i in range(20)]
        jr = asyncio.run(jsvc.get_rate_limits([JReq(**kw) for kw in items]))
        pr = asyncio.run(psvc.get_rate_limits([RateLimitReq(**kw) for kw in items]))
        assert [_resp_tuple(r) for r in pr] == [_resp_tuple(r) for r in jr]
        assert sum(r.error == pov.ERR_DEADLINE_EXPIRED for r in pr) == 10
        assert psvc.recorder.snapshot()["decisions"] == jsvc.recorder.snapshot()["decisions"]
        # a standing queue for one whole controller interval (the pump's
        # pickup waits fell in the interval before)
        mono.t += 0.2
        for g in (peng.overload, jeng.overload):
            g.overloaded()  # rolls the interval over
            g.observe_wait(1.0)
        mono.t += 0.2
        assert psvc.overload.evaluate() == jsvc.overload.evaluate() == 1
        pi, ji = psvc.overload_debug_info(), jsvc.overload_debug_info()
        for info in (pi, ji):
            # the pump's pickup waits are times of each package's own run
            del info["intake"]["wait_ewma_ms"], info["intake"]["retry_after_ms"]
        assert pi == ji
        lines = family_lines(psvc.metrics)
        assert lines == family_lines(jsvc.metrics)
        assert 'gubernator_intake_shed_counter{reason="deadline_expired"} 10.0' in lines
        assert "gubernator_overload_level 1.0" in lines
    finally:
        peng.close()
        if kind != "ici":
            jeng.close()
