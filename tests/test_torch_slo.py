"""The port's SLO observatory (service/slo.py) against the JAX package's.

Specs: the default catalog, `parse_slo_specs` (overrides, new ids and
every refusal, with the same message), `_window_label` and each
comparator of `is_bad`. Evaluation: both observatories take the same
seeded ring pushes (healthy, fast burn, slow burn, exhausted, data-less
specs) and must give equal `evaluate()`, `debug_info()`, `fleet_info()`
and, through `metrics_sync`, equal rendered lines of the
`gubernator_slo_*` and `gubernator_thread_stalled` families, with a
watchdog whose clock both sides share. Sampling: `sample_once` over a
paged DeviceEngine and an 8-shard IciEngine of each package after the
same calls pushes the same SLIs, with equal values for every SLI that
is not a time (serving_ok, admission_excess_ratio, page moves, shard
imbalance); it scans nothing. Then the sampler thread and the
V1Service seams. Tolerance: none.
"""

import asyncio
import json
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.metrics import Metrics as JMetrics
from gubernator_tpu.metrics import wire_engine_telemetry as jwire
from gubernator_tpu.runtime import watchdog as jwatchdog
from gubernator_tpu.runtime.engine import DeviceEngine as JEngine
from gubernator_tpu.runtime.engine import EngineConfig as JConfig
from gubernator_tpu.runtime.ici_engine import IciEngine as JIciEngine
from gubernator_tpu.runtime.ici_engine import IciEngineConfig as JIciConfig
from gubernator_tpu.service import slo as jslo
from gubernator_tpu.service.server import V1Service as JService
from gubernator_tpu_torch.api.types import RateLimitReq
from gubernator_tpu_torch.metrics import Metrics, wire_engine_telemetry
from gubernator_tpu_torch.runtime.engine import DeviceEngine, EngineConfig
from gubernator_tpu_torch.runtime.ici_engine import IciEngine, IciEngineConfig
from gubernator_tpu_torch.runtime.watchdog import Watchdog
from gubernator_tpu_torch.service import slo as pslo
from gubernator_tpu_torch.service.server import V1Service
from test_torch_engine import Clock, make_calls

SLO_FAMILIES = ("gubernator_slo_burn_rate", "gubernator_slo_error_budget_remaining",
                "gubernator_slo_alert_state", "gubernator_thread_stalled")
PAGED = dict(num_groups=256, batch_size=8, batch_wait_s=0.002, page_groups=16,
             page_budget=8, page_demote_interval_s=0)
ICI = dict(num_groups=64, ways=4, num_slots=256, replica_ways=4, batch_size=32,
           batch_wait_s=0.001, sync_wait_s=3600.0)


def family_lines(metrics, families=SLO_FAMILIES) -> list:
    """The rendered sample lines of the named families, in order."""
    return [ln for ln in metrics.render().decode().splitlines()
            if not ln.startswith("#") and ln.split("{")[0].split(" ")[0] in families]


def spec_fields(s) -> dict:
    return dict(s.__dict__)


# ---------------------------------------------------------------------------
# specs


def test_default_specs_match_jax():
    """The seven built-in SLOs, field for field, in order; each
    validates."""
    ps, js = pslo.default_specs(), jslo.default_specs()
    assert [spec_fields(s) for s in ps] == [spec_fields(s) for s in js]
    assert pslo.STATES == jslo.STATES
    for s in ps:
        s.validate()


SPEC_TEXTS = [
    "",
    "   ",
    json.dumps([{"id": "flush-latency", "fast_windows": [1, 2], "threshold": 0.05}]),
    json.dumps([{"id": "custom", "sli": "flush_p99_s", "objective": 0.95, "comparator": "ge"}]),
    json.dumps([{"id": "availability", "budget_window_s": 60}, {"id": "x", "sli": "y",
                                                                 "objective": 0.5}]),
    "{not json",
    json.dumps({"id": "availability"}),
    json.dumps([["availability"]]),
    json.dumps([{"sli": "no id"}]),
    json.dumps([{"id": "availability", "colour": "red"}]),
    json.dumps([{"id": "new-one", "sli": "x"}]),
    json.dumps([{"id": "availability", "objective": 1.0}]),
    json.dumps([{"id": "availability", "comparator": "eq"}]),
    json.dumps([{"id": "availability", "slow_windows": [5]}]),
    json.dumps([{"id": "availability", "fast_windows": [5, -1]}]),
    json.dumps([{"id": "availability", "budget_window_s": 0}]),
    json.dumps([{"id": "", "sli": "x", "objective": 0.9}]),
]


@pytest.mark.parametrize("text", SPEC_TEXTS, ids=range(len(SPEC_TEXTS)))
def test_parse_slo_specs_matches_jax(text):
    """The same specs, or the same ValueError message."""
    try:
        want = [spec_fields(s) for s in jslo.parse_slo_specs(text)]
    except ValueError as e:
        with pytest.raises(ValueError) as pe:
            pslo.parse_slo_specs(text)
        assert str(pe.value) == str(e)
        return
    assert [spec_fields(s) for s in pslo.parse_slo_specs(text)] == want


@pytest.mark.parametrize("seconds", [300.0, 3600.0, 1800, 21600.0, 90.0, 7.5, 61.0, 86400.0])
def test_window_label_matches_jax(seconds):
    assert pslo._window_label(seconds) == jslo._window_label(seconds)


@pytest.mark.parametrize("comparator", ["gt", "ge", "lt", "le"])
def test_is_bad_matches_jax(comparator):
    kw = dict(id="t", sli="x", objective=0.99, threshold=0.5, comparator=comparator)
    p, j = pslo.SloSpec(**kw), jslo.SloSpec(**kw)
    for v in (-1.0, 0.0, 0.49, 0.5, 0.51, 7.0):
        assert p.is_bad(v) == j.is_bad(v)


# ---------------------------------------------------------------------------
# evaluation and exports


class SharedClock:
    """One monotonic clock for both packages' watchdogs."""

    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


def short_specs(mod):
    """The default catalog plus two specs with windows of seconds, so a
    run of pushes reaches every alert state."""
    return mod.default_specs() + (
        mod.SloSpec(id="short-gt", sli="x", objective=0.99, threshold=0.5,
                    fast_windows=(30.0, 60.0), slow_windows=(60.0, 120.0),
                    budget_window_s=120.0),
        mod.SloSpec(id="short-le", sli="y", objective=0.9, threshold=1.0, comparator="le",
                    fast_windows=(20.0, 40.0), slow_windows=(90.0, 200.0),
                    budget_window_s=600.0),
    )


SCENARIOS = {
    # name: (bad share of x over its samples, bad share of y, serving_ok stalls)
    "healthy": (0.0, 0.0, 0),
    "fast_burn": (0.5, 0.0, 0),
    "slow_burn": (0.0, 0.35, 0),
    "exhausted": (1.0, 1.0, 3),
    "mixed": (0.2, 0.6, 1),
}


def observatories(monkeypatch, scenario, seed):
    """Both observatories with the same specs and the same pushes, and
    watchdogs with the same beats and stalls, all on one shared
    monotonic clock (both packages' slo modules and the JAX watchdog read
    `time.monotonic`)."""
    base = 10_000.0
    clock = SharedClock(base)
    for mod in (jwatchdog, jslo, pslo):
        monkeypatch.setattr(mod, "time", SimpleNamespace(monotonic=clock))
    pwd, jwd = Watchdog(stall_ms=2000, clock=clock), jwatchdog.Watchdog(stall_ms=2000)
    bad_x, bad_y, stalls = SCENARIOS[scenario]
    rng = np.random.default_rng(seed)
    obs = []
    for mod, wd in ((pslo, pwd), (jslo, jwd)):
        o = mod.SloObservatory(SimpleNamespace(), interval_s=1.0, specs=short_specs(mod),
                               watchdog=wd)
        obs.append(o)
    for k in range(150):
        ts = base - 0.5 - k * 1.37
        x = 1.0 if rng.random() < bad_x else 0.1
        y = 0.5 if rng.random() < bad_y else 3.0
        ok = 0.0 if k < stalls else 1.0
        f = float(rng.random() * 0.2)
        for o in obs:
            o.rings.push("x", x, ts)
            o.rings.push("y", y, ts)
            o.rings.push("serving_ok", ok, ts)
            o.rings.push("flush_p99_s", f, ts)
    for wd in (pwd, jwd):
        wd.beat("engine-pump", serving=True)
        wd.beat("engine-complete", serving=True)
        wd.beat("slo-sampler", period_s=1.0)
    clock.t = base + (3.0 if stalls else 0.5)
    for wd in (pwd, jwd):
        wd.beat("engine-complete", serving=True)
        wd.check()
    return obs


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_evaluation_and_exports_match_jax(monkeypatch, scenario):
    """evaluate(), debug_info(), fleet_info() and the rendered SLO and
    stall lines after metrics_sync: equal."""
    po, jo = observatories(monkeypatch, scenario, seed=len(scenario))
    now = pslo.time.monotonic()
    assert po.evaluate(now) == jo.evaluate(now)
    states = {e["id"]: e["state"] for e in po.evaluate(now)}
    if scenario != "healthy":
        assert set(states.values()) != {"ok"}
    assert po.debug_info() == jo.debug_info()
    assert po.fleet_info() == jo.fleet_info()
    pm, jm = Metrics(), JMetrics()
    po.metrics_sync(pm)
    jo.metrics_sync(jm)
    lines = family_lines(pm)
    assert lines == family_lines(jm)
    assert any(ln.startswith("gubernator_thread_stalled") for ln in lines)


def test_ring_capacity_and_interval_match_jax():
    """The ring capacity follows the largest window at the cadence,
    bounded to [720, 8640]; the interval has a 0.1 s floor."""
    for interval in (0.001, 0.5, 5.0, 60.0):
        for short in (False, True):
            p = pslo.SloObservatory(SimpleNamespace(), interval_s=interval,
                                    specs=short_specs(pslo) if short else None)
            j = jslo.SloObservatory(SimpleNamespace(), interval_s=interval,
                                    specs=short_specs(jslo) if short else None)
            assert (p.interval_s, p.rings.capacity) == (j.interval_s, j.rings.capacity)


# ---------------------------------------------------------------------------
# sampling over engines

def engine_pair(kind, clock):
    """A port engine and a JAX engine of the same kind on one clock."""
    if kind == "paged":
        return (DeviceEngine(EngineConfig(device="cpu", **PAGED), now_fn=clock),
                JEngine(JConfig(**PAGED), now_fn=clock))
    return (IciEngine(IciEngineConfig(devices=["cpu"] * 8, **ICI), now_fn=clock),
            JIciEngine(JIciConfig(devices=jax.devices()[:8], **ICI), now_fn=clock))


@pytest.mark.parametrize("kind", ["paged", "ici"])
def test_sample_once_matches_jax(kind):
    """After the same calls through V1Services wired as the JAX daemon
    wires them, one sampling pass before and one after the engines'
    admission and census caches fill: the same rings; equal values for
    serving_ok, admission_excess_ratio, page_demotes, page_promotes and
    shard_imbalance_ratio; flush_p99_s and device_sync_p99_s (times) on
    both sides. No pass scans the table."""
    clock = Clock()
    peng, jeng = engine_pair(kind, clock)
    try:
        pm, jm = Metrics(), JMetrics()
        wire_engine_telemetry(pm, peng)
        jwire(jm, jeng)
        psvc = V1Service(peng, now_fn=clock, metrics=pm)
        jsvc = JService(jeng, now_fn=clock, metrics=jm)
        pwd, jwd = Watchdog(), jwatchdog.Watchdog()
        po = pslo.SloObservatory(psvc, watchdog=pwd)
        jo = jslo.SloObservatory(jsvc, watchdog=jwd)
        for items in make_calls(81, 3, 40):
            asyncio.run(jsvc.get_rate_limits([JReq(**kw) for kw in items]))
            asyncio.run(psvc.get_rate_limits([RateLimitReq(**kw) for kw in items]))
            clock.ms += 900
        scans = []
        for name in ("_admission_scan", "_census_scan"):
            fn = getattr(peng, name)
            setattr(peng, name, lambda fn=fn, name=name: (scans.append(name), fn())[1])
        po.sample_once(now=100.0)
        jo.sample_once(now=100.0)
        assert scans == []
        assert po.rings.names() == jo.rings.names()
        assert "admission_excess_ratio" not in po.rings.names()
        peng.admission_snapshot()
        peng.table_census()
        jeng.admission_snapshot(max_age_s=0)
        jeng.table_census(max_age_s=0)
        scans.clear()
        po.sample_once(now=101.0)
        jo.sample_once(now=101.0)
        assert scans == []
        names = po.rings.names()
        assert names == jo.rings.names()
        want = {"serving_ok", "admission_excess_ratio", "flush_p99_s", "device_sync_p99_s"}
        want |= {"page_demotes", "page_promotes"} if kind == "paged" else {"shard_imbalance_ratio"}
        assert want <= set(names)
        for n in names:
            ps, js = po.rings.get(n).samples(), jo.rings.get(n).samples()
            assert len(ps) == len(js) == (1 if n == "admission_excess_ratio" else 2), n
            if n not in ("flush_p99_s", "device_sync_p99_s"):
                assert ps == js, n
        assert po._ticks == jo._ticks == 2
    finally:
        peng.close()
        jeng.close()


def test_sampler_thread_beats_and_stops():
    """start() beats `slo-sampler` at once and samples every interval;
    stop() joins the thread and unregisters the loop."""
    wd = Watchdog()
    eng = DeviceEngine(EngineConfig(device="cpu", num_groups=64, batch_size=8))
    try:
        svc = V1Service(eng)
        obs = pslo.SloObservatory(svc, interval_s=0.1, watchdog=wd)
        obs.start()
        obs.start()  # a second start is a no-op
        deadline = time.monotonic() + 10.0
        while obs._ticks < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert "slo-sampler" in wd.beats() and obs._ticks >= 2
        assert "flush_p99_s" in obs.rings.names()
        t = obs._thread
        obs.stop()
        assert not t.is_alive() and "slo-sampler" not in wd.beats()
    finally:
        eng.close()


@pytest.mark.parametrize("armed", [False, True])
def test_v1service_slo_seam_matches_jax(armed):
    """slo_debug_info(): {"enabled": false} until an observatory is set,
    then its debug_info; the scrape bridge renders the same SLO lines in
    both packages (none while unset)."""
    clock = Clock()
    peng = DeviceEngine(EngineConfig(device="cpu", num_groups=64, batch_size=8), now_fn=clock)
    jeng = JEngine(JConfig(num_groups=64, batch_size=8), now_fn=clock)
    try:
        psvc, jsvc = V1Service(peng, now_fn=clock), JService(jeng, now_fn=clock)
        assert psvc.slo is None
        if armed:
            base = time.monotonic() - 1.0
            for svc, mod in ((psvc, pslo), (jsvc, jslo)):
                svc.slo = mod.SloObservatory(svc, specs=short_specs(mod))
                for k in range(5):
                    svc.slo.rings.push("x", float(k % 2), base - k)
            assert psvc.slo_debug_info() == jsvc.slo_debug_info()
            assert psvc.slo_debug_info()["enabled"] is True
        else:
            assert psvc.slo_debug_info() == jsvc.slo_debug_info() == {"enabled": False}
        lines = family_lines(psvc.metrics)
        assert lines == family_lines(jsvc.metrics)
        assert bool(lines) == armed
    finally:
        peng.close()
        jeng.close()
