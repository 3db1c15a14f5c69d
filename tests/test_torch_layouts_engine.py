"""The port's DeviceEngine at the wide and packed layouts against the JAX
package's, flat and paged.

tests/test_torch_store.py's harness (`run_both`: one case function run
through the JAX package, then through the port, on one frozen clock;
their traces must be equal) on the engine's three serving paths, for
the wide and packed layouts, flat and paged (8 logical pages of 128
groups over 4 frames, so pages move):

- the object path: seeded calls of several items (repeated keys, so a
  call spans several waves), token and leaky, RESET_REMAINING and
  DRAIN_OVER_LIMIT, through `check_batch`;
- a Store through a restart (a seeded fuzz, then a fresh table over the
  same store) and the Loader round trip;
- the columnar edge with a Store (`serve_get_rate_limits_bytes` against
  the JAX package's with its fast edge on).

Every answer, the store's entries with their get and change counts, and
the final wide table with its key strings must be equal. The mesh tier
(`IciEngine`, `make_mesh_kernels`, the replica tier's factories) refuses
both layouts with a ValueError that names the layout. Tolerance: none.
"""

import random

import pytest

from gubernator_tpu_torch.parallel import ici, mesh as pmesh
from gubernator_tpu_torch.runtime.engine import DeviceEngine, EngineConfig
from gubernator_tpu_torch.runtime.ici_engine import IciEngine, IciEngineConfig
from test_torch_store import (  # noqa: F401 - jax_engines is a fixture
    LEAKY,
    TOKEN,
    RESET,
    DRAIN,
    case_loader_roundtrip,
    jax_engines,
    run_both,
)
from test_torch_edge import outcome, to_bytes
from test_torch_store_engine import _edge_call, _seed_store
from gubernator_tpu.service.grpc_service import serve_get_rate_limits_bytes as jserve
from gubernator_tpu.service.server import V1Service as JService
from gubernator_tpu_torch.service.server import V1Service, serve_get_rate_limits_bytes

VARIANTS = [("wide", False), ("packed", False), ("wide", True), ("packed", True)]
VARIANT_IDS = ["wide", "packed", "wide-paged", "packed-paged"]


def case_object_path(s, seed):
    """Calls of 1-16 items on at most 3 of 60 keys (a key up to several
    times a call, so a call spans several waves, and its pages fit the
    paged table's 4 frames), both algorithms, RESET_REMAINING and
    DRAIN_OVER_LIMIT, windows that expire between calls."""
    rng = random.Random(seed)
    eng = s.engine()
    keys = [f"obj{i}" for i in range(60)]
    for _ in range(16):
        mine = rng.sample(keys, rng.randint(1, 3))
        items = []
        for _ in range(rng.randint(1, 16)):
            behavior = rng.choice([0] * 6 + [RESET, DRAIN])
            items.append(s.req(rng.choice(mine), name="ob",
                               algorithm=rng.choice([TOKEN, LEAKY]), behavior=behavior,
                               duration=rng.choice([100, 5_000, 60_000]),
                               limit=rng.choice([1, 5, 50]), hits=rng.choice([0, 1, 2, 7])))
        assert not any(a[4] for a in s.check(eng, items))
        s.clock.ms += rng.choice([1, 50, 900, 7_000])
    s.note("stats", {k: eng.stats()[k] for k in ("cache_hits", "cache_misses", "over_limit")}
           if s.port else {"cache_hits": eng.metrics.cache_hits,
                           "cache_misses": eng.metrics.cache_misses,
                           "over_limit": eng.metrics.over_limit})
    s.note_table(eng)


@pytest.mark.parametrize("layout,paged", VARIANTS, ids=VARIANT_IDS)
def test_object_path_matches_jax(layout, paged, jax_engines):
    trace = run_both(case_object_path, "wide", layout, paged, jax_engines, seed=5)
    assert any(a[0] == "answers" and len(a[1]) > 8 for a in trace)


def case_store_restart(s, seed):
    """A Store attached: 60 calls of 1-3 items over 10 keys (both
    algorithms, RESET_REMAINING, DRAIN_OVER_LIMIT), then the restart: a
    fresh table over the same store, every key asked for once per
    algorithm (a read-through each)."""
    rng = random.Random(seed)
    store = s.store()
    eng = s.engine()
    s.st.attach_store(eng, store)
    keys = [f"sr{i}" for i in range(10)]
    for _ in range(60):
        if rng.random() < 0.15:
            s.clock.ms += rng.choice([5, 500, 70_000])
        s.check(eng, [s.req(rng.choice(keys), name="sr", algorithm=rng.choice([TOKEN, LEAKY]),
                            behavior=rng.choice([0] * 8 + [RESET, DRAIN]),
                            duration=rng.choice([100, 60_000]), limit=rng.choice([3, 10, 50]),
                            hits=rng.choice([-1, 0, 1, 2, 5, 60]))
                      for _ in range(rng.randint(1, 3))])
    s.note_store(store)
    s.note_table(eng)
    eng2 = s.engine()
    s.st.attach_store(eng2, store)
    for key in keys:
        for algo in (TOKEN, LEAKY):
            s.check(eng2, [s.req(key, name="sr", algorithm=algo, duration=60_000, limit=50)])
    s.note_store(store)
    s.note_table(eng2)


@pytest.mark.parametrize("layout,paged", VARIANTS, ids=VARIANT_IDS)
def test_store_through_restart_matches_jax(layout, paged, jax_engines):
    trace = run_both(case_store_restart, "wide", layout, paged, jax_engines, seed=7)
    assert trace[-2][0] == "store" and trace[-2][1]
    run_both(case_loader_roundtrip, "wide", layout, paged, jax_engines)


def case_columnar_edge(s, seed):
    """Wire bytes through the columnar edge with a Store seeded with half
    the keys (tests/test_torch_store_engine.py's, some expired, some
    invalidated): 10 calls of up to 4 items (Gregorian ones spliced
    through the object path), whose pages fit the paged table's 4
    frames."""
    rng = random.Random(seed)
    store = s.store()
    _seed_store(s, store, rng)
    eng = s.engine()
    s.st.attach_store(eng, store)
    if s.port:
        svc, serve = V1Service(eng, now_fn=s.clock), serve_get_rate_limits_bytes
    else:
        svc, serve = JService(eng, now_fn=s.clock), jserve
        svc.fast_edge = True
    for _ in range(10):
        s.note("bytes", outcome(serve, svc, to_bytes(_edge_call(rng, 4))))
        s.clock.ms += rng.choice([7, 120, 900])
    if s.port:
        assert eng.stats()["columnar_flushes"] > 0
    s.note_store(store)
    s.note_table(eng)


@pytest.mark.parametrize("layout,paged", VARIANTS, ids=VARIANT_IDS)
def test_columnar_edge_with_store_matches_jax(layout, paged, jax_engines):
    run_both(case_columnar_edge, "wide", layout, paged, jax_engines, seed=21)


@pytest.mark.parametrize("layout", ["wide", "packed"])
def test_engine_reads_torch_backend(layout):
    """Wide and packed are served by torch ops, so the engine reports the
    torch backend and no team kernel, as the JAX engine reads "xla" for
    them under GUBER_KERNEL=pallas; the table's resident bytes per slot
    are the layout's."""
    eng = DeviceEngine(EngineConfig(device="cpu", num_groups=64, layout=layout))
    try:
        assert (eng.kernel_backend, eng.pallas_block) == ("torch", 0)
        assert eng.device_memory()["subsystems"]["slot_table"] == 64 * 8 * (
            83 if layout == "wide" else 72)
    finally:
        eng.close()


@pytest.mark.parametrize("layout", ["wide", "packed"])
def test_mesh_tier_refuses_wide_and_packed(layout):
    """IciEngine, the sharded kernels and the replica tier's factories
    refuse wide and packed at construction, naming the layout and the
    layouts the mesh serves; fused and narrow still build."""
    m = pmesh.make_mesh(["cpu"] * 8)
    for build in (
        lambda: IciEngine(IciEngineConfig(devices=["cpu"] * 8, num_groups=64, layout=layout)),
        lambda: pmesh.make_mesh_kernels(m, layout, 64, 8),
        lambda: pmesh.make_mesh_kernels(m, layout, 64, 8, page_groups=8, page_budget=8),
        lambda: pmesh.create_sharded_table(m, 64, 8, layout),
        lambda: ici.create_ici_state(m, 256, 4, layout=layout),
        lambda: ici.make_replica_decide(m, 256, 4, layout=layout),
        lambda: ici.make_sync_step(m, 256, 4, layout=layout),
        lambda: ici.make_inject_replicas(m, 256, 4, layout=layout),
    ):
        with pytest.raises(ValueError, match=f"layout '{layout}'.*mesh tier serves"):
            build()
    assert pmesh.MESH_LAYOUTS == ("fused", "narrow")
    for ok in pmesh.MESH_LAYOUTS:
        pmesh.make_mesh_kernels(m, ok, 64, 8)
