"""The port's device-throughput bench (`gubernator_tpu_torch/bench.py`)
against the repo's `bench.py`, at small sizes on the CPU.

- `_make_zipf_batch` draws the same batches from the same seed, in both
  modes, on every field.
- A small `kernel` / `kernel10m` run on `device="cpu"` (the plain
  version behind the registry's `decide` and `decide_scan`) leaves the
  same table and counts the same unexpired evictions as the same
  sequence through the JAX package's `K.decide` / `K.decide_scan`
  (`GUBER_KERNEL=xla`): the warm single decide, the warm and timed
  chunks, the round-trip decides. Tolerance: none.
- The printed line has the repo bench's four keys and names the device.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gubernator_tpu.ops.kernels import get_kernels as jget_kernels
from gubernator_tpu_torch import bench as pbench

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
import bench as jbench  # noqa: E402

# 4 groups of 8 ways under ~40 distinct keys: live entries get evicted
SMALL = dict(num_groups=4, n_keys=5000, batch=8, steps=16, warm_chunks=1,
             chunks=2, rtt_calls=3)


@pytest.mark.parametrize("mode", ["kernel", "kernel10m"])
def test_zipf_batch_matches_repo_bench(mode):
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    for width, keys, groups in ((256, 1000, 64), (4096, 1_000_000, 1 << 18)):
        a = jbench._make_zipf_batch(r1, width, keys, groups, pbench.NOW, mode)
        b = pbench._make_zipf_batch(r2, width, keys, groups, pbench.NOW, mode)
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (mode, width, f)
        assert 0 < int(b.active.sum()) <= min(width, groups)
    if mode == "kernel10m":
        assert set(np.unique(b.behavior)) >= {8, 32}


def _jax_run(mode, layout, p):
    """The bench's decide sequence through the JAX registry."""
    JK = jget_kernels(layout)
    rng = np.random.default_rng(7)
    host = [jbench._make_zipf_batch(rng, p["batch"], p["n_keys"], p["num_groups"],
                                    pbench.NOW, mode) for _ in range(p["steps"])]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *host)
    nows = np.arange(pbench.NOW, pbench.NOW + p["steps"], dtype=np.int64)
    table = JK.create(p["num_groups"], pbench.WAYS)
    table, _ = JK.decide(table, host[0], pbench.NOW - 10, pbench.WAYS, False)
    evictions = 0
    for c in range(p["warm_chunks"] + p["chunks"]):
        table, out = JK.decide_scan(table, stacked, nows, pbench.WAYS, False)
        if c >= p["warm_chunks"]:
            evictions += int(np.sum(np.asarray(out.unexpired_evictions)))
    for i in range(p["rtt_calls"]):
        table, _ = JK.decide(table, host[0], pbench.NOW + 1000 + i, pbench.WAYS, False)
    return table, evictions


@pytest.mark.parametrize("mode,layout", [("kernel", "fused"), ("kernel10m", "narrow")])
def test_kernel_bench_matches_jax_sequence(mode, layout, monkeypatch):
    monkeypatch.setenv("GUBER_KERNEL", "xla")
    run = pbench.run_kernel_bench(mode, layout, device="cpu", log=lambda *_: None, **SMALL)
    jt, jev = _jax_run(mode, layout, SMALL)
    assert np.array_equal(run.table.data.numpy(), np.asarray(jt.data))
    assert run.evictions == jev and jev > 0
    line = json.loads(json.dumps(run.result))
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["unit"] == "decisions/s" and line["value"] > 0
    assert f"{mode}, cpu, {layout} layout" in line["metric"]
    assert line["vs_baseline"] == round(line["value"] / 4000.0, 1)


def test_paged_bench_with_every_page_resident_equals_flat():
    """On a paged table whose pages are all bound in order the paged
    registry's scan leaves the flat run's table, frame for group."""
    flat = pbench.run_kernel_bench("kernel", "narrow", device="cpu", log=lambda *_: None, **SMALL)
    paged = pbench.run_kernel_bench("kernel", "narrow", device="cpu", log=lambda *_: None,
                                    page_groups=2, **SMALL)
    assert torch.equal(paged.table.data.data, flat.table.data)
    assert torch.equal(paged.table.page_map, torch.arange(2, dtype=torch.int32))
    assert paged.evictions == flat.evictions > 0
    assert "paged: 2 pages of 2 groups, all resident" in paged.result["metric"]


def test_latency_line_and_refusals(monkeypatch):
    line = pbench.bench_latency("fused", device="cpu", num_groups=64, n_keys=600,
                                widths=(16, 32), s1=2, s2=4, reps=2, log=lambda *_: None)
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["unit"] == "us/step" and "B=16" in line["metric"] and "cpu" in line["metric"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        pbench.run_kernel_bench("kernel", device="cuda")
    with pytest.raises(RuntimeError):
        pbench.bench_latency(device="cuda")
    with pytest.raises(SystemExit):
        pbench.main(["--mode", "kernel", "--device", "cpu", "--layout", "wide"])
    with pytest.raises(ValueError):
        pbench.run_kernel_bench("latency", device="cpu")
