"""The port stands alone: it imports torch, numpy and the standard
library, never jax, nothing of `gubernator_tpu`, and not
prometheus_client (the port renders its own exposition)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "gubernator_tpu_torch"


def _port_modules():
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_imports_with_jax_and_reference_package_blocked():
    """Every module of the package imports in a fresh interpreter where
    `import jax`, `import gubernator_tpu` and `import prometheus_client`
    fail."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gubernator_tpu'] = None\n"
        "sys.modules['prometheus_client'] = None\n"
        "import importlib\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v is not None]\n"
        "print('ok')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax_or_reference_package(path):
    """No import statement names jax, gubernator_tpu or
    prometheus_client (the port keeps its own copies of what it
    needs)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "gubernator_tpu", "prometheus_client"), (
                f"{path}:{node.lineno} imports {n}"
            )


@pytest.mark.parametrize("module", [
    "gubernator_tpu_torch.ops.narrow",
    "gubernator_tpu_torch.ops.paged",
    "gubernator_tpu_torch.runtime.pager",
    "gubernator_tpu_torch.bench",
    "gubernator_tpu_torch.ops.cuda_decide",
    "gubernator_tpu_torch.parallel.mesh",
    "gubernator_tpu_torch.runtime.topology",
    "gubernator_tpu_torch.runtime.ici_engine",
    "gubernator_tpu_torch.ablate",
    "gubernator_tpu_torch.wire",
    "gubernator_tpu_torch.service.fastpath",
    "gubernator_tpu_torch.service.server",
    "gubernator_tpu_torch.runtime.engine",
    "gubernator_tpu_torch.ops.census",
    "gubernator_tpu_torch.ops.admission",
    "gubernator_tpu_torch.ops.inject",
    "gubernator_tpu_torch.parallel.ici",
    "gubernator_tpu_torch.store",
    "gubernator_tpu_torch.store.store",
    "gubernator_tpu_torch.metrics",
    "gubernator_tpu_torch.runtime.telemetry",
    "gubernator_tpu_torch.runtime.watchdog",
    "gubernator_tpu_torch.utils.devicemem",
    "gubernator_tpu_torch.service.admission",
    "gubernator_tpu_torch.utils.timeseries",
    "gubernator_tpu_torch.service.slo",
    "gubernator_tpu_torch.service.overload",
    "gubernator_tpu_torch.ops.decide",
    "gubernator_tpu_torch.ops.packed",
    "gubernator_tpu_torch.ops.kernels",
])
def test_slice_modules_are_checked(module):
    """The narrow layout, the paged table, the pager, the bench, the
    scan and sharded wrappers, the mesh, the topologies, the mesh
    engine, the kernel ablation tool, the wire path, the columnar edge,
    the bytes serving core, the pipelined engine, the table scans, the
    inject, the GLOBAL replica tier, the Store and Loader seams, and
    the observability core (the metrics registry with its exposition,
    the flight recorder, the watchdog, device memory, decision
    provenance), the overload control plane with the SLO observatory
    and its time-series rings, and the wide and packed layouts with the
    registry that serves all four are among the modules
    imported above with jax, gubernator_tpu and prometheus_client
    blocked."""
    assert module in _port_modules()


def test_wire_library_builds_from_the_port_source():
    """The wire path loads the port's own build of csrc/wirepath.cc
    (into gubernator_tpu_torch/_build/), never the JAX package's
    native/ library."""
    from gubernator_tpu_torch import wire
    from gubernator_tpu_torch.ops import _build

    lib = wire.load()
    assert lib._name == str(_build.lib_path("wirepath"))
    assert _build.lib_path("wirepath").parent == PKG / "_build"
    assert "native" not in Path(lib._name).parts
