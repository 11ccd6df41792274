"""Nothing the benchmark loads is JAX or the JAX package, and the plain
reference loads nothing of the program.  Each check runs in a fresh
interpreter and compares whole top-level module names: `miotts_tpu_torch`
is not `miotts_tpu`."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"

PROBE = r"""
import importlib, json, sys
sys.path.insert(0, {root!r})
for name in {modules!r}:
    importlib.import_module(name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_after_import(modules: list) -> set:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT), modules=modules)],
        capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def benchmark_modules(sub: str = "") -> list:
    base = PB / sub if sub else PB
    mods = []
    for p in sorted(base.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        if "tests" in rel.parts:
            continue
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_no_module_of_the_benchmark_loads_jax_or_the_jax_package():
    mods = benchmark_modules() + ["miotts_tpu_torch.runtime.batching",
                                  "miotts_tpu_torch.runtime.engine"]
    assert "portbench.run" in mods and "portbench.reference.judge" in mods
    loaded = top_level_after_import(mods)
    assert {"portbench", "torch", "miotts_tpu_torch"} <= loaded
    assert not loaded & {"jax", "jaxlib", "flax", "miotts_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    """The reference and the architectures' files, whose `layer` is the
    reference's."""
    mods = benchmark_modules("reference") + benchmark_modules("archs")
    assert "portbench.archs.lfm2" in mods
    loaded = top_level_after_import(mods)
    assert "portbench" in loaded
    assert "miotts_tpu_torch" not in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "miotts_tpu"}


def test_the_harness_names_what_it_finds():
    from portbench import harness
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & set(harness.FORBIDDEN))
    assert "miotts_tpu" in harness.FORBIDDEN
    assert "miotts_tpu_torch" not in harness.FORBIDDEN
