"""The port stands alone: importing every module of miotts_tpu_torch and
chip_smoke.py pulls in neither JAX nor the JAX package, and no source file
of the port names them."""

import json
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import miotts_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "miotts_tpu_torch"


def _port_modules() -> list[str]:
    return ["miotts_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages([str(PORT)], "miotts_tpu_torch.")]


def test_importing_the_port_loads_no_jax():
    """In a fresh interpreter: import every port module and chip_smoke, then
    list what landed in sys.modules."""
    mods = _port_modules() + ["chip_smoke"]
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=str(ROOT), timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded
           if m == "jax" or m.startswith(("jax.", "jaxlib"))
           or m == "miotts_tpu" or m.startswith("miotts_tpu.")]
    assert not bad, bad
    assert "miotts_tpu_torch.ops.qmat" in loaded
    assert "miotts_tpu_torch.ops.decode_attn" in loaded
    assert "miotts_tpu_torch.runtime.server" in loaded
    assert "regex" not in loaded     # the GPU machine has no `regex` package


def test_port_sources_name_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|regex)\b"
                     r"|miotts_tpu\.(?!\w*_torch)|import miotts_tpu\b(?!_torch)",
                     re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        text = f.read_text()
        code = "\n".join(line for line in text.splitlines()
                         if not line.lstrip().startswith("#"))
        hits = [m.group(0) for m in pat.finditer(code)
                if "miotts_tpu/" not in m.group(0)]
        assert not hits, (f.name, hits)


def test_every_port_module_has_a_counterpart_layout():
    """The port mirrors the JAX package's layout."""
    for sub in ("gguf", "text", "audio", "ops", "models", "runtime"):
        assert (PORT / sub / "__init__.py").exists(), sub
    for src in ("qdot.cu", "qdot_gemv.cu", "decode_attn.cu",
                "decode_attn_single.cu"):
        assert (PORT / "ops" / "csrc" / src).exists(), src
    assert miotts_tpu_torch.__version__
