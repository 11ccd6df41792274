"""Whole runs of tiny cells on the CPU: the harness drives the program
and the judge passes it; the control, one precision lower, fails; each
fault a serving cell can have, planted under the timed path, makes
`correct` false; and a new configuration, workload and metric are found
and run as files alone."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness

from .conftest import TINY_DENSE, tiny_cell, write_cell

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 5


def run(root, name="tiny-dense.closed", **kw):
    return harness.run(name, SEED, 1.5, False, device="cpu", root=root, **kw)


@pytest.mark.parametrize("name", ["tiny-dense.closed", "tiny-lfm2.closed",
                                  "tiny-dense.poisson"])
def test_a_sound_run_is_correct_and_the_control_is_not(tiny_root, name):
    r = run(tiny_root, name, control=True)
    assert r["correct"], r["compared"]
    assert list(r)[-1] == "compared" and r["failed"] == 0
    assert set(r["metrics"]) == {"audio_x_realtime", "ttfa_p50_s",
                                 "ttfa_p95_s", "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    limits = {k: c["limit"] for k, c in r["compared"].items()}
    assert any(r["control"][k] > limits[k] for k in limits), r["control"]
    assert r["control_correct"] is False


def _alter_token(monkeypatch):
    import miotts_tpu_torch.models.llm as llm
    sample = llm.sample_tokens_slots

    def altered(logits, temperature, seed, drawn):
        tok = sample(logits, temperature, seed, drawn)
        hit = (drawn % 3) == 1
        return torch.where(hit, (tok + 1) % logits.shape[-1], tok)
    monkeypatch.setattr(llm, "sample_tokens_slots", altered)


def _state_unchanged(monkeypatch):
    import miotts_tpu_torch.runtime.batching as batching
    chunk = batching.llm_generate_chunk_batched

    def unchanged(params, last, cache, *a, **k):
        kept = {key: cache[key].clone() for key in ("k", "v", "conv")
                if key in cache}
        out = chunk(params, last, cache, *a, **k)
        for key, v in kept.items():
            out[3][key].copy_(v)
        return out
    monkeypatch.setattr(batching, "llm_generate_chunk_batched", unchanged)


def _half_batch(monkeypatch):
    import miotts_tpu_torch.runtime.batching as batching
    prefill = batching.llm_prefill_slots

    def half(params, tokens, n_real, cache, slots, cfg):
        A = tokens.shape[0]
        last = torch.zeros((A, cfg.n_vocab), dtype=torch.float32)
        if A // 2:
            part, cache = prefill(params, tokens[:A // 2], n_real[:A // 2],
                                  cache, slots[:A // 2], cfg)
            last[:A // 2] = part
            last[A // 2:] = part.mean(dim=0)
        return last, cache
    monkeypatch.setattr(batching, "llm_prefill_slots", half)


def _audio_altered(monkeypatch):
    from miotts_tpu_torch.runtime.engine import TTSEngine
    sliced = TTSEngine._codec_audio_sliced

    def louder(self, *a, **k):
        out = sliced(self, *a, **k)
        return out * 1.05 if out.dtype == torch.float32 else (
            out.float() * 1.05).to(out.dtype)
    monkeypatch.setattr(TTSEngine, "_codec_audio_sliced", louder)


@pytest.mark.parametrize("name", ["tiny-dense.closed", "tiny-dense.poisson"])
@pytest.mark.parametrize("fault", [_alter_token, _state_unchanged,
                                   _half_batch, _audio_altered],
                         ids=["token_altered", "state_unchanged",
                              "half_batch", "audio_altered"])
def test_each_fault_makes_the_run_incorrect(tiny_root, monkeypatch, fault,
                                            name):
    fault(monkeypatch)
    r = run(tiny_root, name)
    assert not r["correct"], r["compared"]


def test_a_traced_open_loop_serves_no_burst(tiny_root):
    """Poisson arrivals do not pile up while the profiler starts (seconds
    on the CPU): without the held traffic clock they reach the traced
    window at once and wait ~0.8 s for a slot here; with it, the next
    admission wave."""
    r = harness.run("tiny-dense.poisson", SEED, 2.0, True, device="cpu",
                    root=tiny_root)
    assert r["correct"], r["compared"]
    assert r["metrics"]["queue_wait_p95_s"]["value"] < 0.4


NEW_METRIC = '''"""A reader added as a file: chunks traced."""
UNIT, BETTER, SOURCE = "chunks", "higher", "program_counter"
LAYER = "scheduler: runtime/batching.py"
MOVES = "audio_x_realtime"


def read(ctx):
    return float(len(ctx.chunks)) if ctx.chunks else None
'''


def test_new_cells_and_metrics_are_files_alone(tmp_path):
    copy = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", copy,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (tmp_path / "miotts_tpu_torch").symlink_to(ROOT / "miotts_tpu_torch")
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    cfg = dict(TINY_DENSE, name="tiny-new")
    write_cell(copy, "tiny-new.closed", cfg,
               tiny_cell(cfg, trace_seconds=0.6))
    (copy / "metrics" / "chunks_traced.py").write_text(NEW_METRIC)
    assert all(p.read_bytes() == b for p, b in before.items())

    listed = subprocess.run(
        [sys.executable, str(copy / "run.py"), "--list"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300, check=True)
    found = json.loads(listed.stdout.strip().splitlines()[-1])
    assert "tiny-new.closed" in found["workloads"]
    assert "chunks_traced" in found["per_layer"]

    code = ("import json, sys; sys.path.insert(0, '.');"
            "from portbench import harness;"
            "r = harness.run('tiny-new.closed', 9, 1.5, True, device='cpu');"
            "print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["compared"]
    assert r["metrics"]["chunks_traced"]["value"] >= 1
    assert r["metrics"]["chunks_traced"]["unit"] == "chunks"


def test_the_command_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "lfm2-1.2b.serve64-closed", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_run_writes_no_files(tiny_root, tmp_path, monkeypatch):
    """The model files live in anonymous memory: nothing lands in TMPDIR,
    in the run's folder or beside the cell files."""
    tmp = tmp_path / "tmpdir"
    tmp.mkdir()
    monkeypatch.setenv("TMPDIR", str(tmp))
    before = sorted(p for p in tiny_root.rglob("*"))
    assert run(tiny_root)["correct"]
    assert list(tmp.iterdir()) == []
    assert sorted(p for p in tiny_root.rglob("*")) == before


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card(tiny_root):
    """On a card: the tiny cell through the CUDA kernels, untraced and
    traced, is correct and the traced run reads the device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = harness.run("tiny-dense.closed", SEED, 2.0, False, root=tiny_root)
    assert r["correct"], r["compared"]
    t = harness.run("tiny-dense.closed", SEED, 2.0, True, root=tiny_root)
    assert t["correct"], t["compared"]
    assert t["device"]["busy_s"] > 0
    assert {"qdot_all_roofline", "attn_roofline", "device_idle_share",
            "host_launches_per_step"} <= set(t["metrics"])
    assert t["metrics"]["qdot_all_roofline"]["value"] <= 105
