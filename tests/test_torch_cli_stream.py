"""The port's `stream`, `bench`, `compare` and `analyze` subcommands
against the JAX package's CLI (tests/test_cli.py's tiny models, the port on
`--device cpu`).

Tolerances: streamed PCM within one s16 step (f32_to_s16 truncates, and the
two codecs differ by ~1e-6 in f32); compare.* and analyze numbers within
1e-4 (relative to 1)."""

import re

import numpy as np
import pytest

from miotts_tpu import cli as jcli
from miotts_tpu.audio.wav import wav_write
from miotts_tpu.gguf import write_voice_embedding
from miotts_tpu.models.synthetic import write_synthetic_codec, write_synthetic_llm
from miotts_tpu.text import format_speech_tokens
from miotts_tpu_torch import cli as tcli
from torch_port_util import few_torch_threads  # noqa: F401

NUM_TOL = 1e-4


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_stream")
    codec, llm, emb = (str(d / n) for n in ("codec.gguf", "llm.gguf",
                                            "voice.emb.gguf"))
    ccfg = write_synthetic_codec(codec, n_codes=64, seed=3)
    write_synthetic_llm(llm, seed=5, n_speech=64)
    write_voice_embedding(emb, np.random.default_rng(0)
                          .standard_normal(ccfg.adaln_dim) * 0.3)
    return d, codec, llm, emb


def _both(capsys, args, port_extra=("--device", "cpu")):
    """Run `args` through the JAX CLI, then the port's (on the CPU):
    [(rc, stdout)] x 2."""
    out = []
    for main, extra in ((jcli.main, []), (tcli.main, list(port_extra))):
        rc = main(args + extra)
        out.append((rc, capsys.readouterr().out))
    return out


def _metrics(text: str) -> dict:
    return {k: v for k, v in re.findall(r"^(\S+?)=(\S+)", text, re.M)}


CODES = format_speech_tokens(np.random.default_rng(9).integers(0, 64, 90))


@pytest.mark.parametrize("source", ["skip_llm", "greedy"])
def test_stream_to_file_matches_jax(paths, tmp_path, capsys, source):
    """`stream -o FILE`: 90 scripted codes (one decode, in chunks) or 60 greedy
    tokens; the same s16le PCM length, within one s16 step."""
    d, codec, llm, emb = paths
    base = ["stream", "-c", codec, "-v", emb, "--chunk-samples", "2048"]
    base += (["-p", CODES, "--skip-llm"] if source == "skip_llm" else
             ["-m", llm, "-p", "stream me", "-t", "0", "--max-tokens", "60"])
    pcm = []
    for i, (main, extra) in enumerate(((jcli.main, []),
                                       (tcli.main, ["--device", "cpu"]))):
        out = str(tmp_path / f"out{i}.pcm")
        assert main(base + ["-o", out] + extra) == 0
        pcm.append(np.fromfile(out, dtype="<i2").astype(np.int32))
    want, got = pcm
    assert got.size == want.size > 0
    assert int(np.max(np.abs(got - want))) <= 1


def test_bench_prints_jax_keys(paths, capsys):
    """`bench`: the JAX CLI's stream_bench.* keys, and the same counts."""
    d, codec, llm, emb = paths
    (jrc, jout), (trc, tout) = _both(
        capsys, ["bench", "-c", codec, "-v", emb, "-p", CODES, "--skip-llm"])
    assert jrc == trc == 0
    want, got = _metrics(jout), _metrics(tout)
    assert set(got) == set(want)
    for k in ("audio_sec", "llm_tokens", "decode_calls", "decoded_codes",
              "emitted_samples"):
        assert got[f"stream_bench.{k}"] == want[f"stream_bench.{k}"]
    assert re.search(r"^stream_bench\.stage\.codec_sec=\S+ \(\S+%\)$", tout,
                     re.M)


def test_bench_trace_writes_a_chrome_trace(paths, tmp_path, capsys):
    d, codec, llm, emb = paths
    trace = tmp_path / "trace"
    assert tcli.main(["bench", "-c", codec, "-v", emb, "-p", CODES,
                      "--skip-llm", "--device", "cpu", "--trace",
                      str(trace)]) == 0
    assert "stream_bench.x_realtime=" in capsys.readouterr().out
    assert (trace / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("source", ["skip_llm", "greedy"])
def test_compare_matches_jax(paths, capsys, source):
    """`compare`: the same sample counts and compare.* numbers within
    1e-4."""
    d, codec, llm, emb = paths
    args = ["compare", "-c", codec, "-v", emb]
    args += (["-p", CODES, "--skip-llm"] if source == "skip_llm" else
             ["-m", llm, "-p", "compare me", "-t", "0", "--max-tokens", "60"])
    (jrc, jout), (trc, tout) = _both(capsys, args)
    assert jrc == trc == 0
    want, got = _metrics(jout), _metrics(tout)
    assert set(got) == set(want) and "compare.best_lag_samples" in got
    for k in ("compare.offline_samples", "compare.stream_samples",
              "compare.best_lag_samples"):
        assert got[k] == want[k]
    for k in set(got) - {"compare.best_lag_samples"}:
        assert abs(float(got[k]) - float(want[k])) < NUM_TOL, k


def test_analyze_matches_jax(paths, tmp_path, capsys):
    d, codec, llm, emb = paths
    sr = 44100
    t = np.arange(sr // 2) / sr
    rng = np.random.default_rng(3)
    x = (0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
         + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
    wav = str(tmp_path / "an.wav")
    wav_write(wav, x, sr)
    (jrc, jout), (trc, tout) = _both(capsys, ["analyze", wav], port_extra=())
    assert jrc == trc == 0
    want = re.findall(r"^\s+(\w+): (.*)$", jout, re.M)
    got = re.findall(r"^\s+(\w+): (.*)$", tout, re.M)
    assert [k for k, _ in got] == [k for k, _ in want] and "rms" in dict(got)
    for (k, gv), (_, wv) in zip(got, want):
        nums_g = [float(v) for v in re.findall(r"-?\d+\.?\d*(?:e-?\d+)?", gv)]
        nums_w = [float(v) for v in re.findall(r"-?\d+\.?\d*(?:e-?\d+)?", wv)]
        assert len(nums_g) == len(nums_w), k
        for a, b in zip(nums_g, nums_w):
            assert abs(a - b) <= NUM_TOL * max(1.0, abs(b)), k
