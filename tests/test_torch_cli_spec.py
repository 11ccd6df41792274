"""`--draft-model` / `--spec-tokens` in the port's CLI against the JAX
package's CLI (tests/test_spec_decode.py's tiny target and draft, the port
on `--device cpu`): `synth` and `bench` decode speculatively, `bench`
prints the two spec lines, `serve` warns and drops the draft.

Held exactly: a speculative WAV is the draft-less one bit for bit; the
acceptance rate and token count are JAX's."""

import re

import numpy as np
import pytest

from miotts_tpu import cli as jcli
from miotts_tpu.audio.wav import wav_read
from miotts_tpu.gguf import write_voice_embedding
from miotts_tpu.models.synthetic import write_synthetic_codec, write_synthetic_llm
from miotts_tpu_torch import cli as tcli
from miotts_tpu_torch.runtime import engine as te
from torch_port_util import few_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_spec")
    codec, target, draft, emb = (str(d / n) for n in (
        "codec.gguf", "target.gguf", "draft.gguf", "voice.emb.gguf"))
    ccfg = write_synthetic_codec(codec, n_codes=64, seed=3)
    write_synthetic_llm(target, seed=5, n_speech=64)
    write_synthetic_llm(draft, seed=9, n_speech=64)
    write_voice_embedding(emb, np.random.default_rng(0)
                          .standard_normal(ccfg.adaln_dim) * 0.3)
    return dict(codec=codec, target=target, draft=draft, voice=emb)


def _args(p, cmd, *extra):
    return [cmd, "-m", p["target"], "-c", p["codec"], "-v", p["voice"],
            "-p", "speculative cli", "-t", "0", "--max-tokens", "60",
            *extra]


def _s16(path):
    x, sr = wav_read(path)
    return np.round(x * 32768.0).astype(np.int32), sr


@pytest.mark.parametrize("k", ["1", "6"])
def test_synth_with_draft_matches_plain(paths, tmp_path, capsys, k):
    """`synth --draft-model D --spec-tokens k -t 0` writes the port's
    draft-less WAV bit for bit (the same greedy tokens).  The CLI runs the
    LLM in bf16, where the two packages' logits differ (the bf16-logits
    difference of ROADMAP.md), so the tokens are held against the JAX
    package in f32 by tests/test_torch_spec_decode.py; the JAX CLI takes
    the same flags."""
    spec = ["--draft-model", paths["draft"], "--spec-tokens", k]
    wavs = []
    for extra in (spec, []):
        out = str(tmp_path / f"{len(extra)}.wav")
        assert tcli.main(_args(paths, "synth", "-o", out, "--device", "cpu",
                               *extra)) == 0
        wavs.append(_s16(out))
    assert "Saved:" in capsys.readouterr().err
    (got, sr), (want, sr2) = wavs
    assert sr == sr2 and got.size == want.size > 0
    assert np.array_equal(got, want)
    assert jcli.main(_args(paths, "synth", "-o", str(tmp_path / "jax.wav"),
                           *spec)) == 0


def _metrics(text: str) -> dict:
    return dict(re.findall(r"^(\S+?)=(\S+)", text, re.M))


def test_bench_prints_spec_lines(paths, capsys):
    """`bench` with a draft prints stream_bench.spec_rounds and
    stream_bench.spec_accept_rate, as the JAX CLI does, beside every
    stream_bench.* key of a draft-less bench.  60 greedy tokens at
    acceptance 0 (both packages): one token a round after the first, which
    the host draws; the port runs no round past the budget, JAX's last
    chunk runs on to its 20 tokens, so JAX counts as many rounds or more."""
    spec = ["--draft-model", paths["draft"], "--spec-tokens", "3"]
    assert jcli.main(_args(paths, "bench", *spec)) == 0
    want = _metrics(capsys.readouterr().out)
    assert tcli.main(_args(paths, "bench", *spec, "--device", "cpu")) == 0
    got = _metrics(capsys.readouterr().out)
    assert tcli.main(_args(paths, "bench", "--device", "cpu")) == 0
    plain = _metrics(capsys.readouterr().out)
    assert "stream_bench.spec_rounds" not in plain
    assert set(got) == set(plain) | {"stream_bench.spec_rounds",
                                     "stream_bench.spec_accept_rate"}
    for key in ("stream_bench.spec_accept_rate", "stream_bench.llm_tokens"):
        assert got[key] == want[key], key
    rounds = int(got["stream_bench.spec_rounds"])
    assert float(got["stream_bench.spec_accept_rate"]) == 0.0
    assert rounds == int(got["stream_bench.llm_tokens"]) - 1
    assert int(want["stream_bench.spec_rounds"]) >= rounds


def test_skip_llm_ignores_the_draft(paths, tmp_path):
    """With --skip-llm no model and so no draft is loaded (the JAX CLI's
    condition: a draft needs a target)."""
    out = str(tmp_path / "skip.wav")
    assert tcli.main(["synth", "-c", paths["codec"], "-v", paths["voice"],
                      "-p", "<|s_1|><|s_2|><|s_3|>", "--skip-llm",
                      "--draft-model", paths["draft"], "-o", out,
                      "--device", "cpu"]) == 0
    assert _s16(out)[0].size > 0


def test_serve_warns_and_drops_the_draft(paths, tmp_path, monkeypatch,
                                         capsys):
    """`serve --draft-model D`: a warning on stderr, and the engine it
    serves loads no draft (speculative decoding is single-stream)."""
    import shutil
    from miotts_tpu_torch.runtime import server
    voices = tmp_path / "voices"
    voices.mkdir()
    shutil.copy(paths["voice"], voices / "a.emb.gguf")
    served = {}
    monkeypatch.setattr(server, "serve",
                        lambda engine, voices, **kw: served.update(
                            engine=engine, voices=voices))
    assert tcli.main(["serve", "-m", paths["target"], "-c", paths["codec"],
                      "--voices-dir", str(voices), "--draft-model",
                      paths["draft"], "--device", "cpu"]) == 0
    assert "--draft-model is ignored" in capsys.readouterr().err
    eng = served["engine"]
    assert isinstance(eng, te.TTSEngine) and eng.draft_params is None
    assert list(served["voices"]) == ["a"]
