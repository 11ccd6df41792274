"""miotts-torch CLI: synthesis, streaming and serving on PyTorch / CUDA.

  python -m miotts_tpu_torch.cli synth -m LLM.gguf -c CODEC.gguf \\
      -v VOICE.emb.gguf -p "text" -o out.wav [--device cuda] \\
      [--draft-model DRAFT.gguf --spec-tokens 6]
  python -m miotts_tpu_torch.cli stream ... [-o out.pcm | -o -] \\
      [--device-audio]
  python -m miotts_tpu_torch.cli bench ... [--trace DIR]
  python -m miotts_tpu_torch.cli compare ... [-o PREFIX]
  python -m miotts_tpu_torch.cli analyze out.wav
  python -m miotts_tpu_torch.cli serve -m LLM.gguf -c CODEC.gguf \\
      --voices-dir VOICES/ [--port 8080] [--slots 8] [--device cuda]

Subcommands and flags follow the JAX package's CLI:
  synth      text -> WAV (`--dump-tensors`: list the codec GGUF's tensors)
  stream     streaming synthesis through the bounded playback queue into a
             PCM sink (s16le, stdout or a file) or the host's audio device
  bench      streaming benchmark, prints stream_bench.* metrics
  compare    offline-vs-streaming fidelity, prints compare.* metrics
  analyze    waveform health report for WAV files
  serve      HTTP server over the continuous batcher
`--draft-model` / `--spec-tokens` (synth, stream, bench, compare) decode
speculatively with a draft model; `serve` ignores a draft with a warning.
`--device` names the torch device (default cuda; the command fails when
CUDA is asked for and absent), so the JAX package's `stream --device` (play
on the host's sound card) is `stream --device-audio` here.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' on request)")


def _add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-m", "--model", default="", help="MioTTS LLM GGUF path")
    p.add_argument("-c", "--codec", required=True, help="MioCodec GGUF path")
    p.add_argument("-v", "--voice", default="", help="voice .emb.gguf path")
    p.add_argument("-p", "--prompt", default="", help="text to synthesize")
    p.add_argument("-t", "--temp", type=float, default=0.8)
    p.add_argument("--max-tokens", type=int, default=700)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--skip-llm", action="store_true",
                   help="treat --prompt as raw <|s_N|> token text")
    p.add_argument("--draft-model", default="",
                   help="smaller GGUF of the same vocab (e.g. the 0.1B for "
                        "the 2.6B) for speculative decoding: the output "
                        "distribution is exact, the tokens identical at -t 0")
    p.add_argument("--spec-tokens", type=int, default=6,
                   help="draft tokens per speculative round (with "
                        "--draft-model)")
    p.add_argument("--holdback-codes", type=int, default=32,
                   help="streaming commit holdback: codes of right context "
                        "held back from every mid-stream emission (the "
                        "reference's fixed 32).  Raising it trades time to "
                        "first audio for stream-vs-offline fidelity: the "
                        "codec's receptive field is ~6x32 codes")
    _add_device_arg(p)


def _make_engine(args):
    from .runtime.engine import EngineConfig, TTSEngine
    return TTSEngine(EngineConfig(
        model_path="" if args.skip_llm else args.model,
        codec_path=args.codec, temperature=args.temp,
        max_tokens=args.max_tokens, seed=args.seed,
        draft_model_path=args.draft_model, spec_tokens=args.spec_tokens,
        holdback_codes=args.holdback_codes, device=args.device))


def _make_options(args):
    from .runtime.engine import Options
    return Options(temperature=args.temp, max_tokens=args.max_tokens,
                   skip_llm=args.skip_llm, seed=args.seed)


def _check_inputs(args) -> bool:
    """The JAX CLI's input checks: a prompt, a model unless --skip-llm,
    a voice; a message and False on the first that fails."""
    if not args.prompt:
        print("Error: --prompt is required", file=sys.stderr)
        return False
    if not args.skip_llm and not args.model:
        print("Error: --model is required (or use --skip-llm)", file=sys.stderr)
        return False
    if not args.voice:
        print("Error: --voice is required", file=sys.stderr)
        return False
    return True


def _engine_and_voice(args):
    """(engine, voice), or None after printing the error (bad paths, no
    CUDA): the reference's failure semantics, a message and exit 1."""
    from .runtime.engine import VoiceModel
    if not _check_inputs(args):
        return None
    try:
        return _make_engine(args), VoiceModel(args.voice)
    except (RuntimeError, ValueError, OSError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return None


def dump_tensors(path: str) -> None:
    """The JAX CLI's `synth --dump-tensors`: every tensor of the GGUF at
    `path` in file order, its four dims and its type, in the same format."""
    from .gguf import GGUFReader
    with GGUFReader(path) as r:
        print(f"Tensors in {path}: {len(r.tensors)}")
        for name in r.tensor_order:
            info = r.tensors[name]
            ne = list(info.ne) + [1] * (4 - len(info.ne))
            print(f"  {name:<60s} [{ne[0]:5d}, {ne[1]:5d}, {ne[2]:5d}, "
                  f"{ne[3]:5d}] type={info.type_name}")


def cmd_synth(args) -> int:
    if args.dump_tensors:
        dump_tensors(args.codec)
        return 0
    got = _engine_and_voice(args)
    if got is None:
        return 1
    engine, voice = got
    try:
        engine.synthesize_to_file(voice, args.prompt, args.output,
                                  _make_options(args))
    except (RuntimeError, ValueError, OSError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"Saved: {args.output}", file=sys.stderr)
    return 0


def cmd_stream(args) -> int:
    """Real-time streaming through the bounded queue (the reference's
    `examples/stream-to-device.cpp`): `--device-audio` plays on the host's
    audio device through a PCM player process (a paced null sink when none
    is installed); otherwise s16le PCM goes to stdout (`-o -`, e.g. piped
    into `aplay -f S16_LE -r 44100`) or a file."""
    from .runtime.playback import stream_to_sink
    got = _engine_and_voice(args)
    if got is None:
        return 1
    engine, voice = got
    kw = dict(options=_make_options(args), chunk_samples=args.chunk_samples,
              queue_seconds=args.queue_seconds,
              dump_fed_path=args.dump_fed_wav or None)
    if args.device_audio:
        return 0 if stream_to_sink(engine, voice, args.prompt, device=True,
                                   **kw) else 1
    out = sys.stdout.buffer if args.output == "-" else open(args.output, "wb")
    try:
        ok = stream_to_sink(engine, voice, args.prompt, out=out, **kw)
    finally:
        if out is not sys.stdout.buffer:
            out.close()
    return 0 if ok else 1


def cmd_bench(args) -> int:
    """Streaming benchmark with a no-op callback (the reference's
    `examples/stream-benchmark.cpp:86-167` metric contract); `--trace DIR`
    writes a torch.profiler Chrome trace of the stream."""
    from .runtime.profile import StreamProfile, device_trace
    got = _engine_and_voice(args)
    if got is None:
        return 1
    engine, voice = got
    profile = StreamProfile()
    emitted = [0]

    def cb(samples, sr, is_last):
        if samples is not None:
            emitted[0] += len(samples)
        return True

    with device_trace(args.trace):
        ok = engine.synthesize_stream(voice, args.prompt, cb,
                                      chunk_samples=args.chunk_samples,
                                      options=_make_options(args),
                                      profile=profile)
    if not ok:
        print("stream_bench.error=1")
        return 1
    # the fused path times its chunk loop as one stage: move the codec /
    # iSTFT share, measured on the device, out of it
    engine.attribute_stages(profile)
    if not profile.stages_trusted:
        print("stream_bench.stage.untrusted=1  (a device stage measurement "
              "read 0 even after the escalated retry; the codec/istft split "
              "below is unreliable)", file=sys.stderr)
    audio_sec = emitted[0] / engine.sample_rate
    total = max(profile.total_sec, 1e-9)
    for k, v in profile.as_metrics(audio_sec).items():
        if k.startswith("stream_bench.stage."):
            # stages as seconds and percent of the total (the reference's
            # stream-benchmark.cpp:163-166)
            print(f"{k}={v:.6f} ({100.0 * v / total:.2f}%)")
        else:
            print(f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}")
    st = engine._spec_stats
    if st and st["drafted"]:
        # speculative decoding (with --draft-model)
        print(f"stream_bench.spec_rounds={st['rounds']}")
        print(f"stream_bench.spec_accept_rate="
              f"{st['accepted'] / st['drafted']:.4f}")
    return 0


def cmd_compare(args) -> int:
    """Offline vs streaming fidelity (the reference's
    `examples/stream-compare.cpp:100-275`): MAE / RMSE / max-abs, the
    log-spectral distance and the best lag within +-4096 samples."""
    from .audio.metrics import (best_lag_rmse, log_spectral_distance,
                                waveform_errors)
    from .audio.wav import wav_write
    from .runtime.engine import Options
    got = _engine_and_voice(args)
    if got is None:
        return 1
    engine, voice = got
    token_text = engine.generate_token_text(args.prompt, _make_options(args))
    opts = Options(skip_llm=True, apply_peak_normalization=False)
    try:
        offline = engine.synthesize(voice, token_text, opts)
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    chunks = []

    def cb(samples, sr, is_last):
        if samples is not None:
            chunks.append(samples)
        return True

    engine.synthesize_stream(voice, token_text, cb,
                             chunk_samples=args.chunk_samples, options=opts)
    streamed = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    if args.output:
        wav_write(args.output + ".offline.wav", offline, engine.sample_rate)
        wav_write(args.output + ".stream.wav", streamed, engine.sample_rate)

    print(f"compare.offline_samples={len(offline)}")
    print(f"compare.stream_samples={len(streamed)}")
    if min(len(offline), len(streamed)) == 0:
        return 1
    e = waveform_errors(offline, streamed)
    print(f"compare.mae={e['mae']:.8f}")
    print(f"compare.rmse={e['rmse']:.8f}")
    print(f"compare.max_abs={e['max_abs']:.8f}")
    print(f"compare.lsd_db={log_spectral_distance(offline, streamed):.4f}")
    lag, r = best_lag_rmse(offline, streamed)
    print(f"compare.best_lag_samples={lag}")
    print(f"compare.best_lag_rmse={r:.8f}")
    return 0


def cmd_analyze(args) -> int:
    from .audio.analyze import analyze_audio
    from .audio.wav import wav_read
    for path in args.files:
        x, sr = wav_read(path)
        print(f"=== {path} ===")
        for k, v in analyze_audio(x, sr).items():
            print(f"  {k}: {v}")
    return 0


def cmd_serve(args) -> int:
    """HTTP TTS server backed by the continuous batcher."""
    import glob
    import os
    from .runtime.engine import EngineConfig, TTSEngine, VoiceModel
    from .runtime.server import serve
    voices = {os.path.basename(p)[:-len(".emb.gguf")]: VoiceModel(p)
              for p in sorted(glob.glob(os.path.join(args.voices_dir,
                                                     "*.emb.gguf")))}
    if not voices:
        print(f"Error: no *.emb.gguf files in {args.voices_dir}",
              file=sys.stderr)
        return 1
    if args.draft_model:
        # speculation is single-stream: batched serving reads each weight
        # once for all its slots already, and the draft would take device
        # memory the batched KV cache needs
        print("Warning: --draft-model is ignored by `serve` (speculative "
              "decoding is single-stream)", file=sys.stderr)
    try:
        engine = TTSEngine(EngineConfig(
            model_path=args.model, codec_path=args.codec,
            temperature=args.temp, max_tokens=args.max_tokens, seed=args.seed,
            device=args.device))
    except (RuntimeError, ValueError, OSError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    serve(engine, voices, host=args.host, port=args.port, n_slots=args.slots,
          request_timeout_sec=(args.request_timeout
                               if args.request_timeout > 0 else None))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="miotts-torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command")
    p = sub.add_parser("synth", help="offline text -> WAV")
    _add_model_args(p)
    p.add_argument("-o", "--output", default="output.wav")
    p.add_argument("--dump-tensors", action="store_true",
                   help="list the codec GGUF's tensors (name, dims, type) "
                        "and exit")
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("stream", help="stream PCM to a sink (stdout / file) "
                                      "or the host's audio device")
    _add_model_args(p)
    p.add_argument("-o", "--output", default="-",
                   help="s16le PCM sink: '-' for stdout, else a file path")
    p.add_argument("--chunk-samples", type=int, default=4096)
    p.add_argument("--queue-seconds", type=float, default=10.0)
    p.add_argument("--dump-fed-wav", default="",
                   help="also write exactly what the sink consumed as a WAV")
    p.add_argument("--device-audio", action="store_true",
                   help="play on the host's audio device (pw-play / paplay "
                        "/ aplay; the JAX CLI's `stream --device`, renamed "
                        "because --device names the torch device here)")
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("bench", help="streaming benchmark")
    _add_model_args(p)
    p.add_argument("--chunk-samples", type=int, default=4096)
    p.add_argument("--trace", default="",
                   help="write a torch.profiler Chrome trace of the stream "
                        "to DIR/trace.json")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("compare", help="offline vs streaming fidelity")
    _add_model_args(p)
    p.add_argument("--chunk-samples", type=int, default=4096)
    p.add_argument("-o", "--output", default="",
                   help="also write PREFIX.offline.wav and PREFIX.stream.wav")
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("analyze", help="WAV health report")
    p.add_argument("files", nargs="+")
    p.set_defaults(fn=cmd_analyze)

    p = sub.add_parser("serve", help="HTTP TTS server (continuous batching)")
    p.add_argument("-m", "--model", required=True, help="MioTTS LLM GGUF path")
    p.add_argument("-c", "--codec", required=True, help="MioCodec GGUF path")
    p.add_argument("--voices-dir", required=True,
                   help="directory of *.emb.gguf voice files")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--request-timeout", type=float, default=0.0,
                   help="cancel requests running longer than this many "
                        "seconds (0 = unlimited)")
    p.add_argument("-t", "--temp", type=float, default=0.8)
    p.add_argument("--max-tokens", type=int, default=700)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--draft-model", default="",
                   help="ignored, with a warning: speculative decoding is "
                        "single-stream")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_serve)
    args = parser.parse_args(argv)
    if not getattr(args, "fn", None):
        parser.print_help()
        return 1
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
