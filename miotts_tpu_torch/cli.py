"""miotts-torch CLI: synthesis and serving on PyTorch / CUDA.

  python -m miotts_tpu_torch.cli synth -m LLM.gguf -c CODEC.gguf \\
      -v VOICE.emb.gguf -p "text" -o out.wav [--device cuda]
  python -m miotts_tpu_torch.cli serve -m LLM.gguf -c CODEC.gguf \\
      --voices-dir VOICES/ [--port 8080] [--slots 8] [--device cuda]

Flags follow the JAX package's `synth` and `serve`, plus `--device`
(default cuda; the command fails when CUDA is asked for and absent).
"""

from __future__ import annotations

import argparse
import sys


def cmd_synth(args) -> int:
    from .runtime.engine import EngineConfig, Options, TTSEngine, VoiceModel
    if not args.prompt:
        print("Error: --prompt is required", file=sys.stderr)
        return 1
    if not args.skip_llm and not args.model:
        print("Error: --model is required (or use --skip-llm)", file=sys.stderr)
        return 1
    if not args.voice:
        print("Error: --voice is required", file=sys.stderr)
        return 1
    try:
        # same failure semantics as the JAX CLI: message, exit 1, no WAV
        engine = TTSEngine(EngineConfig(
            model_path="" if args.skip_llm else args.model,
            codec_path=args.codec, temperature=args.temp,
            max_tokens=args.max_tokens, seed=args.seed, device=args.device))
        voice = VoiceModel(args.voice)
        engine.synthesize_to_file(voice, args.prompt, args.output, Options(
            temperature=args.temp, max_tokens=args.max_tokens,
            skip_llm=args.skip_llm, seed=args.seed))
    except (RuntimeError, ValueError, OSError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"Saved: {args.output}", file=sys.stderr)
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
    p.add_argument("-m", "--model", default="", help="MioTTS LLM GGUF path")
    p.add_argument("-c", "--codec", required=True, help="MioCodec GGUF path")
    p.add_argument("-v", "--voice", default="", help="voice .emb.gguf path")
    p.add_argument("-p", "--prompt", default="", help="text to synthesize")
    p.add_argument("-t", "--temp", type=float, default=0.8)
    p.add_argument("--max-tokens", type=int, default=700)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--skip-llm", action="store_true",
                   help="treat --prompt as raw <|s_N|> token text")
    p.add_argument("-o", "--output", default="output.wav")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' on request)")
    p.set_defaults(fn=cmd_synth)

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
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' on request)")
    p.set_defaults(fn=cmd_serve)
    args = parser.parse_args(argv)
    if not getattr(args, "fn", None):
        parser.print_help()
        return 1
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
