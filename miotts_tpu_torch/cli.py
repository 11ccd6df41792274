"""miotts-torch CLI: offline synthesis on PyTorch / CUDA.

  python -m miotts_tpu_torch.cli synth -m LLM.gguf -c CODEC.gguf \\
      -v VOICE.emb.gguf -p "text" -o out.wav [--device cuda]

Flags follow the JAX package's `synth`, plus `--device` (default cuda; the
command fails when CUDA is asked for and absent).
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
    args = parser.parse_args(argv)
    if not getattr(args, "fn", None):
        parser.print_help()
        return 1
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
