"""miotts_tpu_torch — the MioTTS pipeline on PyTorch and CUDA.

The PyTorch counterpart of `miotts_tpu`: text in, 44.1 kHz PCM out, on one
NVIDIA Hopper GPU.  Every quantized linear runs through a hand-written CUDA
kernel (ops/csrc/qdot.cu); the rest is plain PyTorch.  Layout mirrors the
JAX package so each module's counterpart is easy to find:

  gguf/      GGUF container + quantization block codecs (host, numpy)
  text/      normalizer, BPE tokenizer, speech-token bridge, prompt template
  audio/     WAV I/O
  ops/       quantized matmul (CUDA kernel + plain torch), iSTFT
  models/    causal LM, MioCodec decoder, synthetic model writers
  runtime/   offline synthesis engine
  convert.py carry the JAX package's parameter trees over as numpy dicts
  cli.py     `synth` subcommand
"""

__version__ = "0.1.0"

