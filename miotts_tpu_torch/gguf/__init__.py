"""GGUF container support (reader, writer, quant codecs), host side, numpy
only."""

from .reader import (
    GGUFReader, TensorInfo, load_voice_embedding, ggml_type_name, ggml_nbytes,
    GGML_F32, GGML_F16, GGML_BF16, GGML_Q4_0, GGML_Q4_K, GGML_Q5_K,
    GGML_Q6_K, GGML_Q8_0, GGML_I32,
)
from .quants import (
    GroupQuant, dequantize, quantize, to_group_quant, is_quantized,
)
from .writer import GGUFWriter, write_voice_embedding

__all__ = [
    "GGUFReader", "TensorInfo", "load_voice_embedding", "ggml_type_name",
    "ggml_nbytes", "GGUFWriter", "write_voice_embedding",
    "GroupQuant", "dequantize", "quantize", "to_group_quant", "is_quantized",
    "GGML_F32", "GGML_F16", "GGML_BF16", "GGML_Q4_0", "GGML_Q4_K",
    "GGML_Q5_K", "GGML_Q6_K", "GGML_Q8_0", "GGML_I32",
]
