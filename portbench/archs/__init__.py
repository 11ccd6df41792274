"""Model architectures: one module a `model_type` (as the model's
config.json names it), found by a configuration file's `model_type` as
archs/<model_type>.py (portbench.weights.arch).  Each module gives:

  GGUF_ARCH                  the file's general.architecture, llama.cpp's
                             name for it
  shape_of(c) -> Shape       the config's sizes (weights.shape_from), with
                             what the architecture adds in Shape.sizes
  tensor_specs(s)            the layers' tensors, [(name, numpy shape,
                             role, sigma, offset)] in file order (role
                             weights.F32, or a role the config's quant
                             maps to a format); weights.llm_specs adds the
                             embedding, the final norm and the head
  gguf_kv(s)                 the architecture's metadata KVs
  layer(x, W, p, i, s, lin, mask) -> x
                             the plain reference's layer i (prefix p) in
                             float32 torch, from reference/llm.py's helpers
  matmul_params(s)           parameters a token meets in matrix products,
                             the output head included
  extra_token_flops(s)       a token's FLOPs outside matrix products and
                             attention (the conv taps)
  weight_parts(s)            the program's block key -> the GGUF tensors it
                             packs (without "blk.<i>." and ".weight")

An architecture imports portbench's helpers and nothing of the program."""
