"""Carry parameter trees and KV caches of the JAX package over to the port.

The functions take the JAX package's params as nested dicts / lists of
numpy arrays, so the port never needs JAX or its classes: a quantized
weight arrives as a dict {values, scales, mins, group, n_out, packed} in the
JAX layout (values / scales / mins transposed to [K(/2), N] and padded to
128 output lanes).  The padding is cut here, so every QTensor of the port
has n_out == N.  bf16 arrays (numpy's ml_dtypes bfloat16) convert exactly
through f32; a QTensor keeps its scales' dtype (f32, or bf16 under the JAX
package's MIOTTS_SCALE_BF16).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.qmat import QTensor

_STACKED_CODEC_BLOCKS = ("prenet_blocks", "prior_blocks", "decoder_blocks",
                         "post_blocks")


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # an owning copy


def _qtensor(d: dict, device) -> QTensor:
    n = int(d["n_out"]) if int(d["n_out"]) > 0 else np.asarray(d["values"]).shape[1]

    def cut(a):
        return None if a is None else _tensor(np.asarray(a)[:, :n], device)
    return QTensor(values=cut(d["values"]), scales=cut(d["scales"]),
                   mins=cut(d["mins"]),
                   group=int(d["group"]), n_out=n, packed=bool(d["packed"]))


def _convert(obj, device):
    if isinstance(obj, dict):
        if "values" in obj and "group" in obj:
            return _qtensor(obj, device)
        return {k: _convert(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_convert(v, device) for v in obj]
    return _tensor(obj, device)


def llm_params_from_numpy(tree: dict, device="cpu") -> dict:
    """JAX `load_llm_params` tree (numpy leaves) -> the port's LLM params:
    "blocks" of a dense model or "layers" of a hybrid one, key for key."""
    if "blocks" not in tree and "layers" not in tree:
        raise ValueError("an LLM tree has 'blocks' (dense) or 'layers' "
                         "(hybrid)")
    return _convert(tree, device)


def codec_params_from_numpy(tree: dict, device="cpu") -> dict:
    """JAX `load_codec_params` tree (numpy leaves) -> the port's codec
    params: the stacked per-layer blocks (JAX scans over them) become lists
    of per-layer dicts."""
    out = {}
    for key, val in tree.items():
        if key in _STACKED_CODEC_BLOCKS:
            n = len(next(iter(val.values())))
            out[key] = [{k: _tensor(np.asarray(a)[i], device)
                         for k, a in val.items()} for i in range(n)]
        else:
            out[key] = _convert(val, device)
    return out


def kv_cache_from_numpy(cache: dict, device="cpu") -> dict:
    """JAX `init_kv_cache` dict (numpy leaves: k, v, optional k_scale /
    v_scale, a hybrid model's conv state, fill) -> the port's cache, same
    layouts ([L, B, H_kv, S, D]; conv [n_conv, B, L_cache - 1, dim]) and
    dtypes (fill as int32)."""
    out = {k: _tensor(v, device) for k, v in cache.items()}
    out["fill"] = out["fill"].to(torch.int32)
    return out
