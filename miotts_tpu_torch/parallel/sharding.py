"""Tensor- and data-parallel layouts of the LLM's weights and KV cache
(counterpart of `miotts_tpu/parallel/sharding.py`).

The same tables as the JAX package's GSPMD layout, each spec naming the
mesh axis of each logical dim ([out, in] for a matrix):

  * fused `wqkv` / `w_gateup` shard their CONTRACTION dim (row-parallel:
    the concatenated output mixes head groups), `wo` / `w_down` their
    input dim; unfused `wq` / `wk` / `wv` / `w_gate` / `w_up` their output
    dim (column-parallel) with their biases;
  * LFM2's short conv: `in_proj` column-parallel, `out_proj` row-parallel,
    the depthwise `conv_w` replicated;
  * `output` shards the vocab; norms and embeddings are replicated;
  * the KV cache puts batch on 'data' and heads on 'model'.

A dim that does not divide its axis replicates the whole tensor (`_fits`),
and a spec whose axes all have one rank leaves the weight as it is (GSPMD
emits no collective over an axis of one, so a data-parallel-only mesh
runs the unsharded arithmetic).  A dim that divides is cut evenly,
and for a QTensor the values, the scales and the mins must all divide, in
their transposed [K, N] storage (the spec's last two axes swapped), so
every shard holds whole quant groups.  A packed Q4 weight's values
[K / 2, N] are cut in storage rows: with the scales' [K / g, N] dividing,
each shard's rows are whole groups of the per-group nibble split.

`_fits` sees the storage as it is.  The JAX package stores a QTensor
padded to 128 output lanes, so its odd-vocab (13059) quantized head is cut
column-parallel; the port's GGUF loader stores N unpadded, so that served
head does not divide and is replicated on every rank (an unsharded GEMV of
the whole vocab a step).  The CPU tests compare shards against JAX's on the
padded storage.

Where JAX places each shard on its device, `shard_llm_params` returns
THIS rank's slice: a cut weight becomes a `Shard`, which records whether
it is row- or column-parallel and over which group, and a replicated one
stays as it was.  The forward (models/llm.py) reads that record and
nothing else: the wrapper keeps the layout next to the tensor it
describes, so a weight cannot be read under another weight's layout and
an unsharded tree needs no config of its own.  `params["tp"]` carries the
model axis (`ModelAxis`) for what no single weight decides: which KV heads
this rank holds.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..ops.collective import ModelAxis, Shard
from ..ops.qmat import QTensor
from .mesh import axis_size

R = None        # a replicated dim

# PartitionSpecs of each per-layer block tensor ([out, in])
_BLOCK_SPECS = {
    "attn_norm": (R,),
    "wqkv": (R, "model"),
    "bqkv": (R,),
    "w_gateup": (R, "model"),
    "wq": ("model", R),
    "wk": ("model", R),
    "wv": ("model", R),
    "wo": (R, "model"),
    "bq": ("model",),
    "bk": ("model",),
    "bv": ("model",),
    "q_norm": (R,),
    "k_norm": (R,),
    "ffn_norm": (R,),
    "w_gate": ("model", R),
    "w_up": ("model", R),
    "w_down": (R, "model"),
}

_TOP_SPECS = {
    "token_embd": (R, R),
    "output_norm": (R,),
    "output": ("model", R),
}

# hybrid (LFM2) layers: short conv in_proj column-parallel, out_proj
# row-parallel, the depthwise conv weight replicated
_HYBRID_SPECS = {
    "attn_norm": (R,), "ffn_norm": (R,),
    "q_norm": (R,), "k_norm": (R,),
    "wq": ("model", R), "wk": ("model", R), "wv": ("model", R),
    "wo": (R, "model"),
    "wqkv": (R, "model"), "bqkv": (R,),
    "w_gate": ("model", R), "w_up": ("model", R),
    "w_down": (R, "model"), "w_gateup": (R, "model"),
    "in_proj": ("model", R), "in_proj_b": ("model",),
    "out_proj": (R, "model"), "out_proj_b": (R,),
    "conv_w": (R, R), "conv_b": (R,),
}

# KV cache [L, B, H_kv, S, D]: batch over 'data', heads over 'model'
_CACHE_SPECS = {
    "k": (R, "data", "model", R, R),
    "v": (R, "data", "model", R, R),
    "k_scale": (R, "data", "model", R),
    "v_scale": (R, "data", "model", R),
    "conv": (R, "data", R, R),
    "fill": ("data",),
}


def _sizes(mesh) -> dict:
    return {ax: axis_size(mesh, ax) for ax in mesh.mesh_dim_names}


def _fits(shape, spec, sizes: dict) -> bool:
    return all(ax is None or d % sizes[ax] == 0
               for d, ax in zip(shape, spec))


def _cut(t: torch.Tensor, spec, sizes: dict, coords: dict) -> torch.Tensor:
    """The block of `t` at `coords` under `spec` (an even split per dim),
    as its own contiguous tensor."""
    for dim, ax in enumerate(spec):
        if ax is not None and sizes[ax] > 1:
            n = t.shape[dim] // sizes[ax]
            t = t.narrow(dim, coords[ax] * n, n)
    return t.contiguous()


def _apply_spec(tree, spec, mesh):
    """This rank's slice of one weight under `spec`: a Shard when a dim is
    cut, else the weight itself (replicated, an axis of one rank, or a spec
    that does not fit: an odd vocab, a quant group that a shard would
    split)."""
    sizes = _sizes(mesh)
    coords = {ax: mesh.get_local_rank(ax) for ax in sizes}
    spec = tuple(spec)
    if all(ax is None or sizes[ax] == 1 for ax in spec):
        return tree
    if isinstance(tree, QTensor):
        # the storage is transposed ([.., K, N] for logical [N, K])
        axes = list(spec) + [None] * max(0, tree.values.dim() - len(spec))
        if len(axes) >= 2:
            axes[-1], axes[-2] = axes[-2], axes[-1]
        qspec = tuple(axes)
        ok = (_fits(tree.values.shape, qspec, sizes)
              and _fits(tree.scales.shape, qspec, sizes)
              and (tree.mins is None
                   or _fits(tree.mins.shape, qspec, sizes)))
        if not ok:
            return tree
        kind = "col" if qspec[-1] is not None else "row"
        local = replace(
            tree, values=_cut(tree.values, qspec, sizes, coords),
            scales=_cut(tree.scales, qspec, sizes, coords),
            mins=None if tree.mins is None
            else _cut(tree.mins, qspec, sizes, coords),
            n_out=-1 if kind == "col" else tree.n_out)
        return Shard(local, kind, _model_axis(mesh), tree.shape[0])
    if not _fits(tree.shape, spec, sizes):
        return tree
    kind = "col" if spec[0] is not None else "row"
    return Shard(_cut(tree, spec, sizes, coords), kind, _model_axis(mesh),
                 tree.shape[0])


def _model_axis(mesh) -> ModelAxis:
    return ModelAxis(mesh.get_group("model"), mesh.get_local_rank("model"),
                     axis_size(mesh, "model"))


def shard_llm_params(params: dict, mesh, cfg=None) -> dict:
    """This rank's slice of the LLM params under the TP layout, with
    params["tp"] the model axis (`ModelAxis`).  An expert (lfm2moe) model
    is refused: its expert stacks have no sharded layout."""
    if any("moe" in layer for layer in params.get("layers", ())):
        raise ValueError("tensor-parallel sharding of an expert (lfm2moe) "
                         "model is not supported: its expert layers have "
                         "no sharded layout")
    out = {}
    for k, v in params.items():
        if k == "tp":
            continue
        if k == "blocks":
            out[k] = [{bk: _apply_spec(bv, _BLOCK_SPECS[bk], mesh)
                       for bk, bv in blk.items()} for blk in v]
        elif k == "layers":
            out[k] = [{lk: _apply_spec(lv, _HYBRID_SPECS.get(lk, ()), mesh)
                       for lk, lv in layer.items()} for layer in v]
        else:
            out[k] = _apply_spec(v, _TOP_SPECS.get(k, ()), mesh)
    out["tp"] = _model_axis(mesh)
    return out


def _cache_spec(key: str, shape, mesh) -> tuple:
    """The KV cache field's spec with every axis that does not divide
    dropped (e.g. fewer KV heads than the model axis replicates them)."""
    sizes = _sizes(mesh)
    return tuple(ax if ax is None or d % sizes[ax] == 0 else None
                 for d, ax in zip(shape, _CACHE_SPECS[key]))


def kv_cache_sharding(mesh) -> dict:
    """The KV cache's specs: batch over 'data', heads over 'model'."""
    return dict(_CACHE_SPECS)


def shard_kv_cache(cache: dict, mesh) -> dict:
    """This rank's block of every cache field (a contiguous copy)."""
    sizes = _sizes(mesh)
    coords = {ax: mesh.get_local_rank(ax) for ax in sizes}
    return {k: _cut(v, _cache_spec(k, v.shape, mesh), sizes, coords)
            for k, v in cache.items()}


def data_rows(mesh, batch: int) -> slice:
    """The rows of a [batch, ...] array this rank holds under the cache's
    'data' split (all of them when batch does not divide the axis)."""
    n = axis_size(mesh, "data")
    if batch % n:
        return slice(0, batch)
    b = batch // n
    r = mesh.get_local_rank("data")
    return slice(r * b, (r + 1) * b)


def replicate(tree, mesh=None):
    """Replicated placement: every rank holds the whole tree already (one
    process per rank), so this is the tree itself."""
    return tree
