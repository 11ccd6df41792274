"""The port's tensor- and data-parallel layer (miotts_tpu_torch.parallel)
against the JAX package's, on the CPU: gloo ranks spawned per mesh
(tests/torch_parallel_workers.py, no JAX in them) against JAX on a mesh of
the same shape over its virtual CPU devices (tests/conftest.py).

  * every rank's weight and cache shards are, bit for bit, JAX's
    `addressable_shards` for the same device: Q8_0, packed Q4_K with Q6_K
    (llama.cpp's Q4_K_M mix), dense f32 with the odd vocab (its head
    replicated), one KV head (its cache heads replicated), LFM2;
  * the TP / DP forward, prefill-then-decode and greedy tokens on meshes
    (1, 2), (2, 1) and (2, 2) against JAX's single-device and same-mesh
    results (f32 logits at JAX's 2e-4; greedy tokens identical);
  * the same at bf16 on the Q4_K_M mix (K1v and K3 routes) and a Q8_0
    LFM2 (K1v): logits within 2e-2 of their scale of JAX's single-device
    bf16 run on the same route (its Pallas kernels in interpret mode), greedy tokens equal up to a near tie (where they first part,
    JAX's top two logits lie within 2e-2 of the scale), and every
    quantized product of the sharded model on the route it was given at
    bf16 x, as unsharded;
  * a data-parallel-only mesh runs the unsharded forward: no collective;
  * `qdot(out_f32=True)`, a row-parallel partial's product, on every
    route: the route's own arithmetic, its f32 sum left unrounded.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from miotts_tpu.gguf import GGUFReader, GGML_Q4_K, GGML_Q8_0
from miotts_tpu.models.llm import (LLMConfig, init_kv_cache, llm_decode_step,
                                   llm_forward, llm_prefill, load_llm_params)
from miotts_tpu.models.synthetic import write_synthetic_llm
from miotts_tpu.ops.qmat import QTensor
from miotts_tpu.parallel.mesh import make_mesh
from miotts_tpu.parallel.sharding import shard_kv_cache, shard_llm_params
from miotts_tpu_torch.ops.qmat import QTensor as TQ
from miotts_tpu_torch.parallel.launch import launch
from torch_port_util import (few_torch_threads, jax_tree_to_numpy,  # noqa: F401
                             rel_err)

import torch_parallel_workers as W

MESHES = [(1, 2), (2, 1), (2, 2)]
B, S, GREEDY = 2, 6, 4

_DENSE = dict(arch="qwen2", n_layers=2, dim=64, n_heads=4, n_kv_heads=4,
              head_dim=16, ff_dim=128, n_vocab=256 + 3 + 64, n_ctx=256,
              rope_style="neox", qkv_bias=True, qk_norm=False)
MODELS = {
    # f32 weights, the odd vocab 323: the head replicates
    "dense": (dict(_DENSE), {}, {}),
    "q8_0": (dict(_DENSE), dict(quant_type=GGML_Q8_0), {}),
    # Q4_K packed (MIOTTS_PACK4) with Q6_K attn_v / ffn_down (Q4_K_M)
    "q4k_q6k": (dict(_DENSE, dim=256, head_dim=64, ff_dim=512),
                dict(quant_type=GGML_Q4_K, mixed_k=True),
                {"MIOTTS_PACK4": "1"}),
    # one KV head: the cache's heads do not divide 'model' and replicate
    "kv1": (dict(_DENSE, n_kv_heads=1), dict(quant_type=GGML_Q8_0), {}),
    "lfm2": (dict(_DENSE, arch="lfm2", n_layers=4, ff_dim=96,
                  n_vocab=256 + 3 + 16, n_ctx=64, qkv_bias=False,
                  qk_norm=True, layer_types=("conv", "attn", "conv", "attn"),
                  conv_l_cache=3), {}, {}),
}

# bf16 runs: (model, the port's QdotRoute fields, the JAX package's env of
# the same route, the kernel every M = 1 product takes, the batch: K3 is an
# M = 1 kernel, so its run is one stream on every rank).  JAX runs the route
# on its Pallas kernels in interpret mode (`jax_bf16`), so every K and
# padded N of a model divides 128 (the JAX package's Pallas gate).
BF16_TOL = 2e-2
BF16_MODELS = {
    "lfm2_q8": (dict(MODELS["lfm2"][0], dim=128, head_dim=32, ff_dim=256),
                dict(quant_type=GGML_Q8_0), {}),
}
BF16_RUNS = {
    "q4k_q6k/bf16dot": ("q4k_q6k", dict(bf16="1"),
                        {"MIOTTS_QDOT_BF16": "1"}, "K1v", B),
    "q4k_q6k/groupdot": ("q4k_q6k", dict(gemv="groupdot"),
                         {"MIOTTS_QDOT_GROUPDOT": "1"}, "K3", 1),
    "lfm2_q8/bf16dot": ("lfm2_q8", dict(bf16="1"),
                        {"MIOTTS_QDOT_BF16": "1"}, "K1v", B),
}
JAX_ROUTE_ENV = ("MIOTTS_QDOT_GEMV", "MIOTTS_QDOT_GROUPDOT",
                 "MIOTTS_PACK4_SPLIT", "MIOTTS_GEMV_M8", "MIOTTS_QDOT_BF16")
JAX_PALLAS_ENTRIES = ("_qdot_pallas", "_qdot_pallas_split",
                      "_qdot_group_pallas", "_qdot_w8a8_pallas")


def _jax_mesh(shape):
    d, m = shape
    return make_mesh(data=d, model=m, devices=jax.devices()[:d * m])


def _write_models(d, table: dict, dtype, paths: dict | None = None) -> dict:
    """{name: (path, JAX params in `dtype`, cfg)}: each model written (or
    read from `paths`) and loaded by the JAX package under its env."""
    out = {}
    mp = pytest.MonkeyPatch()
    for i, (name, (cfg_kw, write_kw, env)) in enumerate(table.items()):
        path = (paths or {}).get(name) or str(d / f"{name}.gguf")
        if not (paths or {}).get(name):
            write_synthetic_llm(path, cfg=LLMConfig(**cfg_kw), seed=i + 1,
                                **write_kw)
        for k, v in env.items():
            mp.setenv(k, v)
        with GGUFReader(path) as r:
            cfg = LLMConfig.from_gguf(r)
            params, _ = load_llm_params(r, cfg, dtype=dtype)
        mp.undo()
        out[name] = (path, params, cfg)
    return out


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return _write_models(tmp_path_factory.mktemp("tpm"), MODELS, jnp.float32)


@pytest.fixture(scope="module")
def bf16_models(tmp_path_factory, models):
    """The bf16 runs' models, loaded by the JAX package in bf16."""
    need = {run[0] for run in BF16_RUNS.values()}
    table = {n: (MODELS | BF16_MODELS)[n] for n in sorted(need)}
    return _write_models(tmp_path_factory.mktemp("tpm_bf16"), table,
                         jnp.bfloat16,
                         {n: models[n][0] for n in need if n in models})


@pytest.fixture(scope="module")
def inputs(models):
    rng = np.random.default_rng(19)
    out = {}
    for name, (path, _, cfg) in models.items():
        out[name] = dict(path=path,
                         toks=rng.integers(0, cfg.n_vocab, (B, S)),
                         n_real=np.array([S - 1, S], np.int32),
                         nxt=rng.integers(0, cfg.n_vocab, B),
                         greedy=GREEDY)
    return out


def _packed_qtensor():
    """The JAX package's test_qtensor_shard_preserves_packed QTensor."""
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 16, (256, 128), dtype=np.int8)
    scales = rng.standard_normal((256 // 32, 128)).astype(np.float32)
    return QTensor(values=jnp.asarray(vals), scales=jnp.asarray(scales),
                   mins=None, group=32, n_out=128).pack4()


def _packed_tree():
    qt = _packed_qtensor()
    # wo: row-parallel (K cut), wq: column-parallel, token_embd replicated
    return {"blocks": [{"wo": qt, "wq": qt}], "token_embd": qt}


def _caches(models):
    """{name: numpy cache}: random k / v (int8 with scales for one), fills,
    a hybrid model's conv state; batch 4 and, for one, batch 1 (the data
    axis dropped)."""
    rng = np.random.default_rng(3)
    out = {}
    for name, batch, quant in (("dense", 4, False), ("kv1", 4, True),
                               ("lfm2", 4, False), ("dense", 1, False)):
        cfg = models[name][2]
        c = {k: np.asarray(v) for k, v in init_kv_cache(
            cfg, batch, 8, dtype=jnp.float32, quantized=quant).items()}
        for k, v in c.items():
            if k == "fill":
                c[k] = rng.integers(0, 8, v.shape).astype(v.dtype)
            elif v.dtype == np.int8:
                c[k] = rng.integers(-127, 128, v.shape).astype(np.int8)
            else:
                c[k] = rng.standard_normal(v.shape).astype(v.dtype)
        out[f"{name}_b{batch}{'_int8' if quant else ''}"] = c
    return out


@pytest.fixture(scope="module")
def bf16_inputs(bf16_models):
    rng = np.random.default_rng(20)
    out = {}
    for run, (name, route, _, _, b) in BF16_RUNS.items():
        path, _, cfg = bf16_models[name]
        out[run] = dict(path=path, toks=rng.integers(0, cfg.n_vocab, (b, S)),
                        n_real=np.array([S - 1, S][-b:], np.int32),
                        nxt=rng.integers(0, cfg.n_vocab, b), greedy=GREEDY,
                        dtype="bfloat16", route=route)
    return out


@pytest.fixture(scope="module")
def ranks(models, inputs, bf16_inputs):
    trees = {name: jax_tree_to_numpy(p) for name, (_, p, _) in models.items()}
    trees["packed"] = jax_tree_to_numpy(_packed_tree())
    caches = _caches(models)
    runs = dict(inputs, **bf16_inputs)
    return {shape: launch(W.model_rank, shape[0] * shape[1],
                          (shape[0], shape[1], trees, caches, runs),
                          timeout=240)
            for shape in MESHES}


def _jax_local(tree, device, prefix=""):
    """{path: device's shard} of a JAX tree (tests/torch_parallel_workers.
    local_leaves' paths)."""
    out = {}
    if isinstance(tree, QTensor):
        for f in ("values", "scales", "mins"):
            a = getattr(tree, f)
            if a is not None:
                out[f"{prefix}.{f}"] = _shard(a, device)
        return out
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_jax_local(v, device, f"{prefix}.{k}" if prefix else k))
        return out
    if isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_jax_local(v, device, f"{prefix}[{i}]"))
        return out
    return {prefix: _shard(tree, device)}


def _shard(a, device):
    return np.asarray(next(s.data for s in a.addressable_shards
                           if s.device == device), np.float32)


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, (k, got[k].shape, want[k].shape)
        np.testing.assert_array_equal(got[k].astype(np.float32), want[k],
                                      err_msg=k)


@pytest.mark.parametrize("name", list(MODELS) + ["packed"])
@pytest.mark.parametrize("shape", MESHES)
def test_weight_shards_equal_jax(models, ranks, shape, name):
    """Each rank's slices of the converted JAX tree are the JAX package's
    addressable shards of device `rank`, bit for bit."""
    mesh = _jax_mesh(shape)
    if name == "packed":
        params, cfg = _packed_tree(), None
    else:
        _, params, cfg = models[name]
    with jax.set_mesh(mesh):
        sp = shard_llm_params(params, mesh, cfg)
    for rank, res in enumerate(ranks[shape]):
        _assert_same(res["shards"][name], _jax_local(sp, mesh.devices.flat[rank]))


@pytest.mark.parametrize("shape", MESHES)
def test_cache_shards_equal_jax(models, ranks, shape):
    mesh = _jax_mesh(shape)
    for name, cache in _caches(models).items():
        with jax.set_mesh(mesh):
            sc = shard_kv_cache({k: jnp.asarray(v) for k, v in cache.items()},
                                mesh)
        for rank, res in enumerate(ranks[shape]):
            want = {k: _shard(v, mesh.devices.flat[rank])
                    for k, v in sc.items()}
            _assert_same(res["caches"][name], want)


def test_shard_kinds(ranks):
    """The layout the forward reads: fused QKV / gate-up, wo and w_down
    row-parallel; LFM2's in_proj column-parallel, out_proj row-parallel;
    the odd-vocab dense head and the norms replicated; the JAX package's
    128-lane padded Q8_0 head column-parallel."""
    k = ranks[(1, 2)][0]["kinds"]
    for w in ("wqkv", "wo", "w_gateup", "w_down"):
        assert k["q8_0"][f"blocks[0].{w}"] == "row", w
    assert k["q8_0"]["output"] == "col"
    assert k["dense"]["output"] == "rep"
    assert k["dense"]["blocks[0].attn_norm"] == "rep"
    assert k["lfm2"]["layers[0].in_proj"] == "col"
    assert k["lfm2"]["layers[0].out_proj"] == "row"
    assert k["lfm2"]["layers[0].conv_w"] == "rep"
    assert k["packed"] == {"blocks[0].wo": "row", "blocks[0].wq": "col",
                           "token_embd": "rep"}


@pytest.mark.parametrize("shape", MESHES)
def test_packed_shards_dequantize_to_their_slice(ranks, shape):
    """A K-cut of packed nibbles holds whole groups of the per-group split:
    each rank's shard dequantizes to its slice of the whole weight (the
    port's counterpart of test_qtensor_shard_preserves_packed)."""
    full_np = jax_tree_to_numpy(_packed_qtensor())
    full = TQ(values=torch.from_numpy(np.array(full_np["values"])),
              scales=torch.from_numpy(np.array(full_np["scales"])), mins=None,
              group=32, n_out=128, packed=True).dequant_t()
    d, m = shape
    for rank, res in enumerate(ranks[shape]):
        r = rank % m
        for key, sl in (("blocks[0].wo", np.s_[r * 256 // m:(r + 1) * 256 // m]),
                        ("blocks[0].wq", np.s_[:, r * 128 // m:(r + 1) * 128 // m])):
            sh = res["shards"]["packed"]
            local = TQ(values=torch.from_numpy(sh[key + ".values"].astype(np.uint8)),
                       scales=torch.from_numpy(sh[key + ".scales"]), mins=None,
                       group=32, packed=True).dequant_t()
            np.testing.assert_array_equal(local.numpy(), full.numpy()[sl])


def _jax_run(params, cfg, inp, dtype) -> dict:
    """JAX single-device: forward logits, the prefill's last logits, one
    decode step's, GREEDY greedy tokens and the logits each was drawn
    from (f32 numpy)."""
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    toks = jnp.asarray(inp["toks"], jnp.int32)
    b = toks.shape[0]
    pos = jnp.broadcast_to(jnp.arange(S), (b, S))
    logits, _ = llm_forward(params, toks, pos,
                            init_kv_cache(cfg, b, 16, dtype=dtype), cfg)
    nr = jnp.asarray(inp["n_real"])
    last, c = llm_prefill(params, toks, nr,
                          init_kv_cache(cfg, b, 16, dtype=dtype), cfg)
    step, _ = llm_decode_step(params, jnp.asarray(inp["nxt"], jnp.int32),
                              c, cfg)
    tl, c = llm_prefill(params, toks, nr,
                        init_kv_cache(cfg, b, 32, dtype=dtype), cfg)
    greedy, drawn_from = [], []
    for _ in range(GREEDY):
        tok = jnp.argmax(tl, axis=-1).astype(jnp.int32)
        greedy.append(np.asarray(tok))
        drawn_from.append(f32(tl))
        tl, c = llm_decode_step(params, tok, c, cfg)
    return dict(logits=f32(logits), last=f32(last), step=f32(step),
                greedy=np.stack(greedy, 1), drawn_from=np.stack(drawn_from, 1))


@pytest.fixture(scope="module")
def jax_single(models, inputs):
    return {name: _jax_run(params, cfg, inputs[name], jnp.float32)
            for name, (_, params, cfg) in models.items()}


@pytest.fixture(scope="module")
def jax_bf16(bf16_models, bf16_inputs):
    """JAX single-device bf16 on each run's route: `_use_pallas` forced on
    and every Pallas entry of its qdot in interpret mode (a test-only patch,
    as tests/test_torch_q4km_routes.py does; nothing in the JAX package
    changes), the route read from its env when traced, the jit caches
    emptied around each run."""
    from miotts_tpu.ops import qmat as jq
    out = {}
    for run, (name, _, env, _, _) in BF16_RUNS.items():
        _, params, cfg = bf16_models[name]
        mp = pytest.MonkeyPatch()
        for k in JAX_ROUTE_ENV:
            mp.delenv(k, raising=False)
        for k, v in env.items():
            mp.setenv(k, v)
        mp.setattr(jq, "_use_pallas", lambda: True)
        for entry in JAX_PALLAS_ENTRIES:
            mp.setattr(jq, entry, partial(getattr(jq, entry), interpret=True))
        jax.clear_caches()
        try:
            out[run] = _jax_run(params, cfg, bf16_inputs[run], jnp.bfloat16)
        finally:
            mp.undo()
            jax.clear_caches()
    return out


def _rows(res, name):
    lo, hi = res["runs"][name]["rows"]
    return slice(lo, hi)


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("shape", MESHES)
def test_tp_forward_matches_jax(models, inputs, ranks, jax_single, shape,
                                name):
    """f32 logits of the sharded forward on each rank's rows against JAX's
    single-device and same-mesh forward (2e-4, JAX's own tolerance)."""
    _, params, cfg = models[name]
    mesh = _jax_mesh(shape)
    toks = jnp.asarray(inputs[name]["toks"], jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    with jax.set_mesh(mesh):
        sp = shard_llm_params(params, mesh, cfg)
        sc = shard_kv_cache(init_kv_cache(cfg, B, 16, dtype=jnp.float32), mesh)
        same_mesh, _ = llm_forward(sp, toks, pos, sc, cfg)
    same_mesh = np.asarray(same_mesh)
    for res in ranks[shape]:
        got = res["runs"][name]["logits"]
        rows = _rows(res, name)
        np.testing.assert_allclose(got, jax_single[name]["logits"][rows],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, same_mesh[rows], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("shape", MESHES)
def test_tp_prefill_then_decode(ranks, jax_single, shape, name):
    for res in ranks[shape]:
        rows = _rows(res, name)
        for key in ("last", "step"):
            np.testing.assert_allclose(res["runs"][name][key],
                                       jax_single[name][key][rows],
                                       rtol=2e-4, atol=2e-4, err_msg=key)


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("shape", MESHES)
def test_tp_greedy_tokens_equal_jax(ranks, jax_single, shape, name):
    for res in ranks[shape]:
        np.testing.assert_array_equal(res["runs"][name]["greedy"],
                                      jax_single[name]["greedy"][_rows(res, name)])


@pytest.mark.parametrize("shape", MESHES)
def test_model_axis_ranks_agree(ranks, shape):
    """The ranks of one 'model' group return the same bits (every
    collective's result is replicated)."""
    d, m = shape
    res = ranks[shape]
    for r in range(len(res)):
        base = res[(r // m) * m]
        for name in MODELS:
            for key in ("logits", "last", "step"):
                np.testing.assert_array_equal(res[r]["runs"][name][key],
                                              base["runs"][name][key])


def _near_tie_tokens(got, want, drawn_from, tol: float):
    """Greedy tokens [b, n] equal to `want`'s, or, where a row's first
    part, `want`'s top two logits (drawn_from [b, n, V]) within `tol` of
    their scale."""
    for b in range(want.shape[0]):
        diff = np.flatnonzero(got[b] != want[b])
        if diff.size:
            lg = drawn_from[b, diff[0]]
            top = np.sort(lg)[-2:]
            gap = (top[1] - top[0]) / np.abs(lg).max()
            assert gap <= tol, (b, int(diff[0]), float(gap))


@pytest.mark.parametrize("run", list(BF16_RUNS))
@pytest.mark.parametrize("shape", MESHES)
def test_tp_bf16_matches_jax(ranks, jax_bf16, shape, run):
    """bf16 activations and cache on the Q4_K_M mix (K1v / K3) and a Q8_0
    LFM2 (K1v): each rank's forward, prefill and decode logits within 2e-2
    of their scale of JAX's single-device bf16 run on the same route,
    greedy tokens equal up to a near tie, and every quantized product at bf16 x on the route it
    was given (K1v for all of them; K3 at M = 1), row-parallel shards
    included."""
    kernel = BF16_RUNS[run][3]
    want = jax_bf16[run]
    for res in ranks[shape]:
        got, rows = res["runs"][run], _rows(res, run)
        for key in ("logits", "last", "step"):
            assert rel_err(got[key], want[key][rows]) < BF16_TOL, key
        _near_tie_tokens(got["greedy"], want["greedy"][rows],
                         want["drawn_from"][rows], BF16_TOL)
        k = got["kernels"]
        assert k["dtypes"] == ["torch.bfloat16"], k
        assert k[kernel] > 0, k
        if kernel == "K1v":
            assert k["K1"] == 0, k


@pytest.mark.parametrize("shape", MESHES)
def test_data_parallel_mesh_runs_no_collective(ranks, shape):
    """On a mesh whose model axis has one rank the weights stay unsharded
    and the forward makes no collective; with two model ranks every run
    reduces its row-parallel partials."""
    for res in ranks[shape]:
        for name, run in res["runs"].items():
            if shape[1] == 1:
                assert run["collectives"] == 0, name
            else:
                assert run["collectives"] > 0, name


@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("route", [
    dict(), dict(bf16="1"), dict(bf16="after"), dict(gemv="groupdot"),
    dict(gemv="w8a8"), dict(split=True)], ids=lambda r: str(r) or "k1")
def test_qdot_out_f32_is_the_unrounded_sum(route, m):
    """`qdot(out_f32=True)`, what a row-parallel shard's partial takes: the
    route's own arithmetic for bf16 x, its f32 sum unrounded, so that
    rounding it gives the bf16 output bit for bit (packed Q4 with mins, the
    route's plain version on the CPU)."""
    from miotts_tpu_torch.ops import qmat
    g = torch.Generator().manual_seed(m)
    K, N, grp = 128, 48, 32
    qt = qmat.QTensor(
        values=torch.randint(0, 16, (K, N), generator=g).to(torch.int8),
        scales=torch.rand((K // grp, N), generator=g) / 50,
        mins=torch.rand((K // grp, N), generator=g) / 50, group=grp,
        n_out=N).pack4()
    w = qmat.with_route(qt, qmat.QdotRoute(**route))
    x = torch.randn((m, K), generator=g).bfloat16()
    y, y32 = qmat.qdot(x, w), qmat.qdot(x, w, out_f32=True)
    assert y.dtype == torch.bfloat16 and y32.dtype == torch.float32
    assert torch.equal(y32.to(torch.bfloat16), y)
    assert not torch.equal(y32, y.float())      # the sum left unrounded
