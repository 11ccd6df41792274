"""Rank functions of the multi-rank CPU tests (tests/test_torch_parallel*.py,
test_torch_collective.py, test_torch_codec_sp.py): each runs in a spawned
process of `miotts_tpu_torch.parallel.launch.launch`, imports no JAX, and
returns numpy results for the test process to hold against the JAX
package's."""

from __future__ import annotations

import numpy as np
import torch

from miotts_tpu_torch.ops.qmat import QTensor
from miotts_tpu_torch.parallel.mesh import axis_size, make_mesh
from miotts_tpu_torch.parallel.sharding import (Shard, data_rows,
                                                shard_kv_cache,
                                                shard_llm_params)


def _np(t):
    return t.detach().cpu().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


def local_leaves(tree, prefix: str = "") -> dict:
    """{path: this rank's arrays} of a sharded params tree: a QTensor (cut
    or not) as its values / scales / mins, a tensor as itself."""
    out = {}
    if isinstance(tree, Shard):
        return local_leaves(tree.local, prefix)
    if isinstance(tree, QTensor):
        out[prefix + ".values"] = _np(tree.values)
        out[prefix + ".scales"] = _np(tree.scales)
        if tree.mins is not None:
            out[prefix + ".mins"] = _np(tree.mins)
        return out
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k != "tp":
                out.update(local_leaves(v, f"{prefix}.{k}" if prefix else k))
        return out
    if isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(local_leaves(v, f"{prefix}[{i}]"))
        return out
    return {prefix: _np(tree)}


def kinds(tree, prefix: str = "") -> dict:
    """{path: "row" | "col" | "rep"} of a sharded params tree."""
    out = {}
    if isinstance(tree, Shard):
        return {prefix: tree.kind}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k != "tp":
                out.update(kinds(v, f"{prefix}.{k}" if prefix else k))
        return out
    if isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(kinds(v, f"{prefix}[{i}]"))
        return out
    return {prefix: "rep"}


# ---------------------------------------------------------------------------
# test_torch_parallel.py: shards, forward, prefill-then-decode
# ---------------------------------------------------------------------------

def _load(path: str, dtype=torch.float32):
    from miotts_tpu_torch.gguf import GGUFReader
    from miotts_tpu_torch.models.llm import LLMConfig, load_llm_params
    with GGUFReader(path) as r:
        cfg = LLMConfig.from_gguf(r)
        params, _ = load_llm_params(r, cfg, dtype=dtype)
    return params, cfg


def routed_kernels():
    """Count, by kernel, the quantized products `qmat._qdot_routed` sends
    on (K1, K1v, K3, ...), with the dtypes of x that reach them: a
    process-wide patch of the module's plain versions, for a rank process."""
    from miotts_tpu_torch.ops import qmat
    seen: dict = {"dtypes": set()}
    for name, fn in (("K1", "qdot_plain"), ("K1v", "qdot_bf16"),
                     ("K3", "qdot_group"), ("K2", "qdot_split"),
                     ("K4", "qdot_w8a8")):
        seen[name] = 0

        def counted(*a, _f=getattr(qmat, fn), _n=name, **kw):
            seen[_n] += 1
            seen["dtypes"].add(str(a[0].dtype))
            return _f(*a, **kw)
        setattr(qmat, fn, counted)
    return seen


def _padded(tree):
    """A numpy JAX tree whose quantized weights keep their 128-lane padded
    storage through `llm_params_from_numpy` (their n_out the padded
    width): the storage the JAX package's GSPMD layout cuts."""
    if isinstance(tree, dict):
        if "values" in tree and "group" in tree:
            return dict(tree, n_out=np.asarray(tree["values"]).shape[1])
        return {k: _padded(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_padded(v) for v in tree]
    return tree


def model_rank(rank: int, world: int, data: int, model: int, trees: dict,
               caches: dict, runs: dict) -> dict:
    """On mesh (data, model):
      trees  {name: numpy tree of the JAX package's params} -> this rank's
             shards of the converted tree (its QTensors in the JAX
             package's padded storage, `_padded`) and each weight's kind;
      caches {name: numpy JAX cache} -> this rank's cache shards;
      runs   {name: dict(path, toks, n_real, nxt, greedy[, dtype,
             route])} -> on this rank's data rows, in `dtype` (default f32)
             with every QTensor on QdotRoute(**route): forward logits, the
             prefill's last logits, one decode step's logits, `greedy`
             greedy tokens, the kernels the quantized products took
             (`routed_kernels`) and the collectives the run made."""
    from miotts_tpu_torch.convert import kv_cache_from_numpy, llm_params_from_numpy
    from miotts_tpu_torch.models.llm import (init_kv_cache, llm_decode_step,
                                             llm_forward, llm_prefill)
    from miotts_tpu_torch.ops import collective
    from miotts_tpu_torch.ops.qmat import QdotRoute, with_route
    seen = routed_kernels()
    mesh = make_mesh(data, model)
    out: dict = {"shards": {}, "kinds": {}, "caches": {}, "runs": {}}
    for name, tree in trees.items():
        sp = shard_llm_params(llm_params_from_numpy(_padded(tree)), mesh)
        out["shards"][name] = local_leaves(sp)
        out["kinds"][name] = kinds(sp)
    for name, cache in caches.items():
        out["caches"][name] = {k: _np(v) for k, v in shard_kv_cache(
            kv_cache_from_numpy(cache), mesh).items()}
    for name, run in runs.items():
        dtype = getattr(torch, run.get("dtype", "float32"))
        params, cfg = _load(run["path"], dtype)
        sp = shard_llm_params(with_route(params,
                                         QdotRoute(**run.get("route", {}))),
                              mesh, cfg)
        seen.update({k: 0 if k != "dtypes" else set() for k in seen})
        collective.transport.update(host_staged=0, native=0, seconds=0.0)
        toks = torch.from_numpy(run["toks"])
        B, S = toks.shape
        rows = data_rows(mesh, B)
        t = toks[rows]
        b = t.shape[0]

        def cache(n):
            return shard_kv_cache(init_kv_cache(cfg, B, n, dtype=dtype), mesh)
        pos = torch.arange(S).expand(b, S)
        logits, _ = llm_forward(sp, t, pos, cache(16), cfg)
        nr = torch.from_numpy(run["n_real"])[rows]
        c = cache(16)
        last, c = llm_prefill(sp, t, nr, c, cfg)
        step, _ = llm_decode_step(sp, torch.from_numpy(run["nxt"])[rows], c,
                                  cfg)
        c = cache(32)
        tok_last, c = llm_prefill(sp, t, nr, c, cfg)
        greedy = []
        for _ in range(run["greedy"]):
            tok = torch.argmax(tok_last, dim=-1)
            greedy.append(tok.numpy())
            tok_last, c = llm_decode_step(sp, tok, c, cfg)
        out["runs"][name] = dict(rows=(rows.start, rows.stop),
                                 logits=_np(logits), last=_np(last),
                                 step=_np(step), greedy=np.stack(greedy, 1),
                                 kernels=dict(seen, dtypes=sorted(
                                     seen["dtypes"])),
                                 collectives=collective.transport["native"])
    return out


# ---------------------------------------------------------------------------
# test_torch_parallel_serving.py: the serving chunk and the batcher
# ---------------------------------------------------------------------------

def serving_rank(rank: int, world: int, data: int, model: int, path: str,
                 chunk_in: dict, files: dict) -> dict:
    """The sharded serving chunk (llm_prefill_slots + two chunks of
    llm_generate_chunk_batched, gathered over 'data') and the sharded
    ContinuousBatcher's audio, unfused and fused."""
    from miotts_tpu_torch.models.llm import (init_kv_cache,
                                             llm_generate_chunk_batched,
                                             llm_prefill_slots)
    from miotts_tpu_torch.ops.collective import all_gather
    mesh = make_mesh(data, model)
    dgroup = mesh.get_group("data")
    params, cfg = _load(path)
    sp = shard_llm_params(params, mesh, cfg)
    n_slots = chunk_in["n_slots"]
    rows = data_rows(mesh, n_slots)
    lo, n = rows.start, rows.stop - rows.start
    cache = shard_kv_cache(init_kv_cache(cfg, n_slots, chunk_in["ctx_len"],
                                         dtype=torch.float32), mesh)
    slots = chunk_in["slots"]
    mine = [i for i, s in enumerate(slots) if lo <= s < lo + n]
    last_logits = torch.zeros((n, cfg.n_vocab))
    active = torch.zeros((n,), dtype=torch.bool)
    if mine:
        loc = torch.tensor([slots[i] - lo for i in mine])
        last, cache = llm_prefill_slots(
            sp, torch.from_numpy(chunk_in["toks"])[mine],
            torch.from_numpy(chunk_in["n_real"])[mine], cache, loc, cfg)
        last_logits[loc] = last
        active[loc] = True
    zeros = torch.zeros((n,), dtype=torch.int64)
    drawn = zeros.clone()
    stop_ids = torch.from_numpy(chunk_in["stop_ids"])
    bufs = []
    for attn_len in (32, 0):
        buf, active, last_logits, cache, drawn = llm_generate_chunk_batched(
            sp, last_logits, cache, active, zeros, drawn,
            torch.zeros((n,)), stop_ids, cfg, chunk_in["chunk"], attn_len)
        bufs.append(all_gather(buf, 0, dgroup).numpy())
    out = dict(chunk=dict(buf=np.stack(bufs),
                          active=all_gather(active, 0, dgroup).numpy(),
                          fill=all_gather(cache["fill"], 0, dgroup).numpy()))
    out["audio"] = {fused: batcher_audio(files, mesh, fused)
                    for fused in (False, True)}
    return out


def batcher_audio(files: dict, mesh=None, fused: bool = False) -> list:
    """The greedy three-request run of the JAX package's sharded batcher
    test on the port: each request's concatenated PCM."""
    from miotts_tpu_torch.runtime.batching import ContinuousBatcher
    from miotts_tpu_torch.runtime.engine import (EngineConfig, Options,
                                                 TTSEngine, VoiceModel)
    eng = TTSEngine(EngineConfig(
        model_path=files["llm"], codec_path=files["codec"], max_tokens=40,
        llm_dtype="float32", prompt_bucket=32, code_bucket=16,
        holdback_codes=6, min_commit_step_codes=4, device="cpu"))
    if mesh is not None:
        eng.llm_params = shard_llm_params(eng.llm_params, mesh, eng.llm_cfg)
    voice = VoiceModel(files["voice"])
    batcher = ContinuousBatcher(eng, n_slots=2, chunk_steps=10, mesh=mesh,
                                fused=fused)
    chunks: dict = {0: [], 1: [], 2: []}

    def cb_factory(i):
        def cb(samples, sr, is_last):
            if samples is not None:
                chunks[i].append(np.asarray(samples).copy())
            return True
        return cb
    for i, text in enumerate(["parity a", "parity b", "parity c"]):
        batcher.submit(text, voice, cb_factory(i),
                       Options(max_tokens=35, temperature=0.0, seed=1))
    batcher.run_until_done(max_iters=200)
    assert batcher.pending == 0
    return [np.concatenate(chunks[i]) if chunks[i]
            else np.zeros(0, np.float32) for i in range(3)]


# ---------------------------------------------------------------------------
# test_torch_collective.py
# ---------------------------------------------------------------------------

def collective_rank(rank: int, world: int, x: np.ndarray,
                    w: np.ndarray) -> dict:
    """make_mesh's shapes and its refusal; psum / all_gather / ppermute
    over 'model'; the ring dots over 'model' on meshes (1, world) and
    (2, world / 2), each rank holding its K range of x and w."""
    from miotts_tpu_torch.ops.collective import (all_gather, ppermute, psum,
                                                 ring_allreduce_dot,
                                                 ring_reduce_scatter_dot)
    out: dict = {"shapes": {}}
    for kw in ({}, {"data": 2}, {"model": 2}, {"data": 1, "model": world}):
        m = make_mesh(**kw)
        out["shapes"][str(sorted(kw.items()))] = tuple(m.shape)
    try:
        make_mesh(data=3, model=1)
        out["error"] = None
    except ValueError as e:
        out["error"] = str(e)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    for shape in ((1, world), (2, world // 2)):
        mesh = make_mesh(*shape)
        g, P, r = (mesh.get_group("model"), axis_size(mesh, "model"),
                   mesh.get_local_rank("model"))
        kl = x.shape[1] // P
        xl, wl = xt[:, r * kl:(r + 1) * kl], wt[r * kl:(r + 1) * kl]
        v = torch.tensor([float(r + 1), 10.0 * (r + 1)])
        out[shape] = dict(
            psum=psum(v, g).numpy(), gather=all_gather(v, 0, g).numpy(),
            right=ppermute(v, 1, g).numpy(), left=ppermute(v, -1, g).numpy(),
            allreduce=ring_allreduce_dot(xl, wl, g).numpy(),
            scatter=ring_reduce_scatter_dot(xl, wl, g).numpy(),
            bulk=psum(xl @ wl, g).numpy(), rank=r, size=P)
    return out


# ---------------------------------------------------------------------------
# test_torch_codec_sp.py
# ---------------------------------------------------------------------------

def codec_sp_rank(rank: int, world: int, path: str, cases: list) -> list:
    """codec_decode_audio_sp for each case (mesh shape, codes, emb,
    n_real), and the asserts on a T that does not divide the axis and on a
    chunk smaller than the halo."""
    from miotts_tpu_torch.gguf import GGUFReader
    from miotts_tpu_torch.models.codec import load_codec_params
    from miotts_tpu_torch.models.codec_sp import codec_decode_audio_sp
    with GGUFReader(path) as r:
        params, cfg = load_codec_params(r)
    out = []
    for shape, codes, emb, n_real in cases:
        mesh = make_mesh(*shape)
        out.append(codec_decode_audio_sp(params, torch.from_numpy(codes),
                                         torch.from_numpy(emb), cfg, mesh,
                                         n_real=n_real).numpy())
    mesh = make_mesh(1, world)
    refused = []
    halo = max(cfg.prenet_window, cfg.decoder_window) // 2
    for T in (world * halo + 1, world * (halo - 1)):
        try:
            codec_decode_audio_sp(params, torch.zeros(T, dtype=torch.int64),
                                  torch.zeros(cfg.adaln_dim), cfg, mesh)
            refused.append(False)
        except AssertionError:
            refused.append(True)
    return [out, refused]


# ---------------------------------------------------------------------------
# test_torch_parallel_cuda.py: two ranks on cuda:0
# ---------------------------------------------------------------------------

def cuda_tp_rank(rank: int, world: int, path: str, toks: np.ndarray) -> dict:
    """A prefill and greedy decode steps of the model at `path` (f32, on
    this rank's GPU) with its weights sharded over mesh (1, world), and a
    ring dot on the card."""
    from miotts_tpu_torch.ops.collective import ring_allreduce_dot
    mesh = make_mesh(1, world)
    params, cfg = _load(path)
    params = shard_llm_params({k: _to_cuda(v) for k, v in params.items()},
                              mesh, cfg)
    return dict(prefill_decode(params, cfg, toks),
                ring=ring_on_card(mesh, ring_allreduce_dot))


def _to_cuda(tree):
    if isinstance(tree, QTensor):
        return tree.to("cuda")
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cuda(v) for v in tree]
    return tree.cuda()


def prefill_decode(params, cfg, toks: np.ndarray, steps: int = 8) -> dict:
    """Greedy tokens and the f32 logits of a prefill and `steps` decode
    steps on the card."""
    from miotts_tpu_torch.models.llm import (init_kv_cache, kv_heads,
                                             llm_decode_step, llm_prefill)
    t = torch.from_numpy(toks).cuda()
    cache = init_kv_cache(cfg, t.shape[0], 64, dtype=torch.float32,
                          device="cuda", n_kv_heads=kv_heads(params, cfg))
    last, cache = llm_prefill(params, t, torch.full((t.shape[0],),
                                                    t.shape[1]), cache, cfg)
    logits, out = [last], []
    for _ in range(steps):
        tok = torch.argmax(last, dim=-1)
        out.append(tok.cpu().numpy())
        last, cache = llm_decode_step(params, tok, cache, cfg)
        logits.append(last)
    return dict(tokens=np.stack(out, 1),
                logits=torch.stack(logits).cpu().numpy())


def ring_on_card(mesh, ring) -> float:
    """The ring all-reduce dot on the card against one dense product: the
    largest difference over the output scale."""
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    x = torch.randn((8, 512), generator=g, device="cuda")
    w = torch.randn((512, 256), generator=g, device="cuda")
    P, r = axis_size(mesh, "model"), mesh.get_local_rank("model")
    kl = 512 // P
    got = ring(x[:, r * kl:(r + 1) * kl], w[r * kl:(r + 1) * kl],
               mesh.get_group("model"))
    want = x @ w
    return float((got - want).abs().max() / want.abs().max())
