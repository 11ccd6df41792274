"""The multi-device dry run (counterpart of `__graft_entry__.py`'s
`dryrun_multichip`): one spawned process per rank over a ('data',
'model') mesh, the serving stack at tiny shapes, each step checked.

    python -m miotts_tpu_torch.parallel.dryrun N [--device cpu|cuda]

On N ranks (mesh data 2 x model N / 2 for an even N, else 1 x N):
  1. a TP + DP prefill, a sample and a decode step, each data rank on its
     own rows, plus a data-parallel codec decode of each rank's rows;
  2. the sequence-parallel codec over 'model' (8 codes a rank);
  3. a sharded serving chunk (`llm_prefill_slots` +
     `llm_generate_chunk_batched`), token-exact against the same chunk of
     the unsharded weights in the same process;
  4. `ContinuousBatcher(mesh=)` serving 3 requests;
  5. the codec on its own device (`codec_device`; a CUDA stream of its own
     on one card, the CPU's one path on the CPU), sample-exact against the
     codec on the LLM's device.
Prints one `dryrun_multichip OK: ...` line.  The ranks talk over gloo on
the CPU and over NCCL where the host has a GPU for each (parallel/mesh.py);
the device defaults to CUDA.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch


def _write_models(d: str, n_kv_heads: int) -> dict:
    """Tiny qwen2-style LLMs (a Q8_0 one and an f32 one for serving), the
    synthetic codec and a voice.  The JAX dry run's heads are 16 wide; the
    port's attention kernels take heads of 64, 80 or 128, so these have 4
    heads of 64 (dim 256)."""
    from ..gguf import GGML_Q8_0, write_voice_embedding
    from ..models.llm import LLMConfig
    from ..models.synthetic import write_synthetic_codec, write_synthetic_llm
    paths = {k: os.path.join(d, f"{k}.gguf")
             for k in ("llm", "codec", "serve_llm", "voice")}
    cfg = LLMConfig(arch="qwen2", n_layers=2, dim=256, n_heads=4,
                    n_kv_heads=n_kv_heads, head_dim=64, ff_dim=512,
                    n_vocab=256 + 3 + 64, n_ctx=256, rope_style="neox",
                    qkv_bias=True, qk_norm=False)
    write_synthetic_llm(paths["llm"], cfg=cfg, quant_type=GGML_Q8_0, seed=0)
    codec_cfg = write_synthetic_codec(paths["codec"], n_codes=64, seed=1)
    write_synthetic_llm(paths["serve_llm"], cfg=cfg, seed=5)
    write_voice_embedding(paths["voice"], np.random.default_rng(1)
                          .standard_normal(codec_cfg.adaln_dim) * 0.3)
    return paths


def _rank(rank: int, world: int, paths: dict, data: int, model: int,
          device: str) -> dict:
    from ..gguf import GGUFReader
    from ..models.codec import codec_decode_audio, load_codec_params
    from ..models.codec_sp import codec_decode_audio_sp
    from ..models.llm import (LLMConfig, init_kv_cache, llm_decode_step,
                              llm_generate_chunk_batched, llm_prefill,
                              llm_prefill_slots, load_llm_params,
                              sample_token)
    from ..ops.collective import all_gather
    from ..runtime.batching import ContinuousBatcher
    from ..runtime.engine import EngineConfig, Options, TTSEngine, VoiceModel
    from .mesh import make_mesh
    from .sharding import data_rows, shard_kv_cache, shard_llm_params

    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    mesh = make_mesh(data=data, model=model)
    data_group = mesh.get_group("data")
    with GGUFReader(paths["llm"]) as r:
        cfg = LLMConfig.from_gguf(r)
        params, _ = load_llm_params(r, cfg, dtype=torch.float32, device=dev)
    with GGUFReader(paths["codec"]) as r:
        codec_params, codec_cfg = load_codec_params(r, device=dev)
    sp = shard_llm_params(params, mesh, cfg)

    # 1. TP + DP prefill -> sample -> decode, and the DP codec decode
    B, S_prompt, T_codes = data * 2, 16, 8
    rows = data_rows(mesh, B)
    b = rows.stop - rows.start
    cache = shard_kv_cache(init_kv_cache(cfg, B, 64, dtype=torch.float32,
                                         device=dev), mesh)
    last, cache = llm_prefill(sp, torch.zeros((b, S_prompt), dtype=torch.int64,
                                              device=dev),
                              torch.full((b,), S_prompt), cache, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tok = sample_token(last, 0.8, gen)
    logits, cache = llm_decode_step(sp, tok, cache, cfg)
    logits = all_gather(logits, 0, data_group)
    audio = codec_decode_audio(codec_params,
                               torch.zeros((b, T_codes), dtype=torch.int64,
                                           device=dev),
                               torch.zeros((b, codec_cfg.adaln_dim),
                                           device=dev), codec_cfg,
                               n_real=torch.full((b,), T_codes))
    audio = all_gather(audio, 0, data_group)
    assert logits.shape == (B, cfg.n_vocab), logits.shape
    assert audio.shape == (B, T_codes * codec_cfg.samples_per_token)

    # 2. the sequence-parallel codec over 'model'
    T_long = 8 * model
    sp_audio = codec_decode_audio_sp(
        codec_params, torch.zeros((T_long,), dtype=torch.int64, device=dev),
        torch.zeros((codec_cfg.adaln_dim,), device=dev), codec_cfg, mesh)
    assert sp_audio.shape == (T_long * codec_cfg.samples_per_token,)

    # 3. the serving chunk, sharded against unsharded (greedy)
    n_slots, ctx_len, chunk = B, 64, 8
    ptoks = torch.zeros((2, 8), dtype=torch.int64, device=dev)
    pn = torch.tensor([8, 5], dtype=torch.int32)
    stop_ids = torch.tensor([cfg.n_vocab - 1, cfg.n_vocab - 2], device=dev)

    def serve_chunk(p, sharded: bool):
        c = init_kv_cache(cfg, n_slots, ctx_len, dtype=torch.float32,
                          device=dev)
        lo, n = 0, n_slots
        if sharded:
            c = shard_kv_cache(c, mesh)
            lo, n = rows.start, rows.stop - rows.start
        mine = [i for i, s in enumerate((0, n_slots - 1)) if lo <= s < lo + n]
        ll = torch.zeros((n, cfg.n_vocab), device=dev)
        act = torch.zeros((n,), dtype=torch.bool, device=dev)
        if mine:
            slots = torch.tensor([(0, n_slots - 1)[i] - lo for i in mine],
                                 device=dev)
            last, c = llm_prefill_slots(p, ptoks[mine], pn[mine], c, slots,
                                        cfg)
            ll[slots] = last
            act[slots] = True
        zeros = torch.zeros((n,), dtype=torch.int64, device=dev)
        buf, *_ = llm_generate_chunk_batched(
            p, ll, c, act, zeros, zeros.clone(), torch.zeros((n,), device=dev),
            stop_ids, cfg, chunk, 32)
        return all_gather(buf, 0, data_group) if sharded else buf
    want_buf, got_buf = serve_chunk(params, False), serve_chunk(sp, True)
    assert torch.equal(want_buf, got_buf), "sharded serving chunk diverged"

    # 4. ContinuousBatcher(mesh=) end to end
    def engine(**kw):
        return TTSEngine(EngineConfig(
            model_path=paths["serve_llm"], codec_path=paths["codec"],
            max_tokens=30, llm_dtype="float32", prompt_bucket=32,
            code_bucket=16, device=str(dev), **kw))
    voice = VoiceModel(paths["voice"])
    eng = engine()
    eng.llm_params = shard_llm_params(eng.llm_params, mesh, eng.llm_cfg)
    batcher = ContinuousBatcher(eng, n_slots=max(2, data), chunk_steps=10,
                                mesh=mesh)
    finished = []
    for i in range(3):
        batcher.submit(f"mesh utterance {i}", voice, lambda *a: True,
                       Options(max_tokens=25, temperature=1.0, seed=i),
                       on_finish=finished.append)
    batcher.run_until_done(max_iters=200)
    assert batcher.pending == 0 and len(finished) == 3
    assert not any(r.failed for r in finished)

    # 5. the codec on a device (stream) of its own, sample-exact
    def serve_pipelined(codec_device: int) -> dict:
        e = engine(codec_device=codec_device)
        b2 = ContinuousBatcher(e, n_slots=2, chunk_steps=10)
        chunks: dict = {i: [] for i in range(3)}

        def mk(i):
            def cb(samples, sr, is_last):
                if samples is not None:
                    chunks[i].append(np.asarray(samples))
                return True
            return cb
        for i in range(3):
            b2.submit(f"pipelined utterance {i}", voice, mk(i),
                      Options(max_tokens=25, temperature=1.0, seed=10 + i))
        b2.run_until_done(max_iters=300)
        assert b2.pending == 0
        return {i: np.concatenate(c) if c else np.zeros(0)
                for i, c in chunks.items()}
    base = serve_pipelined(-1)
    own = serve_pipelined(1 if device == "cuda"
                          and torch.cuda.device_count() > 1 else 0)
    for i in range(3):
        assert np.array_equal(base[i], own[i]), \
            f"codec-device serving diverged on request {i}"
    return dict(logits=tuple(logits.shape), audio=tuple(audio.shape),
                sp_audio=tuple(sp_audio.shape), served=len(finished),
                samples=sum(r.emitted_samples for r in finished),
                pipelined=sum(len(v) for v in own.values()))


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout: float = 600.0) -> dict:
    """The dry run on `n_devices` spawned ranks (see the module
    docstring); prints and returns rank 0's summary.  Raises when a rank
    fails or the run passes `timeout` seconds."""
    from .launch import launch
    data = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    model = n_devices // data
    kv = model if model in (1, 2, 4) else 4     # divides the 4 query heads
    with tempfile.TemporaryDirectory(prefix="miotts_dryrun_") as d:
        paths = _write_models(d, n_kv_heads=max(kv, 2))
        out = launch(_rank, n_devices, (paths, data, model, device),
                     device=device, timeout=timeout)
    res = out[0]
    print(f"dryrun_multichip OK: mesh=({data}x{model}) on {device} tp+dp "
          f"logits={res['logits']} dp audio={res['audio']} sp audio="
          f"{res['sp_audio']} serving-chunk token-exact; batcher served "
          f"{res['served']} reqs ({res['samples']} samples); codec-device "
          f"serving sample-exact ({res['pipelined']} samples)", flush=True)
    return res


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Multi-device dry run of the "
                                             "port on N ranks.")
    ap.add_argument("n", type=int, nargs="?", default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
