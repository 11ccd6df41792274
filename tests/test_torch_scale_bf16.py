"""MIOTTS_SCALE_BF16 in miotts_tpu_torch, held against miotts_tpu on the
CPU: group scales and mins stored in bf16 at load, bit for bit the JAX
package's (the repack, the fusion, convert), every plain version against its
JAX Pallas entry in interpret mode on the same bf16-scale tensor, and tiny
dense and LFM2 models loaded under the switch against JAX's.  The
environment is set through monkeypatch only, so every test restores it."""

import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from miotts_tpu.gguf import GGUFReader as jGGUFReader
from miotts_tpu.gguf.quants import quantize as jquantize
from miotts_tpu.models import llm as jl
from miotts_tpu.ops import qmat as jq
from miotts_tpu.runtime import engine as je
from miotts_tpu_torch.convert import llm_params_from_numpy
from miotts_tpu_torch.gguf import GGUFReader
from miotts_tpu_torch.gguf.reader import (GGML_Q4_0, GGML_Q4_K, GGML_Q5_K,
                                          GGML_Q6_K, GGML_Q8_0)
from miotts_tpu_torch.models import llm as tl
from miotts_tpu_torch.models.synthetic import (synthetic_llm_config,
                                               write_synthetic_codec,
                                               write_synthetic_llm)
from miotts_tpu_torch.ops import qmat as tq
from miotts_tpu_torch.runtime import engine as te
from torch_port_util import (few_torch_threads, jax_tree_to_numpy,  # noqa: F401
                             rel_err)

N, K = 200, 512          # N not a multiple of 128: exercises the JAX lane pad
N_SPEECH = 64
F32_TOL = 1e-5           # kernels, f32 output: the order of the f32 sums
BF16_TOL = 1e-2          # kernels, bf16 output: one rounding on either side
PROBE_TOL = 1e-6         # K8: f32 sums of the tiles in another order
LOGIT_TOL = 1e-4         # models, f32 logits of their scale
BF16 = torch.bfloat16
FORMATS = [(GGML_Q8_0, None), (GGML_Q6_K, None), (GGML_Q5_K, None),
           (GGML_Q4_K, True), (GGML_Q4_K, False), (GGML_Q4_0, True),
           (GGML_Q4_0, False)]
MODES = {"1": True, "after": "after"}


@pytest.fixture
def env(monkeypatch):
    """MIOTTS_SCALE_BF16 and the route switches unset on entry; `env(name=
    value, ...)` sets some."""
    for name in ("MIOTTS_SCALE_BF16", "MIOTTS_NO_PACK4", "MIOTTS_QDOT_GEMV",
                 "MIOTTS_QDOT_GROUPDOT", "MIOTTS_PACK4_SPLIT", "MIOTTS_GEMV_M8",
                 "MIOTTS_QDOT_BF16", "MIOTTS_FORCE_XLA_QDOT"):
        monkeypatch.delenv(name, raising=False)

    def set_env(**kw):
        for name, val in kw.items():
            monkeypatch.setenv(name, val)
    return set_env


def _raw(fmt: int, rows: int, cols: int, seed: int) -> np.ndarray:
    w = np.random.default_rng(seed).standard_normal((rows, cols)).astype(
        np.float32)
    return np.frombuffer(jquantize(w, fmt), dtype=np.uint8)


def _port_of(jqt) -> tq.QTensor:
    """A JAX QTensor carried through the port's convert (N padding cut)."""
    tree = {"blocks": [{"w": jax_tree_to_numpy(jqt)}]}
    return llm_params_from_numpy(tree)["blocks"][0]["w"]


def _pair(fmt, pack4, n=N, k=K, seed=0):
    """(JAX, port) bf16-scale QTensors of the same GGUF bytes."""
    raw = _raw(fmt, n, k, seed)
    return (jq.qtensor_from_raw(raw, fmt, n, k, scale_dtype=jnp.bfloat16,
                                pack4=pack4),
            tq.qtensor_from_raw(raw, fmt, n, k, pack4=pack4,
                                scale_dtype=BF16))


def _same(got: tq.QTensor, want: tq.QTensor) -> None:
    """Bit for bit: values, scales and mins with their dtypes, and the
    layout fields."""
    assert (got.group, got.packed, got.n_out, got.shape) == (
        want.group, want.packed, want.n_out, want.shape)
    assert got.values.dtype == want.values.dtype
    assert torch.equal(got.values, want.values)
    assert got.scales.dtype == want.scales.dtype
    assert torch.equal(got.scales, want.scales)
    assert (got.mins is None) == (want.mins is None)
    if got.mins is not None:
        assert got.mins.dtype == got.scales.dtype
        assert torch.equal(got.mins, want.mins)


def _x(m, k, seed, zero_group=32):
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)
    x[:, zero_group: zero_group + 32] = 0.0
    return x


def _bf16_x(x):
    """x rounded to bf16 by JAX, and the same bits as a torch tensor."""
    xb = jnp.asarray(x, jnp.bfloat16)
    return xb, torch.from_numpy(np.asarray(xb, np.float32)).to(BF16)


# ---------------------------------------------------------------------------
# Storage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,pack4", FORMATS)
def test_qtensor_from_raw_matches_jax_bit_for_bit(fmt, pack4):
    """The same GGUF bytes give the same values and bf16 scales and mins
    (Q4_0 packed: the x8 min fold of bf16 scales), and a bf16-scale tensor
    dequantizes to its f32-scale twin's values rounded once a scale."""
    jt, pt = _pair(fmt, pack4)
    assert pt.scales.dtype == BF16
    _same(pt, _port_of(jt))
    f32 = tq.qtensor_from_raw(_raw(fmt, N, K, 0), fmt, N, K, pack4=pack4)
    _same(pt, f32.with_scale_dtype(BF16))
    assert torch.equal(pt.dequant_t(), pt.with_scale_dtype(
        torch.float32).dequant_t())


def test_with_scale_dtype_round_trip():
    """f32 -> bf16 rounds to nearest even (as numpy's ml_dtypes), bf16 ->
    f32 -> bf16 is exact, the values are shared."""
    _, pt = _pair(GGML_Q4_K, True)
    up = pt.with_scale_dtype(torch.float32)
    assert up.values is pt.values and up.scales.dtype == torch.float32
    _same(up.with_scale_dtype(BF16), pt)
    s = np.asarray(jnp.asarray(up.scales.numpy() * 1.001, jnp.bfloat16),
                   np.float32)
    assert np.array_equal(torch.from_numpy(up.scales.numpy() * 1.001).to(
        BF16).float().numpy(), s)


def test_concat_qtensors_q4_k_q6_k_mix_matches_jax():
    """A Q4_K_M QKV (packed Q4_K q / k, Q6_K v): unpacked, the Q4_K scale
    rows repeated to g16 and Q6_K's zero mins, all in bf16, bit for bit
    JAX's fusion."""
    parts = [_pair(GGML_Q4_K, True, n=128, seed=1),
             _pair(GGML_Q4_K, True, n=64, seed=2),
             _pair(GGML_Q6_K, None, n=64, seed=3)]
    jt = jq.concat_qtensors([p[0] for p in parts])
    pt = tq.concat_qtensors([p[1] for p in parts])
    assert pt.group == 16 and not pt.packed and pt.mins.dtype == BF16
    _same(pt, _port_of(jt))
    assert not pt.mins[:, 192:].any()


def test_convert_keeps_the_scale_dtype():
    """llm_params_from_numpy keeps each QTensor's scale dtype: numpy's
    ml_dtypes bf16 scales and mins arrive as torch bf16 with the same bits
    (no upcast), f32 ones as f32; the lane padding is cut either way."""
    jb, _ = _pair(GGML_Q4_K, True)
    jf = jq.qtensor_from_raw(_raw(GGML_Q4_K, N, K, 0), GGML_Q4_K, N, K)
    tree = llm_params_from_numpy({"blocks": [
        {"wb": jax_tree_to_numpy(jb), "wf": jax_tree_to_numpy(jf)}]})
    wb, wf = tree["blocks"][0]["wb"], tree["blocks"][0]["wf"]
    assert wb.scales.dtype == wb.mins.dtype == BF16
    assert wf.scales.dtype == wf.mins.dtype == torch.float32
    assert wb.scales.shape == (K // 32, N) and wb.n_out == N
    assert np.array_equal(wb.scales.view(torch.int16).numpy(),
                          np.asarray(jb.scales)[:, :N].view(np.int16))
    _same(wb, wf.with_scale_dtype(BF16))


# ---------------------------------------------------------------------------
# The plain versions against the JAX Pallas entries (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,pack4", FORMATS)
def test_k1_plain_matches_pallas_at_bf16_scales(fmt, pack4):
    jt, pt = _pair(fmt, pack4)
    n = pt.shape[0]
    for m in (1, 7, 16):
        x = _x(m, K, seed=m)
        got = tq.qdot_plain(torch.from_numpy(x), pt).numpy()
        want = np.asarray(jq._qdot_pallas(jnp.asarray(x), jt,
                                          interpret=True))[:, :n]
        assert rel_err(got, want) < F32_TOL, (m, rel_err(got, want))
    xb, tb = _bf16_x(_x(3, K, seed=9))
    got = tq.qdot_plain(tb, pt)
    assert got.dtype == BF16
    want = np.asarray(jq._qdot_pallas(xb, jt, interpret=True),
                      np.float32)[:, :n]
    assert rel_err(got.float().numpy(), want) < BF16_TOL


@pytest.mark.parametrize("fmt,pack4", FORMATS)
@pytest.mark.parametrize("mode", list(MODES))
def test_k1v_plain_matches_pallas_at_bf16_scales(fmt, pack4, mode):
    """Both modes: with bf16 scales mode 1's bf16(s) is s itself."""
    jt, pt = _pair(fmt, pack4)
    n = pt.shape[0]
    for m in (1, 8):
        x = _x(m, K, seed=m)
        got = tq.qdot_bf16_plain(torch.from_numpy(x), pt, mode).numpy()
        want = np.asarray(jq._qdot_pallas(jnp.asarray(x), jt, interpret=True,
                                          bf16_dot=MODES[mode]))[:, :n]
        assert rel_err(got, want) < F32_TOL, (m, rel_err(got, want))
        xb, tb = _bf16_x(x)
        got = tq.qdot_bf16_plain(tb, pt, mode)
        want = np.asarray(jq._qdot_pallas(xb, jt, interpret=True,
                                          bf16_dot=MODES[mode]),
                          np.float32)[:, :n]
        assert rel_err(got.float().numpy(), want) < BF16_TOL
    assert torch.equal(tq.qdot_bf16_plain(torch.from_numpy(_x(2, K, 4)), pt,
                                          "1"),
                       tq.qdot_bf16_plain(torch.from_numpy(_x(2, K, 4)), pt,
                                          "after"))


@pytest.mark.parametrize("fmt", [GGML_Q4_K, GGML_Q4_0])
def test_k2_plain_matches_pallas_at_bf16_scales(fmt):
    jt, pt = _pair(fmt, True, n=256)
    for m in (1, 7, 64):
        x = _x(m, K, seed=m)
        got = tq.qdot_split_plain(torch.from_numpy(x), pt).numpy()
        want = np.asarray(jq._qdot_pallas_split(jnp.asarray(x), jt,
                                                interpret=True))
        assert rel_err(got, want) < F32_TOL, (m, rel_err(got, want))
    xb, tb = _bf16_x(_x(3, K, seed=9))
    got = tq.qdot_split_plain(tb, pt)
    want = np.asarray(jq._qdot_pallas_split(xb, jt, interpret=True),
                      np.float32)
    assert rel_err(got.float().numpy(), want) < BF16_TOL


@pytest.mark.parametrize("fmt,pack4", FORMATS)
def test_k3_plain_matches_pallas_at_bf16_scales(fmt, pack4):
    """bf16 x (K3's only input) within 1e-2 of JAX's interpret-mode kernel
    (its output rounds to bf16)."""
    jt, pt = _pair(fmt, pack4)
    n = pt.shape[0]
    xb, tb = _bf16_x(_x(1, K, seed=5))
    got = tq.qdot_group_plain(tb, pt)
    want = np.asarray(jq._qdot_group_pallas(xb, jt, interpret=True),
                      np.float32)[:, :n]
    assert got.dtype == BF16
    assert rel_err(got.float().numpy(), want) < BF16_TOL


@pytest.mark.parametrize("fmt,pack4", FORMATS)
def test_k4_plain_matches_pallas_at_bf16_scales(fmt, pack4):
    """K4a (int8 values) / K4b (packed): f32 x within 1e-5 of JAX's
    interpret-mode kernel (the same int8 quantization of x, the scale s *
    sx of an upcast s), bf16 x within 1e-2."""
    jt, pt = _pair(fmt, pack4)
    n = pt.shape[0]
    x = _x(1, K, seed=6)
    got = tq.qdot_w8a8_plain(torch.from_numpy(x), pt).numpy()
    want = np.asarray(jq._qdot_w8a8_pallas(jnp.asarray(x), jt,
                                           interpret=True))[:, :n]
    assert rel_err(got, want) < F32_TOL
    xb, tb = _bf16_x(x)
    got = tq.qdot_w8a8_plain(tb, pt)
    want = np.asarray(jq._qdot_w8a8_pallas(xb, jt, interpret=True),
                      np.float32)[:, :n]
    assert rel_err(got.float().numpy(), want) < BF16_TOL


@pytest.fixture(scope="module")
def bench_qmat():
    path = Path(__file__).resolve().parents[1] / "benchmarks" / "bench_qmat.py"
    spec = importlib.util.spec_from_file_location("bench_qmat_bf16", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("K_,N_", [(4096, 1024), (2560, 768), (768, 256)])
def test_k8_plain_matches_jax_probe_at_bf16_scales(bench_qmat, K_, N_):
    """bench_qmat.py's own tensor at scale_dtype=bf16 (its make_qt), through
    convert: K8's plain version within 1e-6 of the JAX probe."""
    jt = bench_qmat.make_qt(K_, N_, scale_dtype=jnp.bfloat16, seed=K_ + N_)
    pt = _port_of(jt)
    assert pt.scales.dtype == BF16
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(bench_qmat.dma_floor(None, jt))
    got = tq.qdot_dma_floor_plain(pt)
    assert got.dtype == torch.float32 and got.shape == (1, N_)
    assert rel_err(got.numpy(), want) < PROBE_TOL
    assert tq._k8_checked(pt) == tq._k8_tile_k(K_, N_)


def test_kernel_checks_refuse_mixed_scale_dtypes():
    """The kernels' input check takes bf16 scales with bf16 mins and f32
    with f32, and refuses a mix or another dtype: nothing is converted."""
    _, pt = _pair(GGML_Q4_K, True)
    x = torch.zeros((1, K))
    for mixed in (dataclasses.replace(pt, mins=pt.mins.float()),
                  dataclasses.replace(pt.with_scale_dtype(torch.float32),
                                      mins=pt.mins)):
        with pytest.raises(ValueError, match="scales/mins"):
            tq._checked("qdot", x, mixed)
    with pytest.raises(TypeError, match="f32 or bf16"):
        tq._checked("qdot", x, dataclasses.replace(
            pt, scales=pt.scales.half(), mins=pt.mins.half()))
    with pytest.raises(ValueError, match="GPU"):   # past the dtype checks
        tq._checked("qdot", x, pt)


# ---------------------------------------------------------------------------
# Models loaded under the switch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tiny Q4_K_M dense model (fused QKV of Q4_K and Q6_K, w_down Q6_K,
    wo / gate-up / output Q4_K), a tiny Q8_0 LFM2 (tests/test_lfm2.py's
    config) and a tiny codec, written by the port's writer."""
    d = tmp_path_factory.mktemp("scale_bf16")
    cfg = dataclasses.replace(synthetic_llm_config(n_speech=N_SPEECH),
                              dim=256, n_heads=4, n_kv_heads=2, head_dim=64,
                              ff_dim=256)
    lfm2 = jl.LLMConfig(arch="lfm2", n_layers=4, dim=64, n_heads=4,
                        n_kv_heads=2, head_dim=16, ff_dim=96,
                        n_vocab=256 + 3 + N_SPEECH, n_ctx=128,
                        rope_style="neox", qkv_bias=False, qk_norm=True,
                        layer_types=("conv", "attn", "conv", "attn"),
                        conv_l_cache=3)
    paths = {k: str(d / f"{k}.gguf") for k in ("dense", "lfm2", "codec")}
    write_synthetic_llm(paths["dense"], cfg=cfg, quant_type=GGML_Q4_K, seed=9,
                        mixed_k=True)
    write_synthetic_llm(paths["lfm2"], cfg=lfm2, quant_type=GGML_Q8_0,
                        seed=9)
    write_synthetic_codec(paths["codec"], n_codes=N_SPEECH, seed=3)
    return paths


def _qtensors(tree):
    if isinstance(tree, tq.QTensor):
        return [tree]
    if isinstance(tree, dict):
        return [q for v in tree.values() for q in _qtensors(v)]
    if isinstance(tree, list):
        return [q for v in tree for q in _qtensors(v)]
    return []


def _recast(tree, dtype):
    """Every QTensor of a params tree with its scales and mins in `dtype`
    (chip_smoke.py's bf16_scales walk)."""
    if isinstance(tree, tq.QTensor):
        return tree.with_scale_dtype(dtype)
    if isinstance(tree, dict):
        return {k: _recast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_recast(v, dtype) for v in tree]
    return tree


def _same_tree(got, want) -> None:
    if isinstance(want, tq.QTensor):
        _same(got, want)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same_tree(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same_tree(a, b)
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("model", ["dense", "lfm2"])
def test_load_under_the_switch_matches_jax(files, env, model):
    """Both packages read the file under MIOTTS_SCALE_BF16: every QTensor
    holds bf16 scales and mins, bit for bit after convert; without the
    switch they are f32."""
    with GGUFReader(files[model]) as r:
        f32, _ = tl.load_llm_params(r, dtype=torch.float32, device="cpu")
    assert {q.scales.dtype for q in _qtensors(f32)} == {torch.float32}
    env(MIOTTS_SCALE_BF16="1")
    with jGGUFReader(files[model]) as r:
        jp, _ = jl.load_llm_params(r, jl.LLMConfig.from_gguf(r),
                                   dtype=jnp.float32)
    with GGUFReader(files[model]) as r:
        tp, _ = tl.load_llm_params(r, dtype=torch.float32, device="cpu")
    qts = _qtensors(tp)
    assert qts and {q.scales.dtype for q in qts} == {BF16}
    assert {q.mins.dtype for q in qts if q.mins is not None} <= {BF16}
    if model == "dense":
        assert any(q.mins is not None and not q.packed for q in qts)
    _same_tree(llm_params_from_numpy(jax_tree_to_numpy(jp)), tp)


@pytest.mark.parametrize("model", ["dense", "lfm2"])
def test_recast_equals_a_load_under_the_switch(files, env, model):
    """A tree loaded with f32 scales, recast to bf16 (what the chip smoke
    does on the card), is bit for bit a load under the switch: the fusion
    repeats and zero-fills scales exactly, and each f32 scale rounds once
    either way."""
    with GGUFReader(files[model]) as r:
        f32, _ = tl.load_llm_params(r, dtype=torch.float32, device="cpu")
    env(MIOTTS_SCALE_BF16="1")
    with GGUFReader(files[model]) as r:
        bf16, _ = tl.load_llm_params(r, dtype=torch.float32, device="cpu")
    _same_tree(_recast(f32, BF16), bf16)
    _same_tree(_recast(bf16, torch.float32),
               _recast(_recast(f32, BF16), torch.float32))


@pytest.mark.parametrize("model", ["dense", "lfm2"])
def test_model_under_the_switch_matches_jax(files, env, model):
    """f32 logits of a prefill and 6 teacher-forced decode steps within
    1e-4 of their scale, and 16 greedy f32 tokens of each package's engine
    equal, both loaded under the switch."""
    env(MIOTTS_SCALE_BF16="1")
    with jGGUFReader(files[model]) as r:
        jcfg = jl.LLMConfig.from_gguf(r)
        jp, _ = jl.load_llm_params(r, jcfg, dtype=jnp.float32)
    with GGUFReader(files[model]) as r:
        tp, tcfg = tl.load_llm_params(r, dtype=torch.float32, device="cpu")
    toks = np.zeros((1, 8), np.int32)
    toks[0, :6] = np.random.default_rng(1).integers(0, tcfg.n_vocab, 6)
    n_real = np.asarray([6], np.int32)
    jc = jl.init_kv_cache(jcfg, 1, 32, dtype=jnp.float32)
    jlast, jc = jl.llm_prefill(jp, jnp.asarray(toks), jnp.asarray(n_real), jc,
                               jcfg)
    tc = tl.init_kv_cache(tcfg, 1, 32, dtype=torch.float32)
    tlast, tc = tl.llm_prefill(tp, torch.from_numpy(toks),
                               torch.from_numpy(n_real), tc, tcfg)
    assert rel_err(tlast.numpy(), np.asarray(jlast)) < LOGIT_TOL
    for t in np.random.default_rng(2).integers(0, tcfg.n_vocab, (6, 1)):
        t = t.astype(np.int32)
        jlast, jc = jl.llm_decode_step(jp, jnp.asarray(t), jc, jcfg)
        tlast, tc = tl.llm_decode_step(tp, torch.from_numpy(t), tc, tcfg)
        assert rel_err(tlast.numpy(), np.asarray(jlast)) < LOGIT_TOL
    kw = dict(model_path=files[model], codec_path=files["codec"],
              max_tokens=16, llm_dtype="float32", prompt_bucket=32,
              code_bucket=16)
    jeng = je.TTSEngine(je.EngineConfig(**kw))
    teng = te.TTSEngine(te.EngineConfig(device="cpu", **kw))
    assert {q.scales.dtype for q in _qtensors(teng.llm_params)} == {BF16}
    assert "(scales bfloat16)" in teng.route_line()
    opts = dict(temperature=0.0, max_tokens=16)
    jids = jeng.generate_tokens("hello world", je.Options(**opts))
    tids = teng.generate_tokens("hello world", te.Options(**opts))
    assert tids == jids and len(tids) == 16
