"""GPU-only checks of the PyTorch port: the hand-written flash-attention
kernels (forward, the head_dim 16/32 forward, dq, dk/dv) against their
plain versions, the autograd
op against autograd through `mha_reference`, the engine's kernel path
against attention_impl='xla', a narrow model trained through the
kernels, the engine's decode call as a CUDA graph against its eager
body (dense and paged, greedy and sampled), the speculative verify as
a CUDA graph against its eager body (bf16 and int8 pages, a MoE model),
no build after prewarm() under the strict recompile sentinel, a
profiler window that holds the flash kernel launched by the engine's
loop thread, a weight swap under the graph, and tensor parallelism on
the card: the forward at the per-rank shapes, no mesh or server of
`--tensor 2` on one card, and a tensor=1 engine over a real NCCL group
whose decode graph (its collectives captured) equals eager.  Marked
`gpu`; each test asks the
`cuda` fixture, which skips when there is no CUDA device.  No JAX here,
so the file runs where only the port is installed:

    python -m pytest tests/test_torch_gpu.py -m gpu
"""
import collections
import dataclasses
import gzip
import json
import subprocess
import sys
import threading
import time

import pytest
import torch

from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from skypilot_tpu_torch.models.llama import LlamaConfig, Llama, init_params
from skypilot_tpu_torch.ops.cuda import flash_attention as fa
from skypilot_tpu_torch.perf import compile_telemetry
from skypilot_tpu_torch.perf import profiler as profiler_lib
from skypilot_tpu_torch.server import metrics as metrics_lib
from skypilot_tpu_torch.server import tracing

pytestmark = pytest.mark.gpu

# bf16 kernel vs f32 plain version on the same inputs: P and the output
# are rounded to bf16 in the kernel; one bf16 ulp is 2^-7 of a value.
OUT_ATOL, OUT_RTOL, LSE_ATOL = 1e-2, 1e-2, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', torch.cuda.current_device())


# Shapes at the edges of the kernels' tiles (128-row q/k tiles, 64-row
# q stages of the dk/dv kernel): S below, at and past multiples of 128,
# bench-1b's S=4096 with 16 over 8 heads, GQA group 4 at D=64,
# non-causal ragged, fp16 ragged, odd lengths.
EDGE_SHAPES = [
    (2, 4, 2, 5, 128, True, torch.bfloat16),
    (1, 4, 2, 17, 64, False, torch.float16),
    (1, 4, 2, 64, 128, True, torch.bfloat16),
    (1, 4, 2, 128, 128, True, torch.bfloat16),
    (1, 4, 2, 192, 128, True, torch.bfloat16),
    (1, 4, 2, 320, 128, True, torch.bfloat16),
    (1, 16, 8, 4096, 128, True, torch.bfloat16),
    (1, 32, 8, 256, 64, True, torch.bfloat16),
    (1, 4, 2, 192, 128, False, torch.bfloat16),
    (1, 4, 2, 96, 128, True, torch.float16),
]
# The RL loop's shapes (llama-250m: 16 query heads over 8 kv heads of 64,
# causal bf16, batch 8): the rollout's prefill bucket S=8, and REINFORCE
# steps over prompt + sampled tokens, S=36 and a shorter ragged S=33.
RL_SHAPES = [(8, 16, 8, s, 64, True, torch.bfloat16) for s in (8, 33, 36)]
# The MoE model's (llama3-1b with 8 experts: 32 query heads over 8 kv
# heads of 64, a GQA group of 4): its serving prefill (8 prompts in the
# 256 bucket) and its training step (batch 2 of 2048).
MOE_SHAPES = [(8, 32, 8, 256, 64, True, torch.bfloat16),
              (2, 32, 8, 2048, 64, True, torch.bfloat16)]
# Tensor-parallel serving at tensor=2, one rank's prefill: llama2-7b's
# 16 of 32 MHA heads, and llama3-8b's 16 query heads over 4 of its 8 kv
# heads (GQA group 4), head_dim 128, 8 prompts in the 256 bucket.
TP_SHAPES = [(8, 16, 16, 256, 128, True, torch.bfloat16),
             (8, 16, 4, 256, 128, True, torch.bfloat16)]


@pytest.mark.parametrize('b,hq,hkv,s,d,causal,dtype', [
    (2, 32, 32, 256, 128, True, torch.bfloat16),
    (1, 8, 8, 32, 128, True, torch.bfloat16),
    (2, 12, 4, 128, 128, True, torch.bfloat16),
    (2, 32, 8, 96, 64, True, torch.float16),
    (1, 4, 4, 512, 64, False, torch.bfloat16),
    *EDGE_SHAPES,
    *RL_SHAPES,
    *MOE_SHAPES,
    *TP_SHAPES,
    # A single row: forward only, since with one key the softmax is
    # constant and dq, dk are 0 up to rounding (no relative error).
    (2, 4, 2, 1, 128, True, torch.bfloat16),
])
def test_flash_kernel_matches_plain(cuda, b, hq, hkv, s, d, causal, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, hq, s, d), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, hkv, s, d), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, hkv, s, d), generator=gen, device=cuda).to(dtype)
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                      return_residuals=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    ref, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal=causal,
                                                    return_residuals=True)
    assert out.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref.float(), atol=OUT_ATOL,
                               rtol=OUT_RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize('s,causal', [(32, True), (192, True), (320, False)])
def test_flash_kernel_without_lse_matches_plain(cuda, s, causal):
    """The serving call: no lse requested (the kernel skips its write),
    the same output as with it."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((2, 8, s, 128), generator=gen, device=cuda).to(
        torch.bfloat16)
    k, v = (torch.randn((2, 8, s, 128), generator=gen,
                        device=cuda).to(torch.bfloat16) for _ in range(2))
    out = fa.flash_attention_fwd(q, k, v, causal=causal)
    with_lse, _ = fa.flash_attention_fwd(q, k, v, causal=causal,
                                         return_residuals=True)
    torch.cuda.synchronize()
    ref = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=OUT_ATOL,
                               rtol=OUT_RTOL)
    assert torch.equal(out, with_lse)


# The small-head-dim forward (head_dim 16 and 32, 64-row tiles) at the
# edges of its tiles: one row, below, at and past 64 and 128, GQA groups
# 2 and 4, causal and not, bf16 and fp16.  Tolerance: the JAX
# reference's max-abs 5e-3 (tests/test_ops.py) beyond one ulp of the
# output, which kernel and plain version both round to the input type.
SMALL_ATOL = 5e-3


@pytest.mark.parametrize('s', [1, 5, 17, 63, 64, 65, 127, 128, 129])
@pytest.mark.parametrize('d,hq,causal,dtype', [
    (16, 4, True, torch.bfloat16), (16, 8, False, torch.float16),
    (32, 4, True, torch.float16), (32, 8, False, torch.bfloat16)])
def test_small_head_dim_kernel_matches_plain(cuda, s, d, hq, causal, dtype):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((2, hq, s, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((2, 2, s, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_fwd_small.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                      return_residuals=True)
    no_lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_fwd_small.launches) == (before[0],
                                                       before[1] + 2)
    ref, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal=causal,
                                                    return_residuals=True)
    ref = ref.float()
    ulp = torch.finfo(dtype).eps * torch.exp2(torch.floor(torch.log2(
        ref.abs().clamp_min(torch.finfo(dtype).tiny))))
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert bool(((out.float() - ref).abs() <= SMALL_ATOL + ulp).all())
    torch.testing.assert_close(lse, ref_lse, atol=SMALL_ATOL, rtol=0)
    assert torch.equal(out, no_lse)


def test_flash_kernel_rejects_what_it_cannot_run(cuda):
    q = torch.zeros((1, 2, 64, 80), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match='head_dim'):
        fa.flash_attention_fwd(q, q, q)
    q = torch.zeros((1, 2, 64, 64), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match='bf16/fp16'):
        fa.flash_attention_fwd(q, q, q)
    q = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16,
                    device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match='contiguous'):
        fa.flash_attention_fwd(q, q, q)


# Backward kernels vs their plain versions (same bf16 rounding of P and
# dS, f32 sums in another order, outputs rounded to bf16): judged on the
# norm of the difference relative to the reference's norm; one bf16 ulp
# is 2^-8 relative, a wrong kernel is off by ~1.
BWD_NORM_RTOL = 1e-2


def _norm_rel(x, ref):
    return ((x.float() - ref.float()).norm() / ref.float().norm()).item()


# Edges of the dq kernel's tiles (128 q rows per CTA in two 64-row
# warpgroups, 64-row K/V stages): S one short of and one past 64 and
# 128, and one short of 256, causal and not; GQA group 8 at D=128; fp16
# at D=64.
DQ_EDGE_SHAPES = [
    *((1, 2, 2, s, 128, causal, torch.bfloat16)
      for s in (63, 65, 127, 129, 255) for causal in (True, False)),
    (1, 8, 1, 256, 128, True, torch.bfloat16),
    (2, 4, 2, 129, 64, True, torch.float16),
    (1, 4, 4, 255, 64, False, torch.float16),
]


@pytest.mark.parametrize('b,hq,hkv,s,d,causal,dtype', [
    (1, 4, 2, 256, 128, True, torch.bfloat16),
    (2, 4, 4, 128, 64, True, torch.bfloat16),
    (1, 4, 2, 192, 128, False, torch.bfloat16),
    (2, 4, 2, 96, 64, True, torch.float16),
    (1, 2, 2, 32, 128, True, torch.bfloat16),
    *EDGE_SHAPES,
    *DQ_EDGE_SHAPES,
    *RL_SHAPES,
    MOE_SHAPES[1],
])
def test_flash_bwd_kernels_match_plain(cuda, b, hq, hkv, s, d, causal,
                                       dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, g = (torch.randn((b, hq, s, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=gen,
                        device=cuda).to(dtype) for _ in range(2))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                      return_residuals=True)
    delta = (g.float() * out.float()).sum(-1)
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    dq = fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                     before[1] + 1)
    ref_dq = fa.flash_attention_bwd_dq_reference(q, k, v, g, lse, delta,
                                                 causal)
    ref_dk, ref_dv = fa.flash_attention_bwd_dkv_reference(
        q, k, v, g, lse, delta, causal)
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == dtype and got.shape == ref.shape
        assert torch.isfinite(got).all()
        assert _norm_rel(got, ref) <= BWD_NORM_RTOL


@pytest.mark.parametrize('causal', [True, False])
def test_flash_bwd_kernels_are_deterministic(cuda, causal):
    """Each dq (and dk/dv) element is summed by one thread in a fixed
    order, with no atomics: two calls on the same inputs agree bit for
    bit."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, g = (torch.randn((2, 8, 1024, 128), generator=gen,
                        device=cuda).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((2, 2, 1024, 128), generator=gen,
                        device=cuda).to(torch.bfloat16) for _ in range(2))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                      return_residuals=True)
    delta = (g.float() * out.float()).sum(-1)
    first, second = (
        (fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, causal),
         *fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal))
        for _ in range(2))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_attention_grads_match_mha_reference(cuda):
    """The autograd op (forward kernel, then both backward kernels) in
    bf16 against autograd through `mha_reference` on the same inputs."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((2, 8, 256, 128), generator=gen, device=cuda)
    k, v = (torch.randn((2, 4, 256, 128), generator=gen, device=cuda)
            for _ in range(2))
    g = torch.randn((2, 8, 256, 128), generator=gen, device=cuda)
    leaves = [t.to(torch.bfloat16).requires_grad_() for t in (q, k, v)]
    from skypilot_tpu_torch.ops import attention as attn
    got = torch.autograd.grad(attn.flash_attention(*leaves),
                              leaves, g.to(torch.bfloat16))
    want = torch.autograd.grad(attn.mha_reference(*leaves), leaves,
                               g.to(torch.bfloat16))
    for x, ref in zip(got, want):
        assert _norm_rel(x, ref) <= 2 * BWD_NORM_RTOL


def test_engine_on_gpu_goes_through_kernel(cuda):
    """A narrow llama2-shaped model (MHA, head_dim 128, bf16) served on
    the card: every prefill group launches the kernel once per layer, and
    prefill logits through the kernel match attention_impl='xla' on the
    same weights within bf16 noise (relative to the logits' scale)."""
    cfg = LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=2,
                      n_kv_heads=2, ffn_dim=688, rope_theta=10000.0,
                      max_seq_len=128, dtype=torch.bfloat16)
    params = init_params(cfg, cuda,
                         torch.Generator(device=cuda).manual_seed(0))
    model = Llama(cfg, params)
    engine = DecodeEngine(model, EngineConfig(
        n_slots=4, prefill_buckets=(16, 32), steps_per_call=4), device=cuda)
    before = fa.flash_attention_fwd.launches
    reqs = [engine.submit(p, 8)
            for p in ([1, 5, 9, 200, 7], list(range(40, 70)), [3] * 12)]
    for _ in range(100):
        engine.step()
        if all(r.finished_at is not None for r in reqs):
            break
    assert [len(r.tokens()) for r in reqs] == [8, 8, 8]
    assert (fa.flash_attention_fwd.launches - before ==
            cfg.n_layers * engine.prefill_groups)
    xla = Llama(dataclasses.replace(cfg, attention_impl='xla'), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    with torch.no_grad():
        got, _ = model(toks, decode=True)
        want, _ = xla(toks, decode=True)
    assert (got - want).abs().max() <= 5e-2 * want.abs().max()


def test_narrow_model_trains_through_kernels(cuda):
    """A narrow bench-1b-shaped model (GQA, head_dim 128, tied, remat
    'none') takes 3 train steps on the card: every layer launches the
    forward kernel twice (forward and remat recompute) and each backward
    kernel once per step, and the loss is finite and falls."""
    from skypilot_tpu_torch.train import trainer as tt
    cfg = LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4,
                      n_kv_heads=2, ffn_dim=1024, max_seq_len=256,
                      tie_embeddings=True, dtype=torch.bfloat16)
    model = Llama(cfg, init_params(
        cfg, cuda, torch.Generator(device=cuda).manual_seed(0)))
    trainer = tt.Trainer(model, tt.TrainConfig(learning_rate=1e-2,
                                               warmup_steps=1,
                                               total_steps=50))
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    losses = []
    for _ in range(3):
        trainer.state, metrics = trainer.train_step(trainer.state, tokens)
        losses.append(float(metrics['loss']))
    assert [c.launches - b for c, b in zip(counters, before)] == [
        3 * 2 * cfg.n_layers, 3 * cfg.n_layers, 3 * cfg.n_layers]
    assert all(torch.isfinite(torch.tensor(losses))) and losses[-1] < losses[0]


def _narrow_engine(cuda, eager=False, n_experts=0, **kw):
    """A narrow llama2-shaped model (MHA, head_dim 128, bf16; with
    `n_experts`, top-2 MoE blocks) and an engine over it: on the card its
    decode call is a CUDA graph unless `eager` (the private switch kept
    for this comparison)."""
    cfg = LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=2,
                      n_kv_heads=2, ffn_dim=688, rope_theta=10000.0,
                      max_seq_len=128, dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16, n_experts=n_experts)
    params = init_params(cfg, cuda,
                         torch.Generator(device=cuda).manual_seed(0))
    config = dict(n_slots=4, prefill_buckets=(16, 32), steps_per_call=4)
    config.update(kw)
    return DecodeEngine(Llama(cfg, params), EngineConfig(**config),
                        device=cuda, _eager_decode=eager)


def _serve(engine, prompts, n_new):
    reqs = [engine.submit(p, n_new) for p in prompts]
    for _ in range(200):
        engine.step_pipelined()
        if all(r.finished_at is not None for r in reqs):
            engine.drain()
            return [r.tokens() for r in reqs]
    raise AssertionError('requests did not finish')


_GRAPH_PROMPTS = ([1, 5, 9, 200, 7], list(range(40, 70)), [3] * 12,
                  list(range(100, 140)), [7, 7, 8])


@pytest.mark.parametrize('n_experts', [0, 8])
@pytest.mark.parametrize('paged', [False, True])
@pytest.mark.parametrize('temperature', [0.0, 1.0])
def test_graph_decode_matches_eager(cuda, paged, temperature, n_experts):
    """The decode call replayed as a CUDA graph gives the eager body's
    tokens (five prompts over four slots, a chunked one among them): the
    same kernels on the same buffers, and at temperature 1 the same
    draws, since the graph advances the engine's registered generator.
    A MoE model captures too: its routing reads nothing back to the
    host."""
    kw = dict(temperature=temperature, seed=3, n_experts=n_experts)
    if paged:
        kw['kv_page_size'] = 16
    graph = _narrow_engine(cuda, **kw)
    graph.prewarm()
    assert graph._decode_call.graph is not None
    eager = _narrow_engine(cuda, eager=True, **kw)
    eager.prewarm()
    assert eager._decode_call.graph is None
    assert (_serve(graph, _GRAPH_PROMPTS, 10) ==
            _serve(eager, _GRAPH_PROMPTS, 10))


@pytest.mark.parametrize('paged', [False, True])
def test_sentinel_swap_under_the_graph(cuda, paged):
    """A sentinel lm_head installed mid-request: the graph reads the
    parameters at their captured addresses, so every token of a call
    dispatched after the install is a sentinel and none before is."""
    sentinels = (100, 200)
    engine = _narrow_engine(cuda, n_slots=1, steps_per_call=2,
                            kv_page_size=16 if paged else None)
    req = engine.submit([1, 5, 9, 200, 7], 12)
    for _ in range(3):
        engine.step()
    emitted = req.emitted
    assert engine._decode_call.graph is not None and emitted
    params = engine.model.state_dict()
    head = torch.zeros_like(params['lm_head.weight'])
    head[sentinels[0]] = 5.0
    head[sentinels[1]] = -5.0
    engine.update_params({**params, 'lm_head.weight': head})
    for _ in range(20):
        engine.step()
        if req.finished_at is not None:
            break
    toks = req.tokens()
    assert len(toks) == 12
    assert set(toks[emitted:]) <= set(sentinels)
    assert not set(toks[:emitted]) <= set(sentinels)


def _spec_counts():
    text = metrics_lib.render()
    return [sum(float(line.rsplit(' ', 1)[1]) for line in text.splitlines()
                if line.startswith(f'skytpu_engine_spec_{k}_tokens_total'))
            for k in ('proposed', 'accepted')]


@pytest.mark.parametrize('kv_dtype,n_experts', [('bf16', 0), ('int8', 0),
                                                ('bf16', 8)],
                         ids=['bf16', 'int8', 'moe'])
def test_graph_verify_matches_eager(cuda, kv_dtype, n_experts):
    """The speculative verify replayed as a CUDA graph (captured at
    prewarm(), over its fixed draft buffer) gives the eager body's tokens
    and acceptance counts: bf16 and int8 pages, and a MoE model whose
    S = k+1 capacity is a Python int."""
    kw = dict(kv_page_size=16, speculation=4, kv_dtype=kv_dtype,
              n_experts=n_experts)
    runs = []
    for eager in (False, True):
        engine = _narrow_engine(cuda, eager=eager, **kw)
        engine.prewarm()
        assert engine._decode_call is None
        assert (engine._verify_call.graph is None) == eager
        before = _spec_counts()
        toks = _serve(engine, _GRAPH_PROMPTS, 10)
        runs.append((toks, [a - b for a, b in zip(_spec_counts(), before)]))
    assert runs[0] == runs[1]
    assert runs[0][1][0] > 0


def test_no_build_after_prewarm_under_the_strict_sentinel(cuda, monkeypatch):
    """prewarm() captures every call an engine uses and arms the
    sentinel: dense, paged and speculative traffic then builds nothing,
    while a call built after it raises the post-warmup error before any
    capture starts."""
    monkeypatch.setenv(compile_telemetry.STRICT_ENV, '1')
    tracing.reset_for_tests()
    try:
        for kw in ({}, dict(kv_page_size=16),
                   dict(kv_page_size=16, speculation=4)):
            engine = _narrow_engine(cuda, **kw)
            engine.prewarm()
            assert compile_telemetry.armed()
            before = compile_telemetry.summary()
            _serve(engine, _GRAPH_PROMPTS, 10)
            assert compile_telemetry.summary() == before
        assert not tracing.events_for(compile_telemetry.SENTINEL_REQUEST_ID)
        with pytest.raises(RuntimeError, match='post-warmup verify build'):
            engine._new_verify_call()
        assert tracing.events_for(compile_telemetry.SENTINEL_REQUEST_ID)
    finally:
        compile_telemetry.reset_for_tests()
        tracing.reset_for_tests()


def test_profile_window_holds_the_loop_threads_kernels(cuda, tmp_path):
    """A profiler window opened on another thread while the engine's loop
    thread serves: the gzipped chrome trace holds the flash forward
    kernel of the prefill and the decode graph's kernels."""
    store = profiler_lib.ProfileStore(root=str(tmp_path))
    engine = _narrow_engine(cuda)
    engine.prewarm()
    engine.start()
    summary = {}
    try:
        th = threading.Thread(
            target=lambda: summary.update(store.capture(2000.0)))
        th.start()
        time.sleep(0.3)
        reqs = [engine.submit(p, 10) for p in _GRAPH_PROMPTS]
        deadline = time.time() + 60
        while (not all(r.finished_at is not None for r in reqs) and
               time.time() < deadline):
            time.sleep(0.01)
        th.join(60)
        assert not th.is_alive()
        assert all(r.finished_at is not None for r in reqs)
    finally:
        engine.stop()
    with gzip.open(store.artifact_path(summary['artifact'])) as f:
        events = json.load(f)['traceEvents']
    kernels = [e for e in events if e.get('cat') == 'kernel']
    assert any('fa_fwd_kernel' in e['name'] for e in kernels)
    # A graph replay is one launch: its kernels share a correlation id,
    # where each eager launch has its own.
    per_launch = collections.Counter(e['args']['correlation']
                                     for e in kernels)
    assert max(per_launch.values()) > 1


def test_no_two_rank_mesh_or_server_on_one_card(cuda):
    """No fallback on a one-card machine: the default two-rank mesh is
    refused (NCCL puts one rank on a card) and the server's `--tensor 2`
    exits non-zero with the reason, before it spawns a rank."""
    from skypilot_tpu_torch.parallel.mesh import build_serve_mesh
    if torch.cuda.device_count() >= 2:
        pytest.skip('this machine has two cards')
    with pytest.raises(ValueError, match='needs 2 devices'):
        build_serve_mesh(2, n_heads=2, n_kv_heads=2)
    proc = subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.inference.server',
         '--model', 'tiny', '--tensor', '2'],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert 'needs 2 CUDA devices' in proc.stderr


def rank_nccl_tensor1(eager):
    """In a one-rank NCCL group: the narrow model over a tensor=1 mesh
    (its all-reduces and gathers run, over one rank), served with the
    decode call as a CUDA graph or eagerly."""
    from skypilot_tpu_torch.parallel.mesh import build_serve_mesh
    cfg = LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=2,
                      n_kv_heads=2, ffn_dim=688, rope_theta=10000.0,
                      max_seq_len=128, dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16)
    mesh = build_serve_mesh(1, cfg.n_heads, cfg.n_kv_heads)
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    model = Llama(cfg, init_params(cfg, mesh.device, gen, mesh=mesh), mesh)
    engine = DecodeEngine(model, EngineConfig(
        n_slots=4, prefill_buckets=(16, 32), steps_per_call=4, mesh=mesh),
        _eager_decode=eager)
    engine.prewarm()
    graph = engine._decode_call.graph is not None
    toks = _serve(engine, _GRAPH_PROMPTS, 10)
    engine.close()
    return toks, graph


def test_nccl_tensor1_graph_decode_matches_eager(cuda):
    """tensor=1 over a real NCCL group: the decode call is captured as a
    CUDA graph with its collectives, and its tokens equal the eager
    call's and the mesh-free engine's."""
    from skypilot_tpu_torch.parallel.group import RankPool
    with RankPool(1, 'nccl', timeout_s=120) as pool:
        graph_toks, graph = pool.run(rank_nccl_tensor1, False)[0]
        eager_toks, eager = pool.run(rank_nccl_tensor1, True)[0]
    assert graph and not eager
    plain = _narrow_engine(cuda)
    plain.prewarm()
    assert graph_toks == eager_toks == _serve(plain, _GRAPH_PROMPTS, 10)
