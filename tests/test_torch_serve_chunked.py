"""Chunked prefill in the port's engine, against the JAX engine
(mirrors tests/test_serve_chunked.py; its swap cases are mirrored in
tests/test_torch_lifecycle.py and chunked = fused at tensor 2 in
tests/test_torch_sharded.py):

- mixed long and short prompts through the pipelined scheduler: the
  long ones token-identical to the fused single-dispatch path, every
  budget exact, two runs equal, and the same tokens as the JAX engine
  under the same traffic;
- a prompt of max_seq_len - 1 is admitted and generates its one token;
- a long prompt's final chunk insert is not starved by short traffic;
- no call object is built under mixed chunked / short traffic once the
  engine is prewarmed (the strict recompile sentinel armed);
- admission: beyond the cache and beyond the `max_prompt_len` knob
  refused, at the cap admitted; the HTTP server's 413 carries the limit;
- the chunk counter and the queued-prefill-token backlog gauge.

Weights: the JAX `tiny` model's, converted; f32 compute on both sides so
greedy argmax is not at the mercy of bf16 rounding."""
import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from skypilot_tpu.inference import engine as jax_engine
from skypilot_tpu.perf import compile_telemetry as jax_compile_telemetry
from skypilot_tpu.models import llama as jl
from skypilot_tpu_torch.inference import server as torch_server
from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.perf import compile_telemetry
from skypilot_tpu_torch.server import metrics as metrics_lib

torch.set_num_threads(1)

CFG_J = dataclasses.replace(jl.LLAMA_CONFIGS['tiny'], dtype=jnp.float32)
CFG_T = dataclasses.replace(tl.LLAMA_CONFIGS['tiny'], dtype=torch.float32)
KW = dict(n_slots=2, prefill_buckets=(8, 16), steps_per_call=3)


@pytest.fixture(scope='module')
def weights():
    """(JAX model, JAX params, the port's state dict of them)."""
    model_j = jl.Llama(CFG_J)
    params_j = meta.unbox(jax.jit(model_j.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))['params'])
    return model_j, params_j, params_from_jax(jax.tree.map(np.asarray,
                                                           params_j))


@pytest.fixture(autouse=True)
def _reset():
    # The JAX reference engines compile lazily: a JAX sentinel left armed
    # by an earlier test in this process (a mesh engine's prewarm() arms
    # it) would raise inside them under SKYTPU_STRICT_RECOMPILE.
    for telemetry in (compile_telemetry, jax_compile_telemetry):
        telemetry.reset_for_tests()
    metrics_lib.reset_for_tests()
    yield
    metrics_lib.reset_for_tests()
    for telemetry in (compile_telemetry, jax_compile_telemetry):
        telemetry.reset_for_tests()


def prompt_of(n, seed):
    return np.random.default_rng(seed).integers(1, CFG_T.vocab_size,
                                                n).tolist()


def make_engine(weights, **overrides):
    return DecodeEngine(tl.Llama(CFG_T, weights[2]),
                        EngineConfig(**dict(KW, **overrides)), device='cpu')


def make_jax_engine(weights, **overrides):
    return jax_engine.DecodeEngine(weights[0], weights[1],
                                   jax_engine.EngineConfig(
                                       **dict(KW, **overrides)))


def run_to_completion(engine, reqs, max_steps=2000, step='step'):
    fn = getattr(engine, step)
    for _ in range(max_steps):
        fn()
        if all(r.finished_at is not None for r in reqs):
            return
    raise AssertionError('requests did not finish')


def fused_reference(weights, prompt, n_new):
    """The single-dispatch path: an engine whose largest bucket holds the
    whole prompt."""
    engine = make_engine(weights, prefill_buckets=(8, 16, 128))
    assert len(prompt) <= 128
    req = engine.submit(prompt, n_new)
    run_to_completion(engine, [req])
    return req.tokens()


def test_chunked_pipelined_mixed_traffic(weights):
    """Long and short prompts interleaved through the pipelined
    scheduler: every budget exact, the long ones equal to the fused
    path, two runs equal, and the JAX engine's tokens under the same
    traffic."""
    long1, long2 = prompt_of(30, 1), prompt_of(50, 2)
    shorts = [prompt_of(3, 3), prompt_of(12, 4), prompt_of(7, 5)]
    want1 = fused_reference(weights, long1, 8)
    want2 = fused_reference(weights, long2, 5)

    def run(make):
        engine = make(weights)
        r1 = engine.submit(long1, 8)
        rs = [engine.submit(p, 6) for p in shorts[:2]]
        engine.step_pipelined()
        r2 = engine.submit(long2, 5)
        rs.append(engine.submit(shorts[2], 6))
        run_to_completion(engine, [r1, r2] + rs, step='step_pipelined')
        return [r.tokens() for r in (r1, r2)], [r.tokens() for r in rs]

    first = run(make_engine)
    (got1, got2), short_toks = first
    assert got1 == want1 and got2 == want2
    assert [len(t) for t in short_toks] == [6, 6, 6]
    assert run(make_engine) == first
    assert run(make_jax_engine) == first


def test_chunked_up_to_max_seq_len(weights):
    """The admission ceiling is the cache, not the bucket set: a
    max_seq_len - 1 prompt is admitted, clamped to one new token, and
    generates the JAX engine's token."""
    prompt = prompt_of(CFG_T.max_seq_len - 1, 6)
    toks = []
    for make in (make_engine, make_jax_engine):
        engine = make(weights)
        assert engine.max_prompt_len == CFG_T.max_seq_len - 1
        req = engine.submit(prompt, 10)
        assert req.max_new_tokens == 1
        run_to_completion(engine, [req])
        toks.append(req.tokens())
    assert len(toks[0]) == 1 and toks[0] == toks[1]


def test_final_insert_not_starved_by_short_traffic(weights):
    """Once a long prompt's final chunk is pending, admission reserves
    its slot (n_slots=1: total contention), so it finishes ahead of
    shorts queued behind it, with the fused path's tokens."""
    prompt = prompt_of(40, 7)
    want = fused_reference(weights, prompt, 5)
    engine = make_engine(weights, n_slots=1)
    long_req = engine.submit(prompt, 5)
    shorts = [engine.submit(prompt_of(4, 10 + i), 5) for i in range(8)]
    run_to_completion(engine, [long_req] + shorts, step='step_pipelined')
    assert long_req.tokens() == want
    assert long_req.finished_at < max(s.finished_at for s in shorts)


def test_zero_builds_mixed_chunked_short_traffic(weights, monkeypatch):
    """After prewarm(), mixed chunked / short traffic builds no call
    object: the strict sentinel is armed (a build would raise in the
    building call), the build counts stay where prewarm left them, the
    decode call is the same object, and the tokens are the JAX
    engine's."""
    monkeypatch.setenv(compile_telemetry.STRICT_ENV, '1')
    engine = make_engine(weights)
    engine.prewarm()
    engine.arm_recompile_sentinel()
    try:
        builds = compile_telemetry.summary()
        call = engine._decode_call
        traffic = [(prompt_of(55, 20), 5),    # 3 chunks, rem 7
                   (prompt_of(44, 21), 5),    # rem 12 -> bucket 16
                   (prompt_of(7, 22), 5), (prompt_of(16, 23), 5)]
        reqs = [engine.submit(p, n) for p, n in traffic]
        run_to_completion(engine, reqs, step='step_pipelined')
        engine.drain()
        assert engine.healthy, engine.error
        assert compile_telemetry.summary() == builds
        assert engine._decode_call is call
    finally:
        compile_telemetry.disarm()
    ref = make_jax_engine(weights)
    jreqs = [ref.submit(p, n) for p, n in traffic]
    run_to_completion(ref, jreqs, step='step_pipelined')
    assert [r.tokens() for r in reqs] == [r.tokens() for r in jreqs]


def test_admission_rejects_beyond_max_seq_len(weights):
    engine = make_engine(weights)
    with pytest.raises(ValueError, match='max_prompt_len'):
        engine.submit(prompt_of(CFG_T.max_seq_len, 8), 4)
    with pytest.raises(ValueError, match=str(CFG_T.max_seq_len - 1)):
        engine.submit(prompt_of(500, 8), 4)


def test_admission_respects_max_prompt_len_knob(weights):
    engine = make_engine(weights, max_prompt_len=32)
    assert engine.max_prompt_len == 32
    with pytest.raises(ValueError, match='max_prompt_len 32'):
        engine.submit(prompt_of(33, 9), 4)
    req = engine.submit(prompt_of(32, 9), 4)       # at the cap: admitted
    run_to_completion(engine, [req])
    assert len(req.tokens()) == 4


def test_http_server_413_carries_limit(weights):
    """An over-limit prompt gets a 413 carrying the limit, not a 500 or a
    hang; an admissible long (chunked) prompt still serves."""
    from aiohttp.test_utils import TestClient, TestServer

    engine = make_engine(weights, max_prompt_len=16)
    engine.start()

    async def drive():
        client = TestClient(TestServer(torch_server.build_app(engine)))
        await client.start_server()
        try:
            r = await client.post(
                '/v1/completions',
                json={'prompt_ids': list(range(1, 40)), 'max_tokens': 4})
            assert r.status == 413
            body = await r.json()
            assert body['max_prompt_len'] == 16
            assert 'max_prompt_len 16' in body['error']
            r2 = await client.post(
                '/v1/completions',
                json={'prompt_ids': list(range(1, 14)), 'max_tokens': 3})
            assert r2.status == 200
            assert len((await r2.json())['ids']) == 3
        finally:
            await client.close()

    try:
        asyncio.new_event_loop().run_until_complete(drive())
    finally:
        engine.stop()


def test_chunk_counter_and_backlog_gauge(weights):
    engine = make_engine(weights)
    req = engine.submit(prompt_of(40, 11), 4)     # 2 chunks + final 8
    engine._sample_gauges(0)
    text = metrics_lib.render()
    assert 'skytpu_engine_queued_prefill_tokens 40.0' in text
    run_to_completion(engine, [req])
    engine._sample_gauges(0)
    text = metrics_lib.render()
    assert 'skytpu_engine_prefill_chunks_total 3.0' in text
    assert 'skytpu_engine_queued_prefill_tokens 0.0' in text
    assert 'skytpu_engine_prefill_tokens_total 40.0' in text
