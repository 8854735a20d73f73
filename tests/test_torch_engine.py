"""Port decode engine on `tiny` with weights converted from the Flax
model: continuous batching must reproduce the JAX model's greedy tokens
exactly (mirrors tests/test_inference.py for the dense engine), plus a
chunked-prefill prompt longer than the largest bucket.  f32 compute on
both sides so greedy argmax is not at the mercy of bf16 rounding."""
import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from skypilot_tpu.models import llama as jl
from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(1)

CFG_J = dataclasses.replace(jl.LLAMA_CONFIGS['tiny'], dtype=jnp.float32)
CFG_T = dataclasses.replace(tl.LLAMA_CONFIGS['tiny'], dtype=torch.float32)
PAD = 64        # reference forward length (causal: right padding is inert)


@pytest.fixture(scope='module')
def models():
    model_j = jl.Llama(CFG_J)
    params_j = meta.unbox(jax.jit(model_j.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))['params'])
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j))
    apply = jax.jit(lambda toks: model_j.apply({'params': params_j}, toks))

    @functools.lru_cache(maxsize=None)
    def greedy(prompt, n_new):
        """JAX reference: full forward over the growing sequence each
        step, padded to one length so it compiles once."""
        ids = list(prompt)
        for _ in range(n_new):
            buf = np.zeros((1, PAD), np.int32)
            buf[0, :len(ids)] = ids
            ids.append(int(jnp.argmax(apply(buf)[0, len(ids) - 1])))
        return ids[len(prompt):]

    return tl.Llama(CFG_T, params_t), greedy


def _engine(model, **kw):
    return DecodeEngine(model, EngineConfig(**kw), device='cpu')


def _run(engine, reqs, step='step', limit=400):
    for _ in range(limit):
        getattr(engine, step)()
        if all(r.finished_at is not None for r in reqs):
            return [r.tokens() for r in reqs]
    raise AssertionError('requests did not finish')


def test_engine_matches_jax_greedy(models):
    model, greedy = models
    engine = _engine(model, n_slots=2, prefill_buckets=(8, 16))
    prompt = (5, 17, 3, 42, 9)
    assert _run(engine, [engine.submit(list(prompt), 8)]) == [
        greedy(prompt, 8)]


def test_engine_continuous_batching_staggered(models):
    model, greedy = models
    engine = _engine(model, n_slots=2, prefill_buckets=(8, 16))
    p1, p2 = (1, 2, 3), (7, 8, 9, 10, 11, 12)
    r1 = engine.submit(list(p1), 10)
    for _ in range(3):
        engine.step()
    r2 = engine.submit(list(p2), 6)
    assert _run(engine, [r1, r2]) == [greedy(p1, 10), greedy(p2, 6)]


def test_engine_batched_admission_burst(models):
    """Mixed buckets and odd group sizes (power-of-two padding rows), all
    admitted by the first step."""
    model, greedy = models
    engine = _engine(model, n_slots=8, prefill_buckets=(8, 16),
                     steps_per_call=2)
    prompts = [(1, 2, 3), (4, 5, 6, 7, 8), (9, 10, 11),
               tuple(range(20, 30)), (13, 14, 15, 16, 17, 18, 19, 20, 21)]
    reqs = [engine.submit(list(p), 6) for p in prompts]
    engine.step()
    assert sum(s is not None for s in engine._slots) == 5
    assert engine.prefill_groups == 2
    assert _run(engine, reqs) == [greedy(p, 6) for p in prompts]


def test_engine_slot_reuse_no_kv_leak(models):
    model, greedy = models
    engine = _engine(model, n_slots=1, prefill_buckets=(8,))
    _run(engine, [engine.submit([4] * 8, 5)])
    assert _run(engine, [engine.submit([9, 1, 9], 5)]) == [
        greedy((9, 1, 9), 5)]


def test_engine_eos_and_max_len(models):
    model, greedy = models
    want = greedy((3, 1), 12)
    stop_at = next((i for i in range(1, len(want))
                    if want[i] not in want[:i]), None)
    eos = want[stop_at] if stop_at is not None else -1
    engine = _engine(model, n_slots=1, prefill_buckets=(8,), eos_id=eos)
    got = _run(engine, [engine.submit([3, 1], 12)])[0]
    assert got == (want[:stop_at + 1] if stop_at is not None else want)
    req = engine.submit([3, 1], 10_000)
    assert req.max_new_tokens == CFG_T.max_seq_len - 2


def test_engine_rejects_oversized_prompt(models):
    model, _ = models
    engine = _engine(model, n_slots=1, prefill_buckets=(8, 512))
    assert engine.cfg.prefill_buckets == (8,)
    with pytest.raises(ValueError):
        engine.submit(list(range(200)), 4)


def test_engine_chunked_prefill_long_prompt(models):
    """A prompt longer than the largest bucket streams through the
    scratch cache in chunks (16 + 16 + final 8-bucket chunk) while a
    short request decodes beside it."""
    model, greedy = models
    engine = _engine(model, n_slots=2, prefill_buckets=(8, 16),
                     steps_per_call=3)
    long_prompt = tuple(int(x) for x in np.random.default_rng(5).integers(
        0, CFG_T.vocab_size, 37))
    short = engine.submit([2, 4, 6], 7)
    long_req = engine.submit(list(long_prompt), 6)
    assert _run(engine, [short, long_req], step='step_pipelined') == [
        greedy((2, 4, 6), 7), greedy(long_prompt, 6)]


def test_engine_crash_fails_requests_and_health(models):
    model, _ = models
    engine = _engine(model, n_slots=1, prefill_buckets=(8,))
    engine._decode = None   # force a crash inside step()
    engine.start()
    try:
        req = engine.submit([1, 2], 4)
        assert req.tokens() == []          # failed, not hung
        assert not engine.healthy
        with pytest.raises(RuntimeError):
            engine.submit([1, 2], 4)       # dead engine rejects submits
    finally:
        engine.stop()


def test_engine_pipelined_matches_sync_step(models):
    model, _ = models

    def run(step):
        engine = _engine(model, n_slots=2, steps_per_call=3,
                         prefill_buckets=(8, 16))
        reqs = [engine.submit([1, 2, 3], 8), engine.submit([7, 8, 9, 10], 6)]
        return _run(engine, reqs, step=step)

    assert run('step_pipelined') == run('step')


def test_engine_pipelined_slot_reuse_backlog(models):
    """4 requests through 2 slots under pipelining: each completes with
    exactly its max_new tokens and matches the reference."""
    model, greedy = models
    engine = _engine(model, n_slots=2, steps_per_call=3,
                     prefill_buckets=(8, 16))
    prompts = [(1, 2, 3), (7, 8, 9, 10), (4, 4, 4, 4, 4), (11, 12)]
    lens = [10, 6, 5, 7]
    reqs = [engine.submit(list(p), n) for p, n in zip(prompts, lens)]
    assert _run(engine, reqs, step='step_pipelined') == [
        greedy(p, n) for p, n in zip(prompts, lens)]


def test_engine_pipelined_threaded_loop(models):
    model, greedy = models
    engine = _engine(model, n_slots=2, steps_per_call=2,
                     prefill_buckets=(8, 16))
    engine.start()
    try:
        r1 = engine.submit([1, 2, 3], 6)
        threading.Event().wait(0.05)
        r2 = engine.submit([7, 8, 9, 10, 11, 12], 4)
        assert r1.tokens() == greedy((1, 2, 3), 6)
        assert r2.tokens() == greedy((7, 8, 9, 10, 11, 12), 4)
    finally:
        engine.stop()
    assert not engine._thread.is_alive()


def test_engine_refuses_later_slice_options(models):
    """Tensor parallelism (`mesh`) is accepted now, over a model built on
    the same mesh (tests/test_torch_sharded.py serves it): a mesh the
    model was not built over is refused.  The paged options (pages, pool
    size, prefix cache, int8 pages, speculation) are accepted."""
    model, _ = models
    with pytest.raises(ValueError, match='model over the same mesh'):
        _engine(model, mesh=object())
    for kw in ({'kv_page_size': 8}, {'kv_page_size': 8, 'kv_pages': 17},
               {'kv_page_size': 8, 'prefix_cache': False},
               {'kv_page_size': 8, 'kv_dtype': 'int8'},
               {'kv_page_size': 8, 'speculation': 2}):
        engine = _engine(model, prefill_buckets=(8, 16), **kw)
        assert engine._paged and engine.cfg.kv_page_size == kw[
            'kv_page_size']


def test_engine_temperature_sampling_is_seeded(models):
    """temperature > 0 draws from the engine's own generator: the same
    seed gives the same tokens, ids stay in the vocabulary."""
    model, _ = models

    def run(seed):
        engine = _engine(model, n_slots=2, prefill_buckets=(8,),
                         temperature=0.8, seed=seed, steps_per_call=3)
        reqs = [engine.submit([1, 2, 3], 7), engine.submit([4, 5], 7)]
        return _run(engine, reqs)

    first = run(3)
    assert first == run(3)
    assert all(len(t) == 7 and all(0 <= i < CFG_T.vocab_size for i in t)
               for t in first)
