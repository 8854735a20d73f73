"""In-flight weight swaps in the port engine (`update_params`), mirroring
the JAX engine's swap tests (tests/test_serve_chunked.py): a sentinel
`lm_head` installed mid-request under `step()` (dense and paged), a swap
with a chunked prefill in progress under `step_pipelined`, repeated
swaps under the threaded loop; plus what the port adds: the engine never
aliases the caller's tensors, the decode call keeps its fixed buffers
(the CUDA graph's addresses) across admissions and swaps, and malformed
state dicts are refused.  `tiny` weights converted from the Flax model,
f32 compute."""
import dataclasses
import gc
import time
import weakref

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
_SENTINELS = (100, 200)
_PROMPT_RNG = np.random.default_rng(7)


@pytest.fixture(scope='module')
def params():
    model_j = jl.Llama(CFG_J)
    params_j = meta.unbox(jax.jit(model_j.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))['params'])
    return params_from_jax(jax.tree.map(np.asarray, params_j))


def make_engine(params, **overrides):
    """An engine over its OWN model (update_params writes into the
    served parameters, so engines never share one)."""
    kw = dict(n_slots=2, prefill_buckets=(8, 16), steps_per_call=3)
    kw.update(overrides)
    model = tl.Llama(CFG_T, {k: v.clone() for k, v in params.items()})
    return DecodeEngine(model, EngineConfig(**kw), device='cpu')


def run_to_completion(engine, reqs, max_steps=2000, step='step'):
    fn = getattr(engine, step)
    for _ in range(max_steps):
        fn()
        if all(r.finished_at is not None for r in reqs):
            return
    raise AssertionError('requests did not finish')


def wait_tokens(reqs, timeout=120.0):
    """Each request's tokens, once the threaded loop finished them all
    (`Request.tokens()` would block forever on a stuck loop)."""
    deadline = time.monotonic() + timeout
    while any(r.finished_at is None for r in reqs):
        if time.monotonic() > deadline:
            raise AssertionError('requests did not finish in time')
        time.sleep(0.01)
    return [r.tokens() for r in reqs]


def prompt_of(n):
    return _PROMPT_RNG.integers(1, CFG_T.vocab_size, n).tolist()


def sentinel_params(params):
    """A state dict whose lm_head can only ever argmax to one of two
    sentinel tokens, whatever the hidden state: every row is zero except
    +-5 constant rows at the sentinels, so the logits are (5*sum(h),
    -5*sum(h), 0, ...)."""
    head = torch.zeros_like(params['lm_head.weight'])
    head[_SENTINELS[0]] = 5.0
    head[_SENTINELS[1]] = -5.0
    return {**params, 'lm_head.weight': head}


def scaled(params, factor):
    return {k: v * factor for k, v in params.items()}


@pytest.mark.parametrize('paged', [False, True])
def test_update_params_in_flight_next_call_uses_new_weights(params, paged):
    """Sync-step control: swap mid-request; the very next decode call
    (dispatched after the install) samples from the NEW weights:
    post-install tokens can ONLY be sentinels, and pre-install tokens
    (random weights) are not all sentinels."""
    engine = make_engine(params, n_slots=1, steps_per_call=2,
                         kv_page_size=8 if paged else None)
    req = engine.submit(prompt_of(5), 12)
    for _ in range(3):
        engine.step()
    emitted_before = req.emitted
    assert emitted_before and req.finished_at is None
    engine.update_params(sentinel_params(params))
    engine.step()                      # first call after the install
    run_to_completion(engine, [req])
    toks = req.tokens()
    assert len(toks) == 12             # never dropped, full budget
    assert set(toks[emitted_before:]) <= set(_SENTINELS), \
        'a post-install token was sampled from the old weights'
    assert not set(toks[:emitted_before]) <= set(_SENTINELS)


def test_update_params_in_flight_chunked(params):
    """The swap composes with a chunked prefill in progress under the
    pipelined loop: nothing is dropped, serving continues, and the
    served parameters hold the new values."""
    engine = make_engine(params)
    long_req = engine.submit(prompt_of(60), 8)
    short_req = engine.submit(prompt_of(4), 8)
    engine.step_pipelined()            # chunk 1 + the short admission
    engine.step_pipelined()            # a decode call in flight, chunk 2
    assert engine._chunked is not None and engine._inflight is not None
    new = scaled(params, 1.03)
    engine.update_params(new)
    run_to_completion(engine, [long_req, short_req], step='step_pipelined')
    assert len(long_req.tokens()) == 8
    assert len(short_req.tokens()) == 8
    served = engine.model.state_dict()
    for name, want in new.items():
        assert torch.equal(served[name], want), name


def test_update_params_continuous_emission_across_swaps(params):
    """Rolling refresh under the threaded loop: tokens keep flowing
    while update_params fires repeatedly: no request blocks, none is
    dropped, and the last swap is what the engine serves."""
    engine = make_engine(params, n_slots=2, steps_per_call=2)
    engine.start()
    try:
        reqs = [engine.submit(prompt_of(20), 20),
                engine.submit(prompt_of(6), 20)]
        trees = [scaled(params, s) for s in (1.01, 1.02, 1.03)]
        for tree in trees:
            engine.update_params(tree)
        outs = wait_tokens(reqs)
    finally:
        engine.stop()
    assert engine.healthy
    assert [len(o) for o in outs] == [20, 20]
    served = engine.model.state_dict()
    assert all(torch.equal(served[k], v) for k, v in trees[-1].items())


def test_update_params_never_aliases_the_callers_tensors(params):
    """An optimizer goes on updating its tensors in place after the
    swap: the engine serves the values it was given, not the caller's
    later ones."""
    prompts = [prompt_of(5), prompt_of(9)]
    new = scaled(params, 1.05)
    engine = make_engine(params)
    engine.update_params(new)
    for t in new.values():
        t.mul_(-3.0)                   # the caller mutates in place
    served = engine.model.state_dict()
    assert not any(served[k].data_ptr() == v.data_ptr()
                   for k, v in new.items())
    reqs = [engine.submit(p, 6) for p in prompts]
    run_to_completion(engine, reqs)
    fresh = make_engine(scaled(params, 1.05))
    want = [fresh.submit(p, 6) for p in prompts]
    run_to_completion(fresh, want)
    assert [r.tokens() for r in reqs] == [r.tokens() for r in want]


@pytest.mark.parametrize('paged', [False, True])
def test_decode_call_keeps_its_buffers(params, paged):
    """The buffers a captured decode call reads and writes keep their
    storage for the engine's life (results are copied back, the page
    table is refreshed in place), and each call hands out a clone of its
    output rows: admissions, retires, a chunked prompt and a swap later,
    the pipelined loop still equals the synchronous one."""
    kw = dict(kv_page_size=8) if paged else {}
    engine = make_engine(params, **kw)
    engine.prewarm()                   # builds the call before traffic
    call = engine._decode_call
    fixed = [engine._last_d, engine._lens_d, call.out] + [
        t for layer in engine._cache for t in layer]
    if paged:
        fixed.append(engine._pt_device)
    ptrs = [t.data_ptr() for t in fixed]
    prompts = [prompt_of(3), prompt_of(40), prompt_of(12)]
    reqs = [engine.submit(p, 7) for p in prompts]
    outs = []

    def spy(eng):
        out = call(eng)
        assert out.data_ptr() != call.out.data_ptr()
        outs.append(out)
        return out

    engine._decode_call = spy
    engine.step_pipelined()
    engine.update_params(scaled(params, 1.0))
    run_to_completion(engine, reqs, step='step_pipelined')
    engine.drain()
    assert len(outs) >= 3 and call.graph is None
    assert [t.data_ptr() for t in fixed] == ptrs
    ref = make_engine(params, **kw)
    want = [ref.submit(p, 7) for p in prompts]
    run_to_completion(ref, want)
    assert [r.tokens() for r in reqs] == [r.tokens() for r in want]


@pytest.mark.parametrize('edit,match', [
    (lambda p: {k: v for k, v in p.items() if k != 'final_norm.scale'},
     r"lacks \['final_norm.scale'\]"),
    (lambda p: {**p, 'extra.weight': torch.zeros(2)},
     r"unknown \['extra.weight'\]"),
    (lambda p: {**p, 'lm_head.weight': p['lm_head.weight'][:, :8]},
     'wrong shapes.*lm_head.weight'),
])
def test_update_params_refuses_malformed_state_dicts(params, edit, match):
    engine = make_engine(params)
    with pytest.raises(ValueError, match=match):
        engine.update_params(edit(params))
    assert engine._staged_params is None
    served = engine.model.state_dict()
    assert all(torch.equal(served[k], v) for k, v in params.items())


@pytest.mark.parametrize('paged', [False, True])
def test_engine_frees_without_the_garbage_collector(params, paged):
    """A dropped engine frees its cache, its decode call and its model
    at once: nothing it owns points back at it (a cycle would hold a
    card's worth of KV cache and weights until a collection ran)."""
    engine = make_engine(params, kv_page_size=8 if paged else None)
    engine.prewarm()
    req = engine.submit(prompt_of(5), 4)
    run_to_completion(engine, [req], step='step_pipelined')
    engine.drain()
    engine.update_params(scaled(params, 1.0))
    refs = [weakref.ref(x) for x in (engine, engine._decode_call,
                                     engine.model)]
    gc.disable()
    try:
        del engine
        assert [r() for r in refs] == [None, None, None]
    finally:
        gc.enable()
