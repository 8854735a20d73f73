"""Paged KV pool + radix prefix cache of the port's engine, against the
JAX engine (mirrors tests/test_serve_paged.py at the engine level).

Parity contract: the port's paged engine (page pool, per-slot page
tables, prefix-cache hits included) emits the JAX paged engine's greedy
tokens exactly, on the same `tiny` weights (converted from the Flax tree
with models/convert.py), f32 compute on both sides.  The allocator
invariants (refcounts equal live holders, no page written by two live
slots, free pages conserved) hold through churn and eviction, every
active step fetches from the device once, and the config refusals carry
the JAX engine's messages.  JAX engines are shared through module
fixtures: one compile per program, reused by every test.
"""
import asyncio
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from flax.core import meta

from skypilot_tpu.inference import engine as jax_engine
from skypilot_tpu.models import llama as jl
from skypilot_tpu_torch.inference import engine as torch_engine
from skypilot_tpu_torch.inference import server as torch_server
from skypilot_tpu_torch.inference.paging import TRASH_PAGE
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.server import metrics as metrics_lib
from skypilot_tpu_torch.server import tracing

torch.set_num_threads(1)

# f32 compute on both sides so greedy argmax is not at the mercy of bf16.
CFG_J = dataclasses.replace(jl.LLAMA_CONFIGS['tiny'], dtype=jnp.float32)
CFG_T = dataclasses.replace(tl.LLAMA_CONFIGS['tiny'], dtype=torch.float32)
PS = 8     # page size: divides the buckets (8, 16) and max_seq_len (128)
ENGINE_KW = dict(n_slots=2, prefill_buckets=(8, 16), steps_per_call=3,
                 kv_page_size=PS)


def prompt_of(n, seed):
    return np.random.default_rng(seed).integers(
        1, CFG_T.vocab_size, n).tolist()


def jax_params(cfg=CFG_J):
    model = jl.Llama(cfg)
    return model, meta.unbox(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))['params'])


def torch_model(params_j, cfg=CFG_T):
    return tl.Llama(cfg, params_from_jax(jax.tree.map(np.asarray,
                                                      params_j)))


def run(engine, reqs, step='step', limit=3000):
    """Step until every request finished; returns their streams."""
    fn = getattr(engine, step)
    for _ in range(limit):
        fn()
        if all(r.finished_at is not None for r in reqs):
            if step == 'step_pipelined':
                engine.drain()
            return [r.tokens() for r in reqs]
    raise AssertionError('requests did not finish')


def counter(family):
    """Sum of one family's samples in the port's /metrics text."""
    total = 0.0
    for line in metrics_lib.render().splitlines():
        if line.startswith(family) and not line.startswith('#'):
            name = line.split('{')[0].split(' ')[0]
            if name == family:
                total += float(line.rsplit(' ', 1)[1])
    return total


class CountingFetch:
    """Counts the engine's device->host fetches (`Tensor.cpu`) and any
    `.item()` / `.tolist()`, which would be hidden syncs."""

    def __init__(self, monkeypatch):
        self.cpu = self.hidden = 0
        real_cpu = torch.Tensor.cpu

        def cpu(t, *args, **kwargs):
            self.cpu += 1
            return real_cpu(t, *args, **kwargs)

        def hidden(name):
            real = getattr(torch.Tensor, name)

            def wrapped(t, *args, **kwargs):
                self.hidden += 1
                return real(t, *args, **kwargs)
            return wrapped

        monkeypatch.setattr(torch.Tensor, 'cpu', cpu)
        monkeypatch.setattr(torch.Tensor, 'item', hidden('item'))
        monkeypatch.setattr(torch.Tensor, 'tolist', hidden('tolist'))


@pytest.fixture(scope='module')
def ref():
    """(JAX model, params, port model, JAX stream fn).  The JAX stream
    fn serves prompts on one shared paged JAX engine per config."""
    model_j, params_j = jax_params()
    engines = {}

    def jax_streams(prompts, n_new, **overrides):
        key = tuple(sorted(overrides.items()))
        if key not in engines:
            kw = dict(ENGINE_KW, **overrides)
            engines[key] = jax_engine.DecodeEngine(
                model_j, params_j, jax_engine.EngineConfig(**kw))
        eng = engines[key]
        reqs = [eng.submit(list(p), n_new) for p in prompts]
        for _ in range(3000):
            eng.step()
            if all(r.finished_at is not None for r in reqs):
                return [r.tokens() for r in reqs]
        raise AssertionError('JAX requests did not finish')

    return model_j, params_j, torch_model(params_j), jax_streams


@pytest.fixture(autouse=True)
def _reset_metrics():
    metrics_lib.reset_for_tests()
    yield
    metrics_lib.reset_for_tests()


def make_engine(model, paged=True, **overrides):
    kw = dict(ENGINE_KW)
    if not paged:
        kw.pop('kv_page_size')
    kw.update(overrides)
    return torch_engine.DecodeEngine(model, torch_engine.EngineConfig(**kw),
                                     device='cpu')


def assert_page_invariants(engine):
    """No page referenced by two live non-sharing slots; refcounts
    consistent; freed-page count conserved."""
    engine._pool_alloc.check_conserved()
    owned_by = {}
    for i, slot in enumerate(engine._slots):
        if slot is None or slot.pages is None:
            continue
        for j, p in enumerate(slot.pages):
            if j < slot.n_shared:
                continue                 # shared prefix pages may repeat
            assert p not in owned_by, (
                f'page {p} owned by live slots {owned_by[p]} and {i}')
            owned_by[p] = i


# ----- parity with the JAX paged engine --------------------------------------
@pytest.mark.parametrize('plen', [5, 13, 16, 40])
def test_paged_matches_jax_paged(ref, plen):
    """Fused-bucket, partial-page, page-aligned and CHUNKED prompts,
    two at a time (one admission group): the port's paged engine emits
    the JAX paged engine's tokens."""
    _, _, model, jax_streams = ref
    prompts = [prompt_of(plen, plen), prompt_of(plen + 1, plen + 100)]
    engine = make_engine(model)
    got = run(engine, [engine.submit(p, 7) for p in prompts])
    assert got == jax_streams(prompts, 7)
    assert_page_invariants(engine)


def test_paged_matches_unpaged_and_pipelined(ref):
    """Paged equals the port's dense engine, and the pipelined loop
    equals the synchronous step, through two passes over a shared prefix
    (the second pass hits)."""
    _, _, model, _ = ref
    shared = prompt_of(12, 1)
    prompts = [prompt_of(5, 2), prompt_of(14, 3), prompt_of(40, 4)]
    dense = make_engine(model, paged=False)
    want = run(dense, [dense.submit(p, 6) for p in prompts])
    paged = make_engine(model)
    assert run(paged, [paged.submit(p, 6) for p in prompts]) == want

    def rounds(step):
        engine = make_engine(model)
        outs = []
        for round_i in range(2):
            reqs = [engine.submit(shared + [round_i + 1, j], 6)
                    for j in range(3)]
            outs.append(run(engine, reqs, step=step))
        return outs

    assert rounds('step_pipelined') == rounds('step')


# ----- prefix cache ----------------------------------------------------------
def test_prefix_hit_token_identical_and_counted(ref):
    _, _, model, jax_streams = ref
    shared = prompt_of(20, 5)            # 2 full pages
    pa, pb = shared + prompt_of(3, 6), shared + prompt_of(5, 7)
    want_a, want_b = jax_streams([pa], 6)[0], jax_streams([pb], 6)[0]
    engine = make_engine(model)
    assert run(engine, [engine.submit(pa, 6)]) == [want_a]
    assert run(engine, [engine.submit(pb, 6)]) == [want_b]   # the hit
    assert counter('skytpu_engine_prefix_cache_hits_total') == 1
    assert counter('skytpu_engine_prefix_cache_misses_total') == 1
    # 2 full pages x 8 tokens of prefill skipped.
    assert counter('skytpu_engine_prefix_cache_tokens_total') == 16
    assert 'skytpu_engine_kv_free_pages' in metrics_lib.render()


def test_prefix_hit_records_span_and_decomposes(ref):
    _, _, model, _ = ref
    tracing.clear_for_tests()
    engine = make_engine(model)
    shared = prompt_of(20, 8)
    run(engine, [engine.submit(shared + [7], 4, request_id='pt-miss')])
    run(engine, [engine.submit(shared + [9, 9], 4, request_id='pt-hit')])
    events = tracing.events_for('pt-hit')
    hit = next(e for e in events if e['name'] == 'engine.prefix_hit')
    assert hit['attrs']['cached_tokens'] == 16
    s = tracing.decompose(events)
    assert s['prefix_cached_tokens'] == 16
    assert s['ttft_ms'] is not None
    assert abs(s['unattributed_ms']) <= max(0.02 * s['ttft_ms'], 5.0)


def test_prefix_cache_off_no_hits(ref):
    _, _, model, jax_streams = ref
    shared = prompt_of(20, 9)
    want = jax_streams([shared + [9]], 5)[0]
    engine = make_engine(model, prefix_cache=False)
    run(engine, [engine.submit(shared + [7], 5)])
    assert run(engine, [engine.submit(shared + [9], 5)]) == [want]
    assert engine._radix is None
    assert 'prefix_cache_hits_total' not in metrics_lib.render()


def test_paged_slot_reuse_no_kv_leak(ref):
    """A request admitted into pages a previous request used generates
    exactly what it would in a fresh engine."""
    _, _, model, jax_streams = ref
    engine = make_engine(model, n_slots=1, prefix_cache=False)
    run(engine, [engine.submit([4] * 8, 5)])
    prompt = prompt_of(7, 10)
    assert run(engine, [engine.submit(prompt, 5)]) == jax_streams(
        [prompt], 5)


def test_multi_turn_replay_hits_generated_pages(ref):
    """Retire donates prompt+generated pages: a second turn replaying
    turn 1 (prompt + reply) hits past the original prompt, into the
    generated region, and still matches the JAX engine."""
    _, _, model, jax_streams = ref
    engine = make_engine(model)
    turn1 = prompt_of(16, 11)            # page-aligned prompt
    reply = run(engine, [engine.submit(turn1, 9)])[0]
    assert reply == jax_streams([turn1], 9)[0]
    turn2 = turn1 + reply + prompt_of(4, 12)
    assert run(engine, [engine.submit(turn2, 5)]) == jax_streams(
        [turn2], 5)
    assert counter('skytpu_engine_prefix_cache_hits_total') == 1
    # 16 + 9 tokens -> 24 of them have KV written: 3 full pages.
    assert counter('skytpu_engine_prefix_cache_tokens_total') == 24


# ----- allocator invariants --------------------------------------------------
def test_paged_invariants_through_churn(ref):
    """Deterministic churn (mixed admissions, retires, hits) holds the
    allocator invariants at every synchronous step."""
    _, _, model, _ = ref
    engine = make_engine(model, kv_pages=24)
    shared = prompt_of(12, 13)
    reqs = []
    for i in range(6):
        reqs.append(engine.submit(shared + [i + 1], 4))
        reqs.append(engine.submit(prompt_of(5 + i, 20 + i), 4))
        for _ in range(4):
            engine.step()
            assert_page_invariants(engine)
    outs = run(engine, reqs)
    assert_page_invariants(engine)
    assert all(len(out) == 4 for out in outs)
    # Every slot retired: tables point at trash, nothing live is held.
    assert (engine._page_tables == TRASH_PAGE).all()


def test_paged_eviction_refcount_soak(ref):
    """Seeded admit/finish/evict churn on an under-provisioned pool:
    every request completes with its full budget, the invariants hold
    every round, and evictions actually happen."""
    _, _, model, _ = ref
    rng = np.random.default_rng(3)
    engine = make_engine(model, n_slots=4, kv_pages=24, steps_per_call=2)
    shared = [prompt_of(16, 30), prompt_of(24, 31)]
    live, done = [], []
    for _ in range(30):
        if rng.random() < 0.7:
            if rng.random() < 0.5:
                base = shared[int(rng.integers(len(shared)))]
                prompt = base + rng.integers(1, CFG_T.vocab_size,
                                             3).tolist()
            else:
                prompt = rng.integers(1, CFG_T.vocab_size, int(
                    rng.integers(4, 40))).tolist()
            live.append(engine.submit(prompt, int(rng.integers(2, 8))))
        for _ in range(int(rng.integers(1, 4))):
            engine.step_pipelined()
        assert_page_invariants(engine)
        done += [r for r in live if r.finished_at is not None]
        live = [r for r in live if r.finished_at is None]
    outs = [r.tokens() for r in done] + run(engine, live,
                                            step='step_pipelined')
    assert_page_invariants(engine)
    assert [len(out) for out in outs] == [r.max_new_tokens
                                          for r in done + live]
    assert counter('skytpu_engine_prefix_cache_evicted_pages_total') > 0


# ----- one fetch per step ----------------------------------------------------
def test_paged_one_fetch_per_step(ref, monkeypatch):
    """Paging adds no device->host fetch: tables ship host->device and
    all bookkeeping is host state, so `.cpu()` fires once per active
    step (prefix hits, gathers and paged inserts included) and nothing
    calls `.item()` or `.tolist()`."""
    _, _, model, _ = ref
    engine = make_engine(model)
    shared = prompt_of(20, 14)
    counting = CountingFetch(monkeypatch)
    active = 0
    for prompt in (shared + [5], shared + [6, 7]):   # the second hits
        req = engine.submit(prompt, 4)
        while req.finished_at is None:
            active += engine.step() > 0
        assert req.tokens()
    assert counting.cpu == active and counting.hidden == 0
    assert counter('skytpu_engine_prefix_cache_hits_total') == 1


# ----- config validation -----------------------------------------------------
@pytest.mark.parametrize('kw', [
    dict(n_slots=0),
    dict(prefill_buckets=(8, 12), kv_page_size=8),
    dict(prefill_buckets=(12, 24), kv_page_size=12),
    dict(kv_page_size=-4),
    dict(kv_page_size=8, kv_pages=16),
], ids=['n_slots', 'bucket', 'max_seq_len', 'negative', 'pool_floor'])
def test_config_validation_gives_jax_messages(ref, kw):
    model_j, params_j, model, _ = ref
    with pytest.raises(ValueError) as want:
        jax_engine.DecodeEngine(model_j, params_j,
                                jax_engine.EngineConfig(**kw))
    with pytest.raises(ValueError) as got:
        torch_engine.DecodeEngine(model, torch_engine.EngineConfig(**kw),
                                  device='cpu')
    assert str(got.value) == str(want.value)


def test_config_fields_equal_jax(ref):
    """The port's EngineConfig has the JAX engine's fields (mesh
    included: tests/test_torch_sharded.py serves it); the pool floor is
    accepted."""
    _, _, model, _ = ref
    names = [f.name for f in dataclasses.fields(torch_engine.EngineConfig)]
    assert names == [f.name for f in
                     dataclasses.fields(jax_engine.EngineConfig)]
    engine = make_engine(model, kv_pages=17)                # floor: ok
    assert engine._pool_alloc.n_pages == 17
    full = make_engine(model)
    assert full._pool_alloc.n_pages == 2 * 128 // PS + 1
    assert full._cache[0][0].shape == (17 * 2 - 1, CFG_T.n_kv_heads, PS,
                                       CFG_T.head_dim)


# ----- HTTP server -----------------------------------------------------------
def test_http_server_with_kv_page_size(ref, monkeypatch):
    """`python -m skypilot_tpu_torch.inference.server --kv-page-size 16`
    builds a paged, prefix-cached engine from its flags and serves it:
    two requests sharing a prefix, the second a hit."""
    served = {}

    def fake_run_app(app, port, print=None):  # noqa: A002
        del port, print

        async def drive():
            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                shared = list(range(1, 21))
                for tail in (30, 31):
                    resp = await client.post(
                        '/v1/completions',
                        json={'prompt_ids': shared + [tail],
                              'max_tokens': 4})
                    assert resp.status == 200
                    served.setdefault('ids', []).append(
                        (await resp.json())['ids'])
                health = await client.get('/health')
                served['health'] = await health.json()
            finally:
                await client.close()

        loop = asyncio.new_event_loop()
        try:
            loop.run_until_complete(drive())
        finally:
            loop.close()

    monkeypatch.setattr(torch_server.web, 'run_app', fake_run_app)
    monkeypatch.setattr(sys, 'argv', [
        'server', '--model', 'tiny', '--device', 'cpu', '--max-seq-len',
        '64', '--n-slots', '2', '--kv-page-size', '16', '--kv-pages', '9'])
    torch_server.main()
    assert [len(ids) for ids in served['ids']] == [4, 4]
    assert served['health'] == {'status': 'ok', 'role': 'monolithic'}
    assert counter('skytpu_engine_prefix_cache_hits_total') == 1
    assert counter('skytpu_engine_kv_free_pages') >= 0
