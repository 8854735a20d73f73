"""Disaggregated prefill/decode of the port: the KV handoff within the
port and ACROSS the two packages (mirrors tests/test_serve_disagg.py).

Parity contract: a request prefilled on one engine and decoded on
another (its pages exported, serialized, deserialized and adopted, never
recomputed) emits the monolithic stream exactly, port to port and in
both directions between the JAX engine and the port's (f32 `tiny`,
weights converted from the Flax tree).  The wire format is the JAX
module's byte for byte (bf16 and int8 leaves), the port exports its
leaves in the JAX cache tree's order (checked at 12 layers, where string
order and numeric order of the layers differ), and payload and geometry
errors carry the JAX messages.  Two in-process port servers push,
fail over and fall back to monolithic serving.
"""
import asyncio
import dataclasses
import socket

import ml_dtypes
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from skypilot_tpu.inference import engine as jax_engine
from skypilot_tpu.inference import kv_transfer as jax_transfer
from skypilot_tpu_torch.inference import engine as torch_engine
from skypilot_tpu_torch.inference import kv_transfer
from skypilot_tpu_torch.inference import server as torch_server
from skypilot_tpu_torch.server import metrics as metrics_lib
from skypilot_tpu_torch.server import tracing

from test_torch_paged import (CFG_J, CFG_T, CountingFetch, ENGINE_KW, PS,
                              counter, jax_params, prompt_of, run,
                              torch_model)

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def ref():
    """(JAX model, params, port model, shared JAX engines by name)."""
    model_j, params_j = jax_params()
    engines = {name: jax_engine.DecodeEngine(
        model_j, params_j, jax_engine.EngineConfig(**ENGINE_KW))
        for name in ('mono', 'prefill', 'decode')}
    return model_j, params_j, torch_model(params_j), engines


@pytest.fixture(autouse=True)
def _reset_metrics():
    metrics_lib.reset_for_tests()
    yield
    metrics_lib.reset_for_tests()


def make_engine(model, **overrides):
    return torch_engine.DecodeEngine(
        model, torch_engine.EngineConfig(**dict(ENGINE_KW, **overrides)),
        device='cpu')


def jax_run(engine, req):
    while req.finished_at is None:
        engine.step()
    return req.tokens()


def mono(engines, prompt, max_new):
    eng = engines['mono']
    return jax_run(eng, eng.submit(prompt, max_new))


def export_port(engine, prompt, max_new, request_id=None):
    """Prefill on a port engine -> (first-token stream, payload)."""
    req = engine.submit_prefill(prompt, max_new, request_id=request_id)
    first = run(engine, [req])[0]
    exported = engine.export_result(req)
    return first, kv_transfer.serialize(kv_transfer.KVHandoff(
        prompt_ids=prompt, first_token=exported['first_token'],
        max_new_tokens=max_new, page_size=PS, leaves=exported['leaves'],
        request_id=request_id))


def adopt_port(engine, payload, request_id=None):
    h = kv_transfer.deserialize(payload)
    req = engine.submit_adopt(h.prompt_ids, h.first_token, h.leaves,
                              h.max_new_tokens, request_id=request_id,
                              page_size=h.page_size)
    return run(engine, [req])[0]


# ----- greedy parity ----------------------------------------------------------
@pytest.mark.parametrize('plen', [7, 13, 16, 40])
def test_handoff_parity_port_to_port(ref, plen):
    """Fused-bucket, partial-page, page-aligned and CHUNKED prompts:
    prefill on A + decode on B equals the monolithic JAX stream, and A's
    sampled first token heads it."""
    _, _, model, engines = ref
    prompt = prompt_of(plen, 200 + plen)
    want = mono(engines, prompt, 10)
    first, payload = export_port(make_engine(model), prompt, 10)
    assert first == [want[0]]
    assert adopt_port(make_engine(model), payload) == want
    assert counter('skytpu_engine_kv_exports_total') == 1
    assert counter('skytpu_engine_kv_adopts_total') == 1


def test_handoff_parity_prefix_hit(ref):
    """A prompt that HITS A's radix cache hands off identically: the
    exported pages are the shared ones plus the fresh suffix."""
    _, _, model, engines = ref
    shared = prompt_of(16, 210)
    tails = [prompt_of(5, 211), prompt_of(5, 212)]
    a = make_engine(model)
    run(a, [a.submit(shared + tails[0], 10)])     # publishes the prefix
    _, payload = export_port(a, shared + tails[1], 10)
    assert counter('skytpu_engine_prefix_cache_hits_total') == 1
    assert adopt_port(make_engine(model), payload) == mono(
        engines, shared + tails[1], 10)


@pytest.mark.parametrize('plen', [13, 40])
def test_handoff_jax_prefill_port_decode(ref, plen):
    """A JAX prefill replica's payload adopts into the port's engine and
    decodes the monolithic stream."""
    _, _, model, engines = ref
    prompt = prompt_of(plen, 220 + plen)
    pre = engines['prefill']
    req = pre.submit_prefill(prompt, 9)
    jax_run(pre, req)
    exported = pre.export_result(req)
    payload = jax_transfer.serialize(jax_transfer.KVHandoff(
        prompt_ids=prompt, first_token=exported['first_token'],
        max_new_tokens=9, page_size=PS, leaves=exported['leaves']))
    assert adopt_port(make_engine(model), payload) == mono(engines,
                                                           prompt, 9)


@pytest.mark.parametrize('plen', [13, 40])
def test_handoff_port_prefill_jax_decode(ref, plen):
    """The port's payload adopts into the JAX engine and decodes the
    monolithic stream."""
    _, _, model, engines = ref
    prompt = prompt_of(plen, 230 + plen)
    _, payload = export_port(make_engine(model), prompt, 9)
    h = jax_transfer.deserialize(payload)
    dec = engines['decode']
    req = dec.submit_adopt(h.prompt_ids, h.first_token, h.leaves,
                           h.max_new_tokens, page_size=h.page_size)
    assert jax_run(dec, req) == mono(engines, prompt, 9)


# ----- wire format ------------------------------------------------------------
def _leaves_both(kind):
    """The same leaves as JAX-side numpy and port-side torch tensors."""
    rng = np.random.default_rng(5)
    if kind == 'bf16':
        bits = [rng.integers(0, 1 << 16, (2, 2, PS, 16), dtype=np.uint16)
                for _ in range(4)]
        # Only finite values: NaN bit patterns compare unequal.
        bits = [np.where((b & 0x7f80) == 0x7f80, b & 0x807f, b)
                for b in bits]
        return ([b.view(ml_dtypes.bfloat16) for b in bits],
                [torch.from_numpy(b.view(np.int16)).view(torch.bfloat16)
                 for b in bits])
    arrs = []
    for _ in range(2):
        arrs.append(rng.integers(-127, 128, (2, 2, PS, 16), dtype=np.int8))
        arrs.append(rng.random((2, 2, PS), dtype=np.float32))
    return arrs, [torch.from_numpy(a.copy()) for a in arrs]


@pytest.mark.parametrize('kind', ['bf16', 'int8'])
def test_payload_bytes_identical_across_packages(kind):
    """`serialize` of the same leaves gives the same bytes in both
    packages, and each side parses the other's payload to the same
    leaves."""
    np_leaves, t_leaves = _leaves_both(kind)
    fields = dict(prompt_ids=list(range(1, 14)), first_token=7,
                  max_new_tokens=9, page_size=PS, request_id='wire-1')
    jax_bytes = jax_transfer.serialize(
        jax_transfer.KVHandoff(leaves=np_leaves, **fields))
    port_bytes = kv_transfer.serialize(
        kv_transfer.KVHandoff(leaves=t_leaves, **fields))
    assert port_bytes == jax_bytes
    from_jax = kv_transfer.deserialize(jax_bytes)
    assert [t.dtype for t in from_jax.leaves] == [t.dtype for t in t_leaves]
    for got, want in zip(from_jax.leaves, t_leaves):
        assert torch.equal(got.view(torch.uint8) if got.dtype ==
                           torch.bfloat16 else got,
                           want.view(torch.uint8) if want.dtype ==
                           torch.bfloat16 else want)
    from_port = jax_transfer.deserialize(port_bytes)
    for got, want in zip(from_port.leaves, np_leaves):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8))
    assert from_jax.request_id == from_port.request_id == 'wire-1'


def test_export_leaf_order_matches_jax_at_12_layers():
    """At 12 layers the JAX cache tree flattens layer_0, layer_1,
    layer_10, layer_11, layer_2, ...: each leaf of the port's export is
    close to the same-index leaf of the JAX export of the same weights,
    and far from the leaf of another layer (what a swap would give)."""
    cfg_j = dataclasses.replace(CFG_J, n_layers=12)
    cfg_t = dataclasses.replace(CFG_T, n_layers=12)
    model_j, params_j = jax_params(cfg_j)
    model = torch_model(params_j, cfg_t)
    prompt = prompt_of(13, 240)
    jeng = jax_engine.DecodeEngine(model_j, params_j,
                                   jax_engine.EngineConfig(**ENGINE_KW))
    req = jeng.submit_prefill(prompt, 4)
    jax_run(jeng, req)
    want = [np.asarray(x) for x in jeng.export_result(req)['leaves']]
    teng = make_engine(model)
    req = teng.submit_prefill(prompt, 4)
    run(teng, [req])
    got = [t.numpy() for t in teng.export_result(req)['leaves']]
    assert len(got) == len(want) == 24
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4,
                                   err_msg=f'leaf {i}')
    # Index 4 is layer_10's k in JAX's order; numeric order would put
    # layer_2's k there, which is far off.
    assert not np.allclose(got[4], want[8], atol=1e-2)
    assert not np.allclose(got[0], want[2], atol=1e-2)


def test_payload_integrity_errors_match_jax(ref):
    _, _, model, _ = ref
    _, payload = export_port(make_engine(model), prompt_of(13, 250), 9)
    flipped = bytearray(payload)
    flipped[-1] ^= 0xFF
    versioned = payload.replace(b'"version":1', b'"version":2')
    for bad in (bytes(flipped), payload[:len(payload) - 8],
                b'NOPE' + payload, versioned):
        with pytest.raises(ValueError) as want:
            jax_transfer.deserialize(bad)
        with pytest.raises(ValueError) as got:
            kv_transfer.deserialize(bad)
        assert str(got.value) == str(want.value)
    h = kv_transfer.deserialize(payload)
    assert h.n_kv_pages == 2 and h.page_size == PS


def test_adopt_geometry_errors_match_jax(ref):
    """Page size, page count, leaf count, page shape and dtype mismatches
    are refused at submit with the JAX engine's messages; an unpaged
    engine refuses handoffs both ways."""
    model_j, params_j, model, engines = ref
    jeng, teng = engines['decode'], make_engine(model)
    hd = CFG_T.head_dim
    one = [np.zeros((2, CFG_T.n_kv_heads, PS, hd), np.float32)]
    full = [np.zeros((2,) + tuple(t.shape[1:]), np.float32)
            for t in teng._wire_leaves()]
    wide = [np.zeros((2, CFG_T.n_kv_heads * 2, PS, hd), np.float32)
            for _ in full]
    half = [np.zeros(x.shape, np.float16) for x in full]
    cases = [(prompt_of(13, 1), one, PS * 2),       # page size
             (prompt_of(30, 2), one, PS),           # does not cover
             (prompt_of(13, 3), one, PS),           # leaf count
             (prompt_of(13, 4), wide, PS),          # page shape
             (prompt_of(13, 5), half, PS)]          # dtype
    for prompt, leaves, ps in cases:
        with pytest.raises(ValueError) as want:
            jeng.submit_adopt(prompt, 1, leaves, 8, page_size=ps)
        with pytest.raises(ValueError) as got:
            teng.submit_adopt(prompt, 1, leaves, 8, page_size=ps)
        assert str(got.value) == str(want.value)
    unpaged_j = jax_engine.DecodeEngine(
        model_j, params_j, jax_engine.EngineConfig(n_slots=1))
    unpaged_t = make_engine(model, kv_page_size=None)
    for call in (lambda e: e.submit_adopt(prompt_of(13, 6), 1, one, 8),
                 lambda e: e.submit_prefill(prompt_of(13, 6), 8)):
        with pytest.raises(RuntimeError) as want:
            call(unpaged_j)
        with pytest.raises(RuntimeError) as got:
            call(unpaged_t)
        assert str(got.value) == str(want.value)


# ----- one fetch per step -----------------------------------------------------
def test_one_fetch_per_step_with_handoff(ref, monkeypatch):
    """The export gather is dispatch-only on the loop: its copy to the
    host happens in export_result, on the caller's thread; adopt ships
    host->device only.  One `.cpu()` per active step on both roles."""
    _, _, model, _ = ref
    a, b = make_engine(model), make_engine(model)
    counting = CountingFetch(monkeypatch)
    ra = a.submit_prefill(prompt_of(13, 260), 6)
    a_active = 0
    while ra.finished_at is None:
        a_active += a.step() > 0
    assert counting.cpu == a_active and counting.hidden == 0
    exported = a.export_result(ra)
    assert counting.cpu == a_active + len(exported['leaves'])
    base = counting.cpu
    rb = b.submit_adopt(ra.prompt_ids, exported['first_token'],
                        exported['leaves'], 6)
    b_active = 0
    while rb.finished_at is None:
        b_active += b.step() > 0
    assert counting.cpu - base == b_active and counting.hidden == 0
    with pytest.raises(RuntimeError, match='already consumed'):
        a.export_result(ra)


# ----- two in-process servers -------------------------------------------------
def _dead_url():
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return f'http://127.0.0.1:{sock.getsockname()[1]}'


def test_servers_push_failover_and_fallback(ref):
    """A prefill-role server pushes to a decode-role server: with a dead
    first candidate it fails over to the second (same payload, no
    re-prefill); with every candidate dead it serves monolithically.
    Each way the ids are the monolithic stream."""
    _, _, model, engines = ref
    prompt = prompt_of(13, 270)
    want = mono(engines, prompt, 8)
    pre, dec = make_engine(model), make_engine(model)
    tracing.reset_for_tests()

    async def drive():
        pre_srv = TestServer(torch_server.build_app(pre, role='prefill'))
        dec_srv = TestServer(torch_server.build_app(dec, role='decode'))
        await dec_srv.start_server()
        client = TestClient(pre_srv)
        await client.start_server()
        dec_url = str(dec_srv.make_url('')).rstrip('/')
        dead = _dead_url()
        try:
            health = await (await client.get('/health')).json()
            resp = await client.post(
                '/v1/completions',
                json={'prompt_ids': prompt, 'max_tokens': 8},
                headers={kv_transfer.DECODE_URL_HEADER:
                         f'{dead},{dec_url}',
                         tracing.TRACE_HEADER: 'disagg-1'})
            pushed = await resp.json()
            resp = await client.post(
                '/v1/completions',
                json={'prompt_ids': prompt, 'max_tokens': 8},
                headers={kv_transfer.DECODE_URL_HEADER: dead})
            fallback = await resp.json()
            return health, pushed, fallback, dec_url
        finally:
            await client.close()
            await dec_srv.close()

    pre.start()
    dec.start()
    try:
        loop = asyncio.new_event_loop()
        try:
            health, pushed, fallback, dec_url = loop.run_until_complete(
                drive())
        finally:
            loop.close()
    finally:
        pre.stop()
        dec.stop()
    assert health == {'status': 'ok', 'role': 'prefill'}
    assert pushed['ids'] == want and pushed['disaggregated'] is True
    assert pushed['decode_url'] == dec_url
    assert 'disaggregated' not in fallback
    assert fallback['ids'] == want
    text = metrics_lib.render()
    assert 'skytpu_lb_kv_transfer_total{outcome="error"} 2.0' in text
    assert 'skytpu_lb_kv_transfer_total{outcome="ok"} 1.0' in text
    names = [e['name'] for e in tracing.events_for('disagg-1')]
    for needle in ('engine.kv_export', 'engine.kv_adopt',
                   'engine.first_token'):
        assert needle in names, (needle, names)
