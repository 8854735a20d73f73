"""Port HTTP server over the port engine (aiohttp test client): health,
completions by text and by ids (ids equal to the JAX server's on the same
weights), the 413 admission limit, the TTFT histogram on /metrics, and
the request-id / backlog headers."""
import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from flax.core import meta

from skypilot_tpu.inference import engine as jax_engine
from skypilot_tpu.inference import server as jax_server
from skypilot_tpu.models import llama as jl
from skypilot_tpu_torch.inference import engine as torch_engine
from skypilot_tpu_torch.inference import server as torch_server
from skypilot_tpu_torch.models import llama as tl
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.server import tracing

torch.set_num_threads(1)

# f32 compute on both sides so the greedy ids do not hinge on bf16 ties.
CFG_J = dataclasses.replace(jl.LLAMA_CONFIGS['tiny'], dtype=jnp.float32)
CFG_T = dataclasses.replace(tl.LLAMA_CONFIGS['tiny'], dtype=torch.float32,
                            max_seq_len=64)
ENGINE_KW = dict(n_slots=2, prefill_buckets=(8, 16), steps_per_call=4,
                 max_prompt_len=32)
PROMPT_IDS = [5, 17, 3, 42, 9, 200, 1]


@pytest.fixture(scope='module')
def params():
    model_j = jl.Llama(CFG_J)
    params_j = meta.unbox(jax.jit(model_j.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))['params'])
    return model_j, params_j


def _serve(app, drive):
    async def run():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await drive(client)
        finally:
            await client.close()

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(run())
    finally:
        loop.close()


def _jax_ids(params):
    model_j, params_j = params
    engine = jax_engine.DecodeEngine(
        model_j, params_j,
        jax_engine.EngineConfig(n_slots=1, prefill_buckets=(8,),
                                steps_per_call=4))
    engine.start()

    async def drive(client):
        r = await client.post('/v1/completions',
                              json={'prompt_ids': PROMPT_IDS,
                                    'max_tokens': 6})
        assert r.status == 200
        return (await r.json())['ids']

    try:
        return _serve(jax_server.build_app(engine), drive)
    finally:
        engine.stop()


def test_torch_server_routes(params):
    params_t = params_from_jax(jax.tree.map(np.asarray, params[1]))
    engine = torch_engine.DecodeEngine(
        tl.Llama(CFG_T, params_t), torch_engine.EngineConfig(**ENGINE_KW),
        device='cpu')
    engine.start()

    async def drive(client):
        got = {}
        r = await client.get('/health')
        assert r.status == 200 and (await r.json())['status'] == 'ok'
        r = await client.post('/v1/completions',
                              json={'prompt': 'hi', 'max_tokens': 4},
                              headers={tracing.TRACE_HEADER: 'req-abc'})
        assert r.status == 200
        assert r.headers[tracing.TRACE_HEADER] == 'req-abc'
        assert int(r.headers[torch_server.BACKLOG_HEADER]) >= 0
        body = await r.json()
        assert len(body['ids']) == 4 and body['request_id'] == 'req-abc'
        assert body['usage']['prompt_tokens'] == 2
        assert body['usage']['ttft_ms'] is not None
        r = await client.post('/v1/completions',
                              json={'prompt_ids': PROMPT_IDS,
                                    'max_tokens': 6})
        assert r.status == 200 and r.headers[tracing.TRACE_HEADER]
        got['ids'] = (await r.json())['ids']
        # Longer than the largest bucket: admitted via chunked prefill.
        r = await client.post('/v1/completions',
                              json={'prompt_ids': list(range(1, 30)),
                                    'max_tokens': 3})
        assert r.status == 200 and len((await r.json())['ids']) == 3
        r = await client.post('/v1/completions',
                              json={'prompt_ids': list(range(40)),
                                    'max_tokens': 2})
        assert r.status == 413
        assert (await r.json())['max_prompt_len'] == 32
        r = await client.post('/v1/completions', json={'bogus': 1})
        assert r.status == 400
        text = await (await client.get('/metrics')).text()
        assert 'skytpu_engine_ttft_seconds_count' in text
        r = await client.get('/debug/requests/req-abc')
        assert r.status == 200
        names = {e['name'] for e in (await r.json())['events']}
        assert {'engine.prefill', 'engine.first_token'} <= names
        return got

    try:
        got = _serve(torch_server.build_app(engine), drive)
    finally:
        engine.stop()
    assert got['ids'] == _jax_ids(params)


def test_torch_server_health_reports_crash(params):
    params_t = params_from_jax(jax.tree.map(np.asarray, params[1]))
    engine = torch_engine.DecodeEngine(
        tl.Llama(CFG_T, params_t), torch_engine.EngineConfig(**ENGINE_KW),
        device='cpu')
    engine._decode = None
    engine.start()

    async def drive(client):
        r = await client.post('/v1/completions',
                              json={'prompt_ids': [1, 2], 'max_tokens': 2})
        assert r.status == 200 and (await r.json())['ids'] == []
        r = await client.get('/health')
        assert r.status == 503 and (await r.json())['status'] == 'error'

    try:
        _serve(torch_server.build_app(engine), drive)
    finally:
        engine.stop()
