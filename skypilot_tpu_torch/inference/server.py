"""HTTP completions server over the decode engine (PyTorch port).

Twin of `skypilot_tpu/inference/server.py`, monolithic role.  Routes:

- GET  /health        -> 200 while the engine loop is healthy, 503 with
                         the error once it crashed.
- GET  /metrics       -> Prometheus exposition: engine TTFT /
                         inter-token-latency histograms, token counters,
                         occupancy/queue gauges.
- POST /v1/completions  {"prompt": "...", "max_tokens": N} or
                        {"prompt_ids": [...], "max_tokens": N}
                        -> {"ids": [...], "text": "...", "usage": {...}}
                        Prompts longer than the largest prefill bucket
                        are admitted via chunked prefill (up to
                        max_prompt_len, default max_seq_len - 1); a
                        prompt beyond that limit gets 413 with the limit
                        in the body.
- GET  /debug/requests        -> flight-recorder summaries.
- GET  /debug/requests/<id>   -> one request's span events + TTFT
                         decomposition (`?format=chrome` for Perfetto).

Every response carries `X-Skytpu-Queued-Prefill-Tokens` (the engine's
queued-prefill-token backlog) and `X-Skytpu-Request-Id` (honored from the
request, minted otherwise), which keys the request's span events.

Text prompts use a byte-level tokenizer (token id = byte value); real
deployments pass `prompt_ids` from their own tokenizer.

Run: python -m skypilot_tpu_torch.inference.server --model llama2-7b \
    --max-seq-len 448  (on the GPU; --device cpu for a CPU run).
"""
from __future__ import annotations

import argparse
import asyncio
import os
from typing import List

from aiohttp import web

from skypilot_tpu_torch import sky_logging
from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from skypilot_tpu_torch.server import metrics as metrics_lib
from skypilot_tpu_torch.server import tracing

logger = sky_logging.init_logger(__name__)

ROLE = 'monolithic'


def encode_bytes(text: str) -> List[int]:
    return list(text.encode('utf-8'))


def decode_bytes(ids: List[int]) -> str:
    return bytes(i for i in ids if 0 <= i < 256).decode('utf-8',
                                                        errors='replace')


# Engine backlog stamped on every response: queued prefill tokens.
BACKLOG_HEADER = metrics_lib.BACKLOG_HEADER


def build_app(engine: DecodeEngine) -> web.Application:

    @web.middleware
    async def stamp_backlog(request: web.Request, handler):
        # Honor the caller's request id or mint one here; stamped on the
        # response so the client always learns the id.
        rid = request.headers.get(tracing.TRACE_HEADER) or \
            tracing.mint_request_id()
        request['skytpu_request_id'] = rid
        resp = await handler(request)
        resp.headers[BACKLOG_HEADER] = str(engine.queued_prefill_tokens)
        resp.headers[tracing.TRACE_HEADER] = rid
        return resp

    app = web.Application(middlewares=[stamp_backlog])

    async def health(_request):
        if not engine.healthy:
            return web.json_response(
                {'status': 'error', 'error': repr(engine.error),
                 'role': ROLE}, status=503)
        return web.json_response({'status': 'ok', 'role': ROLE})

    async def completions(request):
        try:
            body = await request.json()
        except Exception:  # pylint: disable=broad-except
            return web.json_response({'error': 'invalid JSON'}, status=400)
        ids = body.get('prompt_ids')
        if ids is None:
            prompt = body.get('prompt')
            if not isinstance(prompt, str):
                return web.json_response(
                    {'error': 'need "prompt" or "prompt_ids"'}, status=400)
            ids = encode_bytes(prompt)
        max_tokens = int(body.get('max_tokens', 64))
        rid = request['skytpu_request_id']
        try:
            req = engine.submit(ids, max_tokens, request_id=rid)
        except ValueError as e:
            # Admission rejection: the prompt exceeds max_prompt_len.  413,
            # not 400: the request was well-formed, just too large.
            tracing.record_instant(rid, 'server.reject', status=413,
                                   prompt_tokens=len(ids),
                                   max_prompt_len=engine.max_prompt_len)
            return web.json_response(
                {'error': str(e),
                 'max_prompt_len': engine.max_prompt_len}, status=413)
        out = await asyncio.get_event_loop().run_in_executor(
            None, req.tokens)
        return web.json_response({
            'ids': out,
            'text': decode_bytes(out),
            'request_id': rid,
            'usage': {
                'prompt_tokens': len(ids),
                'completion_tokens': len(out),
                'ttft_ms': round(
                    (req.first_token_at - req.submitted_at) * 1e3, 2)
                if req.first_token_at else None,
            },
        })

    async def metrics_route(_request):
        return web.Response(text=metrics_lib.render(),
                            content_type='text/plain')

    debug_requests, debug_request = tracing.make_debug_handlers()

    app.router.add_get('/health', health)
    app.router.add_get('/metrics', metrics_route)
    app.router.add_get('/debug/requests', debug_requests)
    app.router.add_get('/debug/requests/{request_id}', debug_request)
    app.router.add_post('/v1/completions', completions)
    return app


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', default='bench-600m')
    parser.add_argument('--port', type=int,
                        default=int(os.environ.get(
                            'SKYTPU_SERVE_REPLICA_PORT', '8200')))
    parser.add_argument('--n-slots', type=int, default=8)
    parser.add_argument('--max-seq-len', type=int, default=1024)
    parser.add_argument(
        '--max-prompt-len', type=int,
        default=int(os.environ.get('SKYTPU_SERVE_MAX_PROMPT_LEN', '0')),
        help='longest admissible prompt in tokens (0 = model limit, '
        'max_seq_len - 1).  Prompts beyond the largest prefill bucket '
        'are chunked and interleaved with decode.')
    parser.add_argument('--device', default='cuda',
                        help='torch device to serve on (cuda or cpu)')
    parser.add_argument('--seed', type=int, default=0,
                        help='seed of the random weights')
    args = parser.parse_args()
    if args.max_prompt_len < 0:
        # A negative cap would 413 every request while /health stays
        # green: refuse at startup instead of serving a dead replica.
        parser.error(f'--max-prompt-len must be >= 0, '
                     f'got {args.max_prompt_len}')

    import dataclasses

    import torch

    from skypilot_tpu_torch.device import resolve_device
    from skypilot_tpu_torch.models.llama import (LLAMA_CONFIGS, Llama,
                                                 init_params)

    device = resolve_device(args.device)
    cfg = dataclasses.replace(LLAMA_CONFIGS[args.model],
                              max_seq_len=args.max_seq_len)
    logger.warning('serving RANDOM-INIT params (demo mode; checkpoint '
                   'loading comes with a later slice)')
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = Llama(cfg, init_params(cfg, device, gen))
    engine = DecodeEngine(
        model,
        EngineConfig(n_slots=args.n_slots,
                     max_prompt_len=args.max_prompt_len or None),
        device=device)
    engine.prewarm()
    engine.start()
    logger.info(f'serving {args.model} on :{args.port} '
                f'({args.n_slots} slots, device={device})')
    try:
        web.run_app(build_app(engine), port=args.port, print=None)
    finally:
        engine.stop()


if __name__ == '__main__':
    main()
