"""HTTP completions server over the decode engine (PyTorch port).

Twin of `skypilot_tpu/inference/server.py`.  Routes:

- GET  /health        -> 200 while the engine loop is healthy, 503 with
                         the error once it crashed; both carry the role.
- GET  /metrics       -> Prometheus exposition: engine TTFT /
                         inter-token-latency histograms, token counters,
                         occupancy/queue gauges, the paging, prefix-cache,
                         speculation and handoff counters.
- POST /v1/completions  {"prompt": "...", "max_tokens": N} or
                        {"prompt_ids": [...], "max_tokens": N}
                        -> {"ids": [...], "text": "...", "usage": {...}}
                        Prompts longer than the largest prefill bucket
                        are admitted via chunked prefill (up to
                        max_prompt_len, default max_seq_len - 1); a
                        prompt beyond that limit gets 413 with the limit
                        in the body.
- POST /v1/kv_adopt     Disaggregated serving: a prefill replica's
                        KV-handoff payload (inference/kv_transfer.py
                        format, the JAX server's byte for byte).  The
                        engine adopts the pages and decodes; the reply
                        is the /v1/completions JSON, so the prefill
                        replica relays it verbatim.
- GET  /debug/requests        -> flight-recorder summaries.
- GET  /debug/requests/<id>   -> one request's span events + TTFT
                         decomposition (`?format=chrome` for Perfetto).
- GET  /debug/profile?duration_ms=N  -> a torch.profiler window of N ms
                         (default 500) over the whole process, the
                         engine's kernels and graph replays included;
                         the reply names the gzipped chrome trace
                         (perf/profiler.py).  400 for a duration that is
                         not a positive number, 409 while another capture
                         (or a CUDA graph capture) holds the profiler.
- GET  /debug/profile/artifact/<path> -> that trace, while retained
                         (SKYTPU_PROFILE_RETAIN, under SKYTPU_PROFILE_DIR
                         or a private tmpdir removed at shutdown); 404
                         for a missing file or a path leaving the store.

Roles (`--role`, env SKYTPU_SERVE_ROLE): `monolithic` (default) serves
each request end to end.  A `prefill` replica, when the serve LB stamps
X-Skytpu-Decode-Url with decode candidates, runs only the prefill and
PUSHES the paged KV + first token to the first candidate that accepts
(bounded timeout; a dead candidate fails over to the next with the same
payload); if every candidate fails it serves the request monolithically
(the re-prefill hits its own prefix cache).  A `decode` replica accepts
/v1/kv_adopt.  Both roles run the full engine.

Every response carries `X-Skytpu-Queued-Prefill-Tokens` (the engine's
queued-prefill-token backlog) and `X-Skytpu-Request-Id` (honored from the
request, minted otherwise), which keys the request's span events.

Text prompts use a byte-level tokenizer (token id = byte value); real
deployments pass `prompt_ids` from their own tokenizer.

Weights: `--checkpoint DIR` restores the latest step a port trainer
saved there (inference/weights.py), cast to `--param-dtype`; DIR may be
a `gs://bucket/prefix`, fetched to a temp directory that is removed
after the load.  Without it the replica serves random weights from
`--seed`.

Tensor parallelism: `--tensor N` (env SKYTPU_SERVE_TENSOR, which a serve
spec's `tensor_parallel` sets) serves one replica over N ranks, weights
and KV sharded over heads.  This process is rank 0 and serves HTTP; it
spawns ranks 1..N-1 itself (`parallel/group.py`), each building the same
model's slices (from `--seed` or its slices of `--checkpoint`) and
following rank 0's engine.  On CUDA the ranks take cuda:0..N-1 over NCCL,
and a machine with fewer cards exits non-zero; `--device cpu` runs gloo
ranks on the CPU.

Run: python -m skypilot_tpu_torch.inference.server --model llama2-7b \
    --max-seq-len 448 --checkpoint DIR --param-dtype bfloat16 \
    --kv-page-size 64  (on the GPU; --device cpu for a CPU run).
"""
from __future__ import annotations

import argparse
import asyncio
import os
from typing import List, Optional

import aiohttp
from aiohttp import web

from skypilot_tpu_torch import sky_logging
from skypilot_tpu_torch.device import device_of
from skypilot_tpu_torch.inference import kv_transfer
from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
from skypilot_tpu_torch.perf import profiler as profiler_lib
from skypilot_tpu_torch.server import metrics as metrics_lib
from skypilot_tpu_torch.server import tracing

logger = sky_logging.init_logger(__name__)


def encode_bytes(text: str) -> List[int]:
    return list(text.encode('utf-8'))


def decode_bytes(ids: List[int]) -> str:
    return bytes(i for i in ids if 0 <= i < 256).decode('utf-8',
                                                        errors='replace')


# Engine backlog stamped on every response: queued prefill tokens.
BACKLOG_HEADER = metrics_lib.BACKLOG_HEADER


def build_app(engine: DecodeEngine,
              role: str = 'monolithic') -> web.Application:
    # One pooled client session for KV-handoff pushes, created lazily on
    # the app's own event loop and closed with the app.
    _state = {'session': None}

    def _session() -> aiohttp.ClientSession:
        if _state['session'] is None or _state['session'].closed:
            _state['session'] = aiohttp.ClientSession()
        return _state['session']

    async def _close_session(_app):
        if _state['session'] is not None and not _state['session'].closed:
            await _state['session'].close()

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

    # aiohttp's default client_max_size is 1 MiB; a KV-handoff payload is
    # tens to hundreds of MB.
    max_payload = int(os.environ.get('SKYTPU_SERVE_MAX_PAYLOAD_BYTES',
                                     str(2 * 1024 ** 3)))
    app = web.Application(middlewares=[stamp_backlog],
                          client_max_size=max_payload)

    async def health(_request):
        if not engine.healthy:
            return web.json_response(
                {'status': 'error', 'error': repr(engine.error),
                 'role': role}, status=503)
        return web.json_response({'status': 'ok', 'role': role})

    def _completion_json(rid, ids, out, req):
        return {
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
        }

    def _reject_413(rid, ids, e):
        # Admission rejection: the prompt exceeds max_prompt_len.  413,
        # not 400: the request was well-formed, just too large.
        tracing.record_instant(rid, 'server.reject', status=413,
                               prompt_tokens=len(ids),
                               max_prompt_len=engine.max_prompt_len)
        return web.json_response(
            {'error': str(e), 'max_prompt_len': engine.max_prompt_len},
            status=413)

    async def _serve_monolithic(ids, max_tokens, rid):
        try:
            req = engine.submit(ids, max_tokens, request_id=rid)
        except ValueError as e:
            return _reject_413(rid, ids, e)
        out = await asyncio.get_event_loop().run_in_executor(
            None, req.tokens)
        return web.json_response(_completion_json(rid, ids, out, req))

    def _export_payload(req, ids, max_tokens, rid):
        """Executor-thread half of a handoff: the device->host copy of
        the gathered pages plus serialization, never on the event loop
        or the engine loop."""
        exported = engine.export_result(req)
        return kv_transfer.serialize(kv_transfer.KVHandoff(
            prompt_ids=ids,
            first_token=exported['first_token'],
            max_new_tokens=max_tokens,
            page_size=engine.cfg.kv_page_size,
            leaves=exported['leaves'],
            request_id=rid))

    async def _serve_prefill_handoff(ids, max_tokens, rid, targets):
        """Prefill role: run the prefill locally, push the KV pages +
        first token to a decode candidate, relay its completion.  Every
        failure falls back one level: next candidate, then monolithic
        serving on this replica."""
        loop = asyncio.get_event_loop()
        try:
            req = engine.submit_prefill(ids, max_tokens, request_id=rid)
        except ValueError as e:
            return _reject_413(rid, ids, e)
        await loop.run_in_executor(None, req.tokens)
        if req.kv_export is None:
            # Engine died mid-prefill; serve the error like any other.
            return web.json_response(
                {'error': f'prefill failed: {engine.error!r}'},
                status=503)
        payload = await loop.run_in_executor(
            None, _export_payload, req, ids, max_tokens, rid)
        body, url = await kv_transfer.push(_session(), targets, payload,
                                           request_id=rid)
        if body is not None:
            body['request_id'] = rid
            body['disaggregated'] = True
            body['decode_url'] = url
            return web.json_response(body)
        logger.warning(f'every decode candidate failed for {rid}; '
                       f'serving monolithically')
        return await _serve_monolithic(ids, max_tokens, rid)

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
        targets = kv_transfer.parse_decode_targets(
            request.headers.get(kv_transfer.DECODE_URL_HEADER))
        if role == 'prefill' and targets and engine.cfg.kv_page_size:
            return await _serve_prefill_handoff(ids, max_tokens, rid,
                                                targets)
        return await _serve_monolithic(ids, max_tokens, rid)

    async def kv_adopt(request):
        """Decode role: adopt a prefill replica's KV handoff and decode
        it to completion; the reply is the completions JSON."""
        raw = await request.read()
        rid = request['skytpu_request_id']
        try:
            handoff = kv_transfer.deserialize(raw)
        except ValueError as e:
            return web.json_response({'error': str(e)}, status=400)
        try:
            req = engine.submit_adopt(
                handoff.prompt_ids, handoff.first_token, handoff.leaves,
                handoff.max_new_tokens, request_id=rid,
                page_size=handoff.page_size)
        except ValueError as e:
            # Geometry mismatch (page size/count/shape): 422 tells the
            # pusher to try another replica.
            return web.json_response({'error': str(e)}, status=422)
        except RuntimeError as e:
            return web.json_response({'error': str(e)}, status=503)
        out = await asyncio.get_event_loop().run_in_executor(
            None, req.tokens)
        return web.json_response(
            _completion_json(rid, handoff.prompt_ids, out, req))

    async def metrics_route(_request):
        return web.Response(text=metrics_lib.render(),
                            content_type='text/plain')

    # On-demand profiler capture (perf/profiler.py): artifacts live
    # under a retention-bounded store, wholly removed at shutdown so
    # long-lived replicas never grow disk without bound.
    profile_store = profiler_lib.ProfileStore()

    async def debug_profile(request):
        try:
            duration_ms = float(request.query.get('duration_ms', '500'))
        except ValueError:
            return web.json_response(
                {'error': 'duration_ms must be a number'}, status=400)
        if not duration_ms > 0:
            return web.json_response(
                {'error': 'duration_ms must be positive'}, status=400)
        rid = request['skytpu_request_id']
        loop = asyncio.get_event_loop()
        try:
            # Executor thread: capture() sleeps for the whole window.
            summary = await loop.run_in_executor(
                None, profile_store.capture, duration_ms, rid)
        except profiler_lib.CaptureBusy as e:
            return web.json_response({'error': str(e)}, status=409)
        summary['role'] = role
        return web.json_response(summary)

    async def debug_profile_artifact(request):
        try:
            path = profile_store.artifact_path(
                request.match_info['tail'])
        except (ValueError, FileNotFoundError) as e:
            return web.json_response({'error': str(e)}, status=404)
        return web.FileResponse(path)

    async def _cleanup_profiles(_app):
        profile_store.cleanup()

    debug_requests, debug_request = tracing.make_debug_handlers()

    app.router.add_get('/health', health)
    app.router.add_get('/metrics', metrics_route)
    app.router.add_get('/debug/requests', debug_requests)
    app.router.add_get('/debug/requests/{request_id}', debug_request)
    app.router.add_get('/debug/profile', debug_profile)
    app.router.add_get('/debug/profile/artifact/{tail:.+}',
                       debug_profile_artifact)
    app.router.add_post('/v1/completions', completions)
    app.router.add_post(kv_transfer.ADOPT_ROUTE, kv_adopt)
    app.on_cleanup.append(_close_session)
    app.on_cleanup.append(_cleanup_profiles)
    # Tests and embedders reach the store for retention assertions.
    app['skytpu_profile_store'] = profile_store
    return app


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """The server's flags (`argv` None: the command line)."""
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
    parser.add_argument(
        '--tensor', type=int,
        default=int(os.environ.get('SKYTPU_SERVE_TENSOR', '1')),
        help='tensor-parallel degree: shard weights and KV cache over '
        'this many ranks (must divide the model\'s head counts; 1 = one '
        'device).  On CUDA it needs that many cards (cuda:0..N-1, NCCL); '
        'with --device cpu the ranks are gloo processes on the CPU.  '
        'Serve specs set it via service.tensor_parallel, which arrives '
        'here as SKYTPU_SERVE_TENSOR.')
    parser.add_argument(
        '--kv-page-size', type=int,
        default=int(os.environ.get('SKYTPU_SERVE_KV_PAGE_SIZE', '0')),
        help='paged KV cache: page size in tokens (must divide every '
        'prefill bucket and max_seq_len).  Admission then charges pages '
        'instead of reserving n_slots x max_seq_len, and shared prompt '
        'prefixes are prefilled once (--prefix-cache).  0 = the '
        'contiguous layout.  Env SKYTPU_SERVE_KV_PAGE_SIZE.')
    parser.add_argument(
        '--kv-pages', type=int,
        default=int(os.environ.get('SKYTPU_SERVE_KV_PAGES', '0')),
        help='page-pool size (with --kv-page-size).  0 = full backing '
        '(n_slots x max_seq_len / page_size).  Env '
        'SKYTPU_SERVE_KV_PAGES.')
    parser.add_argument(
        '--prefix-cache', type=int, choices=(0, 1),
        default=int(os.environ.get('SKYTPU_SERVE_PREFIX_CACHE', '1')),
        help='radix prefix cache over the paged KV pool (needs '
        '--kv-page-size).  Env SKYTPU_SERVE_PREFIX_CACHE.')
    parser.add_argument(
        '--kv-dtype', choices=('bf16', 'int8'),
        default=os.environ.get('SKYTPU_SERVE_KV_DTYPE', 'bf16'),
        help='KV-page storage dtype (needs --kv-page-size); int8 '
        'quantizes pages at scatter time.  Env SKYTPU_SERVE_KV_DTYPE.')
    parser.add_argument(
        '--spec-ngram', type=int,
        default=int(os.environ.get('SKYTPU_SERVE_SPEC_NGRAM', '0')),
        help='self-speculative n-gram decoding: draft length k per '
        'verify step (needs --kv-page-size; 0 = off).  Env '
        'SKYTPU_SERVE_SPEC_NGRAM.')
    parser.add_argument(
        '--role', choices=('monolithic', 'prefill', 'decode'),
        default=os.environ.get('SKYTPU_SERVE_ROLE', 'monolithic'),
        help='disaggregated serving role (requires --kv-page-size: pages '
        'are the KV-transfer unit).  `prefill` replicas push the paged '
        'KV + first token to a decode candidate named by '
        'X-Skytpu-Decode-Url; `decode` replicas accept /v1/kv_adopt.  '
        'Env SKYTPU_SERVE_ROLE.')
    parser.add_argument('--device', default='cuda',
                        help='torch device to serve on (cuda or cpu)')
    parser.add_argument('--seed', type=int, default=0,
                        help='seed of the random weights')
    parser.add_argument(
        '--checkpoint', default=None,
        help='checkpoint directory written by the port\'s '
        'train/checkpoint.py (step_<n>/state.pt; a local path or '
        'gs://bucket/prefix): restores trained params (the latest step) '
        'instead of random init')
    parser.add_argument(
        '--param-dtype', choices=['float32', 'bfloat16'], default=None,
        help='dtype the params are held in (restored params are cast; '
        'random ones made in it).  bfloat16 halves device memory.  '
        'Default: the model config\'s (float32)')
    args = parser.parse_args(argv)
    if args.max_prompt_len < 0:
        # A negative cap would 413 every request while /health stays
        # green: refuse at startup instead of serving a dead replica.
        parser.error(f'--max-prompt-len must be >= 0, '
                     f'got {args.max_prompt_len}')
    if args.tensor < 1:
        parser.error(f'--tensor must be >= 1, got {args.tensor}')
    return args


def model_config(args: argparse.Namespace):
    """`args.model`'s config at `--max-seq-len` and `--param-dtype`."""
    import dataclasses

    import torch

    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS

    cfg = dataclasses.replace(LLAMA_CONFIGS[args.model],
                              max_seq_len=args.max_seq_len)
    if args.param_dtype:
        cfg = dataclasses.replace(cfg,
                                  param_dtype=getattr(torch, args.param_dtype))
    return cfg


def build_model(args: argparse.Namespace, mesh=None):
    """The served model: `args.model` at `--max-seq-len`, its params
    restored from `--checkpoint` (the latest step) or, without one,
    random from `--seed`, held in `--param-dtype`, on `--device` (under a
    `mesh`: this rank's slices, on its device)."""
    import torch

    from skypilot_tpu_torch.device import resolve_device
    from skypilot_tpu_torch.inference.weights import load_serving_params
    from skypilot_tpu_torch.models.llama import Llama, init_params

    device = resolve_device(args.device if mesh is None else mesh.device)
    cfg = model_config(args)
    if args.checkpoint:
        params = load_serving_params(args.checkpoint, dtype=cfg.param_dtype,
                                     device=device, mesh=mesh)
    else:
        logger.warning('no --checkpoint given: serving RANDOM-INIT params '
                       '(demo mode)')
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = init_params(cfg, device, gen, mesh=mesh)
    return Llama(cfg, params, mesh)


def _mesh_devices(args: argparse.Namespace):
    """(devices, backend) of `--tensor` ranks on `--device`: the CPU over
    gloo, else cuda:0..N-1 over NCCL; exits when the machine has fewer
    cards than ranks, or the model's heads do not split N ways."""
    import torch

    from skypilot_tpu_torch.parallel import mesh as mesh_lib

    cfg = model_config(args)
    try:
        mesh_lib.plan_serve_mesh(args.tensor, tensor=args.tensor,
                                 n_heads=cfg.n_heads,
                                 n_kv_heads=cfg.n_kv_heads)
    except ValueError as e:
        raise SystemExit(f'--tensor {args.tensor}: {e}') from None
    if torch.device(args.device).type == 'cpu':
        return ['cpu'] * args.tensor, 'gloo'
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < args.tensor:
        raise SystemExit(
            f'--tensor {args.tensor} needs {args.tensor} CUDA devices (one '
            f'rank per card, NCCL); this machine has {n_cards}')
    return [f'cuda:{i}' for i in range(args.tensor)], 'nccl'


def _serve_mesh(args: argparse.Namespace, devices, backend):
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    cfg = model_config(args)
    return mesh_lib.build_serve_mesh(args.tensor, n_heads=cfg.n_heads,
                                     n_kv_heads=cfg.n_kv_heads,
                                     devices=devices, backend=backend)


def engine_config(args: argparse.Namespace, mesh=None) -> EngineConfig:
    paged = bool(args.kv_page_size)
    return EngineConfig(n_slots=args.n_slots, mesh=mesh,
                        max_prompt_len=args.max_prompt_len or None,
                        kv_page_size=args.kv_page_size or None,
                        kv_pages=args.kv_pages or None,
                        prefix_cache=bool(args.prefix_cache),
                        kv_dtype=args.kv_dtype if paged else 'bf16',
                        speculation=args.spec_ngram if paged else 0)


def _follower(argv: List[str], devices, backend) -> None:
    """Ranks 1..N-1 of a `--tensor N` replica: the same model's slices
    and engine, following rank 0's until it closes."""
    args = parse_args(argv)
    mesh = _serve_mesh(args, devices, backend)
    engine = DecodeEngine(build_model(args, mesh), engine_config(args, mesh))
    engine.follow()


def main(argv: Optional[List[str]] = None) -> None:
    import sys

    from skypilot_tpu_torch.parallel import group as group_lib

    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    followers = mesh = None
    if args.tensor > 1:
        devices, backend = _mesh_devices(args)
        followers = group_lib.Followers(args.tensor, backend, _follower,
                                        (argv, devices, backend))
        mesh = _serve_mesh(args, devices, backend)
    try:
        _serve(args, mesh)
    finally:
        if followers is not None:
            followers.close()


def _serve(args: argparse.Namespace, mesh) -> None:
    model = build_model(args, mesh)
    device = device_of(model)
    paged = bool(args.kv_page_size)
    engine = DecodeEngine(model, engine_config(args, mesh), device=device)
    engine.prewarm()
    engine.start()
    if args.role != 'monolithic' and not paged:
        # A roled replica without paging cannot hand KV off; serve
        # monolithically rather than advertise a capability it lacks.
        logger.warning(f'--role {args.role} requires --kv-page-size; '
                       f'serving monolithically')
        args.role = 'monolithic'
    logger.info(f'serving {args.model} on :{args.port} '
                f'({args.n_slots} slots, device={device}, '
                f'role={args.role}, '
                f'kv_page_size={args.kv_page_size or "off"}, '
                f'prefix_cache={bool(args.prefix_cache and paged)}, '
                f'kv_dtype={args.kv_dtype if paged else "bf16"}, '
                f'speculation={args.spec_ngram if paged else 0}, '
                f'tensor={args.tensor})')
    try:
        web.run_app(build_app(engine, role=args.role), port=args.port,
                    print=None)
    finally:
        engine.close()


if __name__ == '__main__':
    main()
