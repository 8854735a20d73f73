#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (skypilot_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. Device: the card's name, and name + power limit from nvidia-smi.
2. Build: nvcc compiles every kernel of the serving path from
   skypilot_tpu_torch/csrc/ for sm_90a into build/skypilot_tpu_torch/;
   ptxas reports registers, shared memory and spills.
3. Kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes (llama2-7b prefill, GQA shapes of
   bench-600m and llama3-1b, a non-causal, a ragged fp16 case), then
   CUDA-event times of the kernel, the plain version and the library
   call at the llama2-7b prefill shape, beside the roofline bound.
4. Serving: llama2-7b at full width and depth (bf16 random weights from
   a seed) behind the port's HTTP app on a local port, 8 prompts of 219
   tokens plus one of 300 (chunked prefill), 32 new tokens each; every
   response checked; kernel launch counts read around this run; prefill
   logits through the kernel held against attention_impl='xla'.
5. Result: the kernels JSON line, the nvidia-smi line, then
   {"ok": true, "device": {...}} as the last line.

Needs one CUDA device; exits non-zero without one and imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# Published H100 SXM peaks (dense): the roofline bound's denominators.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12
# bf16 kernel vs its f32 plain version on the same bf16 inputs: the
# kernel rounds P to bf16 before P.V (as the TPU kernel does) and the
# output to bf16; one bf16 ulp is 2^-7 (0.8%) of a value, so
# |out - ref| <= OUT_ATOL + OUT_RTOL * |ref|.  The lse is f32 on both
# sides; only the order of f32 sums differs.
OUT_ATOL, OUT_RTOL, LSE_ATOL = 1e-2, 1e-2, 1e-3
# Serving prefill logits, kernel vs attention_impl='xla' on the same
# weights: 32 bf16 layers amplify the attention outputs' last-bit
# differences, so the gate is relative to the logits' scale.
LOGITS_RTOL = 5e-2
SERVE = dict(model='llama2-7b', max_seq_len=448, n_slots=8,
             steps_per_call=32, prefill_buckets=(256,), prompt_len=219,
             n_prompts=8, long_prompt_len=300, max_tokens=32)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b, hq, hkv, s, d, causal, itemsize=2):
    """Least time for the forward: q, k, v read once and out written
    once over HBM bandwidth, vs the QK^T and PV flops this input needs
    (causal: s(s+1)/2 query-key pairs) over the bf16 tensor-core peak."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * hq * pairs * d
    nbytes = (2 * b * hq * s * d + 2 * b * hkv * s * d) * itemsize
    t_flops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S
    return (max(t_flops, t_bytes) * 1e3,
            'operations' if t_flops > t_bytes else 'bytes', flops, nbytes)


def kernel_phase(device):
    """Every flash-forward shape of the check against the plain version;
    returns the kernels-line numbers except the launch count."""
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(SEED)
    shapes = [(b, 32, 32, s, 128, True, torch.bfloat16)   # llama2-7b prefill
              for b in (1, 8) for s in (32, 64, 128, 256, 512)]
    shapes += [(4, 12, 4, 256, 128, True, torch.bfloat16),  # bench-600m
               (4, 32, 8, 256, 64, True, torch.bfloat16),   # llama3-1b
               (2, 32, 32, 256, 128, False, torch.bfloat16),  # non-causal
               (2, 8, 2, 96, 64, True, torch.float16)]      # ragged, fp16
    max_err = 0.0
    for b, hq, hkv, s, d, causal, dtype in shapes:
        q = torch.randn((b, hq, s, d), generator=gen, device=device).to(dtype)
        k = torch.randn((b, hkv, s, d), generator=gen,
                        device=device).to(dtype)
        v = torch.randn((b, hkv, s, d), generator=gen,
                        device=device).to(dtype)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                          return_residuals=True)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_fwd_reference(
            q, k, v, causal=causal, return_residuals=True)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        ok = bool((diff <= OUT_ATOL + OUT_RTOL * ref.float().abs()).all())
        log(f'  flash_fwd b={b} hq={hq} hkv={hkv} s={s} d={d} '
            f'causal={causal} {str(dtype)[6:]}: out max_abs_err={err:.3e} '
            f'lse max_abs_err={lse_err:.3e}')
        if not (ok and lse_err <= LSE_ATOL and torch.isfinite(out).all()):
            raise SystemExit(
                f'flash_attention_fwd disagrees with its plain version at '
                f'{(b, hq, hkv, s, d, causal)}: out {err} lse {lse_err}')
        max_err = max(max_err, err)

    # Times at the llama2-7b prefill shape of the serving phase.
    b, h, s, d = 8, 32, SERVE['prefill_buckets'][0], 128
    q, k, v = (torch.randn((b, h, s, d), generator=gen,
                           device=device).to(torch.bfloat16)
               for _ in range(3))
    ms = cuda_time_ms(lambda: fa.flash_attention_fwd(q, k, v))
    plain_ms = cuda_time_ms(lambda: fa.flash_attention_fwd_reference(q, k, v))
    library_ms = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    bound_ms, bound_by, flops, nbytes = attention_bound(b, h, h, s, d, True)
    log(f'  timing b={b} h={h} s={s} d={d} causal bf16: kernel {ms:.4f} ms, '
        f'plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound '
        f'{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP, '
        f'{nbytes / 1e6:.2f} MB)')
    return {
        'name': 'flash_attention_fwd', 'route': 'cuda',
        'source': 'skypilot_tpu_torch/csrc/flash_attention_fwd.cu',
        'replaces': 'skypilot_tpu/ops/pallas/flash_attention.py:37',
        'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms,
        'bound_ms': bound_ms, 'bound_by': bound_by,
        'library_ms': library_ms,
    }


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


async def _post_all(port, bodies):
    import aiohttp
    url = f'http://127.0.0.1:{port}/v1/completions'
    timeout = aiohttp.ClientTimeout(total=900)
    async with aiohttp.ClientSession(timeout=timeout) as session:

        async def one(body):
            async with session.post(url, json=body) as resp:
                return resp.status, await resp.json()

        return await asyncio.gather(*(one(b) for b in bodies))


async def _serve_and_post(engine, batches):
    """Start the port's HTTP app on a local port, POST each batch of
    bodies concurrently (batch after batch), stop the app."""
    from aiohttp import web
    from skypilot_tpu_torch.inference.server import build_app

    runner = web.AppRunner(build_app(engine))
    await runner.setup()
    port = _free_port()
    site = web.TCPSite(runner, '127.0.0.1', port)
    await site.start()
    try:
        results = []
        for bodies in batches:
            t0 = time.perf_counter()
            replies = await _post_all(port, bodies)
            results.append((time.perf_counter() - t0, replies))
        return results
    finally:
        await runner.cleanup()


def serving_phase(device, card):
    """llama2-7b through the HTTP app; returns the kernel launch count of
    this run (the counter is zeroed just before it)."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS, Llama, init_params
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa

    cfg = dataclasses.replace(LLAMA_CONFIGS[SERVE['model']],
                              max_seq_len=SERVE['max_seq_len'],
                              param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_params(cfg, device,
                         torch.Generator(device=device).manual_seed(SEED))
    model = Llama(cfg, params)
    torch.cuda.synchronize()
    log(f'  {SERVE["model"]}: {cfg.num_params() / 1e9:.3f}B params bf16, '
        f'{cfg.n_layers} layers, dim {cfg.dim}, init '
        f'{time.perf_counter() - t0:.1f} s')
    engine = DecodeEngine(
        model, EngineConfig(n_slots=SERVE['n_slots'],
                            steps_per_call=SERVE['steps_per_call'],
                            prefill_buckets=SERVE['prefill_buckets']),
        device=device)
    engine.prewarm()
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, SERVE['prompt_len']).tolist()
               for _ in range(SERVE['n_prompts'])]
    long_prompt = rng.integers(0, cfg.vocab_size,
                               SERVE['long_prompt_len']).tolist()
    n_new = SERVE['max_tokens']
    warm = [{'prompt_ids': prompts[0][:40], 'max_tokens': 4}]
    burst = [{'prompt_ids': p, 'max_tokens': n_new}
             for p in prompts + [long_prompt]]

    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_fwd.launches = 0
    groups_before = engine.prefill_groups
    engine.start()
    try:
        (_, warm_replies), (wall, replies) = asyncio.run(
            _serve_and_post(engine, [warm, burst]))
    finally:
        engine.stop()
    launches = fa.flash_attention_fwd.launches
    groups = engine.prefill_groups - groups_before
    if not engine.healthy:
        raise SystemExit(f'engine crashed: {engine.error!r}')
    for status, body in warm_replies + replies:
        if status != 200:
            raise SystemExit(f'request failed: {status} {body}')
    for (status, body), req in zip(replies, burst):
        if len(body['ids']) != n_new:
            raise SystemExit(f'{len(body["ids"])} ids for a request of '
                             f'{n_new}: {body}')
        if not all(0 <= i < cfg.vocab_size for i in body['ids']):
            raise SystemExit(f'token id out of range: {body["ids"]}')
    if groups < 1 or launches < cfg.n_layers * groups:
        raise SystemExit(f'flash kernel launched {launches} times over '
                         f'{groups} prefill groups of {cfg.n_layers} layers')
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ttfts = sorted(body['usage']['ttft_ms'] for _, body in replies)
    out_toks = sum(len(body['ids']) for _, body in replies)
    log(f'  served {len(replies)} requests ({SERVE["n_prompts"]} x '
        f'{SERVE["prompt_len"]} + 1 x {SERVE["long_prompt_len"]} tokens, '
        f'{n_new} new each) on {card}: wall {wall:.3f} s, '
        f'{out_toks / wall:.1f} out-tok/s, TTFT ms p50 '
        f'{ttfts[len(ttfts) // 2]:.1f} max {ttfts[-1]:.1f}, peak memory '
        f'{peak_gb:.2f} GB; flash launches {launches} over {groups} '
        f'prefill groups')

    # Kernel vs plain attention on the serving path itself: prefill
    # logits of two prompts through attention_impl 'flash' and 'xla'
    # (same weights).  Not part of the counted run.
    xla = Llama(dataclasses.replace(cfg, attention_impl='xla'), params)
    bucket = SERVE['prefill_buckets'][0]
    toks = torch.zeros((2, bucket), dtype=torch.long, device=device)
    for j in range(2):
        toks[j, :SERVE['prompt_len']] = torch.tensor(prompts[j])
    with torch.no_grad():
        got, _ = model(toks, decode=True)
        want, _ = xla(toks, decode=True)
    got = got[:, :SERVE['prompt_len']]
    want = want[:, :SERVE['prompt_len']]
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f'  prefill logits flash vs xla: max_abs_err {err:.4f} of max '
        f'|logit| {scale:.3f} (rel {err / scale:.2e}), argmax agreement '
        f'{agree:.4f}')
    if not (torch.isfinite(got).all() and err <= LOGITS_RTOL * scale):
        raise SystemExit('prefill logits through the kernel disagree with '
                         'attention_impl=xla')
    profile_step(engine, prompts, card)
    return launches


def profile_step(engine, prompts, card):
    """Where the time goes: one synchronous engine step that admits the 8
    prompts as one prefill group and runs one decode call of
    steps_per_call steps, traced with torch.profiler (device time by
    kernel, device busy share of the step's wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reqs = [engine.submit(p, SERVE['steps_per_call']) for p in prompts]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if not all(r.finished_at is not None for r in reqs):
        raise SystemExit('profiled step did not finish its requests')
    # Kernel rows only: an aten op's row repeats its kernels' time.
    rows = sorted(((evt.self_device_time_total / 1e3, evt.count, evt.key)
                   for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    flash_ms = sum(r[0] for r in rows if 'fa_fwd_kernel' in r[2])
    log(f'  profile on {card}: 1 prefill group of {len(prompts)} x '
        f'{SERVE["prompt_len"]} + 1 decode call of '
        f'{SERVE["steps_per_call"]} steps: wall {wall_ms:.1f} ms, device '
        f'busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}), flash kernel '
        f'{flash_ms:.3f} ms')
    for dev_ms, count, name in rows[:10]:
        log(f'    {dev_ms:9.3f} ms  x{count:<6d} {name[:90]}')


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from skypilot_tpu_torch.device import resolve_device
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa

    t_start = time.perf_counter()
    device = resolve_device('cuda')
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f'[device] {card} | {smi} | torch {torch.__version__} cuda '
        f'{torch.version.cuda}')

    t0 = time.perf_counter()
    build_log = fa.build()
    log(f'[build] flash_attention_fwd.cu in {time.perf_counter() - t0:.1f} '
        f's -> {fa.BUILD_DIR}')
    for line in build_log.splitlines():
        if 'ptxas' in line or 'error' in line.lower():
            log(f'  {line.strip()}')

    log(f'[kernels] vs plain version (out |d| <= {OUT_ATOL} + {OUT_RTOL}'
        f'*|ref|, lse |d| <= {LSE_ATOL})')
    entry = kernel_phase(device)

    log(f'[serving] {SERVE}')
    entry['launches'] = serving_phase(device, card)

    kernels = {'kernels': [{
        key: entry[key] for key in (
            'name', 'route', 'source', 'replaces', 'launches',
            'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
            'library_ms')}]}
    log(f'[done] {time.perf_counter() - t_start:.1f} s')
    log(json.dumps(kernels))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': card,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
