#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (skypilot_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. Device: the card's name, and name + power limit from nvidia-smi.
2. Build: nvcc compiles every kernel source in skypilot_tpu_torch/csrc/
   for sm_90a (one process per source, in parallel) and links them into
   one library under build/skypilot_tpu_torch/; ptxas reports registers,
   shared memory and spills, and any spill store (or a setmaxnreg that
   ptxas ignored) fails the run.
3. Kernels: each kernel against its plain PyTorch version on the card:
   the forward at the serving path's shapes, then the forward, dq and
   dk/dv at the training path's (bench-1b, llama-250m, llama2-7b, a
   non-causal, a ragged fp16 case, S=32 and S=320); then CUDA-event
   times of each kernel (and its TFLOP/s), its plain version and the
   library call (SDPA; beside its backward also the port's dq + dk/dv
   sum), next to the roofline bound, at the llama2-7b prefill
   shape (forward, also with the L2 flushed before each call) and the
   bench-1b training shape (forward, dq, dk/dv), and one profiled launch
   of each (registers per thread and shared memory as launched).
4. Serving: llama2-7b at full width and depth (bf16 random weights from
   a seed) behind the port's HTTP app on a local port, 8 prompts of 219
   tokens plus one of 300 (chunked prefill), 32 new tokens each; every
   response checked; kernel launch counts read around this run; prefill
   logits through the kernel held against attention_impl='xla'.
5. Paged serving, over the same weights and prompts (PAGED): 64-token
   pages on the engine API against the dense engine (identical tokens;
   32 flash launches per prefill group, counted around the paged run),
   a prefix-hit burst (8 requests sharing a 3-page prefix; the hit
   counters exact), int8 pages (within half a quantization step plus one
   bf16 ulp of the bf16 pages; pool bytes), speculation with k = 4
   (proposed, accepted), and the KV handoff prefill -> bytes -> decode
   (identical to a monolithic paged run); every hit, int8 and
   speculative token within LOGITS_RTOL of the argmax of a teacher-forced
   forward through the kernel; one paged decode call profiled.
6. Training: bench-1b at full width and depth (f32 params, bf16 compute,
   remat 'none') through Trainer.run at batch 4, seq 4096: 2 untimed and
   8 timed steps, launch counts read around the timed steps (2 forward,
   1 dq and 1 dk/dv launch per layer per step), step time, tokens/s, MFU
   and peak memory; then one step's loss and gradients at batch 1
   through the kernels against the same step with the backward kernels'
   plain versions (same forward) and against attention_impl='xla', on
   the same weights, and one step traced with torch.profiler.
7. Result: the kernels JSON line (per kernel also TFLOP/s, ptxas
   registers and spill-store bytes, shared memory per launch), the
   nvidia-smi line, then
   {"ok": true, "device": {...}} as the last line.

Needs one CUDA device; exits non-zero without one and imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import math
import os
import re
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
# Backward kernels vs their plain versions on the same bf16 inputs: both
# round P and dS to the input type before their products, as the TPU
# kernels do; they differ in the order of f32 sums, in the SFU's 2^x
# against exp, in where a value lands next to a bf16 rounding boundary,
# and in the output's bf16 rounding (2^-8 relative).  Judged on ||kernel - plain|| / ||plain|| per
# output; a wrong kernel is off by ~1.
BWD_NORM_RTOL = 1e-2
# Training gradients at batch 1 through the backward kernels vs the same
# step whose attention backward is the kernels' plain versions on the
# same CUDA tensors (same forward kernel, same bf16 rounding of P and
# dS, f32 dP on both sides): they differ only in the order of f32 sums
# and in 1-ulp roundings, carried through 14 layers.  Per-tensor
# norm-relative error; a kernel fault of a few percent in any tensor
# fails it.
GRAD_PLAIN_RTOL = 1e-2
# The same step through attention_impl='xla' (mha_reference under
# autograd): bf16 compute rounded at other places (it rounds dP to bf16
# before the softmax backward's cancellation), so it is a coarser
# witness: per tensor, over all tensors together (the norm of the
# difference of the whole gradient over the whole gradient's norm), and
# the loss.
GRAD_NORM_RTOL = 0.1
GRAD_GLOBAL_RTOL = 1e-2
LOSS_RTOL = 1e-2
TRAIN = dict(model='bench-1b', batch=4, seq=4096, warm_steps=2,
             timed_steps=8, grad_batch=1, warmup_steps=5, total_steps=1000)
# (b, hq, hkv, s, d, causal, dtype) of the backward check: bench-1b's
# training shape first (it is also the timed one), llama-250m, llama2-7b
# (MHA), a non-causal and a ragged fp16 case, and S shorter than one
# tile and past a multiple of the 128-row tiles.
BWD_SHAPES = [(4, 16, 8, 4096, 128, True, 'bfloat16'),
              (8, 16, 8, 2048, 64, True, 'bfloat16'),
              (2, 32, 32, 512, 128, True, 'bfloat16'),
              (2, 16, 8, 1024, 128, False, 'bfloat16'),
              (2, 8, 2, 96, 64, True, 'float16'),
              (1, 4, 2, 32, 128, True, 'bfloat16'),
              (1, 4, 2, 320, 128, True, 'bfloat16')]
SERVE = dict(model='llama2-7b', max_seq_len=448, n_slots=8,
             steps_per_call=32, prefill_buckets=(256,), prompt_len=219,
             n_prompts=8, long_prompt_len=300, max_tokens=32)
# The paged serving phase, over the serving phase's weights and prompts
# (model and max_seq_len are SERVE's): 64-token pages divide the bucket
# and max_seq_len, so full backing is 8 * 448/64 + 1 = 57 pages.  The
# hit burst shares a 192-token (3-page) prefix; the handoff takes 4
# prompts; the profiled decode call runs with 64-token budgets so the
# second call is all decode.
PAGED = dict(model='llama2-7b', max_seq_len=448, n_slots=8,
             steps_per_call=32, prefill_buckets=(256,), kv_page_size=64,
             prefix_len=192, tail_len=27, max_tokens=32, spec_k=4,
             handoff_prompts=4, profile_tokens=64)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


# Device cycles of the spin kernel queued ahead of a timed run (~10 ms):
# the host enqueues every timed call behind it, so the events time the
# calls back to back on the device and not the host's launch overhead,
# which exceeds a short kernel's own time.
SPIN_CYCLES = 20_000_000


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_l2_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean CUDA-event time of `fn` with the 50 MB L2 flushed before each
    call (a 64 MB write between calls; events around each call only)."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device='cuda')
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    for start, end in events:
        flush.fill_(1)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


# Kernel symbols as ptxas and the profiler name them, by wrapper.
KERNEL_SYMBOLS = {'flash_attention_fwd': 'fa_fwd_kernel',
                  'flash_attention_bwd_dq': 'fa_bwd_dq_kernel',
                  'flash_attention_bwd_dkv': 'fa_bwd_dkv_kernel'}


def ptxas_report(build_log: str) -> dict:
    """{(symbol, 'bf16' | 'fp16', head_dim): {'registers', 'stack',
    'spill_stores', 'spill_loads'}} from nvcc's -Xptxas -v output."""
    report, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(fa_\w+?_kernel)I"
                      r"(\w+?)Li(\d+)E", line)
        if m:
            cur = (m.group(1), 'bf16' if 'bfloat16' in m.group(2) else 'fp16',
                   int(m.group(3)))
            report[cur] = {}
            continue
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m and cur:
            report[cur].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r'Used (\d+) registers', line)
        if m and cur:
            report[cur]['registers'] = int(m.group(1))
    return report


def launch_attrs(calls: dict) -> dict:
    """{symbol: the profiler's record of its launch} for each {symbol:
    fn} of `calls`, all under one profiler: registers per thread,
    shared memory (static + dynamic), grid, block ({} where the trace has
    no such kernel)."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    attrs = {symbol: {} for symbol in calls}
    for evt in trace.get('traceEvents', []):
        for symbol in calls:
            if evt.get('cat') == 'kernel' and symbol in evt.get('name', ''):
                args = evt.get('args', {})
                attrs[symbol] = {key: args.get(key) for key in (
                    'registers per thread', 'shared memory', 'grid',
                    'block', 'blocks per SM', 'warps per SM')}
    return attrs


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


def bwd_bound(kind, b, hq, hkv, s, d, causal, itemsize=2):
    """Least time for one backward kernel: its inputs (q, dO [B,Hq,S,D],
    k, v [B,Hkv,S,D], lse and delta [B,Hq,S] f32) read once and its
    outputs (dq [B,Hq,S,D], or dk and dv [B,Hkv,S,D]) written once over
    HBM bandwidth, vs the products over the (q, k) pairs this input needs
    (causal: s(s+1)/2) over the bf16 tensor-core peak: dq recomputes
    Q K^T and dO V^T and forms dS K (6 D flops per pair), dk/dv also forms
    P^T dO and dS^T Q (8 D)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = (6 if kind == 'dq' else 8) * b * hq * pairs * d
    in_bytes = (2 * b * hq * s * d + 2 * b * hkv * s * d) * itemsize
    in_bytes += 2 * b * hq * s * 4
    out_bytes = (b * hq * s * d if kind == 'dq' else 2 * b * hkv * s * d)
    nbytes = in_bytes + out_bytes * itemsize
    t_flops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S
    return (max(t_flops, t_bytes) * 1e3,
            'operations' if t_flops > t_bytes else 'bytes', flops, nbytes)


def _norm_rel(x, ref) -> float:
    return ((x.float() - ref.float()).norm() / ref.float().norm()).item()


def bwd_kernel_phase(device):
    """The forward, then dq and dk/dv, against their plain versions at
    every BWD_SHAPES entry; then times at bench-1b's training shape (the
    first entry) of
    the forward, dq and dk/dv kernels, their plain versions, SDPA and
    the bounds.  Returns (dq entry, dkv entry, forward's timing there)."""
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    errs = {'dq': 0.0, 'dkv': 0.0, 'fwd': 0.0}
    timed = None
    for shape in BWD_SHAPES:
        b, hq, hkv, s, d, causal, dtype_name = shape
        dtype = getattr(torch, dtype_name)
        q, g = (torch.randn((b, hq, s, d), generator=gen,
                            device=device).to(dtype) for _ in range(2))
        k, v = (torch.randn((b, hkv, s, d), generator=gen,
                            device=device).to(dtype) for _ in range(2))
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                          return_residuals=True)
        torch.cuda.synchronize()
        # The forward at the training shapes first: its out and lse are
        # the backward's inputs on both sides, so a wrong forward would
        # pass the backward's check unseen.
        ref, ref_lse = fa.flash_attention_fwd_reference(
            q, k, v, causal=causal, return_residuals=True)
        diff = (out.float() - ref.float()).abs()
        fwd_err = diff.max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        fwd_ok = bool((diff <= OUT_ATOL + OUT_RTOL * ref.float().abs()).all()
                      and torch.isfinite(out).all())
        del ref, ref_lse, diff
        log(f'  flash_fwd b={b} hq={hq} hkv={hkv} s={s} d={d} '
            f'causal={causal} {dtype_name}: out max_abs_err={fwd_err:.3e} '
            f'lse max_abs_err={lse_err:.3e}')
        if not (fwd_ok and lse_err <= LSE_ATOL):
            raise SystemExit(f'flash_attention_fwd disagrees with its plain '
                             f'version at {shape}: out {fwd_err} lse '
                             f'{lse_err}')
        errs['fwd'] = max(errs['fwd'], fwd_err)
        delta = (g.float() * out.float()).sum(-1)
        dq = fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, causal)
        torch.cuda.synchronize()
        ref_dq = fa.flash_attention_bwd_dq_reference(q, k, v, g, lse, delta,
                                                     causal)
        rels = {'dq': _norm_rel(dq, ref_dq)}
        abs_errs = {'dq': (dq.float() - ref_dq.float()).abs().max().item()}
        finite = bool(torch.isfinite(dq).all())
        del ref_dq
        ref_dk, ref_dv = fa.flash_attention_bwd_dkv_reference(
            q, k, v, g, lse, delta, causal)
        rels['dk'], rels['dv'] = _norm_rel(dk, ref_dk), _norm_rel(dv, ref_dv)
        abs_errs['dkv'] = max(
            (dk.float() - ref_dk.float()).abs().max().item(),
            (dv.float() - ref_dv.float()).abs().max().item())
        finite = finite and bool(torch.isfinite(dk).all() and
                                 torch.isfinite(dv).all())
        del ref_dk, ref_dv
        log(f'  flash_bwd b={b} hq={hq} hkv={hkv} s={s} d={d} '
            f'causal={causal} {dtype_name}: norm-rel dq {rels["dq"]:.3e} '
            f'dk {rels["dk"]:.3e} dv {rels["dv"]:.3e}; max_abs_err dq '
            f'{abs_errs["dq"]:.3e} dk/dv {abs_errs["dkv"]:.3e}')
        if not finite or max(rels.values()) > BWD_NORM_RTOL:
            raise SystemExit(f'flash backward kernels disagree with their '
                             f'plain versions at {shape}: {rels}')
        for key in abs_errs:
            errs[key] = max(errs[key], abs_errs[key])
        if timed is None:
            timed = (q, k, v, g, out, lse, delta, shape)
        else:
            del q, k, v, g, out, lse, delta
        del dq, dk, dv
        torch.cuda.empty_cache()

    q, k, v, g, out, lse, delta, shape = timed
    b, hq, hkv, s, d, causal, _ = shape
    ms = {
        'dq': cuda_time_ms(lambda: fa.flash_attention_bwd_dq(
            q, k, v, g, lse, delta, causal)),
        'dkv': cuda_time_ms(lambda: fa.flash_attention_bwd_dkv(
            q, k, v, g, lse, delta, causal)),
        'fwd': cuda_time_ms(lambda: fa.flash_attention_fwd(
            q, k, v, causal=causal, return_residuals=True)),
    }
    plain_ms = {
        'dq': cuda_time_ms(lambda: fa.flash_attention_bwd_dq_reference(
            q, k, v, g, lse, delta, causal), iters=3, warmup=1),
        'dkv': cuda_time_ms(lambda: fa.flash_attention_bwd_dkv_reference(
            q, k, v, g, lse, delta, causal), iters=3, warmup=1),
        'fwd': cuda_time_ms(lambda: fa.flash_attention_fwd_reference(
            q, k, v, causal=causal, return_residuals=True), iters=3,
            warmup=1),
    }
    torch.cuda.empty_cache()
    # The library yardstick: SDPA's forward, and its backward (one call
    # computes dq, dk and dv), with grouped-query heads.
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                              enable_gqa=True)
    lib_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
        sdpa_out, leaves, g, retain_graph=True))
    with torch.no_grad():
        lib_fwd_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True))
    del sdpa_out, leaves
    entries = {}
    calls = {KERNEL_SYMBOLS['flash_attention_fwd']:
             lambda: fa.flash_attention_fwd(q, k, v, causal=causal,
                                            return_residuals=True)}
    for kind, name, line, source, call in (
            ('dq', 'flash_attention_bwd_dq', 196, 'flash_attention_bwd_dq.cu',
             lambda: fa.flash_attention_bwd_dq(q, k, v, g, lse, delta,
                                               causal)),
            ('dkv', 'flash_attention_bwd_dkv', 225,
             'flash_attention_bwd_dkv.cu',
             lambda: fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta,
                                                causal))):
        bound_ms, bound_by, flops, nbytes = bwd_bound(kind, b, hq, hkv, s,
                                                      d, causal)
        tflops = flops / ms[kind] / 1e9
        log(f'  timing {name} b={b} hq={hq} hkv={hkv} s={s} d={d} causal '
            f'bf16: kernel {ms[kind]:.4f} ms ({tflops:.1f} TFLOP/s), plain '
            f'{plain_ms[kind]:.4f} ms, sdpa backward (dq+dk+dv) '
            f'{lib_bwd_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: '
            f'{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), '
            f'{bound_ms / ms[kind]:.1%} of bound')
        entries[kind] = {
            'name': name, 'route': 'cuda',
            'source': f'skypilot_tpu_torch/csrc/{source}',
            'replaces': f'skypilot_tpu/ops/pallas/flash_attention.py:{line}',
            'max_abs_err': errs[kind], 'ms': ms[kind],
            'plain_ms': plain_ms[kind], 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': lib_bwd_ms,
            'tflops': tflops, 'shape': list(shape)}
        calls[KERNEL_SYMBOLS[name]] = call
    # The like-for-like yardstick of SDPA's one backward call: the port's
    # two backward kernels together.
    entries['dq']['port_bwd_ms'] = ms['dq'] + ms['dkv']
    log(f'  timing the port\'s backward (dq + dk/dv kernels) '
        f'{ms["dq"] + ms["dkv"]:.4f} ms vs sdpa backward {lib_bwd_ms:.4f} ms')
    bound_ms, bound_by, flops, nbytes = attention_bound(b, hq, hkv, s, d,
                                                        causal)
    fwd_train = {'ms': ms['fwd'], 'plain_ms': plain_ms['fwd'],
                 'bound_ms': bound_ms, 'bound_by': bound_by,
                 'library_ms': lib_fwd_ms, 'tflops': flops / ms['fwd'] / 1e9,
                 'shape': list(shape), 'max_abs_err': errs['fwd']}
    log(f'  timing flash_attention_fwd (with lse) at the same shape: kernel '
        f'{ms["fwd"]:.4f} ms ({fwd_train["tflops"]:.1f} TFLOP/s), plain '
        f'{plain_ms["fwd"]:.4f} ms, sdpa '
        f'{lib_fwd_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: '
        f'{flops / 1e9:.1f} GFLOP), {bound_ms / ms["fwd"]:.1%} of bound')
    # One profiled launch of each kernel at this shape (all three are the
    # bf16, head_dim 128 instantiations the main paths run).
    attrs = launch_attrs(calls)
    for entry, symbol in ((entries['dq'], 'fa_bwd_dq_kernel'),
                          (entries['dkv'], 'fa_bwd_dkv_kernel'),
                          (fwd_train, 'fa_fwd_kernel')):
        entry['launch'] = attrs[symbol]
        log(f'  launch of {symbol}: {attrs[symbol]}')
    del q, k, v, g, out, lse, delta, timed
    torch.cuda.empty_cache()
    return entries['dq'], entries['dkv'], fwd_train


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
    def call():
        return fa.flash_attention_fwd(q, k, v)

    ms = cuda_time_ms(call)
    # q, k, v and out are 16.8 MB each (67.1 MB together): part of them
    # stays in the 50 MB L2 between back-to-back calls; the flushed time
    # reads them all from device memory.
    cold_ms = cold_l2_ms(call)
    plain_ms = cuda_time_ms(lambda: fa.flash_attention_fwd_reference(q, k, v))
    library_ms = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    bound_ms, bound_by, flops, nbytes = attention_bound(b, h, h, s, d, True)
    log(f'  timing b={b} h={h} s={s} d={d} causal bf16: kernel {ms:.4f} ms '
        f'(L2 warm), {cold_ms:.4f} ms (L2 flushed before each call), plain '
        f'{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound '
        f'{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.3f} GFLOP, '
        f'{nbytes / 1e6:.2f} MB): {bound_ms / ms:.1%} of bound warm, '
        f'{bound_ms / cold_ms:.1%} cold')
    return {
        'name': 'flash_attention_fwd', 'route': 'cuda',
        'source': 'skypilot_tpu_torch/csrc/flash_attention_fwd.cu',
        'replaces': 'skypilot_tpu/ops/pallas/flash_attention.py:37',
        'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms,
        'bound_ms': bound_ms, 'bound_by': bound_by,
        'library_ms': library_ms, 'tflops': flops / ms / 1e9,
        'ms_l2_flushed': cold_ms,
        'shape': [b, h, h, s, d, True, 'bfloat16'],
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


KERNEL_NAMES = ('flash_attention_fwd', 'flash_attention_bwd_dq',
                'flash_attention_bwd_dkv')


def zero_launches() -> None:
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa
    for name in KERNEL_NAMES:
        getattr(fa, name).launches = 0


def read_launches() -> dict:
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa
    return {name: getattr(fa, name).launches for name in KERNEL_NAMES}


def serving_phase(device, card):
    """llama2-7b through the HTTP app; returns the kernels' launch counts
    of this run (the counters are zeroed just before it) and what the
    paged phase reuses: the weights, the model and the prompts."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS, Llama, init_params

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
    zero_launches()
    groups_before = engine.prefill_groups
    engine.start()
    try:
        (_, warm_replies), (wall, replies) = asyncio.run(
            _serve_and_post(engine, [warm, burst]))
    finally:
        engine.stop()
    counts = read_launches()
    launches = counts['flash_attention_fwd']
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
    ctx = {'cfg': cfg, 'params': params, 'model': model, 'prompts': prompts,
           'long_prompt': long_prompt,
           'http_ids': [body['ids'] for _, body in replies]}
    return counts, ctx


def _drive(engine, prompts, max_new, step='step_pipelined'):
    """Submit every prompt, then step until all finished (drained);
    returns (streams, wall s, TTFTs s, requests)."""
    import torch
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new) for p in prompts]
    fn = getattr(engine, step)
    while not all(r.finished_at is not None for r in reqs):
        fn()
    if step == 'step_pipelined':
        engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not engine.healthy:
        raise SystemExit(f'paged engine crashed: {engine.error!r}')
    return ([r.tokens() for r in reqs], wall,
            [r.first_token_at - r.submitted_at for r in reqs], reqs)


def _p50(xs):
    return sorted(xs)[len(xs) // 2]


def _counter(name):
    from skypilot_tpu_torch.server import metrics as metrics_lib
    total = 0.0
    for line in metrics_lib.render().splitlines():
        if line.split('{')[0].split(' ')[0] == name:
            total += float(line.rsplit(' ', 1)[1])
    return total


def teacher_forced(model, prompts, streams, what):
    """Each emitted token against one non-decode forward (flash kernel)
    over prompt + tokens[:-1]: its logit must be within LOGITS_RTOL of
    the position's max |logit| below the max logit.  A wrong page,
    position or acceptance count gives tokens far from the argmax; a
    bf16 argmax flip passes.  Returns (worst slack, exact-argmax count,
    token count)."""
    import torch
    worst, exact, total = 0.0, 0, 0
    device = next(model.parameters()).device
    for prompt, toks in zip(prompts, streams):
        seq = torch.tensor([list(prompt) + toks[:-1]], device=device)
        with torch.no_grad():
            logits = model(seq)[0, len(prompt) - 1:]        # [n, V]
        ids = torch.tensor(toks, device=device)[:, None]
        got = logits.gather(1, ids)[:, 0]
        top = logits.max(-1).values
        slack = (top - got) / logits.abs().max(-1).values
        if not torch.isfinite(logits).all():
            raise SystemExit(f'{what}: non-finite teacher-forced logits')
        worst = max(worst, slack.max().item())
        exact += int((got == top).sum().item())
        total += len(toks)
    log(f'    teacher-forced {what}: {exact}/{total} tokens are the exact '
        f'argmax, worst (max - logit)/max|logit| {worst:.4f} (gate '
        f'{LOGITS_RTOL})')
    if worst > LOGITS_RTOL:
        raise SystemExit(f'{what}: an emitted token is {worst:.4f} of the '
                         f'logits\' scale below the argmax')
    return worst, exact, total


def _share_equal(a, b):
    same = sum(x == y for sa, sb in zip(a, b) for x, y in zip(sa, sb))
    return same / sum(len(sa) for sa in a)


def paged_phase(device, card, ctx):
    """The paged serving path over the serving phase's weights: (1) bf16
    pages against the dense engine on the same prompts (identical
    tokens; the flash launches counted around the paged run), (2) a
    prefix-hit burst, (3) int8 pages, (4) n-gram speculation, (5) the KV
    handoff prefill -> bytes -> decode; the hit, int8 and speculative
    streams held by the teacher-forced gate; then one paged decode call
    profiled.  Returns the kernels' launch counts of the paged run."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.inference import kv_quant, kv_transfer
    from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig

    cfg, model = ctx['cfg'], ctx['model']
    if (PAGED['model'], PAGED['max_seq_len']) != (SERVE['model'],
                                                  cfg.max_seq_len):
        raise SystemExit('PAGED must name the serving phase\'s model')
    prompts = ctx['prompts'] + [ctx['long_prompt']]
    n_new = PAGED['max_tokens']
    base = dict(n_slots=PAGED['n_slots'],
                steps_per_call=PAGED['steps_per_call'],
                prefill_buckets=PAGED['prefill_buckets'])
    paged_kw = dict(base, kv_page_size=PAGED['kv_page_size'])

    def engine(**kw):
        return DecodeEngine(model, EngineConfig(**kw), device=device)

    # (1) bf16 pages vs the dense engine, same prompts, same groups.
    dense = engine(**base)
    want, wall_d, ttft_d, _ = _drive(dense, prompts, n_new)
    groups_d = dense.prefill_groups
    del dense
    torch.cuda.empty_cache()
    paged = engine(**paged_kw)
    zero_launches()
    got, wall_p, ttft_p, _ = _drive(paged, prompts, n_new)
    counts = read_launches()
    groups = paged.prefill_groups
    toks = sum(map(len, got))
    log(f'  (1) bf16 pages, {len(prompts)} prompts ({len(prompts) - 1} x '
        f'{len(prompts[0])} + 1 x {len(prompts[-1])}), {n_new} new each, '
        f'on {card}: paged {toks / wall_p:.1f} out-tok/s (wall '
        f'{wall_p:.3f} s), TTFT p50 {_p50(ttft_p) * 1e3:.1f} ms; dense '
        f'engine {toks / wall_d:.1f} out-tok/s (wall {wall_d:.3f} s), TTFT '
        f'p50 {_p50(ttft_d) * 1e3:.1f} ms; prefill groups {groups} (dense '
        f'{groups_d}); flash launches {counts}; tokens equal to the HTTP '
        f'serving phase\'s {_share_equal(got, ctx["http_ids"]):.4f}')
    if got != want:
        raise SystemExit(f'paged tokens differ from the dense engine\'s: '
                         f'{_share_equal(got, want):.4f} equal')
    if groups != groups_d or counts['flash_attention_fwd'] != \
            cfg.n_layers * groups:
        raise SystemExit(f'flash launched {counts} over {groups} prefill '
                         f'groups of {cfg.n_layers} layers')
    paged._pool_alloc.check_conserved()

    # (2) Prefix cache: a warm request publishes the 3-page prefix, then
    # a burst of 8 shares it, each with its own tail.
    rng = np.random.default_rng(SEED + 5)
    prefix = rng.integers(0, cfg.vocab_size, PAGED['prefix_len']).tolist()
    tails = [rng.integers(0, cfg.vocab_size, PAGED['tail_len']).tolist()
             for _ in range(PAGED['n_slots'] + 1)]
    hit_engine = engine(**paged_kw)
    _drive(hit_engine, [prefix + tails[0]], n_new)
    before = {k: _counter(f'skytpu_engine_prefix_cache_{k}_total')
              for k in ('hits', 'tokens', 'misses')}
    burst = [prefix + t for t in tails[1:]]
    hit_toks, wall_h, ttft_h, _ = _drive(hit_engine, burst, n_new)
    delta = {k: _counter(f'skytpu_engine_prefix_cache_{k}_total') - v
             for k, v in before.items()}
    hit_engine._pool_alloc.check_conserved()
    log(f'  (2) prefix hits: burst of {len(burst)} x ({PAGED["prefix_len"]} '
        f'shared + {PAGED["tail_len"]}) after one warm request: '
        f'{sum(map(len, hit_toks)) / wall_h:.1f} out-tok/s (wall '
        f'{wall_h:.3f} s), TTFT p50 {_p50(ttft_h) * 1e3:.1f} ms (step 1: '
        f'{_p50(ttft_p) * 1e3:.1f} ms); counters {delta}; free pages '
        f'{hit_engine._pool_alloc.free_pages} of '
        f'{hit_engine._pool_alloc.n_pages}')
    if (delta['hits'] != len(burst) or delta['misses'] != 0 or
            delta['tokens'] != len(burst) * PAGED['prefix_len']):
        raise SystemExit(f'prefix-cache counters moved by {delta}')
    teacher_forced(model, burst, hit_toks, 'prefix-hit streams')
    del hit_engine
    torch.cuda.empty_cache()

    # (3) int8 pages on the step-1 prompts; then the first prompt's three
    # full prompt pages (held by both radix caches) against bf16.
    quant = engine(**paged_kw, kv_dtype='int8')
    q_toks, wall_q, ttft_q, _ = _drive(quant, prompts, n_new)
    n_pages = len(prompts[0]) // PAGED['kv_page_size']
    matched = [e._radix.match(prompts[0], n_pages) for e in (paged, quant)]
    if [n for n, _ in matched] != [n_pages, n_pages]:
        raise SystemExit(f'radix caches hold {matched} of prompt 0')
    rows_b, rows_q = (torch.tensor(pg, device=device) for _, pg in matched)
    worst_q = 0.0
    for (kb, vb), (kq, vq) in zip(paged._cache, quant._cache):
        for ref, qp in ((kb, kq), (vb, vq)):
            want_kv = ref[rows_b].float()
            step = qp.scale[rows_q][..., None]
            deq = kv_quant.dequantize_kv(qp.data[rows_q], qp.scale[rows_q],
                                         torch.float32)
            bound = 0.5 * step + want_kv.abs() * 2.0 ** -7
            worst_q = max(worst_q, ((deq - want_kv).abs() /
                                    bound.clamp_min(1e-30)).max().item())
    for e, (_, pg) in zip((paged, quant), matched):
        e._pool_alloc.release(pg)
    bytes_q = sum(t.numel() * t.element_size() for t in quant._wire_leaves())
    bytes_b = sum(t.numel() * t.element_size() for t in paged._wire_leaves())
    log(f'  (3) int8 pages: pool {bytes_q / 1e9:.4f} GB vs bf16 '
        f'{bytes_b / 1e9:.4f} GB (ratio {bytes_q / bytes_b:.5f}, expected '
        f'{(1 + 4 / cfg.head_dim) / 2:.5f}); prompt-0 pages dequantized vs '
        f'bf16: worst |d| / (half a step + 1 bf16 ulp) {worst_q:.4f}; '
        f'{toks / wall_q:.1f} out-tok/s (wall {wall_q:.3f} s), TTFT p50 '
        f'{_p50(ttft_q) * 1e3:.1f} ms; tokens equal to step 1\'s '
        f'{_share_equal(q_toks, got):.4f}')
    if worst_q > 1.0:
        raise SystemExit('int8 pages off the bf16 pages by more than half a '
                         'quantization step plus one bf16 ulp')
    if abs(bytes_q / bytes_b - (1 + 4 / cfg.head_dim) / 2) > 1e-9:
        raise SystemExit('int8 pool size off its expected ratio')
    quant._pool_alloc.check_conserved()
    teacher_forced(model, prompts, q_toks, 'int8 streams')
    del quant, paged
    torch.cuda.empty_cache()

    # (4) Speculation, k drafts per verify call.
    spec = engine(**paged_kw, speculation=PAGED['spec_k'])
    before = [_counter(f'skytpu_engine_spec_{k}_tokens_total')
              for k in ('proposed', 'accepted')]
    s_toks, wall_s, ttft_s, _ = _drive(spec, prompts, n_new, step='step')
    proposed, accepted = (_counter(f'skytpu_engine_spec_{k}_tokens_total')
                          - b for k, b in zip(('proposed', 'accepted'),
                                              before))
    log(f'  (4) speculation k={PAGED["spec_k"]}: proposed {proposed:.0f}, '
        f'accepted {accepted:.0f} (acceptance '
        f'{accepted / max(proposed, 1):.4f}); {toks / wall_s:.1f} '
        f'out-tok/s (wall {wall_s:.3f} s), TTFT p50 '
        f'{_p50(ttft_s) * 1e3:.1f} ms; tokens equal to step 1\'s '
        f'{_share_equal(s_toks, got):.4f}')
    if proposed <= 0 or not 0 <= accepted <= proposed:
        raise SystemExit(f'speculation counters: {proposed} {accepted}')
    teacher_forced(model, prompts, s_toks, 'speculative streams')
    del spec
    torch.cuda.empty_cache()

    # (5) Handoff: prefill role -> payload bytes -> decode role, against a
    # monolithic paged run of the same prompts submitted together.
    hand = prompts[:PAGED['handoff_prompts']]
    mono_toks, _, _, _ = _drive(engine(**paged_kw), hand, n_new)
    torch.cuda.empty_cache()
    pre, dec = engine(**paged_kw), engine(**paged_kw)
    reqs = [pre.submit_prefill(p, n_new) for p in hand]
    while not all(r.finished_at is not None for r in reqs):
        pre.step_pipelined()
    pre.drain()
    firsts = [r.tokens() for r in reqs]
    t0 = time.perf_counter()
    exported = [pre.export_result(r) for r in reqs]
    export_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    payloads = [kv_transfer.serialize(kv_transfer.KVHandoff(
        prompt_ids=p, first_token=e['first_token'], max_new_tokens=n_new,
        page_size=PAGED['kv_page_size'], leaves=e['leaves']))
        for p, e in zip(hand, exported)]
    ser_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    handoffs = [kv_transfer.deserialize(b) for b in payloads]
    de_ms = (time.perf_counter() - t0) * 1e3
    adopted = [dec.submit_adopt(h.prompt_ids, h.first_token, h.leaves,
                                h.max_new_tokens, page_size=h.page_size)
               for h in handoffs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec._step_adopt()
    torch.cuda.synchronize()
    adopt_ms = (time.perf_counter() - t0) * 1e3
    while not all(r.finished_at is not None for r in adopted):
        dec.step_pipelined()
    dec.drain()
    h_toks = [r.tokens() for r in adopted]
    mb = sum(map(len, payloads)) / len(payloads) / 1e6
    log(f'  (5) handoff of {len(hand)} prompts: payload {mb:.3f} MB each; '
        f'export_result (device -> host) {export_ms:.3f} ms, serialize '
        f'{ser_ms:.3f} ms, deserialize {de_ms:.3f} ms, adopt (host -> '
        f'device + scatter, synced) {adopt_ms:.3f} ms, all {len(hand)}')
    if [f[0] for f in firsts] != [m[0] for m in mono_toks] or \
            h_toks != mono_toks:
        raise SystemExit(f'handoff streams differ from the monolithic '
                         f'paged run: {_share_equal(h_toks, mono_toks):.4f}')
    del pre, dec, exported, payloads, handoffs
    torch.cuda.empty_cache()
    profile_paged_decode(engine(**paged_kw), ctx['prompts'], card)
    return counts


def profile_paged_decode(engine, prompts, card):
    """Where the time goes in paged decode: the second step() of 8
    requests (all decode: one call of steps_per_call steps) traced with
    torch.profiler; device time of the page gather/scatter and copy
    kernels against the GEMMs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    reqs = [engine.submit(p, PAGED['profile_tokens']) for p in prompts]
    engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if not all(r.finished_at is not None for r in reqs):
        raise SystemExit('profiled paged decode did not finish its requests')
    rows = kernel_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    kinds = {'gather/scatter': ('index', 'gather', 'scatter'),
             'gemm': ('gemm', 'nvjet', 'cutlass', 'sm90'),
             'copy': ('copy', 'Copy')}
    by_kind = {k: sum(r[0] for r in rows if any(t in r[2] for t in names))
               for k, names in kinds.items()}
    log(f'  paged decode profile on {card}: 1 call of '
        f'{PAGED["steps_per_call"]} steps over {len(prompts)} slots: wall '
        f'{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms '
        f'({busy_ms / wall_ms:.1%}); by kind (ms) '
        f'{ {k: round(v, 3) for k, v in by_kind.items()} }')
    for dev_ms, count, name in rows[:12]:
        log(f'    {dev_ms:9.3f} ms  x{count:<6d} {name[:200]}')


def kernel_rows(prof):
    """(device ms, launches, name) of every kernel in a torch.profiler
    trace, largest first.  Kernel rows only: an aten op's row repeats
    its kernels' time, and a GPU user annotation (the optimizer's
    `Optimizer.step#AdamW.step`) spans kernels already counted."""
    from torch.autograd import DeviceType
    return sorted(((evt.self_device_time_total / 1e3, evt.count, evt.key)
                   for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CUDA
                   and not getattr(evt, 'is_user_annotation', False)),
                  reverse=True)


def profile_step(engine, prompts, card):
    """Where the time goes: one synchronous engine step that admits the 8
    prompts as one prefill group and runs one decode call of
    steps_per_call steps, traced with torch.profiler (device time by
    kernel, device busy share of the step's wall time)."""
    import torch
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
    rows = kernel_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    flash_ms = sum(r[0] for r in rows
                   if KERNEL_SYMBOLS['flash_attention_fwd'] in r[2])
    log(f'  profile on {card}: 1 prefill group of {len(prompts)} x '
        f'{SERVE["prompt_len"]} + 1 decode call of '
        f'{SERVE["steps_per_call"]} steps: wall {wall_ms:.1f} ms, device '
        f'busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}), flash kernel '
        f'{flash_ms:.3f} ms')
    for dev_ms, count, name in rows[:10]:
        log(f'    {dev_ms:9.3f} ms  x{count:<6d} {name[:90]}')


def training_phase(device, card, smi):
    """bench-1b through Trainer.run: 2 untimed steps, then the timed
    steps with every launch counter zeroed just before and read just
    after.  Returns the launch counts of the timed run."""
    import torch
    from skypilot_tpu_torch.models.llama import LLAMA_CONFIGS, Llama, init_params
    from skypilot_tpu_torch.train import flops as flops_lib
    from skypilot_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = LLAMA_CONFIGS[TRAIN['model']]
    batch, seq, steps = TRAIN['batch'], TRAIN['seq'], TRAIN['timed_steps']
    t0 = time.perf_counter()
    model = Llama(cfg, init_params(
        cfg, device, torch.Generator(device=device).manual_seed(SEED)))
    trainer = Trainer(model, TrainConfig(warmup_steps=TRAIN['warmup_steps'],
                                         total_steps=TRAIN['total_steps']),
                      device=device)
    tokens = torch.randint(
        0, cfg.vocab_size, (batch, seq), device=device,
        generator=torch.Generator(device=device).manual_seed(SEED + 2))
    torch.cuda.synchronize()
    log(f'  {TRAIN["model"]}: {cfg.num_params() / 1e9:.3f}B params f32, '
        f'{cfg.n_layers} layers, dim {cfg.dim}, heads {cfg.n_heads}/'
        f'{cfg.n_kv_heads} x {cfg.head_dim}, compute {cfg.dtype}, remat '
        f'{cfg.remat_policy!r}; init {time.perf_counter() - t0:.1f} s')

    # Per-step metrics stay on the device; they are read after the run.
    step_metrics = []
    train_step = trainer.train_step

    def recording_step(state, tokens_):
        state, metrics = train_step(state, tokens_)
        step_metrics.append(metrics)
        return state, metrics

    trainer.train_step = recording_step
    t0 = time.perf_counter()
    trainer.run(iter([tokens] * TRAIN['warm_steps']), TRAIN['warm_steps'],
                log_every=TRAIN['warm_steps'])
    torch.cuda.synchronize()
    log(f'  {TRAIN["warm_steps"]} untimed steps: '
        f'{time.perf_counter() - t0:.2f} s')

    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    out = trainer.run(iter([tokens] * steps), steps, log_every=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m['loss']) for m in step_metrics]
    norms = [float(m['grad_norm']) for m in step_metrics]
    step_ms = wall / steps * 1e3
    tokens_per_s = batch * seq * steps / wall
    flops_per_token = flops_lib.train_flops_per_token(
        cfg.num_params(), cfg.n_layers, cfg.dim, seq)
    mfu = flops_lib.estimate_mfu(tokens_per_s, cfg.num_params(),
                                 cfg.n_layers, cfg.dim, seq, kind='h100')
    log(f'  trained {steps} timed steps of {batch} x {seq} tokens on '
        f'{smi}: step {step_ms:.1f} ms, {tokens_per_s:.0f} tokens/s, MFU '
        f'{mfu:.2f}% of 989 TFLOP/s ({flops_per_token / 1e9:.3f} GFLOP/'
        f'token), peak memory {peak_gb:.2f} GB; trainer tokens/s '
        f'{out["tokens_per_s"]:.0f}')
    log(f'  loss per step ({TRAIN["warm_steps"]} untimed, then timed) '
        f'{[round(x, 4) for x in losses]}; grad norm '
        f'{[round(x, 3) for x in norms]}; launches {counts}')
    want = {'flash_attention_fwd': 2 * cfg.n_layers * steps,
            'flash_attention_bwd_dq': cfg.n_layers * steps,
            'flash_attention_bwd_dkv': cfg.n_layers * steps}
    if counts != want:
        raise SystemExit(f'training launches {counts}, expected {want} '
                         f'(per step: forward 2 per layer under remat, '
                         f'dq and dk/dv 1 per layer)')
    if not all(map(math.isfinite, losses + norms)):
        raise SystemExit(f'non-finite training loss or grad norm: {losses} '
                         f'{norms}')
    grad_check(trainer.model, cfg, tokens[:TRAIN['grad_batch']])
    trainer.train_step = train_step
    profile_train_step(trainer, tokens, card)
    return counts


def _grad_diff(grads, ref):
    """(per-tensor norm-relative errors, worst three, whole-gradient
    norm-relative error) of one gradient dict against another."""
    import torch
    rels = {n: _norm_rel(grads[n], ref[n]) for n in ref}
    worst = sorted(rels.items(), key=lambda kv: -kv[1])[:3]
    total = (torch.stack([(grads[n] - ref[n]).float().norm()
                          for n in rels]).norm() /
             torch.stack([ref[n].float().norm() for n in rels]).norm())
    return rels, worst, total.item()


def grad_check(model, cfg, tokens):
    """One step's loss and per-tensor gradients through the kernels vs
    (a) the same model with the attention backward through the kernels'
    plain versions on the same CUDA tensors, and (b) attention_impl=
    'xla', on the same (trained) weights."""
    import torch
    from unittest import mock
    from skypilot_tpu_torch.models.llama import Llama
    from skypilot_tpu_torch.ops import attention as attn_lib
    from skypilot_tpu_torch.ops.cuda import flash_attention as fa
    from skypilot_tpu_torch.train.trainer import lm_loss

    per_call = []   # (dq, dk, dv) norm-rel, kernels vs plain, last layer first

    class PlainBackward(torch.autograd.Function):
        """The forward kernel, then `flash_attention_bwd_reference`; the
        backward kernels also run on the same inputs, for comparison
        only (their results are not returned)."""

        @staticmethod
        def forward(ctx, q, k, v, causal):
            out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                              return_residuals=True)
            ctx.causal = causal
            ctx.save_for_backward(q, k, v, out, lse)
            return out

        @staticmethod
        def backward(ctx, g):
            q, k, v, out, lse = ctx.saved_tensors
            args = (q, k, v, out, lse, g.contiguous(), ctx.causal)
            plain = fa.flash_attention_bwd_reference(*args)
            per_call.append([_norm_rel(x, ref) for x, ref in
                             zip(fa.flash_attention_bwd(*args), plain)])
            return (*plain, None)

    def loss_and_grads(m):
        names, params = zip(*m.named_parameters())
        loss = lm_loss(m(tokens), tokens)
        grads = torch.autograd.grad(loss, params)
        return loss.item(), dict(zip(names, grads))

    loss_f, grads_f = loss_and_grads(model)
    with mock.patch.object(attn_lib, 'flash_attention',
                           lambda q, k, v, causal=True, block_size=512:
                           PlainBackward.apply(q, k, v, causal)):
        loss_p, grads_p = loss_and_grads(model)
    if len(per_call) != cfg.n_layers:
        raise SystemExit(f'the plain-backward path ran {len(per_call)} '
                         f'attention backwards for {cfg.n_layers} layers')
    xla = Llama(dataclasses.replace(cfg, attention_impl='xla'),
                model.state_dict()).requires_grad_(True)
    loss_x, grads_x = loss_and_grads(xla)
    del xla
    rels_p, worst_p, total_p = _grad_diff(grads_f, grads_p)
    _, worst_x, total_x = _grad_diff(grads_f, grads_x)
    _, worst_px, total_px = _grad_diff(grads_p, grads_x)
    per_layer = [max(r for n, r in rels_p.items()
                     if n.startswith(f'layers.{i}.'))
                 for i in range(cfg.n_layers)]
    per_call = per_call[::-1]
    log(f'  gradients at batch {tokens.shape[0]}, kernels vs plain '
        f'backward: loss {loss_f:.6f} vs {loss_p:.6f}; global norm-rel '
        f'{total_p:.3e}; worst tensors '
        f'{[(n, round(r, 6)) for n, r in worst_p]}')
    log(f'    worst tensor per layer (0..{cfg.n_layers - 1}) '
        f'{[float(f"{r:.2e}") for r in per_layer]}')
    log(f'    one attention backward on each layer\'s own inputs, kernels '
        f'vs plain, max of dq/dk/dv per layer '
        f'{[float(f"{max(r):.2e}") for r in per_call]}')
    log(f'  kernels vs xla: loss {loss_f:.6f} vs {loss_x:.6f}; global '
        f'norm-rel {total_x:.3e}; worst tensors '
        f'{[(n, round(r, 5)) for n, r in worst_x]}')
    log(f'  plain backward vs xla: global norm-rel {total_px:.3e}; worst '
        f'tensors {[(n, round(r, 5)) for n, r in worst_px]}')
    if not (math.isfinite(loss_f) and worst_p[0][1] <= GRAD_PLAIN_RTOL and
            max(map(max, per_call)) <= BWD_NORM_RTOL):
        raise SystemExit('training gradients through the backward kernels '
                         'disagree with their plain versions')
    if (abs(loss_f - loss_x) > LOSS_RTOL * abs(loss_x) or
            worst_x[0][1] > GRAD_NORM_RTOL or total_x > GRAD_GLOBAL_RTOL):
        raise SystemExit('training gradients through the kernels disagree '
                         'with attention_impl=xla')
    del grads_f, grads_p, grads_x
    torch.cuda.empty_cache()


def profile_train_step(trainer, tokens, card):
    """Where the time goes in training: one step traced with
    torch.profiler (device time by kernel, device busy share of the
    step's wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.state, metrics = trainer.train_step(trainer.state, tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    flash = {name: sum(r[0] for r in rows if name in r[2])
             for name in KERNEL_SYMBOLS.values()}
    gemm_ms = sum(r[0] for r in rows
                  if any(t in r[2].lower() for t in ('gemm', 'nvjet',
                                                     'cutlass', 'sm90')))
    log(f'  profile on {card}: 1 train step of {tuple(tokens.shape)}: wall '
        f'{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms '
        f'({busy_ms / wall_ms:.1%}); flash kernels '
        f'{ {k: round(v, 3) for k, v in flash.items()} } ms '
        f'({sum(flash.values()) / max(busy_ms, 1e-9):.1%} of device time); '
        f'GEMM-named '
        f'kernels {gemm_ms:.1f} ms; loss {float(metrics["loss"]):.4f}')
    for dev_ms, count, name in rows[:12]:
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
    log(f'[build] {", ".join(p.name for p in fa.sources())} in '
        f'{time.perf_counter() - t0:.1f} s -> {fa.BUILD_DIR}')
    for line in build_log.splitlines():
        if line.startswith('==') or 'error' in line.lower() or any(
                t in line for t in ('registers', 'spill', 'Compiling',
                                    'arning', 'Performance')):
            log(f'  {line.strip()}')
    ptxas = ptxas_report(build_log)
    spills = {key: r['spill_stores'] for key, r in ptxas.items()
              if r.get('spill_stores')}
    if spills or 'setmaxnreg ignored' in build_log:
        raise SystemExit(f'ptxas spilled ({spills}) or ignored setmaxnreg')

    log(f'[kernels] forward vs plain version (out |d| <= {OUT_ATOL} + '
        f'{OUT_RTOL}*|ref|, lse |d| <= {LSE_ATOL})')
    fwd = kernel_phase(device)
    log(f'[kernels] at the training shapes: forward as above, dq and dk/dv '
        f'vs plain versions (||d|| / ||ref|| <= {BWD_NORM_RTOL})')
    dq, dkv, fwd['at_training_shape'] = bwd_kernel_phase(device)
    fwd['max_abs_err'] = max(fwd['max_abs_err'],
                             fwd['at_training_shape']['max_abs_err'])

    log(f'[serving] {SERVE}')
    by_path = {}
    by_path['serving'], serve_ctx = serving_phase(device, card)
    log(f'[paged] {PAGED}')
    by_path['paged'] = paged_phase(device, card, serve_ctx)
    del serve_ctx
    torch.cuda.empty_cache()
    log(f'[training] {TRAIN}')
    by_path['training'] = training_phase(device, card, smi)

    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms', 'tflops',
            'registers', 'smem_bytes', 'spill_bytes')
    rows = []
    for entry in (fwd, dq, dkv):
        # ptxas of the timed instantiation (bf16, head_dim 128); shared
        # memory as the profiler saw the timed launch.  None where the
        # library was reused from an earlier build (no ptxas output).
        report = ptxas.get((KERNEL_SYMBOLS[entry['name']], 'bf16', 128), {})
        entry['registers'] = report.get('registers')
        entry['spill_bytes'] = report.get('spill_stores')
        launch = entry.get('launch') or entry['at_training_shape']['launch']
        entry['smem_bytes'] = launch.get('shared memory')
        counts = {path: c[entry['name']] for path, c in by_path.items()}
        if not any(counts.values()):
            raise SystemExit(f'{entry["name"]} was never launched on the '
                             f'main paths: {counts}')
        entry['launches'] = sum(counts.values())
        entry['launches_by_path'] = counts
        rows.append({**{key: entry[key] for key in keys},
                     **{key: entry[key] for key in entry if key not in keys}})
    kernels = {'kernels': rows}
    log(f'[done] {time.perf_counter() - t_start:.1f} s')
    log(json.dumps(kernels))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': card,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
