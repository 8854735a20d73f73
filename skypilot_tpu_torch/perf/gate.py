"""Perf-regression gate: `python -m skypilot_tpu_torch.perf.gate [--check]`.

The port's twin of `skypilot_tpu/perf/gate.py` (`skytpu perf`): runs a
FRESH serve probe of the port's engine (`tiny`, on the GPU unless
`--device cpu` is given), loads the newest committed `BENCH_*.json`,
and evaluates the same two families of checks:

- **Ratio tolerances** (`TOLERANCES`): fresh/baseline ratio windows per
  headline metric, run only when the probe and the baseline measured
  the SAME model on the SAME chip kind; the committed rounds are TPU
  runs of another model, so on the card (chip `h100`) and on the CPU
  they are reported as cross-host skips, as the JAX gate reports them.
- **Consistency checks** (always on): the baseline artifact is
  structurally sound, the probe produced throughput, and the engine's
  LIVE `skytpu_engine_mfu` / `skytpu_engine_hbm_bytes_per_token`
  gauges (bf16 and int8 pages) agree with the cost model's values
  within 5%.

The probe also reports observed vs roofline-projected prefill per
bucket.  On the card the probe's prefills (head_dim 16) run the small
flash-forward kernel (`csrc/flash_attention_fwd_small.cu`).

`TOLERANCES`, `GAUGE_AGREEMENT_FRAC`, `latest_bench`, `_dig`,
`_ratio_check`, `_agreement_check`, `run` and `render_report` are the
JAX gate's, verbatim (pinned by tests/test_torch_package.py);
`probe_serve` is its probe on the port's `DecodeEngine` and `Llama`
(same config, buckets, slots, requests, warm-ups, int8 paged engine and
report keys, `chip` from the port's cost model).
"""
from __future__ import annotations

import argparse
import functools
import glob
import json
import os
import re
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

from skypilot_tpu_torch.device import DeviceLike, resolve_device

# fresh/baseline ratio windows, applied only on same-chip+same-model
# pairs.  Keys are dotted paths into the bench artifact's
# parsed.detail.
TOLERANCES: Dict[str, Tuple[float, float]] = {
    'serve.out_tok_per_s': (0.5, 20.0),
    'serve.req_per_s': (0.5, 20.0),
    'serve.tpot_median_ms': (0.05, 2.0),
    'serve.ttft_median_ms': (0.02, 10.0),
}

# Live-gauge vs bench-computed agreement bound (acceptance criterion).
GAUGE_AGREEMENT_FRAC = 0.05


def latest_bench(root: Optional[str] = None) -> Tuple[str, dict]:
    """Newest committed BENCH_*.json (highest round number)."""
    root = root or os.getcwd()
    paths = glob.glob(os.path.join(root, 'BENCH_*.json'))
    if not paths:
        raise FileNotFoundError(f'no BENCH_*.json under {root}')

    def round_no(path: str) -> int:
        m = re.search(r'BENCH_r?(\d+)', os.path.basename(path))
        return int(m.group(1)) if m else -1

    best = max(paths, key=round_no)
    with open(best) as f:
        return best, json.load(f)


def _dig(tree: dict, dotted: str):
    node = tree
    for part in dotted.split('.'):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def probe_serve(device: DeviceLike = None) -> dict:
    """Fresh mini serve run on `device` (default: the GPU; raises
    without one): tiny model, saturated regime, plus the
    per-prefill-bucket observed timings the roofline report compares
    against.  The JAX gate's probe, step for step."""
    import dataclasses

    import numpy as np

    from skypilot_tpu_torch.inference.engine import DecodeEngine, EngineConfig
    from skypilot_tpu_torch.models.llama import (LLAMA_CONFIGS, Llama,
                                                 init_params)

    device = resolve_device(device)
    cfg = dataclasses.replace(LLAMA_CONFIGS['tiny'], max_seq_len=128)
    model = Llama(cfg, init_params(cfg, device))
    buckets = (8, 16)
    n_slots, new_tokens, n_requests, prompt_len = 2, 8, 6, 8
    engine = DecodeEngine(
        model,
        EngineConfig(n_slots=n_slots, steps_per_call=4,
                     prefill_buckets=buckets),
        device=device)
    # Warm every shape the measurement hits, so the probe measures
    # steady-state decode, not builds.
    warm = engine.submit([1, 2, 3], 2)
    while warm.finished_at is None:
        engine.step()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, prompt_len).tolist()
               for _ in range(n_requests)]
    # Warm the padded admission shapes CONCURRENTLY: _admit_free groups
    # same-bucket admissions into one fused prefill dispatch, so the
    # saturated run below admits n_slots rows at once.
    warms = [engine.submit(p, 1) for p in prompts[:n_slots]]
    while any(w.finished_at is None for w in warms):
        engine.step()

    engine.perf_window_s = 1e9       # one window spanning the whole run
    engine.perf_reset_window()
    reqs = [engine.submit(p, new_tokens) for p in prompts]
    t0 = time.perf_counter()
    while any(r.finished_at is None for r in reqs):
        engine.step_pipelined()
    wall = time.perf_counter() - t0
    engine.perf_window_s = 0.0
    engine.step()                    # idle step flushes the perf window
    snap = engine.perf_snapshot() or {}

    out_tokens = sum(r.emitted for r in reqs)
    rate = out_tokens / wall
    cm = engine.perf_cost_model
    mean_ctx = prompt_len + new_tokens / 2.0
    rows = []
    for bucket in engine.cfg.prefill_buckets:
        obs = []
        for k in range(3):
            # request_id required: prefill_end_at is only stamped for
            # traced requests (anonymous submits skip the span path).
            r = engine.submit(
                rng.integers(0, cfg.vocab_size, bucket).tolist(), 2,
                request_id=f'perf-gate-b{bucket}-{k}')
            while r.finished_at is None:
                engine.step()
            if r.prefill_end_at is not None:
                obs.append(r.prefill_end_at - r.submitted_at)
        obs.sort()
        observed_ms = obs[len(obs) // 2] * 1e3 if obs else 0.0
        projected_ms = cm.prefill_seconds(bucket) * 1e3
        rows.append({
            'bucket': bucket,
            'observed_ms': round(observed_ms, 3),
            'projected_ms': round(projected_ms, 6),
            'observed_over_projected': round(
                observed_ms / projected_ms, 2) if projected_ms else None,
        })
    # int8 KV probe: a fresh paged engine with quantized pages, whose
    # cost model is built from the engine's DECLARED kv_dtype, so
    # live-vs-bench agreement here proves the quantized-width plumbing
    # end to end.
    q_engine = DecodeEngine(
        model,
        EngineConfig(n_slots=n_slots, steps_per_call=4,
                     prefill_buckets=buckets, kv_page_size=8,
                     kv_dtype='int8'),
        device=device)
    q_warms = [q_engine.submit(p, 1) for p in prompts[:n_slots]]
    while any(w.finished_at is None for w in q_warms):
        q_engine.step()
    q_engine.perf_window_s = 1e9
    q_engine.perf_reset_window()
    q_reqs = [q_engine.submit(p, new_tokens) for p in prompts]
    while any(r.finished_at is None for r in q_reqs):
        q_engine.step_pipelined()
    q_engine.perf_window_s = 0.0
    q_engine.step()
    q_snap = q_engine.perf_snapshot() or {}
    q_cm = q_engine.perf_cost_model
    return {
        'chip': cm.chip,
        'model': 'tiny',
        'out_tok_per_s': round(rate, 1),
        'mfu_live_pct': (round(snap['mfu'], 6)
                         if snap.get('mfu') is not None else None),
        'mfu_bench_pct': round(cm.mfu(rate, mean_ctx), 6),
        'hbm_bytes_per_token_live': snap.get('hbm_bytes_per_token'),
        'hbm_bytes_per_token_bench': round(
            cm.decode_hbm_bytes_per_token(mean_ctx, n_slots), 1),
        'hbm_bytes_per_token_live_int8': q_snap.get(
            'hbm_bytes_per_token'),
        'hbm_bytes_per_token_bench_int8': round(
            q_cm.decode_hbm_bytes_per_token(mean_ctx, n_slots), 1),
        'arith_intensity': round(cm.arith_intensity(mean_ctx, n_slots), 4),
        'roofline': rows,
    }


def _ratio_check(name, fresh, base, lo, hi) -> dict:
    if not base:
        return {'name': name, 'status': 'skip',
                'detail': 'baseline value missing/zero'}
    ratio = fresh / base
    ok = lo <= ratio <= hi
    return {'name': name, 'status': 'ok' if ok else 'fail',
            'detail': f'fresh={fresh} baseline={base} '
                      f'ratio={ratio:.3f} window=[{lo}, {hi}]'}


def _agreement_check(name, live, bench) -> dict:
    if live is None or not bench:
        return {'name': name, 'status': 'fail',
                'detail': f'live={live} bench={bench} (gauge never '
                          f'sampled or cost model missing)'}
    frac = abs(live / bench - 1.0)
    ok = live > 0 and frac <= GAUGE_AGREEMENT_FRAC
    return {'name': name, 'status': 'ok' if ok else 'fail',
            'detail': f'live={live} bench={bench} '
                      f'disagreement={frac * 100:.2f}% '
                      f'(bound {GAUGE_AGREEMENT_FRAC * 100:.0f}%)'}


def run(baseline_path: Optional[str] = None,
        probe_fn: Callable[[], dict] = probe_serve) -> dict:
    """Full gate run -> report dict (see render_report)."""
    if baseline_path is None:
        baseline_path, baseline = latest_bench()
    else:
        with open(baseline_path) as f:
            baseline = json.load(f)
    checks: List[dict] = []
    parsed = baseline.get('parsed') or {}
    detail = parsed.get('detail') or {}
    checks.append({
        'name': 'baseline-parse',
        'status': 'ok' if (baseline.get('rc') == 0 and detail)
        else 'fail',
        'detail': f'{os.path.basename(baseline_path)}: rc='
                  f'{baseline.get("rc")} detail_keys='
                  f'{sorted(detail)}'})
    structural = ['train.mfu_pct', 'train.tokens_per_s_per_chip',
                  'serve.out_tok_per_s', 'serve.tpot_median_ms']
    missing = [k for k in structural
               if not isinstance(_dig(detail, k), (int, float))
               or _dig(detail, k) <= 0]
    checks.append({
        'name': 'baseline-structure',
        'status': 'ok' if not missing else 'fail',
        'detail': ('all headline fields positive' if not missing
                   else f'missing/non-positive: {missing}')})

    probe = probe_fn()
    checks.append({
        'name': 'probe-throughput',
        'status': 'ok' if probe.get('out_tok_per_s', 0) > 0 else 'fail',
        'detail': f'fresh out_tok_per_s={probe.get("out_tok_per_s")}'})
    checks.append(_agreement_check(
        'gauge-vs-bench-mfu', probe.get('mfu_live_pct'),
        probe.get('mfu_bench_pct')))
    checks.append(_agreement_check(
        'gauge-vs-bench-hbm-bytes-per-token',
        probe.get('hbm_bytes_per_token_live'),
        probe.get('hbm_bytes_per_token_bench')))
    checks.append(_agreement_check(
        'gauge-vs-bench-hbm-bytes-per-token-int8',
        probe.get('hbm_bytes_per_token_live_int8'),
        probe.get('hbm_bytes_per_token_bench_int8')))

    base_chip = _dig(detail, 'train.chip')
    base_model = _dig(detail, 'serve.model')
    comparable = (probe['chip'] == base_chip and
                  probe['model'] == base_model)
    for dotted, (lo, hi) in sorted(TOLERANCES.items()):
        if not comparable:
            checks.append({
                'name': f'tolerance:{dotted}', 'status': 'skip',
                'detail': f'cross-host: probe ran {probe["model"]} on '
                          f'{probe["chip"]}, baseline is {base_model} '
                          f'on {base_chip} — ratio not meaningful'})
            continue
        fresh_key = dotted.split('.')[-1]
        checks.append(_ratio_check(
            f'tolerance:{dotted}', probe.get(fresh_key, 0.0),
            _dig(detail, dotted), lo, hi))
    for row in probe.get('roofline', []):
        sane = (row['projected_ms'] and row['observed_ms'] and
                row['observed_ms'] > 0)
        checks.append({
            'name': f'roofline:bucket={row["bucket"]}',
            'status': 'ok' if sane else 'fail',
            'detail': f'observed={row["observed_ms"]}ms '
                      f'projected={row["projected_ms"]}ms '
                      f'x{row["observed_over_projected"]}'})
    return {
        'baseline_path': baseline_path,
        'baseline_round': baseline.get('n'),
        'probe': probe,
        'checks': checks,
        'ok': all(c['status'] != 'fail' for c in checks),
    }


def render_report(report: dict) -> str:
    lines = [
        f'perf gate vs {os.path.basename(report["baseline_path"])} '
        f'(round {report["baseline_round"]}): '
        f'{"PASS" if report["ok"] else "FAIL"}',
        '',
        f'probe: {report["probe"]["model"]} on {report["probe"]["chip"]} '
        f'— {report["probe"]["out_tok_per_s"]} out tok/s, '
        f'mfu_live={report["probe"]["mfu_live_pct"]}% '
        f'hbm_bytes/token={report["probe"]["hbm_bytes_per_token_live"]} '
        f'arith_intensity={report["probe"]["arith_intensity"]} F/B',
        '',
        'observed vs roofline-projected prefill (per bucket):',
    ]
    for row in report['probe'].get('roofline', []):
        lines.append(
            f'  bucket {row["bucket"]:>5}: observed '
            f'{row["observed_ms"]:.3f} ms, roofline '
            f'{row["projected_ms"]:.6f} ms '
            f'(x{row["observed_over_projected"]})')
    lines.append('')
    lines.append('checks:')
    for c in report['checks']:
        lines.append(f'  [{c["status"].upper():4}] {c["name"]}: '
                     f'{c["detail"]}')
    return '\n'.join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    """`skytpu perf`'s options: exit 1 under --check when a check fails."""
    parser = argparse.ArgumentParser(
        prog='python -m skypilot_tpu_torch.perf.gate',
        description='Perf-regression gate: a fresh serve probe of the '
        'port against the committed baseline (ratio checks only on the '
        'same chip and model; the live gauges against the cost model '
        'always; observed vs roofline prefill per bucket).')
    parser.add_argument('--check', action='store_true',
                        help='exit non-zero if any regression check fails '
                        '(the CI perf-gate mode)')
    parser.add_argument('--baseline', default=None,
                        help='benchmark baseline JSON (default: the latest '
                        'BENCH_*.json in the working directory)')
    parser.add_argument('--as-json', action='store_true',
                        help='emit the raw report')
    parser.add_argument('--device', default='cuda',
                        help='torch device of the probe (cuda or cpu)')
    args = parser.parse_args(argv)
    if args.baseline is not None and not os.path.exists(args.baseline):
        parser.error(f'--baseline {args.baseline!r} does not exist')
    report = run(baseline_path=args.baseline,
                 probe_fn=functools.partial(probe_serve, args.device))
    if args.as_json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        sys.stdout.write(render_report(report))
        sys.stdout.flush()
    return 1 if args.check and not report['ok'] else 0


if __name__ == '__main__':
    sys.exit(main())
