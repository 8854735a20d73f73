"""`skytpu-torch` CLI (parity: sky/client/cli/command.py — launch :1040,
exec :1231, status/stop/down/logs/queue/cancel/autostop/check).

Thin click layer over the REST SDK; all real work happens server-side.
Run as `python -m skypilot_tpu_torch.client.cli` or the `skytpu-torch`
entry point.

This is the port's counterpart of `skypilot_tpu/client/cli.py`: the same
commands over the port's server and modules (`check`'s analyzer,
`perf`'s gate, `plan`'s placement check, `top`/`jobs top`/`alerts`'
views, the storage commands' GcsStore).  It differs where the port
differs: `perf` takes `--device` (its probe runs on the card unless told
`cpu`), and `plan` takes GPU slices (`H100:8`).
"""
from __future__ import annotations

import sys
from typing import Optional, Tuple

import click

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch import task as task_lib
from skypilot_tpu_torch.client import sdk
from skypilot_tpu_torch.utils import common_utils
from skypilot_tpu_torch.utils import ux_utils


def _load_task(entrypoint: Tuple[str, ...], **overrides) -> task_lib.Task:
    """YAML file or inline command → Task (reference:
    _make_task_or_dag_from_entrypoint_with_overrides, command.py:731)."""
    if len(entrypoint) == 1 and entrypoint[0].endswith(
            ('.yaml', '.yml')):
        task = task_lib.Task.from_yaml(entrypoint[0])
    else:
        task = task_lib.Task(run=' '.join(entrypoint) or None)
    res_overrides = {
        k: v for k, v in overrides.items()
        if k in ('accelerators', 'infra', 'cpus', 'memory', 'use_spot')
        and v not in (None, False)
    }
    if res_overrides:
        task.set_resources(
            {r.copy(**res_overrides) for r in task.resources})
    if overrides.get('num_nodes'):
        task.num_nodes = overrides['num_nodes']
    if overrides.get('workdir'):
        task.workdir = overrides['workdir']
    if overrides.get('name'):
        task.name = overrides['name']
    return task


@click.group()
@click.version_option('0.1.0', prog_name='skytpu-torch')
def cli() -> None:
    """skytpu-torch — run AI workloads on GPU infrastructure."""



_task_options = [
    click.option('--cluster', '-c', default=None, help='Cluster name.'),
    click.option('--name', '-n', default=None, help='Task name.'),
    click.option('--accelerators', '--gpus', 'accelerators', default=None,
                 help='e.g. tpu-v5p-8'),
    click.option('--infra', default=None, help='cloud[/region[/zone]]'),
    click.option('--cpus', default=None),
    click.option('--memory', default=None),
    click.option('--num-nodes', type=int, default=None),
    click.option('--use-spot', is_flag=True, default=False),
    click.option('--workdir', default=None),
    click.option('--detach-run', '-d', is_flag=True, default=False),
]


def _apply(options):
    def wrap(fn):
        for opt in reversed(options):
            fn = opt(fn)
        return fn
    return wrap


@cli.command()
@click.argument('entrypoint', nargs=-1)
@_apply(_task_options)
@click.option('--dryrun', is_flag=True, default=False)
@click.option('--retry-until-up', is_flag=True, default=False,
              help='Keep sweeping placements until capacity appears '
                   'instead of failing when every zone is exhausted.')
def launch(entrypoint, cluster, detach_run, dryrun, retry_until_up,
           **overrides):
    """Launch a task on a new or existing cluster."""
    task = _load_task(entrypoint, **overrides)
    cluster = cluster or f'sky-{common_utils.generate_id(length=4)}'
    request_id = sdk.launch(task, cluster, dryrun=dryrun,
                            retry_until_up=retry_until_up)
    click.echo(f'Launch request {request_id} submitted '
               f'(cluster {cluster!r}).')
    result = sdk.get(request_id)
    if dryrun or result.get('job_id') is None:
        return
    click.echo(f'Job {result["job_id"]} on cluster {cluster!r}.')
    if not detach_run:
        sdk.tail_logs(cluster, result['job_id'])


@cli.command('exec')
@click.argument('entrypoint', nargs=-1)
@_apply(_task_options)
def exec_cmd(entrypoint, cluster, detach_run, **overrides):
    """Run a task on an existing cluster (skips provision/setup)."""
    if cluster is None:
        raise click.UsageError('exec requires --cluster.')
    task = _load_task(entrypoint, **overrides)
    result = sdk.get(sdk.exec_(task, cluster))
    click.echo(f'Job {result["job_id"]} on cluster {cluster!r}.')
    if not detach_run:
        sdk.tail_logs(cluster, result['job_id'])


@cli.command()
@click.argument('clusters', nargs=-1)
@click.option('--refresh', '-r', is_flag=True, default=False)
@click.option('--all-users', '-u', is_flag=True, default=False,
              help='Show all users\' clusters, not just yours.')
def status(clusters, refresh, all_users):
    """Show clusters (in the active workspace)."""
    records = sdk.status(list(clusters) or None, refresh=refresh,
                         all_users=all_users)
    rows = []
    for r in records:
        res = r.get('resources', {})
        rows.append([
            r['name'], r['status'],
            res.get('accelerators') or res.get('instance_type') or 'cpu',
            res.get('infra', '-'),
            r.get('user_name') or '-',
            common_utils.readable_time_duration(
                max(0, __import__('time').time() - r['launched_at'])),
        ])
    ux_utils.print_table(['NAME', 'STATUS', 'RESOURCES', 'INFRA', 'USER',
                          'AGE'], rows)


@cli.command()
@click.argument('cluster')
@click.option('--yes', '-y', is_flag=True, default=False)
def down(cluster, yes):
    """Tear down a cluster."""
    if not yes:
        click.confirm(f'Down cluster {cluster!r}?', abort=True)
    sdk.get(sdk.down(cluster))
    click.echo(f'Cluster {cluster!r} terminated.')


@cli.command()
@click.argument('cluster')
def stop(cluster):
    """Stop a cluster (not supported for TPU pod slices)."""
    sdk.get(sdk.stop(cluster))
    click.echo(f'Cluster {cluster!r} stopped.')


@cli.command()
@click.argument('cluster')
def start(cluster):
    """Restart a stopped cluster."""
    sdk.get(sdk.start(cluster))
    click.echo(f'Cluster {cluster!r} started.')


@cli.command()
@click.argument('cluster')
@click.option('--idle-minutes', '-i', type=int, default=5)
@click.option('--down', 'down_flag', is_flag=True, default=False)
def autostop(cluster, idle_minutes, down_flag):
    """Schedule autostop/autodown after idleness."""
    sdk.get(sdk.autostop(cluster, idle_minutes, down_flag))
    click.echo(f'Autostop set on {cluster!r}: {idle_minutes}m '
               f'({"down" if down_flag else "stop"}).')


@cli.command()
@click.argument('cluster')
def queue(cluster):
    """Show a cluster's job queue."""
    jobs = sdk.queue(cluster)
    rows = [[j['job_id'], j.get('name') or '-', j['status'],
             j.get('returncode') if j.get('returncode') is not None
             else '-'] for j in jobs]
    ux_utils.print_table(['ID', 'NAME', 'STATUS', 'RC'], rows)


@cli.command()
@click.argument('cluster')
@click.argument('job_id', type=int)
def cancel(cluster, job_id):
    """Cancel a job."""
    ok = sdk.cancel(cluster, job_id)
    click.echo('Cancelled.' if ok else 'Nothing to cancel.')


@cli.command()
@click.argument('cluster')
@click.argument('job_id', type=int)
@click.option('--no-follow', is_flag=True, default=False)
def logs(cluster, job_id, no_follow):
    """Tail a job's logs."""
    sdk.tail_logs(cluster, job_id, follow=not no_follow)


@cli.command('cost-report')
def cost_report():
    """Estimated costs of live clusters."""
    rows = [[r['name'], str(r['status']),
             f"${r['hourly_cost']:.2f}", f"${r['accrued_cost']:.2f}"]
            for r in sdk.cost_report()]
    ux_utils.print_table(['NAME', 'STATUS', '$/HR', 'ACCRUED'], rows)


@cli.command()
@click.argument('name_filter', required=False)
def accelerators(name_filter):
    """List TPU offerings (name, zones, $/hr)."""
    rows = []
    for name, offs in sdk.accelerators(name_filter).items():
        for o in offs:
            rows.append([name, o['zone'], f"${o['hourly_cost']:.2f}",
                         f"${o['hourly_cost_spot']:.2f}"])
    ux_utils.print_table(['ACCELERATOR', 'ZONE', '$/HR', 'SPOT $/HR'],
                         rows)


@cli.command()
@click.argument('paths', nargs=-1,
                type=click.Path(exists=True, dir_okay=True))
@click.option('--json', 'as_json', is_flag=True, default=False,
              help='Static analysis: emit the findings as JSON '
                   '(stable schema; CI uploads it as an artifact).')
@click.option('--rule', 'rules', multiple=True,
              help='Static analysis: run only these rules '
                   '(repeatable).')
@click.option('--list-rules', is_flag=True, default=False,
              help='Static analysis: list the rule set and exit.')
@click.option('--show-suppressed', is_flag=True, default=False,
              help='Static analysis: also print annotated exceptions.')
def check(paths, as_json, rules, list_rules, show_suppressed):
    """Cloud-credential check, or hot-path static analysis.

    With no arguments: check cloud credentials and catalog freshness
    (talks to the API server).  With PATHS or any analysis flag: run
    the hot-path invariant analyzer (skypilot_tpu_torch/analysis/) over the
    given files/dirs — default: the installed skypilot_tpu_torch package —
    and exit non-zero on findings.  Suppress an intentional exception
    at the call site with `# skytpu: allow-<rule>(<reason>)`.
    """
    if paths or rules or as_json or list_rules or show_suppressed:
        raise SystemExit(_check_static(paths, as_json, rules,
                                       list_rules, show_suppressed))
    result = sdk.check()
    for warning in result.pop('_warnings', []):
        click.secho(f'  WARNING: {warning}', fg='yellow', err=True)
    for name, info in result.items():
        mark = 'enabled' if info['enabled'] else \
            f'disabled ({info["reason"]})'
        storage = info.get('storage')
        if storage is not None and storage['enabled'] != info['enabled']:
            smark = 'enabled' if storage['enabled'] else \
                f'disabled ({storage["reason"]})'
            mark += f'  [storage: {smark}]'
        click.echo(f'  {name}: {mark}')
    for fn, st in sdk.catalog_staleness().items():
        age = st.get('age_days')
        state = ('UNKNOWN AGE' if age is None else
                 f'{age}d old' + (' — STALE, refresh with '
                                  'data_fetchers' if st['stale'] else ''))
        click.echo(f'  catalog {fn}: {state}')


def _check_static(paths, as_json, rules, list_rules,
                  show_suppressed) -> int:
    """`skytpu check <paths>`: run the invariant analyzer locally (no
    server involved — this is the same gate tier-1 and CI run)."""
    from skypilot_tpu_torch import analysis
    if list_rules:
        from skypilot_tpu_torch.analysis.rules import all_rules
        for rule in all_rules():
            click.echo(f'{rule.name}: {rule.description} '
                       f'[suppress: # skytpu: allow-'
                       f'{rule.suppress_token}(<reason>)]')
        return 0
    try:
        report = analysis.run_check(paths or None, rules or None)
    except ValueError as e:          # unknown --rule
        click.secho(str(e), fg='red', err=True)
        return 2
    if as_json:
        click.echo(analysis.render_json(report), nl=False)
    else:
        out = analysis.render_text(report)
        if show_suppressed and report.suppressed:
            lines = [f.format() for f in report.suppressed]
            out = '\n'.join(lines) + '\n' + out
        click.echo(out, nl=False)
    return 1 if (report.unsuppressed or report.parse_errors) else 0


@cli.command('trace')
@click.argument('request_id')
@click.option('--endpoint', envvar='SKYTPU_TRACE_ENDPOINT',
              default='http://127.0.0.1:8200', show_default=True,
              help='Base URL exposing /debug/requests — a service\'s '
                   'load balancer (federated: LB + replica spans in '
                   'one view), a single replica, or the API server '
                   '(jobs postmortem events).')
@click.option('--chrome-out', type=click.Path(), default=None,
              help='Also write the Chrome-trace/Perfetto JSON document '
                   'to this path (open in ui.perfetto.dev or '
                   'chrome://tracing).')
def trace_cmd(request_id, endpoint, chrome_out):
    """Show one request's distributed trace + TTFT decomposition.

    Every response from a serve endpoint carries X-Skytpu-Request-Id
    (client-supplied ids are honored).  The span events live in each
    process's always-on flight recorder (bounded ring, knob
    SKYTPU_TRACE_RING_SIZE); this fetches /debug/requests/<id> and
    renders the timeline plus the decomposition
    queue wait + N x prefill chunk + dispatch = measured TTFT.
    """
    import json as json_lib
    import urllib.error
    import urllib.parse
    import urllib.request

    base = endpoint.rstrip('/')
    quoted = urllib.parse.quote(request_id, safe='')
    url = f'{base}/debug/requests/{quoted}'

    def fetch(u):
        with urllib.request.urlopen(u, timeout=10) as resp:
            return json_lib.load(resp)

    try:
        doc = fetch(url)
    except urllib.error.HTTPError as e:
        if e.code == 404:
            raise click.ClickException(
                f'request {request_id!r} is not in the flight recorder '
                f'at {base} (evicted from the ring, or never seen '
                f'there — try the service\'s load balancer endpoint)')
        raise click.ClickException(f'{url}: HTTP {e.code}')
    except (urllib.error.URLError, OSError) as e:
        raise click.ClickException(f'cannot reach {base}: {e}')

    events = doc.get('events', [])
    t0 = min((e['ts'] for e in events), default=0.0)
    click.echo(f'request {request_id} — {len(events)} span events')
    rows = []
    for e in events:
        rows.append([
            f'{(e["ts"] - t0) * 1e3:10.2f}',
            '-' if e['dur_ms'] is None else f'{e["dur_ms"]:.2f}',
            e['name'],
            ' '.join(f'{k}={v}' for k, v in sorted(e['attrs'].items())
                     if v is not None),
        ])
    ux_utils.print_table(['AT_MS', 'DUR_MS', 'SPAN', 'ATTRS'], rows)
    s = doc.get('summary', {})
    if s.get('ttft_ms') is not None:
        chunks = s.get('prefill_chunks', 0)
        prefill_part = (f'{chunks} x chunk {s["prefill_ms"]:.1f}'
                        if chunks else f'prefill {s["prefill_ms"]:.1f}')
        click.echo(
            f'TTFT {s["ttft_ms"]:.1f} ms = '
            f'queue {s["queue_wait_ms"]:.1f} + {prefill_part} + '
            f'dispatch {s["dispatch_ms"]:.1f} '
            f'(decomposed {s["decomposed_ttft_ms"]:.1f}, '
            f'unattributed {s["unattributed_ms"]:.1f})')
    else:
        click.echo(f'outcome: {s.get("outcome", "unknown")} '
                   f'(no first token recorded)')
    if s.get('replica') is not None:
        click.echo(f'replica: {s["replica"]}'
                   + (f'  emitted: {s["emitted_tokens"]} tokens'
                      if s.get('emitted_tokens') is not None else ''))
    if chrome_out:
        chrome = fetch(url + '?format=chrome')
        with open(chrome_out, 'w', encoding='utf-8') as f:
            json_lib.dump(chrome, f)
        click.echo(f'Chrome trace written to {chrome_out} '
                   f'(load in ui.perfetto.dev)')


@cli.command('profile')
@click.argument('endpoint')
@click.option('--duration-ms', default=500.0, show_default=True,
              help='Capture window per replica (bounded server-side).')
@click.option('--out', type=click.Path(), default=None,
              help='Download the Perfetto artifact to this path '
                   '(single-replica endpoints only).')
def profile_cmd(endpoint, duration_ms, out):
    """Trigger an on-demand device profiler capture and summarize it.

    ENDPOINT is an inference server base URL or a service load
    balancer (which federates: every ready replica captures
    concurrently).  Each capture runs jax.profiler for the requested
    window and leaves a Perfetto trace in a retention-bounded store
    (knobs SKYTPU_PROFILE_RETAIN / SKYTPU_PROFILE_DIR); artifacts are
    downloadable from /debug/profile/artifact/<path> while retained.
    """
    import json as json_lib
    import urllib.error
    import urllib.parse
    import urllib.request

    base = endpoint.rstrip('/')
    url = (f'{base}/debug/profile?duration_ms='
           f'{urllib.parse.quote(str(duration_ms), safe="")}')
    try:
        with urllib.request.urlopen(
                url, timeout=duration_ms / 1e3 + 30) as resp:
            doc = json_lib.load(resp)
    except urllib.error.HTTPError as e:
        try:
            detail = json_lib.load(e).get('error', '')
        except Exception:  # noqa: BLE001 - best-effort error body
            detail = ''
        raise click.ClickException(
            f'{base}/debug/profile: HTTP {e.code}'
            + (f' — {detail}' if detail else ''))
    except (urllib.error.URLError, OSError) as e:
        raise click.ClickException(f'cannot reach {base}: {e}')

    captures = doc.get('captures', [doc])   # LB federates; replica: one
    rows = []
    for c in captures:
        rows.append([
            str(c.get('replica', c.get('role', '-'))),
            'ok' if c.get('ok', True) else 'FAILED',
            c.get('name', '-'),
            '-' if c.get('duration_ms') is None
            else f'{c["duration_ms"]:.0f}',
            '-' if c.get('size_bytes') is None
            else f'{c["size_bytes"]}',
            str(c.get('artifact', '-')),
        ])
    ux_utils.print_table(
        ['REPLICA', 'STATUS', 'CAPTURE', 'DUR_MS', 'BYTES', 'ARTIFACT'],
        rows)
    if out:
        ok = [c for c in captures
              if c.get('ok', True) and c.get('artifact')]
        if len(ok) != 1:
            raise click.ClickException(
                '--out needs exactly one successful capture with an '
                f'artifact (got {len(ok)}); fetch per-replica '
                'endpoints directly for multi-replica services')
        art = urllib.parse.quote(ok[0]['artifact'])
        art_base = ok[0].get('url', base).rstrip('/')
        with urllib.request.urlopen(
                f'{art_base}/debug/profile/artifact/{art}',
                timeout=30) as resp, open(out, 'wb') as f:
            f.write(resp.read())
        click.echo(f'artifact written to {out} '
                   f'(open in ui.perfetto.dev)')


@cli.command('alerts')
@click.option('--endpoint', default=None,
              envvar='SKYTPU_TRACE_ENDPOINT',
              help='Service load-balancer base URL exposing /alerts '
                   '(federated view of the controller\'s telemetry '
                   'store).  Mutually exclusive with --db.')
@click.option('--db', 'db_url', default=None,
              help='Read the telemetry store directly — a sqlite path '
                   'or postgres:// DSN (default: the local serve state '
                   'database).  Used when no --endpoint is given.')
@click.option('--service', default=None,
              help='Filter to one service (default: all services in '
                   'the store).')
@click.option('--history', 'history_n', default=20, show_default=True,
              help='Recent fire/clear transitions to show below the '
                   'active set.')
@click.option('--as-json', is_flag=True, help='Emit the raw document.')
def alerts_cmd(endpoint, db_url, service, history_n, as_json):
    """Show SLO burn-rate alerts: the active set + recent history.

    The controller's telemetry plane evaluates declarative burn-rate
    rules (TTFT/TPOT p95 vs the service's targets, shed rate, dark
    scrapes, speculative-acceptance collapse, KV free-page exhaustion)
    over multi-window burn rates and persists fire/clear transitions
    in the state backend.  This reads them back, either through a load
    balancer's /alerts endpoint or straight from the store.
    """
    import json as json_lib

    if endpoint:
        import urllib.error
        import urllib.request
        url = f'{endpoint.rstrip("/")}/alerts'
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                doc = json_lib.load(resp)
        except (urllib.error.URLError, OSError) as e:
            raise click.ClickException(f'cannot reach {url}: {e}')
        active, history = doc.get('active', []), doc.get('history', [])
    else:
        from skypilot_tpu_torch.obs import store as obs_store
        from skypilot_tpu_torch.serve import serve_state
        store = obs_store.TelemetryStore(db_url or
                                         serve_state._db_path())
        active = store.active_alerts(service)
        history = store.alert_history(service, limit=history_n)
        doc = {'active': active, 'history': history}
    if as_json:
        click.echo(json_lib.dumps(doc, indent=2, sort_keys=True))
        return
    if service:
        active = [a for a in active if a['service'] == service]
        history = [a for a in history if a['service'] == service]

    def rows_of(items):
        return [[a['service'], a['rule'], a['pool'] or '-', a['state'],
                 f'{a["fired_at"]:.0f}',
                 '-' if a.get('cleared_at') is None
                 else f'{a["cleared_at"]:.0f}',
                 f'{a["burn"]:.2f}'] for a in items]

    click.echo(f'{len(active)} firing')
    if active:
        ux_utils.print_table(
            ['SERVICE', 'RULE', 'POOL', 'STATE', 'FIRED_AT',
             'CLEARED_AT', 'BURN'], rows_of(active))
    if history:
        click.echo('recent transitions:')
        ux_utils.print_table(
            ['SERVICE', 'RULE', 'POOL', 'STATE', 'FIRED_AT',
             'CLEARED_AT', 'BURN'], rows_of(history[:history_n]))


@cli.command('top')
@click.option('--db', 'db_url', default=None,
              help='Telemetry store to watch — a sqlite path or '
                   'postgres:// DSN (default: the local serve state '
                   'database).')
@click.option('--service', default=None,
              help='Service to watch (default: the first service with '
                   'telemetry in the store).')
@click.option('--interval', default=2.0, show_default=True,
              help='Refresh period in seconds.')
@click.option('--iterations', default=None, type=int,
              help='Render this many frames then exit (default: run '
                   'until Ctrl-C).')
@click.option('--window', default=300.0, show_default=True,
              help='Aggregation window in seconds for the per-pool '
                   'table and sparklines.')
def top_cmd(db_url, service, interval, iterations, window):
    """Live fleet view: per-pool QPS, p95 TTFT/TPOT, MFU, prefix-hit
    rate, free KV pages, and the active alert set, refreshed from the
    controller's telemetry store."""
    from skypilot_tpu_torch.obs import store as obs_store
    from skypilot_tpu_torch.obs import top as obs_top
    from skypilot_tpu_torch.serve import serve_state
    store = obs_store.TelemetryStore(db_url or serve_state._db_path())
    raise SystemExit(obs_top.run(store, service, interval=interval,
                                 iterations=iterations, window=window))


@cli.command('perf')
@click.option('--check', 'check_flag', is_flag=True,
              help='Exit non-zero if any regression check fails '
                   '(the CI perf-gate mode).')
@click.option('--baseline', type=click.Path(exists=True), default=None,
              help='Benchmark baseline JSON (default: the latest '
                   'BENCH_*.json in the repo root).')
@click.option('--as-json', is_flag=True, help='Emit the raw report.')
@click.option('--device', default='cuda', show_default=True,
              help='torch device of the probe (cuda or cpu).')
def perf_cmd(check_flag, baseline, as_json, device):
    """Perf-regression gate: fresh probe vs the committed baseline.

    Runs a short in-process serve probe (tiny model, on the card unless
    --device cpu), checks the live MFU / bytes-per-token gauges
    agree with the cost model within tolerance, compares throughput
    against the latest BENCH_*.json within declared tolerances
    (cross-hardware comparisons are skipped, not failed), and renders
    a per-prefill-bucket observed-vs-roofline report.
    """
    import functools
    import json as json_lib

    from skypilot_tpu_torch.perf import gate as gate_lib
    report = gate_lib.run(
        baseline_path=baseline,
        probe_fn=functools.partial(gate_lib.probe_serve, device))
    if as_json:
        click.echo(json_lib.dumps(report, indent=2, sort_keys=True))
    else:
        click.echo(gate_lib.render_report(report), nl=False)
    if check_flag and not report['ok']:
        raise SystemExit(1)


@cli.command('rotate-keys')
def rotate_keys():
    """Rotate the framework SSH keypair across every UP cluster.

    Pushes the new public key over the old credentials first, swaps the
    local keypair only after every reachable cluster accepted it, and
    keeps a timestamped backup of the old private key.  Runs client-side
    (key material never transits the API server)."""
    from skypilot_tpu_torch import authentication
    from skypilot_tpu_torch import exceptions as exc
    try:
        result = authentication.rotate_keys()
    except exc.SkyTpuError as e:
        click.secho(str(e), fg='red', err=True)
        raise SystemExit(1)
    for name in result['rotated']:
        click.echo(f'  rotated: {name}')
    for entry in result['skipped']:
        click.echo(f'  skipped: {entry}')
    click.echo('Key rotation complete; old key backed up as '
               f'{authentication.PRIVATE_KEY_PATH}.<stamp>.bak')


@cli.command('plan')
@click.option('--accelerator', required=True,
              help='Target GPUs, e.g. H100:8 (xN for N nodes).')
@click.option('--model', 'model_name', default='llama3-8b',
              help='Model to place (models/llama.py LLAMA_CONFIGS key).')
@click.option('--batch', default=8, type=int)
@click.option('--seq', default=2048, type=int)
@click.option('--data', type=int, default=None)
@click.option('--fsdp', type=int, default=None)
@click.option('--tensor', type=int, default=None)
@click.option('--compile', 'do_compile', is_flag=True,
              help='Refused: the JAX package lowers the step for an '
                   'abstract TPU topology; PyTorch has no counterpart.')
def plan(accelerator, model_name, batch, seq, data, fsdp, tensor,
         do_compile):
    """Validate a training placement BEFORE spending quota.

    Estimates the sharded parameter, optimizer, gradient and activation
    bytes on each GPU of the target (no hardware needed) and reports the
    per-device footprint; exits non-zero when the plan does not fit."""
    from skypilot_tpu_torch.parallel import validate as validate_lib
    report = validate_lib.validate_placement(
        accelerator, model_name=model_name, batch=batch, seq=seq,
        data=data, fsdp=fsdp, tensor=tensor, compile=do_compile)
    click.echo(report.summary())
    if not report.fits:
        raise SystemExit(1)


@cli.group()
def catalog():
    """Pricing-catalog maintenance."""


@catalog.command('refresh')
def catalog_refresh():
    """Regenerate the GCP catalogs from the Cloud Billing API.

    Runs the data fetcher (catalog/data_fetchers/fetch_gcp.py) locally:
    refreshed CSVs land in ~/.skytpu/catalogs/ and take precedence over
    the bundled copies; `skytpu check` reports their age.  Requires GCP
    credentials + google-api-python-client (or a recorded fixture via
    SKYTPU_BILLING_FIXTURE)."""
    from skypilot_tpu_torch.catalog.data_fetchers import fetch_gcp
    rc = fetch_gcp.main()
    if rc != 0:
        raise SystemExit(rc)
    click.echo('Catalogs refreshed; `skytpu-torch check` shows their age.')


@cli.group()
def volumes():
    """Named persistent volumes (k8s PVCs, GCP disks)."""


@volumes.command('apply')
@click.argument('name')
@click.option('--type', 'vtype', required=True,
              type=click.Choice(['k8s-pvc', 'gcp-disk']))
@click.option('--infra', required=True,
              help='kubernetes/<ctx> or gcp/<region>/<zone>')
@click.option('--size', 'size_gb', required=True, type=int,
              help='Size in GiB')
def volumes_apply_cmd(name, vtype, infra, size_gb):
    """Create (or idempotently re-apply) a volume."""
    vol = sdk.volumes_apply(name, vtype, infra, size_gb)
    click.echo(f'Volume {vol["name"]!r} ({vol["vtype"]}, '
               f'{vol["size_gb"]}Gi) ready on {vol["infra"]}.')


@volumes.command('ls')
@click.option('--all-users', '-u', is_flag=True, default=False)
def volumes_ls_cmd(all_users):
    """List volumes in the active workspace."""
    rows = [[v['name'], v['vtype'], v['infra'], v['size_gb'],
             v['status'], v.get('user_name') or '-']
            for v in sdk.volumes_list(all_users=all_users)]
    ux_utils.print_table(
        ['NAME', 'TYPE', 'INFRA', 'SIZE_GB', 'STATUS', 'USER'], rows)


@volumes.command('delete')
@click.argument('name')
def volumes_delete_cmd(name):
    """Delete a volume and its backing store."""
    sdk.volumes_delete(name)
    click.echo(f'Volume {name!r} deleted.')


@cli.group()
def storage():
    """Object-storage buckets (parity: `sky storage` CRUD).

    Operates directly on the store (gsutil; the hermetic fake root in
    tests) — no server round-trip, matching the reference's
    client-side storage management."""


@storage.command('create')
@click.argument('bucket')
@click.option('--region', default=None)
def storage_create_cmd(bucket, region):
    """Create a bucket (idempotent)."""
    from skypilot_tpu_torch.data import storage as storage_lib
    storage_lib.GcsStore(bucket).create(region=region)
    click.echo(f'Bucket gs://{bucket} ready.')


@storage.command('ls')
@click.argument('bucket', required=False)
@click.option('--prefix', default='')
def storage_ls_cmd(bucket, prefix):
    """List a bucket's objects (or hint at ls of all buckets)."""
    from skypilot_tpu_torch.data import storage as storage_lib
    if not bucket:
        raise click.UsageError('specify a bucket: skytpu storage ls '
                               '<bucket>')
    store = storage_lib.GcsStore(bucket)
    if not store.exists():
        raise click.ClickException(f'gs://{bucket} does not exist')
    for key in store.list_prefix(prefix):
        click.echo(key)


@storage.command('upload')
@click.argument('bucket')
@click.argument('src_dir')
@click.option('--prefix', default='')
def storage_upload_cmd(bucket, src_dir, prefix):
    """Upload a directory (honors .skyignore at its root)."""
    from skypilot_tpu_torch.data import storage as storage_lib
    store = storage_lib.GcsStore(bucket)
    if not store.exists():
        store.create()
    store.sync_up(src_dir, prefix=prefix)
    click.echo(f'Uploaded {src_dir} -> gs://{bucket}/{prefix}'.rstrip('/'))


@storage.command('download')
@click.argument('bucket')
@click.argument('dst_dir')
@click.option('--prefix', default='')
def storage_download_cmd(bucket, dst_dir, prefix):
    """Download a bucket (or prefix) into a local directory."""
    from skypilot_tpu_torch.data import storage as storage_lib
    store = storage_lib.GcsStore(bucket)
    if not store.exists():
        # A typo'd bucket must error, not 'succeed' with an empty dir.
        raise click.ClickException(f'gs://{bucket} does not exist')
    store.sync_down(dst_dir, prefix=prefix)
    click.echo(f'Downloaded gs://{bucket}/{prefix} -> {dst_dir}'
               .rstrip('/'))


@storage.command('delete')
@click.argument('bucket')
@click.option('--yes', '-y', is_flag=True, default=False)
def storage_delete_cmd(bucket, yes):
    """Delete a bucket and everything in it."""
    if not yes:
        click.confirm(f'Delete gs://{bucket} and ALL its objects?',
                      abort=True)
    from skypilot_tpu_torch.data import storage as storage_lib
    storage_lib.GcsStore(bucket).delete()
    click.echo(f'Bucket gs://{bucket} deleted.')


@cli.group()
def jobs():
    """Managed jobs: auto-recovering tasks on preemptible TPU slices."""


@jobs.command('launch')
@click.argument('entrypoint', nargs=-1)
@_apply(_task_options)
def jobs_launch(entrypoint, cluster, detach_run, **overrides):
    """Launch a managed job (auto-recovers from preemption).

    A multi-document YAML entrypoint is a pipeline: its tasks run
    sequentially, each on its own ephemeral cluster."""
    del cluster  # managed jobs own their ephemeral clusters
    name = overrides.get('name')
    pipeline = None
    if len(entrypoint) == 1 and entrypoint[0].endswith(('.yaml', '.yml')):
        from skypilot_tpu_torch import dag as dag_lib
        from skypilot_tpu_torch.utils import common_utils
        if len(common_utils.read_yaml_all(entrypoint[0])) > 1:
            if any(v not in (None, False, 0) for k, v in overrides.items()
                   if k != 'name'):
                raise click.UsageError(
                    'task override flags (--infra, --accelerators, ...) '
                    'are not supported with pipeline YAMLs; set resources '
                    'per task in the YAML instead.')
            pipeline = dag_lib.load_chain_dag_from_yaml(entrypoint[0])
    if pipeline is not None:
        result = sdk.get(sdk.jobs_launch(
            pipeline.topological_order(), name or pipeline.name))
        click.echo(f'Managed job {result["job_id"]} submitted '
                   f'({len(pipeline)}-task pipeline).')
    else:
        task = _load_task(entrypoint, **overrides)
        result = sdk.get(sdk.jobs_launch(task, name))
        click.echo(f'Managed job {result["job_id"]} submitted.')
    if not detach_run:
        import time as _time
        from skypilot_tpu_torch.jobs.state import TERMINAL_STATUS_VALUES \
            as _TERMINAL
        # Logs become available once the controller starts the job — but a
        # job can also fail terminally before it ever starts (e.g.
        # FAILED_NO_RESOURCE), in which case there is nothing to tail.
        rec = None
        for _ in range(600):
            recs = [r for r in sdk.jobs_queue()
                    if r['job_id'] == result['job_id']]
            rec = recs[0] if recs else None
            if rec is not None and (
                    rec.get('cluster_job_id') is not None or
                    rec.get('status') in _TERMINAL):
                break
            _time.sleep(1)
        if rec is not None and rec.get('status') in _TERMINAL and \
                rec.get('cluster_job_id') is None:
            reason = rec.get('failure_reason') or ''
            click.echo(f'Managed job {result["job_id"]} finished with '
                       f'status {rec["status"]}'
                       f'{": " + reason if reason else ""}')
            return
        sdk.jobs_tail_logs(result['job_id'])


@jobs.command('queue')
def jobs_queue_cmd():
    """List managed jobs."""
    from skypilot_tpu_torch.obs import goodput as goodput_lib
    # Recovery cost per job from the goodput ledger (one query for the
    # whole listing): preemption downtime + relaunch seconds, summed
    # across every recovery the job has survived.
    downtime = goodput_lib.GoodputLedger().downtime_by_job()
    rows = []
    for r in sdk.jobs_queue():
        n_tasks = r.get('num_tasks', 1)
        task_col = (f'{r.get("task_index", 0) + 1}/{n_tasks}'
                    if n_tasks > 1 else '-')
        down = downtime.get(str(r['job_id']), 0.0)
        rows.append([
            r['job_id'], r.get('name') or '-', r['status'], task_col,
            r.get('cluster_name') or '-',
            r.get('recovery_count', 0),
            f'{down:.1f}' if down else '-',
            (r.get('failure_reason') or '')[:40],
        ])
    ux_utils.print_table(
        ['ID', 'NAME', 'STATUS', 'TASK', 'CLUSTER', 'RECOVERIES',
         'DOWNTIME_S', 'REASON'], rows)


@jobs.command('top')
@click.argument('job_id')
@click.option('--db', 'db_url', default=None,
              help='Telemetry store holding the job\'s step-time '
                   'scrapes — a sqlite path or postgres:// DSN '
                   '(default: the local serve state database).')
@click.option('--ledger-db', default=None,
              help='Goodput ledger DSN (default: the managed-jobs '
                   'database).')
@click.option('--interval', default=2.0, show_default=True,
              help='Refresh period in seconds.')
@click.option('--iterations', default=None, type=int,
              help='Render this many frames then exit (default: run '
                   'until Ctrl-C; pass 1 for a postmortem print).')
@click.option('--window', default=300.0, show_default=True,
              help='Aggregation window in seconds for the per-host '
                   'table and sparklines.')
def jobs_top_cmd(job_id, db_url, ledger_db, interval, iterations,
                 window):
    """Live per-job goodput view: goodput %, badput breakdown,
    per-host step-time sparklines + straggler skew, and the recovery
    timeline — still renders a dead job's postmortem from the durable
    ledger."""
    from skypilot_tpu_torch.obs import goodput as goodput_lib
    from skypilot_tpu_torch.obs import jobs_top as obs_jobs_top
    from skypilot_tpu_torch.obs import store as obs_store
    from skypilot_tpu_torch.serve import serve_state
    ledger = goodput_lib.GoodputLedger(ledger_db)
    store = obs_store.TelemetryStore(db_url or serve_state._db_path())
    raise SystemExit(obs_jobs_top.run(
        job_id, ledger=ledger, store=store, interval=interval,
        iterations=iterations, window=window))


@jobs.command('cancel')
@click.argument('job_id', type=int)
def jobs_cancel_cmd(job_id):
    """Cancel a managed job (tears its cluster down)."""
    ok = sdk.jobs_cancel(job_id)
    click.echo('Cancel requested.' if ok else 'Job already finished.')


@jobs.command('logs')
@click.argument('job_id', type=int)
@click.option('--no-follow', is_flag=True, default=False)
def jobs_logs_cmd(job_id, no_follow):
    """Tail a managed job's logs."""
    sdk.jobs_tail_logs(job_id, follow=not no_follow)


@cli.group()
def serve():
    """Services: replicated, autoscaled, load-balanced endpoints."""


@serve.command('up')
@click.argument('entrypoint', nargs=-1)
@click.option('--service-name', default=None)
@_apply(_task_options)
def serve_up_cmd(entrypoint, service_name, cluster, detach_run,
                 **overrides):
    """Bring up a service from a task YAML with a service: section."""
    del cluster, detach_run
    task = _load_task(entrypoint, **overrides)
    result = sdk.get(sdk.serve_up(task, service_name))
    click.echo(f'Service {result["name"]!r} starting; endpoint: '
               f'{result["endpoint"]}')


@serve.command('update')
@click.argument('entrypoint', nargs=-1)
@click.option('--service-name', default=None)
@_apply(_task_options)
def serve_update_cmd(entrypoint, service_name, cluster, detach_run,
                     **overrides):
    """Rolling update of a live service to a new task YAML: new-version
    replicas surge up, old ones drain only as replacements turn READY."""
    del cluster, detach_run
    task = _load_task(entrypoint, **overrides)
    result = sdk.get(sdk.serve_update(task, service_name))
    click.echo(f'Service {result["name"]!r}: rolling update to '
               f'v{result["version"]} started.')


@serve.command('down')
@click.argument('service_name')
@click.option('--purge', is_flag=True, default=False,
              help='Force-remove even if the controller is dead.')
def serve_down_cmd(service_name, purge):
    """Tear down a service (replicas, load balancer, controller)."""
    sdk.get(sdk.serve_down(service_name, purge=purge))
    click.echo(f'Service {service_name!r} is shutting down.')


@serve.command('status')
@click.argument('service_names', nargs=-1)
def serve_status_cmd(service_names):
    """Show services and their replicas."""
    for svc in sdk.serve_status(list(service_names) or None):
        click.echo(f'{svc["name"]}: {svc["status"]}  '
                   f'endpoint={svc["endpoint"]}')
        rows = []
        for r in svc['replicas']:
            rows.append([r['replica_id'], r['status'],
                         r.get('url') or '-',
                         r.get('zone') or '-',
                         'spot' if r.get('is_spot') else 'on-demand'])
        if rows:
            ux_utils.print_table(
                ['REPLICA', 'STATUS', 'URL', 'ZONE', 'KIND'], rows)


@serve.command('logs')
@click.argument('service_name')
@click.argument('replica_id', type=int)
@click.option('--follow', is_flag=True, default=False)
def serve_logs_cmd(service_name, replica_id, follow):
    """Stream one replica's workload logs."""
    sdk.serve_replica_logs(service_name, replica_id, follow=follow)


@cli.group()
def api():
    """API server management."""


@api.command('start')
def api_start():
    sdk.ensure_server_running()
    click.echo(f'API server running at {sdk.server_url()}.')


@api.command('info')
def api_info_cmd():
    info = sdk.api_info()
    click.echo(info if info else 'API server not running.')


def main() -> None:
    try:
        cli()
    except exceptions.SkyTpuError as e:
        click.echo(f'Error: {e}', err=True)
        sys.exit(1)


if __name__ == '__main__':
    main()
