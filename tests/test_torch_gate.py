"""The port's perf-regression gate (`skypilot_tpu_torch/perf/gate.py`)
against the JAX package's (`skypilot_tpu/perf/gate.py`; mirrors the gate
cases of tests/test_perf.py):

- the names copied verbatim behave as the JAX ones on the same inputs
  (their sources are pinned in tests/test_torch_package.py);
- the port's `run()` against the newest committed BENCH_*.json is `ok`
  on the CPU, with the same check names and statuses as the JAX gate's
  `run()` (ratio checks skipped as cross-host, the three gauge checks
  within 5%, one roofline row per bucket);
- `python -m skypilot_tpu_torch.perf.gate --check` exits 1 on a broken
  baseline, 0 without `--check`, and refuses to run without a card
  unless `--device cpu` is given.
"""
import json
import pathlib
import subprocess
import sys

import pytest
import torch

from skypilot_tpu.perf import gate as jax_gate
from skypilot_tpu_torch.perf import gate as torch_gate

REPO = pathlib.Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


def _fake_probe():
    return {'chip': 'cpu', 'model': 'tiny', 'out_tok_per_s': 10.0,
            'mfu_live_pct': 1.0, 'mfu_bench_pct': 1.0,
            'hbm_bytes_per_token_live': 5.0,
            'hbm_bytes_per_token_bench': 5.0,
            'hbm_bytes_per_token_live_int8': 4.0,
            'hbm_bytes_per_token_bench_int8': 4.0,
            'arith_intensity': 1.0, 'roofline': []}


@pytest.fixture(scope='module')
def baseline_path():
    path, _ = torch_gate.latest_bench(str(REPO))
    assert path == jax_gate.latest_bench(str(REPO))[0]
    return path


@pytest.fixture(scope='module')
def reports(baseline_path):
    """(JAX report, port report) of a fresh probe each on the CPU."""
    return (jax_gate.run(baseline_path=baseline_path),
            torch_gate.run(baseline_path=baseline_path,
                           probe_fn=lambda: torch_gate.probe_serve('cpu')))


def test_latest_bench_picks_highest_round(tmp_path):
    (tmp_path / 'BENCH_r02.json').write_text('{"n": 2}')
    (tmp_path / 'BENCH_r07.json').write_text('{"n": 7}')
    (tmp_path / 'BENCH_r10.json').write_text('{"n": 10}')
    for gate in (jax_gate, torch_gate):
        path, doc = gate.latest_bench(str(tmp_path))
        assert path.endswith('BENCH_r10.json') and doc['n'] == 10
        with pytest.raises(FileNotFoundError):
            gate.latest_bench(str(tmp_path / 'empty'))


def test_copied_checks_agree_with_the_jax_gate():
    assert torch_gate.TOLERANCES == jax_gate.TOLERANCES
    assert torch_gate.GAUGE_AGREEMENT_FRAC == jax_gate.GAUGE_AGREEMENT_FRAC
    for live, bench in ((1.04, 1.0), (1.06, 1.0), (None, 1.0), (1.0, 0.0),
                        (-1.0, -1.0)):
        assert (torch_gate._agreement_check('x', live, bench) ==
                jax_gate._agreement_check('x', live, bench))
    for fresh, base in ((10.0, 4.0), (1.0, 4.0), (3.0, None)):
        assert (torch_gate._ratio_check('y', fresh, base, 0.5, 2.0) ==
                jax_gate._ratio_check('y', fresh, base, 0.5, 2.0))
    tree = {'a': {'b': {'c': 3}}}
    for dotted in ('a.b.c', 'a.b', 'a.x', 'a.b.c.d'):
        assert torch_gate._dig(tree, dotted) == jax_gate._dig(tree, dotted)


def test_gate_passes_against_committed_bench(reports):
    """`--check` semantics against the newest committed round on the
    CPU: cross-host ratio checks skip, the gauge checks hold."""
    _, report = reports
    assert report['ok'], json.dumps(report['checks'], indent=2)
    by_name = {c['name']: c for c in report['checks']}
    for name in ('baseline-parse', 'baseline-structure', 'probe-throughput',
                 'gauge-vs-bench-mfu', 'gauge-vs-bench-hbm-bytes-per-token',
                 'gauge-vs-bench-hbm-bytes-per-token-int8'):
        assert by_name[name]['status'] == 'ok', by_name[name]
    assert report['probe']['chip'] == 'cpu'
    for dotted in torch_gate.TOLERANCES:
        assert by_name[f'tolerance:{dotted}']['status'] == 'skip'
    buckets = [c for c in report['checks']
               if c['name'].startswith('roofline:bucket=')]
    assert len(buckets) == 2 and all(c['status'] == 'ok' for c in buckets)
    text = torch_gate.render_report(report)
    assert 'PASS' in text and 'observed vs roofline' in text
    assert '[SKIP]' in text


def test_gate_matches_the_jax_gate(reports):
    """The same checks, in the same order, with the same statuses, and
    the same probe report keys and static fields."""
    jax_report, report = reports
    assert ([(c['name'], c['status']) for c in report['checks']] ==
            [(c['name'], c['status']) for c in jax_report['checks']])
    assert sorted(report) == sorted(jax_report)
    assert sorted(report['probe']) == sorted(jax_report['probe'])
    for key in ('chip', 'model'):
        assert report['probe'][key] == jax_report['probe'][key]
    assert ([r['bucket'] for r in report['probe']['roofline']] ==
            [r['bucket'] for r in jax_report['probe']['roofline']])
    assert report['baseline_round'] == jax_report['baseline_round']


def test_gate_fails_on_broken_baseline(tmp_path):
    bad = tmp_path / 'BENCH_r99.json'
    bad.write_text(json.dumps({'n': 99, 'rc': 1, 'parsed': {}}))
    reports = [gate.run(baseline_path=str(bad), probe_fn=_fake_probe)
               for gate in (jax_gate, torch_gate)]
    assert reports[0] == reports[1]
    assert not reports[1]['ok']
    assert 'FAIL' in torch_gate.render_report(reports[1])


def test_main_check_exits_1_on_broken_baseline(tmp_path, monkeypatch,
                                               capsys):
    bad = tmp_path / 'BENCH_r99.json'
    bad.write_text(json.dumps({'n': 99, 'rc': 1, 'parsed': {}}))
    devices = []

    def probe(device=None):
        devices.append(device)
        return _fake_probe()

    monkeypatch.setattr(torch_gate, 'probe_serve', probe)
    argv = ['--baseline', str(bad), '--device', 'cpu']
    assert torch_gate.main(['--check'] + argv) == 1
    assert 'FAIL' in capsys.readouterr().out
    assert torch_gate.main(argv) == 0
    assert devices == ['cpu', 'cpu']
    with pytest.raises(SystemExit):
        torch_gate.main(['--baseline', str(tmp_path / 'absent.json')])


def test_main_as_json_emits_the_report(tmp_path, monkeypatch, capsys):
    bad = tmp_path / 'BENCH_r99.json'
    bad.write_text(json.dumps({'n': 99, 'rc': 1, 'parsed': {}}))
    monkeypatch.setattr(torch_gate, 'probe_serve',
                        lambda device=None: _fake_probe())
    assert torch_gate.main(['--baseline', str(bad), '--device', 'cpu',
                            '--as-json']) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc['ok'] is False and doc['baseline_round'] == 99
    assert doc == torch_gate.run(baseline_path=str(bad),
                                 probe_fn=_fake_probe)


def test_module_entry_needs_cuda_unless_told_cpu(baseline_path):
    """`python -m skypilot_tpu_torch.perf.gate` probes the card by
    default: without one it fails (no CPU fallback)."""
    code = ('import torch, sys\n'
            'torch.cuda.is_available = lambda: False\n'
            'from skypilot_tpu_torch.perf import gate\n'
            f'sys.exit(gate.main(["--baseline", {baseline_path!r}]))\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert 'no CUDA device' in proc.stderr
