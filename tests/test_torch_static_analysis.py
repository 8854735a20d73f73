"""Tier-1 gate for the port's hot-path invariant analyzer
(skypilot_tpu_torch/analysis), the mirror of tests/test_static_analysis.py.

1. THE GATE — zero unsuppressed findings over skypilot_tpu_torch/ with
   the full rule set, anchored at the real engine/trainer/RL loops, and
   the engine's `# skytpu: allow-sync` annotations load-bearing.

2. THE ANALYZER'S OWN COVERAGE — known-bad fixtures per rule
   (tests/fixtures/torch_analysis/), every PyTorch sync form, captures
   and compiles, suppression semantics, JSON schema, the command.

3. PARITY — the four rules copied from the JAX analyzer give its
   findings, field for field, on a copy of tests/fixtures/analysis/ with
   the package renamed.
"""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from skypilot_tpu import analysis as jax_analysis
from skypilot_tpu_torch import analysis
from skypilot_tpu_torch.analysis import __main__ as cli
from skypilot_tpu_torch.analysis import reporters
from skypilot_tpu_torch.analysis.rules import all_rules
from skypilot_tpu_torch.analysis.rules.hot_loop_sync import (
    DEFAULT_ENTRY_POINTS)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, 'skypilot_tpu_torch')
FIXTURES = os.path.join(REPO, 'tests', 'fixtures', 'torch_analysis')
JAX_FIXTURES = os.path.join(REPO, 'tests', 'fixtures', 'analysis')
ENGINE = os.path.join(PKG, 'inference', 'engine.py')
ALLOW_SYNC = re.compile(r'#\s*skytpu:\s*allow-sync\([^)]*\)')
# The rules copied verbatim from the JAX analyzer.
COPIED_RULES = ['blocking-in-async', 'db-discipline', 'unbounded-io',
                'metric-naming']


def _by_rule(findings):
    out = {}
    for f in findings:
        out.setdefault(f.rule, []).append(f)
    return out


@pytest.fixture(scope='module')
def port_report():
    return analysis.run_check([PKG])


@pytest.fixture(scope='module')
def fixture_report():
    return analysis.run_check([FIXTURES])


# ---------------------------------------------------------------------------
# 1. the gate
# ---------------------------------------------------------------------------
def test_port_has_zero_findings(port_report):
    """THE invariant gate: the whole port is clean under every rule.

    If this fails after your change, either fix the violation or — if
    it is intentional — annotate the call site with
    `# skytpu: allow-<rule>(<reason>)` and defend the reason in review.
    """
    assert not port_report.parse_errors, port_report.parse_errors
    assert len(port_report.rules) >= 7
    msgs = '\n'.join(f.format() for f in port_report.unsuppressed)
    assert not port_report.unsuppressed, (
        f'new invariant violations:\n{msgs}')
    for f in port_report.suppressed:
        assert f.reason, f.format()


@pytest.mark.parametrize('entry', DEFAULT_ENTRY_POINTS)
def test_gate_covers_the_real_loops(port_report, entry):
    """Every backstop entry point is a function of the port, and the
    sync rule anchors at it — a rename without updating the backstops
    would let the gate pass vacuously."""
    assert entry in port_report.entry_points, port_report.entry_points


def test_engine_contract_fetches_are_suppressed_with_reasons(port_report):
    """The engine's one fetch per step (synchronous and pipelined) is
    visible to the analyzer as a SUPPRESSED finding with its reason."""
    engine = [f for f in port_report.suppressed
              if f.rule == 'hot-loop-sync' and
              f.path == 'inference/engine.py']
    assert len(engine) >= 2
    for fn in ('_step', '_step_pipelined'):
        hits = [f for f in engine if f.message.startswith('.cpu() in ') and
                f'DecodeEngine.{fn} ' in f.message]
        assert len(hits) == 1, (fn, engine)
        assert 'ONE' in hits[0].reason


def _engine_annotations():
    with open(ENGINE) as f:
        return list(ALLOW_SYNC.finditer(f.read()))


@pytest.mark.parametrize('index', range(len(_engine_annotations())))
def test_deleting_any_engine_allow_sync_fails_the_gate(tmp_path, index):
    """Strip any ONE `# skytpu: allow-sync` annotation from a copy of the
    port's inference/engine.py (kept at its package path, so the
    backstop entry points apply too) and the gate must fail."""
    with open(ENGINE) as f:
        src = f.read()
    annotations = _engine_annotations()
    assert len(annotations) >= 2, 'engine.py lost its sync annotations'
    root = tmp_path / 'skypilot_tpu_torch' / 'inference'
    root.mkdir(parents=True)
    path = root / 'engine.py'
    path.write_text(src)
    intact = analysis.run_check([str(path)], rules=['hot-loop-sync'])
    assert not intact.unsuppressed
    assert len(intact.suppressed) >= len(annotations)
    m = annotations[index]
    path.write_text(src[:m.start()] + src[m.end():])
    report = analysis.run_check([str(path)], rules=['hot-loop-sync'])
    assert report.unsuppressed, f'deleting annotation #{index} did not fail'
    assert all(f.rule == 'hot-loop-sync' for f in report.unsuppressed)


# ---------------------------------------------------------------------------
# 2. every rule fires on a known-bad fixture
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('rule_name', [r.name for r in all_rules()])
def test_rule_fires_on_known_bad_fixture(fixture_report, rule_name):
    hits = [f for f in fixture_report.unsuppressed if f.rule == rule_name]
    assert hits, f'{rule_name} found nothing in its known-bad fixtures'


SYNC_FORMS = ['.item()', '.tolist()', '.cpu()', '.numpy()', ".to('cpu')",
              'torch.cuda.synchronize()', '.synchronize()',
              'np.asarray(<tensor>)', 'float(<tensor>)', 'int(<tensor>)',
              'bool(<tensor>)', '.nonzero()', 'torch.nonzero(...)',
              'torch.unique(...)', 'torch.masked_select(...)',
              '.any() as an if test', '.all() as a while test',
              'torch.tensor(..., device=) (blocking upload)']


@pytest.mark.parametrize('form', SYNC_FORMS)
def test_every_sync_form_is_flagged(fixture_report, form):
    hits = [f for f in fixture_report.unsuppressed
            if f.path == 'hot_sync/bad_sync.py' and
            f.message.startswith(form + ' ')]
    assert hits, form


def test_sync_reach_and_capture_boundaries(fixture_report):
    sync = [f for f in _by_rule(fixture_report.unsuppressed)[
        'hot-loop-sync'] if f.path == 'hot_sync/bad_sync.py']
    # Two calls away from the entry point: flagged.
    assert any('helper_two' in f.message for f in sync)
    # Past the reachable functions, inside a capture block and in a
    # _capture method: not flagged.
    lines = open(os.path.join(FIXTURES, 'hot_sync/bad_sync.py')).read(
    ).splitlines()
    quiet = {i + 1 for i, line in enumerate(lines)
             if 'not flagged' in line or 'must NOT' in line}
    flagged = {f.line for f in sync}
    assert quiet and not quiet & flagged
    assert not any('unreachable' in f.message or '_capture' in f.message
                   for f in sync)
    # .to(device='cpu') is the second .to('cpu') of the fixture.
    assert sum(f.message.startswith(".to('cpu')") for f in sync) == 2


def test_recompile_findings_land_where_expected(fixture_report):
    rc = _by_rule(fixture_report.unsuppressed)['recompile-hazard']
    loops = [f for f in rc if 'inside a loop' in f.message]
    assert {f.path for f in loops} == {'recompile/bad_capture_in_loop.py'}
    assert sorted(f.message.split(' inside')[0] for f in loops) == [
        'CUDA-graph capture', 'kernel build', 'torch.compile']
    hot = [f for f in rc if 'reachable from a hot' in f.message]
    assert {f.path for f in hot} == {'recompile/inference/engine.py'}
    assert len(hot) == 2 and all('Engine._build,' in f.message for f in hot)
    suppressed = [f for f in fixture_report.suppressed
                  if f.rule == 'recompile-hazard']
    assert len(suppressed) == 1
    assert 'one-shot capture' in suppressed[0].reason


def test_speculation_findings_land_where_expected(fixture_report):
    spec = _by_rule(fixture_report.unsuppressed)['speculation']
    assert {f.path for f in spec} == {'inference/bad_speculation.py'}
    assert len(spec) == 2
    msgs = ' '.join(f.message for f in spec)
    assert "CUDA-graph capture inside '_propose_and_verify'" in msgs
    assert "verify graph built in 'step'" in msgs


# ---------------------------------------------------------------------------
# suppression semantics
# ---------------------------------------------------------------------------
def test_suppression_with_reason_suppresses():
    report = analysis.run_check(
        [os.path.join(FIXTURES, 'hot_sync', 'good_sync.py')],
        rules=['hot-loop-sync'])
    assert not report.unsuppressed
    assert len(report.suppressed) == 1
    assert 'fixture counterpart' in report.suppressed[0].reason


def test_suppression_requires_a_reason():
    report = analysis.run_check(
        [os.path.join(FIXTURES, 'hot_sync', 'empty_reason.py')],
        rules=['hot-loop-sync'])
    assert len(report.unsuppressed) == 1
    assert 'reason is required' in report.unsuppressed[0].message


def test_unknown_rule_rejected():
    with pytest.raises(ValueError, match='unknown rule'):
        analysis.run_check([FIXTURES], rules=['no-such-rule'])


# ---------------------------------------------------------------------------
# 3. parity with the JAX analyzer
# ---------------------------------------------------------------------------
@pytest.fixture(scope='module')
def renamed_jax_fixtures(tmp_path_factory):
    """tests/fixtures/analysis/ with `skypilot_tpu.` renamed in import
    lines (nothing else changes: lines and columns stay)."""
    root = tmp_path_factory.mktemp('parity') / 'analysis'
    shutil.copytree(JAX_FIXTURES, root)
    for path in root.rglob('*.py'):
        lines = path.read_text().split('\n')
        path.write_text('\n'.join(
            line.replace('skypilot_tpu.', 'skypilot_tpu_torch.')
            if re.match(r'\s*(from|import)\s', line) else line
            for line in lines))
    return str(root)


def _fields(findings, rename=False):
    def msg(m):
        return m.replace('skypilot_tpu.', 'skypilot_tpu_torch.') \
            if rename else m
    return [(f.rule, f.path, f.line, f.col, f.suppressed, f.reason,
             msg(f.message)) for f in findings]


@pytest.mark.parametrize('rule', COPIED_RULES)
def test_copied_rules_match_the_jax_analyzer(renamed_jax_fixtures, rule):
    want = jax_analysis.run_check([JAX_FIXTURES], rules=[rule])
    got = analysis.run_check([renamed_jax_fixtures], rules=[rule])
    assert want.findings, rule
    assert _fields(got.findings) == _fields(want.findings, rename=True)
    assert got.files_scanned == want.files_scanned
    assert got.parse_errors == want.parse_errors


def test_json_reports_match_the_jax_schema(renamed_jax_fixtures):
    want = json.loads(jax_analysis.render_json(
        jax_analysis.run_check([JAX_FIXTURES], rules=COPIED_RULES)))
    got = json.loads(analysis.render_json(
        analysis.run_check([renamed_jax_fixtures], rules=COPIED_RULES)))
    assert got['version'] == want['version'] == 1
    assert set(got) == set(want)
    assert set(got['summary']) == set(want['summary'])
    assert got['summary'] == want['summary']
    assert got['rules'] == want['rules']
    for g, w in zip(got['findings'], want['findings']):
        assert set(g) == set(w)
    assert len(got['findings']) == len(want['findings'])


# ---------------------------------------------------------------------------
# reporters / command
# ---------------------------------------------------------------------------
def test_json_reporter_schema_is_stable(fixture_report):
    doc = json.loads(analysis.render_json(fixture_report, root=FIXTURES))
    assert doc['version'] == reporters.JSON_SCHEMA_VERSION == 1
    assert set(doc) == {'version', 'root', 'rules', 'entry_points',
                        'findings', 'summary'}
    assert set(doc['summary']) == {'total', 'suppressed',
                                   'files_scanned', 'parse_errors'}
    assert doc['summary']['total'] == len(fixture_report.unsuppressed)
    for f in doc['findings']:
        assert set(f) == {'rule', 'path', 'line', 'col', 'message',
                          'suppressed', 'reason'}
    assert doc['findings'] == sorted(
        doc['findings'],
        key=lambda f: (f['path'], f['line'], f['col'], f['rule']))


def test_text_reporter_mentions_suppressed_count(port_report):
    text = analysis.render_text(port_report)
    assert 'no findings' in text
    assert 'annotated exception' in text


def test_command_over_the_port_lists_annotated_sites(capsys):
    assert cli.main(['--show-suppressed']) == 0
    out = capsys.readouterr().out
    assert 'no findings' in out
    assert "the engine's contract" in out
    assert 'one call late' in out


@pytest.mark.parametrize('argv,code', [
    ([FIXTURES], 1),
    ([FIXTURES, '--json'], 1),
    ([FIXTURES, '--rule', 'db-discipline', '--json'], 1),
    ([FIXTURES, '--rule', 'no-such-rule'], 2),
    (['--list-rules'], 0),
])
def test_command_exit_codes(capsys, argv, code):
    assert cli.main(argv) == code
    out = capsys.readouterr().out
    if '--json' in argv:
        doc = json.loads(out)
        assert doc['summary']['total'] > 0
        if '--rule' in argv:
            assert {f['rule'] for f in doc['findings']} == {'db-discipline'}
    if '--list-rules' in argv:
        for r in all_rules():
            assert r.name in out


def test_module_entry_point_and_pure_ast():
    """`python -m skypilot_tpu_torch.analysis` gates the port (exit 0)
    and the torch fixtures (exit 1), and the analyzer imports neither
    torch nor JAX: it parses, it never imports what it analyzes."""
    env = dict(os.environ, PYTHONPATH=REPO)
    ok = subprocess.run([sys.executable, '-m', 'skypilot_tpu_torch.analysis'],
                        cwd=REPO, env=env, capture_output=True, text=True,
                        timeout=120)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert 'no findings' in ok.stdout
    bad = subprocess.run([sys.executable, '-m', 'skypilot_tpu_torch.analysis',
                          FIXTURES], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert bad.returncode == 1
    code = ('import sys\n'
            'from skypilot_tpu_torch import analysis\n'
            'report = analysis.run_check()\n'
            'assert not report.unsuppressed\n'
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
            '("torch", "jax", "skypilot_tpu"))\n'
            'assert not bad, bad\n')
    pure = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert pure.returncode == 0, pure.stderr
