"""Reporters: human text and machine-stable JSON for the analyzer.

The JSON schema is versioned and pinned by
tests/test_torch_static_analysis.py (as the JAX package's is by
tests/test_static_analysis.py) — CI uploads the findings file as a
build artifact, so downstream tooling may parse it; bump ``version``
on any breaking shape change.
"""
from __future__ import annotations

import json
from typing import Optional

from skypilot_tpu_torch.analysis.core import Report

JSON_SCHEMA_VERSION = 1


def render_text(report: Report, root: Optional[str] = None) -> str:
    lines = []
    for f in report.findings:
        if not f.suppressed:
            lines.append(f.format())
    n, s = len(report.unsuppressed), len(report.suppressed)
    for err in report.parse_errors:
        lines.append(f'PARSE ERROR: {err}')
    if n == 0 and not report.parse_errors:
        lines.append(
            f'skytpu check: no findings '
            f'({len(report.rules)} rules, {report.files_scanned} '
            f'files, {s} annotated exception'
            f'{"s" if s != 1 else ""}).')
    else:
        lines.append(
            f'skytpu check: {n} finding{"s" if n != 1 else ""} '
            f'({s} suppressed) across {report.files_scanned} files.')
    return '\n'.join(lines) + '\n'


def render_json(report: Report, root: Optional[str] = None) -> str:
    doc = {
        'version': JSON_SCHEMA_VERSION,
        'root': root,
        'rules': list(report.rules),
        'entry_points': list(report.entry_points),
        'findings': [
            {
                'rule': f.rule,
                'path': f.path,
                'line': f.line,
                'col': f.col,
                'message': f.message,
                'suppressed': f.suppressed,
                'reason': f.reason,
            }
            for f in report.findings
        ],
        'summary': {
            'total': len(report.unsuppressed),
            'suppressed': len(report.suppressed),
            'files_scanned': report.files_scanned,
            'parse_errors': list(report.parse_errors),
        },
    }
    return json.dumps(doc, indent=2, sort_keys=True) + '\n'
