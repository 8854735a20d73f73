"""Run the port's hot-path invariant analyzer.

    python -m skypilot_tpu_torch.analysis [PATHS] [--json] [--rule R]
        [--list-rules] [--show-suppressed]

PATHS default to the installed skypilot_tpu_torch package.  Exit 0 when
there are no unsuppressed findings (and no parse errors), 1 otherwise,
2 on an unknown --rule.  Suppress an intentional exception at the call
site with `# skytpu: allow-<token>(<reason>)`.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from skypilot_tpu_torch import analysis
from skypilot_tpu_torch.analysis.rules import all_rules


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog='python -m skypilot_tpu_torch.analysis',
        description='Hot-path invariant analyzer of skypilot_tpu_torch.')
    ap.add_argument('paths', nargs='*',
                    help='files or directories (default: the package)')
    ap.add_argument('--json', dest='as_json', action='store_true',
                    help='emit the findings as JSON (stable schema)')
    ap.add_argument('--rule', dest='rules', action='append', default=[],
                    help='run only these rules (repeatable)')
    ap.add_argument('--list-rules', action='store_true',
                    help='list the rule set and exit')
    ap.add_argument('--show-suppressed', action='store_true',
                    help='also print annotated exceptions with their '
                         'reasons')
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule in all_rules():
            print(f'{rule.name}: {rule.description} '
                  f'[suppress: # skytpu: allow-'
                  f'{rule.suppress_token}(<reason>)]')
        return 0
    try:
        report = analysis.run_check(args.paths or None, args.rules or None)
    except ValueError as e:          # unknown --rule
        print(str(e), file=sys.stderr)
        return 2
    if args.as_json:
        sys.stdout.write(analysis.render_json(report))
    else:
        out = analysis.render_text(report)
        if args.show_suppressed and report.suppressed:
            lines = [f'{f.format()}: {f.reason}' for f in report.suppressed]
            out = '\n'.join(lines) + '\n' + out
        sys.stdout.write(out)
    return 1 if (report.unsuppressed or report.parse_errors) else 0


if __name__ == '__main__':
    sys.exit(main())
