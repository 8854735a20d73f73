"""db-discipline: ONE database access layer.

The state-backend subsystem (skypilot_tpu_torch/state/: sqlite + Postgres
selected by DSN) swaps cleanly precisely because every connection in
the tree flows through the ``utils/db_utils.py`` funnel — a stray
``sqlite3.connect`` (or a stray ``psycopg.connect``) anywhere else is
a silent second source of truth that the other backend will not see,
and that the lease/claim protocol cannot protect.  This rule pins the
funnel: holding the ``sqlite3`` **or** ``psycopg`` import at all is
only legal in the backend implementations under ``state/`` (plus the
funnel itself and the state modules written against it).
"""
from __future__ import annotations

import ast
from typing import List

from skypilot_tpu_torch.analysis import callgraph as cg
from skypilot_tpu_torch.analysis.core import Finding, Project, Rule

# The funnel + the backends behind it + the state modules above it.
ALLOWED_FILES = (
    'utils/db_utils.py',          # the op-set funnel itself
    'state/__init__.py',          # backend selection (DSN dispatch)
    'state/sqlite.py',            # sqlite backend (holds sqlite3)
    'state/postgres.py',          # Postgres backend (holds psycopg)
    'state/dialect.py',           # SQL translation (no connections)
    'state/leases.py',            # heartbeat leases (via db_utils)
    'global_user_state.py',       # cluster/user state
    'jobs/state.py',              # managed-jobs state
    'serve/serve_state.py',       # serve services/replicas
    'server/requests_db.py',      # API request records
)

# Database client modules whose import anywhere else breaks the funnel.
_DB_MODULES = ('sqlite3', 'psycopg', 'psycopg2')


class DbDisciplineRule(Rule):
    name = 'db-discipline'
    suppress_token = 'db'
    description = ('direct sqlite3/psycopg use outside the state-store '
                   'funnel (utils/db_utils.py + skypilot_tpu_torch/state/ '
                   'backends + the state modules)')

    def check(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        for module in project.modules:
            if any(module.path.endswith(a) or module.rel.endswith(a)
                   for a in ALLOWED_FILES):
                continue
            for node in ast.walk(module.tree):
                if isinstance(node, ast.Import):
                    for a in node.names:
                        if a.name.split('.')[0] in _DB_MODULES:
                            findings.append(project.finding(
                                self, module, node,
                                f'import {a.name.split(".")[0]} outside '
                                f'the DB access layer — all connections '
                                f'must flow through utils/db_utils.py '
                                f'(the funnel the state backends live '
                                f'behind)'))
                elif isinstance(node, ast.ImportFrom):
                    root = (node.module or '').split('.')[0]
                    if root in _DB_MODULES:
                        findings.append(project.finding(
                            self, module, node,
                            f'from {root} import ... outside the DB '
                            f'access layer — use utils/db_utils.py'))
                elif isinstance(node, ast.Call):
                    dotted = cg._dotted(node.func)
                    if dotted is None:
                        continue
                    resolved = cg.resolve_alias(dotted, module)
                    if resolved.split('.')[0] in _DB_MODULES:
                        findings.append(project.finding(
                            self, module, node,
                            f'{resolved}(...) outside the DB access '
                            f'layer — all database connections go '
                            f'through utils/db_utils.py so both '
                            f'backends (sqlite, Postgres) see one '
                            f'source of truth'))
        return findings
