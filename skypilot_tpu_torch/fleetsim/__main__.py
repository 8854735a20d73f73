"""CLI: ``python -m skypilot_tpu_torch.fleetsim [--smoke] [--seed N] ...``

Runs one fleet simulation and prints the headline plus the ranked
control-plane profile (or the full result as JSON with ``--json``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from skypilot_tpu_torch.fleetsim import profile as profile_lib
from skypilot_tpu_torch.fleetsim import scenario as scenario_lib
from skypilot_tpu_torch.fleetsim import sim as sim_lib


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m skypilot_tpu_torch.fleetsim',
        description='Fleet-scale simulation: the real control plane '
                    'against virtual replicas.')
    parser.add_argument('--smoke', action='store_true',
                        help='CI-sized run (small fleet, 60 s horizon)')
    parser.add_argument('--seed', type=int, default=None,
                        help='RNG seed (default: the canonical '
                             'FLEET_SEED)')
    parser.add_argument('--horizon', type=float, default=None,
                        help='override the sim horizon in seconds')
    parser.add_argument('--scenario', default=None, metavar='YAML',
                        help='scenario file (events + bursts); '
                             'default: the canonical storm script')
    parser.add_argument('--db', default=None,
                        help='state DSN: sqlite path or postgresql:// '
                             'URL (default: fresh temp sqlite)')
    parser.add_argument('--json', action='store_true',
                        help='emit the full result as JSON')
    args = parser.parse_args(argv)

    config = sim_lib.fleet_config(smoke=args.smoke, seed=args.seed,
                                  db=args.db)
    if args.horizon is not None:
        config = dataclasses.replace(config, horizon_s=args.horizon)
    if args.scenario is not None:
        config = dataclasses.replace(
            config, scenario=scenario_lib.Scenario.load(args.scenario))

    result = sim_lib.run_fleet(config)
    if args.json:
        json.dump(result.to_dict(with_history=True), sys.stdout,
                  indent=2)
        sys.stdout.write('\n')
    else:
        print(result.headline())
        print(f'backend={result.backend} seed={result.seed} '
              f'horizon={result.horizon_s:.0f}s '
              f'admitted={result.admitted} shed={result.shed} '
              f'no_ready={result.no_ready} retried={result.retried} '
              f'prefix_hit_rate={result.prefix_hit_rate:.1%} '
              f'lease_frozen={result.lease_frozen_s:.0f}s '
              f'wall={result.wall_s:.1f}s')
        print()
        print(profile_lib.render_report(result.profile))
    return 0


if __name__ == '__main__':
    sys.exit(main())
