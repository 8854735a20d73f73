"""The GCP catalog fetcher of the port against the JAX package's, from
the recorded billing-SKU fixture (tests/fixtures/gcp_billing_skus.json):
the parsed TPU and VM unit prices, the derived VM rows, the CSVs and
sidecars `main()` writes, the catalog reading them back, and `catalog
refresh` of each CLI, compared exactly (mirrors
tests/test_catalog_fetcher.py)."""
import json
import os

import pytest
from click.testing import CliRunner

from tests.torch_parity import Pkg, run_both

FIXTURE = os.path.join(os.path.dirname(__file__), 'fixtures',
                       'gcp_billing_skus.json')
JAX, PORT = Pkg('skypilot_tpu'), Pkg('skypilot_tpu_torch')


@pytest.fixture(autouse=True)
def billing_fixture(monkeypatch):
    monkeypatch.setenv('SKYTPU_BILLING_FIXTURE', FIXTURE)


def test_sku_parsing_and_price_derivation():
    with open(FIXTURE, encoding='utf-8') as f:
        pages = json.load(f)
    shapes = [('n2-standard-4', 4.0, 16.0), ('unknown-family-2', 2, 8)]
    got = []
    for pkg in (JAX, PORT):
        fetch = pkg('catalog.data_fetchers.fetch_gcp')
        units = fetch.fetch_vm_unit_prices(pages)
        got.append((fetch.fetch_tpu_prices(pages), units,
                    fetch.derive_vm_rows(units, shapes),
                    fetch.fixture_recorded_at()))
    assert got[1] == got[0]
    tpu_rows, units, vm_rows, _ = got[1]
    assert any(r['generation'] == 'v5e' and r['region'] == 'us-west4'
               for r in tpu_rows)
    assert units[('n2', 'core', 'us-central1', False)] == pytest.approx(
        0.031611)
    assert len(vm_rows) == 1


def _catalog_files(pkg):
    common = pkg('catalog.common')
    override = common.catalog_override_dir()
    files = {}
    for name in sorted(os.listdir(override)):
        with open(os.path.join(override, name), encoding='utf-8') as f:
            files[name] = f.read()
    return files


def test_main_writes_the_same_catalogs_and_the_catalog_prefers_them(
        tmp_path, monkeypatch):
    def scenario(pkg):
        rc = pkg('catalog.data_fetchers.fetch_gcp').main()
        common = pkg('catalog.common')
        gcp_catalog = pkg('catalog.gcp_catalog')
        gcp_catalog._tpu_df.invalidate()  # pylint: disable=protected-access
        gcp_catalog._vm_df.invalidate()  # pylint: disable=protected-access
        try:
            prices = (gcp_catalog.get_tpu_hourly_cost('tpu-v5p-8',
                                                      zone='us-east5-a'),
                      gcp_catalog.get_vm_hourly_cost('n2-standard-4'))
        finally:
            gcp_catalog._tpu_df.invalidate()  # pylint: disable=protected-access
            gcp_catalog._vm_df.invalidate()  # pylint: disable=protected-access
        return (rc, _catalog_files(pkg),
                common.resolve_catalog_path('gcp_tpus.csv').replace(
                    os.environ['HOME'], 'HOME'),
                prices, {n: common.catalog_staleness(n)['stale']
                         for n in ('gcp_tpus.csv', 'gcp_vms.csv')})

    jax_side, port_side = run_both(scenario, tmp_path, monkeypatch)
    assert port_side == jax_side
    rc, files, path, prices, _ = port_side
    assert rc == 0 and path.startswith('HOME/')
    assert sorted(files) == ['gcp_tpus.csv', 'gcp_tpus.csv.meta.json',
                             'gcp_vms.csv', 'gcp_vms.csv.meta.json']
    assert prices[0] == pytest.approx(4 * 4.2)


def test_catalog_refresh_cli(tmp_path, monkeypatch):
    """`catalog refresh` runs the fetcher in both CLIs: exit 0, the same
    files written (the port's message names its own command)."""
    def scenario(pkg):
        result = CliRunner().invoke(pkg('client.cli').cli,
                                    ['catalog', 'refresh'])
        return (result.exit_code,
                result.output.replace(os.environ['HOME'], 'HOME').replace(
                    'skytpu-torch', 'skytpu'),
                _catalog_files(pkg))

    jax_side, port_side = run_both(scenario, tmp_path, monkeypatch)
    assert port_side == jax_side
    assert port_side[0] == 0 and 'Catalogs refreshed' in port_side[1]
