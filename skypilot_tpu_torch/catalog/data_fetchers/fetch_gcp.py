"""Regenerate the GCP TPU/VM catalogs from the Cloud Billing API.

Analog of the reference's `sky/catalog/data_fetchers/fetch_gcp.py` (which
builds price tables from the billing SKU list).  Writes refreshed CSVs to
`~/.skytpu/catalogs/<schema>/`, which `catalog.common.resolve_catalog_path`
prefers over the bundled copies.

The SKU source is injectable: the real Cloud Billing API (network + GCP
credentials + google-api-python-client), or — with
``SKYTPU_BILLING_FIXTURE=<path.json>`` — a recorded page list committed to
the repo (tests/fixtures/gcp_billing_skus.json), so the whole
SKU-parsing → price-derivation → CSV-writing path runs hermetically in CI
(vcr-style; the fixture file mirrors the API's response shape exactly).

VM prices are derived the way the reference does: an instance type's
$/hr = vcpus x core-SKU price + memory_gb x ram-SKU price for its
family; the vcpu/memory shapes come from the bundled table (the machine-
types API is the authority on shapes, billing only prices them).

Usage: python -m skypilot_tpu_torch.catalog.data_fetchers.fetch_gcp
       (or `skytpu-torch catalog refresh`)
"""
from __future__ import annotations

import json
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Tuple

from skypilot_tpu_torch.catalog import common

_BILLING_SERVICE_GCE = 'services/6F81-5844-456A'  # Compute Engine SKUs
_TPU_SKU_RE = re.compile(r'Tpu[- ]?(v\d+[a-z]*)', re.IGNORECASE)

# VM families whose core/ram SKUs we price.  The SKU descriptions carry
# the family name ('N2 Instance Core running in Americas', 'E2 Instance
# Ram ...'); spot SKUs say 'Spot Preemptible'.
_VM_FAMILIES = ('e2', 'n2', 'c3', 'a2', 'g2', 'm3', 'c3d')
_VM_SKU_RE = re.compile(
    r'^(?:Spot Preemptible )?(' + '|'.join(f.upper() for f in _VM_FAMILIES)
    + r')(?: Instance)? (Core|Ram) running', re.IGNORECASE)


def _unwrap_fixture(obj):
    """Fixture files may wrap the raw page list with recording
    provenance: {"recorded_at": "YYYY-MM-DD", "pages": [...]}.  A bare
    list/dict of pages (vcr-style) stays supported."""
    if isinstance(obj, dict) and 'pages' in obj:
        obj = obj['pages']
    return [obj] if isinstance(obj, dict) else list(obj)


def fixture_recorded_at() -> Optional[float]:
    """Epoch seconds the active billing fixture was recorded, from its
    `recorded_at` field ("YYYY-MM-DD" or epoch seconds).  None when no
    fixture is active or it carries no provenance.  Threaded into the
    written catalogs' .meta.json so staleness tracks the DATA's age,
    not the time someone last replayed the recording."""
    fixture = os.environ.get('SKYTPU_BILLING_FIXTURE')
    if not fixture:
        return None
    try:
        with open(fixture, encoding='utf-8') as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(obj, dict):
        return None
    raw = obj.get('recorded_at')
    if raw is None:
        return None
    try:
        return float(raw)
    except (TypeError, ValueError):
        pass
    try:
        import datetime
        return datetime.datetime.strptime(
            str(raw), '%Y-%m-%d').replace(
                tzinfo=datetime.timezone.utc).timestamp()
    except ValueError:
        return None


def iter_sku_pages() -> Iterable[dict]:
    """Yield billing-API SKU response pages, from the recorded fixture
    (SKYTPU_BILLING_FIXTURE) or the live API."""
    fixture = os.environ.get('SKYTPU_BILLING_FIXTURE')
    if fixture:
        with open(fixture, encoding='utf-8') as f:
            pages = json.load(f)
        yield from _unwrap_fixture(pages)
        return
    try:
        import googleapiclient.discovery  # type: ignore
    except ImportError as e:
        raise SystemExit(
            'google-api-python-client is required to refresh catalogs; '
            'the bundled catalog remains in use.') from e
    billing = googleapiclient.discovery.build('cloudbilling', 'v1')
    req = billing.services().skus().list(parent=_BILLING_SERVICE_GCE)
    while req is not None:
        resp = req.execute()
        yield resp
        req = billing.services().skus().list_next(req, resp)


def _sku_price(sku: dict) -> Optional[float]:
    pricing = sku.get('pricingInfo', [])
    if not pricing:
        return None
    rate = pricing[0]['pricingExpression']['tieredRates'][-1]['unitPrice']
    return float(rate.get('units', 0)) + rate.get('nanos', 0) / 1e9


def fetch_tpu_prices(pages: Optional[Iterable[dict]] = None
                     ) -> List[Dict[str, object]]:
    rows: List[Dict[str, object]] = []
    pages = _unwrap_fixture(pages) if pages is not None else None
    for resp in (pages if pages is not None else iter_sku_pages()):
        for sku in resp.get('skus', []):
            m = _TPU_SKU_RE.search(sku.get('description', ''))
            if not m:
                continue
            gen = m.group(1).lower()
            spot = 'preemptible' in sku.get('description', '').lower()
            price = _sku_price(sku)
            if price is None:
                continue
            for region in sku.get('serviceRegions', []):
                rows.append({
                    'generation': gen,
                    'region': region,
                    'spot': spot,
                    'price_chip_hr': price,
                })
    return rows


def fetch_vm_unit_prices(pages: Optional[Iterable[dict]] = None
                         ) -> Dict[Tuple[str, str, str, bool], float]:
    """{(family, 'core'|'ram', region, spot): unit $/hr}."""
    out: Dict[Tuple[str, str, str, bool], float] = {}
    pages = _unwrap_fixture(pages) if pages is not None else None
    for resp in (pages if pages is not None else iter_sku_pages()):
        for sku in resp.get('skus', []):
            desc = sku.get('description', '')
            m = _VM_SKU_RE.match(desc)
            if not m:
                continue
            family = m.group(1).lower()
            unit = m.group(2).lower()     # core | ram
            spot = desc.lower().startswith('spot preemptible')
            price = _sku_price(sku)
            if price is None:
                continue
            for region in sku.get('serviceRegions', []):
                out[(family, unit, region, spot)] = price
    return out


def derive_vm_rows(unit_prices: Dict[Tuple[str, str, str, bool], float],
                   shapes: 'List[Tuple[str, float, float]]',
                   region: str = 'us-central1'
                   ) -> List[Dict[str, object]]:
    """Price each (instance_type, vcpus, memory_gb) shape from its
    family's core/ram unit SKUs: $/hr = vcpus*core + mem*ram."""
    rows = []
    for instance_type, vcpus, mem in shapes:
        family = instance_type.split('-', 1)[0].split('.')[0]
        core = unit_prices.get((family, 'core', region, False))
        ram = unit_prices.get((family, 'ram', region, False))
        if core is None or ram is None:
            continue
        spot_core = unit_prices.get((family, 'core', region, True),
                                    core * 0.3)
        spot_ram = unit_prices.get((family, 'ram', region, True),
                                   ram * 0.3)
        rows.append({
            'instance_type': instance_type,
            'vcpus': vcpus,
            'memory_gb': mem,
            'price_hr': round(vcpus * core + mem * ram, 4),
            'spot_price_hr': round(vcpus * spot_core + mem * spot_ram, 4),
        })
    return rows


def main() -> int:
    out_dir = common.catalog_override_dir()
    os.makedirs(out_dir, exist_ok=True)
    pages = list(iter_sku_pages())
    rows = fetch_tpu_prices(pages)
    if not rows:
        print('No TPU SKUs returned; keeping bundled catalog.',
              file=sys.stderr)
        return 1
    # Merge on-demand + spot rows into the bundled-catalog schema.  SKU
    # descriptions use marketing names ('v5e'); canonicalize through the
    # accelerator registry so gcp_catalog's generation filter matches.
    from skypilot_tpu_torch import accelerators as acc_lib
    import pandas as pd
    alias_to_gen = acc_lib.alias_to_generation()
    bundled = pd.read_csv(
        os.path.join(common._BUNDLED_DIR, 'gcp_tpus.csv'))
    known_zones: Dict[tuple, List[str]] = {}
    for _, r in bundled.iterrows():
        known_zones.setdefault((r['generation'], r['region']),
                               []).append(r['zone'])
    merged: Dict[tuple, Dict[str, float]] = {}
    for r in rows:
        gen = alias_to_gen.get(str(r['generation']).lower())
        if gen is None:
            continue
        key = (gen, r['region'])
        slot = 'spot_price_chip_hr' if r['spot'] else 'price_chip_hr'
        merged.setdefault(key, {})[slot] = float(r['price_chip_hr'])
    path = os.path.join(out_dir, 'gcp_tpus.csv')
    with open(path, 'w', encoding='utf-8') as f:
        f.write('generation,region,zone,price_chip_hr,spot_price_chip_hr\n')
        for (gen, region), prices in sorted(merged.items()):
            od = prices.get('price_chip_hr')
            sp = prices.get('spot_price_chip_hr', (od or 0) * 0.5)
            if od is None:
                continue
            # Billing SKUs are per-region; zones come from the bundled
            # table (the TPU locations API is the authority — regions
            # without known zones are skipped rather than invented).
            for zone in known_zones.get((gen, region), []):
                f.write(f'{gen},{region},{zone},{od},{sp}\n')
    # Staleness provenance: a fixture replay stamps the RECORDING
    # date, so the catalog's age reflects the data, not the replay.
    recorded_at = fixture_recorded_at()
    common.write_catalog_metadata(path, generated_at=recorded_at)
    print(f'Wrote {path}')

    # VM catalog: price the bundled shapes from core/ram unit SKUs.
    # Families without unit SKUs keep their BUNDLED prices — the refresh
    # must never make a previously-priced instance type unknown (the
    # override CSV shadows the bundled one entirely).
    unit_prices = fetch_vm_unit_prices(pages)
    bundled_vms = pd.read_csv(
        os.path.join(common._BUNDLED_DIR, 'gcp_vms.csv'))
    shapes = [(r['instance_type'], float(r['vcpus']),
               float(r['memory_gb'])) for _, r in bundled_vms.iterrows()]
    derived = {r['instance_type']: r
               for r in derive_vm_rows(unit_prices, shapes)}
    if derived:
        vm_path = os.path.join(out_dir, 'gcp_vms.csv')
        with open(vm_path, 'w', encoding='utf-8') as f:
            f.write('instance_type,vcpus,memory_gb,price_hr,'
                    'spot_price_hr\n')
            for _, b in bundled_vms.iterrows():
                r = derived.get(b['instance_type'])
                if r is not None:
                    f.write(f"{r['instance_type']},{r['vcpus']},"
                            f"{r['memory_gb']},{r['price_hr']},"
                            f"{r['spot_price_hr']}\n")
                else:
                    f.write(f"{b['instance_type']},{b['vcpus']},"
                            f"{b['memory_gb']},{b['price_hr']},"
                            f"{b['spot_price_hr']}\n")
        common.write_catalog_metadata(vm_path, generated_at=recorded_at)
        print(f'Wrote {vm_path}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
