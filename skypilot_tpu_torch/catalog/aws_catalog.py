"""AWS EC2 instance catalog (parity: sky/catalog/aws_catalog.py).

CPU families only: this build is TPU-first — AWS is the second compute
substrate for controllers, CPU tasks and S3-adjacent work, not an
accelerator cloud.  Same CSV-with-staleness-stamp mechanics as the GCP
catalog (catalog/common.py); prices are per-region (EC2 list prices
differ across regions, unlike the region-flat GCE sheet we ship).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.catalog import common

_vm_df = common.LazyDataFrame('aws_vms.csv')

DEFAULT_REGION = 'us-east-1'


def regions() -> List[str]:
    return sorted(_vm_df.read()['region'].unique())


def _rows(instance_type: str, region: Optional[str] = None):
    df = _vm_df.read()
    df = df[df['instance_type'] == instance_type]
    if region is not None:
        df = df[df['region'] == region]
    return df


def get_vm_spec(instance_type: str) -> Tuple[float, float]:
    """(vcpus, memory_gb)."""
    rows = _rows(instance_type)
    if rows.empty:
        raise exceptions.InvalidResourcesError(
            f'Unknown EC2 instance type: {instance_type!r}')
    r = rows.iloc[0]
    return float(r['vcpus']), float(r['memory_gb'])


def get_vm_hourly_cost(instance_type: str,
                       region: Optional[str] = None,
                       use_spot: bool = False) -> float:
    rows = _rows(instance_type, region)
    if rows.empty:
        where = region or 'any region'
        raise exceptions.ResourcesUnavailableError(
            f'{instance_type} is not offered in {where} '
            f'(AWS catalog).')
    col = 'spot_price_hr' if use_spot else 'price_hr'
    return float(rows.sort_values(col).iloc[0][col])


def get_default_instance_type(cpus: Optional[str] = None,
                              memory: Optional[str] = None,
                              region: Optional[str] = None
                              ) -> Optional[str]:
    """Cheapest type satisfying the cpu/memory bounds ('4', '4+')."""
    df = _vm_df.read()
    if region is not None:
        df = df[df['region'] == region]
    if cpus is None and memory is None:
        cpus = '4+'     # controller-friendly default, matches GCP path
    df = common.parse_cpus_filter(df, cpus)
    df = common.parse_memory_filter(df, memory)
    if df.empty:
        return None
    return df.sort_values('price_hr').iloc[0]['instance_type']
