"""Kubernetes accelerator/pod metrics scraping (parity:
sky/metrics/utils.py:218-424 — the reference scrapes GPU metrics from
k8s nodes and surfaces them through the API server).

TPU-native shape: our k8s substrate runs pods-as-nodes
(provision/kubernetes), so the interesting signals are per-pod —
cpu/memory usage from the metrics.k8s.io API (metrics-server) and the
TPU chip count from the pod spec's `google.com/tpu` resource request.
`scrape_once()` refreshes the server's Prometheus gauges
(server/metrics.py), which `/metrics` then exports:

    skytpu_k8s_pod_cpu_millicores{cluster,pod}
    skytpu_k8s_pod_memory_bytes{cluster,pod}
    skytpu_k8s_pod_tpu_chips{cluster,pod}

Runs as a server daemon (server/daemons.py) when a k8s endpoint is
configured; a scrape failure never raises (metrics are best-effort).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional

from skypilot_tpu_torch import sky_logging

logger = sky_logging.init_logger(__name__)

_CLUSTER_LABEL = 'skytpu-cluster'

# (cluster, pod) label pairs written by the previous scrape, so vanished
# pods' gauge series can be removed instead of going stale.
_last_scraped_pods: set = set()


def _parse_cpu(q) -> float:
    """k8s cpu quantity -> millicores ('250m' -> 250, '2' -> 2000).

    Metrics come from an external API: malformed/empty quantities parse
    to 0.0 — a garbled pod must not raise out of the whole scrape."""
    q = str(q).strip()
    if not q:
        return 0.0
    try:
        if q.endswith('n'):
            return max(0.0, float(q[:-1]) / 1e6)
        if q.endswith('u'):
            return max(0.0, float(q[:-1]) / 1e3)
        if q.endswith('m'):
            return max(0.0, float(q[:-1]))
        return max(0.0, float(q) * 1000.0)
    except ValueError:
        return 0.0


_MEM_SUFFIX = {'Ki': 2**10, 'Mi': 2**20, 'Gi': 2**30, 'Ti': 2**40,
               'Pi': 2**50, 'Ei': 2**60,
               'K': 1e3, 'k': 1e3, 'M': 1e6, 'G': 1e9, 'T': 1e12,
               'P': 1e15, 'E': 1e18,
               # Decimal sub-unit suffixes are legal quantities too —
               # metrics-server emits millibyte forms from cgroup math.
               'm': 1e-3, 'u': 1e-6, 'n': 1e-9}


def _parse_mem(q) -> float:
    """k8s memory quantity -> bytes.  Malformed/empty -> 0.0; an
    UNKNOWN suffix also parses to 0.0 rather than silently dropping the
    multiplier ('10Xi' as 10 bytes would underreport by orders of
    magnitude)."""
    q = str(q).strip()
    if not q:
        return 0.0
    m = re.match(r'^([0-9]*\.?[0-9]+)([A-Za-z]*)$', q)
    if m is None:
        # Plain/scientific float without a suffix ('1e3' defeats the
        # suffix regex but is a legal quantity).
        try:
            return max(0.0, float(q))
        except ValueError:
            return 0.0
    val, suffix = float(m.group(1)), m.group(2)
    if suffix and suffix not in _MEM_SUFFIX:
        logger.debug(f'unknown memory suffix in quantity {q!r}')
        return 0.0
    return val * _MEM_SUFFIX.get(suffix, 1.0)


def scrape_once(context: Optional[str] = None) -> List[Dict]:
    """One scrape: pod usage + TPU requests -> server metrics gauges.
    Returns the scraped rows (tests; the CLI could table them)."""
    from skypilot_tpu_torch.provision.kubernetes import instance as k8s
    from skypilot_tpu_torch.server import metrics as metrics_lib

    client = k8s._Client(context)  # pylint: disable=protected-access
    ns = k8s._namespace()          # pylint: disable=protected-access
    rows: List[Dict] = []

    # Pod specs: our clusters + their TPU chip requests.
    resp = client.request('GET', '/pods')
    resp.raise_for_status()
    chips_by_pod: Dict[str, int] = {}
    cluster_by_pod: Dict[str, str] = {}
    for pod in resp.json().get('items', []):
        labels = pod['metadata'].get('labels', {})
        cluster = labels.get(_CLUSTER_LABEL)
        if not cluster:
            continue
        name = pod['metadata']['name']
        cluster_by_pod[name] = cluster
        chips = 0
        for ct in pod.get('spec', {}).get('containers', []):
            chips += int(ct.get('resources', {}).get('requests', {})
                         .get('google.com/tpu', 0) or 0)
        chips_by_pod[name] = chips

    # Usage from metrics-server (absent on clusters without it: the
    # chip gauges still publish, usage gauges just stay unset).
    usage_by_pod: Dict[str, Dict] = {}
    try:
        import requests as requests_lib
        m = requests_lib.get(
            f'{client.base}/apis/metrics.k8s.io/v1beta1/namespaces/'
            f'{ns}/pods', headers=client.headers, verify=client.verify,
            timeout=30)
        if m.ok:
            for item in m.json().get('items', []):
                name = item['metadata']['name']
                cpu = mem = 0.0
                for ct in item.get('containers', []):
                    cpu += _parse_cpu(ct['usage'].get('cpu', '0'))
                    mem += _parse_mem(ct['usage'].get('memory', '0'))
                usage_by_pod[name] = {'cpu_millicores': cpu,
                                      'memory_bytes': mem}
    except Exception as e:  # pylint: disable=broad-except
        logger.debug(f'metrics-server scrape failed: {e}')

    written = set()
    for name, cluster in cluster_by_pod.items():
        row = {'pod': name, 'cluster': cluster,
               'tpu_chips': chips_by_pod.get(name, 0)}
        row.update(usage_by_pod.get(name, {}))
        rows.append(row)
        written.add((cluster, name))
        metrics_lib.set_gauge('skytpu_k8s_pod_tpu_chips',
                              row['tpu_chips'], cluster=cluster,
                              pod=name)
        if 'cpu_millicores' in row:
            metrics_lib.set_gauge('skytpu_k8s_pod_cpu_millicores',
                                  row['cpu_millicores'], cluster=cluster,
                                  pod=name)
            metrics_lib.set_gauge('skytpu_k8s_pod_memory_bytes',
                                  row['memory_bytes'], cluster=cluster,
                                  pod=name)
    # Drop series for pods that disappeared since the previous scrape —
    # /metrics would otherwise keep reporting torn-down clusters forever.
    global _last_scraped_pods
    for cluster, name in _last_scraped_pods - written:
        for metric in ('skytpu_k8s_pod_tpu_chips',
                       'skytpu_k8s_pod_cpu_millicores',
                       'skytpu_k8s_pod_memory_bytes'):
            metrics_lib.remove_gauge(metric, cluster=cluster, pod=name)
    _last_scraped_pods = written
    return rows


def maybe_scrape() -> int:
    """Daemon tick: scrape if a k8s endpoint is configured; never
    raises.  Returns #pods scraped (0 = k8s not configured or the
    scrape failed)."""
    import os
    if not (os.environ.get('SKYTPU_K8S_API_ENDPOINT') or
            _has_kubeconfig()):
        return 0
    try:
        return len(scrape_once())
    except Exception as e:  # pylint: disable=broad-except
        logger.debug(f'k8s metrics scrape failed: {e}')
        return 0


def _has_kubeconfig() -> bool:
    import os
    return os.path.isfile(os.path.expanduser(
        os.environ.get('KUBECONFIG', '~/.kube/config')))
