"""GCP adaptor: lazy google-auth access + ONE process-wide credential
cache (parity: sky/adaptors/gcp.py).

Every GCP REST client (provision/gcp/tpu_client.py, gce_client.py,
catalog fetchers) shares this token cache instead of each refreshing
its own copy — N clients previously meant N refresh round-trips and N
independent expiry clocks.  google-auth imports lazily, so
environments without it (tests against fake endpoints, non-GCP
deployments) never pay or fail the import.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

_SCOPES = ['https://www.googleapis.com/auth/cloud-platform']
_lock = threading.Lock()
_token: Optional[str] = None
_token_expiry = 0.0


def auth_headers() -> Dict[str, str]:
    """Authorization header from application-default credentials,
    refreshed on expiry; shared across every GCP client in-process."""
    global _token, _token_expiry
    with _lock:
        if _token is None or time.time() > _token_expiry - 60:
            import google.auth
            import google.auth.transport.requests
            creds, _ = google.auth.default(scopes=_SCOPES)
            creds.refresh(google.auth.transport.requests.Request())
            _token = creds.token
            # Trust the credential's own expiry when it reports one
            # (impersonated service accounts / workload identity can be
            # much shorter than ADC's ~3600s); fall back to a fixed
            # headroom only when it is unknown.
            expiry = getattr(creds, 'expiry', None)
            if expiry is not None:
                # google-auth expiry is a NAIVE datetime in UTC.
                from datetime import timezone
                if expiry.tzinfo is None:
                    expiry = expiry.replace(tzinfo=timezone.utc)
                _token_expiry = expiry.timestamp()
            else:
                _token_expiry = time.time() + 3000
        return {'Authorization': f'Bearer {_token}'}


def default_project() -> str:
    """The acting GCP project (delegates to the provision layer's
    resolver, which honors SKYTPU_GCP_PROJECT / GOOGLE_CLOUD_PROJECT
    and raises NoCloudAccessError with guidance when unset)."""
    from skypilot_tpu_torch.provision.gcp import tpu_client
    return tpu_client.default_project()


def reset_cache_for_tests() -> None:
    global _token, _token_expiry
    with _lock:
        _token = None
        _token_expiry = 0.0
