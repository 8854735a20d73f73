"""Client/server API versioning (parity: sky/server/constants.py).

Both sides carry API_VERSION (what I speak) and
MIN_COMPATIBLE_API_VERSION (the oldest peer I still understand).  The
handshake is symmetric:

- every SDK call sends ``X-SkyTPU-API-Version``; the server rejects
  clients older than its MIN_COMPATIBLE with 426 Upgrade Required;
- ``/api/health`` reports the server's pair; the SDK refuses servers
  older than ITS MIN_COMPATIBLE with an upgrade hint.

Bump API_VERSION whenever a route's request or response shape changes;
raise MIN_COMPATIBLE_API_VERSION only when compatibility shims for old
peers are actually removed.
"""
from __future__ import annotations

API_VERSION = 2
MIN_COMPATIBLE_API_VERSION = 1

API_VERSION_HEADER = 'X-SkyTPU-API-Version'

# Caller identity, forwarded by the SDK on every call (trusted from the
# authenticated channel — the bearer token gates the API, like the
# reference trusts its auth proxy's user header).
USER_HEADER = 'X-SkyTPU-User'
WORKSPACE_HEADER = 'X-SkyTPU-Workspace'
