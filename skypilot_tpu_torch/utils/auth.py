"""Shared client/server auth-token lookup: env SKYTPU_API_TOKEN, then
api_server.auth_token in the layered config.  One helper so the server
middleware and both SDKs can never drift on where the token comes from.

Three server-side modes (parity: the reference's service-account tokens
sky/users/token_service.py + its oauth2-proxy deployment
sky/server/auth/oauth2_proxy.py):

- shared token (``api_server.auth_token``): one bearer gates the API,
  identity comes from the X-SkyTPU-User header (trusted channel);
- per-user tokens (``api_server.tokens: {token: username}``): the
  bearer IS the identity — the header is ignored for authenticated
  users, so identity can no longer be spoofed by other token holders;
- auth proxy (``api_server.auth_proxy``): the server sits behind an
  authenticating reverse proxy (oauth2-proxy, IAP, Pomerium...) that
  performs the actual OAuth2/OIDC flow and forwards the verified
  identity in a header (default ``X-Auth-Request-Email``).  The proxy
  must inject ``proxy_secret`` in ``secret_header`` on every request —
  that is what stops clients from reaching the server directly and
  forging the identity header.  Config:

      api_server:
        auth_proxy:
          identity_header: X-Auth-Request-Email   # optional
          secret_header: X-SkyTPU-Proxy-Secret    # optional
          proxy_secret: <random shared with the proxy>
"""
from __future__ import annotations

import hmac
import os
from typing import Dict, Optional, Tuple


def get_auth_token() -> Optional[str]:
    token = os.environ.get('SKYTPU_API_TOKEN')
    if token:
        return token
    from skypilot_tpu_torch import sky_config
    return sky_config.get_nested(('api_server', 'auth_token'), None)


def get_token_users() -> Dict[str, str]:
    """Per-user service tokens from config: {token: username}."""
    from skypilot_tpu_torch import sky_config
    tokens = sky_config.get_nested(('api_server', 'tokens'), None)
    if not tokens:
        return {}
    return {str(k): str(v) for k, v in tokens.items()}


def _tokens_equal(a: str, b: str) -> bool:
    # Bytes, not str: compare_digest raises TypeError on non-ASCII
    # strings, and the supplied token is attacker-controlled.
    return hmac.compare_digest(a.encode('utf-8', 'surrogateescape'),
                               b.encode('utf-8', 'surrogateescape'))


def authenticate(supplied: str) -> Tuple[bool, Optional[str]]:
    """(authorized, authenticated_user) for a supplied bearer token.

    Per-user tokens bind identity; the shared token authorizes without
    binding (identity then comes from the user header).  With neither
    configured the API is open: (True, None).
    """
    token_users = get_token_users()
    for token, user in token_users.items():
        if _tokens_equal(supplied, token):
            return True, user
    shared = get_auth_token()
    if shared:
        return _tokens_equal(supplied, shared), None
    # No auth configured: open (single-user/dev), unless per-user
    # tokens exist — then only they grant access.
    return (False, None) if token_users else (True, None)


def get_auth_proxy_config() -> Optional[Dict[str, str]]:
    """Auth-proxy mode config, normalized, or None when not enabled.

    A PRESENT auth_proxy section with an empty proxy_secret (e.g. an
    unexpanded env template) is a hard error, not 'disabled' — failing
    open on a typo'd secret would serve the API unauthenticated while
    the operator believes proxy auth is enforced.  (The config schema
    also rejects it with minLength; this guards env-injected configs
    that skip validation.)
    """
    from skypilot_tpu_torch import exceptions, sky_config
    cfg = sky_config.get_nested(('api_server', 'auth_proxy'), None)
    if not isinstance(cfg, dict):
        return None
    if not str(cfg.get('proxy_secret') or '').strip():
        raise exceptions.InvalidSkyConfigError(
            'api_server.auth_proxy is configured but proxy_secret is '
            'empty — refusing to fail open; set the shared secret or '
            'remove the auth_proxy section')
    return {
        'identity_header': str(cfg.get('identity_header',
                                       'X-Auth-Request-Email')),
        'secret_header': str(cfg.get('secret_header',
                                     'X-SkyTPU-Proxy-Secret')),
        'proxy_secret': str(cfg['proxy_secret']),
    }


def authenticate_proxy(headers,
                       cfg: Dict[str, str]) -> Tuple[bool, Optional[str]]:
    """(authorized, user) for auth-proxy mode (`cfg` is the caller's
    already-fetched get_auth_proxy_config() — one lookup per request,
    and no window where a config reload could drop it mid-check).

    Authorized iff the request carries the proxy's shared secret (it
    came THROUGH the authenticating proxy, not directly); the identity
    header then names the already-authenticated user.  The email's
    local part becomes the RBAC username (``alice@corp`` -> ``alice``),
    matching how the reference maps proxied identities to users.
    """
    supplied = headers.get(cfg['secret_header'], '')
    if not _tokens_equal(supplied, cfg['proxy_secret']):
        return False, None
    identity = headers.get(cfg['identity_header'], '')
    user = identity.split('@', 1)[0].strip()
    if not user:
        # An empty local part would set a FALSY auth_user, and every
        # downstream `auth_user or client_header` fallback would hand
        # identity back to the forgeable X-SkyTPU-User header.
        return False, None
    return True, user


def warn_if_spoofable_rbac(logger) -> bool:
    """Warn when RBAC (`users:`) is enabled but only a shared token gates
    the API: any bearer holder can then set X-SkyTPU-User to any name —
    including an admin's — so ownership checks are spoofable.  Only
    per-user tokens (``api_server.tokens``) bind identity.  Returns True
    when the warning fired (tested in tests/test_api_server.py)."""
    from skypilot_tpu_torch import sky_config
    rbac_on = bool(sky_config.get_nested(('users',), None))
    if rbac_on and get_auth_token() and not get_token_users() and \
            get_auth_proxy_config() is None:
        logger.warning(
            'RBAC (`users:`) is enabled but only a shared api_server.'
            'auth_token is configured: identity comes from the client-'
            'supplied X-SkyTPU-User header, so any token holder can act '
            'as any user. Configure per-user api_server.tokens to bind '
            'identity to the bearer.')
        return True
    return False
