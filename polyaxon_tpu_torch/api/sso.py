"""Single sign-on: OAuth2 authorization-code login against a provider.

The port's copy of ``polyaxon_tpu/api/sso.py``, the same but for its imports.

Parity: reference ``polyaxon/sso/`` — provider wizards for GitHub /
GitLab / Bitbucket / Azure that map an external identity onto a platform
user.  Collapsed here to one authorization-code flow over a provider
CATALOG (the four reference providers plus a generic ``oidc`` entry whose
endpoints come from conf), with the platform's own per-user tokens as the
session mechanism: a successful callback upserts the user, ROTATES their
platform token, and hands it to the browser (localStorage — consistent
with the dashboard's no-token-in-URL rule... the one-time callback
fragment excepted, which is the standard implicit-handoff tradeoff).

State is a signed nonce held in-process with a TTL — the control plane is
a single process (no shared cache to coordinate), so this matches the
deployment model the same way the reference leaned on Django sessions.
"""

from __future__ import annotations

import secrets
import time
from dataclasses import dataclass, replace
from typing import Dict, Optional
from urllib.parse import urlencode

from polyaxon_tpu_torch.exceptions import PolyaxonTPUError


class SSOError(PolyaxonTPUError):
    pass


@dataclass(frozen=True)
class ProviderConfig:
    name: str
    authorize_url: str
    token_url: str
    userinfo_url: str
    #: JSON field of the userinfo payload that names the user
    username_field: str
    scope: str = ""


#: The reference's four providers (``sso/providers/``) + generic OIDC.
PROVIDERS: Dict[str, ProviderConfig] = {
    "github": ProviderConfig(
        name="github",
        authorize_url="https://github.com/login/oauth/authorize",
        token_url="https://github.com/login/oauth/access_token",
        userinfo_url="https://api.github.com/user",
        username_field="login",
        scope="read:user",
    ),
    "gitlab": ProviderConfig(
        name="gitlab",
        authorize_url="https://gitlab.com/oauth/authorize",
        token_url="https://gitlab.com/oauth/token",
        userinfo_url="https://gitlab.com/api/v4/user",
        username_field="username",
        scope="read_user",
    ),
    "bitbucket": ProviderConfig(
        name="bitbucket",
        authorize_url="https://bitbucket.org/site/oauth2/authorize",
        token_url="https://bitbucket.org/site/oauth2/access_token",
        userinfo_url="https://api.bitbucket.org/2.0/user",
        username_field="username",
        scope="account",
    ),
    "azure": ProviderConfig(
        name="azure",
        authorize_url=(
            "https://login.microsoftonline.com/common/oauth2/v2.0/authorize"
        ),
        token_url="https://login.microsoftonline.com/common/oauth2/v2.0/token",
        userinfo_url="https://graph.microsoft.com/v1.0/me",
        username_field="userPrincipalName",
        scope="User.Read",
    ),
    # Endpoints supplied entirely by conf (self-hosted GitLab, Keycloak,
    # Okta, dex, ...).
    "oidc": ProviderConfig(
        name="oidc",
        authorize_url="",
        token_url="",
        userinfo_url="",
        username_field="preferred_username",
        scope="openid profile",
    ),
}


def resolve_provider(conf) -> Optional[ProviderConfig]:
    """The configured provider with conf URL/field overrides applied;
    None when SSO is off (no provider or no client id)."""
    name = conf.get("sso.provider")
    if not name:
        return None
    base = PROVIDERS.get(name)
    if base is None:
        raise SSOError(f"Unknown SSO provider {name!r}")
    overrides = {}
    for field, key in (
        ("authorize_url", "sso.authorize_url"),
        ("token_url", "sso.token_url"),
        ("userinfo_url", "sso.userinfo_url"),
        ("username_field", "sso.username_field"),
    ):
        value = conf.get(key)
        if value:
            overrides[field] = value
    provider = replace(base, **overrides)
    if not conf.get("sso.client_id"):
        return None
    if not (provider.authorize_url and provider.token_url and provider.userinfo_url):
        raise SSOError(
            f"SSO provider {name!r} needs authorize/token/userinfo URLs "
            "(set sso.authorize_url etc.)"
        )
    return provider


class StateStore:
    """Single-use login nonces with a TTL (CSRF guard for the callback).

    Bounded: /auth/sso/login is unauthenticated, so without a cap a
    request loop would grow the dict for the whole TTL; at the cap the
    oldest nonce is evicted (its login attempt just restarts)."""

    def __init__(self, ttl: float = 600.0, max_size: int = 4096) -> None:
        self.ttl = ttl
        self.max_size = max_size
        self._states: Dict[str, float] = {}

    def issue(self) -> str:
        now = time.time()
        self._states = {
            s: t for s, t in self._states.items() if now - t < self.ttl
        }
        while len(self._states) >= self.max_size:
            self._states.pop(next(iter(self._states)))  # oldest (insert order)
        state = secrets.token_urlsafe(24)
        self._states[state] = now
        return state

    def redeem(self, state: Optional[str]) -> bool:
        if not state:
            return False
        issued = self._states.pop(state, None)
        return issued is not None and time.time() - issued < self.ttl


def authorize_redirect_url(
    provider: ProviderConfig, client_id: str, redirect_uri: str, state: str
) -> str:
    params = {
        "client_id": client_id,
        "redirect_uri": redirect_uri,
        "state": state,
        "response_type": "code",
    }
    if provider.scope:
        params["scope"] = provider.scope
    sep = "&" if "?" in provider.authorize_url else "?"
    return f"{provider.authorize_url}{sep}{urlencode(params)}"


async def exchange_code(
    session, provider: ProviderConfig, *, code: str, client_id: str,
    client_secret: str, redirect_uri: str,
) -> str:
    """code -> provider access token (server-side POST)."""
    async with session.post(
        provider.token_url,
        data={
            "client_id": client_id,
            "client_secret": client_secret,
            "code": code,
            "grant_type": "authorization_code",
            "redirect_uri": redirect_uri,
        },
        headers={"Accept": "application/json"},
    ) as resp:
        if resp.status != 200:
            raise SSOError(
                f"Token exchange failed ({resp.status}): "
                f"{(await resp.text())[:200]}"
            )
        payload = await resp.json(content_type=None)
    token = payload.get("access_token")
    if not token:
        raise SSOError(f"No access_token in provider response: {payload}")
    return token


async def fetch_username(session, provider: ProviderConfig, access_token: str) -> str:
    async with session.get(
        provider.userinfo_url,
        headers={
            "Authorization": f"Bearer {access_token}",
            "Accept": "application/json",
        },
    ) as resp:
        if resp.status != 200:
            raise SSOError(
                f"Userinfo fetch failed ({resp.status}): "
                f"{(await resp.text())[:200]}"
            )
        payload = await resp.json(content_type=None)
    username = payload.get(provider.username_field)
    if not username:
        raise SSOError(
            f"Userinfo payload has no {provider.username_field!r}: "
            f"{list(payload)}"
        )
    return str(username)


async def authenticate(
    provider: ProviderConfig,
    *,
    code: str,
    client_id: str,
    client_secret: str,
    redirect_uri: str,
    timeout: float = 15.0,
) -> str:
    """Full code -> identity resolution on one bounded client session
    (a stalled provider must not pin the callback handler for aiohttp's
    5-minute default)."""
    import aiohttp

    async with aiohttp.ClientSession(
        timeout=aiohttp.ClientTimeout(total=timeout)
    ) as session:
        access = await exchange_code(
            session,
            provider,
            code=code,
            client_id=client_id,
            client_secret=client_secret,
            redirect_uri=redirect_uri,
        )
        return await fetch_username(session, provider, access)


#: Page that hands the platform token to the dashboard (localStorage, same
#: slot the login form uses) and cleans the URL.
CALLBACK_HTML = """<!doctype html>
<html><body><script>
localStorage.setItem('px_token', {token!r});
location.replace('/');
</script>signed in — redirecting…</body></html>
"""
