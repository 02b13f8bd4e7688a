"""Typed option registry, the port's copy of ``polyaxon_tpu/conf/options.py``.

``Option`` (key, type, default, stores, secret, choices) and ``OPTIONS``
with the reference's keys, types, defaults and choices, the ``spawner.*``
options that ``spawner/remote.py:spawner_from_conf`` reads among them.  Two
descriptions name ``torch.distributed`` and a host pool where the
reference's name its own runtime.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple


class OptionStores:
    ENV = "env"  # POLYAXON_TPU_<KEY>
    DB = "db"  # registry options table (cluster-editable at runtime)
    DEFAULT = "default"


@dataclass(frozen=True)
class Option:
    key: str
    typing: type
    default: Any
    description: str = ""
    #: resolution order, first hit wins
    stores: Tuple[str, ...] = (OptionStores.DB, OptionStores.ENV, OptionStores.DEFAULT)
    #: secrets are write-only over every surface (API/CLI list AND set
    #: responses mask them)
    secret: bool = False
    #: closed value set; coerce() rejects anything else
    choices: Optional[Tuple[str, ...]] = None

    @property
    def env_var(self) -> str:
        return "POLYAXON_TPU_" + self.key.upper().replace(".", "_")

    def coerce(self, raw: Any) -> Any:
        if raw is None:
            return raw
        if not isinstance(raw, self.typing):
            if self.typing is bool:
                raw = str(raw).lower() in ("1", "true", "yes", "on")
            else:
                raw = self.typing(raw)
        if self.choices is not None and raw not in self.choices:
            raise ValueError(
                f"{self.key} must be one of {self.choices}, got {raw!r}"
            )
        return raw


_ALL = [
    Option("scheduler.monitor_interval", float, 0.2,
           "gang poll cadence (reference Intervals.EXPERIMENTS_SYNC=30s analog)"),
    Option("scheduler.heartbeat_ttl", float, 600.0,
           "no-heartbeat window before a run is declared zombie"),
    Option("scheduler.heartbeat_check_interval", float, 60.0,
           "zombie-check cron cadence (reference beat: 600s)"),
    Option("scheduler.terminal_grace", float, 10.0,
           "grace before force-stopping a logically-done gang"),
    Option("scheduler.monitor_failure_streak", int, 25,
           "consecutive monitor-poll failures before a run is failed"),
    Option("scheduler.queued_redispatch_ttl", float, 60.0,
           "age before a run stranded in QUEUED is re-dispatched"),
    Option("worker.heartbeat_interval", float, 5.0,
           "in-process heartbeat cadence (reference sidecar poll: 2s)"),
    Option("spawner.default_accelerator", str, "cpu",
           "topology.accelerator default for specs that omit it"),
    Option("spawner.backend", str, "local",
           "gang transport (restart required)", choices=("local", "ssh")),
    Option("spawner.hosts", str, "",
           "comma-separated worker host addresses for the ssh backend "
           "(slice order: worker 0 first — it hosts the coordinator)"),
    Option("spawner.ssh_user", str, "", "ssh login user ('' = current user)"),
    Option("spawner.ssh_identity_file", str, "", "ssh private key path"),
    Option("spawner.remote_python", str, "python3",
           "python interpreter on worker hosts"),
    Option("spawner.coordinator_port_base", int, 8476,
           "base of the 512-wide torch.distributed coordinator port range"),
    Option("sso.provider", str, "",
           "single sign-on provider ('' = SSO off; oidc = endpoints from "
           "sso.*_url)",
           choices=("", "github", "gitlab", "bitbucket", "azure", "oidc")),
    Option("sso.client_id", str, "", "OAuth2 client id"),
    Option("sso.client_secret", str, "", "OAuth2 client secret", secret=True),
    Option("sso.authorize_url", str, "",
           "authorize endpoint override (oidc/self-hosted providers)"),
    Option("sso.token_url", str, "", "token endpoint override"),
    Option("sso.userinfo_url", str, "", "userinfo endpoint override"),
    Option("sso.username_field", str, "",
           "userinfo JSON field naming the user ('' = provider default)"),
    Option("sso.redirect_base", str, "",
           "public base URL of this platform for the OAuth callback "
           "('' = derive from the request)"),
    Option("sso.allowed_users", str, "",
           "comma-separated provider usernames allowed to self-provision "
           "via SSO (existing same-provider users always may log in)"),
    Option("sso.auto_create", bool, False,
           "create a platform user for ANY provider identity — on a "
           "public provider this opens the platform to every account "
           "there; prefer the allowlist"),
    Option("provision.zone", str, "",
           "GCE zone for tpu-vm provisioning (e.g. us-central2-b); "
           "'' disables the pools commands"),
    Option("provision.project", str, "",
           "GCP project for tpu-vm provisioning ('' = gcloud default)"),
    Option("provision.gcloud_bin", str, "gcloud",
           "gcloud binary (tests point this at a fake)"),
    Option("provision.version", str, "tpu-ubuntu2204-base",
           "tpu-vm software version for created slices"),
    Option("stores.artifacts_url", str, "",
           "durable artifact store (file:///path or gs://bucket/prefix); "
           "'' disables off-box sync"),
    Option("notifier.webhook_url", str, "",
           "notification webhook endpoint ('' = off)"),
    Option("notifier.webhook_kind", str, "",
           "payload dialect ('' = raw JSON; restart required)",
           choices=("", "slack", "discord", "mattermost", "pagerduty")),
    Option("notifier.pagerduty_routing_key", str, "",
           "Events-API-v2 integration key (webhook_kind=pagerduty)"),
    Option("notifier.email_host", str, "", "SMTP host ('' = email off)"),
    Option("notifier.email_port", int, 25, "SMTP port"),
    Option("notifier.email_from", str, "polyaxon-tpu@localhost", "sender address"),
    Option("notifier.email_to", str, "", "comma-separated recipients"),
    Option("notifier.email_tls", bool, False, "STARTTLS before sending"),
    Option("notifier.email_user", str, "", "SMTP login ('' = no auth)"),
    Option("notifier.email_password", str, "", "SMTP password", secret=True),
    Option("notifier.alert_routes", str, "",
           "severity→sink routing for alert-engine notifications, e.g. "
           "'critical:webhook,email;warning:webhook;info:log' "
           "('' = every severity to every sink; restart required)"),
    Option("groups.max_concurrency", int, 64,
           "upper bound on a sweep's concurrency setting"),
    Option("restarts.max_allowed", int, 10,
           "upper bound on restart_policy.max_restarts"),
    Option("logs.retention_days", float, 30.0, "activity/log cleanup horizon"),
    Option("cleaning.archives_ttl_days", float, 7.0,
           "archived runs older than this are purged by the cron"),
    Option("api.page_size", int, 100, "default list page size"),
    Option("tracker.endpoint", str, "",
           "anonymized usage-event publish URL ('' = off; restart required)"),
    Option("stats.backend", str, "memory",
           "operational metrics sink (restart required)",
           choices=("memory", "statsd", "noop")),
    Option("stats.statsd_host", str, "127.0.0.1", "statsd UDP host"),
    Option("stats.statsd_port", int, 8125, "statsd UDP port"),
]

OPTIONS: Dict[str, Option] = {o.key: o for o in _ALL}


def option_by_key(key: str) -> Optional[Option]:
    return OPTIONS.get(key)


def display_value(opt: Option, value: Any) -> Any:
    """What a read surface may show for this option's value."""
    return "***" if opt.secret else value


def options_payload(conf) -> list:
    """The option listing every surface serves (API and local CLI share
    this so the payloads can never drift)."""
    return [
        {
            "key": opt.key,
            "value": display_value(opt, conf.get(opt.key)),
            "default": display_value(opt, opt.default),
            "description": opt.description,
        }
        for opt in OPTIONS.values()
    ]
