"""The port's options and their resolution (``conf/``) against the JAX
package's: every ``Option``'s key, type, default, stores, secrecy and
choices; ``ConfService`` reads through the registry, the environment and
the defaults, writes, unsets and refuses alike on both registries; a secret
option round-trips through either package's encryptor under one key."""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import pytest

from polyaxon_tpu.conf import encryptor as jenc
from polyaxon_tpu.conf import options as jopt
from polyaxon_tpu.conf.service import ConfService as JaxConfService
from polyaxon_tpu.db.registry import RunRegistry as JaxRunRegistry
from polyaxon_tpu_torch.conf import encryptor as tenc
from polyaxon_tpu_torch.conf import knobs as tknobs
from polyaxon_tpu_torch.conf import options as topt
from polyaxon_tpu_torch.conf.service import ConfService
from polyaxon_tpu_torch.db.registry import RunRegistry


def _fields(o):
    return (o.key, o.typing, o.default, o.stores, o.secret, o.choices, o.env_var)


def test_every_option_is_the_references():
    assert list(topt.OPTIONS) == list(jopt.OPTIONS)
    for key, want in jopt.OPTIONS.items():
        assert _fields(topt.OPTIONS[key]) == _fields(want), key
    assert vars(topt.OptionStores).keys() >= {"ENV", "DB", "DEFAULT"}
    assert (topt.OptionStores.ENV, topt.OptionStores.DB, topt.OptionStores.DEFAULT) == (
        jopt.OptionStores.ENV, jopt.OptionStores.DB, jopt.OptionStores.DEFAULT)


@pytest.mark.parametrize("key, raw", [
    ("spawner.backend", "ssh"), ("spawner.backend", "k8s"), ("sso.auto_create", "on"),
    ("sso.auto_create", "0"), ("spawner.coordinator_port_base", "9000"),
    ("spawner.coordinator_port_base", "x"), ("stats.backend", "noop"),
    ("scheduler.monitor_interval", 3),
])
def test_coerce_is_the_references(key, raw):
    def run(opt):
        try:
            return ("ok", opt.coerce(raw))
        except (TypeError, ValueError) as e:
            return (type(e).__name__, str(e))

    assert run(topt.OPTIONS[key]) == run(jopt.OPTIONS[key])


def test_the_options_listing_is_the_references(monkeypatch):
    """Key, shown value and default of every option (two descriptions name
    the port's runtime and host pool where the reference's name its own)."""
    for var in [o.env_var for o in jopt.OPTIONS.values()]:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("POLYAXON_TPU_SSO_CLIENT_SECRET", "shown-masked")

    def rows(mod, conf):
        return [(r["key"], r["value"], r["default"]) for r in mod.options_payload(conf)]

    assert rows(topt, ConfService(cache_ttl=0)) == rows(jopt, JaxConfService(cache_ttl=0))
    assert ("sso.client_secret", "***", "***") in rows(topt, ConfService(cache_ttl=0))


def _script(conf, monkeypatch):
    """One sequence of reads, writes and refusals; what each step saw."""
    seen = []

    def step(fn, *args):
        try:
            seen.append(("ok", fn(*args)))
        except Exception as e:  # noqa: BLE001 — compared by type and message
            seen.append((type(e).__name__, str(e)))

    step(conf.get, "spawner.backend")
    monkeypatch.setenv("POLYAXON_TPU_SPAWNER_HOSTS", "a,b")
    monkeypatch.setenv("POLYAXON_TPU_SPAWNER_COORDINATOR_PORT_BASE", "not-a-number")
    conf.invalidate()
    step(conf.get, "spawner.hosts")
    step(conf.get, "spawner.coordinator_port_base")  # invalid env: the default
    step(conf.set, "spawner.backend", "ssh")
    step(conf.get, "spawner.backend")
    step(conf.set, "spawner.backend", "k8s")
    step(conf.get, "spawner.backend")
    step(conf.set, "sso.auto_create", "yes")
    step(conf.get, "sso.auto_create")
    step(conf.set, "spawner.hosts", "c")  # the registry wins over the env
    step(conf.get, "spawner.hosts")
    step(conf.unset, "spawner.hosts")
    step(conf.get, "spawner.hosts")
    step(conf.get, "no.such.key")
    step(conf.set, "no.such.key", 1)
    step(conf.set, "notifier.email_password", "hunter2")
    step(conf.get, "notifier.email_password")
    step(conf.unset, "spawner.backend")
    step(conf.get, "spawner.backend")
    return seen


def test_conf_service_reads_writes_and_refuses_as_the_references(tmp_path, monkeypatch):
    jreg = JaxRunRegistry(tmp_path / "jax.db")
    treg = RunRegistry(tmp_path / "port.db")
    try:
        with monkeypatch.context() as m:
            want = _script(JaxConfService(jreg, cache_ttl=60.0), m)
        with monkeypatch.context() as m:
            got = _script(ConfService(treg, cache_ttl=60.0), m)
        assert got == want
        assert treg.get_option("sso.auto_create") is True
        with pytest.raises(Exception) as e:
            ConfService(None).set("spawner.backend", "ssh")
        assert (type(e.value).__name__, str(e.value)) == ("ConfError", "No registry attached; "
                                                                       "cannot persist options")
    finally:
        jreg.close()
        treg.close()


def test_a_secret_option_round_trips_through_the_encryptor(tmp_path, monkeypatch):
    from cryptography.fernet import Fernet

    monkeypatch.setenv("POLYAXON_TPU_SECRET_KEY", Fernet.generate_key().decode())
    treg = RunRegistry(tmp_path / "port.db")
    try:
        port = ConfService(treg, encryptor=tenc.Encryptor.from_base_dir(tmp_path))
        port.set("sso.client_secret", "s3cret")
        stored = treg.get_option("sso.client_secret")
        assert tenc.Encryptor.is_encrypted(stored) and "s3cret" not in stored
        assert port.get("sso.client_secret") == "s3cret"
        # The reference's encryptor reads what the port wrote, and back.
        jax_side = jenc.Encryptor.from_base_dir(tmp_path)
        assert jax_side.decrypt(stored) == "s3cret"
        assert tenc.Encryptor.from_base_dir(tmp_path).decrypt(jax_side.encrypt("x")) == "x"
        assert port.encryptor.decrypt("legacy plain") == "legacy plain"
    finally:
        treg.close()


def test_the_keyfile_and_a_bad_key_behave_as_the_references(tmp_path, monkeypatch):
    monkeypatch.delenv("POLYAXON_TPU_SECRET_KEY", raising=False)
    key_dir = tmp_path / "base"
    port = tenc.Encryptor.from_base_dir(key_dir)
    assert (key_dir / ".secret_key").stat().st_mode & 0o777 == 0o600
    assert jenc.Encryptor.from_base_dir(key_dir).decrypt(port.encrypt("v")) == "v"
    for mod in (tenc, jenc):
        with pytest.raises(mod.EncryptionError) as e:
            mod.Encryptor(b"not a key")
        assert str(e.value).startswith("Invalid secret key")
    other = tenc.Encryptor.from_base_dir(tmp_path / "other")
    for mod, enc in ((tenc, other), (jenc, jenc.Encryptor.from_base_dir(tmp_path / "other"))):
        with pytest.raises(mod.EncryptionError, match="Cannot decrypt stored secret"):
            enc.decrypt(port.encrypt("v"))


def test_the_knobs_conf_reads_are_the_references():
    from polyaxon_tpu.conf import knobs as jknobs

    for name in ("POLYAXON_TPU_SECRET_KEY", "POLYAXON_TPU_RETENTION_SWEEP_ROWS"):
        assert tknobs.KNOBS[name] == jknobs.KNOBS[name].default
    # Every name the port declares (the gang env contract included) keeps
    # the reference's default, and the port's families are the reference's.
    for name, default in tknobs.KNOBS.items():
        assert default == jknobs.KNOBS[name].default, name
        assert not jknobs.KNOBS[name].prefix, name
    assert set(tknobs.FAMILIES) <= set(jknobs.FAMILIES)
