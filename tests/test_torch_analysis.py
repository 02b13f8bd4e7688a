"""The port's static analysis (``polyaxon_tpu_torch/analysis/``) against the
JAX package's.

Every test of ``tests/test_analysis/test_rules.py`` and
``test_self_clean.py`` has a counterpart here.  Where the rules are the
reference's (GL003, GL004, GL006, GL007, GL008) both engines run on the
reference's own fixtures and must give the same ``(rule, line, col,
message)`` lists; GL005 must agree on a fixture naming knobs both catalogs
hold; the suppression machinery, the CLI's text, JSON and exit codes, and
the state file must agree on the same files.  GL001 and GL002 have a port
meaning (CUDA-graph captures, ROADMAP item 10): they are held to the port's
own fixtures (``tests/torch_analysis_fixtures/``) with exact counts, and to
mutated copies of the port's real capture sites.  The port's package lints
clean with every suppression justified, and the health probe reads the
CLI's state.
"""

from tests import torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from polyaxon_tpu import analysis as janalysis
from polyaxon_tpu.analysis import __main__ as jmain
from polyaxon_tpu.analysis import core as jcore
from polyaxon_tpu.analysis import reporter as jreporter
from polyaxon_tpu.analysis import rules as jrules
from polyaxon_tpu_torch import analysis
from polyaxon_tpu_torch.analysis import __main__ as tmain
from polyaxon_tpu_torch.analysis import core, reporter, rules
from polyaxon_tpu_torch.checks import health
from polyaxon_tpu_torch.conf import knobs as tknobs

REPO = Path(__file__).resolve().parent.parent
REF_FIXTURES = REPO / "tests" / "test_analysis" / "fixtures"
FIXTURES = REPO / "tests" / "torch_analysis_fixtures"

#: The rules whose code, messages and catalogs are the reference's.
SHARED = ["GL003", "GL004", "GL006", "GL007", "GL008"]
#: GL001 and GL002's names on each plane: the one stated departure in the
#: rule catalog's text.
RENAMED = {"GL001": ("capture-purity", "jit-purity"), "GL002": ("static-inputs", "donation")}


def _rule(mod, rule_id):
    return mod.rule_by_id(rule_id)()


def _lint(core_mod, path: Path, rule_list):
    project = core_mod.load_project([path], root=path.parent)
    return [f for f in core_mod.run_rules(project, rule_list) if not f.suppressed]


def _port(path, *ids):
    return _lint(core, path, [_rule(rules, i) for i in ids])


def _both(path, rule_id):
    """(port findings, reference findings) of one rule on one file, as
    ``(rule, line, col, message)``."""
    got = {}
    for plane, (core_mod, rules_mod) in {"port": (core, rules), "jax": (jcore, jrules)}.items():
        got[plane] = [(f.rule, f.line, f.col, f.message)
                      for f in _lint(core_mod, path, [_rule(rules_mod, rule_id)])]
    return got["port"], got["jax"]


def _messages(findings):
    return " | ".join(f.message for f in findings)


# -- sensitivity: the port's bad fixture trips every rule --------------------

def test_gl001_fires_on_host_syncs_in_captured_fns():
    findings = _port(FIXTURES / "bad_patterns.py", "GL001")
    assert len(findings) == 9
    in_step = [f for f in findings if "`impure_step`" in f.message]
    assert len(in_step) == 6
    messages = _messages(in_step)
    for needle in ("print", "time.time", "np.asarray", ".item()", ".tolist()",
                   "torch.cuda.synchronize"):
        assert needle in messages, needle


def test_gl001_fires_on_graphed_callables_and_graph_bodies():
    findings = _port(FIXTURES / "bad_patterns.py", "GL001")
    graphed = [f.message for f in findings if "`graphed_forward`" in f.message]
    assert len(graphed) == 2
    assert any("float(x)" in m for m in graphed) and any(".cpu()" in m for m in graphed)
    body = [f.message for f in findings if "torch.cuda.graph(...)` body in `capture_body`"
            in f.message]
    assert len(body) == 1 and ".item()" in body[0]


def test_gl002_fires_on_rebound_static_inputs():
    findings = _port(FIXTURES / "bad_patterns.py", "GL002")
    assert len(findings) == 2
    assert any(f.message.startswith("`token` rebound") and "`one_step`" in f.message
               for f in findings)
    assert any(f.message.startswith("`static_x` rebound") and "torch.cuda.graph(...)` body"
               in f.message for f in findings)
    assert all("copy_(...)" in f.message for f in findings)


@pytest.mark.parametrize("rule_id", SHARED)
def test_a_shared_rule_gives_the_reference_findings_on_its_fixtures(rule_id):
    for name in ("bad_patterns.py", "good_patterns.py"):
        port, jax = _both(REF_FIXTURES / name, rule_id)
        assert port == jax, name
    # The port's bad fixture carries the reference's sections as they are.
    port = [f[3] for f in _both(FIXTURES / "bad_patterns.py", rule_id)[0]]
    jax = [f[3] for f in _both(REF_FIXTURES / "bad_patterns.py", rule_id)[1]]
    assert port == jax and port


def test_gl003_fires_on_write_outside_lock():
    findings = _port(FIXTURES / "bad_patterns.py", "GL003")
    assert len(findings) == 1
    assert "bad_write" in findings[0].message and "DELETE" in findings[0].message


def test_gl004_fires_on_blocking_beat_hooks():
    findings = _port(FIXTURES / "bad_patterns.py", "GL004")
    messages = _messages(findings)
    assert len(findings) == 2 and "time.sleep" in messages and "urlopen" in messages


def test_gl005_fires_on_phantom_knob():
    findings = _port(FIXTURES / "bad_patterns.py", "GL005")
    assert [f.message.split("`")[1] for f in findings] == ["POLYAXON_TPU_DOES_NOT_EXIST"]


def test_gl005_agrees_with_the_reference_on_knobs_both_catalogs_hold():
    port, jax = _both(FIXTURES / "shared_knobs.py", "GL005")
    assert port == jax
    assert [m.split("`")[1] for *_, m in port] == ["POLYAXON_TPU_SERVING_WARMPU",
                                                   "POLYAXON_TPU_DOES_NOT_EXIST"]


def test_gl005_finds_dead_catalog_entries_in_the_port_s_catalog(tmp_path):
    # A project holding the port's catalog and one module naming every
    # entry but the alert interval: that entry, and the ALERT_ family it
    # alone used, are dead.
    pkg = tmp_path / "pkg"
    (pkg / "conf").mkdir(parents=True)
    source = (analysis.package_root() / "conf" / "knobs.py").read_text()
    (pkg / "conf" / "knobs.py").write_text(source)
    names = [n for n in tknobs.KNOBS if n != "POLYAXON_TPU_ALERT_INTERVAL_S"]
    (pkg / "use.py").write_text("".join(f"K{i} = {n!r}\n" for i, n in enumerate(names)))
    findings = core.run_rules(core.load_project([pkg]), [rules.KnobRegistryRule()])
    lines = source.splitlines()
    got = {f.message.split("`")[1]: f for f in findings}
    assert set(got) == {"POLYAXON_TPU_ALERT_INTERVAL_S", "POLYAXON_TPU_ALERT_"}
    for name, f in got.items():
        assert f.path == "conf/knobs.py" and f'"{name}"' in lines[f.line - 1]
        assert f.message.startswith("dead catalog entry") and not f.suppressed
    # Naming a family member keeps the family alive.
    (pkg / "more.py").write_text('X = "POLYAXON_TPU_ALERT_RUN_STALLED_ENABLED"\n')
    findings = core.run_rules(core.load_project([pkg]), [rules.KnobRegistryRule()])
    assert [f.message.split("`")[1] for f in findings] == ["POLYAXON_TPU_ALERT_INTERVAL_S"]


def test_gl006_fires_on_unbounded_urlopen():
    # notify() plus SleepyAgent.fetch, as in the reference.
    assert len(_port(FIXTURES / "bad_patterns.py", "GL006")) == 2


def test_gl007_fires_on_interpolated_and_uncatalogued_labels():
    findings = _port(FIXTURES / "bad_patterns.py", "GL007")
    messages = _messages(findings)
    assert len(findings) == 5
    for needle in ("f-string", ".format()", "concatenation", "customer_id", "**kwargs"):
        assert needle in messages, needle


def test_gl008_fires_on_interpolated_and_uncatalogued_span_names():
    findings = _port(FIXTURES / "bad_patterns.py", "GL008")
    messages = _messages(findings)
    assert len(findings) == 3
    for needle in ("not a string literal", "'NotDotted'", "'serving.bogus_phase'"):
        assert needle in messages, needle


def test_the_reference_s_jit_rules_see_nothing_of_the_port_s_captures():
    # Copied as they are, GL001 and GL002 would check nothing in the port.
    for rule_id in ("GL001", "GL002"):
        assert _lint(jcore, FIXTURES / "bad_patterns.py", [_rule(jrules, rule_id)]) == []
        assert _lint(jcore, REF_FIXTURES / "bad_patterns.py", [_rule(jrules, rule_id)])
        assert _port(REF_FIXTURES / "bad_patterns.py", rule_id) == []


# -- precision: the good fixtures are silent ---------------------------------

@pytest.mark.parametrize("rule_id", [f"GL00{i}" for i in range(1, 9)])
def test_good_fixture_is_clean(rule_id):
    findings = _port(FIXTURES / "good_patterns.py", rule_id)
    assert findings == [], [f.message for f in findings]


# -- precision on the port's real hot paths, and its real capture sites ------

@pytest.mark.parametrize("rel", ["serving/engine.py", "runtime/train.py", "models/decode.py"])
def test_zero_false_positives_on_real_hot_paths(rel):
    path = analysis.package_root() / rel
    findings = _port(path, "GL001", "GL002")
    assert findings == [], [f"{f.location()}: {f.message}" for f in findings]


@pytest.mark.parametrize("rel, old, new, rule_id", [
    # generate's decode loop (models/decode.py) with its write in place undone.
    ("models/decode.py", "        token.copy_(pick(logits))\n", "        token = pick(logits)\n",
     "GL002"),
    # the engine's captured step entry reading a value back to the host.
    ("serving/engine.py", "capture_step(lambda: fn(**inputs), pool=pool)",
     "capture_step(lambda: fn(**inputs).item(), pool=pool)", "GL001"),
])
def test_a_real_capture_site_trips_its_rule_once_broken(rel, old, new, rule_id, tmp_path):
    source = (analysis.package_root() / rel).read_text()
    assert source.count(old) == 1
    path = tmp_path / Path(rel).name
    path.write_text(source.replace(old, new))
    findings = _port(path, "GL001", "GL002")
    assert [f.rule for f in findings] == [rule_id]
    assert findings[0].line == source[:source.index(old)].count("\n") + 1


# -- suppression machinery: both engines, the same findings ------------------

_URLOPEN = "import urllib.request\ndef f(url):\n"
SUPPRESSIONS = {
    "trailing": _URLOPEN + "    return urllib.request.urlopen(url)"
                           "  # graft-lint: disable=GL006 -- caller enforces a deadline\n",
    "standalone": _URLOPEN + "    # graft-lint: disable=GL006 -- bounded by the socket default\n"
                             "    return urllib.request.urlopen(url)\n",
    "file": "# graft-lint: disable-file=GL006 -- generated fixture\n"
            + _URLOPEN + "    return urllib.request.urlopen(url)\n",
    "rule-scoped": _URLOPEN + "    return urllib.request.urlopen(url)"
                              "  # graft-lint: disable=GL001 -- wrong rule\n",
    "all": _URLOPEN + "    return urllib.request.urlopen(url)  # graft-lint: disable=all\n",
}
SUPPRESSED = {"trailing": (True, "caller enforces a deadline"),
              "standalone": (True, "bounded by the socket default"),
              "file": (True, "generated fixture"), "rule-scoped": (False, ""), "all": (True, "")}


@pytest.mark.parametrize("case", list(SUPPRESSIONS))
def test_suppressions_give_the_reference_s_findings(case, tmp_path):
    p = tmp_path / "mod.py"
    p.write_text(SUPPRESSIONS[case])
    got = {}
    for plane, (core_mod, rules_mod) in {"port": (core, rules), "jax": (jcore, jrules)}.items():
        got[plane] = [f.as_dict() for f in core_mod.run_rules(core_mod.load_project([p]),
                                                              [rules_mod.NetTimeoutRule()])]
    assert got["port"] == got["jax"]
    assert len(got["port"]) == 1
    assert (got["port"][0]["suppressed"], got["port"][0]["suppress_reason"]) == SUPPRESSED[case]


def test_module_load_skips_syntax_errors(tmp_path):
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    assert core.load_module(broken, tmp_path) is None is jcore.load_module(broken, tmp_path)
    assert core.load_project([tmp_path]).modules == [] == jcore.load_project([tmp_path]).modules


# -- reporting / CLI plumbing -------------------------------------------------

def _as_reference(payload):
    """A JSON report or state with GL001 and GL002's names put back."""
    out = json.loads(json.dumps(payload))
    for rule_id, (port_name, jax_name) in RENAMED.items():
        entry = out["rules"].get(rule_id)
        if entry is not None:
            assert entry["name"] == port_name
            entry["name"] = jax_name
    return out


def _cli(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.fixture()
def cli_files(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(_URLOPEN + "    return urllib.request.urlopen(url)\n")
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    quiet = tmp_path / "quiet.py"
    quiet.write_text(SUPPRESSIONS["trailing"])
    return tmp_path, bad, good, quiet


def test_cli_json_format_and_exit_codes(cli_files, capsys):
    tmp_path, bad, good, quiet = cli_files
    runs = [[str(bad), "--format", "json", "--no-state"],
            [str(bad), "--no-state"],
            [str(good), "--no-state"],
            [str(quiet), "--show-suppressed", "--no-state"],
            [str(quiet), "--format", "json", "--show-suppressed", "--no-state"],
            [str(tmp_path), "--rules", "GL006,GL003", "--format", "json", "--no-state"],
            [str(REF_FIXTURES / "bad_patterns.py"), "--rules", ",".join(SHARED), "--no-state"]]
    for argv in runs:
        rc, out = _cli(tmain.main, argv, capsys)
        jrc, jout = _cli(jmain.main, argv, capsys)
        assert rc == jrc, argv
        if "json" in argv:
            port, jax = json.loads(out), json.loads(jout)
            port["summary"] = _as_reference(port["summary"])
            assert port == jax, argv
        else:
            assert out == jout, argv
    rc, out = _cli(tmain.main, runs[0], capsys)
    payload = json.loads(out)
    assert rc == 1 and payload["summary"]["unsuppressed"] == 1
    assert payload["findings"][0]["rule"] == "GL006"
    assert _cli(tmain.main, runs[2], capsys)[0] == 0


def test_cli_exits_1_on_the_port_s_bad_fixture_with_every_rule_firing(capsys):
    rc, out = _cli(tmain.main, [str(FIXTURES / "bad_patterns.py"), "--format", "json",
                                "--no-state"], capsys)
    assert rc == 1
    assert set(json.loads(out)["summary"]["by_rule"]) == {f"GL00{i}" for i in range(1, 9)}
    rc, out = _cli(tmain.main, [str(FIXTURES / "good_patterns.py"), "--no-state"], capsys)
    assert rc == 0 and out.strip() == "graft-lint: 0 finding(s), 0 suppressed, 8 rule(s)"


def test_cli_lists_the_reference_s_rule_ids(capsys):
    rc, out = _cli(tmain.main, ["--list-rules"], capsys)
    assert rc == 0
    ids = [line.split()[0] for line in out.splitlines() if not line.startswith(" ")]
    assert ids == [cls.id for cls in jrules.ALL_RULES]
    assert "capture-purity" in out and "static-inputs" in out


def test_cli_writes_state_file(tmp_path, monkeypatch, capsys):
    target = tmp_path / "clean.py"
    target.write_text("x = 1\n")
    states = {}
    for plane, main, read in (("port", tmain.main, reporter.read_state),
                              ("jax", jmain.main, jreporter.read_state)):
        for subset in ("all", "shared"):
            path = tmp_path / f"{plane}-{subset}.json"
            monkeypatch.setenv("POLYAXON_TPU_LINT_STATE", str(path))
            argv = [str(target)] + (["--rules", ",".join(SHARED)] if subset == "shared" else [])
            assert main(argv) == 0
            states[plane, subset] = read()
            assert states[plane, subset] == json.loads(path.read_text())
    capsys.readouterr()
    port, jax = states["port", "all"], states["jax", "all"]
    assert port["unsuppressed"] == 0 and "GL001" in port["rules"]
    assert set(port) == set(jax)
    assert {k: v for k, v in _as_reference(port).items() if k != "ts"} == \
        {k: v for k, v in jax.items() if k != "ts"}
    port, jax = states["port", "shared"], states["jax", "shared"]
    assert {k: v for k, v in port.items() if k != "ts"} == \
        {k: v for k, v in jax.items() if k != "ts"}
    # The health probe reports the port's recorded run as clean.
    monkeypatch.setenv("POLYAXON_TPU_LINT_STATE", str(tmp_path / "port-all.json"))
    ok, detail = health.check_static_analysis(None)
    assert ok and detail.startswith("clean, 0 suppressed finding(s)")
    assert "GL001 v1" in detail and "GL008 v1" in detail


def test_the_state_path_reads_the_knobs_as_the_reference(tmp_path, monkeypatch):
    monkeypatch.delenv("POLYAXON_TPU_LINT_STATE", raising=False)
    monkeypatch.setenv("POLYAXON_TPU_HOME", str(tmp_path))
    assert reporter.state_file_path() == jreporter.state_file_path() == \
        tmp_path / "analysis" / "last_run.json"
    assert health.state_file_path is reporter.state_file_path
    assert health.read_state is reporter.read_state
    monkeypatch.setenv("POLYAXON_TPU_LINT_STATE", "~/x.json")
    assert reporter.state_file_path() == jreporter.state_file_path()


def test_run_analysis_writes_no_state(tmp_path, monkeypatch):
    monkeypatch.setenv("POLYAXON_TPU_LINT_STATE", str(tmp_path / "state.json"))
    target = tmp_path / "clean.py"
    target.write_text("x = 1\n")
    assert analysis.run_analysis([target]) == []
    assert not (tmp_path / "state.json").exists()


def test_all_rules_have_distinct_ids_and_docs():
    got = rules.default_rules()
    ids = [r.id for r in got]
    assert len(ids) == len(set(ids)) == 8
    assert ids == [r.id for r in jrules.default_rules()]
    for r in got:
        assert r.doc and r.version
    # The rule catalogs of the shared rules are the reference's.
    assert rules._ALLOWED_LABEL_KEYS == jrules._ALLOWED_LABEL_KEYS
    assert rules._SPAN_NAMES == jrules._SPAN_NAMES
    assert analysis.package_root() == REPO / "polyaxon_tpu_torch"
    assert janalysis.package_root() == REPO / "polyaxon_tpu"


# -- self-clean: the port's package ------------------------------------------

@pytest.fixture(scope="module")
def package_lint(tmp_path_factory):
    """One run of ``python -m polyaxon_tpu_torch.analysis`` over the package,
    as a user (and chip_smoke's phase 57) runs it: (rc, JSON report with the
    suppressed findings, the state file it wrote)."""
    state = tmp_path_factory.mktemp("lint") / "state.json"
    out = subprocess.run(
        [sys.executable, "-m", "polyaxon_tpu_torch.analysis", "--format", "json",
         "--show-suppressed"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, POLYAXON_TPU_LINT_STATE=str(state)))
    assert out.stdout, out.stderr[-4000:]
    return out.returncode, json.loads(out.stdout), state


def test_package_is_clean(package_lint):
    rc, report, state = package_lint
    unsuppressed = [f for f in report["findings"] if not f["suppressed"]]
    assert unsuppressed == [], "\n".join(
        f"{f['path']}:{f['line']}: {f['rule']}: {f['message']}" for f in unsuppressed)
    assert rc == 0 and report["summary"]["unsuppressed"] == 0
    recorded = reporter.read_state(state)
    assert {k: v for k, v in recorded.items() if k != "ts"} == report["summary"]


def test_every_suppression_is_justified(package_lint):
    unjustified = [f for f in package_lint[1]["findings"]
                   if f["suppressed"] and not f["suppress_reason"]]
    assert unjustified == [], "\n".join(
        f"{f['path']}:{f['line']}: {f['rule']} suppressed without a `-- reason`"
        for f in unjustified)


def test_all_rules_ran():
    assert {r.id for r in rules.default_rules()} >= {
        "GL001", "GL002", "GL003", "GL004", "GL005", "GL006"}


def test_the_analysis_loads_no_torch_and_imports_no_torch_at_module_level():
    new = sorted((REPO / "polyaxon_tpu_torch" / "analysis").glob("*.py")) + [
        REPO / "polyaxon_tpu_torch" / "monitor" / "cploadgen.py"]
    for path in new:
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) else [
                    node.module or ""]
                assert not any(n.split(".")[0] == "torch" for n in names), path
    code = ("import sys\nimport polyaxon_tpu_torch.analysis.__main__, "
            "polyaxon_tpu_torch.monitor.cploadgen, polyaxon_tpu_torch.checks.health\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stderr
