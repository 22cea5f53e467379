"""The port's thread lint (``paddle_tpu_torch/analysis/threads.py``) held to
JAX's (``paddle_tpu/analysis/threads.py``), and the port's own tree.

The fixtures in ``tests/thread_lint_fixtures/`` are read as SOURCE (pure
AST, never imported) by both packages' lints; the (rule, severity, line,
message) sets must be equal. Then the port's source: no un-allowlisted
HIGH finding, every allowlist entry reasoned and live, every runtime
module present, an acyclic static lock graph; the CLI's ``--threads`` exit
codes and the ``--list-rules`` / ``--json`` shapes; ``record_findings``.
"""
import contextlib
import io
import json
import os

import pytest

from paddle_tpu.analysis.threads import analyze_threads as jax_threads
from paddle_tpu_torch.analysis.__main__ import main as cli
from paddle_tpu_torch.analysis.threads import (
    BUILTIN_THREAD_ALLOWLIST,
    RUNTIME_MODULES,
    THREAD_RULES,
    analyze_threads,
    lock_order_graph,
    record_findings,
    thread_lint_paths,
)

FIXTURES = os.path.join(os.path.dirname(__file__), "thread_lint_fixtures")
FIXTURE_FILES = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".py"))


def _line(f):
    return f.where.split(" ", 1)[0].rsplit(":", 1)[-1] if f.where else ""


def _keyed(report):
    return sorted((f.rule, f.severity, _line(f), f.message)
                  for f in report.findings)


@pytest.fixture(scope="module")
def port_report():
    return analyze_threads()


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixture_findings_match_jax(name):
    path = os.path.join(FIXTURES, name)
    want = jax_threads(paths=[path], runtime_modules=("*",))
    got = analyze_threads(paths=[path], runtime_modules=("*",))
    assert got.findings, f"{name} seeds a violation"
    assert _keyed(got) == _keyed(want)
    assert got.rules_run == want.rules_run


def test_fixture_directory_matches_jax():
    paths = [os.path.join(FIXTURES, n) for n in FIXTURE_FILES]
    want = jax_threads(paths=paths, runtime_modules=("*",))
    got = analyze_threads(paths=paths, runtime_modules=("*",))
    assert _keyed(got) == _keyed(want)
    from paddle_tpu.analysis.threads import lock_order_graph as jax_graph

    assert set(lock_order_graph(paths=paths)) == set(jax_graph(paths=paths))


def test_synchronize_is_blocking_under_a_lock(tmp_path):
    """The device synchronisation counts as JAX's block_until_ready does;
    a host read of a device value does not, as in JAX."""
    src = tmp_path / "sync.py"
    src.write_text(
        "import threading\nimport torch\n\n\n"
        "class Pool:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n\n"
        "    def flush(self, ev):\n"
        "        with self._lock:\n"
        "            torch.cuda.synchronize()\n"
        "            ev.synchronize()\n\n"
        "    def read(self, t):\n"
        "        with self._lock:\n"
        "            return t.item(), t.cpu()\n")
    r = analyze_threads(paths=[str(src)], runtime_modules=("*",))
    blocking = [f for f in r.findings if f.rule == "blocking-under-lock"]
    assert [_line(f) for f in blocking] == ["11", "12"]
    assert all("synchronize" in f.message for f in blocking)


# ------------------------------------------------------------ the port tree
def test_port_tree_is_clean_or_visibly_allowlisted(port_report):
    assert port_report.high() == [], "\n".join(
        f.render() for f in port_report.high())
    assert port_report.suppressed
    for f, entry in port_report.suppressed:
        assert entry.reason
    rules = {f.rule for f, _ in port_report.suppressed}
    assert {"unguarded-write", "blocking-under-lock", "raw-clock"} <= rules


def test_every_builtin_entry_is_reasoned_and_matches_the_port(port_report):
    """Each entry has a reason and a cause in the port's source: it
    suppresses at least one finding of the port's tree."""
    used = {id(e) for _f, e in port_report.suppressed}
    for entry in BUILTIN_THREAD_ALLOWLIST:
        assert entry.reason and len(entry.reason) > 20
        assert id(entry) in used, entry


def test_runtime_modules_exist_in_the_port():
    paths = [p.replace(os.sep, "/") for p in thread_lint_paths()]
    assert len(RUNTIME_MODULES) == 11
    for mod in RUNTIME_MODULES:
        assert any(p.endswith("paddle_tpu_torch/" + mod) for p in paths), mod
    assert not any("/_build/" in p or "/csrc/" in p for p in paths)


def test_static_lock_graph_of_the_port_is_acyclic():
    from paddle_tpu_torch.analysis.lockwitness import _find_cycles

    edges = lock_order_graph()
    adj = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
    assert _find_cycles(adj) == []
    assert ("kv_cache.PagedKVCache._lock",
            "prefix_cache.PrefixCache._lock") in edges


# --------------------------------------------------------------------- CLI
def test_cli_threads_exit_codes(capsys):
    import paddle_tpu_torch.analysis.lockwitness as lw

    assert cli(["--self-check", "--threads", FIXTURES]) == 1
    assert cli(["--threads", lw.__file__]) == 0
    capsys.readouterr()
    assert cli(["--threads"]) == 0
    out = capsys.readouterr().out
    assert "thread-lint" in out and "allowlisted" in out


def test_cli_list_rules_covers_every_leg(capsys):
    from paddle_tpu_torch.analysis import (COMMS_RULES, HBM_RULES, RULES,
                                           SURFACE_RULES)

    assert cli(["--list-rules"]) == 0
    lines = capsys.readouterr().out.splitlines()
    listed = [ln.split()[0] for ln in lines]
    assert listed == (list(RULES) + list(THREAD_RULES) + list(SURFACE_RULES)
                      + list(HBM_RULES) + list(COMMS_RULES))
    tags = {ln.split()[0]: ln.split()[1] for ln in lines}
    assert all(tags[r] == "[threads]" for r in THREAD_RULES)
    assert all(tags[r] == "[comms]" for r in COMMS_RULES)


def test_cli_json_shape_with_threads(tmp_path):
    src = tmp_path / "bad.py"
    with open(os.path.join(FIXTURES, "bad_unguarded.py")) as fh:
        src.write_text(fh.read())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(["--json", "--threads", str(src)])
    assert rc == 1
    payload = json.loads(buf.getvalue())
    assert payload["status"] == "lint-high" and payload["high_total"] >= 1
    assert [p["program"] for p in payload["programs"]] == ["thread-lint"]
    prog = payload["programs"][0]
    assert set(prog) == {"program", "findings", "suppressed", "by_rule",
                         "high_total"}
    assert prog["by_rule"] == {"unguarded-write": 1}


def test_record_findings_feeds_the_port_registry(port_report):
    from paddle_tpu_torch.observability.metrics import (MetricsRegistry,
                                                        render_prometheus)

    reg = MetricsRegistry()
    path = os.path.join(FIXTURES, "bad_unguarded.py")
    record_findings(analyze_threads(paths=[path], runtime_modules=("*",)),
                    reg)
    record_findings(port_report, reg)
    text = render_prometheus(reg)
    assert "paddle_analysis_findings_total" in text
    assert 'rule="unguarded-write",severity="high"' in text
    assert 'severity="suppressed"' in text
