"""glom-lint's framework-free checkers in the port (glom_tpu_torch/analysis)
against glom_tpu's (glom_tpu/analysis).

For each of the four checkers that read no framework's constructs
(lockset, lock-order, signal-safety, schema-emit; the torch forms of the
other four are held against glom_tpu's by their twin corpus,
tests/test_torch_port_analysis_jax_rules.py), the port's linter and
glom_tpu's, each restricted to that
checker, report the same findings (checker, path, line, column, symbol,
message and rule key) over every shared fixture under tests/fixtures/ and
over every inline snippet of glom_tpu's TestLockset, TestLockOrder,
TestSignalSafety, TestSchemaEmit and TestFramework (read from
tests/test_analysis.py, one parametrised case a snippet). Then the port's
own parts: the baseline's ratchet, the cache, the CLI over the whole port
(one subprocess for the module), its own default baseline, and the
repaired lockset sites.

Pure AST work: no jax compile, no torch kernel.
"""

import ast
import json
import re
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from glom_tpu.analysis import run as tpu_run
from glom_tpu.analysis.cache import AnalysisCache as TpuCache
from glom_tpu_torch.analysis import run as port_run
from glom_tpu_torch.analysis import baseline as port_baseline
from glom_tpu_torch.analysis.__main__ import DEFAULT_BASELINE, main as port_main
from glom_tpu_torch.analysis.cache import AnalysisCache as PortCache
from glom_tpu_torch.analysis.core import default_checkers

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "fixtures"
CHECKERS = ("lockset", "lock-order", "signal-safety", "schema-emit")
JAX_RULES = ("collective-coverage", "axis-environment", "trace-purity", "donation-safety")


def _rows(findings):
    return [(f.checker, f.path, f.line, f.col, f.symbol, f.message, f.key) for f in findings]


def _both(paths, checker):
    """(port rows, glom_tpu rows) of one checker over one analyzed set."""
    paths = [str(p) for p in paths]
    return _rows(port_run(paths, select=[checker])), _rows(tpu_run(paths, select=[checker]))


# ---------------------------------------------------------------------------
# the shared fixtures
# ---------------------------------------------------------------------------

# Each analyzed set with the checker its seeded hazard belongs to.
FIXTURE_SETS = {
    "racy_batcher": (("racy_batcher.py",), "lockset"),
    "lock_order": (("lock_order.py",), "lock-order"),
    "xmod_lock_order": (("xmod_lock_order.py", "xmod_lock_order_pool.py"), "lock-order"),
    "signal_fixture": (("signal_fixture.py",), "signal-safety"),
    "trace_emit": (("trace_emit.py",), "schema-emit"),
    "class_emit": (("class_emit.py",), "schema-emit"),
}


@pytest.mark.parametrize("checker", CHECKERS)
@pytest.mark.parametrize("fixture", sorted(FIXTURE_SETS))
def test_fixture_findings_equal_glom_tpus(fixture, checker, monkeypatch):
    monkeypatch.chdir(REPO)
    names, seeded = FIXTURE_SETS[fixture]
    port, tpu = _both([FIXTURES / n for n in names], checker)
    assert port == tpu
    if checker == seeded:
        assert port, f"{fixture}: the seeded {checker} hazard was not found"


# ---------------------------------------------------------------------------
# glom_tpu's inline snippets
# ---------------------------------------------------------------------------

_PRAGMA = re.compile(r"#\s*glom-lint:\s*ok\[([\w*,\- ]+)\]")
SNIPPET_CLASSES = ("TestLockset", "TestLockOrder", "TestSignalSafety", "TestSchemaEmit",
                   "TestFramework")


def _eval_str(node, env):
    """The string an expression of string literals and known names builds,
    or None."""
    try:
        value = eval(compile(ast.Expression(node), "<snippet>", "eval"),
                     {"__builtins__": {}}, dict(env))
    except Exception:  # noqa: BLE001 - anything not a pure string expression
        return None
    return value if isinstance(value, str) else None


def _snippets(classes=SNIPPET_CLASSES):
    """[(case id, source, file name)]: every source glom_tpu's tests in
    `classes` hand to `lint(tmp_path, SRC, name=...)` or write to a file
    with `.write_text(SRC)`, in the order they appear."""
    tree = ast.parse((REPO / "tests" / "test_analysis.py").read_text())
    module_env = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            value = _eval_str(node.value, module_env)
            if value is not None:
                module_env[node.targets[0].id] = value
    cases, seen = [], set()
    for cls in tree.body:
        if not (isinstance(cls, ast.ClassDef) and cls.name in classes):
            continue
        for fn in cls.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            env = dict(module_env)
            nodes = sorted((n for n in ast.walk(fn) if hasattr(n, "lineno")),
                           key=lambda n: (n.lineno, n.col_offset))
            k = 0
            for node in nodes:
                if (isinstance(node, ast.Assign) and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    value = _eval_str(node.value, env)
                    if value is not None:
                        env[node.targets[0].id] = value
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                if isinstance(func, ast.Name) and func.id == "lint" and len(node.args) >= 2:
                    src = _eval_str(node.args[1], env)
                    name = next((_eval_str(kw.value, env) for kw in node.keywords
                                 if kw.arg == "name"), None) or "snippet.py"
                elif (isinstance(func, ast.Attribute) and func.attr == "write_text"
                      and len(node.args) == 1):
                    src, name = _eval_str(node.args[0], env), "snippet.py"
                else:
                    continue
                if src is None or (src, name) in seen:
                    continue
                seen.add((src, name))
                cases.append((f"{cls.name}.{fn.name}.{k}", src, name))
                k += 1
    return cases


SNIPPETS = _snippets()


def test_the_snippet_corpus_is_glom_tpus():
    """Every class is read, and the corpus holds the seeded hazards."""
    classes = {case.split(".")[0] for case, _, _ in SNIPPETS}
    assert classes == set(SNIPPET_CLASSES)
    assert len(SNIPPETS) >= 35
    assert any("signal.signal" in src for _, src, _ in SNIPPETS)
    assert any("glom-lint: ok[" in src for _, src, _ in SNIPPETS)


@pytest.mark.parametrize("case,source,name", SNIPPETS, ids=[c for c, _, _ in SNIPPETS])
def test_snippet_findings_equal_glom_tpus(case, source, name, tmp_path):
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(source)
    for checker in CHECKERS:
        port, tpu = _both([path], checker)
        assert port == tpu, checker
    # With every checker: the port's findings are glom_tpu's restricted to
    # the four, and where every pragma names only those (a pragma for an
    # unported checker suppresses nothing in the port), the unused-pragma
    # warnings are glom_tpu's too.
    port_w, tpu_w = [], []
    port_all = _rows(port_run([str(path)], warnings=port_w))
    tpu_all = [r for r in _rows(tpu_run([str(path)], warnings=tpu_w))
               if r[0] in CHECKERS + ("pragma", "parse")]
    assert port_all == tpu_all
    named = {c.strip() for m in _PRAGMA.finditer(source) for c in m.group(1).split(",")}
    if named <= set(CHECKERS) | {"*"}:
        assert port_w == tpu_w


def test_the_snippets_carry_findings(tmp_path):
    """Not a corpus of clean code: the ported checkers fire on a good share
    of it (the seeded halves of glom_tpu's pairs)."""
    fired = 0
    for case, source, name in SNIPPETS:
        path = tmp_path / case / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(source)
        fired += bool(port_run([str(path)], select=list(CHECKERS)))
    assert fired >= 12, fired


# ---------------------------------------------------------------------------
# the framework: checkers, baseline, cache
# ---------------------------------------------------------------------------

RACY = (
    "import threading\n"
    "class Worker:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self.count = 0\n"
    "        self._thread = threading.Thread(target=self._run)\n"
    "    def _run(self):\n"
    "        with self._lock:\n"
    "            self.count += 1\n"
    "    def read(self):\n"
    "        return self.count\n"
)


class TestFramework:
    def test_default_checkers_are_glom_tpus_eight(self):
        from glom_tpu.analysis.core import default_checkers as tpu_default_checkers

        names = [c.name for c in default_checkers()]
        assert names == [c.name for c in tpu_default_checkers()]
        assert names[:4] == list(JAX_RULES) and sorted(names[4:]) == sorted(CHECKERS)

    # One seeded site each, in torch form, linted under a registration path.
    SEEDED = {
        "collective-coverage": ("import torch.distributed as dist\n"
                                "def f(t, g):\n"
                                "    dist.all_reduce(t, group=g)\n"),
        "axis-environment": ("from glom_tpu_torch.parallel.collectives import all_reduce\n"
                             "def f(make_mesh, MeshConfig, rank_axes, t):\n"
                             "    axes = rank_axes(make_mesh(MeshConfig(data=2)))\n"
                             "    return all_reduce(t, axes.model)\n"),
        "trace-purity": ("import torch\n"
                         "@torch.compile\n"
                         "def f(t):\n"
                         "    return t.item()\n"),
        "donation-safety": ("def f(pool, k):\n"
                            "    return k(pool.buffer())\n"),
    }

    @pytest.mark.parametrize("name", JAX_RULES)
    def test_selecting_a_jax_rule_checker_runs_it(self, name, tmp_path):
        path = tmp_path / "parallel" / "manual.py"
        path.parent.mkdir()
        path.write_text("x = 1\n")
        assert port_run([str(path)], select=[name]) == []
        assert tpu_run([str(path)], select=[name]) == []
        path.write_text(self.SEEDED[name])
        found = port_run([str(path)], select=[name])
        assert [f.checker for f in found] == [name]
        assert found[0].line == len(self.SEEDED[name].splitlines())

    def test_an_unknown_checker_raises(self, tmp_path):
        path = tmp_path / "m.py"
        path.write_text("x = 1\n")
        with pytest.raises(ValueError, match="unknown checkers"):
            port_run([str(path)], select=["nope"])

    def test_list_checkers(self, capsys):
        assert port_main(["--list-checkers"]) == 0
        out = capsys.readouterr().out
        assert [line.split()[0] for line in out.splitlines()] == [
            c.name for c in default_checkers()]
        assert sorted(line.split()[0] for line in out.splitlines()) == sorted(
            CHECKERS + JAX_RULES)

    def test_baseline_roundtrip_ratchet_and_refusal(self, tmp_path, capsys):
        bad = tmp_path / "mod.py"
        bad.write_text(RACY)
        b = tmp_path / "baseline.json"
        assert port_main([str(bad), "--no-baseline"]) == 1
        assert port_main([str(bad), "--write-baseline", str(b)]) == 0
        data = json.loads(b.read_text())
        assert len(data["suppressions"]) == 1
        # an unreviewed entry refuses to gate
        assert port_main([str(bad), "--baseline", str(b)]) == 1
        assert "without a 'reviewed' note" in capsys.readouterr().err
        for entry in data["suppressions"].values():
            entry["reviewed"] = "seeded test suppression"
        b.write_text(json.dumps(data))
        assert port_main([str(bad), "--baseline", str(b)]) == 0
        # a finding beyond the baselined count fails
        bad.write_text(RACY + "    def again(self):\n        return self.count\n")
        assert port_main([str(bad), "--baseline", str(b)]) == 1
        # fixing everything leaves the stale entry as a warning only
        bad.write_text("def f(x):\n    return x\n")
        capsys.readouterr()
        assert port_main([str(bad), "--baseline", str(b)]) == 0
        assert "stale baseline entry" in capsys.readouterr().out
        # and the port's baseline file is glom_tpu's format
        from glom_tpu.analysis import baseline as tpu_baseline

        assert tpu_baseline.load(str(b)) == port_baseline.load(str(b))

    def test_fingerprints_are_line_free_and_glom_tpus(self, tmp_path):
        (tmp_path / "a").mkdir()
        path = tmp_path / "a" / "m.py"
        path.write_text(RACY)
        fp1 = [f.fingerprint for f in port_run([str(path)])]
        path.write_text("# a comment pushing everything down\n\n\n" + RACY)
        fp2 = [f.fingerprint for f in port_run([str(path)])]
        assert fp1 == fp2 and len(fp1) == 1
        assert fp2 == [f.fingerprint for f in tpu_run([str(path)], select=["lockset"])]

    def test_prune_baseline(self, tmp_path, capsys):
        bad = tmp_path / "mod.py"
        bad.write_text(RACY)
        b = tmp_path / "baseline.json"
        assert port_main([str(bad), "--write-baseline", str(b)]) == 0
        data = json.loads(b.read_text())
        for entry in data["suppressions"].values():
            entry["reviewed"] = "seeded test suppression"
        b.write_text(json.dumps(data))
        bad.write_text("def f(x):\n    return x\n")
        before = b.read_text()
        assert port_main([str(bad), "--baseline", str(b), "--prune-baseline"]) == 0
        assert "dry run" in capsys.readouterr().out and b.read_text() == before
        assert port_main([str(bad), "--baseline", str(b), "--prune-baseline", "--apply"]) == 0
        assert json.loads(b.read_text())["suppressions"] == {}
        removal = json.loads(Path(str(b) + ".removed.json").read_text())
        [(fp, entry)] = removal["removed"].items()
        assert fp.startswith("lockset::") and entry["reviewed"] == "seeded test suppression"
        assert port_main([str(bad), "--baseline", str(b), "--select", "lockset",
                          "--prune-baseline"]) == 2


class TestAnalysisCache:
    """The cross-module lock-order pair plus a lone module, through the
    port's cache and glom_tpu's: the same findings, the same reuse."""

    LONE = "def f(x):\n    return x\n"
    NAMES = ("xmod_lock_order.py", "xmod_lock_order_pool.py", "lone.py")

    def _tree(self, tmp_path):
        for name in self.NAMES[:2]:
            shutil.copy(FIXTURES / name, tmp_path / name)
        (tmp_path / "lone.py").write_text(self.LONE)
        return [str(tmp_path / n) for n in self.NAMES]

    @staticmethod
    def _cached(tmp_path, paths, cache_cls, run, name):
        cache = cache_cls(str(tmp_path / name))
        return cache, run(paths, cache=cache)

    def _pass(self, tmp_path, paths):
        port = self._cached(tmp_path, paths, PortCache, port_run, "port.json")
        tpu = self._cached(tmp_path, paths, TpuCache, tpu_run, "tpu.json")
        tpu_rows = [r for r in _rows(tpu[1]) if r[0] in CHECKERS]
        assert _rows(port[1]) == tpu_rows
        assert port[0].stats() == tpu[0].stats()
        return port

    def test_warm_cache_replays_findings(self, tmp_path):
        paths = self._tree(tmp_path)
        cache, cold = self._pass(tmp_path, paths)
        assert cache.stats() == "cache: 0/3 files reused (cold)"
        assert [f.checker for f in cold] == ["lock-order", "lock-order"]
        cache, warm = self._pass(tmp_path, paths)
        assert cache.stats() == "cache: 3/3 files reused (warm)"
        assert [(f.fingerprint, f.line) for f in warm] == [(f.fingerprint, f.line) for f in cold]

    @pytest.mark.parametrize("edited", ["xmod_lock_order.py", "xmod_lock_order_pool.py"])
    def test_an_edit_invalidates_both_ends_of_an_import(self, edited, tmp_path):
        paths = self._tree(tmp_path)
        self._pass(tmp_path, paths)
        target = tmp_path / edited
        target.write_text(target.read_text() + "\n# an edit\n")
        cache, findings = self._pass(tmp_path, paths)
        assert cache.stats() == "cache: 1/3 files reused (mixed)"
        assert [Path(p).name for p in cache.reused_files] == ["lone.py"]
        assert len(findings) == 2

    def test_corruption_falls_back_loudly(self, tmp_path, capsys):
        paths = self._tree(tmp_path)
        _, cold = self._pass(tmp_path, paths)
        (tmp_path / "port.json").write_text("{ not json")
        cache, findings = self._cached(tmp_path, paths, PortCache, port_run, "port.json")
        err = capsys.readouterr().err
        assert "unreadable" in err and "FULL pass" in err
        assert cache.stats() == "cache: 0/3 files reused (cold)"
        assert [f.fingerprint for f in findings] == [f.fingerprint for f in cold]

    def test_select_runs_never_cache(self, tmp_path):
        paths = self._tree(tmp_path)
        cache = PortCache(str(tmp_path / "port.json"))
        port_run(paths, cache=cache, select=["lockset"])
        assert "disabled" in cache.stats()
        assert not (tmp_path / "port.json").exists()


# ---------------------------------------------------------------------------
# the port linted by itself
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def self_host():
    """`python -m glom_tpu_torch.analysis glom_tpu_torch` from the repo root,
    once for the module: (exit code, stdout, stderr)."""
    res = subprocess.run(
        [sys.executable, "-m", "glom_tpu_torch.analysis", "glom_tpu_torch"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    return res.returncode, res.stdout, res.stderr


class TestSelfHost:
    def test_the_port_lints_clean_with_its_own_baseline(self, self_host):
        rc, out, err = self_host
        assert rc == 0, out + err
        assert "glom-lint: clean" in out
        assert "warning" not in out, out

    def test_the_default_baseline_is_the_ports_own(self):
        assert Path(DEFAULT_BASELINE) == REPO / "glom_tpu_torch" / "analysis_baseline.json"
        assert Path(DEFAULT_BASELINE) != REPO / "analysis_baseline.json"
        data = port_baseline.load(DEFAULT_BASELINE)
        assert port_baseline.unreviewed(data) == []
        # the reviewed entries are the port's own, never glom_tpu's paths
        assert data["suppressions"]
        assert all(fp.split("::")[1].startswith("glom_tpu_torch/")
                   for fp in data["suppressions"])

    def test_the_root_baseline_is_never_read(self, tmp_path, monkeypatch, capsys):
        """From the repo root, where glom_tpu's baseline lies, the port's
        CLI reads its own: a run over a clean file reports every entry it
        read as stale, and those are the port's, never glom_tpu's four."""
        monkeypatch.chdir(REPO)
        clean = tmp_path / "m.py"
        clean.write_text("x = 1\n")
        assert port_main([str(clean)]) == 0
        out = capsys.readouterr().out
        stale = [line.rsplit(": ", 1)[1] for line in out.splitlines()
                 if line.startswith("warning: stale baseline entry")]
        assert not [fp for fp in stale if fp.split("::")[1].startswith("glom_tpu/")]
        assert sorted(stale) == sorted(port_baseline.load(DEFAULT_BASELINE)["suppressions"])
        assert "glom-lint: clean" in out

    @pytest.mark.parametrize("relpath", ["glom_tpu_torch/utils/checkpoint.py",
                                         "glom_tpu_torch/utils/metrics.py"])
    def test_glom_tpus_lockset_finds_nothing_at_the_repaired_sites(self, relpath, monkeypatch):
        monkeypatch.chdir(REPO)
        assert tpu_run([relpath], select=["lockset"]) == []
        assert port_run([relpath], select=["lockset"]) == []

    def test_the_writer_error_pragma_says_what_orders_it(self):
        text = (REPO / "glom_tpu_torch/utils/checkpoint.py").read_text()
        assert "# glom-lint: ok[lockset] read only by _drain, after its join()" in text


# ---------------------------------------------------------------------------
# the repaired race: MetricsWriter.write against close()
# ---------------------------------------------------------------------------


class _FakeBoard:
    def __init__(self):
        self.scalars = []
        self.closed = False

    def add_scalar(self, k, v, step):
        self.scalars.append((k, v, step))

    def close(self):
        self.closed = True


class _CloseBeforeNthAcquire:
    """A lock that, just before its n-th acquisition, lets a second thread
    run the writer's close() to its end: the interleaving in which a write
    that already looked at the tensorboard writer meets a close."""

    def __init__(self, writer, n):
        self._lock = threading.Lock()
        self._writer, self._n, self._count = writer, n, 0

    def __enter__(self):
        self._count += 1
        if self._count == self._n:
            t = threading.Thread(target=self._writer.close)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False


def test_metrics_write_racing_close_skips_the_board():
    """On the parent, write() tested `self._tb` outside the lock, so a
    close() landing between the test and the lock made it call
    `None.add_scalar` (AttributeError)."""
    from glom_tpu_torch.utils.metrics import MetricsWriter

    w = MetricsWriter(path=None, echo=False)
    board = _FakeBoard()
    w._tb = board
    w.write({"step": 1, "loss": 0.5})
    assert ("loss", 0.5, 1) in board.scalars
    mirrored = list(board.scalars)
    # the write's second lock section is where the board is mirrored
    w._lock = _CloseBeforeNthAcquire(w, n=2)
    w.write({"step": 2, "loss": 0.25})
    assert board.closed and w._tb is None
    assert board.scalars == mirrored
