"""glom-lint's four jax-reading checkers in torch form
(glom_tpu_torch/analysis: collective-coverage, axis-environment,
trace-purity, donation-safety) held against glom_tpu's.

Every case of glom_tpu's TestCollectiveCoverage, TestTracePurity,
TestDonationSafety, TestAxisEnvironment, TestHandRolledCollectiveTiming
and the purity / donation / mesh-flow cases of TestCrossModulePairs
(tests/test_analysis.py) has a TORCH TWIN: the same hazard (or the same
clean shape) written against the port's constructs, line for line. An
inline snippet's twin is in SNIPPET_TWINS; a fixture's twin is the file
of the same name under tests/torch_fixtures/ (parsed, never imported).
glom_tpu's checkers on the original and the port's on the twin give the
same findings, checker by checker: the same count, file names, lines,
symbols, and keys under KEY_MAP. A case with no torch counterpart is in
NOT_CARRIED with its reason, and one test holds that every case is one
or the other, so the corpus cannot shrink silently.

Then the port itself: one whole-tree pass (a module fixture) whose
findings are exactly its reviewed baseline's, and whose attested axis
environments are the meshes make_mesh and ServeMesh build.

Pure AST work: no jax compile, no torch kernel.
"""

import ast
from pathlib import Path

import pytest

from glom_tpu.analysis import run as tpu_run
from glom_tpu_torch.analysis import baseline as port_baseline
from glom_tpu_torch.analysis import run as port_run
from glom_tpu_torch.analysis.__main__ import DEFAULT_BASELINE
from test_torch_port_analysis import _snippets

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "fixtures"
TWIN_FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
JAX_RULES = ("collective-coverage", "axis-environment", "trace-purity", "donation-safety")
TWIN_CLASSES = ("TestCollectiveCoverage", "TestTracePurity", "TestDonationSafety",
                "TestAxisEnvironment", "TestHandRolledCollectiveTiming",
                "TestCrossModulePairs")

# glom_tpu's rule key -> the port's, where the torch form names it
# otherwise: an axis name is checked where the Axis is made (mesh_axis),
# the collectives are the port's, and a dispatch of an unpinned pool
# snapshot is what the use-after-donation findings become.
KEY_MAP = {
    "axis-psum": "axis-mesh_axis",
    "axis-pmean": "axis-mesh_axis",
    "unregistered-psum_scatter": "unregistered-reduce_scatter",
    "hand-rolled-timing-psum": "hand-rolled-timing-all_reduce",
    "use-after-donate-imgs": "alias-unpinned-dispatch",
    "splat-at-donating-call": "alias-unpinned-dispatch",
}

_DONATE = ("a donate_argnums rule: eager PyTorch donates no buffer, and the port "
           "resolves ServeConfig.donate to False (analysis/donation.py)")
NOT_CARRIED = {
    "TestDonationSafety.test_use_after_donated_dispatch.0": _DONATE,
    "TestDonationSafety.test_non_donated_position_clean.0": _DONATE,
    "TestDonationSafety.test_rebind_revives_the_name.0": _DONATE,
    "TestDonationSafety.test_decorated_empty_argnums_means_no_donation.0": _DONATE,
    "TestDonationSafety.test_decorated_donating_function_flagged.0": _DONATE,
    "TestDonationSafety.test_lowered_compile_chain_conservative.0":
        _DONATE + "; the .lower().compile() chain has no torch counterpart",
    "TestDonationSafety.test_memoized_handle_via_provider_method_flagged.0": _DONATE,
    "TestDonationSafety.test_memoized_handle_direct_subscript_call_flagged.0": _DONATE,
    "TestDonationSafety.test_memoized_handle_splat_kwargs_conservative.0": _DONATE,
    "TestDonationSafety.test_memoized_handle_rebind_clears_the_taint.0": _DONATE,
    "TestDonationSafety.test_memoized_handle_non_donated_position_clean.0": _DONATE,
    "TestDonationSafety.test_memoized_handle_fixture_pair":
        _DONATE + " (tests/fixtures/donation_memo.py)",
    "TestAxisEnvironment.test_spec_axes_union_into_env.0":
        "PartitionSpec in_specs/out_specs have no torch counterpart: a rank's "
        "Axis values come from its mesh alone",
}

# glom_tpu's cases that read fixtures: the analyzed sets (file names under
# tests/fixtures/ and tests/torch_fixtures/), and the path the first file
# is linted under when the case copies it (the registration-scope path).
FIXTURE_TWINS = {
    "TestDonationSafety.test_alias_fixture_pair": [("alias_pool.py",)],
    "TestAxisEnvironment.test_seeded_fixture_pair": [("axis_env.py",)],
    "TestAxisEnvironment.test_opaque_param_caller_attestation_pair": [("axis_env_param.py",)],
    "TestHandRolledCollectiveTiming.test_fixture_pair":
        [("collective_timing.py",), "parallel/manual.py"],
    "TestCrossModulePairs.test_purity_reaches_through_import":
        [("xmod_purity.py", "xmod_purity_util.py")],
    "TestCrossModulePairs.test_purity_pair_needs_both_files": [("xmod_purity_util.py",)],
    "TestCrossModulePairs.test_donation_handle_flows_through_typed_receiver":
        [("xmod_donation.py", "xmod_donation_engine.py")],
    "TestCrossModulePairs.test_mesh_flow_attested_through_import":
        [("xmod_mesh_flow.py", "xmod_mesh_flow_runtime.py"), ("xmod_mesh_flow.py",)],
}
# glom_tpu's cases over its own tree: the port's counterpart.
REAL_TWINS = {
    "TestAxisEnvironment.test_serve_mesh_paged_gather_is_clean":
        "test_serve_mesh_twin_is_clean",
    "TestCrossModulePairs.test_real_repo_project_evidence": "TestRealPort",
}
# TestCrossModulePairs' lock-order case belongs to a framework-free checker,
# held against glom_tpu's in tests/test_torch_port_analysis.py.
ELSEWHERE = {
    "TestCrossModulePairs.test_lock_order_cycle_across_classes_and_modules":
        "test_torch_port_analysis.FIXTURE_SETS['xmod_lock_order']",
}

SNIPPET_TWINS = {
    # -- collective-coverage ---------------------------------------------
    "TestCollectiveCoverage.test_unknown_axis_literal_flagged.0": (
        "from glom_tpu_torch.parallel.collectives import all_reduce, mesh_axis\n"
        "def f(x, mesh):\n"
        "    return all_reduce(x, mesh_axis(mesh, 'bogus_axis'))\n"
    ),
    "TestCollectiveCoverage.test_declared_axis_constant_clean.0": (
        "from glom_tpu_torch.parallel.collectives import all_reduce, mesh_axis\n"
        "DATA_AXIS = 'data'\n"
        "def f(x, mesh):\n"
        "    return all_reduce(x, mesh_axis(mesh, DATA_AXIS))\n"
    ),
    "TestCollectiveCoverage.test_axis_param_threading_clean.0": (
        "from glom_tpu_torch.parallel.collectives import mesh_axis, ring_shift\n"
        "def shard_body(x, mesh, axis_name):\n"
        "    return ring_shift([x], mesh_axis(mesh, axis_name))\n"
    ),
    "TestCollectiveCoverage.test_non_axis_param_flagged.0": (
        "from glom_tpu_torch.parallel.collectives import all_reduce, mesh_axis\n"
        "def f(x, mesh, which):\n"
        "    return all_reduce(x, mesh_axis(mesh, which))\n"
    ),
    "TestCollectiveCoverage.test_unregistered_collective_in_wire_module.0": (
        "from glom_tpu_torch.parallel.collectives import reduce_scatter\n"
        "def grads(g, data_axis):\n"
        "    return reduce_scatter(g, data_axis, 0)\n"
    ),
    "TestCollectiveCoverage.test_registered_collective_clean.0": (
        "from glom_tpu_torch.parallel.collectives import reduce_scatter\n"
        "from glom_tpu_torch.telemetry import counters as tele_counters\n"
        "def grads(g, data_axis):\n"
        "    tele_counters.record_collective('reduce', 8)\n"
        "    return reduce_scatter(g, data_axis, 0)\n"
    ),
    "TestCollectiveCoverage.test_registration_not_required_outside_wire_modules.0": (
        "from glom_tpu_torch.parallel.collectives import all_reduce\n"
        "def f(x, data_axis):\n"
        "    return all_reduce(x, data_axis)\n"
    ),
    # -- trace-purity -----------------------------------------------------
    "TestTracePurity.test_host_clock_in_jitted_body.0": (
        "import time\n"
        "import torch\n"
        "def step(x):\n"
        "    t0 = time.perf_counter()\n"
        "    return x + t0\n"
        "fast = torch.compile(step)\n"
    ),
    "TestTracePurity.test_print_reachable_through_helper.0": (
        "import torch\n"
        "def helper(x):\n"
        "    print('loss', x)\n"
        "    return x\n"
        "def step(x):\n"
        "    return helper(x) * 2\n"
        "fast = torch.compile(step)\n"
    ),
    "TestTracePurity.test_numpy_on_parameter_in_shard_map_body.0": (
        "import numpy as np\n"
        "import torch\n"
        "def build(mesh):\n"
        "    def body(params, x):\n"
        "        return np.asarray(x).sum()\n"
        "    return torch.func.vmap(body, in_dims=(None, 0))\n"
    ),
    "TestTracePurity.test_metadata_reads_are_pure.0": (
        "import numpy as np\n"
        "import torch\n"
        "def step(x):\n"
        "    b = x.shape[0]\n"
        "    scale = np.float32(1.0 / b)\n"
        "    dt = x.element_size() * x.size(0)\n"
        "    return x * scale + dt\n"
        "fast = torch.compile(step)\n"
    ),
    "TestTracePurity.test_branch_on_tracer_value.0": (
        "import torch\n"
        "from torch.func import vmap\n"
        "def body(c, x):\n"
        "    s = torch.sum(x)\n"
        "    if s > 0:\n"
        "        return c, x\n"
        "    return c, -x\n"
        "def outer(xs):\n"
        "    return vmap(body, in_dims=(None, 0))(0, xs)\n"
    ),
    "TestTracePurity.test_while_loop_cond_and_config_branch_clean.0": (
        "import torch\n"
        "from torch.func import vmap\n"
        "def run(x0, remat):\n"
        "    def cond(c):\n"
        "        return torch.max(torch.abs(c)) > 1e-3\n"
        "    def body(c):\n"
        "        if remat:\n"
        "            return c * 0.5\n"
        "        return c * 0.9\n"
        "    return vmap(body)(x0) if vmap(cond)(x0).all() else x0\n"
    ),
    "TestTracePurity.test_host_code_not_flagged.0": (
        "import time\n"
        "def bench(step):\n"
        "    t0 = time.perf_counter()\n"
        "    step()\n"
        "    print(time.perf_counter() - t0)\n"
    ),
    # -- donation-safety: the aliased-pool pinning rule -------------------
    "TestDonationSafety.test_alias_unpinned_dispatch_flagged.0": (
        "import torch\n"
        "class Engine:\n"
        "    def _compile(self, sig):\n"
        "        self._compiled[sig] = self._build(\n"
        "            sig\n"
        "        )\n"
        "        return self._compiled[sig]\n"
        "    def infer(self, sig, params):\n"
        "        fn = self._compile(sig)\n"
        "        buf = self.pool.buffer()\n"
        "        return fn(params, buf)\n"
    ),
    "TestDonationSafety.test_alias_pinned_rebind_clean.0": (
        "import torch\n"
        "class Engine:\n"
        "    def _compile(self, sig):\n"
        "        self._compiled[sig] = self._build(\n"
        "            sig\n"
        "        )\n"
        "        return self._compiled[sig]\n"
        "    def infer(self, sig, params):\n"
        "        fn = self._compile(sig)\n"
        "        buf = self.pool.buffer()\n"
        "        buf = self.pool.acquire_read()\n"
        "        try:\n"
        "            return fn(params, buf)\n"
        "        finally:\n"
        "            self.pool.release_read()\n"
    ),
    "TestDonationSafety.test_alias_compile_time_probe_clean.0": (
        "import torch\n"
        "class Engine:\n"
        "    def _compile(self, sig):\n"
        "        dt = self.pool.buffer().dtype\n"
        "        self._compiled[sig] = self._build(\n"
        "            sig, dt\n"
        "        )\n"
        "        return self._compiled[sig]\n"
    ),
    # -- axis-environment -------------------------------------------------
    "TestAxisEnvironment.test_mesh_attested_env_flags_foreign_axis.0": (
        "from glom_tpu_torch.parallel.collectives import all_reduce, mesh_axis\n"
        "from glom_tpu_torch.utils.config import MeshConfig\n"
        "from glom_tpu_torch.parallel.manual import rank_axes\n"
        "DATA_AXIS = 'data'\n"
        "MODEL_AXIS = 'model'\n"
        "def build(make_mesh):\n"
        "    mesh = make_mesh(MeshConfig(data=8))\n"
        "    def body(x):\n"
        "        return all_reduce(x, mesh_axis(mesh, MODEL_AXIS))\n"
        "    axes = rank_axes(mesh)\n"
        "    return body, axes.data\n"
    ),
    "TestAxisEnvironment.test_caller_attestation_beats_module_union.0": (
        "from glom_tpu_torch.parallel.collectives import all_reduce\n"
        "from glom_tpu_torch.utils.config import MeshConfig\n"
        "from glom_tpu_torch.parallel.manual import rank_axes\n"
        "DATA_AXIS = 'data'\n"
        "MODEL_AXIS = 'model'\n"
        "def train_mesh(make_mesh):\n"
        "    return make_mesh(MeshConfig(data=2, model=2))\n"
        "def helper(mesh):\n"
        "    def body(x):\n"
        "        return all_reduce(x, axes.model)\n"
        "    axes = rank_axes(mesh)\n"
        "    return body\n"
        "def build(make_mesh):\n"
        "    mesh = make_mesh(MeshConfig(data=8))\n"
        "    return helper(mesh)\n"
    ),
    "TestAxisEnvironment.test_one_unattested_caller_poisons_attestation.0": (
        "from glom_tpu_torch.parallel.collectives import all_reduce\n"
        "from glom_tpu_torch.utils.config import MeshConfig\n"
        "from glom_tpu_torch.parallel.manual import rank_axes\n"
        "DATA_AXIS = 'data'\n"
        "MODEL_AXIS = 'model'\n"
        "def train_mesh(make_mesh):\n"
        "    return make_mesh(MeshConfig(data=2, model=2))\n"
        "def helper(mesh):\n"
        "    def body(x):\n"
        "        return all_reduce(x, axes.model)\n"
        "    axes = rank_axes(mesh)\n"
        "    return body\n"
        "def build(make_mesh):\n"
        "    mesh = make_mesh(MeshConfig(data=8))\n"
        "    return helper(mesh)\n"
        "def build_opaque(mesh):\n"
        "    return helper(mesh)\n"
    ),
    "TestAxisEnvironment.test_opaque_mesh_skips.0": (
        "from glom_tpu_torch.parallel.collectives import all_reduce\n"
        "from glom_tpu_torch.parallel.manual import rank_axes\n"
        "DATA_AXIS = 'data'\n"
        "MODEL_AXIS = 'model'\n"
        "def build(mesh):\n"
        "    axes = rank_axes(mesh)\n"
        "    def body(x):\n"
        "        return all_reduce(x, axes.model)\n"
        "    return body\n"
    ),
    "TestAxisEnvironment.test_module_wide_meshconfig_attests.0": (
        "from glom_tpu_torch.parallel.collectives import all_reduce\n"
        "from glom_tpu_torch.utils.config import MeshConfig\n"
        "from glom_tpu_torch.parallel.manual import rank_axes\n"
        "DATA_AXIS = 'data'\n"
        "SEQ_AXIS = 'seq'\n"
        "MODEL_AXIS = 'model'\n"
        "def make_my_mesh(make_mesh, scfg):\n"
        "    return make_mesh(MeshConfig(data=scfg.d, seq=scfg.s))\n"
        "def build(mesh):\n"
        "    def body(x):\n"
        "        y = all_reduce(x, axes.seq)\n"
        "        return all_reduce(y, axes.model)\n"
        "    axes = rank_axes(mesh)\n"
        "    return body\n"
    ),
    # -- collective-coverage: hand-rolled timing --------------------------
    "TestHandRolledCollectiveTiming.test_wrapper_lambda_counts_as_registered.0": (
        "from glom_tpu_torch.parallel.collectives import all_reduce\n"
        "from glom_tpu_torch.telemetry import counters as tele_counters\n"
        "DATA_AXIS = 'data'\n"
        "def grads(g, data_axis):\n"
        "    return tele_counters.timed_collective(\n"
        "        's', DATA_AXIS, 'reduce', 8,\n"
        "        lambda x: all_reduce(x, data_axis), g,\n"
        "        collective='psum',\n"
        "    )\n"
    ),
    "TestHandRolledCollectiveTiming.test_timing_primitive_without_collective_is_fine.0": (
        "import time\n"
        "def stats():\n"
        "    return time.perf_counter()\n"
    ),
    "TestHandRolledCollectiveTiming.test_hand_rolled_clock_next_to_collective_flagged.0": (
        "import time\n"
        "from glom_tpu_torch.parallel.collectives import all_reduce\n"
        "from glom_tpu_torch.telemetry import counters as tele_counters\n"
        "DATA_AXIS = 'data'\n"
        "def grads(g, data_axis):\n"
        "    tele_counters.record_collective('reduce', 8)\n"
        "    t0 = time.perf_counter()\n"
        "    out = all_reduce(g, data_axis)\n"
        "    dt = time.perf_counter() - t0\n"
        "    return out, dt\n"
    ),
}


def _rows(findings, key_map=None):
    key_map = key_map or {}
    return sorted((Path(f.path).name, f.line, f.symbol, key_map.get(f.key, f.key))
                  for f in findings)


def _assert_twins(tpu_paths, port_paths):
    """Checker by checker, glom_tpu's findings on the originals (keys
    mapped) equal the port's on the twins; returns how many there were."""
    n = 0
    for checker in JAX_RULES:
        tpu = _rows(tpu_run(tpu_paths, select=[checker]), KEY_MAP)
        port = _rows(port_run(port_paths, select=[checker]))
        assert port == tpu, checker
        n += len(port)
    return n


# ---------------------------------------------------------------------------
# the corpus is glom_tpu's, whole
# ---------------------------------------------------------------------------

SNIPPETS = {case: (source, name) for case, source, name in _snippets(TWIN_CLASSES)}


def _case_methods():
    tree = ast.parse((REPO / "tests" / "test_analysis.py").read_text())
    return {
        f"{cls.name}.{fn.name}"
        for cls in tree.body if isinstance(cls, ast.ClassDef) and cls.name in TWIN_CLASSES
        for fn in cls.body if isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_")
    }


def test_every_case_is_twinned_or_not_carried():
    methods = _case_methods()
    assert len(methods) >= 45 and len(SNIPPETS) >= 37
    for case in SNIPPETS:
        assert (case in SNIPPET_TWINS) != (case in NOT_CARRIED), case
    with_snippets = {case.rsplit(".", 1)[0] for case in SNIPPETS}
    for method in methods - with_snippets:
        homes = [m for m in (FIXTURE_TWINS, REAL_TWINS, ELSEWHERE, NOT_CARRIED) if method in m]
        assert len(homes) == 1, method
    # nothing listed that glom_tpu's tests no longer have
    known = set(SNIPPETS) | methods
    for table in (SNIPPET_TWINS, NOT_CARRIED, FIXTURE_TWINS, REAL_TWINS, ELSEWHERE):
        assert set(table) <= known, sorted(set(table) - known)
    assert all(reason.strip() for reason in NOT_CARRIED.values())


def test_the_fixture_twins_are_line_aligned():
    """A twin is its original's length (xmod_donation_engine.py's provider
    class carries two more methods than the jax one needs), and names no
    jax."""
    twins = sorted({name for sets in FIXTURE_TWINS.values() for s in sets
                    if isinstance(s, tuple) for name in s} | {"xmod_donation_engine.py"})
    assert sorted(p.name for p in TWIN_FIXTURES.glob("*.py")) == twins
    for name in twins:
        ours = (TWIN_FIXTURES / name).read_text()
        theirs = (FIXTURES / name).read_text()
        if name != "xmod_donation_engine.py":
            assert len(ours.splitlines()) == len(theirs.splitlines()), name
        tree = ast.parse(ours)
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                        else [node.module or ""])
                assert not any(m.split(".")[0] in ("jax", "glom_tpu") for m in mods), name


# ---------------------------------------------------------------------------
# the twins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(SNIPPET_TWINS))
def test_snippet_twin_findings_equal_glom_tpus(case, tmp_path):
    source, name = SNIPPETS[case]
    tpu_path, port_path = tmp_path / "tpu" / name, tmp_path / "port" / name
    for path, text in ((tpu_path, source), (port_path, SNIPPET_TWINS[case])):
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    _assert_twins([str(tpu_path)], [str(port_path)])


@pytest.mark.parametrize("case", sorted(FIXTURE_TWINS))
def test_fixture_twin_findings_equal_glom_tpus(case, tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)
    sets = FIXTURE_TWINS[case]
    as_name = sets[1] if len(sets) == 2 and isinstance(sets[1], str) else None
    found = 0
    for names in (s for s in sets if isinstance(s, tuple)):
        if as_name is not None:
            paths = {}
            for root, tag in ((FIXTURES, "tpu"), (TWIN_FIXTURES, "port")):
                path = tmp_path / tag / as_name
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_text((root / names[0]).read_text())
                paths[tag] = [str(path)]
            found += _assert_twins(paths["tpu"], paths["port"])
        else:
            found += _assert_twins([str(FIXTURES / n) for n in names],
                                   [str(TWIN_FIXTURES / n) for n in names])
    # the seeded pairs carry their hazard (only the lone util is clean)
    assert found or case.endswith("needs_both_files"), case


def test_mesh_flow_twin_attestation_trail_equals_glom_tpus(monkeypatch):
    """The attestation trail of the cross-module mesh flow: (file, how,
    axes) for the pair, and every site unattested for the lone module."""
    monkeypatch.chdir(REPO)

    def trail(run, root, names):
        scratch = {}
        run([str(root / n) for n in names], select=["axis-environment"], scratch=scratch)
        return {(Path(p).name, how, axes) for p, _, how, axes in
                scratch["axis-environment:attested"]}

    for names in (("xmod_mesh_flow.py", "xmod_mesh_flow_runtime.py"), ("xmod_mesh_flow.py",)):
        ours = trail(port_run, TWIN_FIXTURES, names)
        assert ours == trail(tpu_run, FIXTURES, names)
    assert ("xmod_mesh_flow.py", "flow", ("data", "model", "seq")) in trail(
        port_run, TWIN_FIXTURES, ("xmod_mesh_flow.py", "xmod_mesh_flow_runtime.py"))


def test_serve_mesh_twin_is_clean():
    """glom_tpu's serve mesh and the port's: no finding of the four rules in
    either (the paged gathers all live in the (data, seq) environment)."""
    assert _assert_twins([str(REPO / "glom_tpu/parallel/serve_mesh.py")],
                         [str(REPO / "glom_tpu_torch/parallel/serve_mesh.py")]) == 0


# ---------------------------------------------------------------------------
# the rules' torch-only edges
# ---------------------------------------------------------------------------


def _lint(tmp_path, source, name="snippet.py", checker=None):
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(source)
    return port_run([str(path)], select=[checker] if checker else None)


@pytest.mark.parametrize("source,keys", [
    # a raw torch.distributed collective in a registration module
    ("import torch.distributed as dist\n"
     "def f(t, g):\n"
     "    dist.all_reduce(t, group=g)\n", ["unregistered-dist.all_reduce"]),
    # site= registers; site=None does not
    ("from glom_tpu_torch.parallel import collectives as coll\n"
     "def f(t, axis):\n"
     "    a = coll.all_reduce(t, axis, site='s')\n"
     "    return coll.all_gather(a, axis, 0, site=None)\n", ["unregistered-all_gather"]),
    # point-to-point is outside WIRE_MOVING (glom_tpu's ppermute)
    ("from glom_tpu_torch.parallel.collectives import ring_shift\n"
     "def f(t, axis):\n"
     "    return ring_shift([t], axis)\n", []),
    # an event harness around a registered collective
    ("import torch\n"
     "from glom_tpu_torch.parallel.collectives import all_reduce\n"
     "def f(t, axis):\n"
     "    ev = torch.cuda.Event(enable_timing=True)\n"
     "    return all_reduce(t, axis, site='s'), ev\n", ["hand-rolled-timing-all_reduce"]),
])
def test_registration_rule_torch_forms(source, keys, tmp_path):
    fs = _lint(tmp_path, source, "parallel/manual.py", "collective-coverage")
    assert [f.key for f in fs] == keys


@pytest.mark.parametrize("source,keys", [
    # loop variables over a literal tuple of declared axes resolve
    ("DATA_AXIS, SEQ_AXIS = 'data', 'seq'\n"
     "def axes(mesh):\n"
     "    return [mesh.get_group(n) for n in ('data', 'seq')]\n", []),
    ("def axes(mesh, Axis):\n"
     "    for name, size in (('data', 2), ('bogus', 2)):\n"
     "        yield Axis(name, None, size, 0)\n", ["axis-Axis"]),
    # an Axis parameter's own name is checked where the Axis was made
    ("def timed(counters, x, axis):\n"
     "    return counters.timed_collective('s', axis.name, 'reduce', 8, abs, x)\n", []),
    ("def timed(counters, x, group):\n"
     "    return counters.timed_collective('s', group.name, 'reduce', 8, abs, x)\n",
     ["axis-timed_collective"]),
])
def test_axis_name_sites(source, keys, tmp_path):
    assert [f.key for f in _lint(tmp_path, source, checker="collective-coverage")] == keys


def test_the_serve_mesh_model_axis_is_caught(tmp_path):
    """The hazard that motivates the rule in the port: a serve body (its
    axes a ServeMesh's, which sizes 'data' and 'seq') all-reducing over
    axes.model, whose Axis has size 1 and issues nothing."""
    src = (
        "from glom_tpu_torch.parallel.collectives import all_reduce\n"
        "class ServeMesh:\n"
        "    pass\n"
        "def serve_body(mesh: ServeMesh, x):\n"
        "    axes = mesh.axes\n"
        "    y = all_reduce(x, axes.seq)\n"
        "    return all_reduce(y, axes.model)\n"
    )
    fs = _lint(tmp_path, src, checker="axis-environment")
    assert [(f.line, f.key) for f in fs] == [(7, "axis-env-model")]


@pytest.mark.parametrize("source,lines", [
    # the captured body of a CUDA graph, and what it calls
    ("import time\n"
     "import torch\n"
     "def tick():\n"
     "    return time.monotonic()\n"
     "def replay(step, x, g):\n"
     "    t0 = time.monotonic()\n"
     "    with torch.cuda.graph(g):\n"
     "        y = step(x)\n"
     "        y.item()\n"
     "        tick()\n"
     "    return y, t0\n", [4, 9]),
    # a custom autograd Function runs eagerly: not an entry
    ("import torch\n"
     "class Op(torch.autograd.Function):\n"
     "    @staticmethod\n"
     "    def forward(ctx, x):\n"
     "        print(x.shape)\n"
     "        return x.cpu()\n", []),
    # decorator form, and a device sync
    ("import torch\n"
     "@torch.compile(mode='max-autotune')\n"
     "def step(x):\n"
     "    torch.cuda.synchronize()\n"
     "    return x\n", [4]),
])
def test_trace_purity_torch_entries(source, lines, tmp_path):
    assert [f.line for f in _lint(tmp_path, source, checker="trace-purity")] == lines


def test_a_pinned_dispatch_and_metadata_reads_are_clean(tmp_path):
    src = (
        "def run(pool, k, idx):\n"
        "    snap = pool.buffer()\n"
        "    n, dt = snap.shape[0], snap.dtype\n"
        "    rows = snap.size(0) + snap.numel()\n"
        "    pinned = pool.acquire_read()\n"
        "    try:\n"
        "        return k(pinned, idx), n, dt, rows\n"
        "    finally:\n"
        "        pool.release_read()\n"
        "def leak(pool, k):\n"
        "    return k(pool.buffer()[0]), pool.buffer().index_select(0, k)\n"
    )
    fs = _lint(tmp_path, src, checker="donation-safety")
    assert [(f.line, f.symbol) for f in fs] == [(11, "leak"), (11, "leak")]


# ---------------------------------------------------------------------------
# the port linted whole: its findings are its reviewed baseline's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_pass():
    """One in-process pass of all eight checkers over glom_tpu_torch/ from
    the repo root: (findings, scratch)."""
    import os

    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        scratch = {}
        findings = port_run(["glom_tpu_torch"], scratch=scratch)
    finally:
        os.chdir(cwd)
    return findings, scratch


class TestRealPort:
    def test_findings_are_the_reviewed_baseline(self, port_pass):
        findings, _ = port_pass
        data = port_baseline.load(DEFAULT_BASELINE)
        counts = {}
        for f in findings:
            counts[f.fingerprint] = counts.get(f.fingerprint, 0) + 1
        assert counts == {fp: e["count"] for fp, e in data["suppressions"].items()}
        # each entry names the glom_tpu entry it mirrors
        for fp, entry in data["suppressions"].items():
            assert fp.startswith("collective-coverage::glom_tpu_torch/parallel/manual.py::")
            assert "collective-coverage::glom_tpu/parallel/manual.py::" in entry["reviewed"]

    def test_the_page_scatter_sits_in_its_wrappers_scope(self, port_pass):
        """The needed-pages reduce-scatter sits in the scope chain of the
        timed_collective that counts it (glom_tpu's
        _scatter_needed_pages_wire registers the same site)."""
        findings, _ = port_pass
        assert not [f for f in findings if f.path.endswith("parallel/serve_mesh.py")]

    def test_attested_environments_are_the_meshes_built(self, port_pass):
        """parallel/manual.py's environments come from make_mesh's
        MeshConfig (all three axes, through the runtime's flow), the serve
        mesh's from ServeMesh ('data' and 'seq')."""
        _, scratch = port_pass
        trail = scratch["axis-environment:attested"]
        manual = [(how, axes) for p, _, how, axes in trail
                  if p == "glom_tpu_torch/parallel/manual.py" and how != "unattested"]
        serve = [(how, axes) for p, _, how, axes in trail
                 if p == "glom_tpu_torch/parallel/serve_mesh.py"]
        assert len(manual) >= 4 and serve, trail
        assert all(how == "flow" and axes == ("data", "model", "seq") for how, axes in manual)
        assert all(axes == ("data", "seq") for _, axes in serve)

    def test_the_cross_object_lock_edge(self, port_pass):
        _, scratch = port_pass
        edges = scratch["lock-order:edges"]
        path, line = edges[("ColumnCache._lock", "PagedColumnPool._lock")]
        assert path == "glom_tpu_torch/serve/column_cache.py" and line > 0

    def test_every_pragma_gives_a_reason(self):
        import re

        pragma = re.compile(r"#\s*glom-lint:\s*ok\[([\w*,\- ]+)\]\s*(.*)")
        for path in (REPO / "glom_tpu_torch").rglob("*.py"):
            for line in path.read_text().splitlines():
                m = pragma.search(line)
                if m and line.strip().startswith("#"):
                    assert len(m.group(2).split()) >= 3, (path, line)
