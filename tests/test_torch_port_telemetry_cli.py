"""The operator's tooling in the port against glom_tpu's: the bench emitter
(`telemetry/sinks.py` emit and bench_bootstrap), the regression gate
(`telemetry/compare.py`) and the Perfetto export (`telemetry/perfetto.py`).

The trace events of `perfetto.convert_lines` must equal glom_tpu's as JSON,
and `compare.main`'s reports (stdout and stderr) and exit codes must equal
glom_tpu's, over the committed fixtures (bench, collective timing,
capacity and SLO streams), over bench artifacts written to tmp_path, and
over streams the port itself writes on the CPU: the train CLI at mnist with
`--trace-steps` and checkpoints, `python -m glom_tpu_torch.resilience
--scenario preempt-pod --device cpu` (two hosts' barrier chains, flight
dumps) and the serve CLI with `--elastic` (decisions, scale events,
dispatch phases). Those three run once for the module (about 30 s).
"""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import pytest

from glom_tpu.telemetry import compare as tpu_compare
from glom_tpu.telemetry import perfetto as tpu_perfetto
from glom_tpu.telemetry import sinks as tpu_sinks
from glom_tpu.telemetry import watchdog as tpu_watchdog
from glom_tpu_torch.telemetry import compare, perfetto, schema, sinks, watchdog
from glom_tpu_torch.tracing import flight

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
STREAM_FIXTURES = ("bench_base.jsonl", "bench_new.jsonl", "colltime_base.jsonl",
                   "colltime_new.jsonl", "capacity_exhausted.jsonl", "capacity_idle.jsonl",
                   "slo_breach.jsonl")


def _run_main(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


def _same_compare(argv, capsys):
    """Both gates on the same argv: equal exit codes and reports."""
    port = _run_main(compare.main, argv, capsys)
    tpu = _run_main(tpu_compare.main, argv, capsys)
    assert port == tpu
    return port


# ---------------------------------------------------------------------------
# the port's own CPU streams
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_streams(tmp_path_factory):
    """{name: [paths]} of JSONL streams the port wrote on the CPU."""
    d = tmp_path_factory.mktemp("streams")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)

    def call(*argv):
        res = subprocess.run([sys.executable, "-m", *argv], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]

    call("glom_tpu_torch.train.cli", "--preset", "mnist", "--device", "cpu", "--steps", "4",
         "--log-every", "1", "--trace-steps", "2:3", "--trace-dir", str(d / "trace"),
         "--checkpoint-every", "2", "--checkpoint-dir", str(d / "ckpt"),
         "--metrics-file", str(d / "train.jsonl"))
    call("glom_tpu_torch.resilience", "--scenario", "preempt-pod", "--dir", str(d / "pod"),
         "--device", "cpu", "--steps", "40")
    call("glom_tpu_torch.serve", "--preset", "mnist", "--device", "cpu", "--iters", "12",
         "--buckets", "1,2,4", "--max-batch", "4", "--queue-depth", "512", "--elastic",
         "--min-engines", "1", "--max-engines", "2", "--warm-pool", "1", "--forecast",
         "--ramp", "4x20,40x0,8x20", "--elastic-p99-ms", "1", "--elastic-window", "0.5",
         "--elastic-dwell", "0.05", "--elastic-cooldown", "0.3", "--elastic-interval", "0.02",
         "--elastic-settle", "30", "--out", str(d / "serve.jsonl"))
    pod = d / "pod"
    return {
        "train": [d / "train.jsonl"],
        "pod": sorted(pod.glob("metrics_h*.jsonl")),
        "pod_flight": sorted(pod.glob("flight_h*/*.jsonl")),
        "serve": [d / "serve.jsonl"],
    }


def _records(paths):
    recs = []
    for p in paths:
        with open(p) as fh:
            recs.extend(rec for _, rec in schema.iter_json_lines(fh))
    return recs


@pytest.mark.parametrize("stream", ["train", "pod", "pod_flight", "serve"])
def test_perfetto_on_the_ports_streams_equals_glom_tpus(stream, port_streams):
    paths = port_streams[stream]
    assert paths
    for p in paths:
        lines = Path(p).read_text().splitlines()
        port, tpu = perfetto.convert_lines(lines), tpu_perfetto.convert_lines(lines)
        assert json.dumps(port["traceEvents"]) == json.dumps(tpu["traceEvents"])
    # the merged form the CLI writes, every file of the stream in one trace
    merged = _records(paths)
    assert (json.dumps(perfetto.to_trace_events(merged))
            == json.dumps(tpu_perfetto.to_trace_events(merged)))


def test_the_ports_streams_carry_what_the_trace_draws(port_streams):
    """Not vacuous: timed spans, both hosts' barrier rounds, decisions that
    actuated scale events, dispatch phases."""
    pod = _records(port_streams["pod"])
    evs = perfetto.to_trace_events(pod)
    timed = [r for r in pod if r.get("kind") == "span" and "t_start" in r]
    assert timed and len([e for e in evs if e["ph"] == "X"]) == len(timed)
    hosts = {r.get("host") for r in pod if r.get("kind") == "barrier"}
    assert len(hosts) == 2
    tracks = [e for e in evs if e["ph"] == "M" and str(e["args"].get("name", "")).startswith("barrier")]
    assert len(tracks) == 2
    serve = _records(port_streams["serve"])
    decided = {r["decision_id"] for r in serve if isinstance(r.get("decision_id"), int)
               and r.get("event") in perfetto._SCALE_EVENTS}
    assert decided
    sevs = perfetto.to_trace_events(serve)
    flows = {e["id"] for e in sevs if e.get("cat") == "decision"}
    assert {f"decision:fleet0:{d}" for d in decided} <= flows or all(
        any(f.endswith(f":{d}") for f in flows) for d in decided)


def test_perfetto_main_equals_glom_tpus(port_streams, tmp_path, capsys):
    paths = [str(p) for p in port_streams["pod"] + port_streams["train"]]
    port_out, tpu_out = tmp_path / "port.json", tmp_path / "tpu.json"
    assert perfetto.main([*paths, "-o", str(port_out)]) == 0
    assert tpu_perfetto.main([*paths, "-o", str(tpu_out)]) == 0
    port, tpu = json.loads(port_out.read_text()), json.loads(tpu_out.read_text())
    assert port["metadata"].pop("source") == "glom_tpu_torch.telemetry.perfetto"
    assert tpu["metadata"].pop("source") == "glom_tpu.telemetry.perfetto"
    assert port == tpu
    out = capsys.readouterr().out.splitlines()
    assert out[0].split(":")[1] == out[1].split(":")[1]  # the same event count
    empty = tmp_path / "empty.jsonl"
    empty.write_text("not json\n")
    assert perfetto.main([str(empty)]) == tpu_perfetto.main([str(empty)]) == 1


def test_the_ports_streams_lint_and_compare_clean(port_streams, capsys):
    """A stream compared with itself passes both gates with one report."""
    for name in ("train", "serve"):
        p = str(port_streams[name][0])
        rc, out, err = _same_compare([p, p], capsys)
        assert rc == 0


# ---------------------------------------------------------------------------
# the committed fixtures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", STREAM_FIXTURES)
def test_perfetto_on_the_fixtures_equals_glom_tpus(name):
    lines = (FIXTURES / name).read_text().splitlines()
    port, tpu = perfetto.convert_lines(lines), tpu_perfetto.convert_lines(lines)
    assert port["traceEvents"]
    assert json.dumps(port["traceEvents"]) == json.dumps(tpu["traceEvents"])
    assert port["displayTimeUnit"] == tpu["displayTimeUnit"]


COMPARE_CASES = {
    "bench_regression": ["bench_base.jsonl", "bench_new.jsonl"],
    "bench_self": ["bench_base.jsonl", "bench_base.jsonl"],
    "bench_reverse": ["bench_new.jsonl", "bench_base.jsonl"],
    "bench_fail_on_missing": ["bench_base.jsonl", "bench_new.jsonl", "--fail-on-missing"],
    "bench_threshold": ["bench_base.jsonl", "bench_new.jsonl", "--threshold", "0.5"],
    "colltime": ["colltime_base.jsonl", "colltime_new.jsonl"],
    "colltime_reverse": ["colltime_new.jsonl", "colltime_base.jsonl", "--fail-on-missing"],
    "capacity": ["capacity_idle.jsonl", "capacity_exhausted.jsonl"],
    "capacity_reverse": ["capacity_exhausted.jsonl", "capacity_idle.jsonl"],
    "slo": ["slo_breach.jsonl", "slo_breach.jsonl"],
}


@pytest.mark.parametrize("case", sorted(COMPARE_CASES))
def test_compare_on_the_fixtures_equals_glom_tpus(case, capsys, monkeypatch):
    monkeypatch.chdir(REPO)
    argv = [f"tests/fixtures/{a}" if a.endswith(".jsonl") else a for a in COMPARE_CASES[case]]
    rc, out, err = _same_compare(argv, capsys)
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["kind"] == "summary" and schema.validate_record(summary) == []
    if case == "bench_regression":
        assert rc == 1 and "REGRESSION" in err


def _bench(metric, value, unit="ms", **kw):
    return json.dumps(schema.stamp({"metric": metric, "value": value, "unit": unit, **kw},
                                   kind="bench"))


def _error(metric, unit="ms"):
    return json.dumps(schema.stamp({"metric": metric, "value": None, "unit": unit,
                                    "error": "backend-init-unavailable"}, kind="error"))


def _artifact(path, lines, parsed=None):
    obj = {"tail": "\n".join(lines)}
    if parsed is not None:
        obj["parsed"] = parsed
    path.write_text(json.dumps(obj))
    return str(path)


ARTIFACT_CASES = {
    "regression": ([_bench("p50", 5.0), _bench("rate", 100.0, unit="column-iters/s")],
                   [_bench("p50", 7.5), _bench("rate", 50.0, unit="column-iters/s")]),
    "best_of_repeats": ([_bench("p50", 5.0), _bench("p50", 6.0)],
                        [_bench("p50", 5.1), _bench("p50", 9.0)]),
    "unmeasured_new": ([_bench("p50", 5.0), _bench("step", 20.0)],
                       [_bench("p50", 5.0), _error("step")]),
    "missing_new": ([_bench("p50", 5.0), _bench("step", 20.0)], [_bench("p50", 5.0)]),
    "all_unmeasured": ([_error("p50")], [_error("p50")]),
}


@pytest.mark.parametrize("flags", [[], ["--fail-on-missing"]], ids=["plain", "fail_on_missing"])
@pytest.mark.parametrize("case", sorted(ARTIFACT_CASES))
def test_compare_bench_artifacts_equals_glom_tpus(case, flags, tmp_path, capsys):
    base_lines, new_lines = ARTIFACT_CASES[case]
    base = _artifact(tmp_path / "base.json", base_lines)
    new = _artifact(tmp_path / "new.json", new_lines)
    rc, out, err = _same_compare([base, new, "--bench-artifact", *flags], capsys)
    if case == "regression":
        assert rc == 1
    if case == "unmeasured_new":
        # an UNMEASURED row only warns, even under --fail-on-missing
        assert rc == 0 and "UNMEASURED_IN_NEW" in err


def test_compare_artifact_parsed_fallback(tmp_path, capsys):
    base = _artifact(tmp_path / "base.json", [],
                     parsed=json.loads(_bench("p50", 5.0)))
    new = _artifact(tmp_path / "new.json", [], parsed=json.loads(_bench("p50", 8.0)))
    rc, _, _ = _same_compare([base, new, "--bench-artifact"], capsys)
    assert rc == 1


@pytest.mark.parametrize("unit", ["ms", "column-iters/s/chip", "x", "percent", "bytes",
                                  "iters/request", "s", "MiB", "requests/s", "ratio"])
def test_lower_is_better_equals_glom_tpus(unit):
    for metric in ("serve_p50", "headroom_frac", "regret_ms", "served_share", "pad_waste",
                   "forecast_mape", "delta_chain_depth", "failed_requests"):
        assert (compare.lower_is_better(metric, unit)
                == tpu_compare.lower_is_better(metric, unit)), metric


@pytest.mark.parametrize("name", STREAM_FIXTURES)
def test_load_and_flatten_equal_glom_tpus(name):
    lines = (FIXTURES / name).read_text().splitlines()
    assert compare.load_bench_records(lines) == tpu_compare.load_bench_records(lines)
    for _, rec in schema.iter_json_lines(lines):
        assert (compare.flatten_engine_metrics(rec)
                == tpu_compare.flatten_engine_metrics(rec))


# ---------------------------------------------------------------------------
# emit and bench_bootstrap
# ---------------------------------------------------------------------------


class _Up:
    def record(self):
        return {"backend_state": "up", "backend_devices": 1}


class _Ring:
    def __init__(self):
        self.seen = []

    def observe(self, rec):
        self.seen.append(rec)


@pytest.fixture
def globals_restored():
    yield
    watchdog.set_global_watchdog(None)
    tpu_watchdog.set_global_watchdog(None)
    flight.set_global_flight_recorder(None)


@pytest.mark.parametrize("kind", ["bench", "error", "note"])
def test_emit_stamps_equal_glom_tpus(kind, capsys, globals_restored):
    rec = {"metric": "p50", "value": 5.0, "unit": "ms"}
    if kind == "error":
        rec = {"metric": "p50", "value": None, "unit": "ms", "error": "backend-init-unavailable"}
    if kind == "note":
        rec = {"note": "hello", "backend_state": "down"}  # an existing key wins
    watchdog.set_global_watchdog(_Up())
    tpu_watchdog.set_global_watchdog(_Up())
    ring = _Ring()
    flight.set_global_flight_recorder(ring)
    port = sinks.emit(copy.deepcopy(rec), kind=kind)
    port_line = capsys.readouterr().out
    tpu = tpu_sinks.emit(copy.deepcopy(rec), kind=kind)
    tpu_line = capsys.readouterr().out
    assert port == tpu and port_line == tpu_line
    assert json.loads(port_line) == port
    assert ring.seen == [port]
    assert schema.validate_record(port) == []
    if kind == "note":
        assert port["backend_state"] == "down"


def test_emit_to_a_stream(tmp_path, globals_restored):
    path = tmp_path / "rows.jsonl"
    with open(path, "w") as fh:
        sinks.emit({"metric": "p50", "value": 1.0, "unit": "ms"}, stream=fh)
    (row,) = [json.loads(l) for l in path.read_text().splitlines()]
    assert row["kind"] == "bench" and row["schema_version"] == schema.SCHEMA_VERSION
    assert schema.main([str(path)]) == 0


def test_bench_bootstrap_with_the_probe_down(capsys, monkeypatch, globals_restored):
    """Exactly one UNMEASURED record, False, and no platform switched."""
    import torch

    from glom_tpu_torch.utils import metrics

    calls = []
    monkeypatch.setattr(metrics, "probe_device_count",
                        lambda timeout=120.0, device_type="cuda": calls.append(device_type))
    env = dict(os.environ)
    device = torch.empty(0).device
    assert sinks.bench_bootstrap("serve_p50", "ms", probe_timeout=5.0) is False
    assert calls == ["cuda"]  # one probe, of the card, and no second platform
    assert dict(os.environ) == env and torch.empty(0).device == device
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["kind"] == "error" and row["value"] is None
    assert row["error"] == "backend-init-unavailable"
    assert row["metric"] == "serve_p50" and row["unit"] == "ms"
    assert row["backend_state"] == "down"
    assert [t["backend_state"] for t in row["watchdog_timeline"]] == ["down"]
    assert schema.validate_record(row) == []
    # glom_tpu's record for the same outage carries the same fields
    wd = mock.Mock()
    wd.probe_once.return_value = "down"
    wd.timeline.return_value = row["watchdog_timeline"]
    wd.record.return_value = {"backend_state": "down"}
    with mock.patch("glom_tpu.telemetry.watchdog.BackendWatchdog", return_value=wd), \
            mock.patch.dict("os.environ", {}, clear=False):
        assert tpu_sinks.bench_bootstrap("serve_p50", "ms") is False
    tpu_row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = ("kind", "schema_version", "metric", "value", "unit", "error", "backend_state",
            "watchdog_timeline")
    assert {k: row[k] for k in keys} == {k: tpu_row[k] for k in keys}
    # and the gate reads it as missing, never as a regression
    results = compare.compare_records(*compare.load_bench_records([_bench("serve_p50", 5.0)]),
                                      *compare.load_bench_records(lines))
    assert [r["status"] for r in results] == ["unmeasured-in-new"]


def test_bench_bootstrap_with_the_probe_up(capsys, monkeypatch, globals_restored):
    from glom_tpu_torch.utils import metrics

    seen = []

    def probe(timeout=120.0, device_type="cuda"):
        seen.append(device_type)
        return 1

    monkeypatch.setattr(metrics, "probe_device_count", probe)
    assert sinks.bench_bootstrap("serve_p50", "ms", device_type="cpu") is True
    assert seen == ["cpu"]
    assert capsys.readouterr().out == ""
    row = sinks.emit({"metric": "serve_p50", "value": 5.0, "unit": "ms"})
    assert row["backend_state"] == "up" and row["backend_devices"] == 1
    assert json.loads(capsys.readouterr().out) == row


def test_bench_bootstrap_probes_the_cpu_for_real(capsys, globals_restored):
    """The throwaway-subprocess probe of the CPU answers on this machine."""
    assert sinks.bench_bootstrap("m", "ms", device_type="cpu", probe_timeout=120.0) is True
    assert watchdog.get_global_watchdog().state == "up"
