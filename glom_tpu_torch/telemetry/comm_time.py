"""Per-collective wall time: the measured half of the capacity observatory.

Counterpart of `glom_tpu/telemetry/comm_time.py`. `telemetry/counters.py`
prices the parallel paths' collectives in BYTES; this module measures the
CLOCK:

  * `CollectiveTimeSampler` -- the "sampled" timing mode's harness: from the
    site registry a counted step or dispatch filled
    (counters.CollectiveCounters.sites: site, axis, collective, rank-local
    shape, dtype, scatter/gather dim), it runs each site's one collective
    on zeros of that shape over this rank's group of that axis, through
    `parallel/collectives.py` (so gloo's pinned staging applies as in the
    real step). Each site is timed with a device synchronize before and
    after, the minimum of `repeats` runs after one untimed warm run (the
    bench convention). The number is the ISOLATED collective: an upper
    bound on its blocking cost inside the real step, and the
    latency/bandwidth point the alpha-beta fit needs. A sample is itself a
    collective: every rank of the group calls `sample()` at the same
    boundary and walks the sites in the same sorted order, and each site's
    minimum is MAX-reduced over the mesh's axes, so every rank stamps the
    slowest rank's time (glom_tpu's single `block_until_ready` waits for
    the slowest shard).

  * the alpha-beta time model -- `wall_ms = alpha_ms + beta_ms_per_byte *
    wire_bytes`, fitted by closed-form least squares from the measured
    points and stamped back onto every record as `comm_time_model_ms` and
    `comm_time_model_drift`.

  * `collective_time_records` -- the "collective_time" rows (site, axis,
    collective, bytes, wall_ms, bytes_per_s, mode, model drift) plus one
    `comm_time_model` row carrying the fitted alpha / beta.

The model math is pure Python, the same as glom_tpu's; only the sampler
touches torch.distributed.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from glom_tpu_torch.telemetry import schema

# The axes a sample's MAX runs over, in this order on every rank.
MESH_AXES = ("data", "seq", "model")


# -- the alpha-beta time model ------------------------------------------------


def fit_time_model(points: List[dict]) -> dict:
    """Least-squares `wall_ms = alpha + beta * wire_bytes` over measured
    site points ({wire_bytes, wall_ms}). One point (or all points at one
    byte size) pins alpha to the mean and beta to 0: a model claiming a
    bandwidth it never measured would fake a fit. beta is clamped at 0 (a
    negative marginal byte cost is noise, and extrapolating it would
    predict negative time)."""
    pts = [
        (float(p["wire_bytes"]), float(p["wall_ms"]))
        for p in points
        if isinstance(p.get("wire_bytes"), (int, float))
        and isinstance(p.get("wall_ms"), (int, float))
    ]
    n = len(pts)
    if n == 0:
        return {"alpha_ms": 0.0, "beta_ms_per_byte": 0.0, "n_points": 0}
    mean_x = sum(x for x, _ in pts) / n
    mean_y = sum(y for _, y in pts) / n
    var_x = sum((x - mean_x) ** 2 for x, _ in pts)
    if var_x <= 0.0:
        return {"alpha_ms": round(mean_y, 6), "beta_ms_per_byte": 0.0, "n_points": n}
    beta = sum((x - mean_x) * (y - mean_y) for x, y in pts) / var_x
    beta = max(0.0, beta)
    alpha = max(0.0, mean_y - beta * mean_x)
    return {"alpha_ms": round(alpha, 6), "beta_ms_per_byte": beta, "n_points": n}


def predict_ms(model: dict, wire_bytes: float) -> float:
    return float(model.get("alpha_ms", 0.0)) + float(
        model.get("beta_ms_per_byte", 0.0)
    ) * float(wire_bytes)


def time_model_drift(wall_ms: float, model_ms: float) -> float:
    """(measured - modeled) / modeled, with glom_tpu's inf -> 1e9 clamp."""
    if model_ms <= 0.0:
        return 0.0 if wall_ms == 0.0 else 1e9
    return round((wall_ms - model_ms) / model_ms, 6)


def collective_time_records(
    samples: List[dict],
    *,
    path: str,
    mode: str,
    model: Optional[dict] = None,
) -> List[dict]:
    """Stamped "collective_time" rows from raw site samples ({site, axis,
    collective, wire_bytes, wall_ms[, calls, wall_ms_max]}). The
    alpha-beta model is fitted from these points unless one is passed;
    every row stamps its own drift, and a final `comm_time_model` row
    carries the fit and the aggregate drift."""
    if not samples:
        return []
    fitted = model if model is not None else fit_time_model(samples)
    out = []
    total_measured = 0.0
    total_modeled = 0.0
    for s in sorted(samples, key=lambda r: str(r.get("site"))):
        wall = float(s["wall_ms"])
        nbytes = int(s.get("wire_bytes", 0))
        pred = predict_ms(fitted, nbytes)
        total_measured += wall
        total_modeled += pred
        rec = {
            "site": str(s["site"]),
            "axis": s.get("axis"),
            "collective": s.get("collective"),
            "path": path,
            "mode": mode,
            "wire_bytes": nbytes,
            "wall_ms": wall,
            "bytes_per_s": round(nbytes / (wall / 1e3), 1) if wall > 0 else None,
            "comm_time_model_ms": round(pred, 6),
            "comm_time_model_drift": time_model_drift(wall, pred),
        }
        for k in ("calls", "wall_ms_max"):
            if k in s:
                rec[k] = s[k]
        out.append(schema.stamp(rec, kind="collective_time"))
    out.append(schema.stamp({
        "site": "comm_time_model",
        "path": path,
        "mode": mode,
        "wall_ms": round(total_measured, 6),
        "alpha_ms": fitted["alpha_ms"],
        "beta_ms_per_byte": fitted["beta_ms_per_byte"],
        "n_points": fitted["n_points"],
        "comm_time_model_ms": round(total_modeled, 6),
        "comm_time_model_drift": time_model_drift(total_measured, total_modeled),
    }, kind="collective_time"))
    return out


# -- the sampled-mode re-dispatch harness ----------------------------------------


def _dtype(name: str) -> torch.dtype:
    """A registered site's dtype ("torch.float32") as a torch dtype."""
    return getattr(torch, str(name).rpartition(".")[2])


class CollectiveTimeSampler:
    """Re-dispatches each registered collective site over this rank's
    groups: the "sampled" timing mode.

    `axes`: this rank's mesh axes by name (a dict of
    `parallel.collectives.Axis`, or a RankAxes tuple). `sites`: a counted
    run's site registry. `maybe_sample()` rate-limits to every
    `interval`-th call, so a fit loop can call it at every logging
    boundary. Every rank of the mesh must make the same calls."""

    def __init__(self, axes, sites: List[dict], *, interval: int = 10, repeats: int = 2,
                 device="cpu"):
        if interval < 1:
            raise ValueError(f"interval {interval} must be >= 1")
        if repeats < 1:
            raise ValueError(f"repeats {repeats} must be >= 1")
        self.axes = dict(axes._asdict()) if hasattr(axes, "_asdict") else dict(axes)
        self.device = torch.device(device)
        # Only sites that move wire, deduplicated by what determines their
        # time (site, axis, collective, payload bytes, dtype): two shapes of
        # one payload ride one timed collective, their calls merged.
        self._uniq: Dict[tuple, dict] = {}
        self._merge(sites)
        self.interval = int(interval)
        self.repeats = int(repeats)
        self._inputs: Dict[tuple, torch.Tensor] = {}
        self._calls = 0

    @staticmethod
    def _key(s: dict) -> tuple:
        return (s["site"], s["axis"], s["collective"], s["wire_bytes"], s.get("dtype"))

    def _merge(self, sites: List[dict]) -> None:
        for s in sites:
            if s.get("wire_bytes", 0) <= 0:
                continue
            key = self._key(s)
            if key in self._uniq:
                self._uniq[key]["calls"] += s.get("calls", 1)
            else:
                self._uniq[key] = dict(s)

    @property
    def sites(self) -> List[dict]:
        """The sites in the order every rank samples them (sorted by key)."""
        return [self._uniq[k] for k in sorted(self._uniq, key=str)]

    def update_sites(self, sites: List[dict]) -> None:
        """Merge sites registered after construction (a new signature's
        first dispatch); an already-known key is skipped, so re-merging the
        same registry does not double its calls."""
        for s in sites:
            if s.get("wire_bytes", 0) <= 0:
                continue
            self._uniq.setdefault(self._key(s), dict(s))

    def _run(self, site: dict) -> None:
        """The site's one collective on zeros of its rank-local shape,
        through parallel/collectives.py (uncounted: no site name)."""
        from glom_tpu_torch.parallel import collectives

        key = self._key(site)
        x = self._inputs.get(key)
        if x is None:
            x = self._inputs[key] = torch.zeros(
                tuple(site["shape"]), dtype=_dtype(site["dtype"]), device=self.device)
        axis = self.axes[site["axis"]]
        collective, dim = site["collective"], int(site.get("dim", 0))
        if collective in ("psum", "pmean"):  # a mean is the sum's all-reduce
            collectives.all_reduce(x, axis)
        elif collective == "psum_scatter":
            collectives.reduce_scatter(x, axis, dim)
        elif collective == "all_gather":
            collectives.all_gather(x, axis, dim)
        else:
            raise ValueError(f"unknown collective {collective!r}")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _max_over_mesh(self, values: List[float]) -> List[float]:
        """Each value's MAX over every rank of the mesh: one MAX all-reduce
        over each axis of more than one rank, in MESH_AXES order."""
        from glom_tpu_torch.parallel.collectives import transport

        out = list(values)
        for name in MESH_AXES:
            axis = self.axes.get(name)
            if axis is None or axis.size <= 1:
                continue
            # A gloo group reduces host memory; NCCL the device's.
            host = dist.get_backend(axis.group) == "gloo"
            t = torch.tensor(out, dtype=torch.float64,
                             device="cpu" if host else self.device)
            transport("timing all_reduce", axis.name, lambda: dist.all_reduce(
                t, op=dist.ReduceOp.MAX, group=axis.group))
            out = t.tolist()
        return out

    def sample(self) -> List[dict]:
        """One timed pass over every registered site: each site's minimum
        over `repeats` synchronized runs (its first pass ever warms,
        untimed), then the MAX over the mesh. Returns raw site samples (feed
        them to collective_time_records)."""
        sites = self.sites
        best = []
        for site in sites:
            key = self._key(site)
            if key not in self._inputs:
                self._run(site)  # allocate + warm, untimed
            t_min = float("inf")
            for _ in range(self.repeats):
                self._sync()
                t0 = time.perf_counter()
                self._run(site)
                self._sync()
                t_min = min(t_min, time.perf_counter() - t0)
            best.append(t_min)
        best = self._max_over_mesh(best) if sites else best
        return [
            {
                "site": site["site"],
                "axis": site["axis"],
                "collective": site["collective"],
                "wire_bytes": site["wire_bytes"],
                "calls": site.get("calls", 1),
                "wall_ms": round(t * 1e3, 6),
            }
            for site, t in zip(sites, best)
        ]

    def maybe_sample(self, *, path: str) -> List[dict]:
        """Every `interval`-th call: sample, fit and return the stamped
        collective_time records (empty between samples)."""
        self._calls += 1
        if self._calls % self.interval != 0:
            return []
        return collective_time_records(self.sample(), path=path, mode="sampled")
