#!/usr/bin/env python3
"""Where a training rank's start goes, item by item, on one NVIDIA GPU.

    python3 rank_start.py [STEPS]

Builds the kernels (as `chip_smoke.py` does, so the ranks load them), then
times, each in a fresh process on the card:

  * the bare interpreter (`python -c pass`), `import torch`, `import
    glom_tpu_torch.train.cli` (the whole package), and CUDA's context
    (`torch.cuda.init()` and a first allocation); the package's import
    twice more with PYTHONPYCACHEPREFIX on a fresh directory (what bytecode
    the installation lacks); the modules whose import takes longest
    (`python -X importtime`);
  * `python -m torch.distributed.run --standalone --nproc-per-node 2
    rank_start.py --rank OUT ...`: each rank runs the training CLI's
    `--distributed` path (imagenet224-dp8, gloo, global batch 16, STEPS
    steps, default 3, a checkpoint after the last) in process, with marks
    at its first statement, after `import torch`, after the package's
    import, after CUDA's context, after `import torch._dynamo` (which
    torch.optim's first optimizer would import), around the process
    group's rendezvous
    (`initialize_multihost`), each kernel library's load, the
    DistributedTrainer's construction, each batch drawn, each step and the
    checkpoint's save and wait; the launcher's wall time around it.

Every mark is seconds since the launcher started torch.distributed.run
(the epoch clock, one host). It prints one JSON line per measurement and
the card's name and power limit; a run on a machine without a card exits 1.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

T_PROC = time.time()  # the rank's first statement (module import)


def _wall(code: str, env=None) -> float:
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", code], check=True, capture_output=True, timeout=600,
                   env=env)
    return time.perf_counter() - t0


def _import_top(n: int = 25) -> list:
    """`python -X importtime -c 'import glom_tpu_torch.train.cli'`: the n
    modules with the largest cumulative import time, [(us, module)]."""
    res = subprocess.run([sys.executable, "-X", "importtime", "-c",
                          "import glom_tpu_torch.train.cli"],
                         capture_output=True, text=True, timeout=600, check=True)
    rows = []
    for ln in res.stderr.splitlines():
        parts = ln.split("|")
        if len(parts) == 3 and parts[1].strip().isdigit():
            rows.append((int(parts[1]), parts[2].rstrip()))
    return sorted(rows, reverse=True)[:n]


def _rank(out_dir: str, argv: list) -> int:
    """One rank: the training CLI in process, its start marked."""
    t0 = float(os.environ["RANK_START_T0"])
    marks = [("process", T_PROC - t0)]

    def mark(name):
        marks.append((name, time.time() - t0))

    import torch

    mark("import_torch")
    from glom_tpu_torch.train import cli as train_cli

    mark("import_package")
    rank = int(os.environ["RANK"])
    if torch.cuda.is_available():
        torch.cuda.init()
        torch.empty(1, device="cuda")
        torch.cuda.synchronize()
        mark("cuda_context")

    # torch.optim's first optimizer imports torch._dynamo (its methods are
    # wrapped in torch._disable_dynamo); the trainer's construction pays it
    # unless it is imported first, here, on its own mark.
    import torch._dynamo  # noqa: F401

    mark("import_dynamo")
    import glom_tpu_torch.data as data_mod
    from glom_tpu_torch.kernels import _build
    from glom_tpu_torch.parallel import mesh
    from glom_tpu_torch.parallel.runtime import DistributedTrainer
    from glom_tpu_torch.utils.checkpoint import CheckpointManager

    def timed(owner, attr, label, each=False):
        orig = getattr(owner, attr)
        count = [0]

        def wrapper(*a, **kw):
            name = f"{label}_{count[0]}" if each else label
            count[0] += 1
            mark(f"{name}_begin")
            try:
                return orig(*a, **kw)
            finally:
                mark(f"{name}_end")

        setattr(owner, attr, wrapper)

    timed(mesh, "initialize_multihost", "rendezvous")
    orig_load = _build.load

    def load(name, signatures):
        fresh = name not in _build._LIBS
        t = time.time()
        lib = orig_load(name, signatures)
        if fresh:
            marks.append((f"load_{name}", time.time() - t0, time.time() - t))
        return lib

    _build.load = load
    timed(DistributedTrainer, "__init__", "trainer_init")
    timed(DistributedTrainer, "step", "step", each=True)
    timed(DistributedTrainer, "step_fast", "step", each=True)
    timed(CheckpointManager, "save", "ckpt_save", each=True)
    timed(CheckpointManager, "wait", "ckpt_wait", each=True)
    shapes = data_mod.shapes_dataset

    def marked_shapes(*a, **kw):
        it = shapes(*a, **kw)
        i = 0
        while True:
            mark(f"batch_{i}_begin")
            try:
                b = next(it)
            except StopIteration:
                return
            mark(f"batch_{i}_end")
            i += 1
            yield b

    data_mod.shapes_dataset = marked_shapes
    mark("patched")
    rc = train_cli.main(argv)
    mark("cli_returned")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump({"rank": rank, "rc": rc, "marks": marks}, fh)
    return rc


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("rank_start: no CUDA device is available", file=sys.stderr)
        return 1
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    from glom_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.prebuild()
    build_s = time.perf_counter() - t0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    fresh = {
        "python_pass": _wall("pass"),
        "import_torch": _wall("import torch"),
        "import_package": _wall("import glom_tpu_torch.train.cli"),
        "cuda_context": _wall("import torch; torch.cuda.init(); torch.empty(1, device='cuda');"
                              " torch.cuda.synchronize()"),
    }
    print(json.dumps({"phase": "fresh_process_s", "build_s": build_s, **fresh}), flush=True)
    # The same import with bytecode written to a fresh cache directory: the
    # first process compiles what the installation has no .pyc for, the
    # second reads it back.
    with tempfile.TemporaryDirectory(prefix="pyc_") as pyc:
        env = dict(os.environ, PYTHONPYCACHEPREFIX=pyc)
        cached = [_wall("import glom_tpu_torch.train.cli", env) for _ in range(2)]
    print(json.dumps({"phase": "pycache_prefix_s", "first": cached[0], "second": cached[1]}),
          flush=True)
    print(json.dumps({"phase": "import_time_top", "rows": _import_top()}), flush=True)
    here = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory(prefix="rank_start_") as work:
        argv = ["--preset", "imagenet224-dp8", "--distributed", "--dist-backend", "gloo",
                "--device", "cuda:0", "--batch-size", "16", "--steps", str(steps),
                "--checkpoint-every", str(steps), "--log-every", "1", "--prefetch", "0",
                "--checkpoint-dir", os.path.join(work, "ckpt"),
                "--metrics-file", os.path.join(work, "m.jsonl")]
        env = dict(os.environ, RANK_START_T0=repr(time.time()))
        t1 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                              "--nproc-per-node", "2", "--monitor-interval", "0.1", here,
                              "--rank", work, *argv], env=env, capture_output=True, text=True,
                             timeout=900)
        wall = time.perf_counter() - t1
        ranks = []
        for r in (0, 1):
            path = os.path.join(work, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as fh:
                    ranks.append(json.load(fh))
        print(json.dumps({"phase": "torchrun_2_ranks", "rc": res.returncode, "wall_s": wall,
                          "steps": steps, "nvidia_smi": smi, "ranks": ranks,
                          "stderr_tail": None if res.returncode == 0 else res.stderr[-3000:]}),
              flush=True)
    return 0 if res.returncode == 0 and len(ranks) == 2 else 1


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--rank":
        sys.exit(_rank(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
