"""The harness: finds a cell's configuration, workload and drivers by name,
runs it, reads its metrics, checks that no JAX module was loaded, and
prints the result.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` names the cell's metrics. A cell's configuration is
``benchmark/configs/<config>.json``, its traffic and limits
``benchmark/workloads/<cell>.json``, whose ``driver`` names
``benchmark/traffic/<driver>.py``; each per-layer metric is read by
``benchmark/metrics/<metric>.py``. Adding a cell, a configuration or a
metric adds files and entries and edits none."""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from .spans import Spans

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "benchmark"
METRICS_DIR = BENCH_DIR / "metrics"
JAX_PACKAGE = "robust_speech_emotion_recognition_via_dynamic_asymmetric_distillation_in_noisy_environments_tpu"
PORT_PACKAGE = JAX_PACKAGE + "_torch"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", JAX_PACKAGE})
# build and kernel caches at fixed paths inside the checkout (the port's
# nvcc libraries build into its own csrc/build/, also inside the checkout)
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCHINDUCTOR_CACHE_DIR": "inductor",
              "TORCH_EXTENSIONS_DIR": "torch_extensions"}


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


@dataclass
class Context:
    """What a driver gets, and what it leaves for the metric readers."""

    name: str
    cell: dict  # the BENCHMARK.json workload entry
    workload: dict  # benchmark/workloads/<cell>.json
    config: dict  # benchmark/configs/<config>.json
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float  # time.monotonic() when the run began
    spans: Spans = field(default_factory=Spans)
    counters: Dict[str, float] = field(default_factory=dict)
    trace_data: Any = None  # lib.trace.TraceData of the traced stretch


@dataclass
class Outcome:
    """What a driver returns: its end-to-end readings, the requests or
    steps attempted and failed, each number compared with its limit, and
    the peak device memory read once the window closed."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Tuple[str, float, float]]
    memory_peak_bytes: int
    window_start: float


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared whole (the port's name begins with the JAX
    package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def set_cache_dirs() -> None:
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(BENCH_DIR / ".cache" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def cell_metrics(bench: dict, name: str) -> Tuple[List[dict], List[dict]]:
    """The cell's end-to-end and per-layer metric entries of BENCHMARK.json."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if ((name in m["workloads"]) if "workloads" in m else (m["moves"] in names))]
    return e2e, per


def load_reader(metric: str):
    path = METRICS_DIR / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(driver: str):
    return importlib.import_module(f"benchmark.traffic.{driver}")


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, bench: Optional[dict] = None,
             config: Optional[dict] = None, workload: Optional[dict] = None) -> dict:
    """Runs one cell and returns its result object. ``config`` and
    ``workload`` replace the files (the CPU tests run tiny ones); on
    ``cuda`` the cards the cell asks for must be there."""
    t_start = time.monotonic() if t_start is None else t_start
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = workload or load_json(BENCH_DIR / "workloads" / f"{name}.json")
    config = config or load_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    import torch

    if device.startswith("cuda"):
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise NoDevice(f"cell {name} needs {cell['chips']} CUDA device(s); "
                           f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    ctx = Context(name, cell, workload, config, seed, seconds, trace, device, t_start)
    out: Outcome = load_driver(workload["driver"]).run(ctx)
    e2e, per = cell_metrics(bench, name)
    metrics = {}
    if trace:
        for m in per:
            v = load_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": out.e2e[m["name"]], "unit": m["unit"]}
    correct = out.failed == 0 and all(v <= lim for _n, v, lim in out.checks)
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": torch.cuda.get_device_name() if device.startswith("cuda") else "cpu",
           "count": cell["chips"], "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if trace and ctx.trace_data is not None:
        td = ctx.trace_data
        dev["busy_s"] = td.busy_s
        dev["window_s"] = td.window_s
        result["breakdown"] = {"device_ops": td.top_ops(10),
                               "idle_gaps": td.idle_by_span(ctx.spans, 10)}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in out.checks}
    # last, once the driver and every metric reader have run: whatever the
    # process loaded by then is in sys.modules
    found = forbidden_modules()
    if found:
        raise ImportError(f"modules of JAX or the JAX package were loaded: {found}")
    return result


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return 1e300 if x > 0 else -1e300
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(argv=None, t_start: Optional[float] = None, **cell) -> int:
    """The command line. ``cell``: ``run_cell``'s keyword arguments
    (``device``, ``config``, ``workload``: the CPU tests run tiny cells)."""
    p = argparse.ArgumentParser(description="run one cell of the port's benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_dirs()
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=t_start, **cell)
    except NoDevice as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    except ImportError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0
