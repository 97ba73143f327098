"""What every cell shares: finding its pieces by name, the device's
description, the check of loaded modules, and the result line.

A cell (`workloads` entry of BENCHMARK.json) names a configuration and a
traffic mix. Each piece is a file found by its name:
  configs/<config>.json   the configuration as run (its `config` keys go
                          to the port's Config) and its precision;
  traffic/<traffic>.json  the mix: its `kind` (the cell module
                          benchmark/<kind>_cell.py) and its parameters;
  limits/<workload>.json  the limit of each number the check compares;
  metrics/<metric>.py     one reader per per-layer metric: read(ctx) ->
                          a number, or None where it finds nothing.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "benerf_tpu")


def load_json(path) -> Any:
    with open(path) as f:
        return json.load(f)


def spec(root=ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_file(bench: dict, name: str) -> Path:
    for c in bench["configs"]:
        if c["name"] == name:
            return ROOT / c["file"]
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(name: str) -> dict:
    return load_json(HERE / "limits" / f"{name}.json")


def cell_module(kind: str):
    return importlib.import_module(f"benchmark.{kind}_cell")


def metric_names(bench: dict, cell: str, kind: str) -> list:
    """The cell's metrics of a kind ("end_to_end" or "per_layer"): those
    whose `workloads` list it, or that have none."""
    return [m["name"] for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str):
    """The read(ctx) function of benchmark/metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Context:
    """What a per-layer reader may read: the cell, its program objects and
    the traces the run took."""

    workload: str
    conf: dict                      # the configuration file
    cfg: Any                        # the port's Config as run
    device: Any
    chips: int
    e2e: dict = field(default_factory=dict)      # end-to-end values
    profile: Optional[Any] = None    # tracing.Profile of the traced window
    steps: int = 1                   # steps (or frames) in that window
    objects: dict = field(default_factory=dict)  # state, batch, params, ...

    @property
    def precision(self) -> str:
        return self.conf["precision"]


def unit_of(bench: dict, name: str) -> str:
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if m["name"] == name:
                return m["unit"]
    raise KeyError(name)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi: not available"


def device_entry(torch, count: int, peak_bytes: int, profile=None) -> dict:
    d = {"platform": "gpu" if torch.cuda.is_available() else "cpu",
         "kind": (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                  else "cpu"),
         "count": count, "memory_peak_bytes": int(peak_bytes)}
    if profile is not None:
        d["busy_s"] = profile["busy_s"]
        d["window_s"] = profile["window_s"]
    return d


def finish(result: dict, checks: dict) -> int:
    """Print each compared number beside its limit as the last lines of
    standard error, and the result line, with the checks last, as the last
    line of standard output. Refuses (exit 3, no line) when JAX or the JAX
    package is loaded."""
    bad = loaded_forbidden()
    if bad:
        print(f"refused: the process has loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    result = dict(result, checks=checks)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def compare(numbers: dict, lim: dict) -> tuple:
    """(all within their limits, {name: {value, limit}}); a number that is
    not finite fails."""
    import math

    checks = {k: {"value": v, "limit": lim[k]} for k, v in numbers.items()}
    ok = all(math.isfinite(v) and v <= lim[k] for k, v in numbers.items())
    return ok, checks
