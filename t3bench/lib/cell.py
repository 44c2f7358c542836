"""Find a cell's parts by name: its workload file, its configuration, its
request loop, the readers of its metrics and the rooflines of the kernels."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
CELL_KEYS = {"config", "traffic", "loop", "chips", "why", "params"}


class CellError(ValueError):
    """A cell, configuration, request loop or metric that cannot be found or
    does not hold what the harness needs."""


def _json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise CellError(f"no such file: {path}") from None


def _name(name: str) -> str:
    if not NAME.match(name):
        raise CellError(f"not a valid name: {name!r}")
    return name


def load_cell(bench_dir: str, name: str) -> dict:
    """``workloads/<name>.json``: its config, traffic, loop, chips, why
    and the traffic's parameters (``params``)."""
    cell = _json(os.path.join(bench_dir, "workloads", _name(name) + ".json"))
    missing = CELL_KEYS - set(cell)
    if missing:
        raise CellError(f"workload {name}: missing {sorted(missing)}")
    return cell


def load_config(bench_dir: str, name: str) -> dict:
    return _json(os.path.join(bench_dir, "configs", _name(name) + ".json"))


def _module(path: str, modname: str):
    if not os.path.exists(path):
        raise CellError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_loop(bench_dir: str, name: str):
    return _module(os.path.join(bench_dir, "loops", _name(name) + ".py"),
                   f"t3bench_loop_{name}")


def load_reader(bench_dir: str, metric: str):
    mod = _module(os.path.join(bench_dir, "metrics", _name(metric) + ".py"),
                  "t3bench_metric_" + metric.replace(".", "_"))
    if not callable(getattr(mod, "read", None)):
        raise CellError(f"metrics/{metric}.py has no read(ctx)")
    return mod


def load_rooflines(bench_dir: str) -> dict:
    """Every ``rooflines/<kernel>.json`` by kernel name."""
    d = os.path.join(bench_dir, "rooflines")
    return {f[:-5]: _json(os.path.join(d, f))
            for f in sorted(os.listdir(d)) if f.endswith(".json")}


def load_peaks(bench_dir: str) -> dict:
    return _json(os.path.join(bench_dir, "peaks.json"))


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    layer: str | None


def metric_plan(benchmark: dict, cell: str):
    """(end-to-end, per-layer) metrics that ``cell`` reports: an entry with
    ``workloads`` where it lists the cell; an end-to-end one without, in
    every cell; a per-layer one without, wherever the end-to-end metric it
    moves is reported."""
    def applies(m):
        return cell in m["workloads"] if "workloads" in m else None
    e2e = [m for m in benchmark["end_to_end"] if applies(m) is not False]
    names = {m["name"] for m in e2e}
    per = [m for m in benchmark["per_layer"]
           if applies(m) or ("workloads" not in m and m["moves"] in names)]
    return ([Metric(m["name"], m["unit"], None) for m in e2e],
            [Metric(m["name"], m["unit"], m["layer"]) for m in per])
