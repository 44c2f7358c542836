"""The benchmark's files hold together: every cell of BENCHMARK.json has its
workload file, configuration, request loop and metric readers, under names and
units the benchmark's contract allows."""
import json
import os
import re

import pytest

from t3bench.lib import cell as cells
from t3bench.tests.tiny import BENCH, ROOT, benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_names_and_units():
    b = benchmark()
    items = b["configs"] + b["workloads"] + b["end_to_end"] + b["per_layer"]
    for it in items:
        assert NAME.match(it["name"]), it["name"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in b["configs"]:
        assert len(c["source"]) <= 200
        for k in c["reduced"]:
            assert NAME.match(k)


ENTRY_KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"},),
    "workloads": ({"name", "config", "traffic", "chips", "why"},),
    "end_to_end": ({"name", "unit", "better", "bound", "source"},
                   {"name", "unit", "better", "bound", "source",
                    "workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"},
                  {"name", "unit", "better", "source", "layer", "moves",
                   "workloads"}),
}


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entry_keys(section):
    """Each entry has just the keys the contract gives its section, and
    each line of text fits one line of 1 to 200 characters."""
    b = benchmark()
    assert set(b) == {"command", "paths", "run_seconds", *ENTRY_KEYS}
    for it in b[section]:
        assert set(it) in [set(k) for k in ENTRY_KEYS[section]], it["name"]
        for key in ("why", "layer", "source"):
            if isinstance(it.get(key), str):
                text = it[key]
                assert 1 <= len(text) <= 200, (it["name"], key)
                assert "\n" not in text and "\t" not in text


@pytest.mark.parametrize("w", benchmark()["workloads"],
                         ids=lambda w: w["name"])
def test_cell_files(w):
    cell = cells.load_cell(BENCH, w["name"])
    for key in ("config", "traffic", "chips", "why"):
        assert cell[key] == w[key], key
    cells.load_config(BENCH, cell["config"])
    assert os.path.exists(os.path.join(BENCH, "loops",
                                       cell["loop"] + ".py"))
    e2e, per = cells.metric_plan(benchmark(), w["name"])
    assert "setup_s" in [m.name for m in e2e] and len(e2e) >= 2
    assert per
    for m in e2e + per:
        cells.load_reader(BENCH, m.name)


def test_configs_listed_by_file():
    b = benchmark()
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert c["file"] == f"t3bench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]


def test_rooflines_name_a_kernel_entry_point():
    for name, rf in cells.load_rooflines(BENCH).items():
        assert rf["peak"] in cells.load_peaks(BENCH)
        mod, attr = rf["call"].split(":")
        assert mod.startswith("ternary_image_codec_tpu_torch.") and attr
