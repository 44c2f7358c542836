"""The runner finds a cell, a metric and a roofline by name: each added as
files alone is picked up with no change to the code."""
import json
import os
import time

import pytest
import torch

from t3bench.lib import runner
from t3bench.tests import tiny

CPU = torch.device("cpu")


def run(bd, bench, name, trace=False, control=False, seed=2 ** 31 + 7):
    return runner.run_cell(bd, bench, name, seed, 0.3, trace, CPU,
                           time.perf_counter(), control=control)


@pytest.mark.parametrize("name", tiny.CELLS)
def test_cell_runs_correct_on_cpu(tmp_path, name):
    bd = tiny.copy(tmp_path)
    out = run(bd, tiny.benchmark(), name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    own = {"p2_8k_luma.rt_clean": ".rt", "p2_8k_luma.sfdp4_rt": ".sfdp"}
    sfx = own.get(name, "")
    assert {"fps" + sfx, "latency_ms_p95" + sfx, "setup_s"} \
        <= set(out["metrics"])
    assert list(out)[-1] == "checks"


def test_added_workload_file_runs(tmp_path):
    bd = tiny.copy(tmp_path)
    with open(os.path.join(bd, "workloads", "p2_8k_luma.rx_dirty5.json")) \
            as f:
        cell = json.load(f)
    cell["traffic"] = "rx_dirty2_small"
    cell["params"].update(frames_per_request=2, groups=1, repair_cap=4)
    with open(os.path.join(bd, "workloads", "p2_8k_luma.rx_small.json"),
              "w") as f:
        json.dump(cell, f)
    bench = tiny.benchmark()
    for m in bench["end_to_end"]:
        if m["name"] == "fps":
            m["workloads"].append("p2_8k_luma.rx_small")
    out = run(bd, bench, "p2_8k_luma.rx_small")
    assert out["correct"], out["checks"]
    assert out["metrics"]["fps"]["value"] > 0
    assert "latency_ms_p95" not in out["metrics"]


def test_added_metric_and_roofline_files_are_read(tmp_path):
    bd = tiny.copy(tmp_path)
    bench = tiny.benchmark()
    bench["per_layer"].append(
        {"name": "requests_ms.any", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "device", "moves": "fps"})
    with open(os.path.join(bd, "metrics", "requests_ms.any.py"), "w") as f:
        f.write("def read(ctx):\n"
                "    ms = ctx.spans['request']\n"
                "    return sum(ms) / len(ms)\n")
    with open(os.path.join(bd, "rooflines", "grid_check.json"), "w") as f:
        json.dump({"kernel": "grid check", "name_pattern": "grid",
                   "call": "ternary_image_codec_tpu_torch.ops.pipeline:"
                           "grid_check", "bytes": "tensors",
                   "peak": "hbm_bytes_per_s"}, f)
    out = run(bd, bench, "p5_8k_beacon.rx_dirty1", trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["requests_ms.any"]["value"] > 0
    assert "busy_s" in out["device"] and "breakdown" in out


def test_trace_run_restores_the_program(tmp_path):
    from ternary_image_codec_tpu_torch.ops import dec_cuda, rs_cuda
    before = (dec_cuda.check_decode, rs_cuda.rs_correct)
    bd = tiny.copy(tmp_path)
    out = run(bd, tiny.benchmark(), "p2_8k_luma.rt_clean", trace=True)
    assert out["correct"]
    assert {"encode_ms.rt", "decode_ms.rt"} == set(out["metrics"])
    assert (dec_cuda.check_decode, rs_cuda.rs_correct) == before


def test_no_chip_exits_without_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = runner.main(["--workload", tiny.CELLS[0], "--seed", "1",
                      "--seconds", "1", "--trace", "0"], 0.0, tiny.ROOT)
    assert rc != 0 and capsys.readouterr().out == ""
