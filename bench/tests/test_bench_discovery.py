"""A configuration, a mix and a per-layer metric added as new files (and
entries in ``BENCHMARK.json``) in a copy of the benchmark are found by
name and run, with no file of the harness edited."""

import json
import shutil
import time

from bench import harness, spec


def test_new_files_are_found(tiny, tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(tiny, bench)
    cfg = json.loads((bench / "configs" / "mixtral-8x7b-l16.json").read_text())
    cfg["name"] = "newmodel"
    (bench / "configs" / "newmodel.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "tiny.json").read_text())
    mix["clients"] = 3
    (bench / "traffic" / "newmix.json").write_text(json.dumps(mix))
    (bench / "metrics" / "new_metric.py").write_text(
        "def read(record):\n    return 42.0\n")
    (bench / "checks" / "newmodel.newmix.json").write_text(
        json.dumps({"logit_gap": {"limit": 1.0}}))
    s = json.loads((tiny.parent / "BENCHMARK.json").read_text())
    s["workloads"].append({"name": "newmodel.newmix", "config": "newmodel",
                           "traffic": "newmix", "chips": 1, "why": "x"})
    s["per_layer"].append({"name": "new_metric", "unit": "ms",
                           "better": "lower", "source": "host_clock",
                           "layer": "x", "moves": "output_tok_s",
                           "workloads": ["newmodel.newmix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))

    cell = spec.load_cell("newmodel.newmix", bench)
    assert cell["config"]["name"] == "newmodel"
    assert cell["mix"]["clients"] == 3
    assert "new_metric" in [m["name"] for m in cell["per_layer"]]
    assert "new_metric" not in [
        m["name"] for m in spec.load_cell("mixtral-8x7b-l16.tiny",
                                          bench)["per_layer"]]
    assert spec.read_metrics([{"name": "new_metric", "unit": "ms"}], {},
                             bench) == {"new_metric": {"value": 42.0,
                                                       "unit": "ms"}}
    r = harness.run("newmodel.newmix", 5, 3.0, False, time.monotonic(),
                    device="cpu", bench=bench)
    assert r["correct"] and r["attempted"] > 0
    assert set(r["metrics"]) == {m["name"] for m in s["end_to_end"]
                                 if "workloads" not in m}
