"""A later change adds a cell with files and entries only: a configuration,
a traffic mix, a driver and a metric reader placed in another checkout are
found by the names in its BENCHMARK.json."""

import json

from pbench import spec


def test_files_added_in_a_new_checkout_are_found_by_name(tmp_path):
    bench = tmp_path / "portbench"
    for d in ("configs", "traffic", "drivers", "metrics"):
        (bench / d).mkdir(parents=True)
    (bench / "configs" / "cfg-x.json").write_text(json.dumps({"shards": 8}))
    (bench / "traffic" / "mix-y.json").write_text(json.dumps({"driver": "drv_z", "rate": 3}))
    (bench / "drivers" / "drv_z.py").write_text("def setup(cell, seed, device):\n    return seed\n")
    (bench / "metrics" / "m.q.py").write_text("def read(run):\n    return run.get('q')\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "cfg-x", "file": "portbench/configs/cfg-x.json"}],
        "workloads": [{"name": "cell-1", "config": "cfg-x", "traffic": "mix-y", "chips": 1}],
        "end_to_end": [{"name": "rate_x", "unit": "ops/s"}, {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "m.q", "unit": "%", "moves": "rate_x", "workloads": ["cell-1"]},
                      {"name": "other", "unit": "%", "moves": "rate_x",
                       "workloads": ["cell-2"]}],
    }))
    cell = spec.resolve(spec.load_benchmark(tmp_path), "cell-1", root=tmp_path, here=bench)
    assert cell.config == {"shards": 8} and cell.traffic["rate"] == 3
    assert [m["name"] for m in cell.per_layer] == ["m.q"]
    assert spec.driver(cell.traffic["driver"], here=bench).setup(cell, 7, None) == 7
    assert spec.read_metrics(cell, {"q": 2.5}, here=bench) == {"m.q": {"value": 2.5, "unit": "%"}}
    assert spec.read_metrics(cell, {}, here=bench) == {}  # a reader that finds nothing


def test_every_metric_and_traffic_of_the_benchmark_has_its_file():
    b = spec.load_benchmark()
    for m in b["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    for w in b["workloads"]:
        cell = spec.resolve(b, w["name"])
        drv = spec.driver(cell.traffic["driver"])
        assert all(callable(getattr(drv, f)) for f in ("setup", "window", "check", "control"))
