"""BENCHMARK.json against the benchmark contract's shapes, and the harness
finding every cell's files by name (a file added under each folder is
picked up with no edit)."""

import json
import re
import shutil

import pytest

from portbench import harness

BENCH = json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_portbench_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert all(LINE.match(w) for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_portbench_names_units_and_lines(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end" and section != "per_layer":
                assert LINE.match(e[key]), e[key]
        if section == "per_layer":
            assert LINE.match(e["layer"])
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        if section == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0 < e["bound"] <= 0.25


def test_portbench_metric_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for c in m["workloads"]:
            assert c in cells
            assert c in e2e[m["moves"]].get("workloads", [c])
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    for c in cells:
        reported = [m for m in BENCH["end_to_end"]
                    if c in m.get("workloads", [c])]
        assert len(reported) >= 2
        assert any(c in m["workloads"] for m in BENCH["per_layer"])
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_portbench_every_cell_finds_its_files(name):
    c = harness.Cell(name)
    assert c.config["n_levels"] == 16 and c.config["log2_hashmap_size"] == 19
    assert c.driver().run
    assert isinstance(c.limits, dict)
    for m in c.per_layer:
        assert callable(harness.reader(m["name"]))
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2


def test_portbench_config_files_hold_their_sources():
    for conf in BENCH["configs"]:
        assert conf["file"].startswith("portbench/configs/")
        body = json.loads((harness.CHECKOUT / conf["file"]).read_text())
        for key in conf["reduced"]:
            assert NAME.match(key) and key in body


def test_portbench_new_files_are_found_without_an_edit(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric as new files and entries alone."""
    root = tmp_path / "portbench"
    shutil.copytree(harness.HERE, root,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    conf = json.loads((root / "configs" / "ngp_synthetic.json").read_text())
    conf["log2_hashmap_size"] = 21
    (root / "configs" / "ngp_big_table.json").write_text(json.dumps(conf))
    traffic = json.loads((root / "traffic" / "train.json").read_text())
    traffic["trace_blocks"] = 8
    (root / "traffic" / "train_long_trace.json").write_text(
        json.dumps(traffic))
    (root / "workloads" / "big_table_train.json").write_text(
        json.dumps({"limits": {"timed.loss_gap": 0.5}}))
    (root / "metrics" / "train.adam_ms.py").write_text(
        "def read(t):\n    ms = t.span_ms('adam')\n"
        "    return None if ms is None else ms / t.units\n")
    bench["configs"].append({"name": "ngp_big_table", "source": "x",
                             "file": "portbench/configs/ngp_big_table.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "big_table_train",
                               "config": "ngp_big_table",
                               "traffic": "train_long_trace", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_ms_per_step":
            m["workloads"].append("big_table_train")
    bench["per_layer"].append({"name": "train.adam_ms", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "optimiser (training/trainer.Adam)",
                               "moves": "train_ms_per_step",
                               "workloads": ["big_table_train"]})
    c = harness.Cell("big_table_train", bench=bench, root=root)
    assert c.config["log2_hashmap_size"] == 21
    assert c.traffic["trace_blocks"] == 8
    assert c.limits == {"timed.loss_gap": 0.5}
    assert "train.adam_ms" in [m["name"] for m in c.per_layer]
    assert "train_ms_per_step" in [m["name"] for m in c.end_to_end]

    class T:
        units = 4

        @staticmethod
        def span_ms(name):
            return 8.0 if name == "adam" else None
    assert harness.reader("train.adam_ms", root)(T) == 2.0


def test_portbench_verdict_needs_every_limit():
    rows, ok = harness.verdict({"a": 1.0, "b": 2.0}, {"a": 1.5, "b": 2.5})
    assert ok and rows == [("a", 1.0, 1.5), ("b", 2.0, 2.5)]
    assert not harness.verdict({"a": 1.0}, {})[1]
    assert not harness.verdict({"a": float("nan")}, {"a": 1.0})[1]
    assert not harness.verdict({"a": 2.0}, {"a": 1.0})[1]
    assert not harness.verdict({}, {})[1]
