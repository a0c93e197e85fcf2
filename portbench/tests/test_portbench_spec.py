"""BENCHMARK.json against the contract's character rules, and a cell
found by name from files alone."""

import json
import re

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())


def test_names_and_units_within_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"])) == len(
        BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and len(m["unit"]) <= 16, m
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["configs"] + BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_file_a_cell_names_is_there_and_loads():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"] and cell.traffic["name"] == w["traffic"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
    for c in BENCH["configs"]:
        conf = json.loads((spec.ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]


def test_a_cell_added_as_files_alone(tmp_path):
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    (tmp_path / "portbench" / "traffic").mkdir(parents=True)
    conf = json.loads((spec.HERE / "configs" / "nt1-512m.json").read_text())
    conf["name"] = "new-conf"
    (tmp_path / "portbench" / "configs" / "new-conf.json").write_text(json.dumps(conf))
    mix = json.loads((spec.HERE / "traffic" / "community.json").read_text())
    mix["name"] = "newmix"
    (tmp_path / "portbench" / "traffic" / "newmix.json").write_text(json.dumps(mix))
    bench = dict(BENCH)
    bench["configs"] = BENCH["configs"] + [
        {"name": "new-conf", "source": "x", "file": "portbench/configs/new-conf.json",
         "reduced": [], "why": "x"}]
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "new.cell", "config": "new-conf", "traffic": "newmix", "chips": 1, "why": "x"}]
    bench["end_to_end"] = BENCH["end_to_end"] + [
        {"name": "only_new", "unit": "s", "better": "lower", "bound": 0.1,
         "source": "host_clock", "workloads": ["new.cell"]}]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    cell = spec.load_cell("new.cell", path, tmp_path)
    assert cell.config["name"] == "new-conf" and cell.traffic["name"] == "newmix"
    names = {m["name"] for m in cell.end_to_end}
    assert "only_new" in names and "batch_p90_ms" not in names
    with pytest.raises(KeyError):
        spec.load_cell("missing.cell", path, tmp_path)
