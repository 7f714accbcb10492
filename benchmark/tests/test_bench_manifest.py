"""BENCHMARK.json and the files it names: the keys, the character sets,
and every name resolving to a file of its own."""

import json
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/") for p in MAN["paths"])
    for word in MAN["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MAN["paths"])


def test_run_seconds_fit_the_check_with_24_cells():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    names = [c["name"] for c in MAN["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert all(NAME.match(n) for n in names)
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        assert len({e["name"] for e in group}) == len(group)
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_every_name_resolves_to_its_files():
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = harness.load_json("configs", c["name"] + ".json")
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert (harness.BENCH / "programs" / f"{cfg['program']}.py").exists()
        assert (harness.BENCH / "reference" / f"{c['name']}.py").exists()
    for w in MAN["workloads"]:
        mix = harness.load_json("mixes", w["traffic"] + ".json")
        assert (harness.BENCH / "drivers" / f"{mix['driver']}.py").exists()
    for m in METRICS:
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_has_set_limits(cell):
    checks = harness.load_json("workloads", cell + ".json")["checks"]
    assert checks
    for name, c in checks.items():
        assert isinstance(c["limit"], (int, float)), (name, c)
        assert c["lower_reading"] < c["limit"] < c["upper_reading"], (name, c)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_e2e_and_a_per_layer_metric(cell):
    e2e = {m["name"] for m in harness.metrics_of(MAN, cell, False)}
    layer = harness.metrics_of(MAN, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])


def test_per_layer_metrics_move_an_end_to_end_metric_in_each_of_their_cells():
    for m in MAN["per_layer"]:
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert m["moves"] in {e["name"] for e in harness.metrics_of(MAN, cell, False)}


def test_roofline_and_mfu_names():
    for m in MAN["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"


def test_manifest_is_plain_json():
    json.loads((harness.ROOT / "BENCHMARK.json").read_text())
