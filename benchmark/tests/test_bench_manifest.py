"""BENCHMARK.json against its schema, and every file it
names found by name."""
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def committed():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture(params=["committed", "with_frames"])
def m(request):
    """BENCHMARK.json, and as the frame cell added as data would make it."""
    if request.param == "committed":
        return committed()
    from benchmark.tests.frame_cell import manifest_with_frames

    return manifest_with_frames(committed())


def cells_reporting(m, metric):
    cells = [w["name"] for w in m["workloads"]]
    return metric.get("workloads", cells)


def test_keys_are_exactly_the_schemas(m):
    assert set(m) == TOP
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines_use_the_allowed_characters(m):
    names = []
    for c in m["configs"]:
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        assert LINE.match(c["why"]) and LINE.match(c["source"])
    for w in m["workloads"]:
        names.append(w["name"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"])
    for e in m["end_to_end"] + m["per_layer"]:
        names.append(e["name"])
        assert UNIT.match(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher")
        assert e["source"] in SOURCES
    for p in m["per_layer"]:
        assert LINE.match(p["layer"])
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads"):
        ns = [x["name"] for x in m[group]]
        assert len(ns) == len(set(ns))
    metric_names = [e["name"] for e in m["end_to_end"] + m["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    assert all(LINE.match(w) for w in m["command"])


def test_moves_names_an_end_to_end_metric_of_every_cell_reporting_it(m):
    e2e = {e["name"]: e for e in m["end_to_end"]}
    for p in m["per_layer"]:
        assert p["moves"] in e2e, p["name"]
        for cell in cells_reporting(m, p):
            assert cell in cells_reporting(m, e2e[p["moves"]]), (
                p["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(m):
    for w in m["workloads"]:
        e2e = [e["name"] for e in m["end_to_end"]
               if w["name"] in cells_reporting(m, e)]
        layers = [p["name"] for p in m["per_layer"]
                  if w["name"] in cells_reporting(m, p)]
        assert "setup_s" in e2e and len(e2e) >= 2 and layers, w["name"]
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")


def test_bounds_run_seconds_and_the_checks_budget(m):
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25, e["name"]
    assert [e["bound"] for e in m["end_to_end"]
            if e["name"] == "setup_s"] == [0.25]
    s = m["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_cells_configs_and_chips(m):
    configs = {c["name"] for c in m["configs"]}
    assert 1 <= len(m["workloads"]) <= 24 and 1 <= len(configs) <= 24
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in m["workloads"]} == configs
    assert all(w["chips"] in (1, 4) for w in m["workloads"])
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert four <= max(1, len(m["workloads"]) // 4)


def test_paths_and_command_stay_inside_the_benchmark(m):
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(m["command"]) <= 32
    for word in m["command"][1:]:
        if "/" in word or word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in m["paths"]), word
            assert os.path.exists(os.path.join(ROOT, word))


@pytest.mark.parametrize("sub,key", [("configs", "config"),
                                     ("workloads", "traffic"),
                                     ("limits", "name")])
def test_each_cell_finds_its_data_by_name(sub, key, m):
    for w in m["workloads"]:
        path = os.path.join(ROOT, "benchmark", sub, w[key] + ".json")
        with open(path) as f:
            json.load(f)
    for c in m["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"


def test_each_traffic_kind_and_metric_has_its_module(m):
    for w in m["workloads"]:
        with open(os.path.join(ROOT, "benchmark", "workloads",
                               w["traffic"] + ".json")) as f:
            kind = json.load(f)["kind"]
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic",
                                           kind + ".py"))
    for p in m["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           p["name"] + ".py")), p["name"]


def test_shares_of_a_peak_are_percentages_named_as_such(m):
    for p in m["per_layer"]:
        if "roofline" in p["name"] or "mfu" in p["name"]:
            assert p["unit"] == "%" and p["better"] == "higher", p["name"]
    mfu = [p for p in m["per_layer"] if "mfu" in p["name"]]
    rooflines = [p for p in m["per_layer"] if "_roofline" in p["name"]]
    # a kernel's roofline stands beside the whole step's share of the peak
    for r in rooflines:
        assert any(x["moves"] == r["moves"] and set(r.get("workloads", []))
                   <= set(x.get("workloads", [])) for x in mfu), r["name"]
