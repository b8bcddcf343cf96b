"""BENCHMARK.json keeps to its contract, and every file it implies exists."""

import json
import re

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _data():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_shape_names_and_units():
    b = _data()
    assert set(b) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])
    names = ([c["name"] for c in b["configs"]]
             + [w["name"] for w in b["workloads"]]
             + [m["name"] for m in b["end_to_end"] + b["per_layer"]])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


def test_every_cell_finds_its_files():
    b = _data()
    configs = {c["name"]: c for c in b["configs"]}
    used = set()
    for w in b["workloads"]:
        c = configs[w["config"]]
        used.add(c["name"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (BENCH / "models" / f"{cfg['family']}.py").is_file()
        assert (BENCH / "graph_kinds"
                / f"{cfg['graph']['kind']}.py").is_file()
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                             .read_text())
        assert (BENCH / "entries" / f"{traffic['entry']}.py").is_file()
        limits = json.loads((BENCH / "checks" / f"{w['name']}.json")
                            .read_text())
        assert limits and all(v > 0 for v in limits.values())
    assert used == set(configs)
    assert len({c["file"] for c in b["configs"]}) == len(configs)
    for m in b["per_layer"]:
        quantity = m["name"].split(".")[0]
        assert (BENCH / "metrics" / f"{quantity}.py").is_file()
    for c in b["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))


def test_metrics_cover_every_cell_and_move_what_it_reports():
    b = _data()
    cells = [w["name"] for w in b["workloads"]]
    e2e = {m["name"]: m for m in b["end_to_end"]}

    def reports(metric, cell):
        return cell in metric.get("workloads", cells)

    layers = {}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    assert "setup_s" in e2e
    for cell in cells:
        got = [n for n, m in e2e.items() if reports(m, cell)]
        assert "setup_s" in got and len(got) >= 2
        assert any(reports(m, cell) for m in b["per_layer"])
    for m in b["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_each_cell_has_a_config_and_traffic_that_load(manifest):
    """Each cell's entry belongs to its configuration's family, drives one
    of the two loops, and names controls."""
    for w in manifest.data["workloads"]:
        cfg = manifest.config(w)
        traffic = manifest.traffic(w)
        entry = manifest.entry(traffic)
        assert entry.LOOP in ("serve", "train")
        assert callable(entry.session)
        assert f"models import {cfg['family']} " in (
            BENCH / "entries" / f"{traffic['entry']}.py").read_text()
        assert traffic["controls"]


def test_every_piece_is_found_by_its_name():
    """Each file of a piece kind is found by the name it carries, and the
    harness reads no other: a new one is a new file."""
    from harness import found

    for kind in ("graph_kinds", "entries", "metrics", "datasets"):
        files = sorted((BENCH / kind).glob("*.py"))
        assert files, kind
    for f in (BENCH / "graph_kinds").glob("*.py"):
        assert callable(found._piece("graph_kinds", f.stem).make)
    for f in (BENCH / "entries").glob("*.py"):
        assert found.entry(f.stem).LOOP in ("serve", "train")
    for f in (BENCH / "metrics").glob("*.py"):
        assert found.reader(f"{f.stem}.anything").read
