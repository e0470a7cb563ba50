"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, the run length's budget, and every cell resolving by name to its
configuration, traffic, readers and kernel counts."""

import json
import math
import re

import pytest

from harness import manifest

ROOT = manifest.ROOT
M = manifest.load_manifest(ROOT)
CELLS = [w["name"] for w in M["workloads"]]
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_size():
    assert set(M) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert M["command"] == ["python3", "benchmark/run.py"] and len(M["command"]) <= 32
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_the_contract_keys(section):
    for entry in M[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(entry) <= KEYS[section] | extra, entry["name"]


@pytest.mark.parametrize("section", sorted(KEYS))
def test_names_and_units(section):
    names = [e["name"] for e in M[section]]
    assert len(names) == len(set(names))
    for entry in M[section]:
        assert manifest.NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert manifest.UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in entry:
                assert LINE.match(entry[key]), (entry["name"], key)


def test_metric_sources_and_bounds():
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in names
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in names
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs_and_cells_pair_up():
    configs = {c["name"]: c for c in M["configs"]}
    used = {w["config"] for w in M["workloads"]}
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert any(c["file"].startswith(p + "/") for p in M["paths"])
        assert len(c["reduced"]) <= 16 and all(manifest.NAME.match(k) for k in c["reduced"])
        spec = manifest.load_json(ROOT / c["file"])
        assert sorted(spec["reduced"]) == sorted(c["reduced"])
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(M["workloads"]) // 4)
    assert all(w["chips"] in (1, 4) for w in M["workloads"])


def test_run_seconds_fits_the_check_with_24_cells():
    rs = M["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    ctx = manifest.resolve(M, cell, ROOT)
    assert ctx.traffic["why"] == ctx.entry["why"]
    assert ctx.spec["name"] == ctx.config["name"]
    manifest.reference(ctx.spec["reference"])
    reported = {m["name"] for m in ctx.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and ctx.per_layer
    for m in ctx.per_layer:
        reader = manifest.reader(m["name"], ROOT)
        assert callable(reader.read)
    for m in M["per_layer"] + M["end_to_end"]:
        for w in m.get("workloads", []):
            assert w in CELLS


def test_every_per_layer_metric_has_a_reader_and_every_reader_a_metric():
    readers = {p.stem for p in (ROOT / "benchmark" / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in M["per_layer"]}


def test_whys_and_limits_of_cells():
    for w in M["workloads"]:
        traffic = manifest.load_json(ROOT / "benchmark" / "cells" / f"{w['name']}.json")
        assert set(traffic["limits"]) == {"grad1", "change"}
        assert all(v > 0 and math.isfinite(v) for v in traffic["limits"].values())
        json.dumps(traffic)


def test_a_new_kind_of_labels_is_a_new_file(tmp_path):
    """A cell whose labels are of a kind no file has yet (masks, say) needs
    one new file under ``traffic/`` and no other edit."""
    import shutil

    import torch

    from harness import inputs

    shutil.copytree(ROOT / "benchmark" / "traffic", tmp_path / "benchmark" / "traffic")
    (tmp_path / "benchmark" / "traffic" / "dummy.py").write_text(
        "import torch\n\n\ndef infos(labels, clips, gen):\n"
        "    u = torch.rand(clips.shape[:2], generator=gen, device=clips.device)\n"
        "    return {'mask': u < labels['ratio']}\n")
    traffic = {"videos_per_step": 2, "clips_per_video": 3, "frames": 1, "ingest": [4, 4], "pool": 2,
               "labels": {"kind": "dummy", "ratio": 0.4}}
    pool = inputs.make_pool(traffic, 2**32 + 3, torch.device("cpu"), root=tmp_path)
    again = inputs.make_pool(traffic, 2**32 + 3, torch.device("cpu"), root=tmp_path)
    assert len(pool) == 2 and pool[0][1]["mask"].shape == (2, 3) and pool[0][1]["mask"].dtype == torch.bool
    assert all(torch.equal(a[1]["mask"], b[1]["mask"]) and torch.equal(a[0], b[0]) for a, b in zip(pool, again))
    with pytest.raises(FileNotFoundError):
        inputs.make_pool(dict(traffic, labels={"kind": "missing"}), 1, torch.device("cpu"), root=tmp_path)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_labels_and_solver_resolve_by_name(cell):
    ctx = manifest.resolve(M, cell, ROOT)
    assert callable(manifest.traffic_kind(ctx.traffic["labels"]["kind"]).infos)
    assert callable(manifest.solver(ctx.spec["reference_spec"]["solver"]["method"]).received)


def test_traced_host_operators_are_the_union_of_the_readers():
    from types import SimpleNamespace

    from harness import trace

    a = SimpleNamespace(HOST_OPS=("aten::mm", "aten::convolution"))
    b = SimpleNamespace(HOST_OPS=("aten::convolution", "aten::bmm"))
    assert trace.host_ops([a, b, SimpleNamespace()]) == ("aten::bmm", "aten::convolution", "aten::mm")
    assert trace.host_ops([SimpleNamespace()]) == ()
    ctx = manifest.resolve(M, "speed_r50.b8x4x8", ROOT)
    assert trace.host_ops(manifest.reader(m["name"], ROOT) for m in ctx.per_layer) == (
        "aten::convolution", "aten::convolution_backward")
