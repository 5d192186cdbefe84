"""BENCHMARK.json against the benchmark's contract, and the files it names."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import manifest as mf

ROOT = mf.ROOT
M = mf.load_manifest()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
LINE = 200  # a why, a layer, a source, a word of the command
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= LINE and "\n" not in s and "\t" not in s


def test_keys_and_sizes():
    assert set(M) == TOP_KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(M["paths"]) <= 16 and 1 <= len(M["configs"]) <= 24
    assert 1 <= len(M["workloads"]) <= 24 and 1 <= len(M["end_to_end"]) <= 16
    assert 1 <= len(M["per_layer"]) <= 128
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def test_command_and_paths_stay_inside():
    assert 1 <= len(M["command"]) <= 32 and all(_line(w) for w in M["command"])
    for w in M["command"]:
        assert not w.startswith("/") and ".." not in w.split("/")
    for p in M["paths"]:
        assert len(p) <= 200 and all(c.isalnum() or c in "_.-/" for c in p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
        assert (ROOT / p).is_dir()


def test_names_and_units():
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in M[k]}) == len(M[k])
        for x in M[k]:
            assert mf.NAME.fullmatch(x["name"]), x["name"]
    for m in M["end_to_end"] + M["per_layer"]:
        assert mf.UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in M["end_to_end"]}
        if "roofline" in m["name"]:
            assert m["unit"] == "%"


def test_configs_and_cells():
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in M["paths"])
        assert (ROOT / c["file"]) == mf.HERE / "configs" / f"{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert mf.NAME.fullmatch(w["config"]) and mf.NAME.fullmatch(w["traffic"])
        mf.config(w["config"])
        traffic = mf.traffic(w["traffic"])
        mf.entry(traffic["entry"])
        mf.work(traffic["entry"])
        faults = mf.faults(traffic["entry"])
        assert callable(faults.altered) and callable(faults.half_batch)


def test_every_cell_reports_enough():
    for w in M["workloads"]:
        e2e = {m["name"] for m in mf.end_to_end(M, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = mf.per_layer(M, w["name"])
        assert layer
        for m in layer:
            assert m["moves"] in e2e


def test_every_metric_has_a_reader_and_one_layer_name():
    """BENCHMARK.json holds each metric's unit, layer and arrow; its reader
    gives only the number."""
    for m in M["per_layer"]:
        r = mf.metric_reader(m["name"])
        assert callable(r.read), m["name"]
        assert not {"LAYER", "UNIT", "BETTER", "SOURCE", "MOVES"} & set(vars(r)), m["name"]
    layers = {}
    for m in M["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_a_split_metric_measures_its_quantity():
    """``request_p50_ms.b1`` is ``request_p50_ms`` in the cells of one query
    a request; no cell reports a quantity twice."""
    assert mf.quantity("request_p50_ms.b1") == mf.quantity("request_p50_ms") == "request_p50_ms"
    for w in M["workloads"]:
        names = [mf.quantity(m["name"]) for m in mf.end_to_end(M, w["name"])]
        assert len(names) == len(set(names)), w["name"]


def test_a_full_check_fits_the_day():
    cells = 24  # later PRs may add cells up to the limit, at this length
    assert (2 + 14 * cells) * (M["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_new_files_add_a_cell_with_no_edit(tmp_path):
    """A new entry point (its adapter, work and faults), a configuration, a
    traffic mix and two cells over them, one of one card and one of four,
    added as files and entries of BENCHMARK.json, run through the same code
    with no file of the benchmark edited: both correct, and the new entry's
    own faults make the first not correct. On the CPU the four-card cell's
    card list is the one device."""
    shutil.copytree(mf.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    for folder in ("entries", "work", "faults"):
        shutil.copy(tmp_path / "benchmark" / folder / "match.py",
                    tmp_path / "benchmark" / folder / "tiny_match.py")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny-db", "source": "test", "reduced": [],
                                "file": "benchmark/configs/tiny-db.json", "why": "test"})
    cells = ["tiny.match-b2", "tiny.match-b2-4chip"]
    manifest["workloads"] += [
        {"name": cells[0], "config": "tiny-db", "traffic": "tiny-b2", "chips": 1, "why": "test"},
        {"name": cells[1], "config": "tiny-db", "traffic": "tiny-b2-4", "chips": 4, "why": "test"}]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m and "plain3m-match-b128" in m["workloads"]:
            m["workloads"] += cells
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    (tmp_path / "benchmark/configs/tiny-db.json").write_text(json.dumps(
        {"system": "plaintext", "entries": 300, "storage": "packed", "chunk": 128,
         "reduced": []}))
    mix = {"entry": "tiny_match", "batch": 2, "duplicate_share": 0.5, "flip_bits": 8,
           "distinct_requests": 3, "warmup_requests": 1, "check_queries": 4,
           "control_requests": 2}
    (tmp_path / "benchmark/traffic/tiny-b2.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark/traffic/tiny-b2-4.json").write_text(json.dumps({**mix, "batch": 4}))
    code = ("import time, pytest; from benchmark import harness, manifest as mf\n"
            "def run(cell):\n"
            "    r = harness.run_cell(cell, 5, 0.3, False, 'cpu', time.perf_counter())\n"
            "    return r.correct, r.memory_peak_bytes, sorted(r.metrics)\n"
            "print(run('tiny.match-b2'))\n"
            "print(run('tiny.match-b2-4chip'))\n"
            "for fault in ('altered', 'half_batch'):\n"
            "    with pytest.MonkeyPatch.context() as mp:\n"
            "        getattr(mf.faults('tiny_match'), fault)(mp)\n"
            "        print(run('tiny.match-b2'))\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(tmp_path), str(ROOT)])}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    e2e = sorted(m["name"] for m in mf.end_to_end(manifest, cells[0]))
    assert out.stdout.splitlines()[-4:] == [str((True, 0, e2e))] * 2 + [str((False, 0, e2e))] * 2
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.parametrize("name", [w["name"] for w in M["workloads"]])
def test_run_refuses_without_a_card(name):
    """No card: a non-zero exit and no result line."""
    code = ("import torch, sys; torch.cuda.is_available = lambda: False; "
            "from benchmark import run; sys.exit(run.main(['--workload', %r, '--seed', "
            "'1', '--seconds', '1', '--trace', '0']))" % name)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_without_the_port(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's files, on a
    machine that has a card (faked here): a non-zero exit and no result."""
    shutil.copytree(mf.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import torch, sys; torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 4; from benchmark import run; "
            "sys.exit(run.main(['--workload', %r, '--seed', '1', '--seconds', '1', "
            "'--trace', '0']))" % M["workloads"][0]["name"])
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "mpc_iris_tpu_torch" in out.stderr
