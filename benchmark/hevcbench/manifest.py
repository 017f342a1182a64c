"""BENCHMARK.json and the files it names, found by name alone:
`benchmark/configs/<config>.json`, `benchmark/traffic/<traffic>.json`
and `benchmark/metrics/<metric>.py`. A configuration, a mix, a cell or
a per-layer metric is added by adding files and entries, with no edit
to the harness."""
from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = "benchmark"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}\Z")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
E2E_SOURCES = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text, what, errs):
    if not isinstance(text, str) or not 1 <= len(text) <= 200 or \
            "\n" in text or "\t" in text:
        errs.append(f"{what}: 1-200 characters on one line")


def problems(man: dict) -> list[str]:
    """Every way `man` departs from the benchmark's schema (empty when
    it keeps to it)."""
    errs = []
    if set(man) != TOP_KEYS:
        errs.append(f"top-level keys {sorted(man)}")
        return errs
    if not isinstance(man["run_seconds"], int) or \
            not 1 <= man["run_seconds"] <= 51:
        errs.append("run_seconds: a whole number from 1 to 51")
    if not 1 <= len(man["paths"]) <= 16 or not all(
            isinstance(p, str) and PATH.match(p) and ".." not in p and
            not p.startswith("/") for p in man["paths"]):
        errs.append("paths")
    if not 1 <= len(man["command"]) <= 32:
        errs.append("command: 1-32 words")
    for word in man["command"]:
        _line(word, "command word", errs)
    names = {}
    for kind, keys, lo, hi in (("configs", CONFIG_KEYS, 1, 24),
                               ("workloads", CELL_KEYS, 1, 24),
                               ("end_to_end", E2E_KEYS, 1, 16),
                               ("per_layer", LAYER_KEYS, 1, 128)):
        entries = man[kind]
        if not lo <= len(entries) <= hi:
            errs.append(f"{kind}: {lo}-{hi} entries")
        for e in entries:
            extra = set(e) - keys - ({"workloads"} if kind in (
                "end_to_end", "per_layer") else set())
            if set(e) < keys or extra:
                errs.append(f"{kind} {e.get('name')}: keys {sorted(e)}")
                continue
            if not isinstance(e["name"], str) or not NAME.match(e["name"]):
                errs.append(f"{kind} name {e['name']!r}")
            names.setdefault(kind if kind in ("configs", "workloads")
                             else "metrics", []).append(e["name"])
    for kind, seen in names.items():
        if len(seen) != len(set(seen)):
            errs.append(f"{kind}: a name comes twice")
    cfgs = {c["name"] for c in man["configs"]}
    cells = {c["name"] for c in man["workloads"]}
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for c in man["configs"]:
        for key in ("source", "why"):
            _line(c.get(key), f"config {c.get('name')} {key}", errs)
        if not any(c["file"].startswith(p.rstrip("/") + "/")
                   for p in man["paths"]):
            errs.append(f"config {c['name']}: file outside paths")
        if len(c["reduced"]) > 16 or not all(
                NAME.match(k) for k in c["reduced"]):
            errs.append(f"config {c['name']}: reduced")
        if not any(w["config"] == c["name"] for w in man["workloads"]):
            errs.append(f"config {c['name']}: used by no cell")
    pairs = set()
    for w in man["workloads"]:
        _line(w.get("why"), f"cell {w.get('name')} why", errs)
        if w["config"] not in cfgs:
            errs.append(f"cell {w['name']}: unknown config")
        if not NAME.match(str(w["traffic"])):
            errs.append(f"cell {w['name']}: traffic name")
        if w["chips"] not in (1, 4):
            errs.append(f"cell {w['name']}: chips 1 or 4")
        if (w["config"], w["traffic"]) in pairs:
            errs.append(f"cell {w['name']}: config and traffic twice")
        pairs.add((w["config"], w["traffic"]))
    if "setup_s" not in e2e:
        errs.append("end_to_end: no setup_s")
    for m in man["end_to_end"] + man["per_layer"]:
        if not isinstance(m["unit"], str) or not UNIT.match(m["unit"]):
            errs.append(f"metric {m['name']}: unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            errs.append(f"metric {m['name']}: better")
        for w in m.get("workloads", []):
            if w not in cells:
                errs.append(f"metric {m['name']}: unknown cell {w}")
    for m in man["end_to_end"]:
        if m["source"] not in E2E_SOURCES:
            errs.append(f"metric {m['name']}: source")
        if not isinstance(m["bound"], (int, float)) or \
                not 0.01 <= m["bound"] <= 0.25:
            errs.append(f"metric {m['name']}: bound 0.01-0.25")
    for m in man["per_layer"]:
        _line(m.get("layer"), f"metric {m['name']} layer", errs)
        if m["source"] not in SOURCES:
            errs.append(f"metric {m['name']}: source")
        moved = e2e.get(m["moves"])
        if moved is None:
            errs.append(f"metric {m['name']}: moves {m['moves']}")
            continue
        for w in m.get("workloads", sorted(cells)):
            if w not in cells or not reports(moved, w):
                errs.append(f"metric {m['name']}: {w} does not report "
                            f"{m['moves']}")
    for w in cells:
        ends = [m for m in man["end_to_end"] if reports(m, w)]
        if len(ends) < 2 or not any(reports(m, w)
                                    for m in man["per_layer"]):
            errs.append(f"cell {w}: setup_s, another end-to-end metric and "
                        f"a per-layer metric")
    return errs


def reports(metric: dict, cell: str) -> bool:
    """Whether the cell reports the metric."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(root: str, man: dict, name: str) -> dict:
    entry = next(c for c in man["configs"] if c["name"] == name)
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def traffic(root: str, name: str) -> dict:
    with open(os.path.join(root, HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def reader(root: str, name: str):
    """The `read(readings)` function of `benchmark/metrics/<name>.py`."""
    path = os.path.join(root, HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
