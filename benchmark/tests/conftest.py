"""Shared set-up of the benchmark's CPU tests: the harness importable,
and a copy of the benchmark in a temporary checkout with small cells
added from files alone (configurations, a mix, a metric reader, and
entries in its BENCHMARK.json), as a later change would add them."""
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CONFIGS = {
    "tiny_ra": {"entry": "single", "streams": [
        {"name": "ra_tiles", "file": "benchmark/tests/streams/ra_tiles.265",
         "md5": "benchmark/tests/streams/ra_tiles.265.md5",
         "bl_md5": None}]},
    "tiny_shvc": {"entry": "shvc", "streams": [
        {"name": "col_il_mv",
         "file": "benchmark/tests/streams/col_il_mv.265",
         "md5": "benchmark/tests/streams/col_il_mv.md5",
         "bl_md5": "benchmark/tests/streams/col_il_mv.bl.md5"}]},
}
TINY_MIX = {"tiny_live": {"loop": "open", "session": "repeat",
                          "fetch": True, "rate_aus_per_s": 20.0}}
TINY_CELLS = [("tiny_ra_batch", "tiny_ra", "batch"),
              ("tiny_ra_keyframes", "tiny_ra", "keyframes"),
              ("tiny_shvc_batch", "tiny_shvc", "batch"),
              ("tiny_shvc_live", "tiny_shvc", "tiny_live")]
PICTURES_READER = '''"""Output pictures of the traced window (a reader added by a test)."""


def read(r):
    return float(r.pictures) if r.pictures else None
'''


def add_tiny_cells(root):
    """Add the small cells to the checkout at `root` by new files and
    new entries only."""
    bench = os.path.join(root, "benchmark")
    for name, cfg in TINY_CONFIGS.items():
        with open(os.path.join(bench, "configs", f"{name}.json"), "w") as f:
            json.dump({"name": name, **cfg}, f)
    for name, mix in TINY_MIX.items():
        with open(os.path.join(bench, "traffic", f"{name}.json"), "w") as f:
            json.dump(mix, f)
    with open(os.path.join(bench, "metrics", "pictures.tiny.py"), "w") as f:
        f.write(PICTURES_READER)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        man = json.load(f)
    for name in TINY_CONFIGS:
        man["configs"].append({
            "name": name, "source": "a CPU test stream of feature_streams",
            "file": f"benchmark/configs/{name}.json", "reduced": [],
            "why": "small enough for the CPU"})
    cells = [c for c, _, _ in TINY_CELLS]
    for c, cfg, mix in TINY_CELLS:
        man["workloads"].append({"name": c, "config": cfg, "traffic": mix,
                                 "chips": 1, "why": "a CPU test cell"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            live = "picture_latency" in m["name"] or m["name"].endswith(
                ".live")
            m["workloads"] += [c for c in cells if ("live" in c) == live]
    man["per_layer"].append({
        "name": "pictures.tiny", "unit": "pictures", "better": "higher",
        "source": "host_clock", "layer": "device", "moves": "setup_s",
        "workloads": cells})
    with open(path, "w") as f:
        json.dump(man, f, indent=1)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A checkout with the benchmark (and the program beside it) and the
    small cells added."""
    root = str(tmp_path_factory.mktemp("checkout"))
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    os.symlink(os.path.join(ROOT, "openhevc_tpu_torch"),
               os.path.join(root, "openhevc_tpu_torch"))
    add_tiny_cells(root)
    return root
