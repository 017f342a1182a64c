"""BENCHMARK.json keeps to its schema, and every cell finds its files
by name: its configuration, its mix, its streams (frozen) and the
reader of each of its per-layer metrics. A cell added from files alone
does too."""
import copy
import json
import os

import pytest

from conftest import ROOT, TINY_CELLS
from hevcbench import manifest
from hevcbench.cell import Cell
from hevcbench.streams import Stream, check_frozen
from hevcbench.traffic import check_mix


@pytest.fixture(scope="module")
def man():
    return manifest.load(ROOT)


def test_manifest_keeps_to_the_schema(man):
    assert manifest.problems(man) == []


def test_every_name_and_unit_uses_the_allowed_characters(man):
    entries = man["configs"] + man["workloads"] + man["end_to_end"] + \
        man["per_layer"]
    for e in entries:
        assert manifest.NAME.match(e["name"]), e["name"]
    for m in man["end_to_end"] + man["per_layer"]:
        assert manifest.UNIT.match(m["unit"]), m["unit"]
    for w in man["workloads"]:
        assert manifest.NAME.match(w["config"])
        assert manifest.NAME.match(w["traffic"])
    for c in man["configs"]:
        assert all(manifest.NAME.match(k) for k in c["reduced"])
    assert len(json.dumps(man)) < 64 * 1024


@pytest.mark.parametrize("break_it, what", [
    (lambda m: m["end_to_end"][0].update(unit="pictures per s"), "unit"),
    (lambda m: m["workloads"][0].update(name="a/b"), "name"),
    (lambda m: m["end_to_end"].pop(), "setup_s"),
    (lambda m: m["per_layer"][0].update(why="extra key"), "keys"),
    (lambda m: m["workloads"].append(dict(m["workloads"][0])), "twice"),
    (lambda m: m["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda m: m["per_layer"][0].update(moves="no_such_metric"), "moves"),
    (lambda m: m.update(run_seconds=52), "run_seconds"),
    (lambda m: m["workloads"][0].update(chips=2), "chips"),
    (lambda m: m["per_layer"][0]["workloads"].append("shvc_x2_live"),
     "does not report"),
])
def test_schema_refuses_a_broken_manifest(man, break_it, what):
    broken = copy.deepcopy(man)
    break_it(broken)
    errs = manifest.problems(broken)
    assert errs and any(what in e for e in errs), errs


def test_every_cell_finds_its_files_by_name(man):
    for w in man["workloads"]:
        c = Cell(ROOT, w["name"])
        check_mix(c.mix)
        assert c.streams and all(s.aus for s in c.streams)
        assert set(c.per_layer) == {
            m["name"] for m in man["per_layer"]
            if manifest.reports(m, w["name"])}
        assert all(callable(read) for read, _ in c.per_layer.values())
        assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2
    for c in man["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
    for m in man["per_layer"]:
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "metrics", f"{m['name']}.py"))


def test_streams_are_the_frozen_copies(man):
    for c in man["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        for e in cfg["streams"]:
            check_frozen(ROOT, [e[k] for k in ("file", "md5", "bl_md5")
                                if e.get(k)])
            s = Stream(ROOT, e)
            assert len(s.aus) == len(s.el)
            assert s.bl is None or len(s.bl) == len(s.el)


def test_a_changed_stream_is_refused(tmp_path):
    src = os.path.join(ROOT, "benchmark", "streams")
    dst = tmp_path / "benchmark" / "streams"
    dst.mkdir(parents=True)
    for name in ("SOURCES.json", "shvc_x2_1080p_ld32.md5"):
        (dst / name).write_bytes(open(os.path.join(src, name), "rb").read())
    (dst / "shvc_x2_1080p_ld32.md5").write_text("0" * 32)
    with pytest.raises(ValueError, match="frozen"):
        check_frozen(str(tmp_path),
                     ["benchmark/streams/shvc_x2_1080p_ld32.md5"])


def test_a_cell_added_from_files_alone_is_found(tiny_root):
    man = manifest.load(tiny_root)
    assert manifest.problems(man) == []
    for name, _cfg, _mix in TINY_CELLS:
        c = Cell(tiny_root, name)
        assert "pictures.tiny" in c.per_layer
        assert c.streams[0].aus
    # the accepted cells are untouched by the addition
    base = manifest.load(ROOT)
    assert [w["name"] for w in man["workloads"][:len(base["workloads"])]] \
        == [w["name"] for w in base["workloads"]]
