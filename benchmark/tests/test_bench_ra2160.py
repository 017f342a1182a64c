"""The UHD Main 10 configuration `hevc_main10_ra_2160p` and its cell
`ra2160_batch`: their entries, the frozen stream in a directory of its
own, the two readers of the threaded parse (`parse_threaded.batch`,
`wavefront_wait_ms.batch`) on synthetic spans, and a traced tiny cell
that reads them."""
import json
import os
import sys

import pytest

from conftest import ROOT
from hevcbench import manifest
from hevcbench.cell import Cell
from hevcbench.readings import Readings
from hevcbench.streams import check_frozen
from test_bench_cells import run
from test_bench_spans import program, sp  # noqa: F401  (program: fixture)

WAVE = ("parse_threaded.batch", "wavefront_wait_ms.batch")


@pytest.fixture(scope="module")
def man():
    return manifest.load(ROOT)


def test_the_manifest_with_the_uhd_entries_keeps_to_the_schema(man):
    assert manifest.problems(man) == []


def test_the_uhd_configuration_and_its_cell(man):
    """`hevc_main10_ra_2160p` and `ra2160_batch`: their entries, the
    configuration's file, and its stream frozen in a directory of its
    own, with its own SOURCES.json and one sidecar line an access unit."""
    cfg = next(c for c in man["configs"]
               if c["name"] == "hevc_main10_ra_2160p")
    assert cfg["reduced"] == ["frames", "intra_period"]
    assert cfg["source"].startswith("JVET-J1010")
    cell = manifest.cell(man, "ra2160_batch")
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("hevc_main10_ra_2160p", "batch", 1)
    fps = next(m for m in man["end_to_end"] if m["name"] == "fps")
    assert manifest.reports(fps, "ra2160_batch")
    c = Cell(ROOT, "ra2160_batch")
    assert (c.config["width"], c.config["height"], c.config["bit_depth"],
            c.config["chroma_format"]) == (3840, 2160, 10, "4:2:0")
    assert "wpp" in c.config["tools"]
    assert {"parse_threaded.batch", "wavefront_wait_ms.batch",
            "edge_params_on_card.batch", "stage1_hit_rate.batch",
            "intra_roofline.batch", "parse_ms.batch",
            "decoder_self_ms.batch", "engine_host_ms.batch",
            "idle_on_parse_wait.batch"} <= set(c.per_layer)
    (entry,) = c.config["streams"]
    d = os.path.dirname(entry["file"])
    assert d == "benchmark/streams/hevc_main10_ra_2160p"
    assert os.path.dirname(entry["md5"]) == d
    with open(os.path.join(ROOT, d, "SOURCES.json")) as f:
        files = json.load(f)["files"]
    assert set(files) == {os.path.basename(entry["file"]),
                          os.path.basename(entry["md5"])}
    with open(os.path.join(ROOT, "benchmark", "streams",
                           "SOURCES.json")) as f:
        assert not set(json.load(f)["files"]) & set(files)
    check_frozen(ROOT, [entry["file"], entry["md5"]])
    (st,) = c.streams
    assert len(st.aus) == len(st.el) == c.config["frames"] == \
        c.config["intra_period"] == 33
    assert all(len(m) == 32 for m in st.el)


def wave_window(parse_attrs):
    """Two single-layer pictures, each parsed on the worker with the
    given attributes (one dict a picture)."""
    d = sp("decode", 0, 50)
    out = [d]
    for i, attrs in enumerate(parse_attrs):
        out.append(sp("parse", 1 + 10 * i, 9 + 10 * i, pic=(0, i),
                      parent=d.id, tid=2, **attrs))
        out.append(sp("reconstruct", 30 + 5 * i, 34 + 5 * i, pic=(0, i),
                      parent=d.id))
    return out


def wave_readers():
    return {n: manifest.reader(ROOT, n) for n in WAVE}


def test_the_wavefront_metrics_have_their_entries(man):
    got = {m["name"]: m for m in man["per_layer"]}
    for name in WAVE:
        m = got[name]
        assert m["workloads"] == ["ra2160_batch"]
        assert m["moves"] == "fps"
        assert m["source"] == "program_counter"
        assert m["layer"] == got["parse_worker_ms.batch"]["layer"]


@pytest.mark.parametrize("attrs, threaded, wait", [
    # both pictures threaded on 4 workers
    ([dict(route="native", substreams=34, threads=4, fallback=0,
           wave_wait_us=1500),
      dict(route="native", substreams=34, threads=4, fallback=0,
           wave_wait_us=500)], 100.0, 1.0),
    # one fell back to the serial re-parse
    ([dict(route="native", substreams=34, threads=4, fallback=1,
           wave_wait_us=2000),
      dict(route="native", substreams=34, threads=4, fallback=0,
           wave_wait_us=0)], 50.0, 1.0),
    # no entry points (serial by the stream), and one worker asked for
    ([dict(route="native", substreams=1, threads=1, fallback=0,
           wave_wait_us=0),
      dict(route="native", substreams=34, threads=1, fallback=0,
           wave_wait_us=0)], 0.0, 0.0),
    # a slice the native core refused: the Python parser's span says
    # nothing of threads and is left out
    ([dict(route="python"),
      dict(route="native", substreams=34, threads=2, fallback=0,
           wave_wait_us=300)], 100.0, 0.15),
])
def test_the_wavefront_readers(program, attrs, threaded, wait):  # noqa: F811
    read = wave_readers()
    program["spans"] = wave_window(attrs)
    r = Readings(window_s=1.0)
    assert read["parse_threaded.batch"](r) == pytest.approx(threaded)
    assert read["wavefront_wait_ms.batch"](r) == pytest.approx(wait)


def test_the_wavefront_readers_without_a_native_parse(program):  # noqa: F811
    read = wave_readers()
    r = Readings(window_s=1.0)
    assert all(fn(r) is None for fn in read.values())
    # only the Python parser ran
    program["spans"] = wave_window([dict(route="python")] * 2)
    r = Readings(window_s=1.0)
    assert all(fn(r) is None for fn in read.values())
    # a program whose parse spans do not say how it parsed (the parent)
    program["spans"] = wave_window([dict(route="native")] * 2)
    r = Readings(window_s=1.0)
    assert all(fn(r) is None for fn in read.values())


def test_the_wavefront_readers_without_the_tracer(monkeypatch):
    import openhevc_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "openhevc_tpu_torch.utils.trace", None)
    r = Readings(window_s=1.0)
    assert all(fn(r) is None for fn in wave_readers().values())


def test_a_traced_run_reads_the_threaded_parse(tiny_root):
    """The tiny cell's stream has 2x2 tiles: every picture's four
    substreams parse on the native core's workers, and tiles never wait
    on a row above."""
    out = run(tiny_root, "tiny_ra_batch", trace=True, seconds=3)
    assert out["correct"]
    got = out["metrics"]
    assert got["parse_threaded.batch"]["value"] == 100.0
    assert got["wavefront_wait_ms.batch"]["value"] == 0.0
