"""bench_torch.py, the port's bench script, on the CPU: its streams are
bench.py's with their sidecars' frame counts; it hashes pictures as
bench.py hashes them (8 and 10 bits); its per-stream measurement, driven
on the CPU with the plain kernels on tiny streams and their sidecars,
reports every key md5-checked, and a changed sidecar line fails it; its
busy-share function on synthetic intervals; and without a card the
script exits 2 and prints no result. Tolerance: none (md5s, counts)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
import bench_torch as bt
from test_torch_banded import encode10
from test_torch_inter import stream as inter_stream
from test_torch_intra import cuda  # noqa: F401  (a fixture)
from test_torch_parse import encode
from test_torch_shvc import shvc_stream

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("fps", "fps_median", "fps_decode_only", "fps_decode_only_median",
        "rep_times_s", "bit_exact", "decode_only_exact", "frames",
        "launches", "h2d_bytes_per_frame", "d2h_bytes_per_frame",
        "peak_mem_bytes", "busy_share", "busy_share_timed", "top_device_ops",
        "longest_idle_gaps", "stages_ms")
TOP = ("metric", "value", "unit", "value_decode_only", "configs", "device",
       "load_avg", "cpu_count", "ref_fps", "vs_baseline")


def test_configs_are_bench_pys_with_the_sidecars_frame_counts():
    assert [(n, k) for n, k, _ in bt.CONFIGS] == \
        [(n, k) for n, _gen, k, _ in bench.CONFIGS]
    for name, _kind, frames in bt.CONFIGS:
        data, want = bt.load_stream(name)
        assert len(want) == frames and data[:4] == b"\x00\x00\x00\x01"
        with open(bt.stream_path(name) + ".md5") as f:
            assert len(f.read().splitlines()) == frames


def _np_pictures(data, two_layers=False):
    from openhevc_tpu.decoder import Decoder, ShvcDecoder
    dec = ShvcDecoder("np") if two_layers else Decoder("np")
    return dec.decode(data) + dec.flush()


def _port_pictures(data):
    from openhevc_tpu_torch.decoder import Decoder
    dec = Decoder(device="cpu")
    return dec.decode(data) + dec.flush()


@pytest.mark.parametrize("bd", [8, 10])
def test_hash_pics_equals_bench_pys(bd):
    data = (encode if bd == 8 else encode10)(64, 64, n=2, seed=3, qp=30,
                                             ctb_log2=4)[0]
    got = bt.hash_pics(_port_pictures(data))
    want = bench._hash_pics(_np_pictures(data))
    assert len(got) == 2 and got == want


# name -> (stream, two layers, bytes of one fetched frame)
TINY = {
    "i_main_832x480": (lambda: encode(64, 64, n=3, seed=3, qp=30,
                                      ctb_log2=4)[0], False, 64 * 64 * 3 // 2),
    "main10_4k": (lambda: encode10(64, 64, n=2, seed=4, qp=30,
                                   ctb_log2=4)[0], False, 64 * 64 * 3),
    "shvc_2layer_832x480": (lambda: shvc_stream((32, 32), (64, 64), 31,
                                                n=3)[0], True,
                            64 * 64 * 3 // 2),
}


def _write_stream(tmp_path, name):
    """The tiny stream of TINY[name] under bench stream `name` in
    tmp_path, with the sidecar of `Decoder("np")`'s pictures hashed by
    bench.py; returns (data, sidecar)."""
    make, two, _ = TINY[name]
    data = make()
    want = bench._hash_pics(_np_pictures(data, two))
    path = bt.stream_path(name, str(tmp_path))
    with open(path, "wb") as f:
        f.write(data)
    with open(path + ".md5", "w") as f:
        f.write("\n".join(want))
    return data, want


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def _spy_uploads(monkeypatch):
    """The padded sizes of the buffers `upload` copies, as a list that
    grows with every call."""
    from openhevc_tpu_torch.models import pipeline
    sizes = []
    real = pipeline.upload

    def spy(arrays, device):
        sizes.append(max(sum((a.nbytes + 15) & ~15
                             for a in arrays.values()), 16))
        return real(arrays, device)

    monkeypatch.setattr(pipeline, "upload", spy)
    return sizes


class _Picture:
    """A decoded picture as the engine reads a reference: flat planes."""

    def __init__(self, flat, dims):
        self._dev, self._dims = flat, dims


def test_h2d_bytes_count_host_sources_only():
    """A reference plane already where the engine computes is not
    counted, even where the engine's device names an index and the
    plane's does not (`cuda` against `cuda:0` on a card); a plane held
    as a host array is."""
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    eng = TorchEngine("cpu:0")
    assert torch.device("cpu") != eng.device
    H, W = 8, 16
    flat = torch.arange(H * W * 3 // 2, dtype=torch.int64).to(torch.uint8)
    got = eng._ref_plane_dev(_Picture(flat, (H, W, H // 2, W // 2)), 1)
    assert eng.h2d_bytes == 0
    assert torch.equal(got, flat[H * W:H * W + H * W // 4].to(torch.int32)
                       .reshape(H // 2, W // 2))
    host = [np.zeros((H, W), np.uint8), np.ones((H // 2, W // 2), np.uint8),
            np.ones((H // 2, W // 2), np.uint8)]
    eng._ref_plane_dev(host, 2)
    assert eng.h2d_bytes == 4 * (H // 2) * (W // 2)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ra_tiles", "shvc"])
def test_h2d_bytes_on_the_card_are_the_uploads(name, monkeypatch,
                                               cuda):  # noqa: F811
    """On the card (an engine on `cuda`, pictures on `cuda:0`) the count
    is the one upload a picture: references read from the device on
    stage-1 cache misses and inter-layer planes cross nothing."""
    two = name == "shvc"
    data = shvc_stream((32, 32), (64, 64), 31, n=3)[0] if two else \
        inter_stream(name)
    sizes = _spy_uploads(monkeypatch)
    pics, _, dec = bt.decode_all(data, fetch=True, two_layers=two,
                                 device=str(cuda))
    assert two or any(dec.inter)
    assert sum(d._engine().h2d_bytes for d in bt.layers(dec)) == \
        sum(sizes) > 0
    assert len(pics) == (3 if two else 9)


@pytest.mark.parametrize("name", sorted(TINY))
def test_one_stream_reports_every_key_md5_checked(name, tmp_path, capsys,
                                                  monkeypatch):
    data, want = _write_stream(tmp_path, name)
    _make, two, frame_bytes = TINY[name]
    # the engine's H2D count == the bytes of the buffers `upload` copies
    sizes = _spy_uploads(monkeypatch)
    pics, _, dec = bt.decode_all(data, fetch=True, two_layers=two,
                                 device="cpu")
    h2d = sum(d._engine().h2d_bytes for d in bt.layers(dec))
    assert h2d == sum(sizes) > 0

    assert bt.run_only(name, device="cpu", streams_dir=str(tmp_path)) == 0
    line = _last_json(capsys.readouterr().out)
    assert set(TOP) <= set(line)
    assert line["metric"] == "i_main_832x480_intra_fps"
    assert line["ref_fps"] is None and line["vs_baseline"] is None
    assert line["device"]["name"] == "cpu" and line["device"]["count"] == 0
    r = line["configs"][name]
    assert set(KEYS) <= set(r)
    assert r["bit_exact"] and r["decode_only_exact"] and \
        r["diagnostics_exact"]
    assert r["frames"] == len(want) == len(pics)
    for mode in ("decode_only", "delivery"):
        assert len(r["rep_times_s"][mode]) == bt.REPS
    assert r["fps"] == max(r["frames"] / t for t in
                           r["rep_times_s"]["delivery"])
    # the plain versions launch nothing, so nothing is counted
    assert r["launches"] == {n: 0 for n in bt.KERNEL_ENTRIES}
    assert r["h2d_bytes_per_frame"] == h2d / len(pics)
    assert r["d2h_bytes_per_frame"] == frame_bytes
    # device numbers are not measured on the CPU
    assert r["peak_mem_bytes"] is None and r["busy_share"] is None
    assert r["busy_share_timed"] is None
    assert r["busy_share_note"].startswith("not measured")
    assert r["top_device_ops"] == [] and r["longest_idle_gaps"] == []
    assert (r["stages_ms"]["parse"] is None) == two
    assert r["stages_ms"]["kernel"] > 0 and r["stages_ms"]["fetch"] >= 0
    if name == bt.HEADLINE:
        assert line["value"] == r["fps"]
        assert line["value_decode_only"] == r["fps_decode_only"]
    else:
        assert line["value"] is None


def test_a_changed_sidecar_line_fails_the_run(tmp_path, capsys):
    name = bt.HEADLINE
    _data, want = _write_stream(tmp_path, name)
    want[1] = "0" * 32
    with open(bt.stream_path(name, str(tmp_path)) + ".md5", "w") as f:
        f.write("\n".join(want))
    assert bt.run_only(name, device="cpu", streams_dir=str(tmp_path),
                       reps=1) == 1
    line = _last_json(capsys.readouterr().out)
    assert line["metric"] == "i_main_832x480_intra_fps_MISMATCH"
    r = line["configs"][name]
    assert not r["bit_exact"] and not r["decode_only_exact"]
    assert not r["diagnostics_exact"] and not bt.exact(r)
    assert bt.exit_code({name: r}) == 1
    assert bt.exit_code({name: {"error": "timeout after 1 s"}}) == 1


@pytest.mark.parametrize("missing", ["", ".md5"])
def test_a_missing_file_is_named(missing, tmp_path, capsys):
    name = bt.HEADLINE
    _write_stream(tmp_path, name)
    path = bt.stream_path(name, str(tmp_path)) + missing
    os.remove(path)
    assert bt.run_only(name, device="cpu", streams_dir=str(tmp_path)) == 1
    out = capsys.readouterr()
    assert f"missing bench stream file {path}" in out.err
    assert out.out == ""


# ---- the busy share --------------------------------------------------------

def test_busy_share_counts_overlaps_and_nesting_once():
    dev = [(10, 30, "a"), (20, 40, "b"),     # overlap: 10-40
           (50, 90, "a"), (60, 70, "c"),     # nested: 50-90
           (95, 120, "d")]                   # past the window's end
    r = bt.device_busy(dev, [], (0, 100))
    assert r["busy_share"] == pytest.approx((30 + 40 + 5) / 100)
    assert r["device_ms"] == pytest.approx(75 / 1e3)
    assert r["window_ms"] == pytest.approx(0.1)
    assert [(o["name"], o["count"]) for o in r["top_device_ops"]] == \
        [("a", 2), ("b", 1), ("c", 1), ("d", 1)]
    assert r["top_device_ops"][0]["ms"] == pytest.approx(60 / 1e3)
    assert r["top_device_ops"][-1]["ms"] == pytest.approx(5 / 1e3)
    assert len(bt.device_busy(dev, [], (0, 100), top=2)["top_device_ops"]) \
        == 2


def test_busy_share_of_an_empty_trace_is_not_measured():
    for dev in ([], [(200, 300, "late")]):
        r = bt.device_busy(dev, [(0, 100, "host")], (0, 100))
        assert r["busy_share"] is None and r["device_ms"] is None
        assert r["busy_share_note"].startswith("not measured")
        assert r["top_device_ops"] == [] and r["longest_idle_gaps"] == []


def test_idle_gaps_are_the_longest_labelled_by_host_op():
    dev = [(10, 20, "k"), (50, 60, "k"), (62, 90, "k")]
    host = [(0, 100, "decode"), (15, 55, "host_pack"),
            (18, 30, "aten::copy_"), (58, 80, "kernel")]
    r = bt.device_busy(dev, host, (0, 100), gaps=3)
    assert r["busy_share"] == pytest.approx(0.48)
    gaps = r["longest_idle_gaps"]
    assert [(g["start_ms"], g["ms"]) for g in gaps] == \
        [(pytest.approx(0.020), pytest.approx(0.030)),
         (pytest.approx(0.0), pytest.approx(0.010)),
         (pytest.approx(0.090), pytest.approx(0.010))]
    assert gaps[0]["host_stack"] == ["decode", "host_pack", "aten::copy_"]
    assert gaps[0]["host_op"] == "aten::copy_"
    assert gaps[1]["host_stack"] == ["decode"]
    assert [(h["name"], h["ms"]) for h in gaps[0]["host_during"]] == \
        [("decode", pytest.approx(0.030)),
         ("host_pack", pytest.approx(0.030)),
         ("aten::copy_", pytest.approx(0.010))]
    assert [h["name"] for h in gaps[2]["host_during"]] == ["decode"]
    assert bt.device_busy(dev, [], (0, 100))["longest_idle_gaps"][0][
        "host_op"] is None
    # the 2 us gap at 60-62 is the shortest and drops out at gaps=3
    assert len(bt.device_busy(dev, host, (0, 100), gaps=4)
               ["longest_idle_gaps"]) == 4


def test_trace_intervals_reads_a_chrome_trace():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": bt.WINDOW, "ts": 100,
         "dur": 50, "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 105,
         "dur": 3, "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 106,
         "dur": 3, "tid": 8},                 # another thread: not a label
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 108, "dur": 1, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "k" * 300, "ts": 110, "dur": 4,
         "tid": 9},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 120,
         "dur": 2, "tid": 9},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 125,
         "dur": 1, "tid": 9},
        {"ph": "X", "cat": "gpu_user_annotation", "name": bt.WINDOW,
         "ts": 110, "dur": 20, "tid": 9},     # not device work
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 108},
    ]
    dev, host, window = bt.trace_intervals({"traceEvents": ev})
    assert window == (100.0, 150.0)
    assert dev == [(110.0, 114.0, "k" * bt.NAME_CHARS),
                   (120.0, 122.0, "Memcpy HtoD"), (125.0, 126.0, "Memset")]
    assert host == [(105.0, 108.0, "aten::add"),
                    (108.0, 109.0, "cudaLaunchKernel")]
    assert bt.device_busy(dev, host, window)["busy_share"] == \
        pytest.approx(7 / 50)


# ---- no card ---------------------------------------------------------------

def test_without_a_card_the_script_exits_2():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py"),
                        "--only", bt.HEADLINE], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 2
    assert "no CUDA device" in r.stderr
    assert "fps" not in r.stdout and not r.stdout.strip()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.measure(bt.HEADLINE, "single")
