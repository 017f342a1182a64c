"""The deblocking filter's per-edge parameters made on the device
(`ops/filters.py::edge_params`: csrc/edge_params.cu on a card, its plain
PyTorch version `edge_params_ref` on the CPU), array for array, on every
deblocked picture of the benchmark's 1080p random-access stream and of
the deblocked feature streams (4:2:2, 4:4:4, 10 / 12 bit, CTB 16 / 32 /
64, PCM, lossless, weighted bi-prediction). The CPU comparison of the
plain version with the JAX package's `prep_filters` is in
tests/test_torch_filters.py; this file holds the wrapper's checks, the
reader of the `edge_params` spans and the `gpu` test (kernel == plain
version on the card == plain version on the CPU), and imports no JAX
(the card's machine has none). Tolerance: none (integers)."""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from openhevc_tpu_torch.ops.filters import (EDGE_KEYS, edge_inputs,
                                            edge_params, edge_params_ref,
                                            plan_filters)
from test_torch_intra import cuda  # noqa: F401  (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_STREAM = "benchmark/streams/hevc_ra_1080p_qp32.265"


@pytest.fixture
def one_thread():
    """One intra-op thread for this file's CPU work: the test run shares
    the cores among its workers, and eight threads each slowed the plain
    version twentyfold on an 8-core CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _deblocked_feature_streams():
    with open(os.path.join(ROOT, "feature_streams", "MANIFEST.json")) as f:
        entries = json.load(f)["streams"]
    return sorted(f"feature_streams/{e['name']}.265" for e in entries
                  if "deblock" in e["features"])


EDGE_STREAMS = [BENCH_STREAM] + _deblocked_feature_streams()


def deblocked(path):
    """Every picture of the stream (a path from the repo's root) that the
    engine deblocks on the device (its filter plan's device route), in
    decode order; parsed on the CPU."""
    from bench_torch import parse_only
    with open(os.path.join(ROOT, path), "rb") as f:
        data = f.read()
    out = []
    for fs in parse_only(data, device="cpu"):
        plan = plan_filters(fs)
        if plan is not None and plan.route == "device" and plan.do_deblock:
            out.append(fs)
    return out


def device_edges(fs, device, fn=edge_params):
    """fn (`edge_params` or its plain version) on the picture's grids,
    moved to `device`."""
    grids, kw = edge_inputs(fs)
    g = [torch.from_numpy(np.array(a)).to(device) for a in grids.values()]
    return fn(*g, **kw)


def assert_edges_equal(got, pff):
    assert len(got) == len(EDGE_KEYS)
    for k, a in zip(EDGE_KEYS, got):
        want = pff[k]
        assert a.dtype == torch.int16 and tuple(a.shape) == want.shape, k
        assert np.array_equal(a.cpu().numpy(), want), k


def _grids(gh=6, gw=10, motion=True):
    rng = np.random.default_rng(5)
    g = [rng.integers(0, 3, (gh, gw)).astype(np.uint8),
         rng.integers(0, 2, (gh, gw)).astype(np.uint8),
         rng.integers(0, 2, (gh, gw)).astype(np.uint8),
         rng.integers(0, 2, (gh, gw)).astype(np.uint8),
         rng.integers(-10, 51, (gh, gw)).astype(np.int8),
         np.tile(np.arange(-32, 64, dtype=np.int32), (2, 1))]
    if motion:
        g += [rng.integers(0, 4, (gh, gw)).astype(np.uint8),
              rng.integers(-6, 6, (gh, gw, 2, 2)).astype(np.int16),
              rng.integers(0, 3, (gh, gw, 2)).astype(np.int32)]
    return [torch.from_numpy(a) for a in g]


KW = dict(H=24, W=40, hs=1, vs=1, bd=8, bdc=8, beta_offset=0, tc_offset=0)


def _call(g, **kw):
    return edge_params(*g, **dict(KW, **kw))


def test_edge_params_on_random_grids_match_the_plain_version():
    """The wrapper on CPU tensors is the plain version; every array has
    its shape, the first edge column / row is 0, the MV rule decides."""
    g = _grids()
    got = _call(g)
    ref = edge_params_ref(*g, **KW)
    assert [tuple(a.shape) for a in got] == [(6, 5), (6, 5), (3, 10),
                                             (3, 10), (3, 3), (2, 5),
                                             (3, 3), (2, 5)]
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert not got[1][:, 0].any() and not got[3][0].any()
    still = _call(_grids(motion=False))
    assert any(not torch.equal(a, b) for a, b in zip(got, still))


@pytest.mark.parametrize("what", ["dtype", "shape", "contiguous", "motion",
                                  "qlut", "picture", "depth", "device"])
def test_edge_params_refuses_what_the_kernel_does_not_take(what):
    g = _grids()
    kw = {}
    err = ValueError
    if what == "dtype":
        g[4], err = g[4].to(torch.int32), TypeError
    elif what == "shape":
        g[1] = g[1][:5]
    elif what == "contiguous":
        g[0] = torch.zeros((10, 6), dtype=torch.uint8).T
    elif what == "motion":
        g[7] = g[7].reshape(6, 10, 4)
    elif what == "qlut":
        g[5] = g[5][:, :95]
    elif what == "picture":
        kw = dict(H=28)
    elif what == "depth":
        kw = dict(bdc=7)
    else:
        g[2] = g[2].to("meta")
    with pytest.raises(err):
        _call(g, **kw)


def test_reader_of_the_spans_counts_the_kernel_route(monkeypatch):
    """benchmark/metrics/edge_params_on_card.batch.py: the share of
    `edge_params` spans with kernel 1, None without one."""
    from openhevc_tpu_torch.utils import trace
    monkeypatch.syspath_prepend(os.path.join(ROOT, "benchmark"))
    from hevcbench import manifest
    from hevcbench.readings import Readings
    read = manifest.reader(ROOT, "edge_params_on_card.batch")
    entry = {m["name"]: m for m in manifest.load(ROOT)["per_layer"]}[
        "edge_params_on_card.batch"]
    assert entry["moves"] == "fps" and entry["workloads"] == [
        "ra1080_batch", "ra2160_batch"]
    assert entry["source"] == "program_counter"
    held = {"spans": []}
    monkeypatch.setattr(trace, "spans", lambda: list(held["spans"]))
    monkeypatch.setattr(trace, "clear", lambda: held.update(spans=[]))

    def sp(name, **attrs):
        return SimpleNamespace(name=name, id=1, parent=None, pic=(0, 0),
                               attrs=attrs, tid=1, start_ns=0, end_ns=1)

    held["spans"] = [sp("reconstruct"), sp("edge_params", kernel=1),
                     sp("edge_params", kernel=1), sp("edge_params", kernel=0),
                     sp("edge_params", kernel=1)]
    assert read(Readings(window_s=1.0)) == pytest.approx(75.0)
    held["spans"] = [sp("reconstruct"), sp("deblock")]
    assert read(Readings(window_s=1.0)) is None
    assert read(Readings(window_s=1.0)) is None       # nothing recorded


@pytest.mark.gpu
def test_edge_params_kernel_equals_plain_version_on_the_card(cuda):
    """On every deblocked picture of the streams: the kernel == its plain
    version on the card == its plain version on the CPU (which the CPU
    tests hold against the JAX package's `prep_filters`); one launch a
    picture; a second launch gives identical tensors. Then a decode of
    the 1080p stream launches it once a deblocked picture, md5-exact."""
    from bench_torch import hash_pics
    from openhevc_tpu_torch.decoder import Decoder
    n = 0
    before = edge_params.launches
    for path in EDGE_STREAMS:
        for fs in deblocked(path):
            got = device_edges(fs, "cuda")
            assert all(a.device.type == "cuda" for a in got)
            again = device_edges(fs, "cuda")
            plain = device_edges(fs, "cuda", edge_params_ref)
            torch.cuda.synchronize()
            for a, b, c in zip(got, again, plain):
                assert torch.equal(a, b) and torch.equal(a, c)
            cpu = device_edges(fs, "cpu", edge_params_ref)
            assert_edges_equal(got, {k: a.numpy()
                                     for k, a in zip(EDGE_KEYS, cpu)})
            n += 1
    assert edge_params.launches - before == 2 * n
    assert n > 60
    path = os.path.join(ROOT, BENCH_STREAM)
    with open(path, "rb") as f:
        data = f.read()
    with open(path + ".md5") as f:
        want = f.read().split()
    dec = Decoder(device="cuda")
    before = edge_params.launches
    pics = dec.decode(data) + dec.flush()
    assert hash_pics(pics) == want
    assert edge_params.launches - before == len(deblocked(BENCH_STREAM))
