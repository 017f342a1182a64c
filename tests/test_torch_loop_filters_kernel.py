"""The in-loop filters' kernels (`ops/filters.py::apply_filters_device`:
csrc/loop_filters.cu on a card, at most three launches a picture)
against their plain PyTorch version `apply_filters_ref`, array for
array: on a seeded matrix of synthetic pictures (4:2:0 / 4:2:2 / 4:4:4,
CTB 16 / 32 / 64 with the stale-read masks at 16, 8 / 10 / 12 bits,
deblocking only, SAO only and both, no-filter maps, halo bands with
`ybounds`, chroma planes whose size is not a multiple of 8) and on real
pictures of both benchmark streams. The CPU comparison of the plain
version with the JAX package is in tests/test_torch_filters.py and
tests/test_torch_mesh_tiles.py; this file holds the wrapper's checks,
the `kernel` attribute of the engine's `deblock` / `sao` spans, the
reader of `filters_on_card.batch` and the `gpu` tests, and imports no
JAX (the card's machine has none). Tolerance: none (integers)."""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from openhevc_tpu_torch.decoder import Decoder
from openhevc_tpu_torch.ops import filters as F
from openhevc_tpu_torch.ops.tables import BETA_TABLE, TC_TABLE
from openhevc_tpu_torch.utils import trace
from test_torch_edge_params import one_thread  # noqa: F401  (a fixture)
from test_torch_intra import cuda  # noqa: F401  (a fixture)
from test_torch_trace import FILTERED, aus, decode, profiled

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RA_1080P = os.path.join(ROOT, "benchmark", "streams",
                        "hevc_ra_1080p_qp32.265")
RA_2160P = os.path.join(ROOT, "benchmark", "streams", "hevc_main10_ra_2160p",
                        "hevc_ra_2160p10_qp32.265")
SHIFTS = {1: (1, 1), 2: (1, 0), 3: (0, 0)}      # chroma_format_idc -> hs, vs

# W, H, chroma format, CTB, bit depth, deblock, SAO, no-filter maps, band
# (None: the whole picture; a halo band: "top", the picture goes on above
# the band and ends a CTB before its last row; "bottom", the picture
# starts a CTB into the band and goes on below it; row 0 or the last row
# then reads across the band's wrap, as the plain version's rolls do)
MATRIX = [
    (88, 72, 1, 16, 8, True, True, False, None),    # chroma 44x36, stale
    (88, 72, 1, 16, 10, True, True, True, None),    # + no-filter maps
    (96, 64, 1, 32, 12, True, True, True, None),
    (136, 72, 1, 64, 8, True, True, False, None),   # chroma 68x36
    (64, 48, 2, 16, 10, True, True, True, None),    # 4:2:2, stale
    (96, 64, 2, 32, 8, True, True, False, None),
    (136, 64, 2, 64, 12, True, True, True, None),
    (48, 48, 3, 16, 12, True, True, False, None),   # 4:4:4, stale
    (96, 64, 3, 32, 10, True, True, True, None),
    (136, 72, 3, 64, 8, True, True, True, None),
    (88, 72, 1, 32, 8, True, False, True, None),    # deblocking only
    (64, 48, 2, 16, 10, True, False, False, None),
    (88, 72, 1, 16, 10, False, True, True, None),   # SAO only
    (96, 64, 3, 64, 12, False, True, False, None),
    (88, 72, 1, 16, 8, True, True, True, "top"),    # halo bands
    (96, 128, 2, 32, 10, True, True, True, "bottom"),
    (48, 64, 3, 16, 12, False, True, False, "top"),
]


def synthetic(W, H, fmt, cs, bd, dbk, sao, nofilter, band, seed=0):
    """(planes, control arrays, keywords) of `apply_filters_device` for a
    seeded synthetic picture: 8x8 blocks at levels a few tc apart with a
    little noise (every deblocking decision occurs), a few textured
    blocks, random int16 edge parameters, SAO parameters of every type
    and class, and, as asked, no-filter maps, the stale-read masks (CTB
    16 with both filters) and `ybounds`. A band keeps its first row of
    horizontal edges (the plain version pairs it with the band's last
    rows); a whole picture has none there, as `edge_params` makes it."""
    rng = np.random.default_rng(seed)
    hs, vs = SHIFTS[fmt]
    Hc, Wc = H >> vs, W >> hs
    maxv, up = (1 << bd) - 1, bd - 8

    def plane(h, w):
        lv = rng.integers(-4, 5, ((h + 7) // 8, (w + 7) // 8)) << up
        lv = np.cumsum(lv, 1) + (rng.integers(60, 190) << up)
        p = np.kron(lv, np.ones((8, 8), np.int64))[:h, :w]
        p = p + rng.integers(0, 3, (h, w))
        tex = np.kron(rng.random(lv.shape) < 0.1,
                      np.ones((8, 8), bool))[:h, :w]
        p = np.where(tex, rng.integers(0, maxv + 1, (h, w)), p)
        return torch.from_numpy(np.clip(p, 0, maxv).astype(np.int32))

    def edges(shape, table, hi, col0, row0, chroma=False):
        a = np.asarray(table)[rng.integers(hi // 2, hi, shape)] << up
        a = np.where(rng.random(shape) < (0.5 if chroma else 0.2), 0, a)
        if col0:
            a[:, 0] = 0
        if row0:
            a[0, :] = 0
        return a.astype(np.int16)

    def flags(shape, p=0.2):
        return (rng.random(shape) < p).astype(np.int16)

    z2 = np.zeros((1, 1), np.int16)
    s = dict(zip(F.EDGE_KEYS, F.edge_shapes(H, W, hs, vs)))
    a = dict.fromkeys(F.FARG_KEYS, z2)
    a["sao"] = np.zeros((1, 1, 3, 6), np.int16)
    if dbk:
        whole = band is None
        a.update(beta_v=edges(s["beta_v"], BETA_TABLE, 52, True, False),
                 tc_v=edges(s["tc_v"], TC_TABLE, 54, True, False),
                 beta_h=edges(s["beta_h"], BETA_TABLE, 52, False, whole),
                 tc_h=edges(s["tc_h"], TC_TABLE, 54, False, whole))
        for c in "12":
            a["tc_cv" + c] = edges(s["tc_cv1"], TC_TABLE, 54, True, False,
                                   True)
            a["tc_ch" + c] = edges(s["tc_ch1"], TC_TABLE, 54, False, whole,
                                   True)
        if nofilter:           # a segment's flags: its parameters' shape
            a.update({f"no{pq}_{d}": flags(s[f"tc_{d}" + "1" * (len(d) > 1)])
                      for pq in "pq" for d in ("v", "h", "cv", "ch")})
    if sao:
        cH, cW = -(-H // cs), -(-W // cs)
        p = np.zeros((cH, cW, 3, 6), np.int16)
        p[..., 0] = rng.integers(0, 3, (cH, cW, 3))
        p[..., 1] = np.where(p[..., 0] == 1, rng.integers(0, 32, (cH, cW, 3)),
                             rng.integers(0, 4, (cH, cW, 3)))
        p[..., 2:] = rng.integers(-15, 16, (cH, cW, 3, 4)) << min(up, 2)
        a["sao"] = p
        if dbk and cs == 16:
            a.update(st_b0=flags((Hc, Wc), 0.1), st_b2=flags((Hc, Wc), 0.1),
                     st_a3=flags((Hc, Wc), 0.1))
    if nofilter:
        a.update(nf4=flags((H >> 2, W >> 2)), nf4c=flags((H >> 2, W >> 2)))
    ybounds = None
    if band == "top":
        ybounds = ((-8, H - cs), (-8 >> vs, (H - cs) >> vs))
    elif band == "bottom":
        ybounds = ((cs, H + 8), (cs >> vs, (H + 8) >> vs))
    planes = [plane(H, W), plane(Hc, Wc), plane(Hc, Wc)]
    fargs = [torch.from_numpy(a[k]) for k in F.FARG_KEYS]
    kw = dict(bd=bd, bdc=bd, cs=cs, do_deblock=dbk, do_sao=sao, hs=hs,
              vs=vs)
    return planes, fargs, ybounds, kw


def launches_due(kw):
    """The kernels' launches of one `apply_filters_device` call."""
    return 2 * kw["do_deblock"] + kw["do_sao"]


def assert_planes_equal(got, want):
    for c, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.int32 and a.shape == b.shape, c
        assert torch.equal(a.cpu(), b.cpu()), (c, int((a.cpu() != b.cpu())
                                                      .sum()))


def test_cpu_call_runs_the_plain_version(one_thread):
    """On CPU tensors the wrapper gives the plain version's planes, with
    no launch (the `gpu` tests run the whole matrix)."""
    planes, fargs, yb, kw = synthetic(*MATRIX[1])
    before = F.apply_filters_device.launches
    got = F.apply_filters_device(*planes, *fargs, yb, **kw)
    assert F.apply_filters_device.launches == before == 0
    assert_planes_equal(got, F.apply_filters_ref(*planes, *fargs, yb, **kw))
    if kw["do_deblock"] or kw["do_sao"]:
        assert any(not torch.equal(a, b) for a, b in zip(got, planes))


@pytest.mark.parametrize("what", ["dtype", "param_dtype", "contiguous",
                                  "device", "depth", "shape", "ctb",
                                  "nop_v", "noq_ch", "st_b2", "st_a3"])
def test_wrapper_refuses_what_the_kernels_do_not_take(what):
    """MATRIX[1] has every no-filter map and the stale-read masks: a
    no-filter array is a (1, 1) placeholder or its tc array's shape, the
    three masks all placeholders or all the chroma planes' shape."""
    planes, fargs, yb, kw = synthetic(*MATRIX[1])
    at = F.FARG_KEYS.index
    err = ValueError
    if what == "dtype":
        planes[0], err = planes[0].to(torch.int64), TypeError
    elif what == "param_dtype":
        fargs[1], err = fargs[1].to(torch.int32), TypeError
    elif what == "contiguous":                  # columns not adjacent
        planes[1] = planes[1].T.contiguous().T
    elif what == "device":
        fargs[8] = fargs[8].to("meta")
    elif what == "depth":
        kw["bd"] = 7
    elif what == "shape":
        fargs[0] = fargs[0][:, :-1].contiguous()
    elif what == "ctb":
        kw["cs"] = 8
    elif what in ("nop_v", "noq_ch"):           # neither its tc's nor (1, 1)
        fargs[at(what)] = fargs[at(what)][:-1].contiguous()
    elif what == "st_b2":
        fargs[at(what)] = fargs[at(what)][:, :-1].contiguous()
    else:                                       # one placeholder of three
        fargs[at(what)] = torch.zeros((1, 1), dtype=torch.int16)
    with pytest.raises(err):
        F.apply_filters_device(*planes, *fargs, yb, **kw)
    assert F.apply_filters_device.launches == 0


def test_engine_spans_say_the_plain_version_filtered():
    """A CPU decode: every `deblock` and `sao` span carries kernel 0."""
    pics, _ = profiled(lambda: decode(Decoder(device="cpu"), aus(FILTERED)))
    got = [s for s in trace.spans() if s.name in ("deblock", "sao")]
    assert len(got) >= len(pics) == 2
    assert {s.name for s in got} == {"deblock", "sao"}
    assert all(s.attrs == {"kernel": 0} for s in got)
    assert F.apply_filters_device.launches == 0


def test_reader_of_the_spans_counts_the_kernel_route(monkeypatch):
    """benchmark/metrics/filters_on_card.batch.py: the share of `deblock`
    and `sao` spans with kernel 1, None without one."""
    monkeypatch.syspath_prepend(os.path.join(ROOT, "benchmark"))
    from hevcbench import manifest
    from hevcbench.readings import Readings
    read = manifest.reader(ROOT, "filters_on_card.batch")
    entry = {m["name"]: m for m in manifest.load(ROOT)["per_layer"]}[
        "filters_on_card.batch"]
    assert entry["moves"] == "fps" and entry["workloads"] == [
        "ra1080_batch", "ra2160_batch"]
    assert entry["source"] == "program_counter"
    assert entry["layer"] == "torch-op stages (ops/mc.py, ops/filters.py)"
    held = {"spans": []}
    monkeypatch.setattr(trace, "spans", lambda: list(held["spans"]))
    monkeypatch.setattr(trace, "clear", lambda: held.update(spans=[]))

    def sp(name, **attrs):
        return SimpleNamespace(name=name, id=1, parent=None, pic=(0, 0),
                               attrs=attrs, tid=1, start_ns=0, end_ns=1)

    held["spans"] = [sp("reconstruct"), sp("deblock", kernel=1),
                     sp("sao", kernel=1), sp("edge_params", kernel=0)]
    assert read(Readings(window_s=1.0)) == pytest.approx(100.0)
    held["spans"] = [sp("deblock", kernel=0), sp("sao", kernel=0)]
    assert read(Readings(window_s=1.0)) == pytest.approx(0.0)
    held["spans"] = [sp("reconstruct"), sp("edge_params", kernel=1)]
    assert read(Readings(window_s=1.0)) is None
    assert read(Readings(window_s=1.0)) is None       # nothing recorded


@pytest.mark.gpu
def test_kernels_equal_the_plain_version_on_the_matrix(cuda):
    """Each case on the card: the kernels == the plain version (run on
    the card too), in 2 * deblock + SAO launches; a second call gives
    identical planes; the planes passed in are left as they were."""
    for case in MATRIX:
        planes, fargs, yb, kw = synthetic(*case)
        planes = [p.cuda() for p in planes]
        fargs = [a.cuda() for a in fargs]
        kept = [p.clone() for p in planes]
        before = F.apply_filters_device.launches
        got = F.apply_filters_device(*planes, *fargs, yb, **kw)
        again = F.apply_filters_device(*planes, *fargs, yb, **kw)
        want = F.apply_filters_ref(*planes, *fargs, yb, **kw)
        torch.cuda.synchronize()
        assert F.apply_filters_device.launches - before == \
            2 * launches_due(kw), case
        assert all(a.device.type == "cuda" for a in got)
        assert_planes_equal(got, want)
        assert_planes_equal(again, want)
        assert_planes_equal(planes, kept)


def filtered_calls(path, n=None):
    """Decode the first n pictures of a stream on the card (all with
    None), holding every `apply_filters_device` call of the engine's
    filter plan (`FilterPlan.apply` calls it by its name in
    ops/filters.py) to the plain version on the same arguments, with the
    stated launches. Returns (pictures decoded, calls held)."""
    from bench_torch import first_frames
    with open(path, "rb") as f:
        data = f.read()
    if n is not None:
        data = first_frames(data, n)
    held = []
    real = F.apply_filters_device

    def spy(*args, **kw):
        before = real.launches
        got = real(*args, **kw)
        assert real.launches - before == launches_due(kw)
        ref = dict(kw, stage=F.contextlib.nullcontext)
        assert_planes_equal(got, F.apply_filters_ref(*args, **ref))
        held.append(launches_due(kw))
        return got

    F.apply_filters_device = spy
    try:
        dec = Decoder(device="cuda")
        pics = dec.decode(data) + dec.flush()
    finally:
        F.apply_filters_device = real
    return pics, held


@pytest.mark.gpu
def test_kernels_equal_the_plain_version_on_the_benchmark_streams(cuda):
    """Every filtered picture of the 1080p stream (deblocking and SAO on
    every one) and the first picture of the 4K 10-bit stream: the
    kernels == the plain version, three launches each; the 1080p decode
    md5-exact."""
    from bench_torch import hash_pics
    pics, held = filtered_calls(RA_1080P)
    with open(RA_1080P + ".md5") as f:
        assert hash_pics(pics) == f.read().split()
    assert held == [3] * len(pics) == [3] * 33
    pics, held = filtered_calls(RA_2160P, 1)
    assert held == [3] and pics[0].planes.device_filtered
