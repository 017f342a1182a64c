"""Port level schedule: the wavefront level of every intra job, the
order and bounds the level-parallel kernels run by (`level_schedule`),
and the plain versions run level by level (each level's jobs all read
the planes before any of them stores, as the kernel's warps may).

Held against: the dependency invariant itself (every available
neighbour of a job was written by a job of a strictly lower level); the
JAX package's own per-level schedule (`_pack_from_raw`) on the same
parse; the plain versions in decode order; `Decoder("np")` and
`Decoder("jax")` on whole streams. The CUDA kernels run only with a card
(marker `gpu`). Tolerance: none (integer samples, exact equality)."""
import numpy as np
import pytest
import torch

from test_torch_banded import (_banded_planes, _case10, _force_banded)
from test_torch_intra import (_fused, _np_planes, _strong_encoder,
                              cuda)  # noqa: F401  (cuda is a fixture)
from test_torch_parse import encode, parsed_jax, parsed_port

# intra streams of the repo's own encoder: WPP (substream threads fill
# the level map), tiles, PCM (prefilled samples, level 0), 32x32 TUs
# with strong smoothing, 8 and 10 bit
CASES = {
    "plain": dict(W=64, H=64, qp=30, ctb_log2=4),
    "wpp": dict(W=128, H=64, qp=30, ctb_log2=4, wpp=True),
    "tiles": dict(W=128, H=64, qp=30, ctb_log2=4, tile_cols=2, tile_rows=2),
    "wpp_tiles": dict(W=128, H=64, qp=28, ctb_log2=4, wpp=True,
                      tile_cols=2),
    "pcm": dict(W=64, H=64, qp=26, ctb_log2=4, pcm=True),
    "dct32_strong": dict(W=128, H=64, qp=37, ctb_log2=6, strong=True),
    "noise_ctb32": dict(W=64, H=64, qp=6, ctb_log2=5, smooth=False),
    "ten_bit": None,            # test_torch_banded's 10-bit ctb4 stream
    "ten_bit_wpp": None,        # ... and its WPP 128x64 CTB 64 stream
}
CTB = {"dct32_strong": 64, "noise_ctb32": 32, "ten_bit_wpp": 64}


def _stream(name, monkeypatch, n=2):
    if name == "ten_bit":
        return _case10("ctb4", n=n)[0]
    if name == "ten_bit_wpp":
        return _case10("wpp_dct32", n=n)[0]
    kw = dict(CASES[name])
    if kw.pop("strong", False):
        _strong_encoder(monkeypatch)
    return encode(kw.pop("W"), kw.pop("H"), n=n, seed=5, **kw)[0]


def _constrained_intra_stream():
    """IDR + two P pictures with constrained_intra_pred: intra CUs beside
    inter ones, whose samples are unavailable to them."""
    from conftest import make_frames
    from openhevc_tpu.encoder.inter_enc import encode_lowdelay_stream
    frames = make_frames(64, 64, 3, np.random.default_rng(1))
    return encode_lowdelay_stream(frames, 64, 64, qp=32, ctb_log2=4,
                                  seed=101, constrained_intra=True)[0]


def _inter_stream(name):
    """Low-delay / hierarchical-B streams of tests/test_torch_inter.py:
    intra TUs beside inter samples, which no job writes; "all_inter" has
    pictures with no intra job at all."""
    import test_torch_inter as ti
    if name == "all_inter":
        return ti._all_inter_stream()
    return ti.stream({"inter": "p", "inter_ra_wpp": "ra_tmvp_wpp",
                      "inter_tiles": "ra_tiles"}[name])


INTER_CASES = ["inter", "inter_ra_wpp", "inter_tiles", "all_inter"]


def _ref_coords(x, y, s):
    """(xs, ys) of the 4s+1 reference samples in spec order."""
    i = np.arange(2 * s)
    xs = np.concatenate([np.full(2 * s, x - 1), [x - 1], x + i])
    ys = np.concatenate([y + 2 * s - 1 - i, [y - 1], np.full(2 * s, y - 1)])
    return xs, ys


# ---- (a) the dependency invariant ---------------------------------------

@pytest.mark.parametrize("name", sorted(CASES) + ["constrained_intra"] +
                         INTER_CASES)
def test_available_neighbours_are_of_lower_levels(name, monkeypatch):
    """No job of a level reads what another job of that level writes:
    every neighbour sample marked available in `ij_avail` lies in a
    block written by an earlier job of a strictly lower level, or by no
    job at all (level 0: PCM samples and, in inter pictures, inter
    samples: both are in the planes before the kernel starts, which is
    why the prefill must be complete by then). Under constrained intra
    prediction the samples of inter blocks must be unavailable."""
    if name in INTER_CASES:
        data = _inter_stream(name)
    else:
        data = _constrained_intra_stream() if name == "constrained_intra" \
            else _stream(name, monkeypatch)
    fss = parsed_port(data)
    checked = level0 = unwritten = no_jobs = 0
    for fs in fss:
        im, iav = fs.native_raw["ij_meta"], fs.native_raw["ij_avail"]
        if not len(im):
            # an all-inter picture: no job, no level, an empty schedule
            assert fs.inter_pbs and fs.native_raw["n_levels"] == 0
            assert fs.native_pack["n"] == 0
            assert not fs.native_pack["meta6"][5].any()
            no_jobs += 1
            continue
        assert fs.native_raw["n_levels"] == im[:, 6].max()
        assert im[:, 6].min() >= 1
        H, W = fs.sps.height, fs.sps.width
        dims = [(H, W)] + [(H >> fs.sps.vshift1, W >> fs.sps.hshift1)] * 2
        writer_level = [np.zeros(d, np.int32) for d in dims]
        writer_job = [np.full(d, -1, np.int32) for d in dims]
        for j, (plane, x, y, s, _mode, _f, lvl, _) in enumerate(im.tolist()):
            assert (writer_job[plane][y:y + s, x:x + s] == -1).all()
            writer_level[plane][y:y + s, x:x + s] = lvl
            writer_job[plane][y:y + s, x:x + s] = j
        for j, (plane, x, y, s, _mode, _f, lvl, _) in enumerate(im.tolist()):
            xs, ys = _ref_coords(x, y, s)
            av = iav[j, :4 * s + 1] != 0
            ph, pw = dims[plane]
            assert ((xs[av] >= 0) & (ys[av] >= 0) & (xs[av] < pw) &
                    (ys[av] < ph)).all()
            wl = writer_level[plane][ys[av], xs[av]]
            wj = writer_job[plane][ys[av], xs[av]]
            assert (wl < lvl).all(), (fs.poc, j)
            assert (wj < j).all(), (fs.poc, j)
            # the level is tight: 1 + the highest level it depends on
            assert lvl == 1 + (wl.max() if av.any() else 0), (fs.poc, j)
            checked += int(av.sum())
            level0 += int((wj == -1).sum())
            if name in INTER_CASES:
                # what no job wrote is an inter block's prediction
                sh = (0, 0) if plane == 0 else (fs.sps.vshift1,
                                                fs.sps.hshift1)
                pf = fs.motion.pred_flag[(ys[av] << sh[0]) >> 2,
                                         (xs[av] << sh[1]) >> 2]
                assert (pf[wj == -1] > 0).all(), (fs.poc, j)
                assert (pf[wj >= 0] == 0).all(), (fs.poc, j)
            inside = (xs >= 0) & (ys >= 0) & (xs < pw) & (ys < ph) & ~av
            unwritten += int((writer_job[plane][ys[inside], xs[inside]]
                              == -1).sum())
    assert checked > 0
    if name == "pcm" or name in INTER_CASES:
        assert level0 > 0, "no available neighbour outside the jobs"
    else:
        assert level0 == 0
    assert (no_jobs > 0) == (name == "all_inter")
    if name == "constrained_intra":
        assert unwritten > 0, "no intra job beside an inter block"


# ---- (b) the JAX package's own schedule ----------------------------------

def _jax_level_sets(fs):
    """Per level, the set of (plane, x, y, size, mode) the JAX package's
    packer schedules there."""
    from openhevc_tpu.models.pipeline import _pack_from_raw
    _res, intra, n_levels = _pack_from_raw(fs)
    out = []
    for steps in intra["order"]:
        jobs = set()
        for key, idx, s in steps:
            a = {k: v[idx] for k, v in intra["stacked"][key].items()}
            for i in np.nonzero(a["valid"])[0]:
                jobs.add((int(a["plane"][i]), int(a["x"][i]),
                          int(a["y"][i]), s, int(a["mode"][i])))
        out.append(jobs)
    assert len(out) == n_levels
    return out


def _port_level_sets(fs, k):
    """Per level, the set of (plane, x, y, size, mode) of prepare()'s
    schedule k, read back from the kernel meta."""
    from openhevc_tpu_torch.ops.intra_fused import OX, OY
    meta = k["meta"].numpy()
    order = k["order"].numpy()
    b = k["level_bounds"].tolist()
    out = []
    for lo, hi in zip(b, b[1:]):
        m = meta[:, order[lo:hi]]
        out.append({(int(p), int(x) - OX, int(y) - OY, 4 << int(sl), int(md))
                    for y, x, sl, md, p in m[:5].T.tolist()})
        assert len(out[-1]) == hi - lo
    return out


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_level_sets_match_the_jax_schedule(name, banded, monkeypatch):
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    data = _stream(name, monkeypatch)
    port, ref = parsed_port(data), parsed_jax(data)
    if banded:
        _force_banded(monkeypatch, port[0].sps.width, CTB.get(name, 16))
    assert len(port) == len(ref) == 2
    for a, b in zip(port, ref):
        k = TorchEngine("cpu").prepare(a)
        assert (k["bounds"] is not None) == banded
        got, want = _port_level_sets(a, k), _jax_level_sets(b)
        assert len(got) == len(want) == a.native_raw["n_levels"]
        assert got == want
        assert all(got)               # no level is empty


# ---- (c) level order == decode order == the reference decoders -----------

def _decode(dec, data):
    return [[np.asarray(c) for c in p.cropped()]
            for p in dec.decode(data) + dec.flush()]


_WANT = {}      # name -> the JAX package's decodes (the slow part), kept
                # for the banded twin of the same case


def _reference_decodes(name, data):
    from openhevc_tpu.decoder import Decoder as RefDecoder
    if name not in _WANT:
        _WANT[name] = (_np_planes(data), _decode(RefDecoder("jax"), data))
    return _WANT[name]


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_level_order_equals_decode_order_and_decoders(name, banded,
                                                      monkeypatch):
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.ops.intra_fused import (intra_fused,
                                                    intra_fused_banded,
                                                    intra_fused_banded_ref,
                                                    intra_fused_ref)
    data = _stream(name, monkeypatch)
    fss = parsed_port(data)
    want_np, want_jax = _reference_decodes(name, data)
    if banded:
        _force_banded(monkeypatch, fss[0].sps.width, CTB.get(name, 16))
    whole = _decode(Decoder(device="cpu"), data)
    assert len(fss) == len(want_np) == len(want_jax) == len(whole) == 2
    for fs, w_np, w_jax, w_dec in zip(fss, want_np, want_jax, whole):
        if banded:
            runs = [_banded_planes(fs, intra_fused_banded_ref),
                    _banded_planes(fs, intra_fused_banded_ref, levels=True),
                    _banded_planes(fs, intra_fused_banded, levels=True)]
        else:
            runs = [_fused(fs, "cpu", intra_fused_ref),
                    _fused(fs, "cpu", intra_fused_ref, levels=True),
                    _fused(fs, "cpu", intra_fused, levels=True)]
        for got in runs + [w_dec]:
            for c in range(3):
                assert np.array_equal(got[c], w_np[c]), (fs.poc, c)
                assert np.array_equal(got[c], w_jax[c]), (fs.poc, c)


def test_level_order_run_detects_a_wrong_schedule(monkeypatch):
    """The level-by-level plain version has teeth: with every job put in
    one level (all read before any stores) the planes come out wrong."""
    from openhevc_tpu_torch.models.pipeline import TorchEngine, crop_pack
    from openhevc_tpu_torch.ops.intra_fused import intra_fused_ref
    fs = parsed_port(_stream("plain", monkeypatch, n=1))[0]
    outs = []
    for one_level in (False, True):
        k = TorchEngine("cpu").prepare(fs)
        lb = torch.tensor([0, k["n"]], dtype=torch.int32) if one_level \
            else k["level_bounds"]
        intra_fused_ref(k["meta"], k["n"], k["luma"], k["chroma"],
                        k["res_l"], k["res_c"], k["bd"], k["order"], lb)
        outs.append(crop_pack(k["luma"], k["chroma"], *k["dims"], k["bd"]))
    assert not torch.equal(outs[0], outs[1])


# ---- (d) the schedule's shape and the wrappers' checks --------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_level_schedule_shape(name, monkeypatch):
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops.intra_fused import level_schedule
    for fs in parsed_port(_stream(name, monkeypatch)):
        npk, n_levels = fs.native_pack, fs.native_raw["n_levels"]
        n = npk["n"]
        lv = fs.native_raw["ij_meta"][:, 6]
        assert npk["meta6"].shape[0] == 6 and npk["meta6"].dtype == np.int16
        assert npk["meta"].base is not None and npk["meta"].shape[0] == 5
        assert npk["meta"].flags["C_CONTIGUOUS"]
        assert np.array_equal(npk["meta6"][:5], npk["meta"])
        assert np.array_equal(npk["meta6"][5, :n], lv)
        assert not npk["meta6"][5, n:].any()
        k = TorchEngine("cpu").prepare(fs)
        order, lb = k["order"], k["level_bounds"]
        assert order.dtype == lb.dtype == torch.int32
        assert order.shape == (n,) and lb.shape == (n_levels + 1,)
        b = lb.tolist()
        assert b[0] == 0 and b[-1] == n and all(
            p < q for p, q in zip(b, b[1:]))
        assert np.array_equal(order.numpy(), np.argsort(lv, kind="stable"))
        assert np.array_equal(
            lb.numpy(), np.searchsorted(np.sort(lv), np.arange(
                1, n_levels + 2)))
        o2, b2 = level_schedule(torch.from_numpy(lv.copy()), n, n_levels)
        assert torch.equal(o2, order) and torch.equal(b2, lb)


def test_level_schedule_of_no_jobs():
    from openhevc_tpu_torch.ops.intra_fused import (level_schedule,
                                                    sort_meta_by_band)
    order, lb = level_schedule(torch.zeros(8, dtype=torch.int16), 0, 0)
    assert order.shape == (0,) and lb.tolist() == [0]
    assert order.dtype == lb.dtype == torch.int32
    # ... and of a real all-inter picture, band sorted or not
    fss = [fs for fs in parsed_port(_inter_stream("all_inter"))
           if fs.native_pack["n"] == 0]
    assert len(fss) == 2
    for fs in fss:
        m6 = fs.native_pack["meta6"]
        sorted6, bounds = sort_meta_by_band(m6, 0, 16, 1, 2)
        assert sorted6 is m6 and bounds.tolist() == [0, 0, 0]
        order, lb = level_schedule(torch.from_numpy(m6[5]), 0,
                                   fs.native_raw["n_levels"])
        assert order.shape == (0,) and lb.tolist() == [0]


def _wrapper_args():
    meta = torch.zeros((16, 8), dtype=torch.int32)
    luma = torch.zeros((64, 512), dtype=torch.int32)
    chroma = torch.zeros((2, 64, 512), dtype=torch.int32)
    return meta, (luma, chroma, luma, chroma, 8)


BAD_SCHEDULES = {
    "bounds_start": ([0, 1, 2, 3], [1, 2, 4], ValueError),
    "bounds_end": ([0, 1, 2, 3], [0, 2, 3], ValueError),
    "bounds_fall": ([0, 1, 2, 3], [0, 3, 2, 4], ValueError),
    "bounds_past_n": ([0, 1, 2, 3], [0, 5], ValueError),
    "bounds_empty": ([0, 1, 2, 3], [], ValueError),
    "order_short": ([0, 1, 2], [0, 2, 4], ValueError),
    "order_long": ([0, 1, 2, 3, 3], [0, 2, 4], ValueError),
    "order_repeats": ([0, 1, 1, 3], [0, 2, 4], ValueError),
    "order_negative": ([0, 1, -1, 3], [0, 2, 4], ValueError),
    "order_past_n": ([0, 1, 2, 4], [0, 2, 4], ValueError),
    "order_int64": (torch.arange(4), [0, 2, 4], TypeError),
    "bounds_int64": ([0, 1, 2, 3], torch.tensor([0, 2, 4]), TypeError),
    "order_2d": (torch.zeros((2, 2), dtype=torch.int32), [0, 2, 4],
                 ValueError),
    "bounds_2d": ([0, 1, 2, 3], torch.tensor([[0, 4]], dtype=torch.int32),
                  ValueError),
    "order_strided": (torch.tensor([0, 9, 1, 9, 2, 9, 3, 9],
                                   dtype=torch.int32)[::2],
                      [0, 2, 4], ValueError),
}


@pytest.mark.parametrize("entry", ["whole", "banded"])
@pytest.mark.parametrize("case", sorted(BAD_SCHEDULES))
def test_wrappers_reject_bad_level_arguments(case, entry):
    from openhevc_tpu_torch.ops.intra_fused import (intra_fused,
                                                    intra_fused_banded)
    meta, planes = _wrapper_args()
    order, lb, exc = BAD_SCHEDULES[case]
    if not isinstance(order, torch.Tensor):
        order = torch.tensor(order, dtype=torch.int32)
    if not isinstance(lb, torch.Tensor):
        lb = torch.tensor(lb, dtype=torch.int32)
    with pytest.raises(exc):
        if entry == "whole":
            intra_fused(meta, 4, *planes, order, lb)
        else:
            intra_fused_banded(meta, torch.tensor([0, 4], dtype=torch.int32),
                               4, *planes, order, lb)


def test_schedule_checks_read_no_values_off_the_cpu():
    """Off the CPU the wrappers' checks look at dtype, shape and layout
    only: tensors on the meta device have no values to read."""
    from openhevc_tpu_torch.ops.intra_fused import (_check_schedule,
                                                    _check_vector)
    dev = torch.device("meta")
    order = torch.zeros(4, dtype=torch.int32, device=dev)
    lb = torch.zeros(3, dtype=torch.int32, device=dev)
    _check_schedule(order, lb, 4, dev)
    _check_vector("bounds", lb, 4, dev)
    with pytest.raises(ValueError):
        _check_schedule(order[:3], lb, 4, dev)
    with pytest.raises(TypeError):
        _check_vector("bounds", lb.long(), 4, dev)


def test_check_rising():
    from openhevc_tpu_torch.ops.intra_fused import check_rising
    check_rising([0, 0, 3, 3], 3, "b")
    check_rising(np.array([0], np.int32), 0, "b")
    for bad in ([], [1, 3], [0, 2], [0, 2, 1, 3]):
        with pytest.raises(ValueError, match="rise from 0 to n=3"):
            check_rising(bad, 3, "b")


def test_prepare_and_reconstruct_read_nothing_back(monkeypatch):
    """The main path makes no device-to-host read between the upload and
    the output: no .tolist() / .item() / .cpu() / .numpy() on a tensor
    in prepare + reconstruct up to the kernel's wrapper (the CPU run
    stands in for the card; the wrapper itself is stubbed, since on CPU
    tensors it checks values and runs the plain version, which read)."""
    from openhevc_tpu_torch.models import pipeline
    fs = parsed_port(_stream("plain", monkeypatch, n=1))[0]
    _force_banded(monkeypatch, 64, 16)
    ran = []
    monkeypatch.setattr(pipeline, "intra_fused_banded",
                        lambda *a, **kw: ran.append(a))
    reads = []
    for name in ("tolist", "item", "cpu", "numpy"):
        def spy(self, *a, _name=name, **kw):
            reads.append(_name)
            raise AssertionError(f"Tensor.{_name}() on the main path")
        monkeypatch.setattr(torch.Tensor, name, spy)
    pipeline.TorchEngine("cpu").reconstruct(fs)
    assert len(ran) == 1 and not reads


# ---- (e) the CUDA kernels (need a card) -----------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_level_parallel_kernels_match_plain_and_serial(name, banded,
                                                       monkeypatch, cuda):
    """Level-parallel kernel == serial-order kernel == plain version in
    decode order, ten launches in a row giving the same planes."""
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops.intra_fused import (intra_fused,
                                                    intra_fused_banded,
                                                    intra_fused_banded_ref,
                                                    intra_fused_ref,
                                                    intra_fused_serial)
    fss = parsed_port(_stream(name, monkeypatch))
    if banded:
        _force_banded(monkeypatch, fss[0].sps.width, CTB.get(name, 16))
    for fs in fss:
        k = TorchEngine(cuda).prepare(fs)
        tail = (k["res_l"], k["res_c"], k["bd"])
        sched = (k["order"], k["level_bounds"])

        def run(fn, *extra, lead=()):
            luma, chroma = k["luma"].clone(), k["chroma"].clone()
            fn(k["meta"], *lead, k["n"], luma, chroma, *tail, *extra)
            torch.cuda.synchronize()
            return luma, chroma

        if banded:
            lead = (k["bounds"],)
            fn, before = intra_fused_banded, intra_fused_banded.launches
            plain = run(intra_fused_banded_ref, lead=lead)
        else:
            lead = ()
            fn, before = intra_fused, intra_fused.launches
            plain = run(intra_fused_ref)
        s0 = intra_fused_serial.launches
        serial = run(intra_fused_serial)
        assert intra_fused_serial.launches == s0 + 1
        for _ in range(10):
            got = run(fn, *sched, lead=lead)
            for g, s, p in zip(got, serial, plain):
                assert torch.equal(g, s) and torch.equal(g, p)
        assert fn.launches == before + 10


@pytest.mark.gpu
def test_kernel_refuses_a_grid_that_is_not_coresident(monkeypatch, cuda):
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops.intra_fused import intra_fused
    fs = parsed_port(_stream("plain", monkeypatch, n=1))[0]
    k = TorchEngine(cuda).prepare(fs)
    args = (k["meta"], k["n"], k["luma"], k["chroma"], k["res_l"],
            k["res_c"], k["bd"], k["order"], k["level_bounds"])
    before = intra_fused.launches
    for grid in (0, 1 << 20):
        with pytest.raises(ValueError, match="co-resident"):
            intra_fused(*args, grid=grid)
    assert intra_fused.launches == before
    intra_fused(*args, grid=1)
    torch.cuda.synchronize()
    assert intra_fused.launches == before + 1
