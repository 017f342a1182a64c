"""Port inter prediction, function by function: the same seeded numpy
inputs through the JAX package's ops/mc.py + models/pipeline.py (plain
XLA, which runs on the CPU) and the port's ops/mc.py +
models/pipeline.py. 8 and 10 bit, luma and chroma, MVs pointing far
outside the picture, weighted and unweighted, tap mode and pair mode.
Tolerance: none (integers, exact equality)."""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openhevc_tpu.models import pipeline as jax_pl
from openhevc_tpu.ops import mc as jax_mc
from openhevc_tpu_torch.models import pipeline as port_pl
from openhevc_tpu_torch.ops import mc as port_mc

PLANES = [(8, True), (8, False), (10, True), (10, False)]


def _plane(rng, H, W, bd, extreme=False):
    """A reference plane; with extreme=True only the extreme samples, in
    the pattern that drives the filter taps furthest."""
    maxv = (1 << bd) - 1
    if extreme:
        return (rng.integers(0, 2, (H, W)) * maxv).astype(np.int32)
    return rng.integers(0, maxv + 1, (H, W)).astype(np.int32)


def _motion(rng, h4, w4, R, far=True):
    """(mv4 [h4, w4, 2] int16, slot4 [h4, w4]) with a share of MVs far
    outside the picture in every direction."""
    mv = rng.integers(-70, 70, (h4, w4, 2))
    if far:
        big = rng.random((h4, w4)) < 0.3
        mv[big] = rng.integers(-3000, 3000, (int(big.sum()), 2))
        mv[0, 0] = (-32768, 32767)
        mv[-1, -1] = (32767, -32768)
    return mv.astype(np.int16), rng.integers(0, R, (h4, w4)).astype(np.uint8)


def test_filter_tables_match():
    from openhevc_tpu.ops.mc_np import EPEL_FILTERS, QPEL_FILTERS
    from openhevc_tpu_torch.ops import tables
    assert np.array_equal(tables.QPEL_FILTERS, QPEL_FILTERS)
    assert np.array_equal(tables.EPEL_FILTERS, EPEL_FILTERS)
    assert np.array_equal(port_mc._QPEL_ALL, jax_mc._QPEL_ALL)
    assert np.array_equal(port_mc._EPEL_ALL, jax_mc._EPEL_ALL)
    assert port_mc.PAD == jax_mc.PAD


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("bd,is_luma", PLANES)
def test_mc_hprefilter_matches_jax(bd, is_luma, extreme):
    rng = np.random.default_rng(bd + is_luma)
    ref = _plane(rng, 24, 40, bd, extreme)
    want = np.asarray(jax_mc.mc_hprefilter(jnp.asarray(ref), bit_depth=bd,
                                           is_luma=is_luma))
    got = port_mc.mc_hprefilter(torch.from_numpy(ref), bd, is_luma)
    assert got.dtype == torch.int16
    assert got.shape == port_mc.stage1_shape(24, 40, is_luma, False)
    assert np.array_equal(got.numpy(), want)
    out = torch.zeros((3,) + got.shape, dtype=torch.int16)
    port_mc.mc_hprefilter(torch.from_numpy(ref), bd, is_luma, out=out[1])
    assert torch.equal(out[1], got) and not out[0].any() and not out[2].any()


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("bd,is_luma", PLANES)
def test_mc_prefilter_pairs_matches_jax(bd, is_luma, extreme):
    rng = np.random.default_rng(10 + bd + is_luma)
    ref = _plane(rng, 24, 40, bd, extreme)
    want = np.asarray(jax_mc.mc_prefilter_pairs(
        jnp.asarray(ref), bit_depth=bd, is_luma=is_luma))
    got = port_mc.mc_prefilter_pairs(torch.from_numpy(ref), bd, is_luma)
    assert got.dtype == torch.int16
    assert got.shape == port_mc.stage1_shape(24, 40, is_luma, True)
    assert np.array_equal(got.numpy(), want)
    out = torch.zeros((2,) + got.shape, dtype=torch.int16)
    port_mc.mc_prefilter_pairs(torch.from_numpy(ref), bd, is_luma,
                               out=out[1])
    assert torch.equal(out[1], got) and not out[0].any()


def test_stage1_int16_conversion_wraps():
    """Stage 1 stores int16: a sum beyond its range wraps (as the
    reference's int16 store does), it does not saturate. No legal sample
    reaches the range's end (test above: extreme 10-bit samples), so the
    conversion itself is pinned here."""
    acc = torch.tensor([40000, -40000, 32767, -32768, 65536 + 5],
                       dtype=torch.int32)
    want = [40000 - 65536, 65536 - 40000, 32767, -32768, 5]
    assert acc.to(torch.int16).tolist() == want
    out = torch.zeros(5, dtype=torch.int16)
    assert out.copy_(acc).tolist() == want
    assert np.asarray(jnp.asarray(acc.numpy()).astype(jnp.int16)) \
        .tolist() == want


def _stacks(rng, R, H, W, bd, is_luma):
    refs = [_plane(rng, H, W, bd) for _ in range(R)]
    hf = np.stack([np.asarray(jax_mc.mc_hprefilter(
        jnp.asarray(r), bit_depth=bd, is_luma=is_luma)) for r in refs])
    pp = np.stack([np.asarray(jax_mc.mc_prefilter_pairs(
        jnp.asarray(r), bit_depth=bd, is_luma=is_luma)) for r in refs])
    return hf, pp


@pytest.mark.parametrize("bd,is_luma,hs,vs", [
    (bd, lum, hs, vs) for bd, lum in PLANES
    for hs, vs in ([(1, 1)] if lum else [(1, 1), (1, 0), (0, 0)])])
def test_mc_put_matches_jax_in_both_modes(bd, is_luma, hs, vs):
    """Stage 2, tap mode and pair mode, vs the JAX package's; and the two
    modes agree. The chroma cases cover 4:2:0, 4:2:2 and 4:4:4 phases."""
    rng = np.random.default_rng(20 + bd + is_luma + 2 * hs + vs)
    h4, w4, R = 6, 10, 2
    H, W = (h4 * 4, w4 * 4) if is_luma else (h4 * 4 >> vs, w4 * 4 >> hs)
    hf, pp = _stacks(rng, R, H, W, bd, is_luma)
    mv4, slot4 = _motion(rng, h4, w4, R)
    kw = dict(bit_depth=bd, is_luma=is_luma, hs=hs, vs=vs, H=H, W=W)
    want = np.asarray(jax_mc.mc_put_core(
        jnp.asarray(hf), jnp.asarray(mv4), jnp.asarray(slot4), **kw))
    want_p = np.asarray(jax_mc.mc_put_pairs_core(
        jnp.asarray(pp), jnp.asarray(mv4), jnp.asarray(slot4), **kw))
    got = port_mc.mc_put_core(torch.from_numpy(hf), torch.from_numpy(mv4),
                              torch.from_numpy(slot4), **kw)
    got_p = port_mc.mc_put_pairs_core(
        torch.from_numpy(pp), torch.from_numpy(mv4),
        torch.from_numpy(slot4), **kw)
    assert got.dtype == got_p.dtype == torch.int32
    assert np.array_equal(want, want_p)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got_p.numpy(), want)


def test_mc_put_matches_the_numpy_oracle():
    """Stage 1 + 2 against the JAX package's scalar oracle (ops/mc_np.py)
    block by block, MVs reaching outside the picture."""
    from openhevc_tpu.ops.mc_np import epel_put, qpel_put
    rng = np.random.default_rng(7)
    H, W, bd = 32, 48, 8
    luma, chroma = _plane(rng, H, W, bd), _plane(rng, H // 2, W // 2, bd)
    mv4, _ = _motion(rng, H // 4, W // 4, 1)
    mv4 = np.clip(mv4, -400, 400)
    slot4 = np.zeros((H // 4, W // 4), np.uint8)
    for is_luma, plane in ((True, luma), (False, chroma)):
        ph, pw = plane.shape
        hf = port_mc.mc_hprefilter(torch.from_numpy(plane), bd, is_luma)[None]
        got = port_mc.mc_put_core(hf, torch.from_numpy(mv4),
                                  torch.from_numpy(slot4), bit_depth=bd,
                                  is_luma=is_luma, hs=1, vs=1, H=ph,
                                  W=pw).numpy()
        b = 4 if is_luma else 2
        for by in range(H // 4):
            for bx in range(W // 4):
                mx, my = int(mv4[by, bx, 0]), int(mv4[by, bx, 1])
                fn = qpel_put if is_luma else epel_put
                want = fn(plane.astype(np.int64), bx * b, by * b, b, b, mx,
                          my, bd)
                assert np.array_equal(
                    got[by * b:(by + 1) * b, bx * b:(bx + 1) * b], want)


def test_mc_put_clamps_slot_and_indexes_in_int64():
    """torch raises on an out-of-range index where JAX clamps: a slot
    beyond the stack reads the last reference, and the per-pixel indices
    are int64 (the pair planes of a few 4K references hold more than
    2^31 samples)."""
    rng = np.random.default_rng(3)
    hf, pp = _stacks(rng, 2, 16, 16, 8, True)
    mv4, _ = _motion(rng, 4, 4, 2)
    kw = dict(bit_depth=8, is_luma=True, hs=1, vs=1, H=16, W=16)
    over = torch.full((4, 4), 9, dtype=torch.int32)
    last = torch.ones((4, 4), dtype=torch.int32)
    for fn, stack in ((port_mc.mc_put_core, hf),
                      (port_mc.mc_put_pairs_core, pp)):
        a = fn(torch.from_numpy(stack), torch.from_numpy(mv4), over, **kw)
        b = fn(torch.from_numpy(stack), torch.from_numpy(mv4), last, **kw)
        assert torch.equal(a, b)
    parts = port_mc._pixel_motion(torch.from_numpy(mv4), last, True, 1, 1,
                                  16, 16, 2, 25, 25)
    assert all(p.dtype == torch.int64 for p in parts)
    # 16 references of 4K pair-mode chroma: the last sample's index
    R, Py, Px, hn, wn = 16, 8, 8, 1093, 1933
    top = (((R - 1) * Py + 7) * Px + 7) * hn * wn + (hn - 1) * wn + wn - 1
    assert top >= 2 ** 31
    big = torch.tensor([R - 1], dtype=torch.int64)
    idx = (((big * Py + 7) * Px + 7) * hn + (hn - 1)) * wn + (wn - 1)
    assert int(idx) == top


@pytest.mark.parametrize("bd", [8, 10])
def test_combine_plane_matches_jax(bd):
    rng = np.random.default_rng(30 + bd)
    H, W = 16, 24
    lo, hi = -(1 << 13), 1 << 14
    put0 = rng.integers(lo, hi, (H, W)).astype(np.int32)
    put1 = rng.integers(lo, hi, (H, W)).astype(np.int32)
    pf = rng.integers(0, 4, (H, W)).astype(np.int32)
    res = rng.integers(-300, 300, (H, W)).astype(np.int32)
    want = np.asarray(jax_mc.combine_plane(
        jnp.asarray(put0), jnp.asarray(put1), jnp.asarray(pf),
        jnp.asarray(res), bit_depth=bd))
    got = port_mc.combine_plane(*map(torch.from_numpy, (put0, put1, pf, res)),
                                bit_depth=bd)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert not got.numpy()[pf == 0].any()


@pytest.mark.parametrize("denom", [0, 3, 7])
@pytest.mark.parametrize("bd", [8, 10])
def test_combine_plane_w_matches_jax(bd, denom):
    rng = np.random.default_rng(40 + bd + denom)
    H, W = 16, 24
    arrs = [rng.integers(-(1 << 13), 1 << 14, (H, W)).astype(np.int32)
            for _ in range(2)]
    arrs.append(rng.integers(0, 4, (H, W)).astype(np.int32))
    arrs.append(rng.integers(-300, 300, (H, W)).astype(np.int32))
    for _ in range(2):
        arrs.append(rng.integers(-128, 128, (H, W)).astype(np.int32))  # w
        arrs.append(rng.integers(-128, 128, (H, W)).astype(np.int32))  # o
    want = np.asarray(jax_mc.combine_plane_w(
        *map(jnp.asarray, arrs), bit_depth=bd, denom=denom))
    got = port_mc.combine_plane_w(*map(torch.from_numpy, arrs),
                                  bit_depth=bd, denom=denom)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    if denom == 0:
        one, zero = torch.ones((H, W), dtype=torch.int32), \
            torch.zeros((H, W), dtype=torch.int32)
        t = list(map(torch.from_numpy, arrs[:4]))
        assert torch.equal(
            port_mc.combine_plane_w(*t, one, zero, one, zero, bit_depth=bd,
                                    denom=0),
            port_mc.combine_plane(*t, bit_depth=bd))


def _grids(rng, h4, w4):
    """Motion grids that are constant on rectangles, like a picture's."""
    pf4 = np.zeros((h4, w4), np.uint8)
    slot = np.zeros((2, h4, w4), np.uint8)
    mv = np.zeros((h4, w4, 2, 2), np.int16)
    for _ in range(12):
        y0, x0 = rng.integers(0, h4), rng.integers(0, w4)
        y1, x1 = rng.integers(y0, h4) + 1, rng.integers(x0, w4) + 1
        pf4[y0:y1, x0:x1] = rng.integers(0, 4)
        slot[:, y0:y1, x0:x1] = rng.integers(0, 4, (2, 1, 1))
        mv[y0:y1, x0:x1] = rng.integers(-32768, 32768, (2, 2))
    return pf4, slot, mv


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_motion_grids_round_trip_and_match_jax(seed):
    rng = np.random.default_rng(seed)
    h4, w4 = 9, 14
    pf4, slot, mv = _grids(rng, h4, w4)
    jd = jax_pl.motion_diff2(pf4, slot, mv)
    pd = port_pl.motion_diff2(pf4, slot, mv)
    n = len(pd["idx"])
    # the port ships exactly the nonzero deltas; the JAX package pads
    assert pd["idx"].dtype == np.int32 and pd["vals"].dtype == np.int16
    assert pd["vals"].shape == (n, 7) and 0 < n < len(jd["idx"])
    assert np.array_equal(pd["idx"], jd["idx"][:n])
    assert np.array_equal(pd["vals"], jd["vals"][:n])
    assert (jd["idx"][n:] == 1 << 30).all()
    want = jax_pl._motion_grids_dev(jnp.asarray(jd["idx"]),
                                    jnp.asarray(jd["vals"]), h4, w4)
    got = port_pl._motion_grids_dev(torch.from_numpy(pd["idx"]),
                                    torch.from_numpy(pd["vals"]), h4, w4)
    for g, w, orig in zip(got, want, (pf4, mv, slot)):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert np.array_equal(g.numpy(), orig)


def test_motion_grids_of_an_empty_field():
    d = port_pl.motion_diff2(np.zeros((4, 4), np.uint8),
                             np.zeros((2, 4, 4), np.uint8),
                             np.zeros((4, 4, 2, 2), np.int16))
    assert d["idx"].shape == (0,) and d["vals"].shape == (0, 7)
    pf4, mv, slot = port_pl._motion_grids_dev(
        torch.from_numpy(d["idx"]), torch.from_numpy(d["vals"]), 4, 4)
    assert not pf4.any() and not mv.any() and not slot.any()


@pytest.mark.parametrize("c", [0, 1, 2])
@pytest.mark.parametrize("dt", [np.uint8, np.uint16])
def test_slice_plane_matches_jax(c, dt):
    rng = np.random.default_rng(c)
    H, W, Hc, Wc = 8, 12, 4, 6
    flat = rng.integers(0, np.iinfo(dt).max, H * W + 2 * Hc * Wc).astype(dt)
    want = np.asarray(jax_pl._slice_plane(jnp.asarray(flat), c=c, H=H, W=W,
                                          Hc=Hc, Wc=Wc))
    got = port_pl._slice_plane(torch.from_numpy(flat), c, H, W, Hc, Wc)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


# ---- the slice's device half as a whole: _inter_prefill ---------------------

def _inter_pictures(**kw):
    """(fs, refs) of every inter picture of a small low-delay stream: the
    port's parse, and the references' planes as host arrays."""
    from conftest import make_frames
    from openhevc_tpu.encoder.inter_enc import encode_lowdelay_stream
    from openhevc_tpu_torch.decoder import Decoder
    bd = kw.get("bit_depth", 8)
    frames = make_frames(64, 64, 3, np.random.default_rng(5))
    if bd > 8:
        frames = [tuple(p.astype(np.uint16) << (bd - 8) for p in f)
                  for f in frames]
    data, _ = encode_lowdelay_stream(frames, 64, 64, qp=30, ctb_log2=4,
                                     seed=9, **kw)

    class Capture(Decoder):
        def _reconstruct(self, fs, refs):
            if fs.inter_pbs:
                self.seen.append((fs, {p: [np.asarray(x) for x in pl]
                                       for p, pl in refs.items()}))
            return super()._reconstruct(fs, refs)

    d = Capture(device="cpu")
    d.seen = []
    d.decode(data)
    d.flush()
    assert len(d.seen) == 2
    return d.seen


PREFILL_CASES = {
    "p_8bit": dict(),
    "b_two_refs": dict(b_slices=True, n_refs=2),
    "weighted": dict(weighted=True, b_slices=True, n_refs=2),
    "ten_bit": dict(bit_depth=10),
    "ten_bit_weighted": dict(bit_depth=10, weighted=True),
}


@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("name", sorted(PREFILL_CASES))
def test_inter_prefill_matches_jax(name, pairs, monkeypatch):
    """The device half of an inter picture up to the intra kernel: the
    port's parse of a real picture through both packages' host packing
    (`_pack_inter`), stage 1, `_inter_prefill`."""
    from openhevc_tpu.ops.intra_fused import padded_dims
    px = 1 << 30 if pairs else 0
    monkeypatch.setattr(jax_pl.JaxEngine, "MC_PAIRS_MAX_PIXELS", px)
    monkeypatch.setattr(port_pl.TorchEngine, "MC_PAIRS_MAX_PIXELS", px)
    weighted = 0
    for fs, refs in _inter_pictures(**PREFILL_CASES[name]):
        sps, npk = fs.sps, fs.native_pack
        H, W, bd = sps.height, sps.width, sps.bit_depth
        Hc, Wc = H // 2, W // 2
        hl, wl = padded_dims(H, W)
        hc, wc = padded_dims(Hc, Wc)
        dims = dict(H=H, W=W, Hc=Hc, Wc=Wc, hl=hl, wl=wl, hc=hc, wc=wc,
                    bd=bd, hs=1, vs=1)
        ji = jax_pl.JaxEngine()._pack_inter(fs, refs)
        assert ji["pairs"] == pairs
        jwt = ji.get("wt")
        want = jax_pl._inter_prefill(
            jnp.asarray(npk["arena4"]), jnp.asarray(npk["arena16"]),
            jnp.asarray(npk["esc"]), jnp.asarray(ji["md"]["idx"]),
            jnp.asarray(ji["md"]["vals"]), ji["hf"][0], ji["hf"][1],
            ji["hf"][2],
            wt=(jnp.asarray(jwt["wg"]), jnp.asarray(jwt["og"]))
            if jwt else None, caps=npk["caps"], h4=ji["md"]["h4"],
            w4=ji["md"]["w4"],
            denoms=tuple(jwt["denoms"]) if jwt else None, pairs=pairs,
            **dims)
        eng = port_pl.TorchEngine("cpu")
        pi = eng._pack_inter(fs, refs, (H, W, Hc, Wc))
        assert pi["pairs"] == pairs and (pi["wt"] is None) == (jwt is None)
        acc = port_pl._residual_acc(
            *map(torch.from_numpy, (npk["arena4"], npk["arena16"],
                                    npk["esc"])),
            caps=npk["caps"], H=H, W=W, Hc=Hc, Wc=Wc, bd=bd)
        pwt = pi["wt"]
        got = port_pl._inter_prefill(
            *acc, torch.from_numpy(pi["md"]["idx"]),
            torch.from_numpy(pi["md"]["vals"]), *pi["hf"],
            wt=(torch.from_numpy(pwt["wg"]), torch.from_numpy(pwt["og"]))
            if pwt else None, h4=pi["md"]["h4"], w4=pi["md"]["w4"],
            denoms=tuple(pwt["denoms"]) if pwt else None, pairs=pairs,
            **dims)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            assert np.array_equal(g.numpy(), np.asarray(w))
        assert got[0].any() and got[1].any()
        weighted += pwt is not None
    assert (weighted > 0) == ("weighted" in name)


# ---- the stage-1 cache ------------------------------------------------------

class _Pic:
    """A reference's planes object: weakly referenceable, host planes."""

    def __init__(self, rng):
        self.planes = [_plane(rng, 16, 16, 8), _plane(rng, 8, 8, 8),
                       _plane(rng, 8, 8, 8)]

    def __getitem__(self, c):
        return self.planes[c]


def _cache_slots(cache, objs, live=None, count=None):
    def plane_of(o, c):
        if count is not None:
            count.append((id(o), c))
        return torch.from_numpy(np.ascontiguousarray(o[c], np.int32))

    live = {id(o) for o in (objs if live is None else live)}
    return cache.slots(objs, (16, 16, 8, 8), 8, plane_of, live, "cpu")


@pytest.mark.parametrize("pairs", [False, True])
def test_stage1_cache_filters_a_reference_once(pairs):
    rng = np.random.default_rng(1)
    a, b = _Pic(rng), _Pic(rng)
    cache = port_pl.Stage1Cache(pairs, 1 << 30)
    made = []
    bufs, slots = _cache_slots(cache, [a, b], count=made)
    assert sorted(slots) == [0, 1] and len(made) == 6
    assert (cache.hits, cache.misses) == (0, 2)
    bufs2, slots2 = _cache_slots(cache, [b, a], count=made)
    assert slots2 == slots[::-1] and len(made) == 6
    assert (cache.hits, cache.misses) == (2, 2)
    fn = port_mc.mc_prefilter_pairs if pairs else port_mc.mc_hprefilter
    for obj, slot in zip((a, b), slots):
        for c in range(3):
            want = fn(torch.from_numpy(obj[c]), 8, c == 0)
            assert torch.equal(bufs2[c][slot], want)
    assert cache.nbytes() == sum(t.numel() * 2 for t in bufs2)


def test_stage1_cache_frees_dead_and_dropped_references():
    rng = np.random.default_rng(2)
    a, b, c = _Pic(rng), _Pic(rng), _Pic(rng)
    cache = port_pl.Stage1Cache(False, 1 << 30)
    _, (sa, sb) = _cache_slots(cache, [a, b])
    # b left the decoder's reference set: c takes its slot, nothing grows
    _, (sc,) = _cache_slots(cache, [c], live=[a, c])
    assert sc == sb and cache.bufs[0].shape[0] == 2
    # a died: its slot goes to the next newcomer
    del a
    gc.collect()
    d = _Pic(rng)
    _, (sd,) = _cache_slots(cache, [d], live=[c, d])
    assert sd == sa and cache.bufs[0].shape[0] == 2
    assert len(cache.entries) == 2


def test_stage1_cache_keeps_to_its_byte_budget_lru():
    rng = np.random.default_rng(3)
    pics = [_Pic(rng) for _ in range(5)]
    per_ref = 2 * sum(int(np.prod(port_mc.stage1_shape(h, w, lum, False)))
                      for h, w, lum in ((16, 16, True), (8, 8, False),
                                        (8, 8, False)))
    cache = port_pl.Stage1Cache(False, 3 * per_ref + 1)
    for p in pics[:3]:
        _cache_slots(cache, [p], live=pics)
    _cache_slots(cache, [pics[0]], live=pics)          # refresh 0
    _cache_slots(cache, [pics[3]], live=pics)          # evicts 1, the LRU
    assert cache.bufs[0].shape[0] == 3 and cache.nbytes() == 3 * per_ref
    assert set(cache.entries) == {id(pics[0]), id(pics[2]), id(pics[3])}
    # a picture that needs more references than the budget holds gets them
    _cache_slots(cache, pics, live=pics)
    assert cache.bufs[0].shape[0] == 5
    # other dims or depth: everything is dropped
    cache.slots([pics[0]], (16, 16, 8, 8), 10,
                lambda o, c: torch.from_numpy(o[c]), {id(pics[0])}, "cpu")
    assert len(cache.entries) == 1 and cache.bufs[0].shape[0] == 1


def test_stage1_cache_holds_a_host_only_reference_once():
    """A plain list of host planes (the mid-grey concealment frame) has
    no weak reference: the entry keeps it, and it is read once."""
    rng = np.random.default_rng(4)
    planes = _Pic(rng).planes
    cache = port_pl.Stage1Cache(True, 1 << 30)
    made = []
    _cache_slots(cache, [planes], count=made)
    _cache_slots(cache, [planes], count=made)
    assert len(made) == 3 and (cache.hits, cache.misses) == (1, 1)


def test_engine_budget_and_mode_rule():
    from types import SimpleNamespace
    eng = port_pl.TorchEngine("cpu")
    assert eng._stage1[True].budget == eng._stage1[False].budget == 2 ** 30
    assert port_pl.TorchEngine.MC_PAIRS_MAX_PIXELS == \
        jax_pl.JaxEngine.MC_PAIRS_MAX_PIXELS

    def fs(W, H):
        return SimpleNamespace(sps=SimpleNamespace(width=W, height=H))

    assert eng.pairs_mode(fs(1920, 1080)) and eng.pairs_mode(fs(3840, 2160))
    assert not eng.pairs_mode(fs(7680, 4320))
