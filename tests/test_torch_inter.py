"""The inter slice as a whole: openhevc_tpu_torch `Decoder(device="cpu")`
on small low-delay and hierarchical-B streams of the repo's own encoder
(TMVP, WPP, tiles, weighted prediction, constrained intra prediction,
long-term and multiple references, a missing reference, 8 and 10 bit;
whole-frame plan and a forced banded plan, pair mode and tap mode) vs
the JAX package's `Decoder("np")` and `Decoder("jax")`, frame for frame.
None needs the C reference build. Tolerance: none (integer samples)."""
import numpy as np
import pytest
import torch

from conftest import make_frames
from test_torch_banded import _force_banded
from test_torch_intra import cuda  # noqa: F401  (a fixture)

LOWDELAY = {
    "p": dict(),
    "two_refs": dict(n_refs=2, max_merge=3),
    "b_weighted_tmvp": dict(b_slices=True, weighted=True, tmvp=True,
                            n_refs=2),
    "constrained_intra": dict(constrained_intra=True),
    "wpp_amp": dict(wpp=True, amp=True, W=128),
    "long_term": dict(lt_ref=True, n_refs=2),
    "two_slices": dict(num_slices=2),
    "ctb32": dict(ctb_log2=5, W=96),
    "ten_bit": dict(bit_depth=10),
    "ten_bit_weighted_b": dict(bit_depth=10, weighted=True, b_slices=True),
}
RANDOM_ACCESS = {
    "ra": dict(),
    "ra_tmvp_wpp": dict(tmvp=True, wpp=True),
    "ra_tiles": dict(tile_cols=2, tile_rows=2, W=128),
    "ra_weighted": dict(weighted=True),
    "ra_cra": dict(intra_period=8, n=17),
    "ra_ten_bit": dict(bit_depth=10, ctb_log2=5),
}


def frames_for(W, H, n, seed, bd=8):
    fr = make_frames(W, H, n, np.random.default_rng(seed))
    if bd > 8:
        fr = [tuple(p.astype(np.uint16) << (bd - 8) for p in f) for f in fr]
    return fr


def lowdelay(name, seed=21, n=4, **more):
    from openhevc_tpu.encoder.inter_enc import encode_lowdelay_stream
    kw = dict(qp=32, ctb_log2=4, W=64, H=64)
    kw.update(LOWDELAY.get(name, {}), **more)
    W, H = kw.pop("W"), kw.pop("H")
    fr = frames_for(W, H, n, seed, kw.get("bit_depth", 8))
    return encode_lowdelay_stream(fr, W, H, seed=seed, **kw)[0]


def random_access(name, seed=31, **more):
    from openhevc_tpu.encoder.inter_enc import encode_ra_stream
    kw = dict(qp=31, gop=8, ctb_log2=4, W=64, H=64, n=9)
    kw.update(RANDOM_ACCESS.get(name, {}), **more)
    W, H, n = kw.pop("W"), kw.pop("H"), kw.pop("n")
    fr = frames_for(W, H, n, seed, kw.get("bit_depth", 8))
    return encode_ra_stream(fr, W, H, seed=seed, **kw)[0]


def stream(name, **more):
    return (lowdelay if name in LOWDELAY else random_access)(name, **more)


def decode(dec, data):
    pics = dec.decode(data) + dec.flush()
    return [[np.asarray(c) for c in p.cropped()] for p in pics], pics


def np_decode(data):
    from openhevc_tpu.decoder import Decoder
    return decode(Decoder("np"), data)[0]


def assert_same(got, want):
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        for c in range(3):
            assert np.array_equal(g[c], w[c]), (i, c)


def _ctb(name):
    kw = {**LOWDELAY, **RANDOM_ACCESS}[name]
    return 1 << kw.get("ctb_log2", 4), kw.get("W", 64)


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("name", sorted(LOWDELAY) + sorted(RANDOM_ACCESS))
def test_port_decoder_inter_matches_np(name, banded, monkeypatch):
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.ops import intra_fused as port
    data = stream(name)
    want = np_decode(data)
    if banded:
        cs, W = _ctb(name)
        _force_banded(monkeypatch, W, cs)
    calls = {"whole": 0, "banded": 0}
    for key, fn in (("whole", "intra_fused_ref"),
                    ("banded", "intra_fused_banded_ref")):
        orig = getattr(port, fn)

        def spy(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(port, fn, spy)
    dec = Decoder(device="cpu")
    got, pics = decode(dec, data)
    assert_same(got, want)
    assert [p.poc for p in pics] == sorted(p.poc for p in pics)
    assert calls["banded" if banded else "whole"] == len(pics)
    assert calls["whole" if banded else "banded"] == 0
    assert dec.stats["python_slices"] == 0
    dt = np.uint16 if "ten_bit" in name else np.uint8
    assert all(c.dtype == dt for g in got for c in g)
    # the pictures really predict from each other
    cache = dec._engine()._stage1[True]
    assert cache.misses >= 1
    assert dec._engine()._stage1[False].misses == 0


@pytest.mark.parametrize("name", ["b_weighted_tmvp", "ra_tmvp_wpp",
                                  "ra_tiles", "ten_bit"])
def test_port_decoder_inter_matches_jax_decoder(name):
    from openhevc_tpu.decoder import Decoder as JaxDecoder
    from openhevc_tpu_torch.decoder import Decoder
    data = stream(name)
    assert_same(decode(Decoder(device="cpu"), data)[0],
                decode(JaxDecoder("jax"), data)[0])


@pytest.mark.parametrize("name", ["b_weighted_tmvp", "ra_tiles",
                                  "ten_bit", "ra_cra"])
def test_tap_mode_equals_pair_mode(name, monkeypatch):
    """Both MC modes through the whole decoder: the JAX package's rule
    (pair mode up to 8.5 M samples) and, forced, the tap mode."""
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    data = stream(name)
    want = np_decode(data)
    monkeypatch.setattr(TorchEngine, "MC_PAIRS_MAX_PIXELS", 0)
    dec = Decoder(device="cpu")
    assert_same(decode(dec, data)[0], want)
    assert dec._engine()._stage1[False].misses >= 1
    assert dec._engine()._stage1[True].misses == 0


def _drop_picture(data, k):
    """The stream without its k-th picture (VCL NAL)."""
    from openhevc_tpu_torch.decoder import split_nals
    nals = split_nals(data)
    vcl = [i for i, n in enumerate(nals) if ((n[0] >> 1) & 0x3F) <= 31]
    return b"".join(b"\x00\x00\x01" + n for i, n in enumerate(nals)
                    if i != vcl[k])


def test_missing_reference_is_concealed_like_np():
    """A dropped reference picture: a mid-grey concealment frame, held on
    the host, stands in for it; it is uploaded and filtered once."""
    from openhevc_tpu_torch.decoder import DecodeError, Decoder
    data = _drop_picture(lowdelay("p", seed=111), 1)
    dec = Decoder(device="cpu")
    got, pics = decode(dec, data)
    assert_same(got, np_decode(data))
    assert len(pics) == 3
    cache = dec._engine()._stage1[True]
    assert cache.misses == 2 and cache.hits == 0
    with pytest.raises(DecodeError, match="missing from the DPB"):
        decode(Decoder(device="cpu", strict=True), data)


def _all_inter_stream():
    """32x32, CTB 16: pictures 1 and 3 (decode order) hold no intra job,
    picture 2 mixes intra and inter."""
    return lowdelay("p", seed=8, W=32, H=32)


@pytest.mark.parametrize("banded", [False, True])
def test_all_inter_picture_launches_no_kernel(banded, monkeypatch):
    """n == 0: the schedule is empty, neither wrapper reaches its kernel
    (or its plain version), and the picture is the prefill."""
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.models import pipeline
    from openhevc_tpu_torch.ops import intra_fused as port
    data = _all_inter_stream()
    if banded:
        _force_banded(monkeypatch, 32, 16)
    ran, seen = [], []
    for fn in ("intra_fused_ref", "intra_fused_banded_ref"):
        monkeypatch.setattr(
            port, fn, lambda meta, *a, _o=getattr(port, fn), **kw:
            (ran.append(a[0] if isinstance(a[0], int) else a[1]),
             _o(meta, *a, **kw))[1])
    orig = pipeline.TorchEngine.prepare

    def prepare(self, fs, ref_planes=None):
        k = orig(self, fs, ref_planes)
        seen.append((k["n"], bool(fs.inter_pbs), k["order"].shape[0],
                     k["level_bounds"].tolist(),
                     None if k["bounds"] is None else k["bounds"].tolist()))
        return k
    monkeypatch.setattr(pipeline.TorchEngine, "prepare", prepare)
    got, _ = decode(Decoder(device="cpu"), data)
    assert_same(got, np_decode(data))
    assert [(n == 0, inter) for n, inter, *_ in seen] == \
        [(False, False), (True, True), (False, True), (True, True)]
    for n, _inter, n_order, lb, bounds in seen:
        if n == 0:
            assert n_order == 0 and lb == [0]
            assert bounds is None or not any(bounds)
    # the plain versions ran, with n > 0, for the two pictures with jobs
    assert len(ran) == 4 and sorted(r > 0 for r in ran) == \
        [False, False, True, True]


def test_wrappers_take_no_jobs_on_prefilled_planes():
    """n == 0 on non-zero planes: both wrappers and both plain versions
    leave the planes as they are."""
    from openhevc_tpu_torch.ops import intra_fused as port
    meta = torch.zeros((16, 1024), dtype=torch.int32)
    g = torch.Generator().manual_seed(1)
    luma = torch.randint(0, 255, (64, 512), generator=g, dtype=torch.int32)
    chroma = torch.randint(0, 255, (2, 64, 512), generator=g,
                           dtype=torch.int32)
    res_l, res_c = torch.ones_like(luma), torch.ones_like(chroma)
    order = torch.zeros(0, dtype=torch.int32)
    lb = torch.zeros(1, dtype=torch.int32)
    bounds = torch.zeros(5, dtype=torch.int32)
    l0, c0 = luma.clone(), chroma.clone()
    for fn, lead in ((port.intra_fused, ()), (port.intra_fused_ref, ()),
                     (port.intra_fused_banded, (bounds,)),
                     (port.intra_fused_banded_ref, (bounds,))):
        before = getattr(fn, "launches", 0)
        fn(meta, *lead, 0, luma, chroma, res_l, res_c, 8, order, lb)
        assert torch.equal(luma, l0) and torch.equal(chroma, c0)
        assert getattr(fn, "launches", 0) == before
    port.intra_fused_serial(meta, 0, luma, chroma, res_l, res_c, 8)
    port.intra_fused_banded_ref(meta, bounds, 0, luma, chroma, res_l, res_c,
                                8)
    assert torch.equal(luma, l0) and torch.equal(chroma, c0)


def test_references_are_read_on_the_device():
    """The DPB entry is the decoded picture's flat device tensor: no
    picture is fetched to the host while the stream decodes."""
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.models.pipeline import TorchPlanes
    dec = Decoder(device="cpu")
    pics = dec.decode(stream("ra")) + dec.flush()
    assert len(pics) == 9
    for p in pics:
        assert isinstance(p.planes, TorchPlanes) and p.planes._mat is None
        assert p.planes._dev.dtype == torch.uint8
        assert not p.planes.device_filtered


def test_inter_prepare_reads_nothing_back(monkeypatch):
    """No device-to-host read on an inter picture's path up to the
    kernel's wrapper (compare test_torch_levels' intra twin)."""
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.models import pipeline
    data = stream("b_weighted_tmvp")

    class Capture(Decoder):
        def _reconstruct(self, fs, refs):
            self.seen.append((fs, refs))
            return super()._reconstruct(fs, refs)

    d = Capture(device="cpu")
    d.seen = []
    d.decode(data)
    d.flush()
    fs, refs = d.seen[-1]
    assert fs.inter_pbs and fs.weights is not None
    ran, reads = [], []
    monkeypatch.setattr(pipeline, "intra_fused",
                        lambda *a, **kw: ran.append(a))
    for name in ("tolist", "item", "cpu", "numpy"):
        def spy(self, *a, _name=name, **kw):
            reads.append(_name)
            raise AssertionError(f"Tensor.{_name}() on the main path")
        monkeypatch.setattr(torch.Tensor, name, spy)
    out = pipeline.TorchEngine("cpu").reconstruct(fs, refs)
    assert len(ran) == 1 and not reads and out._mat is None


def _captured(data, want_inter=True):
    from openhevc_tpu_torch.decoder import Decoder

    class Capture(Decoder):
        def _reconstruct(self, fs, refs):
            self.seen.append((fs, refs))
            return super()._reconstruct(fs, refs)

    d = Capture(device="cpu")
    d.seen = []
    d.decode(data)
    d.flush()
    return [(fs, refs) for fs, refs in d.seen
            if bool(fs.inter_pbs) == want_inter]


def test_inter_pictures_outside_the_slice_raise():
    """What the JAX package sends down its packed path now decodes, to
    that path's output (`JaxEngine.reconstruct` on the same stream's
    symbols): an inter picture with no usable reference (inter blocks
    stay 0), and one with PCM blocks (the PCM samples over the inter
    prefill, put into both packages' symbols alike)."""
    from openhevc_tpu.decoder import Decoder as JaxDecoder
    from openhevc_tpu.models.pipeline import JaxEngine
    from openhevc_tpu.symbols import PcmBlock as JaxPcm
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.symbols import PcmBlock
    data = stream("p")
    fs, refs = _captured(data)[0]

    class Capture(JaxDecoder):
        def _reconstruct(self, fs, refs):
            self.seen.append((fs, refs))
            return super()._reconstruct(fs, refs)
    d = Capture("jax")
    d.seen = []
    d.decode(data)
    d.flush()
    jfs, jrefs = [s for s in d.seen if s[0].inter_pbs][0]

    def same(ours, theirs):
        got = TorchEngine("cpu").reconstruct(fs, ours)
        out = JaxEngine().reconstruct(jfs, theirs)
        want = out.get() if hasattr(out, "get") else out
        for c in range(3):
            assert np.array_equal(np.asarray(got[c]), np.asarray(want[c])), c
        return got

    same({}, {})
    same({p + 1000: r for p, r in refs.items()},
         {p + 1000: r for p, r in jrefs.items()})
    rng = np.random.default_rng(9)
    samples = [rng.integers(0, 256, sh).astype(np.int32)
               for sh in ((8, 8), (4, 4), (4, 4))]
    pf = np.asarray(fs.motion.pred_flag)
    ys, xs = np.nonzero((pf[:-1:2, :-1:2] > 0) & (pf[1::2, 1::2] > 0))
    y, x = 8 * int(ys[0]), 8 * int(xs[0])      # an inter 8x8 block
    for f, cls in ((fs, PcmBlock), (jfs, JaxPcm)):
        f.motion.pred_flag[y >> 2:(y >> 2) + 2, x >> 2:(x >> 2) + 2] = 0
        f.pcm_blocks = [cls(x, y, 8, *samples)]
    got = same(refs, jrefs)
    assert np.array_equal(np.asarray(got[0])[y:y + 8, x:x + 8], samples[0])


# ---- the CUDA kernel on prefilled planes (needs a card) --------------------

@pytest.mark.gpu
@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("name", ["p", "constrained_intra", "ra_tiles",
                                  "ten_bit", "all_inter"])
def test_kernels_on_inter_prefill_match_plain(name, banded, monkeypatch,
                                              cuda):  # noqa: F811
    """Both level-parallel kernels on the real inter prefill (sparse job
    lists; none at all on all-inter pictures) == their plain versions ==
    the serial-order entry."""
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops.intra_fused import (intra_fused,
                                                    intra_fused_banded,
                                                    intra_fused_banded_ref,
                                                    intra_fused_ref,
                                                    intra_fused_serial)
    data = _all_inter_stream() if name == "all_inter" else stream(name)
    pictures = _captured(data)
    if banded:
        cs, W = (16, 32) if name == "all_inter" else _ctb(name)
        _force_banded(monkeypatch, W, cs)
    eng = TorchEngine(cuda)
    for fs, refs in pictures:
        k = eng.prepare(fs, refs)
        assert k["luma"].any()
        lead = (k["bounds"],) if banded else ()
        fn = intra_fused_banded if banded else intra_fused
        plain = intra_fused_banded_ref if banded else intra_fused_ref

        def run(f, *extra, lead=lead):
            luma, chroma = k["luma"].clone(), k["chroma"].clone()
            f(k["meta"], *lead, k["n"], luma, chroma, k["res_l"],
              k["res_c"], k["bd"], *extra)
            torch.cuda.synchronize()
            return luma, chroma

        before = fn.launches
        got = run(fn, k["order"], k["level_bounds"])
        assert fn.launches == before + (k["n"] > 0)
        for other in (run(plain), run(intra_fused_serial, lead=())):
            assert torch.equal(got[0], other[0])
            assert torch.equal(got[1], other[1])
