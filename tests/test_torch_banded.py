"""Port banded path and Main10: the banded layout and band sort vs the JAX
package's (`band_plan`, `sort_meta_by_band`), the banded plain version
`intra_fused_banded_ref` vs `intra_fused_ref` and `Decoder("np")` on
frames forced into several bands, and the port's `Decoder(device="cpu")`
on 10-bit streams vs the JAX package's decoders. The CUDA kernel vs its
plain version runs only with a card (marker `gpu`). Tolerance: none
(integer samples).

At 10 bits the in-repo encoder's returned reconstruction is not the
decode of the stream it writes (the JAX package's own Main10 tests hold
its decoder to the C reference instead, and the 4K Main10 bench stream
to the reference decoder's md5 sidecar), so 10-bit cases are held to
`Decoder("np")` and `Decoder("jax")` here, and to the sidecar on the
card (chip_smoke.py)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_intra import (FRAME_CASES, _frame_case, _fused, _np_planes,
                              cuda)  # noqa: F401  (cuda is a fixture)
from test_torch_parse import STREAMS, encode, parsed_port, stream

FRAME_DIMS = [(832, 480, 64), (1920, 1080, 64), (3840, 2160, 64),
              (3840, 2160, 32), (64, 64, 16), (128, 64, 64)]


def _force_banded(monkeypatch, W, cs):
    """Every frame takes the banded path, one CTB row per band."""
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops import intra_fused as port
    monkeypatch.setattr(TorchEngine, "FUSED_VMEM_BUDGET", 0)
    monkeypatch.setattr(port, "VMEM_SCRATCH_BUDGET",
                        port.one_row_budget(W, cs, 1, 1))


def _frames10(W, H, n, seed):
    """10-bit test pictures (ramps plus noise, as bench.py's Main10)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for i in range(n):
        y = ((xx * 8 + yy * 12 + i * 40) % 1024 * 0.7 +
             rng.integers(0, 256, (H, W))).astype(np.uint16)
        u = ((xx[::2, ::2] * 4 + i * 28 + 512) % 1024).astype(np.uint16)
        v = ((yy[::2, ::2] * 8 + i * 12) % 1024).astype(np.uint16)
        out.append((y, u, v))
    return out


def encode10(W, H, n=2, seed=0, **kw):
    from openhevc_tpu.encoder.intra_enc import encode_intra_stream
    return encode_intra_stream(_frames10(W, H, n, seed), W, H, seed=seed,
                               bit_depth=10, **kw)


CASES10 = {
    "ctb4": dict(W=64, H=64, qp=30, ctb_log2=4),
    "wpp_dct32": dict(W=128, H=64, qp=37, ctb_log2=6, wpp=True),
    "pcm": dict(W=64, H=64, qp=26, ctb_log2=4, pcm=True),
}


def _case10(name, n=2):
    kw = dict(CASES10[name])
    return encode10(kw.pop("W"), kw.pop("H"), n=n, seed=7, **kw)


# ---- host helpers vs the JAX package ----------------------------------

@pytest.mark.parametrize("W,H,cs", FRAME_DIMS)
def test_band_plan_matches_jax(W, H, cs):
    from openhevc_tpu.ops.intra_fused import band_plan as jax_plan
    from openhevc_tpu_torch.ops.intra_fused import band_plan
    assert band_plan(H, W, H >> 1, W >> 1, cs, 1) == \
        jax_plan(H, W, H >> 1, W >> 1, cs, 1)
    if (W, H, cs) == (3840, 2160, 64):
        assert band_plan(H, W, H >> 1, W >> 1, cs, 1) == \
            (64, 34, 2248, 4224, 1160, 2304)


@pytest.mark.parametrize("budget", [0, 600_000, 1_100_000, 3_000_000])
def test_band_plan_matches_jax_small_budget(budget, monkeypatch):
    from openhevc_tpu.ops import intra_fused as jax_if
    from openhevc_tpu_torch.ops import intra_fused as port
    monkeypatch.setattr(jax_if, "VMEM_SCRATCH_BUDGET", budget)
    monkeypatch.setattr(port, "VMEM_SCRATCH_BUDGET", budget)
    for W, H, cs in [(64, 64, 16), (128, 96, 32), (64, 256, 64)]:
        got = port.band_plan(H, W, H >> 1, W >> 1, cs, 1)
        assert got == jax_if.band_plan(H, W, H >> 1, W >> 1, cs, 1)
    assert (port.band_plan(64, 64, 32, 32, 16, 1) or (0,))[0] == \
        {0: 0, 600_000: 0, 1_100_000: 16, 3_000_000: 64}[budget]


@pytest.mark.parametrize("W,H,cs", FRAME_DIMS)
def test_fused_plan_follows_the_jax_gate(W, H, cs):
    """The port's plan is the JAX package's `_fused_plan` rule (without
    its TPU-backend test): whole-frame under the gate, else band_plan."""
    from openhevc_tpu.models.pipeline import JaxEngine
    from openhevc_tpu.ops.intra_fused import band_plan, padded_dims
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    assert TorchEngine.FUSED_VMEM_BUDGET == JaxEngine.FUSED_VMEM_BUDGET
    sps = SimpleNamespace(height=H, width=W, vshift1=1, hshift1=1,
                          ctb_size=cs)
    plan = TorchEngine("cpu").fused_plan(SimpleNamespace(sps=sps, poc=0))
    hl, wl = padded_dims(H, W)
    hc, wc = padded_dims(H >> 1, W >> 1)
    if (hl * wl + 2 * hc * wc) * 8 <= JaxEngine.FUSED_VMEM_BUDGET:
        assert plan == ("whole", (hl, wl, hc, wc))
    else:
        bh, nb, *dims = band_plan(H, W, H >> 1, W >> 1, cs, 1)
        assert plan == ("banded", tuple(dims), bh, nb)
    assert plan[0] == ("whole" if W * H <= 832 * 480 else "banded")


def test_fused_plan_without_a_band_raises(monkeypatch):
    """Where `band_plan` finds no band (its budget is the TPU's VMEM
    scratch), the plan is "no_band_plan": the whole-frame kernel on the
    padded frame (both CUDA kernels keep the planes in global memory)."""
    from openhevc_tpu.ops.intra_fused import padded_dims
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops import intra_fused as port
    monkeypatch.setattr(port, "VMEM_SCRATCH_BUDGET", 0)
    sps = SimpleNamespace(height=2160, width=3840, vshift1=1, hshift1=1,
                          ctb_size=64)
    plan = TorchEngine("cpu").fused_plan(SimpleNamespace(sps=sps, poc=0))
    assert plan == ("no_band_plan", padded_dims(2160, 3840) +
                    padded_dims(1080, 1920))


@pytest.mark.parametrize("name", sorted(STREAMS))
@pytest.mark.parametrize("mult", [1, 2])
def test_sort_meta_by_band_matches_jax(name, mult):
    from openhevc_tpu.ops.intra_fused import sort_meta_by_band as jax_sort
    from openhevc_tpu_torch.ops.intra_fused import sort_meta_by_band
    data, _ = stream(name)
    for fs in parsed_port(data):
        m8, n = fs.native_pack["meta"], fs.native_pack["n"]
        bh = fs.sps.ctb_size * mult
        nb = -(-fs.sps.height // bh)
        got, gb = sort_meta_by_band(m8, n, bh, 1, nb)
        want, wb = jax_sort(m8, n, bh, 1, nb)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert gb.dtype == np.int32 and np.array_equal(gb, wb)
        assert gb[0] == 0 and gb[-1] == n and (np.diff(gb) >= 0).all()
        if mult == 1 and nb > 1:
            assert (np.diff(gb) > 0).sum() > 1
        assert np.array_equal(m8, fs.native_pack["meta"])   # not in place


# ---- the banded plain version -----------------------------------------

BANDED_CASES = dict(FRAME_CASES)
BANDED_CASES.update({
    # taller frames, so CTB 32 / 64 streams span four bands too
    "ctb32_tall": dict(W=64, H=128, qp=30, ctb_log2=5),
    "dct32_strong_tall": dict(W=64, H=256, qp=37, ctb_log2=6, strong=True),
})


def _banded_case(name, monkeypatch):
    if name == "ten_bit":
        data, recons = _case10("ctb4")
        return data, recons, 16
    if name in FRAME_CASES:
        data, recons = _frame_case(name, monkeypatch)
    else:
        from test_torch_intra import _strong_encoder
        kw = dict(BANDED_CASES[name])
        if kw.pop("strong", False):
            _strong_encoder(monkeypatch)
        data, recons = encode(kw.pop("W"), kw.pop("H"), seed=3, **kw)
    return data, recons, 1 << BANDED_CASES[name]["ctb_log2"]


@pytest.mark.parametrize("name", sorted(BANDED_CASES) + ["ten_bit"])
def test_banded_ref_matches_whole_ref_and_np_decoder(name, monkeypatch):
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops.intra_fused import (intra_fused_banded_ref,
                                                    intra_fused_ref)
    data, recons, cs = _banded_case(name, monkeypatch)
    fss = parsed_port(data)
    want = _np_planes(data)
    whole = [_fused(fs, "cpu", intra_fused_ref) for fs in fss]
    _force_banded(monkeypatch, fss[0].sps.width, cs)
    assert len(fss) == len(want) == len(recons)
    for fs, wh, w, r in zip(fss, whole, want, recons):
        plan = TorchEngine("cpu").fused_plan(fs)
        assert plan[0] == "banded" and plan[2] == cs
        assert plan[3] == -(-fs.sps.height // cs)
        if fs.sps.height >= 4 * cs:
            assert plan[3] >= 4
        got = _banded_planes(fs, intra_fused_banded_ref)
        for c in range(3):
            assert np.array_equal(got[c], wh[c]), (fs.poc, c)
            assert np.array_equal(got[c], w[c]), (fs.poc, c)
            if fs.sps.bit_depth == 8:
                assert np.array_equal(got[c], r[c]), (fs.poc, c)


def _banded_planes(fs, fn, device="cpu", levels=False):
    """Cropped [Y, Cb, Cr] after fn (a banded kernel or its plain
    version) on the prepared banded inputs, band by band or, with
    levels=True, with prepare()'s level schedule."""
    from openhevc_tpu_torch.models.pipeline import TorchEngine, crop_pack
    k = TorchEngine(device).prepare(fs)
    sched = (k["order"], k["level_bounds"]) if levels else ()
    fn(k["meta"], k["bounds"], k["n"], k["luma"], k["chroma"], k["res_l"],
       k["res_c"], k["bd"], *sched)
    H, W, Hc, Wc = k["dims"]
    flat = crop_pack(k["luma"], k["chroma"], H, W, Hc, Wc, k["bd"]) \
        .cpu().numpy()
    return [flat[:H * W].reshape(H, W),
            flat[H * W:H * W + Hc * Wc].reshape(Hc, Wc),
            flat[H * W + Hc * Wc:].reshape(Hc, Wc)]


def test_banded_prepare_sorts_meta_and_uses_band_dims(monkeypatch):
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops.intra_fused import (band_plan, derive_meta16,
                                                    sort_meta_by_band)
    data, _ = encode(64, 64, n=1, seed=3, qp=30, ctb_log2=4)
    fs = parsed_port(data)[0]
    _force_banded(monkeypatch, 64, 16)
    k = TorchEngine("cpu").prepare(fs)
    bh, nb, hl, wl, hc, wc = band_plan(64, 64, 32, 32, 16, 1)
    assert (bh, nb) == (16, 4)
    assert k["luma"].shape == k["res_l"].shape == (hl, wl)
    assert k["chroma"].shape == k["res_c"].shape == (2, hc, wc)
    m8, bounds = sort_meta_by_band(fs.native_pack["meta"], k["n"], bh, 1, nb)
    assert k["bounds"].dtype == torch.int32
    assert np.array_equal(k["bounds"].numpy(), bounds)
    assert torch.equal(k["meta"], derive_meta16(torch.from_numpy(m8), False,
                                                False, False))
    # the level row rides through the same band sort
    m6, _ = sort_meta_by_band(fs.native_pack["meta6"], k["n"], bh, 1, nb)
    assert np.array_equal(m6[:5], m8)
    lv = m6[5, :k["n"]].astype(np.int64)
    order = k["order"].numpy()
    assert np.array_equal(order, np.argsort(lv, kind="stable"))


def test_banded_wrapper_rejects_bad_bounds():
    from openhevc_tpu_torch.ops.intra_fused import intra_fused_banded
    meta = torch.zeros((16, 8), dtype=torch.int32)
    luma = torch.zeros((64, 512), dtype=torch.int32)
    chroma = torch.zeros((2, 64, 512), dtype=torch.int32)
    ok = torch.tensor([0, 0, 0], dtype=torch.int32)
    args = (luma, chroma, luma, chroma, 8, torch.zeros(0, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32))
    intra_fused_banded(meta, ok, 0, *args)
    with pytest.raises(TypeError):
        intra_fused_banded(meta, ok.long(), 0, *args)
    args4 = (luma, chroma, luma, chroma, 8,
             torch.arange(4, dtype=torch.int32),
             torch.tensor([0, 4], dtype=torch.int32))
    for bad in ([0, 3, 5], [0, 5, 4], [1, 2, 4], [0], [4, 0, 4]):
        with pytest.raises(ValueError):
            intra_fused_banded(meta, torch.tensor(bad, dtype=torch.int32),
                               4, *args4)
    with pytest.raises(ValueError):
        intra_fused_banded(meta, torch.tensor([[0, 0]], dtype=torch.int32),
                           0, *args)
    with pytest.raises(ValueError):
        intra_fused_banded(meta, ok, 9, *args)


# ---- Main10 through the port's decoder ---------------------------------

def _decode(dec, data):
    return [p.cropped() for p in dec.decode(data) + dec.flush()]


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("name", sorted(CASES10))
def test_port_decoder_main10_matches_np(name, banded, monkeypatch):
    from openhevc_tpu.decoder import Decoder as NpDecoder
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.ops import intra_fused as port
    data, _ = _case10(name)
    if banded:
        _force_banded(monkeypatch, CASES10[name]["W"],
                      1 << CASES10[name]["ctb_log2"])
    calls = []
    monkeypatch.setattr(port, "intra_fused_banded_ref",
                        _spy(port.intra_fused_banded_ref, calls))
    dec = Decoder(device="cpu")
    got = _decode(dec, data)
    want = _decode(NpDecoder("np"), data)
    assert len(got) == len(want) == 2
    assert len(calls) == (2 if banded else 0)
    for g, w in zip(got, want):
        for c in range(3):
            assert g[c].dtype == np.uint16
            assert np.array_equal(g[c], w[c])
    assert max(int(g[0].max()) for g in got) > 255
    if name == "pcm":
        assert dec.stats["native_slices"] == 2


def _spy(fn, calls):
    def wrapped(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)
    return wrapped


def test_port_decoder_main10_matches_jax_decoder():
    from openhevc_tpu.decoder import Decoder as JaxDecoder
    from openhevc_tpu_torch.decoder import Decoder
    data, _ = _case10("ctb4", n=1)
    got = _decode(Decoder(device="cpu"), data)
    want = _decode(JaxDecoder("jax"), data)
    assert len(got) == len(want) == 1
    for c in range(3):
        assert got[0][c].dtype == np.uint16
        assert np.array_equal(got[0][c], np.asarray(want[0][c]))


def test_main10_output_stays_on_device_as_uint16():
    from openhevc_tpu_torch.decoder import Decoder
    data, _ = _case10("ctb4", n=1)
    dec = Decoder(device="cpu")
    pic = (dec.decode(data) + dec.flush())[0]
    assert pic.planes._mat is None
    assert pic.planes._dev.dtype == torch.uint16
    assert pic.planes._dev.numel() == 64 * 64 + 2 * 32 * 32


@pytest.mark.parametrize("bd,bdc", [(12, 12), (10, 8), (8, 10), (16, 16)])
def test_check_slice_depths_outside_the_slice(bd, bdc):
    """Equal depths of 8 to 12 bits are inside the port now (12 / 12
    passes); unequal luma / chroma depths and depths above 12 stay
    outside, and the message names the reason, not a ROADMAP item that
    would bring them."""
    from openhevc_tpu_torch.models.pipeline import check_slice
    sps = SimpleNamespace(chroma_format_idc=1, bit_depth=bd,
                          bit_depth_chroma=bdc)
    fs = SimpleNamespace(sps=sps, pps=None, poc=0, native_raw={},
                         inter_pbs=[], pcm_blocks=[])
    if (bd, bdc) == (12, 12):
        check_slice(fs)
        return
    what = "unequal luma / chroma" if bd != bdc else f"bit depth {bd}"
    with pytest.raises(NotImplementedError, match=what) as e:
        check_slice(fs)
    assert "Queue 1 item" not in str(e.value)


# ---- the CUDA kernel (needs a card) ------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(BANDED_CASES) + ["ten_bit"])
def test_banded_kernel_matches_plain(name, monkeypatch, cuda):
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.ops.intra_fused import (intra_fused,
                                                    intra_fused_banded,
                                                    intra_fused_banded_ref)
    data, _, cs = _banded_case(name, monkeypatch)
    fss = parsed_port(data)
    _force_banded(monkeypatch, fss[0].sps.width, cs)
    for fs in fss:
        k = TorchEngine(cuda).prepare(fs)
        assert k["bounds"] is not None
        planes = {}
        sched = (k["order"], k["level_bounds"])
        for key, fn in (("kernel", intra_fused_banded),
                        ("plain", intra_fused_banded_ref),
                        ("whole", None)):
            luma, chroma = k["luma"].clone(), k["chroma"].clone()
            before = intra_fused_banded.launches
            if fn is None:
                intra_fused(k["meta"], k["n"], luma, chroma, k["res_l"],
                            k["res_c"], k["bd"], *sched)
            elif fn is intra_fused_banded:
                fn(k["meta"], k["bounds"], k["n"], luma, chroma,
                   k["res_l"], k["res_c"], k["bd"], *sched)
            else:           # the plain version, band by band
                fn(k["meta"], k["bounds"], k["n"], luma, chroma,
                   k["res_l"], k["res_c"], k["bd"])
            torch.cuda.synchronize()
            assert intra_fused_banded.launches == \
                before + (key == "kernel")
            planes[key] = (luma, chroma)
        for key in ("plain", "whole"):
            assert torch.equal(planes["kernel"][0], planes[key][0]), key
            assert torch.equal(planes["kernel"][1], planes[key][1]), key
