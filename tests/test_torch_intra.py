"""Port intra path: `derive_meta16` vs the JAX package's `_derive_meta16`,
and the fused intra kernel's plain version `intra_fused_ref` vs the JAX
package's intra reference (ops/intra_np.py, also what `Decoder("np")`
reconstructs with). The Pallas kernel itself runs only on a TPU (the
JAX package's own tests gate it the same way), so it is held through
these plain references. The CUDA kernel vs `intra_fused_ref` runs only
with a card (marker `gpu`). Tolerance: none (integer samples)."""
import numpy as np
import pytest
import torch

from test_torch_parse import encode, parsed_port, stream


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("sdis,c444,strong", [
    (False, False, False), (False, False, True), (True, False, True),
    (False, True, True)])
def test_derive_meta16_matches_jax(sdis, c444, strong):
    import jax.numpy as jnp
    from openhevc_tpu.models.pipeline import _derive_meta16
    from openhevc_tpu_torch.ops.intra_fused import derive_meta16
    for name in ("plain", "dense"):
        data, _ = stream(name)
        for fs in parsed_port(data):
            m8 = fs.native_pack["meta"]
            want = np.asarray(_derive_meta16(jnp.asarray(m8), sdis, c444,
                                             strong))
            got = derive_meta16(torch.from_numpy(m8), sdis, c444, strong)
            assert got.dtype == torch.int32
            assert np.array_equal(got.numpy(), want)


def _jobs(rng, s, smooth):
    """(plane, mode, avail_groups) cases for one TU size."""
    g = s + 1
    pats = [np.ones(g, bool), np.zeros(g, bool), rng.random(g) < 0.5,
            np.arange(g) >= g // 2, np.arange(g) < g // 3]
    out = []
    for mode in range(35):
        for plane in (0, 1):
            out.append((plane, mode, pats[(mode + plane) % len(pats)]))
    return out


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("s", [4, 8, 16, 32])
def test_intra_fused_ref_job_matches_intra_np(s, bd):
    """Every mode, both plane kinds, five availability patterns, noise
    and ramp neighbourhoods (the ramp meets the 32x32 strong-smoothing
    test), one TU per call against intra_np.intra_predict_block."""
    from openhevc_tpu.ops import intra_np
    from openhevc_tpu.ops.intra_fused import pack_meta
    from openhevc_tpu_torch.ops.intra_fused import (OX, OY, derive_meta16,
                                                    intra_fused_ref,
                                                    padded_dims)
    rng = np.random.default_rng(s + bd)
    maxv = (1 << bd) - 1
    P = 128
    hp, wp = padded_dims(P, P)
    x0 = y0 = 32
    yy, xx = np.mgrid[0:P, 0:P]
    strong_hits = 0
    for smooth in (False, True):
        for plane, mode, groups in _jobs(rng, s, smooth):
            img = (yy + xx) // 2 if smooth else \
                rng.integers(0, maxv + 1, (P, P))
            img = img.astype(np.int32)
            res = rng.integers(-60, 60, (s, s)).astype(np.int32)
            avail = np.concatenate([np.repeat(groups[:s // 2], 4),
                                    groups[s // 2:s // 2 + 1],
                                    np.repeat(groups[s // 2 + 1:], 4)])
            m8 = pack_meta(np.array([plane]), np.array([x0]),
                           np.array([y0]), np.array([s]),
                           np.array([mode]), avail[None].astype(np.uint8))
            meta = derive_meta16(torch.from_numpy(m8), False, False, True)
            buf = np.zeros((hp, wp), np.int32)
            buf[OY:OY + P, OX:OX + P] = img
            rbuf = np.zeros((hp, wp), np.int32)
            rbuf[OY + y0:OY + y0 + s, OX + x0:OX + x0 + s] = res
            luma = torch.from_numpy(buf if plane == 0 else 0 * buf)
            chroma = torch.zeros((2, hp, wp), dtype=torch.int32)
            if plane:
                chroma[plane - 1] = torch.from_numpy(buf)
            res_l = torch.from_numpy(rbuf if plane == 0 else 0 * rbuf)
            res_c = torch.zeros_like(chroma)
            if plane:
                res_c[plane - 1] = torch.from_numpy(rbuf)
            intra_fused_ref(meta.contiguous(), 1, luma, chroma, res_l,
                            res_c, bd)
            out = (luma if plane == 0 else chroma[plane - 1]).numpy()
            got = out[OY + y0:OY + y0 + s, OX + x0:OX + x0 + s]
            filt = plane == 0 and s > 4 and mode != 1
            pred = intra_np.intra_predict_block(
                img, x0, y0, s, mode, avail.astype(bool), plane == 0, bd,
                filter_enabled=filt, strong_smoothing=True)
            want = np.clip(pred + res, 0, maxv)
            assert np.array_equal(got, want), (plane, mode, smooth)
            # untouched outside the block
            out[OY + y0:OY + y0 + s, OX + x0:OX + x0 + s] = \
                img[y0:y0 + s, x0:x0 + s]
            assert np.array_equal(out[OY:OY + P, OX:OX + P], img)
            if s == 32 and filt and groups.any():
                ref = intra_np.substitute_refs(
                    intra_np.gather_refs(img, x0, y0, s), avail.astype(bool),
                    s, bd)
                th = 1 << (bd - 5)
                strong_hits += bool(
                    abs(ref[64] + ref[128] - 2 * ref[96]) < th and
                    abs(ref[64] + ref[0] - 2 * ref[32]) < th and
                    min(abs(mode - 26), abs(mode - 10)) > 0)
    if s == 32:
        assert strong_hits > 0


def _strong_encoder(monkeypatch):
    """encode_intra_stream with the SPS strong_intra_smoothing flag on."""
    from openhevc_tpu.encoder import hevc_enc, intra_enc
    monkeypatch.setattr(
        intra_enc, "EncoderConfig",
        lambda **kw: hevc_enc.EncoderConfig(strong_intra_smoothing=True,
                                            **kw))


FRAME_CASES = {
    "dct32_strong": dict(W=128, H=64, qp=37, ctb_log2=6, strong=True),
    "ctb4": dict(W=64, H=64, qp=30, ctb_log2=4),
    "noise_lowqp": dict(W=64, H=64, qp=6, ctb_log2=5, smooth=False),
    "pcm": dict(W=64, H=64, qp=26, ctb_log2=4, pcm=True),
}


def _frame_case(name, monkeypatch):
    kw = dict(FRAME_CASES[name])
    if kw.pop("strong", False):
        _strong_encoder(monkeypatch)
    data, recons = encode(kw.pop("W"), kw.pop("H"), seed=3, **kw)
    return data, recons


def _np_planes(data):
    from openhevc_tpu.decoder import Decoder
    d = Decoder("np")
    return [p.planes for p in d.decode(data) + d.flush()]


def _fused(fs, device, fn):
    from openhevc_tpu_torch.models.pipeline import TorchEngine, crop_pack
    k = TorchEngine(device).prepare(fs)
    fn(k["meta"], k["n"], k["luma"], k["chroma"], k["res_l"], k["res_c"],
       k["bd"])
    H, W, Hc, Wc = k["dims"]
    flat = crop_pack(k["luma"], k["chroma"], H, W, Hc, Wc).cpu().numpy()
    return [flat[:H * W].reshape(H, W),
            flat[H * W:H * W + Hc * Wc].reshape(Hc, Wc),
            flat[H * W + Hc * Wc:].reshape(Hc, Wc)]


@pytest.mark.parametrize("name", sorted(FRAME_CASES))
def test_intra_fused_ref_frame_matches_np_decoder(name, monkeypatch):
    from openhevc_tpu_torch.ops.intra_fused import intra_fused_ref
    data, recons = _frame_case(name, monkeypatch)
    fss = parsed_port(data)
    if name == "dct32_strong":
        assert fss[0].sps.strong_intra_smoothing
        assert (fss[0].native_raw["ij_meta"][:, 3] == 32).any()
    want = _np_planes(data)
    assert len(fss) == len(want) == len(recons)
    for fs, w, r in zip(fss, want, recons):
        got = _fused(fs, "cpu", intra_fused_ref)
        for c in range(3):
            assert np.array_equal(got[c], w[c]), (fs.poc, c)
            assert np.array_equal(got[c], r[c]), (fs.poc, c)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FRAME_CASES))
def test_intra_fused_kernel_matches_plain(name, monkeypatch, cuda):
    from openhevc_tpu_torch.ops.intra_fused import (intra_fused,
                                                    intra_fused_ref)
    data, _ = _frame_case(name, monkeypatch)
    for fs in parsed_port(data):
        before = intra_fused.launches
        got = _fused(fs, cuda, intra_fused)
        torch.cuda.synchronize()
        assert intra_fused.launches == before + 1
        want = _fused(fs, cuda, intra_fused_ref)
        for c in range(3):
            assert np.array_equal(got[c], want[c]), (fs.poc, c)


def test_wrapper_rejects_bad_inputs():
    from openhevc_tpu_torch.ops.intra_fused import intra_fused
    meta = torch.zeros((16, 8), dtype=torch.int32)
    luma = torch.zeros((64, 512), dtype=torch.int32)
    chroma = torch.zeros((2, 64, 512), dtype=torch.int32)
    with pytest.raises(TypeError):
        intra_fused(meta, 0, luma.float(), chroma, luma, chroma, 8)
    with pytest.raises(ValueError):
        intra_fused(meta, 9, luma, chroma, luma, chroma, 8)
    with pytest.raises(ValueError):
        intra_fused(meta, 0, luma, chroma, luma[:32], chroma, 8)
    with pytest.raises(ValueError):
        intra_fused(meta, 0, luma.T, chroma, luma, chroma, 8)
