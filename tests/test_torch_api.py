"""The port's public surface: twins of tests/test_api.py,
tests/test_api_knobs.py and tests/test_display.py on
openhevc_tpu_torch (`OpenHevc(device="cpu")`, the CLI with `-d cpu`, the
containers, the AU parser, the display sink, the knobs), each held to
the encoder's reconstruction or to the JAX package's `Decoder("np")`.
Left out: the two cases that need the C reference build. Tolerance:
none (integer samples, exact bytes)."""
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import make_frames

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _encode(seed, n=3, **kw):
    from openhevc_tpu.encoder.intra_enc import encode_intra_stream
    frames = make_frames(64, 64, n, np.random.default_rng(seed))
    kw.setdefault("ctb_log2", 4)
    return encode_intra_stream(frames, 64, 64, qp=30, seed=seed, **kw)


def _cli(*args):
    """Run the port's CLI on the CPU; returns the CompletedProcess."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "openhevc_tpu_torch",
                           *map(str, args)], capture_output=True, text=True,
                          cwd=ROOT, env=env, timeout=300)


def _yuv(recons):
    return b"".join(np.asarray(p).astype(np.uint8).tobytes()
                    for rec in recons for p in rec)


def _outputs(h):
    out = []
    while (fr := h.get_output(1)) is not None:
        out.append(fr)
    return out


def _split_ps(data):
    """(hvcC extradata, access units) of an Annex-B stream."""
    from openhevc_tpu_torch.bitstream.au_parser import AuParser
    from openhevc_tpu_torch.container.mp4 import make_hvcc
    from openhevc_tpu_torch.decoder import split_nals
    p = AuParser()
    aus = p.feed(data) + p.flush()
    ps = {t: n for n in split_nals(aus[0])
          if (t := (n[0] >> 1) & 0x3F) in (32, 33, 34)}
    return make_hvcc(ps[32], ps[33], ps[34]), aus


def _decode_samples(hvcc, samples):
    from openhevc_tpu_torch.decoder import Decoder
    d = Decoder(device="cpu")
    d.set_extradata(hvcc)
    pics = []
    for s in samples:
        pics += d.decode(s)
    return pics + d.flush()


def _assert_recons(pics, recons):
    assert len(pics) == len(recons)
    for i, pic in enumerate(pics):
        for c, (got, want) in enumerate(zip(pic.cropped(), recons[i])):
            assert np.array_equal(got, want), (i, c)


# ---- tests/test_api.py ------------------------------------------------------

def test_api_decode_with_md5():
    from openhevc_tpu_torch.api import VERSION, OpenHevc
    data, recons = _encode(5, n=2, ctb_log2=6, md5_sei=True)
    d = OpenHevc(device="cpu")
    d.set_check_md5(True)
    d.start()
    d.decode(data)
    d.flush()
    frames = _outputs(d)
    assert len(frames) == len(recons)
    for fr, want in zip(frames, recons):
        for p, w in zip(fr.planes, want):
            assert np.array_equal(p, w)
    info = frames[0].frame_info
    assert (info.nWidth, info.nHeight, info.nBitDepth) == (64, 64, 8)
    assert "openhevc_tpu_torch" in VERSION


def test_api_and_cli_default_to_the_card(tmp_path):
    from openhevc_tpu_torch.api import OpenHevc
    h = OpenHevc()
    assert h.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        h.start()
    path = tmp_path / "t.265"
    path.write_bytes(_encode(5, n=1)[0])
    r = _cli("-i", path)
    assert r.returncode == 2 and "no CUDA device" in r.stderr


def test_cli_yuv_output(tmp_path):
    data, recons = _encode(5, n=2, ctb_log2=6, md5_sei=True)
    path = tmp_path / "t.265"
    path.write_bytes(data)
    out = tmp_path / "out.yuv"
    r = _cli("-i", path, "-o", out, "-d", "cpu", "-q")
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == _yuv(recons)


def test_hvcc_extradata_input():
    """hvcC extradata + length-prefixed packets decode identically to
    the Annex-B form."""
    from openhevc_tpu_torch.api import OpenHevc
    from openhevc_tpu_torch.decoder import split_nals
    data, recons = _encode(21, n=2, ctb_log2=6)
    ps = {32: [], 33: [], 34: []}
    aus = []
    for nal in split_nals(data):
        t = (nal[0] >> 1) & 0x3F
        (ps[t] if t in ps else aus).append(nal)
    hvcc = bytes([1]) + bytes(20) + bytes([0xFC | 3]) + bytes([3])
    for t in (32, 33, 34):
        hvcc += bytes([t]) + len(ps[t]).to_bytes(2, "big")
        for nal in ps[t]:
            hvcc += len(nal).to_bytes(2, "big") + nal
    h = OpenHevc(device="cpu")
    h.start()
    h.copy_extradata(hvcc)
    out = []
    for nal in aus:
        h.decode(len(nal).to_bytes(4, "big") + nal)
        out += _outputs(h)
    h.flush()
    out += _outputs(h)
    assert len(out) == len(recons)
    for fr, want in zip(out, recons):
        for p, w in zip(fr.planes, want):
            assert np.array_equal(p, w)


def test_au_parser():
    """AU boundaries: multi-slice AUs stay whole, parameter sets attach
    to the following AU, chunked feeding reassembles, and per-AU info
    reports pict_type / IRAP; equal to the JAX package's parser."""
    from openhevc_tpu.bitstream import au_parser as ref
    from openhevc_tpu_torch.bitstream.au_parser import AuParser, au_info
    data, _ = _encode(131, num_slices=2)
    p = AuParser()
    aus = p.feed(data) + p.flush()
    assert len(aus) == 3
    assert b"".join(aus) == data
    i0 = au_info(aus[0])
    assert i0.pict_type == "I" and i0.irap and i0.idr
    assert 32 in i0.nal_types and 33 in i0.nal_types
    assert sum(1 for t in i0.nal_types if t <= 31) == 2
    p = AuParser()
    aus2 = []
    for i in range(0, len(data), 7):
        aus2 += p.feed(data[i:i + 7])
    aus2 += p.flush()
    assert aus2 == aus
    q = ref.AuParser()
    assert q.feed(data) + q.flush() == aus
    assert [vars(au_info(a)) for a in aus] == \
        [vars(ref.au_info(a)) for a in aus]


def test_mp4_roundtrip(tmp_path):
    """Mux an encoded stream into ISO-BMFF, demux it back, decode via
    hvcC extradata + length-prefixed samples, and drive the CLI on it."""
    from openhevc_tpu.container import mux_mp4 as ref_mux
    from openhevc_tpu_torch.container import demux_mp4, is_mp4, mux_mp4
    from openhevc_tpu_torch.container.mp4 import annexb_to_length_prefixed
    data, recons = _encode(161)
    hvcc, aus = _split_ps(data)
    samples = [annexb_to_length_prefixed(au) for au in aus]
    mp4 = mux_mp4(samples, hvcc, 64, 64)
    assert is_mp4(mp4) and mp4 == ref_mux(samples, hvcc, 64, 64)
    hvcc2, samples2, nls = demux_mp4(mp4)
    assert hvcc2 == hvcc and samples2 == samples and nls == 4
    _assert_recons(_decode_samples(hvcc2, samples2), recons)
    f, out = tmp_path / "t.mp4", tmp_path / "o.yuv"
    f.write_bytes(mp4)
    r = _cli("-i", f, "-o", out, "-d", "cpu", "-c")
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == _yuv(recons)


def test_ts_roundtrip(tmp_path):
    from openhevc_tpu_torch.bitstream.au_parser import AuParser
    from openhevc_tpu_torch.container import demux_ts, is_ts, mux_ts
    from openhevc_tpu_torch.decoder import Decoder
    data, recons = _encode(171)
    p = AuParser()
    aus = p.feed(data) + p.flush()
    ts = mux_ts(aus)
    assert is_ts(ts) and len(ts) % 188 == 0
    assert not is_ts(data)
    es = demux_ts(ts)
    assert es == b"".join(aus)
    d = Decoder(device="cpu")
    _assert_recons(d.decode(es) + d.flush(), recons)
    f, out = tmp_path / "t.ts", tmp_path / "o.yuv"
    f.write_bytes(ts)
    r = _cli("-i", f, "-o", out, "-d", "cpu", "-c")
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == _yuv(recons)


def test_mkv_roundtrip(tmp_path):
    from openhevc_tpu_torch.container import demux_mkv, is_mkv, mux_mkv
    from openhevc_tpu_torch.container.mp4 import annexb_to_length_prefixed
    data, recons = _encode(191)
    hvcc, aus = _split_ps(data)
    samples = [annexb_to_length_prefixed(au) for au in aus]
    mkv = mux_mkv(samples, hvcc, 64, 64)
    assert is_mkv(mkv) and not is_mkv(data)
    hvcc2, samples2, nls = demux_mkv(mkv)
    assert hvcc2 == hvcc and samples2 == samples and nls == 4
    _assert_recons(_decode_samples(hvcc2, samples2), recons)
    f, out = tmp_path / "t.mkv", tmp_path / "o.yuv"
    f.write_bytes(mkv)
    r = _cli("-i", f, "-o", out, "-d", "cpu", "-c")
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == _yuv(recons)


def test_mkv_long_stream_clusters():
    """Clusters split before the int16 relative timestamp overflows: a
    900-frame stream at 25 fps (36 s) round-trips."""
    from openhevc_tpu_torch.container import demux_mkv, mux_mkv
    samples = [bytes((0, 0, 0, 2, 0x26, i & 0xFF)) for i in range(900)]
    hvcc = bytes(22) + bytes([3]) + b"\x00"
    mkv = mux_mkv(samples, hvcc, 64, 64, fps=25)
    assert demux_mkv(mkv)[1] == samples


def test_mkv_blockgroup_and_lacing():
    """BlockGroup / Block wrapping and all three lacing modes."""
    from openhevc_tpu_torch.container import demux_mkv
    from openhevc_tpu_torch.container.mkv import (
        _el, _el_uint, EBML_HEADER, SEGMENT, TRACKS, TRACK_ENTRY,
        TRACK_NUMBER, TRACK_TYPE, CODEC_ID, CODEC_PRIVATE, CLUSTER,
        TIMESTAMP, SIMPLE_BLOCK, BLOCK_GROUP, BLOCK, HEVC_CODEC_ID)
    hvcc = bytes(22) + bytes([3]) + b"\x00"
    frames = [bytes([k] * (3 + k)) for k in range(5)]

    def blk(payload, flags):
        return b"\x81\x00\x00" + bytes([flags]) + payload

    bg = _el(BLOCK_GROUP, _el(BLOCK, blk(frames[0], 0x00)))
    xiph = blk(bytes([1, len(frames[1])]) + frames[1] + frames[2], 0x02)
    ebml = blk(bytes([1, 0x80 | len(frames[3])]) + frames[3] + frames[4],
               0x06)
    eq = bytes([7] * 4)
    fixed = blk(bytes([1]) + eq + eq, 0x04)
    cluster = _el(CLUSTER, _el_uint(TIMESTAMP, 0) + bg +
                  _el(SIMPLE_BLOCK, xiph) + _el(SIMPLE_BLOCK, ebml) +
                  _el(SIMPLE_BLOCK, fixed))
    track = _el(TRACKS, _el(TRACK_ENTRY,
                _el_uint(TRACK_NUMBER, 1) + _el_uint(TRACK_TYPE, 1) +
                _el(CODEC_ID, HEVC_CODEC_ID) + _el(CODEC_PRIVATE, hvcc)))
    data = _el(EBML_HEADER, b"") + _el(SEGMENT, track + cluster)
    assert demux_mkv(data)[1] == frames + [eq, eq]


def test_ts_multipacket_psi_and_pes_header():
    """PSI sections and PES headers accumulate across packet boundaries,
    and the mux stamps a PCR on the video PID."""
    from openhevc_tpu_torch.container import demux_ts, mux_ts
    from openhevc_tpu_torch.container.ts import (
        _ts_packets, _psi_section, TS_PKT, PMT_PID, HEVC_PID,
        HEVC_STREAM_TYPE)
    es = b"\x00\x00\x01\x40\x01" + bytes(range(256)) * 3
    ts = mux_ts([es])
    found_pcr = False
    for off in range(0, len(ts), TS_PKT):
        pkt = ts[off:off + TS_PKT]
        pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
        if pid == HEVC_PID and (pkt[3] >> 4) & 2 and pkt[4] > 0:
            found_pcr |= bool(pkt[5] & 0x10)
    assert found_pcr
    assert demux_ts(ts) == es
    cc = {}
    out = bytearray()
    pat_body = bytes((0x00, 0x01, 0xE0 | (PMT_PID >> 8), PMT_PID & 0xFF))
    out += _ts_packets(0, b"\x00" + _psi_section(0x00, 1, pat_body), cc,
                       True)
    pmt_body = bytes((0xE0 | (HEVC_PID >> 8), HEVC_PID & 0xFF, 0xF0, 0x00,
                      HEVC_STREAM_TYPE, 0xE0 | (HEVC_PID >> 8),
                      HEVC_PID & 0xFF, 0xF2, 0x00)) + b"\xff" * 0x200
    out += _ts_packets(PMT_PID, b"\x00" + _psi_section(0x02, 1, pmt_body),
                       cc, True)
    hdr_len = 250
    pes = b"\x00\x00\x01\xe0\x00\x00" + bytes((0x80, 0x00, hdr_len)) + \
        b"\xff" * hdr_len + es
    out += _ts_packets(HEVC_PID, pes, cc, True)
    assert demux_ts(bytes(out)) == es


def test_ogg_roundtrip(tmp_path):
    """BOS mapping, lacing and CRC round-trip, a packet larger than one
    page's lacing capacity, a corrupt-page resync; decode and CLI."""
    from openhevc_tpu_torch.container import demux_ogg, is_ogg, mux_ogg
    from openhevc_tpu_torch.container.mp4 import annexb_to_length_prefixed
    data, recons = _encode(201)
    hvcc, aus = _split_ps(data)
    samples = [annexb_to_length_prefixed(au) for au in aus]
    ogg = mux_ogg(samples, hvcc)
    assert is_ogg(ogg) and not is_ogg(data)
    hvcc2, samples2, nls = demux_ogg(ogg)
    assert hvcc2 == hvcc and samples2 == samples and nls == 4
    bad = bytearray(ogg)
    bad[ogg.find(samples[1][:8])] ^= 0xFF
    assert len(demux_ogg(bytes(bad))[1]) < len(samples)
    big = bytes(np.random.default_rng(201).integers(0, 256, 70000,
                                                    dtype=np.uint8))
    assert demux_ogg(mux_ogg([big], hvcc))[1] == [big]
    _assert_recons(_decode_samples(hvcc2, samples2), recons)
    f, out = tmp_path / "t.ogg", tmp_path / "o.yuv"
    f.write_bytes(ogg)
    r = _cli("-i", f, "-o", out, "-d", "cpu", "-c")
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == _yuv(recons)


# ---- tests/test_api_knobs.py ------------------------------------------------

def _ra_stream_with_sublayers(rng, n=9):
    from openhevc_tpu.encoder.inter_enc import encode_ra_stream
    fr = make_frames(96, 64, n, rng)
    return encode_ra_stream(fr, 96, 64, qp=30, gop=8, ctb_log2=4, seed=5,
                            temporal_ids=True)[0]


def _decode_pocs(data, temporal_layer=None):
    from openhevc_tpu_torch.decoder import Decoder
    d = Decoder(device="cpu", temporal_layer=temporal_layer)
    return {p.poc: p.cropped() for p in d.decode(data) + d.flush()}


def test_temporal_layer_gating_drops_sublayers(rng):
    """temporal_layer=k keeps only pictures with temporal_id <= k; the
    kept pictures decode as in a full decode, which equals
    `Decoder("np")`."""
    from openhevc_tpu.decoder import Decoder as NpDecoder
    data = _ra_stream_with_sublayers(rng)
    full = _decode_pocs(data)
    assert len(full) == 9
    d = NpDecoder("np")
    want = {p.poc: p.cropped() for p in d.decode(data) + d.flush()}
    for poc in want:
        for c in range(3):
            assert np.array_equal(full[poc][c], want[poc][c])
    for tl, want_pocs in [(0, {0, 8}), (1, {0, 4, 8}), (2, {0, 2, 4, 6, 8})]:
        got = _decode_pocs(data, temporal_layer=tl)
        assert set(got) == want_pocs, (tl, sorted(got))
        for poc in want_pocs:
            for c in range(3):
                assert np.array_equal(got[poc][c], full[poc][c]), (tl, poc)


def test_api_temporal_layer_knob(rng):
    from openhevc_tpu_torch.api import OpenHevc
    data = _ra_stream_with_sublayers(rng)
    h = OpenHevc(device="cpu")
    h.start()
    h.set_temporal_layer_id(0)        # wrapper val 0 -> keep tid <= 1
    h.decode(data)
    h.flush()
    pocs = [f.frame_info.display_picture_number for f in _outputs(h)]
    assert sorted(pocs) == [0, 4, 8]


def test_frame_info_vui(rng):
    from openhevc_tpu.encoder.intra_enc import encode_intra_stream
    from openhevc_tpu_torch.api import OpenHevc
    fr = make_frames(64, 64, 1, rng)
    data, _ = encode_intra_stream(fr, 64, 64, qp=30, ctb_log2=4, seed=77,
                                  vui_timing=True)
    h = OpenHevc(device="cpu")
    h.start()
    h.decode(data)
    h.flush()
    f = h.get_output(1)
    assert f is not None
    assert f.frame_info.frameRate == (60000, 1000)
    assert f.frame_info.sample_aspect_ratio == (1, 1)


def test_strict_mode_raises_on_missing_ref(rng):
    """Default: a P picture whose reference was never decoded is
    concealed, as `Decoder("np")` conceals it; strict: DecodeError."""
    from openhevc_tpu.decoder import Decoder as NpDecoder
    from openhevc_tpu.encoder.inter_enc import encode_lowdelay_stream
    from openhevc_tpu_torch.decoder import DecodeError, Decoder, split_nals
    fr = make_frames(64, 64, 3, rng)
    data, _ = encode_lowdelay_stream(fr, 64, 64, qp=30, ctb_log2=4, seed=1)
    keep, dropped = [], False
    for n in split_nals(data):
        if (n[0] >> 1) & 0x3F <= 31 and not dropped:
            dropped = True
            continue
        keep.append(b"\x00\x00\x01" + n)
    damaged = b"".join(keep)
    d = Decoder(device="cpu")
    pics = d.decode(damaged) + d.flush()
    assert pics
    r = NpDecoder("np")
    want = r.decode(damaged) + r.flush()
    assert [p.poc for p in pics] == [p.poc for p in want]
    for a, b in zip(pics, want):
        for c in range(3):
            assert np.array_equal(a.cropped()[c], b.cropped()[c])
    d = Decoder(device="cpu", strict=True)
    with pytest.raises(DecodeError):
        d.decode(damaged)
        d.flush()


def test_decoder_config_dataclass():
    from openhevc_tpu_torch.config import DecoderConfig
    from openhevc_tpu_torch.decoder import Decoder, ShvcDecoder
    assert DecoderConfig().device == "cuda"
    c = DecoderConfig(device="cpu", nb_threads=4, thread_type=2,
                      temporal_layer=1, strict=True)
    d = Decoder(config=c)
    assert d.engine == "torch" and d.device.type == "cpu"
    assert d.temporal_layer == 1 and d.strict
    assert d._parse_depth == 1 and d._parse_threads == 4
    d2 = Decoder(device="cpu", nb_threads=4, thread_type=2,
                 temporal_layer=1, strict=True)
    assert (d2._parse_depth, d2._parse_threads) == (1, 4)
    c3 = DecoderConfig(nb_threads=4, thread_type=2, parse_ahead=3,
                       parse_threads=2)
    assert c3.resolved_threads() == (3, 2)
    s = ShvcDecoder(config=DecoderConfig(device="cpu"))
    assert s.bl.engine == "torch" and s.el.layer == 1
    assert s.el.shvc_bl is s.bl


def test_decoder_config_env(monkeypatch):
    from openhevc_tpu_torch.config import DecoderConfig
    monkeypatch.setenv("OPENHEVC_PARSE_AHEAD", "5")
    monkeypatch.setenv("OPENHEVC_PARSE_THREADS", "3")
    c = DecoderConfig.from_env(device="cpu")
    assert c.parse_ahead == 5 and c.parse_threads == 3
    assert c.resolved_threads() == (5, 3)


# ---- tests/test_display.py --------------------------------------------------

def test_yuv_to_rgb_anchors():
    from openhevc_tpu.display import yuv_to_rgb as ref
    from openhevc_tpu_torch.display import yuv_to_rgb
    y = np.array([[16, 235, 81]], np.int32)
    u = np.array([[128, 128, 90]], np.int32)
    v = np.array([[128, 128, 240]], np.int32)
    rgb = yuv_to_rgb(y, u, v)
    assert rgb.shape == (1, 3, 3)
    assert (rgb[0, 0] == [0, 0, 0]).all()
    assert (rgb[0, 1] == [255, 255, 255]).all()
    assert rgb[0, 2, 0] > 200 and rgb[0, 2, 1] < 60 and rgb[0, 2, 2] < 60
    assert np.array_equal(rgb, ref(y, u, v))


def test_yuv_to_rgb_10bit():
    from openhevc_tpu_torch.display import yuv_to_rgb
    rgb = yuv_to_rgb(np.full((2, 2), 940), np.full((2, 2), 512),
                     np.full((2, 2), 512), bit_depth=10)
    assert (rgb == 255).all()


def test_render_frame_dims_and_ansi():
    from openhevc_tpu.display import render_frame as ref
    from openhevc_tpu_torch.display import render_frame
    rng = np.random.default_rng(0)
    planes = [rng.integers(16, 235, (48, 64)),
              rng.integers(16, 240, (24, 32)),
              rng.integers(16, 240, (24, 32))]
    art = render_frame(planes, cols=20)
    lines = art.split("\n")
    for ln in lines:
        assert ln.count("▀") == 20
        assert ln.endswith("\x1b[0m")
    assert len(lines) >= 2
    assert art == ref(planes, cols=20)


def test_terminal_display_paces_and_writes():
    from openhevc_tpu_torch.display import TerminalDisplay
    out = io.StringIO()
    d = TerminalDisplay(fps=1000.0, cols=16, out=out)
    y = np.full((16, 16), 128)
    c = np.full((8, 8), 128)
    d.show([y, c, c])
    d.show([y, c, c])
    s = out.getvalue()
    assert s.count("▀") > 0
    assert "\x1b[2J" in s
    assert d._shown == 2


def test_y4m_roundtrip_header_and_frames():
    from openhevc_tpu_torch.display import y4m_frame, y4m_header
    hdr = y4m_header(64, 48, 30, 1, hs=1, vs=1, bit_depth=8)
    assert hdr == b"YUV4MPEG2 W64 H48 F30:1 Ip A0:0 C420jpeg\n"
    assert b"C444p10" in y4m_header(8, 8, 25, 1, hs=0, vs=0, bit_depth=10)
    y = np.arange(64 * 48, dtype=np.int32).reshape(48, 64) & 255
    u = np.full((24, 32), 1, np.int32)
    v = np.full((24, 32), 2, np.int32)
    fr = y4m_frame([y, u, v])
    assert fr.startswith(b"FRAME\n")
    assert len(fr) == 6 + 64 * 48 + 2 * 24 * 32
    got_y = np.frombuffer(fr[6:6 + 64 * 48], np.uint8).reshape(48, 64)
    assert np.array_equal(got_y, y.astype(np.uint8))
