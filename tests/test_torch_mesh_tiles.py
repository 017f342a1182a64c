"""Port picture waves on the tile axis of a 2-D mesh ("frame", "tile")
(openhevc_tpu_torch/parallel/mesh.py): `apply_filters_device(ybounds=)`
against the JAX package's on halo bands; the band-sharded filters
(`band_filters`) over T = 2, 3, 4 bands against the whole-frame filter
and the reference's CTB schedule on real pictures (CTB 16 / 32 / 64,
PCM, transquant bypass, 4:2:0 / 4:2:2 / 4:4:4); each tile shard's
residual TUs and intra jobs against the JAX package's
`_split_res_tiles` / `_group_intra_tiles`; the dense level renumbering
of a shard's jobs against the dependency invariant; whole decodes on a
2 x 4 mesh against `Decoder("jax", mesh=2-D Mesh)` and `Decoder("np")`.
Tolerance: none (integer samples, exact equality)."""
import numpy as np
import pytest
import torch

from conftest import make_frames
from test_device_filters import _capture_frames, _frames_fmt
from test_torch_parse import parsed_jax, parsed_port

CPU = torch.device("cpu")


# ---- the filters over bands ------------------------------------------------------

# name -> (chroma format, W, H, log2 CTB, PCM, transquant bypass)
FILTER_CASES = {
    "ctb16_420_part_row": (1, 72, 72, 4, False, False),
    "ctb16_420_pcm": (1, 64, 64, 4, True, False),
    "ctb16_420_tqb": (1, 64, 80, 4, False, True),
    "ctb32_420": (1, 64, 128, 5, False, False),
    "ctb64_420": (1, 128, 128, 6, False, False),
    "ctb16_422": (2, 64, 64, 4, False, False),
    "ctb32_422_pcm": (2, 96, 96, 5, True, False),
    "ctb16_444": (3, 96, 64, 4, False, False),
    "ctb32_444_pcm": (3, 64, 96, 5, True, False),
}
_CAPTURED = {}       # name -> _capture_frames(...) (np decodes, the slow part)


def _captured(name):
    if name not in _CAPTURED:
        from openhevc_tpu.encoder.intra_enc import encode_intra_stream
        fmt, W, H, ctb, pcm, tqb = FILTER_CASES[name]
        seed = 60 + sorted(FILTER_CASES).index(name)
        frames = _frames_fmt(W, H, 2, np.random.default_rng(seed), fmt)
        kw = dict(qp=34, ctb_log2=ctb, seed=seed, pcm=pcm, sao=True,
                  deblock=True, chroma_format_idc=fmt, min_cb_log2=3)
        if tqb:
            kw["transquant_bypass"] = True
        data, _ = encode_intra_stream(frames, W, H, **kw)
        _CAPTURED[name] = _capture_frames(data)
    return _CAPTURED[name]


def _plan(fs):
    """The picture's filter plan (device route) and its arguments on the
    CPU (`plan.args` on the plan's arrays as CPU tensors)."""
    from openhevc_tpu_torch.ops.filters import plan_filters
    plan = plan_filters(fs)
    assert plan.route == "device"
    return plan, plan.args({k: torch.from_numpy(np.ascontiguousarray(a))
                            for k, a in plan.arrays.items()})


def _whole(pre, fs):
    """The port's whole-frame device filters: (plan, args, planes,
    [y, cb, cr])."""
    plan, args = _plan(fs)
    planes = [torch.from_numpy(np.asarray(p, np.int32)) for p in pre]
    out = plan.apply(*planes, args)
    return plan, args, planes, [o.numpy() for o in out]


@pytest.mark.parametrize("T", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(FILTER_CASES))
def test_band_filters_equal_whole_frame(name, T):
    from openhevc_tpu_torch.parallel.mesh import band_filters
    n = 0
    for pre, fs, truth in _captured(name):
        plan, args, planes, want = _whole(pre, fs)
        assert (fs.sps.log2_ctb, fs.sps.chroma_format_idc) == \
            (FILTER_CASES[name][3], FILTER_CASES[name][0])
        got = band_filters(*planes, plan, args, devices=[CPU] * T)
        for c in range(3):
            assert got[c].dtype == torch.int32
            assert np.array_equal(got[c].numpy(), want[c]), (c, T)
            assert np.array_equal(got[c].numpy().astype(np.int64),
                                  truth[c]), c
        n += 1
    assert n == 2


@pytest.mark.parametrize("name", ["ctb16_420_part_row", "ctb32_422_pcm",
                                  "ctb16_444"])
def test_ybounds_matches_jax_on_bands(name):
    """The JAX package's `apply_filters_device` on its own `prep_filters`
    arrays and the port's filter plan (`plan.apply`) on its arguments,
    both cut to the same halo bands (`band_units`, with `ybounds` in band
    coordinates), every band of a 3-band split: equal."""
    import jax.numpy as jnp
    from openhevc_tpu.ops import filters_jax as JF
    from openhevc_tpu_torch.parallel.mesh import _band_rows, band_units
    pre, fs, _truth = _captured(name)[0]
    sps = fs.sps
    cs = 1 << sps.log2_ctb
    csv = cs >> sps.vshift1
    T = 3
    rb = -(-sps.ctbs_h // T)
    H, Hc = sps.height, sps.height >> sps.vshift1
    pff = JF.prep_filters(fs)
    plan, args = _plan(fs)
    assert set(args) == set(pff) - {"do_deblock", "do_sao"}
    units = band_units(cs, csv)
    kw = dict(bd=sps.bit_depth, bdc=sps.bit_depth_chroma, cs=cs,
              do_deblock=pff["do_deblock"], do_sao=pff["do_sao"],
              hs=sps.hshift1, vs=sps.vshift1)
    for g in range(T):
        if g * rb >= sps.ctbs_h:
            continue
        planes = [_band_rows(np.asarray(p, np.int32), g, rb, u)
                  for p, u in zip(pre, (cs, csv, csv))]
        grids = [_band_rows(np.asarray(a), g, rb, units[k]) if k in pff
                 else a for k, a in zip(JF.FARG_KEYS, JF.fargs_arrays(pff))]
        yb = ((cs - g * rb * cs, H + cs - g * rb * cs),
              (csv - g * rb * csv, Hc + csv - g * rb * csv))
        want = JF.apply_filters_device(
            *(jnp.asarray(p) for p in planes),
            *(jnp.asarray(a) for a in grids), ybounds=yb, **kw)
        got = plan.apply(
            *(torch.from_numpy(p) for p in planes),
            {k: _band_rows(a, g, rb, units[k]) for k, a in args.items()},
            ybounds=yb)
        for c in range(3):
            assert np.array_equal(got[c].numpy(), np.asarray(want[c])), \
                (g, c)


# ---- the shards' work --------------------------------------------------------------

def _tiled_444():
    from openhevc_tpu.encoder.intra_enc import encode_intra_stream
    from test_torch_rext import frames_fmt
    frames = frames_fmt(64, 64, 3, 7, idc=3)
    return encode_intra_stream(frames, 64, 64, qp=30, ctb_log2=4, seed=7,
                               tile_cols=2, tile_rows=2, sao=True,
                               deblock=True, chroma_format_idc=3)[0]


def _intra(W, H, n, seed, **kw):
    from openhevc_tpu.encoder.intra_enc import encode_intra_stream
    frames = make_frames(W, H, n, np.random.default_rng(seed))
    return encode_intra_stream(frames, W, H, seed=seed, **kw)[0]


def _ra(seed, n):
    from openhevc_tpu.encoder.inter_enc import encode_ra_stream
    frames = make_frames(64, 64, n, np.random.default_rng(seed))
    return encode_ra_stream(frames, 64, 64, qp=31, gop=8, seed=seed)[0]


def _ra_tiles():
    import test_torch_inter as ti
    return ti.stream("ra_tiles")


TILED = {
    "intra_3x2": lambda: _intra(96, 64, 4, 31, qp=30, ctb_log2=4,
                                tile_cols=3, tile_rows=2, sao=True,
                                deblock=True),
    "ra_tiles": _ra_tiles,
    "444_2x2": _tiled_444,
}


def _jax_shard_sets(fs, T):
    """Per tile shard, the residual TUs and intra jobs the JAX package's
    mesh gives it, as sets of (plane, x, y, size)."""
    from openhevc_tpu.parallel.mesh import MeshFrameDecoder
    m = MeshFrameDecoder.__new__(MeshFrameDecoder)
    m.n_frame, m.n_tile = 1, T
    _pfs, _npad, res, intra, *_ = m._stack_wave([fs], want_intra=True)
    gmaps = m._tile_group_map(fs)[None]
    res_t = m._split_res_tiles(res, T, gmaps, fs.sps)
    intra_t = m._group_intra_tiles(intra, gmaps, fs.sps)
    tus = [set() for _ in range(T)]
    jobs = [set() for _ in range(T)]
    for s, f in res_t.items():
        for t in range(T):
            keep = f["plane"][0, t] != 3
            tus[t] |= {(int(p), int(x) * s, int(y) * s, s) for p, x, y in
                       zip(f["plane"][0, t][keep], f["bx"][0, t][keep],
                           f["by"][0, t][keep])}
    for s, a in intra_t.items():
        for t in range(T):
            keep = a["valid"][0, t] != 0
            jobs[t] |= {(int(p), int(x), int(y), s) for p, x, y in
                        zip(a["plane"][0, t][keep], a["x"][0, t][keep],
                            a["y"][0, t][keep])}
    return gmaps[0], tus, jobs


def _port_shard_sets(fs, T):
    from openhevc_tpu_torch.models.pipeline import _res_buckets, host_pack
    from openhevc_tpu_torch.ops.intra_fused import (OX, OY,
                                                    meta6_tile_group,
                                                    tile_group_of)
    from openhevc_tpu_torch.parallel.mesh import tile_group_map
    sps = fs.sps
    gmap = tile_group_map(fs, T)
    tus = [set() for _ in range(T)]
    for s, b in _res_buckets(fs).items():
        grp = tile_group_of(gmap, b["plane"], b["x"], b["y"], sps.log2_ctb,
                            sps.hshift1, sps.vshift1)
        for p, x, y, g in zip(b["plane"], b["x"], b["y"], grp):
            tus[g].add((int(p), int(x), int(y), s))
    npk = host_pack(fs)
    jobs = []
    for g in range(T):
        m, n, _nl = meta6_tile_group(npk["meta6"], npk["n"], gmap, g,
                                     sps.log2_ctb, sps.hshift1, sps.vshift1)
        jobs.append({(int(r2 >> 2) & 3, int(x) - OX, int(y) - OY,
                      4 << (int(r2) & 3))
                     for y, x, r2 in zip(m[0], m[1], m[2])})
    return gmap, tus, jobs


@pytest.mark.parametrize("T", [2, 3])
@pytest.mark.parametrize("name", sorted(TILED))
def test_shard_work_matches_jax_split(name, T):
    data = TILED[name]()
    fj, fp = parsed_jax(data), parsed_port(data)
    assert len(fj) == len(fp) > 0
    groups_used = set()
    for a, b in zip(fj, fp):
        gj, tus_j, jobs_j = _jax_shard_sets(a, T)
        gp, tus_p, jobs_p = _port_shard_sets(b, T)
        assert np.array_equal(gj, gp)
        assert tus_p == tus_j
        assert jobs_p == jobs_j
        groups_used |= {g for g in range(T) if jobs_p[g]}
    assert groups_used == set(range(T))


@pytest.mark.parametrize("name", sorted(TILED))
def test_shard_residuals_partition_the_picture(name):
    """`_residual_acc(group=...)` of the tile groups: each is zero
    outside its group's CTBs and they add up to the whole residual."""
    from openhevc_tpu_torch.models.pipeline import (_residual_acc,
                                                    host_pack)
    from openhevc_tpu_torch.parallel.mesh import _expand, tile_group_map
    T = 2
    for fs in parsed_port(TILED[name]()):
        sps = fs.sps
        H, W = sps.height, sps.width
        Hc, Wc = H >> sps.vshift1, W >> sps.hshift1
        npk = host_pack(fs)
        args = [torch.from_numpy(np.ascontiguousarray(npk[k]))
                for k in ("arena4", "arena16", "esc")]
        kw = dict(caps=npk["caps"], H=H, W=W, Hc=Hc, Wc=Wc,
                  bd=sps.bit_depth)
        whole = _residual_acc(*args, **kw)
        gmap = torch.from_numpy(tile_group_map(fs, T))
        cs = 1 << sps.log2_ctb
        ml = _expand(gmap, cs, cs, H, W)
        mc = _expand(gmap, cs >> sps.vshift1, cs >> sps.hshift1, Hc, Wc)
        sum_l, sum_c = torch.zeros_like(whole[0]), torch.zeros_like(whole[1])
        for g in range(T):
            acc_l, acc_c = _residual_acc(
                *args, group=(gmap, g, sps.log2_ctb, sps.hshift1,
                              sps.vshift1), **kw)
            assert not acc_l[ml != g].any()
            assert not acc_c[:, mc != g].any()
            sum_l += acc_l
            sum_c += acc_c
        assert torch.equal(sum_l, whole[0]) and torch.equal(sum_c, whole[1])
        assert whole[0].any()


def _ref_coords(x, y, s):
    i = np.arange(2 * s)
    return (np.concatenate([np.full(2 * s, x - 1), [x - 1], x + i]),
            np.concatenate([y + 2 * s - 1 - i, [y - 1], np.full(2 * s, y - 1)]))


@pytest.mark.parametrize("T", [2, 3])
@pytest.mark.parametrize("name", sorted(TILED))
def test_dense_levels_keep_every_dependency(name, T):
    """A shard's jobs keep their meta order and columns; their levels
    run 1..n_levels with none empty, in the old levels' order; every
    available neighbour of a job was written by a job of the same group
    at a strictly lower new level, or by no job (another tile's samples
    are never available)."""
    from openhevc_tpu_torch.ops.intra_fused import (meta6_tile_group,
                                                    tile_group_of)
    from openhevc_tpu_torch.parallel.mesh import tile_group_map
    checked = 0
    for fs in parsed_port(TILED[name]()):
        sps = fs.sps
        im, iav = fs.native_raw["ij_meta"], fs.native_raw["ij_avail"]
        npk = fs.native_pack
        gmap = tile_group_map(fs, T)
        grp = tile_group_of(gmap, im[:, 0], im[:, 1], im[:, 2],
                            sps.log2_ctb, sps.hshift1, sps.vshift1)
        H, W = sps.height, sps.width
        dims = [(H, W)] + [(H >> sps.vshift1, W >> sps.hshift1)] * 2
        new = np.zeros(len(im), np.int64)
        for g in range(T):
            sel = np.nonzero(grp == g)[0]
            m, n, nl = meta6_tile_group(npk["meta6"], npk["n"], gmap, g,
                                        sps.log2_ctb, sps.hshift1,
                                        sps.vshift1)
            assert n == len(sel) == m.shape[1]
            assert np.array_equal(m[:5], npk["meta6"][:5, sel])
            lv = m[5].astype(np.int64)
            assert sorted(set(lv.tolist())) == list(range(1, nl + 1))
            old = im[sel, 6]
            assert np.array_equal(np.argsort(lv, kind="stable"),
                                  np.argsort(old, kind="stable"))
            new[sel] = lv
        writer = [np.full(d, -1, np.int64) for d in dims]
        for j, (plane, x, y, s) in enumerate(im[:, :4].tolist()):
            writer[plane][y:y + s, x:x + s] = j
        for j, (plane, x, y, s) in enumerate(im[:, :4].tolist()):
            xs, ys = _ref_coords(x, y, s)
            av = iav[j, :4 * s + 1] != 0
            wj = writer[plane][ys[av], xs[av]]
            wj = wj[wj >= 0]
            assert (grp[wj] == grp[j]).all(), (fs.poc, j)
            assert (new[wj] < new[j]).all(), (fs.poc, j)
            checked += len(wj)
    assert checked > 0


# ---- whole decodes on the 2-D mesh ---------------------------------------------

TILE_AXIS = {          # tests/test_parallel.py's 2-D-mesh streams, + 4:4:4
    "intra_3x2_filters": (TILED["intra_3x2"], 4),
    "untiled": (lambda: _intra(64, 64, 4, 32, qp=30), 4),
    "ra_inter": (lambda: _ra(33, 9), 9),
    "444_2x2_filters": (_tiled_444, 3),
}


@pytest.mark.parametrize("name", sorted(TILE_AXIS))
def test_tile_axis_decode_matches_jax_mesh_and_np(name, monkeypatch):
    import jax
    from jax.sharding import Mesh
    from openhevc_tpu.decoder import Decoder as JaxDecoder
    from openhevc_tpu.parallel import MeshFrameDecoder as JaxMesh
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.models.pipeline import TorchEngine
    from openhevc_tpu_torch.parallel import DeviceMesh, MeshFrameDecoder
    make, n = TILE_AXIS[name]
    data = make()
    pocs = {MeshFrameDecoder: [], JaxMesh: []}
    for cls, seen in pocs.items():
        def spy(this, fs_list, refs_list=None, orig=cls.reconstruct_wave,
                seen=seen):
            seen.append([fs.poc for fs in fs_list])
            return orig(this, fs_list, refs_list)
        monkeypatch.setattr(cls, "reconstruct_wave", spy)
    shards = []
    prepare = TorchEngine.prepare

    def spy_prepare(self, fs, ref_planes=None, shard=None):
        k = prepare(self, fs, ref_planes, shard)
        shards.append((None if shard is None else shard[1], k["n"]))
        return k
    monkeypatch.setattr(TorchEngine, "prepare", spy_prepare)

    mesh = DeviceMesh([["cpu"] * 4] * 2, ("frame", "tile"))
    got, pics = _decode(Decoder(device="cpu", mesh=mesh), data)
    want_np = _decode(JaxDecoder("np"), data)[0]
    devs = jax.devices("cpu")
    jmesh = Mesh(np.array(devs[:8]).reshape(2, 4), ("frame", "tile"))
    want_jax = _decode(JaxDecoder("jax", mesh=jmesh), data)[0]
    assert len(got) == n
    _assert_same(got, want_np)
    _assert_same(got, want_jax)
    assert pocs[MeshFrameDecoder] == pocs[JaxMesh]
    assert len(shards) == 4 * n and {g for g, _ in shards} == set(range(4))
    if name == "untiled":       # every job in group 0; the others idle
        assert all(nj == 0 for g, nj in shards if g)
        assert all(nj > 0 for g, nj in shards if g == 0)
    elif name != "ra_inter":
        assert all(nj > 0 for g, nj in shards if g < 4)
    assert all(p.planes.device_filtered == ("filters" in name) for p in pics)


def _decode(dec, data):
    pics = dec.decode(data) + dec.flush()
    return [[np.asarray(c, np.int64) for c in p.cropped()] for p in pics], \
        pics


def _assert_same(got, want):
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        for c in range(3):
            assert np.array_equal(g[c], w[c]), (i, c)


def test_host_filter_route_on_the_tile_axis(monkeypatch):
    """A picture whose `prep_filters` gives up (its filter plan takes the
    host route) is filtered on the host after the shards are combined,
    equal to `Decoder("np")`."""
    from openhevc_tpu.decoder import Decoder as JaxDecoder
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.ops import filters
    from openhevc_tpu_torch.parallel import DeviceMesh
    data = TILED["intra_3x2"]()
    monkeypatch.setattr(filters, "prep_filters", lambda fs: None)
    mesh = DeviceMesh([["cpu"] * 2] * 2, ("frame", "tile"))
    got, pics = _decode(Decoder(device="cpu", mesh=mesh), data)
    _assert_same(got, _decode(JaxDecoder("np"), data)[0])
    assert not any(p.planes.device_filtered for p in pics)
    assert all(p.planes._dev.device == CPU and p.planes._mat is not None
               for p in pics)
