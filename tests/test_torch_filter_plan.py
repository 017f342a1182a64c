"""The in-loop filters' one seam in the port (ops/filters.py
`plan_filters`): the engine and the tile axis of a 2 x 2 CPU mesh build
the same filter plan for every picture of a small tiled random-access
stream (names and arrays) and make one `edge_params` call a deblocked
picture; control arrays a picture lacks are shared placeholders, never
uploaded; and source checks: the filters' internal names stay inside
ops/filters.py, the mesh imports no private name of the engine and
nothing inside a function, `TorchEngine.prepare` reads its upload by
name. CPU only. Tolerance: none (integers)."""
import ast
import inspect
import os
import textwrap
import tokenize

import numpy as np
import pytest
import torch

from openhevc_tpu_torch.models import pipeline
from openhevc_tpu_torch.ops import filters
from openhevc_tpu_torch.parallel import mesh
from test_torch_edge_params import ROOT, one_thread  # noqa: F401
from test_torch_inter import assert_same, decode, lowdelay, stream

PORT = os.path.join(ROOT, "openhevc_tpu_torch")
INTERNAL = {"FARG_KEYS", "EDGE_KEYS", "fargs_arrays", "edge_inputs",
            "edge_params", "prep_filters"}


def _spied_decode(dec, data, monkeypatch):
    """Decode with every filter plan kept by POC, for the engine's whole
    pictures and the mesh's tile axis alike, and the `edge_params` calls
    that each `plan.args` makes; then undo every patch of the test."""
    plans, per_args = {}, []
    real_plan, real_edges = filters.plan_filters, filters.edge_params
    real_args = filters.FilterPlan.args
    calls = [0]

    def plan_filters(fs):
        plan = real_plan(fs)
        assert fs.poc not in plans
        plans[fs.poc] = plan
        return plan

    def edge_params(*a, **kw):
        calls[0] += 1
        return real_edges(*a, **kw)

    def args(plan, up, *a, **kw):
        before = calls[0]
        out = real_args(plan, up, *a, **kw)
        per_args.append((plan, calls[0] - before))
        return out

    monkeypatch.setattr(pipeline, "plan_filters", plan_filters)
    monkeypatch.setattr(mesh, "plan_filters", plan_filters)
    monkeypatch.setattr(filters, "edge_params", edge_params)
    monkeypatch.setattr(filters.FilterPlan, "args", args)
    got, pics = decode(dec, data)
    monkeypatch.undo()
    return got, pics, plans, per_args, calls[0]


@pytest.mark.usefixtures("one_thread")
def test_engine_and_tile_axis_build_the_same_plan(monkeypatch):
    """Every picture of a tiled, filtered random-access stream: the plan
    of the engine's route and the plan of the tile axis of a 2 x 2 mesh
    have the same route, steps, format, scalars and named arrays, equal
    array for array; each deblocked picture makes one `edge_params` call
    on each route, every other picture none; both decodes are equal."""
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.parallel import DeviceMesh
    data = stream("ra_tiles", sao=True, deblock=True)
    engine = _spied_decode(Decoder(device="cpu"), data, monkeypatch)
    tiles = _spied_decode(
        Decoder(device="cpu",
                mesh=DeviceMesh([["cpu"] * 2] * 2, ("frame", "tile"))),
        data, monkeypatch)
    assert_same(tiles[0], engine[0])
    (_, _, plans, per_args, n_calls), (_, _, t_plans, t_args, t_calls) = \
        engine, tiles
    assert sorted(plans) == sorted(t_plans) and len(plans) == 9
    assert any("mv" in p.grids for p in plans.values())
    for poc, p in plans.items():
        q = t_plans[poc]
        assert p.route == q.route == "device"
        assert (p.do_deblock, p.do_sao, p.cs, p.hs, p.vs, p.bd, p.bdc) == \
            (q.do_deblock, q.do_sao, q.cs, q.hs, q.vs, q.bd, q.bdc) == \
            (True, True, 16, 1, 1, 8, 8)
        assert p.edge_kw == q.edge_kw
        for a, b in ((p.controls, q.controls), (p.grids, q.grids)):
            assert list(a) == list(b)
            assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                       for k in a)
        assert list(p.arrays) == list(p.controls) + list(p.grids)
    for got, n in ((per_args, n_calls), (t_args, t_calls)):
        assert [c for _p, c in got] == [1] * len(got)
        assert len(got) == n == len(plans)


def test_forced_host_route_is_one_patch(monkeypatch):
    """`prep_filters` giving up turns every plan to the host route, on
    the engine's route and the tile axis alike: no `edge_params` call,
    no device filters, the same samples as the device route."""
    from openhevc_tpu_torch.decoder import Decoder
    from openhevc_tpu_torch.parallel import DeviceMesh
    data = lowdelay("p", sao=True, deblock=True, n=2)
    want = decode(Decoder(device="cpu"), data)[0]
    for m in (None, DeviceMesh([["cpu"] * 2] * 2, ("frame", "tile"))):
        monkeypatch.setattr(filters, "prep_filters", lambda fs: None)
        got, pics, plans, per_args, n_calls = _spied_decode(
            Decoder(device="cpu", mesh=m), data, monkeypatch)
        assert_same(got, want)
        assert {p.route for p in plans.values()} == {"host"}
        assert n_calls == 0 and not per_args
        assert not any(p.planes.device_filtered for p in pics)


def test_placeholders_are_shared_and_never_uploaded(monkeypatch):
    """A deblock-only CTB-32 picture has no control array at all: its plan
    carries only the grids, and each of the 14 arrays it lacks is one
    shared tensor of the device, the same at every call."""
    from test_torch_inter import _captured
    fs, _refs = _captured(lowdelay("ctb32", deblock=True))[-1]
    plan = filters.plan_filters(fs)
    assert plan.controls == {} and plan.do_deblock and not plan.do_sao
    assert all(a.shape != (1, 1) for a in plan.arrays.values())
    seen = []
    real = filters.apply_filters_device

    def spy(*a, **kw):
        seen.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(filters, "apply_filters_device", spy)
    args = plan.args({k: torch.from_numpy(np.ascontiguousarray(a))
                      for k, a in plan.arrays.items()})
    H, W = fs.sps.height, fs.sps.width
    planes = [torch.zeros((H, W), dtype=torch.int32),
              torch.zeros((H // 2, W // 2), dtype=torch.int32),
              torch.zeros((H // 2, W // 2), dtype=torch.int32)]
    plan.apply(*planes, args)
    plan.apply(*planes, args)
    fargs = [a[3:3 + len(filters.FARG_KEYS)] for a in seen]
    cpu = torch.device("cpu")
    for k, x, y in zip(filters.FARG_KEYS, *fargs):
        assert x is y
        if k not in args:
            assert x is filters._placeholder(cpu, k == "sao")
    assert sum(k not in args for k in filters.FARG_KEYS) == 14


def _port_modules():
    for d, _dirs, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_filter_internals_stay_in_their_module():
    """No module of the port but ops/filters.py names the filters' data
    layout or their device steps (Python names; the kernel library's name
    in kernels.py is a string)."""
    seen = {}
    for path in _port_modules():
        if path == os.path.join(PORT, "ops", "filters.py"):
            continue
        with open(path, "rb") as f:
            names = {t.string for t in tokenize.tokenize(f.readline)
                     if t.type == tokenize.NAME}
        if names & INTERNAL:
            seen[os.path.relpath(path, PORT)] = sorted(names & INTERNAL)
    assert seen == {}


def test_mesh_imports_only_public_engine_names_at_module_level():
    with open(mesh.__file__) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            assert not [n for n in ast.walk(node)
                        if isinstance(n, (ast.Import, ast.ImportFrom))], \
                node.name
        if isinstance(node, ast.ImportFrom) and \
                node.module == "models.pipeline":
            assert not [a.name for a in node.names
                        if a.name.startswith("_")]


def test_prepare_reads_its_upload_by_name():
    """`TorchEngine.prepare` indexes its upload with names only (no
    offsets); `reconstruct` takes no shard and returns a `TorchPlanes`;
    `prep_filters` takes the picture alone; the numpy per-edge half, its
    knob and `device_filters_ok` are gone."""
    src = textwrap.dedent(inspect.getsource(pipeline.TorchEngine.prepare))
    subs = [n for n in ast.walk(ast.parse(src))
            if isinstance(n, ast.Subscript) and isinstance(n.value, ast.Name)
            and n.value.id == "dev"]
    assert subs and all(isinstance(n.slice, ast.Constant) and
                        isinstance(n.slice.value, str) for n in subs)
    assert "at" not in {n.id for n in ast.walk(ast.parse(src))
                        if isinstance(n, ast.Name)}
    sig = inspect.signature(pipeline.TorchEngine.reconstruct)
    assert list(sig.parameters) == ["self", "fs", "ref_planes"]
    assert sig.return_annotation in ("TorchPlanes", pipeline.TorchPlanes)
    assert list(inspect.signature(filters.prep_filters).parameters) == ["fs"]
    for gone in ("device_filters_ok", "fargs_arrays"):
        assert not hasattr(filters, gone)
