"""The port stands alone: no module of openhevc_tpu_torch, and not
chip_smoke.py, imports jax or anything of the JAX package openhevc_tpu;
and the default device is the card, with no fallback to the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "openhevc_tpu_torch")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, files in os.walk(PKG):
        if "build" in os.path.relpath(d, PKG).split(os.sep):
            continue
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "openhevc_tpu")


def _imports(path):
    """(absolute module name, line) of every import in the file; relative
    imports are resolved against the file's package."""
    rel = os.path.relpath(path, ROOT)
    pkg = rel.split(os.sep)[:-1]
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                keep = len(pkg) - node.level + 1
                if keep < 1:
                    yield "<escapes the package>", node.lineno
                    continue
                mod = ".".join(pkg[:keep] +
                               ([node.module] if node.module else []))
            else:
                mod = node.module or ""
            yield mod, node.lineno
            for a in node.names:
                yield f"{mod}.{a.name}", node.lineno


def test_no_jax_or_jax_package_imports():
    files = _sources()
    assert len(files) > 15
    bad = [(os.path.relpath(f, ROOT), line, mod)
           for f in files for mod, line in _imports(f)
           if _forbidden(mod) or mod == "<escapes the package>"]
    assert not bad, bad


def test_scanner_catches_forbidden_imports(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom openhevc_tpu.ops import x\n"
                 "import openhevc_tpu_torch\n")
    got = [m for m, _ in _imports(str(p)) if _forbidden(m)]
    assert "jax.numpy" in got and "openhevc_tpu.ops" in got
    assert "openhevc_tpu_torch" not in got


def test_import_leaves_jax_unloaded():
    code = ("import sys\n"
            "import openhevc_tpu_torch\n"
            "from openhevc_tpu_torch.decoder import Decoder\n"
            "import openhevc_tpu_torch.models.pipeline\n"
            "import openhevc_tpu_torch.kernels\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'openhevc_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_default_device_raises_without_a_card():
    from openhevc_tpu_torch.decoder import Decoder
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Decoder()
