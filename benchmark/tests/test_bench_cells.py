"""Whole runs of small cells on the CPU, past the look for a card: every
cell kind is `correct` on sound runs, traced or not, and reports what
BENCHMARK.json says it reports; the control (every sample one bit
short) and each fault a cell can have, planted under the timed path,
make `correct` come out false."""
import math

import pytest

from conftest import TINY_CELLS
from hevcbench import cell, manifest

SEED = 2 ** 31 + 2 ** 20 + 5
CELLS = [c for c, _, _ in TINY_CELLS]


def run(root, name, trace=False, fault=None, seconds=0.6):
    return cell.run(root, name, SEED, seconds, trace, device="cpu",
                    fault=fault)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(tiny_root, name):
    out = run(tiny_root, name)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "limits"
    assert all(v["value"] == 0 == v["limit"]
               for v in out["limits"].values())
    man = manifest.load(tiny_root)
    want = {m["name"] for m in man["end_to_end"] if manifest.reports(m,
                                                                    name)}
    assert set(out["metrics"]) == want
    assert all(math.isfinite(v["value"]) for v in out["metrics"].values())
    assert out["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("name", ["tiny_ra_batch", "tiny_shvc_live"])
def test_a_traced_run_is_correct_and_reads_its_layers(tiny_root, name):
    out = run(tiny_root, name, trace=True, seconds=6)
    assert out["correct"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0
    # on the CPU the trace holds no device op: those readers stay silent
    assert out["device"]["busy_s"] is None
    got = set(out["metrics"])
    assert "pictures.tiny" in got
    assert not any(n.startswith(("device_idle", "intra_roofline"))
                   for n in got)
    prep = "host_prep_ms.live" if "live" in name else "host_prep_ms.batch"
    assert out["metrics"][prep]["value"] > 0


@pytest.mark.parametrize("fault", ["lsb", "stale", "half", "flip"])
@pytest.mark.parametrize("name", ["tiny_shvc_batch", "tiny_shvc_live",
                                  "tiny_ra_batch"])
def test_the_control_and_each_fault_fail(tiny_root, name, fault):
    out = run(tiny_root, name, fault=fault)
    assert out["correct"] is False
    assert out["failed"] > 0
    assert sum(v["value"] for v in out["limits"].values()) == out["failed"]
