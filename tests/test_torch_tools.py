"""The GPU tools under tools/ read their helpers from chip_smoke.py as
`cs.<name>`: every such name must exist there, or the tool breaks only
when it runs on the card (as both did once the stream list moved into
bench_torch.py). No card needed: the names are read from the source."""
import os
import re

import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("tool", ["bench_intra_barriers.py",
                                  "profile_torch_prep.py"])
def test_tool_reads_only_names_chip_smoke_has(tool):
    with open(os.path.join(ROOT, "tools", tool)) as f:
        src = f.read()
    assert "import chip_smoke as cs" in src
    names = set(re.findall(r"\bcs\.([A-Za-z_]\w*)", src))
    assert names
    assert sorted(n for n in names if not hasattr(chip_smoke, n)) == []
