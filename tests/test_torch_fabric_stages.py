"""``scripts/fabric_stages.py`` at its smoke size: every stage of every
call is timed on both fabrics, each reply checked, and the host profile
names functions."""

import importlib.util
import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.fork
@pytest.mark.shm
def test_fabric_stages_smoke(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "fabric_stages", os.path.join(ROOT, "scripts", "fabric_stages.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path / "stages.json"
    assert mod.main(["--smoke", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    sizes = {f"{nb >> 10}KiB" for nb in (*mod.SMOKE["put_nbytes"], 2 * mod.SMOKE["add_nbytes"])}
    assert set(got["floor"]) == sizes
    for row in got["floor"].values():
        assert all(v > 0 for v in row.values())
    names = {"put_64KiB", "get_64KiB", "add_64KiB_numpy"}
    for kind in ("shm", "socket"):
        assert set(got["calls"][kind]) == names
        for call in got["calls"][kind].values():
            for window in ("first_pass", "steady"):
                w = call[window]
                assert w["n"] >= 1 and w["total_ms"] > 0
                assert w["submit_ms"] > 0 and w["wait_ms"] > 0
        for call in got["profile"][kind].values():
            for window in ("first_pass", "steady"):
                assert call[window] and all(r["ms_per_call"] >= 0 for r in call[window])
