"""The port's four examples (``examples/torch_*.py``) on the CPU, each a
fresh interpreter given ``--device cpu``, beside the reference's example
(``JAX_PLATFORMS=cpu``) where its output is deterministic: the values the
runtime examples print, the serve twin's dispatch table and schedule.
The train twin runs a few small-batch steps through its restart."""

from __future__ import annotations

import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _start(script: str, *args: str, reference: bool = False) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}
    if reference:
        env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen([sys.executable, str(EXAMPLES / script), *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen, timeout: float = 120) -> list[str]:
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, out + err
    return out.splitlines()


def _both(twin: str, reference: str, *twin_args: str) -> tuple[list[str], list[str]]:
    """The twin on the CPU and the reference example, run side by side."""
    procs = (_start(twin, "--device", "cpu", *twin_args), _start(reference, reference=True))
    return _finish(procs[0]), _finish(procs[1])


def _line(lines: list[str], prefix: str) -> str:
    hits = [line for line in lines if line.startswith(prefix)]
    assert len(hits) == 1, (prefix, lines)
    return hits[0]


def test_quickstart_twin_matches_the_reference():
    twin, ref = _both("torch_quickstart.py", "quickstart.py")
    assert twin[-1] == "OK (cpu)" and ref[-1] == "OK"
    # the same handler set, so the same sealed key map
    assert _line(twin, "handler table:") == _line(ref, "handler table:")
    assert _line(twin, "inner product on worker:") == _line(ref, "inner product on worker:")


def test_offload_pipeline_twin_matches_the_reference():
    twin, ref = _both("torch_offload_pipeline.py", "offload_pipeline.py")
    assert twin[-1] == "OK (cpu)" and ref[-1] == "OK"
    for prefix in ("stage 1 done", "relay reply:", "reverse offload:",
                   "compressed-grad norm on worker:"):
        assert _line(twin, prefix) == _line(ref, prefix)


def test_serve_twin_keeps_the_reference_table_and_schedule():
    """The twin's weights are the port's seeded draw, not the reference's,
    so its tokens differ; the dispatch table's stable names, each request's
    token count (its budget) and the batched steps do not."""
    twin, ref = _both("torch_serve_batched.py", "serve_batched.py")
    names = _line(twin, "dispatch table:").split("dispatch table: ")[1]
    assert names == _line(ref, "arch=").split("dispatch table: ")[1]
    assert "olmoe-1b-7b-reduced" in _line(twin, "arch=")

    def counts(lines):
        return [len(line.split("-> ")[1].split(",")) for line in lines if line.startswith("req ")]

    assert counts(twin) == counts(ref) and len(counts(twin)) == 8
    modes = [re.search(r"\[(\w+)", line).group(1) for line in twin if line.startswith("req ")]
    assert modes == ["greedy", "sample"] * 4
    steps = re.compile(r"(\d+) tokens in .* over (\d+) batched steps")
    assert steps.search(twin[-1]).groups() == steps.search(ref[-1]).groups()
    assert "8 admissions" in twin[-1]


def test_train_twin_restarts_from_its_checkpoint(tmp_path):
    """The demo's 12 layers (98.7M params) at a tiny batch: ~22 s, and its
    two checkpoints (~2.3 GB) are removed when the test ends."""
    try:
        lines = _finish(_start("torch_train_e2e.py", "--device", "cpu",
                               "--global-batch", "2", "--seq-len", "8", "--steps", "3",
                               "--log-every", "1", "--restart-demo", "--restart-at", "2",
                               "--ckpt-dir", str(tmp_path)))
        assert lines[0].startswith("model: demo-100m  12 layers")
        assert lines[1] == "fresh start"
        assert ">> simulating failure: dropping trainer, restoring from ckpt" in lines
        assert ">> resumed at step 2" in lines
        steps = [int(line.split()[1]) for line in lines if line.startswith("step ")]
        assert steps == [1, 2, 3]
        final = re.fullmatch(r"final loss: (\S+) at step 3", lines[-1])
        assert final and math.isfinite(float(final.group(1)))
        assert sorted(p.name for p in tmp_path.iterdir()) == ["step_000000002", "step_000000003"]
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


def test_twins_are_hamlint_clean():
    """The twins' handlers declare what they do (``stage_scale`` writes
    through its buffer: ``mutates=True``), so the port's linter passes them."""
    from repro_torch.analysis.hamlint import lint_paths

    findings = lint_paths([str(p) for p in sorted(EXAMPLES.glob("torch_*.py"))])
    assert findings == [], "\n".join(f.format() for f in findings)


@pytest.mark.parametrize("script", ["torch_quickstart.py", "torch_offload_pipeline.py",
                                    "torch_serve_batched.py", "torch_train_e2e.py"])
def test_twin_imports_only_the_port(script):
    """Everything the twin loads (``--help`` stops it after its imports)
    is neither JAX nor the reference package."""
    code = "\n".join([
        "import runpy, sys",
        f"sys.argv = [{script!r}, '--help']",
        "try:",
        f"    runpy.run_path({str(EXAMPLES / script)!r}, run_name='__main__')",
        "except SystemExit:",
        "    pass",
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))",
        "print(bad)",
        "sys.exit(1 if bad else 0)",
    ])
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("[]"), r.stdout + r.stderr
