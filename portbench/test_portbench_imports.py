"""Nothing the harness or the reference loads is JAX or the JAX package,
compared by whole top-level names (``repro_torch`` begins with ``repro``
and is not it)."""

import os
import subprocess
import sys

from portbench import common

ROOT = str(common.ROOT)


def test_whole_names_are_compared():
    assert common.jax_modules(["repro_torch", "repro_torch.models", "numpy"]) == []
    assert common.jax_modules(["repro.core", "jax._src", "jaxlib", "flax", "jaxtyping"]) == [
        "flax", "jax._src", "jaxlib", "repro.core"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from portbench import testing, common, calibrate, run\n"
        "from portbench.reference import decoder\n"
        "for m in common.benchmark()['per_layer']: common.reader(m['name'])\n"
        "res = testing.run_cpu(testing.tiny_conf(), testing.tiny_mix('serve'),"
        " 'internlm2-20b.chat-batch', seconds=1.0)\n"
        "res = testing.run_cpu(testing.tiny_conf(moe=True, train=True),"
        " testing.tiny_mix('train'), 'olmoe-1b-7b.train-4k', seconds=0.5)\n"
        "print('FOUND', common.jax_modules(sys.modules), 'repro_torch' in sys.modules)\n"
    ) % (ROOT, os.path.join(ROOT, "src"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND [] True" in out.stdout


def test_the_reference_imports_nothing_of_the_program():
    files = {common.load_json(c["file"])["reference"] for c in common.benchmark()["configs"]}
    assert "portbench/reference/decoder.py" in files
    for name in files:
        src = (common.ROOT / name).read_text()
        imports = [ln for ln in src.splitlines()
                   if ln.lstrip().startswith(("import ", "from "))]
        assert imports and all("repro" not in ln and "jax" not in ln and "portbench" not in ln
                               for ln in imports), name


def test_a_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "internlm2-20b.chat-batch", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=ROOT, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
