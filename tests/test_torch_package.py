"""Package rules of the port: it never imports JAX or the reference package,
its entry points run on the card unless asked for the CPU, and its kernel
wrappers never hand a non-CPU request to the plain version."""

import ast
import dataclasses
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "scripts").glob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_engine_import_leaves_jax_and_repro_unloaded():
    code = (
        "import sys, repro_torch.serve.engine, repro_torch.models.api;"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'));"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_light_package_roots():
    code = (
        "import sys, repro_torch, repro_torch.core;"
        "heavy = [m for m in ('repro_torch.models.transformer', 'repro_torch.kernels.ops',"
        " 'repro_torch.core.device_table') if m in sys.modules];"
        "print(heavy); sys.exit(1 if heavy else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_default_to_cuda(monkeypatch):
    """device=None means the card: without CUDA it raises, never falls back."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced("internlm2-20b")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    params = model.init(seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(model, params, num_slots=1, max_len=8)
    with pytest.raises(ValueError, match="unknown family"):   # repro/models/api.py:212
        build_model(dataclasses.replace(get_reduced("whisper-large-v3"), family="speech"),
                    device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_reduced("xlstm-1.3b"))
    from repro_torch.launch.mesh import make_mesh

    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((1, 1), ("data", "model"))


def _launch_counts():
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import mlstm

    return (dec.launches, dec.launches_q8, fla.launches, fla.launches_window, gmm.launches,
            mlstm.launches, ssd.launches)


def _call(kernel, device):
    """One call of a kernel's model-layout wrapper on ``device``."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(device)

    if kernel == "decode_attention":
        q, kv = t(2, 1, 8, 32), t(2, 16, 2, 32)
        return ops.decode_attention_bhsd(q, kv, kv, torch.tensor([3, 16], dtype=torch.int32,
                                                                 device=device))
    if kernel == "decode_attention_q8":
        q = t(2, 1, 8, 32)
        kv = torch.zeros(2, 16, 2, 32, dtype=torch.int8, device=device)
        scale = t(2, 16, 2, 1).abs()
        return ops.decode_attention_q8_bhsd(q, kv, kv, scale, scale,
                                            torch.tensor([3, 16], dtype=torch.int32,
                                                         device=device))
    if kernel == "flash_attention":
        q, kv = t(2, 16, 8, 32), t(2, 16, 2, 32)
        return ops.flash_attention_bhsd(q, kv, kv)
    if kernel == "flash_attention_window":
        q, kv = t(2, 16, 8, 32), t(2, 16, 2, 32)
        return ops.flash_attention_bhsd(q, kv, kv, window=5)
    if kernel == "mlstm":
        qk, g = t(2, 37, 2, 16), t(2, 37, 2)
        return ops.mlstm_chunked(qk, qk, t(2, 37, 2, 32), g, g, chunk=8)[0]
    if kernel == "mamba2_ssd":
        bc, hd = t(2, 37, 2, 64), t(4)
        return ops.ssd_chunked(t(2, 37, 4, 64), t(2, 37, 4).abs(), -hd.abs(), bc, bc, hd,
                               chunk=8)[0]
    return ops.grouped_matmul(t(1, 4, 8, 32), t(4, 32, 16))


KERNELS = ["decode_attention", "decode_attention_q8", "flash_attention",
           "flash_attention_window", "grouped_matmul", "mlstm", "mamba2_ssd"]
KERNEL_IDS = ["decode", "decode_q8", "flash", "flash_window", "grouped_matmul", "mlstm", "ssd"]


@pytest.mark.parametrize("kernel", KERNELS, ids=KERNEL_IDS)
def test_kernel_wrappers_raise_for_non_cpu_requests(kernel):
    """A request that is not on the CPU goes to the kernel path, which
    raises here (no CUDA device, no nvcc) instead of returning the plain
    result."""
    from repro_torch.kernels import _build

    before = _launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        _call(kernel, "meta")
    assert _launch_counts() == before
    source = kernel.removesuffix("_q8").removesuffix("_window")
    if shutil.which("nvcc") is None and not Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build([source])


@pytest.mark.parametrize("kernel", KERNELS, ids=KERNEL_IDS)
def test_meta_requests_take_the_plain_version_only_in_a_dry_run(kernel):
    """Inside ``plain_on_meta`` (what a dry-run's ``op_analysis.analyze``
    runs its step in) a ``meta`` request takes the plain version, shapes
    only, and counts no launch; once the block ends it goes to the kernel
    path again."""
    from repro_torch.kernels import _build

    before = _launch_counts()
    with _build.plain_on_meta():
        assert _call(kernel, "meta").device.type == "meta"
    assert _launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        _call(kernel, "meta")


@pytest.mark.parametrize("kernel", KERNELS, ids=KERNEL_IDS)
def test_cpu_wrappers_count_no_launches(kernel):
    before = _launch_counts()
    out = _call(kernel, "cpu")
    assert out.device.type == "cpu" and torch.isfinite(out).all()
    assert _launch_counts() == before


KERNEL_MODULES = ["decode_attention", "flash_attention", "grouped_matmul", "mlstm",
                  "mamba2_ssd"]
MODULE_IDS = ["decode", "flash", "grouped_matmul", "mlstm", "ssd"]


class _YieldingCount(int):
    """A launch count whose addition hands the interpreter to another thread
    between the read and the write of ``launches += 1``, as a preempted or
    free-threaded interpreter may: an unlocked count then loses updates."""

    def __add__(self, other):
        time.sleep(0)
        return _YieldingCount(int(self) + other)


@pytest.mark.parametrize("kernel", KERNEL_MODULES, ids=MODULE_IDS)
def test_launch_counters_stay_exact_under_threads(kernel):
    """Serving replicas on thread workers launch kernels at once: each
    wrapper's launch is counted under a lock (``_build.counted``), so
    concurrent counted calls through a stub launch lose no update."""
    import importlib
    import threading

    from repro_torch.kernels import _build

    module = importlib.import_module(f"repro_torch.kernels.{kernel}")
    assert module._launch.__wrapped__ is not None  # the real launch is counted
    def stub():
        return None

    stub.__module__ = module.__name__  # counted into the kernel module
    stub = _build.counted(stub)
    threads, calls = 16, 500
    before = module.launches
    module.launches = _YieldingCount(0)
    try:
        workers = [threading.Thread(target=lambda: [stub() for _ in range(calls)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
        counted = int(module.launches)
    finally:
        module.launches = before
    assert counted == threads * calls


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "internlm2-20b", "qwen1.5-4b", "llama3-405b",
                                  "nemotron-4-340b", "olmoe-1b-7b", "qwen2-moe-a2.7b",
                                  "internvl2-76b", "zamba2-2.7b", "whisper-large-v3"])
def test_build_model_builds_every_config(arch):
    """Every family of ``repro_torch/configs`` builds: the full config's
    model (no params drawn) and the reduced one through init, prefill and
    one decode step on the CPU."""
    from repro_torch.configs import ARCH_IDS, get_config, get_reduced
    from repro_torch.models.api import build_model

    assert arch in ARCH_IDS
    assert build_model(get_config(arch), device="cpu").cfg.name == arch
    cfg = get_reduced(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(seed=0)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 5)))}
    if cfg.vlm is not None:
        batch["patch_embeds"] = torch.randn(2, cfg.vlm.num_patches, cfg.d_model)
    if cfg.encdec is not None:
        batch["frames"] = torch.randn(2, cfg.encdec.encoder_frames, cfg.d_model)
    logits, pre = model.prefill(params, batch)
    n = 5 + (cfg.vlm.num_patches if cfg.vlm is not None else 0)
    assert logits.shape == (2, n, cfg.vocab_size) and torch.isfinite(logits).all()
    cache = model.init_cache(2, n + 2)
    if cfg.encdec is not None:
        cache["cross"] = pre["cross"]
    lg, _ = model.decode_step(params, cache, {"tokens": batch["tokens"][:, :1],
                                              "pos": torch.tensor(n)})
    assert lg.shape == (2, 1, cfg.vocab_size) and torch.isfinite(lg).all()
