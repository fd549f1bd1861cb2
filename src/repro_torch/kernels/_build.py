"""Build the CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o lib<name>_<hash>.so csrc/<name>.cu

The library lands in ``build/repro_torch_kernels/`` at the repository root
(listed in ``.gitignore``), keyed by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads at once.  A failed build
raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: dtype codes of the kernels' C interface (``ham::DType`` in csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LIBS: dict[str, ctypes.CDLL] = {}
#: serialises first loads (a build writes one temporary file per process)
_LIBS_LOCK = threading.Lock()
#: serialises the kernel modules' ``launches += 1`` (see :func:`counted`)
_COUNT_LOCK = threading.Lock()
#: compiler output of each build this process ran (ptxas register/spill lines)
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from csrc/ with the "
            "CUDA toolkit, which this machine does not have"
        )
    return path


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return src, BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names) -> None:
    """Compile every named kernel not built yet: one ``nvcc`` per source,
    all started together, then wait for all of them."""
    todo = [(name, *_target(name)) for name in names]
    todo = [(name, src, so) for name, src, so in todo if not so.exists()]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, src, so in todo:
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((name, so, tmp, proc))
    failed = []
    for name, so, tmp, proc in jobs:
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, so)
        else:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))


def library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed, with
    ``argtypes`` set from ``signatures`` (every pointer and the stream as
    ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LIBS_LOCK:   # replicas on thread workers may reach a first load at once
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)[1]))
            lib.ham_error_string.argtypes = [ctypes.c_int]
            lib.ham_error_string.restype = ctypes.c_char_p
            for symbol, argtypes in signatures.items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (persistent grids
    and the SSD backward's head blocks are sized by it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def count(module_name: str, counter: str = "launches") -> None:
    """Add one to the module's ``counter`` under a lock.  Serving replicas on
    thread workers launch at once, and a bare ``launches += 1`` on a module
    global is a read-modify-write that two threads can interleave and lose."""
    module = sys.modules[module_name]
    with _COUNT_LOCK:
        setattr(module, counter, getattr(module, counter) + 1)


def counted(launch):
    """Decorate a kernel module's launch function: each call that returns
    adds one to its module's ``launches`` (:func:`count`)."""
    @functools.wraps(launch)
    def launch_and_count(*args, **kwargs):
        out = launch(*args, **kwargs)
        count(launch.__module__)
        return out
    return launch_and_count


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned an error (refused launches never run, and a
    later synchronize would not report them)."""
    if err != 0:
        msg = lib.ham_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed ({err}): {msg}")


def _aligned(t, nbytes: int = 16) -> bool:
    # base and every outer stride a multiple of 16 bytes (the kernels load
    # 16-byte vectors along the unit last dim); a size-1 dim's stride is unused
    es = t.element_size()
    outer = zip(t.stride()[:-1], t.shape[:-1])
    return t.data_ptr() % nbytes == 0 and all(
        (s * es) % nbytes == 0 for s, n in outer if n > 1)


def check_inputs(name: str, tensors) -> int:
    """Validate the tensors of one kernel launch and return their dtype code:
    all on one CUDA device, all float32 or all bfloat16, a unit last-dim
    stride and 16-byte aligned rows.  Raises on anything else, so a request
    that is not on a CUDA device never reaches the plain version."""
    first = tensors[0]
    if not all(t.is_cuda and t.device == first.device for t in tensors):
        raise ValueError(f"{name} kernel needs every tensor on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if first.dtype not in DTYPE_CODES or any(t.dtype != first.dtype for t in tensors):
        raise TypeError(f"{name} takes float32 or bfloat16 tensors of one dtype, "
                        f"got {[t.dtype for t in tensors]}")
    if not all(t.stride(-1) == 1 and _aligned(t) for t in tensors):
        raise ValueError(f"{name} kernel needs a unit last-dim stride and "
                         "16-byte aligned rows")
    return DTYPE_CODES[first.dtype]


def check_aux(name: str, like, tensors, dtype, what: str) -> None:
    """Raise unless every tensor of ``tensors`` (operands a kernel reads in
    a dtype of their own, such as float32 gates or states) is ``dtype`` on
    ``like``'s device."""
    for t in tensors:
        if t.device != like.device or t.dtype != dtype:
            raise TypeError(f"{name} {what} must be {dtype} on {like.device}, "
                            f"got {t.dtype} on {t.device}")


#: True inside :func:`plain_on_meta`
_META_PLAIN = contextvars.ContextVar("meta_plain", default=False)


def takes_plain(t) -> bool:
    """Whether a wrapper given ``t`` runs the plain version, not the kernel:
    a CPU tensor does, and a ``meta`` one does inside :func:`plain_on_meta`.
    Any other request, ``meta`` elsewhere included, goes to the kernel
    path, which raises off the card."""
    return t.device.type == "cpu" or (t.device.type == "meta" and _META_PLAIN.get())


@contextlib.contextmanager
def plain_on_meta():
    """Inside the block, ``meta`` tensors take the plain versions: a dry-run
    traces a step's shapes, as the reference's lowers its plain attention."""
    token = _META_PLAIN.set(True)
    try:
        yield
    finally:
        _META_PLAIN.reset(token)


def grad_wanted(*tensors) -> bool:
    """Whether autograd would record a call on ``tensors`` (None skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def no_backward(name: str, item: str, *tensors) -> None:
    """Raise for a kernel call autograd would record: the kernel writes its
    output through raw pointers, so its gradient would stop there
    silently.  ``item`` names the ROADMAP item that ports its backward."""
    if grad_wanted(*tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel on the card yet (ROADMAP Queue 1 item "
            f"{item}); call it under torch.no_grad() or on CPU tensors")
