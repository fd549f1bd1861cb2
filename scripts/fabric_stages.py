#!/usr/bin/env python3
"""Where a data-plane call's time goes on the port's process fabrics.

Splits ``OffloadDomain`` puts and gets of 1 and 8 MiB and a ``demo/add`` of
two 8 MiB float32 arrays, over an shm and a socket fresh-interpreter worker,
into what a host can time from outside the runtime:

* ``floor``, per payload size: a numpy copy; a copy into a shared-memory
  segment whose pages are touched for the first time (``shm_copy_cold``)
  and again (``shm_copy_warm``); the bare transport's round trip of one
  payload-sized frame against an 8-byte reply, on an endpoint pair with a
  forked echo process and no runtime, after the ring has wrapped twice;
* ``calls``, per fabric and call: the median host time split into
  ``submit`` (pack the frame and hand it to the transport) and ``wait``
  (until the reply is decoded; the host pumps its own endpoint), over two
  windows of one fresh worker: ``first_pass``, the calls that fit in the
  ring before it wraps (every ring page touched for the first time), and
  ``steady``, the same number of calls after both rings have wrapped twice
  (the socket legs, which have no ring, run the same windows);
* ``profile``: the same windows once more on a fresh worker with the host
  under ``cProfile``; its heaviest functions by own time, ms per call.

Run from the repository root; no card is needed, and where PyTorch sees
one the ``demo/add`` also runs on two CUDA tensors, staged through pinned
host memory::

    PYTHONPATH=src python3 scripts/fabric_stages.py [--out FILE]

``--smoke`` shrinks every size and count, for a test on any host."""

import argparse
import cProfile
import io
import json
import os
import platform
import pstats
import sys
import time

import numpy as np

SIZES = {"put_nbytes": (1 << 20, 8 << 20), "add_nbytes": 8 << 20,
         "calls": 20, "ring": 1 << 26, "top": 6}
SMOKE = {"put_nbytes": (64 << 10,), "add_nbytes": 64 << 10,
         "calls": 3, "ring": 1 << 20, "top": 3}


def median_ms(ts) -> float:
    return 1e3 * float(np.median(ts))


def registry():
    import repro_torch.offload.demo_handlers  # noqa: F401  (demo/*)
    from repro_torch.core.registry import default_registry

    reg = default_registry()
    if not reg.initialised:
        reg.init()
    return reg


def _echo(kind: str, fabric_args: dict, n: int) -> None:
    """Forked echo peer: answer each of ``n`` frames with 8 bytes."""
    if kind == "shm":
        from repro_torch.comm.shm import ShmEndpoint

        ep = ShmEndpoint(fabric_args["prefix"], 1, 2, peers=[0])
    else:
        from repro_torch.comm.socket import SocketEndpoint

        ep = SocketEndpoint(1, 2, fabric_args["base_port"])
    try:
        for _ in range(n):
            if ep.recv(timeout=60.0) is None:
                raise TimeoutError("the echo peer saw no frame")
            ep.send(0, b"\0" * 8)
    finally:
        ep.close()


def transport_rtt(kind: str, nbytes: int, cfg: dict) -> float:
    """Median round trip of one ``nbytes`` frame and an 8-byte reply over a
    bare endpoint pair, after the ring has wrapped twice (ms)."""
    import multiprocessing

    from repro_torch.comm.shm import ShmFabric
    from repro_torch.comm.socket import SocketFabric

    prime = -(-2 * cfg["ring"] // nbytes)
    n = prime + cfg["calls"]
    if kind == "shm":
        fab = ShmFabric(2, capacity=cfg["ring"])
        args = {"prefix": fab.prefix}
    else:
        fab = SocketFabric(2)
        args = {"base_port": fab.base_port}
    ep = fab.endpoint(0)
    child = multiprocessing.get_context("fork").Process(target=_echo, args=(kind, args, n))
    child.start()
    try:
        frame = np.random.default_rng(0).integers(0, 255, nbytes, dtype=np.uint8).tobytes()
        ts = []
        for i in range(n):
            t0 = time.perf_counter()
            ep.send(1, frame)
            if ep.recv(timeout=60.0) is None:
                raise TimeoutError(f"{kind}: no echo of frame {i}")
            ts.append(time.perf_counter() - t0)
        child.join(30.0)
        if child.exitcode != 0:
            raise RuntimeError(f"{kind}: the echo peer exited with {child.exitcode}")
        return median_ms(ts[prime:])
    finally:
        if child.is_alive():
            child.kill()
            child.join(5.0)
        fab.close()


def shm_copy(nbytes: int, passes: int) -> tuple[float, float]:
    """Median ms of copying ``nbytes`` into a fresh shared-memory segment
    (each page touched for the first time), then into the same pages."""
    from multiprocessing import shared_memory

    seg = shared_memory.SharedMemory(create=True, size=nbytes * passes)
    try:
        src = np.ones(nbytes, np.uint8)
        dst = np.ndarray((passes, nbytes), np.uint8, buffer=seg.buf)
        times = []
        for _ in range(2):
            ts = []
            for row in dst:
                t0 = time.perf_counter()
                np.copyto(row, src)
                ts.append(time.perf_counter() - t0)
            times.append(median_ms(ts))
        del dst
        return times[0], times[1]
    finally:
        seg.close()
        seg.unlink()


def floor(cfg: dict) -> dict:
    out = {}
    for nb in sorted({*cfg["put_nbytes"], 2 * cfg["add_nbytes"]}):
        src, dst = np.ones(nb, np.uint8), np.empty(nb, np.uint8)
        ts = []
        for _ in range(cfg["calls"]):
            t0 = time.perf_counter()
            np.copyto(dst, src)
            ts.append(time.perf_counter() - t0)
        cold, warm = shm_copy(nb, min(cfg["calls"], max(1, cfg["ring"] // nb)))
        out[f"{nb >> 10}KiB"] = {"numpy_copy_ms": median_ms(ts), "shm_copy_cold_ms": cold,
                                 "shm_copy_warm_ms": warm,
                                 **{f"{k}_rtt_ms": transport_rtt(k, nb, cfg)
                                    for k in ("shm", "socket")}}
    return out


def start(kind: str, reg, cfg: dict):
    """A fresh-interpreter worker on node 1 and an inline host domain."""
    from repro_torch.comm.shm import ShmFabric
    from repro_torch.comm.socket import SocketFabric
    from repro_torch.offload import worker
    from repro_torch.offload.api import OffloadDomain

    mods = worker.registered_setup_modules(reg)
    if kind == "shm":
        fab = ShmFabric(2, capacity=cfg["ring"])
        proc = worker.spawn_shm_worker_subprocess(fab, 1, mods)
    else:
        fab = SocketFabric(2)
        fab.endpoint(0)
        proc = worker.spawn_socket_worker_subprocess(1, 2, fab.base_port, mods)
    dom = OffloadDomain(fab, registry=reg, inline_host=True)
    try:
        if dom.ping(1, 1, timeout=60.0) != 1:
            raise RuntimeError(f"{kind}: the worker did not answer")
    except BaseException:
        stop(dom, proc, fab)
        raise
    return dom, proc, fab


def stop(dom, proc, fab) -> None:
    from repro_torch.offload.worker import reap

    try:
        dom.shutdown()
        reap([proc], timeout=30.0)
    finally:
        fab.close()
    if proc.returncode != 0:
        raise RuntimeError(f"a worker exited with {proc.returncode}")


def workload(reg, cfg: dict) -> list:
    """``(name, frame_nbytes, make, check)`` for every call: ``make(dom)``
    returns a function that submits one call and returns its future,
    ``check(result)`` holds the reply to its expected value, and
    ``frame_nbytes`` is the larger of its request and reply payloads."""
    from repro_torch.core.closure import f2f

    rng = np.random.default_rng(0)
    out = []
    for nb in cfg["put_nbytes"]:
        src = rng.standard_normal(nb // 8)

        def put_call(dom, src=src):
            ptr = dom.allocate(1, src.shape, "float64")
            return lambda: dom.async_(1, f2f("_ham/put", 1, ptr.handle, 0, src,
                                             registry=reg))

        def get_call(dom, src=src):
            ptr = dom.allocate(1, src.shape, "float64")
            dom.put(src, ptr)
            return lambda: dom.async_(1, f2f("_ham/get", 1, ptr.handle, 0, -1,
                                             registry=reg))

        out.append((f"put_{nb >> 10}KiB", nb, put_call, lambda r: None))
        out.append((f"get_{nb >> 10}KiB", nb, get_call,
                    lambda r, src=src: _same(np.asarray(r).reshape(-1), src)))
    n = cfg["add_nbytes"] // 4
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    want = a + b
    operands = [("numpy", a, b)]
    import torch

    if torch.cuda.is_available():
        operands.append(("cuda", torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()))
    for tag, x, y in operands:
        def add_call(dom, x=x, y=y):
            return lambda: dom.async_(1, f2f("demo/add", x, y, registry=reg))

        out.append((f"add_{cfg['add_nbytes'] >> 10}KiB_{tag}", 2 * cfg["add_nbytes"],
                    add_call, lambda r: _same(r, want)))
    return out


def _same(got, want) -> None:
    if got.dtype != want.dtype or got.tobytes() != want.tobytes():
        raise AssertionError("a reply differs from the expected bytes")


def top(prof: cProfile.Profile, ncalls: int, k: int) -> list:
    """The ``k`` heaviest functions by own time, in ms per call."""
    stats = pstats.Stats(prof, stream=io.StringIO()).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:k]
    return [{"fn": f"{os.path.basename(f)}:{line}({name})", "ms_per_call": 1e3 * tt / ncalls}
            for (f, line, name), (_, _, tt, _, _) in rows]


def windows(kind: str, reg, cfg: dict, call, profile: bool) -> dict:
    """One fresh worker: the ``first_pass`` window, priming calls until both
    rings have wrapped twice, then the ``steady`` window.  Each window holds
    timings, or with ``profile`` the host's heaviest functions."""
    name, frame_nbytes, make, check = call
    n = max(1, min(cfg["calls"], cfg["ring"] // frame_nbytes - 1))
    prime = -(-2 * cfg["ring"] // frame_nbytes)
    dom, proc, fab = start(kind, reg, cfg)
    out = {}
    try:
        submit = make(dom)

        def timed(tag):
            prof = cProfile.Profile() if profile else None
            sub, wait = [], []
            for _ in range(n):
                if prof:
                    prof.enable()
                t0 = time.perf_counter()
                fut = submit()
                t1 = time.perf_counter()
                got = dom.host.wait(fut, 60.0)
                t2 = time.perf_counter()
                if prof:
                    prof.disable()
                check(got)
                sub.append(t1 - t0)
                wait.append(t2 - t1)
            out[tag] = (top(prof, n, cfg["top"]) if prof else
                        {"n": n, "submit_ms": median_ms(sub), "wait_ms": median_ms(wait),
                         "total_ms": median_ms(np.add(sub, wait))})

        timed("first_pass")
        for _ in range(prime):
            check(dom.host.wait(submit(), 60.0))
        timed("steady")
    finally:
        stop(dom, proc, fab)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="tiny sizes and counts")
    ap.add_argument("--out", help="also write the JSON result to this file")
    args = ap.parse_args(argv)
    cfg = SMOKE if args.smoke else SIZES
    reg = registry()
    result = {"machine": platform.machine(), "cpu_count": os.cpu_count(), "sizes": cfg,
              "floor": floor(cfg)}  # forks its echo peers before any CUDA context
    calls = workload(reg, cfg)
    for key, profile in (("calls", False), ("profile", True)):
        result[key] = {kind: {call[0]: windows(kind, reg, cfg, call, profile)
                              for call in calls}
                       for kind in ("shm", "socket")}
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
