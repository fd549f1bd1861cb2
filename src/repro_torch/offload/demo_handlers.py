"""Demo/benchmark handlers, importable by worker processes.

Serves as the "same source compiled into every binary" of the paper: host
and workers (forked children or fresh interpreters) import this module, so
all processes derive identical handler keys.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.migratable import ScalarSpec, spec_of
from repro_torch.core.registry import default_registry
from repro_torch.offload.api import deref

_reg = default_registry()


@_reg.handler(name="demo/empty", read_only=True)
def empty() -> None:
    """The paper's Fig. 3 microbenchmark payload: an empty function."""


@_reg.handler(name="demo/add", read_only=True)
def add(a, b):
    return a + b


@_reg.handler(name="demo/inner_prod", read_only=True)
def inner_prod(a_ptr, b_ptr, n):
    a = deref(a_ptr)
    b = deref(b_ptr)
    return float(a[:n] @ b[:n])


# saxpy WRITES through y_ptr — the Active Access mutate-at-data shape:
# declared mutates=True, the scheduler routes the call at y's primary and
# commits the write on completion (dirty epoch bumped, replica holders
# invalidated), so replicas never keep serving the overwritten bytes
# (dataplane module docs; docs/failure-model.md)
@_reg.handler(name="demo/saxpy", mutates=True)
def saxpy(alpha, x_ptr, y_ptr):
    y = deref(y_ptr)
    y += alpha * deref(x_ptr)


@_reg.handler(name="demo/matmul", read_only=True)
def matmul(a, b):
    return np.asarray(a) @ np.asarray(b)


# static-spec variant of the empty offload: zero-byte payload AND zero-byte
# static reply (result_specs=()), the true lower bound for dispatch cost
# (key + header only, both directions)
_reg.register(empty, arg_specs=(), result_specs=(), name="demo/empty_static",
              read_only=True)


def echo_small(a, b, scale, arr):
    """Small-RPC benchmark payload: ~250 B of static args, scalar result."""
    return float(a + b) * scale


#: (i8, i8, f8, 28*f8) = 248 B — the ≤256 B small-call regime of Fig. 3
_ECHO_ARGS = (1, 2, 3.0, np.zeros(28, dtype=np.float64))

# the SAME function on both wire paths, so benchmarks compare mechanism,
# not handler work: _static rides the compiled WirePlan both ways
# (FLAG_STATIC request + plan-packed reply), _dyn rides self-describing TLV
_reg.register(
    echo_small,
    arg_specs=tuple(spec_of(a) for a in _ECHO_ARGS),
    result_specs=(ScalarSpec("f8"),),
    name="demo/echo_small_static",
    read_only=True,
)
_reg.register(echo_small, name="demo/echo_small_dyn", read_only=True)


# -- chaos-suite probes (tests/test_chaos.py; docs/failure-model.md) --------
#
# bump is deliberately MUTATING: the per-token counter is the side-effect
# witness for the exactly-once contract — if a retried call ever
# re-executed, the counter total would exceed the number of logical calls.
# Lives here (not in the test file) so fresh-interpreter socket workers
# import it via the registered-setup-modules path like any demo handler.
# The counter is per PROCESS: thread workers (ClusterPool.local) share one
# — read it from any single node; process workers (shm/socket) each own
# theirs — sum counts over the pool.

_chaos_counters: dict = {}


@_reg.handler(name="chaos/bump", read_only=False)
def chaos_bump(token):
    """Mutating probe: increment this worker's counter for ``token`` and
    return the post-increment value.  Exactly-once under retry means every
    logical call adds exactly 1 to the cluster-wide total."""
    n = _chaos_counters.get(token, 0) + 1
    _chaos_counters[token] = n
    return int(n)


@_reg.handler(name="chaos/counts", read_only=True)
def chaos_counts(token):
    """Read-only probe: this worker's counter for ``token`` (0 if never
    bumped).  Summed across workers to assert zero double-execution."""
    return int(_chaos_counters.get(token, 0))


@_reg.handler(name="chaos/reset", read_only=False)
def chaos_reset(token):
    """Clear this worker's counter for ``token`` (test isolation); returns
    the value it had."""
    return int(_chaos_counters.pop(token, 0))
