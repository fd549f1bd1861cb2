"""Per-chip cost of one step, counted op by op on ``meta`` DTensors.

The port's counterpart of ``repro/launch/hlo_analysis.py``.  The reference
parses the SPMD-partitioned HLO text that XLA compiles; PyTorch has no
HLO, so :func:`analyze` runs the step itself, on ``meta`` DTensors over a
fake process group (``launch.mesh.fake_world``), under a dispatch mode that
sees every op DTensor issues on the **local shards** (each rank's shapes)
and every collective its redistributions issue:

* ``flops`` -- ``torch.utils.flop_counter``'s formulas (matmuls,
  attention, convolutions) applied to the local shapes, plus one flop per
  output element of a pointwise op (the reference's elementwise count).
  ``FlopCounterMode`` itself sees a DTensor op at its *global* shape, which
  is why the count is taken below DTensor.  Replicated compute counts on
  every chip, as the reference's ``useful_ratio`` intends;
* ``hbm_bytes`` -- each op's operand and result bytes (views and empty
  allocations move nothing): eager PyTorch runs op by op, so this is what
  the plain step would move, an upper bound on the kernels' traffic;
* ``collective_bytes`` -- the bytes the ``c10d_functional`` collectives
  move per chip, the larger of input and output, all-reduce counted twice
  (a ring), by op in ``collective_by_op`` under the HLO names;
* ``peak_temp_bytes`` -- the most bytes the step's fresh results held at
  once (each freed when its tensor dies; views counted with their base);
* ``loops`` -- (layer function, invocations): the model's Python loop over
  its layers stands where the reference reads a ``while`` loop's trip
  count; ``sites`` carry the layer function whose call issued each op, so
  per-layer sites repeat once per invocation.

The kernels' plain versions run on ``meta`` inside :func:`analyze`
(``kernels._build.plain_on_meta``), as the reference's dry-run lowers its
plain attention.  DTensor's own shape propagation (it runs each op once on
fake tensors of the global shape) is not counted.
"""

from __future__ import annotations

import dataclasses
import sys
import weakref

import torch

#: the model functions one call of which is one layer
LAYER_FUNCTIONS = frozenset({"layer_apply", "mlstm_block_apply", "slstm_block_apply",
                             "mamba2_block_apply", "_dec_layer"})

#: c10d_functional op -> (HLO name, wire factor)
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", 1.0),
    "all_gather_into_tensor_coalesced": ("all-gather", 1.0),
    "all_reduce": ("all-reduce", 2.0),
    "all_reduce_coalesced": ("all-reduce", 2.0),
    "reduce_scatter_tensor": ("reduce-scatter", 1.0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 1.0),
    "all_to_all_single": ("all-to-all", 1.0),
    "broadcast": ("collective-permute", 1.0),
}
#: results that alias their input though the schema does not say so
_ALIASES = frozenset({"wait_tensor", "_wrap_tensor_autograd"})
#: ops that move no bytes
_FREE = _ALIASES | {"empty", "empty_strided", "empty_like", "detach", "lift_fresh"}


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_op: dict = dataclasses.field(default_factory=dict)
    loops: list = dataclasses.field(default_factory=list)   # (layer function, calls)
    sites: list = dataclasses.field(default_factory=list)   # (bytes, flops, desc)
    ops: int = 0
    #: the most bytes the step's own results held at once (per chip)
    peak_temp_bytes: int = 0

    def repeats(self, prefix: str) -> dict:
        """{site: times issued} of the sites whose description starts with
        ``prefix`` (a layer function's name: its per-layer sites)."""
        out: dict = {}
        for _, _, d in self.sites:
            if d.startswith(prefix + "::"):
                out[d] = out.get(d, 0) + 1
        return out


def _tensors(tree):
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _dispatch_mode():
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class CostMode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.cost = OpCost()
            self._last_frame: dict = {}
            self._calls: dict = {}
            self.live = self.peak = 0

        def _freed(self, nbytes):
            self.live -= nbytes

        def _allocated(self, func, outs):
            """Track the bytes of fresh results while they live."""
            if func.overloadpacket.__name__ in _ALIASES or any(
                    r.alias_info is not None for r in func._schema.returns):
                return
            for t in outs:
                b = _nbytes(t)
                self.live += b
                weakref.finalize(t, self._freed, b)
            self.peak = max(self.peak, self.live)

        def _layer(self) -> str:
            f = sys._getframe(2)
            while f is not None:
                name = f.f_code.co_name
                if name in LAYER_FUNCTIONS and "repro_torch" in f.f_code.co_filename:
                    if self._last_frame.get(name) is not f:
                        self._last_frame[name] = f   # held, so its id is not reused
                        self._calls[name] = self._calls.get(name, 0) + 1
                    return name
                f = f.f_back
            return "step"

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented          # let DTensor issue its local ops
            out = func(*args, **kwargs)
            ins, outs = _tensors((args, kwargs)), _tensors(out)
            if any(isinstance(t, FakeTensor) for t in ins + outs):
                return out                     # DTensor's shape propagation
            self._allocated(func, outs)
            self._account(func, args, kwargs, ins, out)
            return out

        def _account(self, func, args, kwargs, ins, out):
            cost = self.cost
            name = func.overloadpacket.__name__
            outs = _tensors(out)
            if func.namespace in ("_c10d_functional", "c10d_functional"):
                if name not in _COLLECTIVES:
                    return
                hlo, factor = _COLLECTIVES[name]
                b = max([_nbytes(t) for t in ins + outs] or [0]) * factor
                cost.collective_bytes += b
                cost.collective_by_op[hlo] = cost.collective_by_op.get(hlo, 0.0) + b
                cost.sites.append((b, 0.0, f"{self._layer()}::COLL::{hlo}::"
                                           f"{[tuple(t.shape) for t in ins]}"))
                return
            if name in _FREE:
                return
            cost.ops += 1
            flops = 0.0
            if func.overloadpacket in flop_registry:
                flops = float(flop_registry[func.overloadpacket](*args, **kwargs, out_val=out))
            elif torch.Tag.pointwise in func.tags:
                flops = float(sum(t.numel() for t in outs))
            # views and aliases move nothing; in-place writes (copy_) do
            view = func.is_view or any(r.alias_info is not None and not r.alias_info.is_write
                                       for r in func._schema.returns)
            nbytes = 0.0 if view else float(sum(_nbytes(t) for t in ins + outs))
            cost.flops += flops
            cost.hbm_bytes += nbytes
            if flops or nbytes:
                shapes = [tuple(t.shape) for t in ins][:3]
                cost.sites.append((nbytes, flops, f"{self._layer()}::{name}::{shapes}"))

        def finish(self) -> OpCost:
            self.cost.loops = sorted(self._calls.items())
            self.cost.peak_temp_bytes = self.peak
            self._last_frame.clear()
            return self.cost

    return CostMode()


def analyze(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` (a step over ``meta`` DTensors) and return
    ``(its result, OpCost)`` per chip."""
    from repro_torch.kernels import _build

    mode = _dispatch_mode()
    with _build.plain_on_meta(), mode:
        result = fn(*args, **kwargs)
    return result, mode.finish()


def matmul_flops(cost: OpCost) -> float:
    """The flops of the sites whose formula came from the flop counter
    (matmuls, attention, convolutions), without the pointwise count."""
    from torch.utils.flop_counter import flop_registry

    names = {p.__name__ for p in flop_registry}
    return float(sum(f for _, f, d in cost.sites if d.split("::")[1] in names))

