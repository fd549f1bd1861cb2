"""Roofline terms of a dry-run step on an NVIDIA H100 (port of
``repro.launch.roofline``, which carries TPU v5e constants)::

    compute    = flops_per_chip / 989e12        (bf16 dense tensor cores)
    memory     = hbm_bytes_per_chip / 3.35e12   (HBM3)
    collective = collective_bytes_per_chip / 450e9   (NVLink, each way)

The constants are NVIDIA's H100 SXM data sheet figures; a card run below
its 700 W limit is slower, so a measured time goes beside the card's name
and power limit.  ``flops`` and ``collective_bytes`` come from
``op_analysis`` on the local shards; the memory term is modelled from the
exact shard sizes (:func:`analytic_memory_bytes`), as the reference's is,
with the eager per-op byte count kept beside it as an upper bound.
MODEL_FLOPS is 6 N_active tokens for train, 2 N_active tokens for
inference (global); ``useful_ratio`` divides it by the flops of all chips,
which counts replicated compute as the waste it is.
"""

from __future__ import annotations

import dataclasses
import json
import os

from repro_torch.models.sharding import mesh_shape

CARD = "NVIDIA H100 80GB HBM3 (SXM data sheet)"
PEAK_FLOPS = 989e12      # bf16 dense / card
HBM_BW = 3.35e12         # bytes/s / card
LINK_BW = 450e9          # bytes/s / card, NVLink each way
HBM_BYTES = 80e9         # device memory / card

EXPERIMENT_DIR = os.environ.get(
    "HAM_EXPERIMENT_DIR",
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments"))


def tree_shard_bytes(tree) -> int:
    """Exact per-chip bytes of a tree of DTensors (or plain tensors, held
    whole): each leaf's local shard, as its placements cut it."""
    from repro_torch.optim.adamw import tree_leaves

    total = 0
    for leaf in tree_leaves(tree):
        local = leaf.to_local() if hasattr(leaf, "to_local") else leaf
        total += local.numel() * local.element_size()
    return total


def analytic_memory_bytes(cfg, cell, mesh, plan, *, param_bytes, opt_bytes,
                          cache_bytes) -> float:
    """Per-chip HBM traffic of one step over the actual shard sizes:

    train:   7 P (forward read, recompute read, gradient write and read,
             update read and write) + 2 O (moments read and write)
             + 2 (L/g) A_boundary (saved layer inputs written and read)
             + 4 logits + 3 MoE dispatch
    prefill: P + C (cache write) + 2 A_layer + logits + MoE dispatch
    decode:  P + C (cache read) + logits + MoE dispatch

    Unlike the reference's model, no attention score tiles: every
    attention and scan of the port runs in a hand-written kernel that keeps
    them on chip (flash, decode, mLSTM and SSD kernels).
    """
    shape = mesh_shape(mesh)
    batch_shard = 1
    for a in ("pod", "data"):
        if a in shape and cell.global_batch % (batch_shard * shape[a]) == 0:
            batch_shard *= shape[a]
    model_size = shape.get("model", 1)
    B_loc = max(cell.global_batch // batch_shard, 1)
    L, d, act_bytes = cfg.num_layers, cfg.d_model, 2
    S = cell.seq_len
    seq_loc = S / model_size if plan.seq_shard else S
    vocab_loc = (cfg.vocab_size / model_size
                 if cfg.vocab_size % model_size == 0 else cfg.vocab_size)
    logits = B_loc * (S if cell.kind != "decode" else 1) * vocab_loc * 4
    moe_dispatch = 0.0
    if cfg.moe is not None and cell.kind != "decode":
        moe_dispatch = (L * B_loc * S * cfg.moe.top_k * cfg.moe.capacity_factor
                        * (d + cfg.moe.d_ff_expert) * act_bytes * 2)
    if cell.kind == "train":
        g = max(getattr(cfg, "remat_group", 1), 1)
        boundary = (L / g) * B_loc * seq_loc * d * act_bytes * 2
        return (7 * param_bytes + 2 * opt_bytes + boundary + 4 * logits
                + 3 * moe_dispatch)
    if cell.kind == "prefill":
        layer_acts = 2 * L * B_loc * seq_loc * d * act_bytes
        return param_bytes + cache_bytes + layer_acts + logits + moe_dispatch
    return param_bytes + cache_bytes + logits + moe_dispatch


@dataclasses.dataclass
class RooflineReport:
    arch: str
    cell: str
    mesh: str
    chips: int
    flops_per_chip: float
    hbm_bytes_per_chip: float        # analytic model (primary memory term)
    hbm_bytes_op_ub: float           # eager per-op bytes (upper bound)
    collective_bytes_per_chip: float
    model_flops: float
    collective_by_op: dict
    memory_stats: dict
    card: str = CARD

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_chip / LINK_BW

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / the flops of all chips."""
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """(MODEL_FLOPS / chips / peak) / the bound: the share of the bound
        step time spent on useful model flops."""
        ideal = self.model_flops / self.chips / PEAK_FLOPS
        return ideal / self.t_bound if self.t_bound else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(
            t_compute=self.t_compute, t_memory=self.t_memory,
            t_collective=self.t_collective, t_bound=self.t_bound,
            bottleneck=self.bottleneck, useful_ratio=self.useful_ratio,
            roofline_fraction=self.roofline_fraction,
        )
        return d

    def summary(self) -> str:
        return (
            f"{self.arch:18s} {self.cell:12s} {self.mesh:10s} "
            f"comp={self.t_compute*1e3:9.3f}ms "
            f"mem={self.t_memory*1e3:9.3f}ms "
            f"coll={self.t_collective*1e3:9.3f}ms "
            f"bound={self.bottleneck:10s} "
            f"useful={self.useful_ratio:6.1%} "
            f"roofline={self.roofline_fraction:6.1%}"
        )


def build_report(arch, cell, mesh_name, chips, cost, model_flops, memory_stats,
                 analytic_bytes=None) -> RooflineReport:
    return RooflineReport(
        arch=arch, cell=cell, mesh=mesh_name, chips=chips,
        flops_per_chip=cost.flops,
        hbm_bytes_per_chip=(analytic_bytes if analytic_bytes is not None
                            else cost.hbm_bytes),
        hbm_bytes_op_ub=cost.hbm_bytes,
        collective_bytes_per_chip=cost.collective_bytes,
        model_flops=model_flops,
        collective_by_op=dict(cost.collective_by_op),
        memory_stats=memory_stats,
    )


def save_report(report: RooflineReport, tag: str = "baseline") -> str:
    d = os.path.join(EXPERIMENT_DIR, "dryrun_h100")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{report.arch}_{report.cell}_{report.mesh}_{tag}.json")
    with open(path, "w") as f:
        json.dump(report.to_dict(), f, indent=1)
    return path
