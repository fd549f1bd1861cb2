"""Divisibility-aware sharding rules on a torch ``DeviceMesh`` (port of
``repro.models.sharding``).

Real fleets are not uniform: 20-head models meet 16-way tensor-parallel
meshes, 60-expert MoEs meet 16-way expert-parallel axes, 51866-token vocabs
meet power-of-two grids.  Every rule degrades gracefully, as the
reference's: a dim is sharded over an axis set only if its size divides
the axis product, otherwise the next fallback (or replication) applies.

:meth:`Sharder.spec` gives the reference's ``PartitionSpec`` entries
(``None``, an axis name, or a tuple of names) as a :class:`PartitionSpec`
tuple; it reads only ``mesh.mesh_dim_names`` and ``mesh.shape``, so a
plain stand-in with no process group serves the rule tests.  Where the
reference builds ``NamedSharding``s, the port places DTensors:
:meth:`Sharder.placements` turns a spec into one ``Shard(d)`` or
``Replicate()`` per mesh dim, :meth:`Sharder.distribute` places a param,
optimizer or cache tree, and :meth:`Sharder.constrain` redistributes an
activation (the reference's ``with_sharding_constraint``).

A dim sharded over several axes, ``("pod", "data")``, splits with ``pod``
the major axis in JAX; DTensor's ``[Shard(0), Shard(0)]`` splits in
mesh-dim order.  The two agree only while the tuple follows the mesh's
axis order, so :meth:`Sharder.placements` raises on any other order.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ShardingPlan


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name, or
    a tuple of names (the dim split over their product)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def mesh_axes(mesh) -> tuple:
    """The mesh's axis names (``mesh_dim_names`` of a ``DeviceMesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_shape(mesh) -> dict:
    """{axis name: size}."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh_axes(mesh), tuple(shape)))


def axis_size(mesh, axes) -> int:
    shape = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def spec_axes(entry) -> tuple:
    """The axis names of one spec entry, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class Sharder:
    """Builds PartitionSpecs from logical dim rules against a mesh.

    A *rule* for one dim is a tuple of logical names, tried in order:
      - "batch"  -> plan.batch_axes present in the mesh (pod+data)
      - "fsdp"   -> plan.fsdp_axes if plan.fsdp (ZeRO-style weight shard)
      - "model"  -> plan.model_axis
      - "seq"    -> model axis if plan.seq_shard (sequence parallelism)
      - None     -> replicate
    The first candidate whose axis product divides the dim size wins.
    """

    def __init__(self, mesh, plan: ShardingPlan):
        self.mesh = mesh
        self.plan = plan
        present = set(mesh_axes(mesh))
        self._batch = tuple(a for a in plan.batch_axes if a in present)
        self._fsdp = (
            tuple(a for a in plan.fsdp_axes if a in present) if plan.fsdp else ()
        )
        self._model = (plan.model_axis,) if plan.model_axis in present else ()
        if plan.pod_in_model and "pod" in present:
            self._model = ("pod",) + self._model
            self._batch = tuple(a for a in self._batch if a != "pod")
        self._seq = self._model if plan.seq_shard else ()

    def _resolve(self, logical) -> tuple:
        if logical is None:
            return ()
        out = []
        for name in (logical if isinstance(logical, (tuple, list)) else (logical,)):
            if name == "batch":
                out.extend(self._batch)
            elif name == "fsdp":
                out.extend(self._fsdp)
            elif name == "model":
                out.extend(self._model)
            elif name == "seq":
                out.extend(self._seq)
            elif name in mesh_axes(self.mesh):   # raw mesh axis name
                out.append(name)
        return tuple(out)

    def dim_spec(self, size: int, *candidates):
        """First candidate whose mesh-axis product divides ``size``."""
        for cand in candidates:
            axes = self._resolve(cand)
            if not axes:
                continue
            if size % axis_size(self.mesh, axes) == 0:
                return axes if len(axes) > 1 else axes[0]
        return None

    def spec(self, shape, rules) -> PartitionSpec:
        """``rules``: per-dim tuple of candidate lists (or a single logical
        name, or None).  Shorter rules are right-padded with None."""
        dims = []
        used: set = set()
        for i, size in enumerate(shape):
            rule = rules[i] if i < len(rules) else None
            if rule is None:
                dims.append(None)
                continue
            cands = rule if isinstance(rule, list) else [rule]
            picked = self.dim_spec(size, *cands)
            flat = spec_axes(picked)
            if any(a in used for a in flat):   # one mesh axis once per spec
                dims.append(None)
                continue
            used.update(flat)
            dims.append(picked)
        return PartitionSpec(*dims)

    # -- DTensor placements --------------------------------------------------

    def spec_placements(self, spec) -> list:
        """One placement per mesh dim for ``spec``: ``Shard(d)`` where
        tensor dim d is split over that axis, ``Replicate()`` elsewhere.
        Raises if a multi-axis entry does not follow the mesh's axis order
        (DTensor would split it in another order than JAX)."""
        from torch.distributed.tensor import Replicate, Shard

        names = mesh_axes(self.mesh)
        out = [Replicate() for _ in names]
        for d, entry in enumerate(spec):
            idx = [names.index(a) for a in spec_axes(entry)]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {entry!r} of dim {d} runs against the mesh "
                                 f"axis order {names}")
            for j in idx:
                out[j] = Shard(d)
        return out

    def placements(self, shape, rules) -> list:
        return self.spec_placements(self.spec(shape, rules))

    def distribute(self, tree, rules_tree):
        """Place every leaf of ``tree`` (nested dicts/tuples/lists of
        tensors, each the full tensor, the same on every rank) as a DTensor
        by the matching rule of ``rules_tree``.  Each rank keeps its own
        shard, a copy where a split leaves it part of the leaf and the leaf
        itself where not (a one-rank mesh wraps the tensors it is given, so
        a card holds one copy of a model); nothing is communicated."""
        return map_rules(lambda t, rules: self.place(t, self.placements(t.shape, rules)),
                         tree, rules_tree)

    def place(self, t, placements):
        """``t`` (the full tensor, the same on every rank) as a DTensor of
        ``placements``: this rank's chunk of every split, in mesh order."""
        from torch.distributed.tensor import DTensor

        mesh, local = self.mesh, t
        coord = mesh.get_coordinate()
        for j, q in enumerate(placements):
            n = mesh.size(j)
            if q.is_shard() and n > 1:
                if local.shape[q.dim] % n:
                    raise ValueError(f"dim {q.dim} of {tuple(t.shape)} does not split {n} ways")
                size = local.shape[q.dim] // n
                local = local.narrow(q.dim, coord[j] * size, size)
        if local is not t:   # its own storage: the caller may drop the full leaf
            local = local.clone(memory_format=torch.contiguous_format)
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=t.shape, stride=t.stride())

    def constrain(self, x, rules):
        """Redistribute the DTensor ``x`` to the placements of ``rules``
        (the reference's ``with_sharding_constraint``).  A plain tensor
        raises: nothing is left unsharded quietly."""
        from torch.distributed.tensor import DTensor

        if not isinstance(x, DTensor):
            raise TypeError(f"Sharder.constrain takes a DTensor, got {type(x).__name__}")
        want = self.placements(x.shape, rules)
        if tuple(x.placements) == tuple(want):
            return x
        return x.redistribute(self.mesh, want)

    # convenience: common activation layouts ------------------------------

    def act_btd(self, x):
        """(batch, seq, d_model): batch over data axes, optionally seq-shard."""
        return self.constrain(x, ["batch", "seq", None])

    def act_bt(self, x):
        return self.constrain(x, ["batch", "seq"])

    def logits(self, x):
        """(batch, seq, vocab): vocab over model axis (vocab-parallel head)."""
        return self.constrain(x, ["batch", None, "model"])


def map_rules(fn, tree, rules):
    """``fn(leaf, rule)`` over a tree of dicts/tuples/lists of tensors and its
    rules tree of the same containers (the tree decides what is a leaf, as
    the reference's ``dryrun.spec_tree`` walks the shapes)."""
    if isinstance(tree, dict):
        return {k: map_rules(fn, v, rules[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_rules(fn, t, r) for t, r in zip(tree, rules))
    return fn(tree, rules)


def tree_spec(sharder: Sharder, params, rules_tree) -> dict:
    """Map a rules tree over a params tree -> PartitionSpec tree."""
    return map_rules(lambda p, r: sharder.spec(tuple(p.shape), r), params, rules_tree)
