"""Sharding strategies: parallelism as an Estimator option.

Counterpart of ``analytics_zoo_tpu/parallel/strategy.py``, the same
grammar and rules. A strategy is a mesh layout over the ranks
(``parallel/mesh.py``) and per-parameter partition rules:

- DP    — the batch split over ``data``; parameters replicated, their
          gradients summed over the ranks.
- FSDP  — the batch split over ``fsdp`` too; each parameter and its
          optimizer state sharded over ``fsdp`` on its largest divisible
          dim, gathered for its product (backward: reduce-scatter).
- TP    — tensor parallel over ``model`` by per-parameter rules.
- SP    — the sequence over ``seq`` (``ops/ring_attention.py``,
          ``ops/ulysses.py``).
- EP    — experts over ``expert`` (``ops/moe.py``).
- PP    — pipeline stages over ``pipe`` (``parallel/pipeline.py``; the
          batch replicated over the stages).

Spell: ``"dp"``, ``"fsdp"``, ``"dp2,tp4"``, ``"dp2,sp2,tp2"``,
``"dp2,pp4"``: sizes omitted or ``-1`` absorb the remaining ranks.

A spec here is JAX's ``PartitionSpec`` as a tuple: one entry per dim,
None, an axis name, or a tuple of axis names (the first major); ``()``
is replicated. ``param_spec`` keeps JAX's three rules: the first rule
whose regex matches the path wins; a rule whose sharded dims do not
divide is dropped for that parameter (which then takes the default); a
rule naming an axis the mesh lacks is skipped. The default is fsdp's
largest divisible dim when fsdp is in use, else replicated. Rules are
matched against flax's paths and flax's shapes (``convert.shard_plan``
maps each onto the port's tensors), so JAX's rules carry over verbatim.

Each rank is one process and knows its data index (``DeviceMesh.
data_index`` over the batch axes), so a layout whose batch axes are not
process-major (``"tp4,dp2"``), which JAX refuses across processes, feeds
correctly here (ROADMAP C27).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib

_TOKEN_RE = re.compile(r"^(dp|fsdp|tp|sp|ep|pp)(-?\d*)$")

_AXIS_OF = {
    "dp": mesh_lib.DATA_AXIS,
    "fsdp": mesh_lib.FSDP_AXIS,
    "tp": mesh_lib.MODEL_AXIS,
    "sp": mesh_lib.SEQ_AXIS,
    "ep": mesh_lib.EXPERT_AXIS,
    "pp": mesh_lib.PIPE_AXIS,
}


def spec_axes(entry) -> tuple:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


@dataclass
class ShardingStrategy:
    """A mesh layout plus parameter partition rules.

    ``param_rules``: ``(path_regex, spec)`` pairs tried in order against
    the '/'-joined parameter path; the first match wins. Unmatched
    parameters are replicated (or fsdp-sharded when fsdp is in use)."""

    sizes: List[Tuple[str, int]] = field(default_factory=lambda: [("dp", -1)])
    param_rules: List[Tuple[str, Tuple]] = field(default_factory=list)

    @classmethod
    def parse(cls, spec, param_rules=None) -> "ShardingStrategy":
        if spec is None:
            return cls(param_rules=list(param_rules or []))
        if isinstance(spec, ShardingStrategy):
            return spec
        sizes = []
        for tok in str(spec).replace(" ", "").split(","):
            if not tok:
                continue
            m = _TOKEN_RE.match(tok)
            if not m:
                raise ValueError(f"bad strategy token {tok!r}; expected e.g. "
                                 "dp, tp2, fsdp-1")
            kind, num = m.group(1), m.group(2)
            sizes.append((kind, int(num) if num not in ("", "-") else -1))
        if not any(k == "dp" for k, _ in sizes) and \
                not any(n == -1 for _, n in sizes):
            sizes.insert(0, ("dp", -1))
        return cls(sizes=sizes, param_rules=list(param_rules or []))

    # ---- mesh ----
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(_AXIS_OF[k] for k, _ in self.sizes)

    def build_mesh(self, devices=None, set_default: bool = True):
        """The mesh over the ranks of the process group (one rank without
        one), or over ``devices`` of this process."""
        shape = [n for _, n in self.sizes]
        if sum(1 for n in shape if n == -1) > 1:
            raise ValueError("at most one -1 axis size")
        return mesh_lib.build_mesh(axes=self.axis_names(), shape=shape,
                                   devices=devices, set_default=set_default)

    @property
    def uses(self):
        return {k for k, _ in self.sizes}

    # ---- shardings ----
    def batch_axes(self) -> Tuple[str, ...]:
        axes = []
        if "dp" in self.uses:
            axes.append(mesh_lib.DATA_AXIS)
        if "fsdp" in self.uses:
            axes.append(mesh_lib.FSDP_AXIS)
        return tuple(axes)

    def batch_spec(self, ndim: int) -> tuple:
        axes = self.batch_axes()
        lead = axes if len(axes) != 1 else axes[0]
        return (lead,) + (None,) * (ndim - 1) if axes else ()

    def batch_shards(self, mesh) -> int:
        """How many blocks a global batch is cut into: the product of the
        batch axes' sizes."""
        n = 1
        for ax in self.batch_axes():
            n *= mesh_lib.mesh_axis_size(mesh, ax)
        return n

    def batch_feed_fraction(self, mesh) -> float:
        """The fraction of each global batch this rank feeds: ``1 / n``
        where the batch axes span ``n`` blocks (each rank its block, the
        one of its data index), ``1.0`` where the batch is replicated
        (pure tp: every rank feeds the whole batch)."""
        n = self.batch_shards(mesh)
        return 1.0 if n <= 1 else 1.0 / n

    def param_spec(self, path: str, shape: Sequence[int], mesh) -> tuple:
        """The spec of one parameter of flax ``shape`` at ``path`` (the
        module docstring has the rules)."""
        for pattern, spec in self.param_rules:
            if re.search(pattern, path):
                if not self._axes_in_mesh(spec, mesh):
                    continue
                if self._divisible(spec, shape, mesh):
                    return tuple(spec)
                break
        if "fsdp" in self.uses:
            size = mesh_lib.mesh_axis_size(mesh, mesh_lib.FSDP_AXIS)
            # shard the largest divisible dim
            order = sorted(range(len(shape)), key=lambda i: -shape[i])
            for i in order:
                if shape[i] % size == 0 and shape[i] >= size:
                    spec = [None] * len(shape)
                    spec[i] = mesh_lib.FSDP_AXIS
                    return tuple(spec)
        return ()

    @staticmethod
    def _axes_in_mesh(spec, mesh) -> bool:
        names = set(mesh.axis_names)
        return all(ax in names for entry in spec for ax in spec_axes(entry))

    @staticmethod
    def _divisible(spec, shape, mesh) -> bool:
        sizes = mesh.shape
        if len(spec) > len(shape):
            return False
        for dim, entry in enumerate(spec):
            total = 1
            for ax in spec_axes(entry):
                total *= sizes.get(ax, 1)
            if total > 1 and shape[dim] % total:
                return False
        return True

    def param_shardings(self, params, mesh):
        """The spec of every leaf of a nested dict of arrays (a flax
        ``params`` tree), keyed like it."""
        def walk(tree, prefix):
            if isinstance(tree, dict):
                return {k: walk(v, f"{prefix}{k}/") for k, v in tree.items()}
            return self.param_spec(prefix[:-1], tuple(tree.shape), mesh)
        return walk(params, "")

    def __str__(self):
        return ",".join(f"{k}{'' if n == -1 else n}" for k, n in self.sizes)
