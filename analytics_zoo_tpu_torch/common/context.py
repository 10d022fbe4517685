"""Global configuration: the part of ``OrcaContext`` that checkpointing
reads.

Counterpart of ``analytics_zoo_tpu/common/context.py`` (ref
``pyzoo/zoo/orca/common.py:21-124``, ``OrcaContextMeta``). Only
``checkpoint_max_to_keep`` is ported: how many versions
``learn/checkpoint.save_checkpoint`` keeps in a directory (default 5, an
int above 0). ``init_orca_context``, the device mesh and the other knobs
are ROADMAP A5.
"""

from __future__ import annotations


class OrcaContextMeta(type):
    """Class-property-style global knobs."""

    _checkpoint_max_to_keep = 5

    @property
    def checkpoint_max_to_keep(cls) -> int:
        return cls._checkpoint_max_to_keep

    @checkpoint_max_to_keep.setter
    def checkpoint_max_to_keep(cls, value: int):
        if not isinstance(value, int) or isinstance(value, bool) or value <= 0:
            raise ValueError(f"checkpoint_max_to_keep must be an int above "
                             f"0, got {value!r}")
        cls._checkpoint_max_to_keep = value


class OrcaContext(metaclass=OrcaContextMeta):
    """Global configuration singleton (ref pyzoo/zoo/orca/common.py:21)."""
