"""The sharded / replicated level split of a distributed hierarchy.

The finest levels of a distributed solve run rank-local on decomposed
blocks; once a level is small enough that the blocks would degenerate, the
residual is gathered and the remaining coarse hierarchy runs *replicated*:
every rank computes the same small coarse correction, with no further
communication until it is prolonged back into the sharded levels.

Ported from ``tpu_multigrid/dist/shard_cycle.py``: :class:`ShardedLevels`
and :func:`_replicated_cycle`, what the fused tier (:mod:`.pallas_cycle`)
reads.  ``sharded_solve``, the plain shard-local tier behind
``dist_path="jnp"``, is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..config import MultigridConfig
from ..core.grids import Hierarchy
from ..cycles import cycle


@dataclasses.dataclass(frozen=True)
class ShardedLevels:
    """Static description of the sharded/replicated level split."""
    sizes: Tuple[Tuple[int, int], ...]      # (n, S) per level, finest first
    num_sharded: int                        # first k levels run shard-local

    @property
    def sharded(self):
        return self.sizes[: self.num_sharded]

    @property
    def replicated(self):
        return self.sizes[self.num_sharded:]


def _replicated_cycle(hier: Hierarchy, cfg: MultigridConfig, k0: int, u, b):
    """The replicated coarse sub-cycle from level index ``k0``, on the plain
    torch operators: the kernels are off here, as the JAX package turns
    Pallas off inside ``shard_map``."""
    cfg = dataclasses.replace(cfg, use_kernels=False)
    return cycle(hier, cfg, u, b, k=k0)
