"""Device-side compute ops (JAX/XLA).

All hot ops work on fixed-shape int32/uint8 SoA blocks with an explicit
valid-count scalar — static shapes keep XLA from recompiling as blocks
stream through, and padding is masked with an index iota, never sentinel
values (query bounds may legally cover the whole int32 range).
"""

from .predicate import (  # noqa: F401
    bbox_count,
    bbox_mask,
    class_count,
    class_mask,
    bbox_count_jnp,
    class_count_jnp,
)
from .compact import compact_indices, pow2_bucket  # noqa: F401
from .density import (  # noqa: F401
    GridSpec3D,
    block_density_candidates,
    density_candidates_multi,
    merge_winners_host,
)
