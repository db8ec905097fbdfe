"""Query models: the engine's declarative plan layer.

Replaces the reference's Searcher double-dispatch (query/src/search/searcher.rs)
with a data-driven plan: one compiled engine executes every (query x format)
combination, so there is no Regular-vs-Optimized fork — the host codec layer
plays the role of the reference's generic "regular" pasture path, and the
device kernels are always the optimized path.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

from ..utils.aabb import AABB


@dataclasses.dataclass(frozen=True)
class BoundsQuery:
    """Closed-box world-space AABB predicate (reference BoundsSearcher)."""

    bounds: AABB


@dataclasses.dataclass(frozen=True)
class ClassQuery:
    """Classification equality predicate (reference ClassSearcher)."""

    classification: int

    def __post_init__(self):
        if not 0 <= self.classification <= 255:
            raise ValueError("classification must be a u8")


@dataclasses.dataclass(frozen=True)
class TimeRangeQuery:
    """GPS-time half-open range predicate: start <= t < end.

    The reference only has dead stubs for this
    (query/src/search/las.rs:297-367, `_search_las_file_by_time_range*`);
    here it is a working query type. GPS times are f64; the host encodes
    them as order-preserving (hi, lo) int32 pairs and the device compares
    those (ops/predicate.py) — exact f64 semantics in int32 compares.
    """

    start: float
    end: float

    def __post_init__(self):
        if not self.start < self.end:
            raise ValueError("time range start must be < end")


@dataclasses.dataclass(frozen=True)
class DensityConfig:
    """Max-density grid sampling (reference --density / SparseGrid).

    cell_size: grid cell edge length in meters (<= 1 point per cell_size^3 m^3).
    scope: 'file' reproduces the reference's --parallel semantics (each file
    deduped independently, main.rs:156); 'global' dedupes across the whole
    query like the reference's sequential mode (one shared collector,
    main.rs:129-133).
    """

    cell_size: float
    scope: str = "global"

    def __post_init__(self):
        if self.cell_size <= 0:
            raise ValueError("density cell size must be positive")
        if self.scope not in ("file", "global"):
            raise ValueError("density scope must be 'file' or 'global'")


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """A fully-specified query: predicate x collection x output.

    Exactly one of bounds/classification must be set (reference
    main.rs:238-244); density composes with bounds or stands alone with the
    dataset's total bounds (main.rs:253-259).
    """

    bounds: BoundsQuery | None = None
    classification: ClassQuery | None = None
    time_range: TimeRangeQuery | None = None
    density: DensityConfig | None = None
    output_dir: Path | None = None
    # Materialize and print matching points (reference StdOutCollector,
    # query/src/collect_points.rs:46-70).
    print_points: bool = False
    # Replicate the reference's exact world->local bounds conversion
    # (truncation casts + x-scale quirk, search/las.rs:88-99) for parity runs.
    parity_quirk: bool = False

    def __post_init__(self):
        n_predicates = sum(
            p is not None for p in (self.bounds, self.classification, self.time_range)
        )
        if n_predicates != 1:
            raise ValueError(
                "Specify exactly one of BOUNDS, CLASS, or TIME-RANGE"
            )

    @property
    def collects_points(self) -> bool:
        """Whether matching points must be materialized (vs counted)."""
        return (
            self.output_dir is not None
            or self.density is not None
            or self.print_points
        )
