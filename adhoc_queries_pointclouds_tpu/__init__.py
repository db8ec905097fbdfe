"""adhoc_queries_pointclouds_tpu — an ad-hoc point-cloud query engine in JAX.

A from-scratch JAX/XLA redesign with the capabilities of the reference
Rust engine `igd-geo/adhoc-queries-pointclouds` (the artifact for "Executing
ad-hoc queries on large geospatial data sets without acceleration structures"):
brute-force columnar scans over unindexed LAS / LAZ / LAST / LAZER point
clouds, with bounding-box, classification and max-density queries, count or
collect-and-write-back outputs, and data-parallel execution — here over a
`jax.sharding.Mesh` of GPUs instead of a rayon thread pool.

Layer map (device-first, not a port):

    host                                   device (GPU)
    ---------------------------------      --------------------------------
    formats/   LAS/LAST/LAZER/LAZ codecs   ops/       fused predicate scans,
               -> int32 SoA point blocks              compaction, grid-sample
    models/    query plans (bbox/class/    parallel/  1-D mesh shard_map,
               density, collect vs count)             psum count reduction,
    utils/     AABB math, local-coords                host<->device pipeline
               conversion, timers
    engine.py  orchestration (the reference's main.rs:191 equivalent)
    cli.py     `query` CLI surface (main.rs:198-219 flags)

The hot predicate runs on raw int32 LAS coordinates against per-file
integer-domain query bounds (reference trick: query/src/search/las.rs:86-99),
so no f64 math ever reaches the device hot path.
"""

__version__ = "0.1.0"

from . import utils  # noqa: F401
