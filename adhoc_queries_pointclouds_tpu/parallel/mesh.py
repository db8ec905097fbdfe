"""Device-mesh data parallelism: the device replacement for rayon.

The reference fans one rayon task out per *file* and folds per-file
collectors on the main thread (query/src/main.rs:146-183). Here the unit of
parallelism is a fixed-shape point *block*: every engine step feeds D blocks
(one per device) through `shard_map` over a 1-D mesh; each device runs the
fused predicate scan on its block against that block's own per-file integer
bounds, and the partial counts meet in a `psum`. Blocks from
different files can ride the same step — bounds/n_valid are per-block
operands, not compile-time constants — so ragged file sets still fill the
mesh.

Multi-host scaling note: under `jax.distributed`, the same program runs with
each host feeding its local devices from its own shard of the file manifest
(the rayon-per-file model lifted to hosts); the `psum` then spans the global
mesh. Single-host meshes are the tested configuration here.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from ..ops import predicate


def make_mesh(n_devices: int | None = None) -> Mesh:
    # The LOCAL engine meshes only this process's devices: under
    # jax.distributed (process_count > 1) a jax.devices() mesh would span
    # non-addressable devices and every readback would fail — cross-process
    # meshes belong to parallel/distributed.py, which assembles global
    # arrays from process-local shards instead.
    devices = jax.local_devices() if jax.process_count() > 1 else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.asarray(devices), axis_names=("d",))


@functools.lru_cache(maxsize=8)
def _bbox_count_fn(mesh: Mesh):
    def per_device(x, y, z, lo, hi, nv):
        # per-device shards: (K, B) blocks, (K, 3) bounds, (K,) valid counts
        counts = predicate.bbox_count_jnp_multi(x, y, z, lo, hi, nv)
        return jax.lax.psum(jnp.sum(counts, dtype=jnp.int32), "d")

    fn = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P("d", None), P("d", None), P("d", None), P("d", None), P("d", None), P("d")),
        out_specs=P(),
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=8)
def _class_count_fn(mesh: Mesh):
    def per_device(cls, target, nv):
        counts = predicate.class_count_jnp_multi(cls, target, nv)
        return jax.lax.psum(jnp.sum(counts, dtype=jnp.int32), "d")

    fn = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P("d", None), P("d"), P("d")),
        out_specs=P(),
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=64)
def _bbox_count_packed_fn(mesh: Mesh, widths: tuple, block_size: int):
    def per_device(xp, yp, zp, lo, hi, nv):
        counts = predicate.bbox_count_packed_jnp_multi(
            xp, yp, zp, lo, hi, nv, widths, block_size
        )
        return jax.lax.psum(jnp.sum(counts, dtype=jnp.int32), "d")

    fn = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P("d", None),) * 5 + (P("d"),),
        out_specs=P(),
    )
    return jax.jit(fn)


def sharded_bbox_count_packed(mesh: Mesh, xp, yp, zp, los, his, nvalids,
                              widths, block_size: int):
    """Bit-planar packed-transport bbox count over D*K blocks. xp/yp/zp:
    (D*K, k//8*B + k%8*(B//8)) u8 plane stacks; los/his residual-space
    bounds; widths a static (kx, ky, kz) bit tuple (one compiled variant
    per width combo)."""
    return _bbox_count_packed_fn(mesh, tuple(widths), block_size)(
        xp, yp, zp, los, his, nvalids
    )


@functools.lru_cache(maxsize=8)
def _class_count_packed_fn(mesh: Mesh):
    def per_device(words, target, nv):
        counts = predicate.class_count_packed_jnp_multi(words, target, nv)
        return jax.lax.psum(jnp.sum(counts, dtype=jnp.int32), "d")

    fn = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P("d", None), P("d"), P("d")),
        out_specs=P(),
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=8)
def _time_count_fn(mesh: Mesh):
    def per_device(ths, tls, qs, nv):
        counts = predicate.time_count_jnp_multi(ths, tls, qs, nv)
        return jax.lax.psum(jnp.sum(counts, dtype=jnp.int32), "d")

    fn = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P("d", None), P("d", None), P("d", None), P("d")),
        out_specs=P(),
    )
    return jax.jit(fn)


def sharded_time_count(mesh: Mesh, ths, tls, qs, nvalids):
    """Count encoded-GPS-time range hits across D*K blocks (exact f64
    semantics via the order-preserving int32 split encoding)."""
    return _time_count_fn(mesh)(ths, tls, qs, nvalids)


@functools.lru_cache(maxsize=64)
def _time_count_packed_fn(mesh: Mesh, widths: tuple, block_size: int):
    def per_device(thp, tlp, qs, nv):
        counts = predicate.time_count_packed_jnp_multi(
            thp, tlp, qs, nv, widths, block_size
        )
        return jax.lax.psum(jnp.sum(counts, dtype=jnp.int32), "d")

    fn = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P("d", None), P("d", None), P("d", None), P("d")),
        out_specs=P(),
    )
    return jax.jit(fn)


def sharded_time_count_packed(mesh: Mesh, thp, tlp, qs, nvalids, widths,
                              block_size: int):
    """Bit-planar packed GPS-time count over D*K blocks. thp/tlp: u8 plane
    stacks of the (hi, lo) int32 split encoding; qs residual-space encoded
    ranges; widths a static (k_hi, k_lo) bit tuple."""
    return _time_count_packed_fn(mesh, tuple(widths), block_size)(
        thp, tlp, qs, nvalids
    )


@functools.lru_cache(maxsize=64)
def _class_count_dict_fn(mesh: Mesh, k: int, block_size: int):
    def per_device(cp, targets, nv):
        counts = predicate.class_count_dict_jnp_multi(
            cp, targets, nv, k, block_size
        )
        return jax.lax.psum(jnp.sum(counts, dtype=jnp.int32), "d")

    fn = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P("d", None), P("d"), P("d")),
        out_specs=P(),
    )
    return jax.jit(fn)


def sharded_class_count_dict(mesh: Mesh, cp, targets, nvalids, k: int,
                             block_size: int):
    """Dictionary-coded class count over D*K blocks. cp: u8 plane stacks of
    per-block dictionary codes; targets: per-block target CODES (len(dict)
    on a miss — a value no point carries)."""
    return _class_count_dict_fn(mesh, k, block_size)(cp, targets, nvalids)


# ---------------------------------------------------------------------------
# sharded collect: one dispatch compacts hit indices of D*K blocks at once.
# The engine's collect path batches K blocks per chip per step exactly like
# the count path (reference main.rs:146-183 runs every query type through
# the same parallel fan-out). Each block's TRUE hit count comes back with a
# cap-bounded index buffer; blocks whose count exceeds the cap are retried
# by the caller with a bigger power-of-two bucket.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _collect_fn(mesh: Mesh, kind: str, cap: int, extra: tuple = ()):
    from ..ops import compact

    if kind == "bbox_packed":
        widths, block_size = extra

        def per_device(xp, yp, zp, los, his, nv):
            mask = predicate.bbox_mask_packed_jnp_multi(
                xp, yp, zp, los, his, nv, widths, block_size
            )
            return compact.masked_collect_multi(mask, cap=cap)

        in_specs = (P("d", None),) * 5 + (P("d"),)
    elif kind == "bbox":
        def per_device(xs, ys, zs, los, his, nv):
            mask = predicate.bbox_mask_jnp_multi(xs, ys, zs, los, his, nv)
            return compact.masked_collect_multi(mask, cap=cap)

        in_specs = (P("d", None),) * 5 + (P("d"),)
    elif kind == "class":
        def per_device(cls, targets, nv):
            mask = predicate.class_mask_jnp_multi(cls, targets, nv)
            return compact.masked_collect_multi(mask, cap=cap)

        in_specs = (P("d", None), P("d"), P("d"))
    elif kind == "class_dict":
        k, block_size = extra

        def per_device(cp, targets, nv):
            mask = predicate.class_mask_dict_jnp_multi(
                cp, targets, nv, k, block_size
            )
            return compact.masked_collect_multi(mask, cap=cap)

        in_specs = (P("d", None), P("d"), P("d"))
    elif kind == "time_packed":
        widths, block_size = extra

        def per_device(thp, tlp, qs, nv):
            mask = predicate.time_mask_packed_jnp_multi(
                thp, tlp, qs, nv, widths, block_size
            )
            return compact.masked_collect_multi(mask, cap=cap)

        in_specs = (P("d", None), P("d", None), P("d", None), P("d"))
    elif kind == "time":
        def per_device(ths, tls, qs, nv):
            mask = predicate.time_mask_jnp_multi(ths, tls, qs, nv)
            return compact.masked_collect_multi(mask, cap=cap)

        in_specs = (P("d", None), P("d", None), P("d", None), P("d"))
    else:
        raise ValueError(f"unknown collect kind {kind!r}")

    fn = shard_map(
        per_device,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P("d"), P("d", None)),
    )
    return jax.jit(fn)


def sharded_collect(mesh: Mesh, kind: str, arrays: tuple, cap: int,
                    extra: tuple = ()):
    """Run the fused predicate+compaction step over D*K stacked blocks.

    arrays: the per-kind operand tuple (see _collect_fn); extra: static
    config for packed kinds ((kx, ky, kz), block_size). Returns
    (counts (D*K,) int32, indices (D*K, cap) int32 padded with block size).
    """
    return _collect_fn(mesh, kind, cap, extra)(*arrays)


# ---------------------------------------------------------------------------
# sharded density: predicate + exact-cell candidate selection for D*K blocks
# of ONE file per dispatch (the grid tables are per-file constants and ride
# replicated, so they upload once and broadcast over the mesh).
# ---------------------------------------------------------------------------

_DENSITY_TABLE_KEYS = (
    "bx", "by", "bz", "crx", "cfx", "cry", "cfy", "crz", "cfz",
    "q0i", "q0f", "dpl", "scale", "dims", "eps_abs",
)


@functools.lru_cache(maxsize=32)
def _density_fn(mesh: Mesh, kind: str, cap: int):
    from ..ops import density as density_ops

    nt = len(_DENSITY_TABLE_KEYS)

    def per_device(*args):
        tbl = dict(zip(_DENSITY_TABLE_KEYS, args[-nt:]))
        if kind == "bbox":
            xs, ys, zs, los, his, nv = args[:-nt]
            mask = predicate.bbox_mask_jnp_multi(xs, ys, zs, los, his, nv)
        elif kind == "class":
            xs, ys, zs, cls, targets, nv = args[:-nt]
            mask = predicate.class_mask_jnp_multi(cls, targets, nv)
        else:
            xs, ys, zs, ths, tls, qs, nv = args[:-nt]
            mask = predicate.time_mask_jnp_multi(ths, tls, qs, nv)
        return density_ops.density_candidates_multi(xs, ys, zs, mask, nv, tbl, cap)

    pred_specs = {
        # 2-D block operands shard on axis 0; 1-D per-block scalars on "d"
        "bbox": (P("d", None),) * 5 + (P("d"),),  # x y z lo hi nv
        "class": (P("d", None),) * 4 + (P("d"), P("d")),  # x y z cls tgt nv
        "time": (P("d", None),) * 6 + (P("d"),),  # x y z th tl q nv
    }[kind]
    in_specs = pred_specs + (P(),) * nt
    fn = shard_map(
        per_device,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P("d"), P("d", None)),
    )
    return jax.jit(fn)


def sharded_density(mesh: Mesh, kind: str, arrays: tuple, tables: dict, cap: int):
    """Predicate + density candidate selection over D*K blocks of one file.

    Returns (candidate counts (D*K,), candidate indices (D*K, cap))."""
    vals = tuple(tables[k] for k in _DENSITY_TABLE_KEYS)
    return _density_fn(mesh, kind, cap)(*(arrays + vals))


@functools.lru_cache(maxsize=32)
def _density_packed_fn(mesh: Mesh, kind: str, cap: int,
                       widths: tuple, block_size: int):
    """Packed-transport density step: xyz ride the link as k-bit residual
    planes (like the bbox collect path) and are reconstructed to ABSOLUTE
    int32 on device (residual + per-block base; exact — sub-32 widths cap
    residuals at 2^28 and k == 32 forces base = 0), because the density
    boundary tables live in absolute file-local coordinates."""
    from ..ops import density as density_ops

    nt = len(_DENSITY_TABLE_KEYS)

    def per_device(*args):
        tbl = dict(zip(_DENSITY_TABLE_KEYS, args[-nt:]))
        xp, yp, zp, bases = args[:4]
        xs = predicate.unpack_bits_jnp(xp, widths[0], block_size) + bases[:, 0:1]
        ys = predicate.unpack_bits_jnp(yp, widths[1], block_size) + bases[:, 1:2]
        zs = predicate.unpack_bits_jnp(zp, widths[2], block_size) + bases[:, 2:3]
        if kind == "bbox":
            los, his, nv = args[4:-nt]
            mask = predicate.bbox_mask_jnp_multi(xs, ys, zs, los, his, nv)
        elif kind == "class":
            cls, targets, nv = args[4:-nt]
            mask = predicate.class_mask_jnp_multi(cls, targets, nv)
        else:
            ths, tls, qs, nv = args[4:-nt]
            mask = predicate.time_mask_jnp_multi(ths, tls, qs, nv)
        return density_ops.density_candidates_multi(xs, ys, zs, mask, nv, tbl, cap)

    pred_specs = {
        "bbox": (P("d", None),) * 2 + (P("d"),),  # lo hi nv
        "class": (P("d", None), P("d"), P("d")),  # cls tgt nv
        "time": (P("d", None),) * 3 + (P("d"),),  # th tl q nv
    }[kind]
    in_specs = (P("d", None),) * 4 + pred_specs + (P(),) * nt
    fn = shard_map(
        per_device,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P("d"), P("d", None)),
    )
    return jax.jit(fn)


def sharded_density_packed(mesh: Mesh, kind: str, arrays: tuple, tables: dict,
                           cap: int, widths: tuple, block_size: int):
    """Packed-transport variant of sharded_density. arrays = (xp, yp, zp,
    bases (D*K, 3) int32, <predicate extras>, nvs)."""
    vals = tuple(tables[k] for k in _DENSITY_TABLE_KEYS)
    return _density_packed_fn(mesh, kind, cap, widths, block_size)(
        *(arrays + vals)
    )


def sharded_bbox_count(mesh: Mesh, xs, ys, zs, los, his, nvalids):
    """Count bbox hits across D*K blocks, K per device per dispatch. All
    args stacked on axis 0 with leading dim a multiple of the mesh size.
    Returns a replicated int32 total (sum over this step's blocks only, so
    it cannot overflow: K*B per device stays far below 2^31)."""
    return _bbox_count_fn(mesh)(xs, ys, zs, los, his, nvalids)


def sharded_class_count(mesh: Mesh, clss, targets, nvalids):
    import numpy as np

    # 4x-packed path: view the host u8 column as int32 words (zero-copy) so
    # the device tests 4 points per element. Same bytes cross the link.
    if isinstance(clss, np.ndarray) and clss.dtype == np.uint8 and clss.shape[-1] % 4 == 0:
        words = predicate.pack_class_words(clss)
        return _class_count_packed_fn(mesh)(words, targets, nvalids)
    return _class_count_fn(mesh)(clss, targets, nvalids)
