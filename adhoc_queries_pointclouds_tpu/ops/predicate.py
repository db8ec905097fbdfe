"""Predicate scans: bbox containment, class equality and GPS-time range.

The reference's hot loops (query/src/search/las.rs:101-146,
last.rs:117-164) as fused XLA computations: the per-point test runs on raw
int32 LAS coordinates against per-file integer-domain query bounds — no f64
math, no world-space materialization for non-hits. The scan is
memory-bandwidth-bound (12 B/point for bbox, 1 B/point for class); XLA
fuses the compares, the valid-index mask and the sum into one reduction
that reads each byte once.

Padding is masked by global point index < n_valid — sentinel coordinates are
impossible since a query may legally cover the full int32 range.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# jnp reference implementations (XLA-fused)
# ---------------------------------------------------------------------------


def bbox_mask_jnp(x, y, z, lo, hi, n_valid):
    """Boolean hit mask for the closed box lo <= (x,y,z) <= hi."""
    idx = jax.lax.iota(jnp.int32, x.shape[0])
    m = (x >= lo[0]) & (x <= hi[0])
    m &= (y >= lo[1]) & (y <= hi[1])
    m &= (z >= lo[2]) & (z <= hi[2])
    return m & (idx < n_valid)


def class_mask_jnp(cls, class_value, n_valid):
    idx = jax.lax.iota(jnp.int32, cls.shape[0])
    return (cls == class_value.astype(cls.dtype)) & (idx < n_valid)


def bbox_count_jnp(x, y, z, lo, hi, n_valid):
    return jnp.sum(bbox_mask_jnp(x, y, z, lo, hi, n_valid), dtype=jnp.int32)


def class_count_jnp(cls, class_value, n_valid):
    return jnp.sum(class_mask_jnp(cls, class_value, n_valid), dtype=jnp.int32)


# jitted-once entry points (a fresh jax.jit wrapper per call would re-trace
# every block; these share one compilation cache across the whole run)
_bbox_mask_jit = jax.jit(bbox_mask_jnp)
_class_mask_jit = jax.jit(class_mask_jnp)
_bbox_count_jit = jax.jit(bbox_count_jnp)
_class_count_jit = jax.jit(class_count_jnp)


# ---------------------------------------------------------------------------
# GPS-time range predicate on device via order-preserving f64 -> (i32, i32)
# encoding. The reference's time query compares f64 GPS times
# (search/las.rs:297-367 stubs), and the device program runs without x64
# mode. IEEE-754 doubles are totally
# ordered by their sign-flipped bit pattern, so the host encodes each f64
# into a lexicographic (hi, lo) int32 pair once (vectorized numpy bit ops),
# and the device predicate is two exact int32 lexicographic compares — bit
# -exact f64 semantics with zero floating-point device math.
# ---------------------------------------------------------------------------


def encode_f64_sortable(t) -> tuple:
    """f64 array -> (hi, lo) int32 arrays, order-preserving.

    enc(a) < enc(b) lexicographically (signed int32) iff a < b as doubles
    (total order; NaNs sort by payload, which is fine for a range predicate
    — NaN GPS times are garbage-in-garbage-out, matching what an f64
    compare would do for the reference). -0.0 is normalized to +0.0 first
    (`t + 0.0`) so encoded compares agree with IEEE f64 compares at that
    edge (f64 has -0.0 == 0.0; the raw bit order would put -0.0 < +0.0).
    """
    import numpy as np

    arr = np.asarray(t, np.float64) + 0.0  # -0.0 -> +0.0
    bits = np.ascontiguousarray(arr).view(np.uint64)
    neg = (bits >> np.uint64(63)).astype(bool)
    flipped = np.where(neg, ~bits, bits ^ np.uint64(1 << 63))
    hi = ((flipped >> np.uint64(32)).astype(np.uint32) ^ np.uint32(0x80000000)).view(
        np.int32
    )
    lo = ((flipped & np.uint64(0xFFFFFFFF)).astype(np.uint32) ^ np.uint32(0x80000000)).view(
        np.int32
    )
    return hi, lo


def encode_f64_scalar(v: float) -> tuple[int, int]:
    import numpy as np

    hi, lo = encode_f64_sortable(np.asarray([v], np.float64))
    return int(hi[0]), int(lo[0])


def time_mask_jnp(th, tl, q, n_valid):
    """Half-open [start, end) on encoded times. q = (q0h, q0l, q1h, q1l)."""
    idx = jax.lax.iota(jnp.int32, th.shape[0])
    ge = (th > q[0]) | ((th == q[0]) & (tl >= q[1]))
    lt = (th < q[2]) | ((th == q[2]) & (tl < q[3]))
    return ge & lt & (idx < n_valid)


def time_mask_jnp_multi(ths, tls, qs, nvs):
    """(K, B) encoded times + (K, 4) encoded range -> (K, B) bool."""
    idx = jax.lax.broadcasted_iota(jnp.int32, ths.shape, 1)
    ge = (ths > qs[:, 0:1]) | ((ths == qs[:, 0:1]) & (tls >= qs[:, 1:2]))
    lt = (ths < qs[:, 2:3]) | ((ths == qs[:, 2:3]) & (tls < qs[:, 3:4]))
    return ge & lt & (idx < nvs[:, None])


def time_count_jnp_multi(ths, tls, qs, nvs):
    return jnp.sum(time_mask_jnp_multi(ths, tls, qs, nvs), axis=1, dtype=jnp.int32)


def class_mask_jnp_multi(cls, targets, nvs):
    idx = jax.lax.broadcasted_iota(jnp.int32, cls.shape, 1)
    return (idx < nvs[:, None]) & (cls.astype(jnp.int32) == targets[:, None])


# ---------------------------------------------------------------------------
# multi-block scans: K blocks with per-block bounds in ONE dispatch.
# Streaming queries batch K blocks per device per step, so the per-dispatch
# cost is amortized K-fold; bounds and valid counts are (K, ...) operands.
# ---------------------------------------------------------------------------


def bbox_mask_jnp_multi(xs, ys, zs, los, his, nvs):
    """(K, B) coords + (K, 3) bounds + (K,) valid -> (K, B) bool."""
    idx = jax.lax.broadcasted_iota(jnp.int32, xs.shape, 1)
    m = idx < nvs[:, None]
    m &= (xs >= los[:, 0:1]) & (xs <= his[:, 0:1])
    m &= (ys >= los[:, 1:2]) & (ys <= his[:, 1:2])
    m &= (zs >= los[:, 2:3]) & (zs <= his[:, 2:3])
    return m


def bbox_count_jnp_multi(xs, ys, zs, los, his, nvs):
    return jnp.sum(bbox_mask_jnp_multi(xs, ys, zs, los, his, nvs), axis=1, dtype=jnp.int32)


def class_count_jnp_multi(cls, targets, nvs):
    idx = jax.lax.broadcasted_iota(jnp.int32, cls.shape, 1)
    m = (idx < nvs[:, None]) & (cls.astype(jnp.int32) == targets[:, None])
    return jnp.sum(m, axis=1, dtype=jnp.int32)


# ---------------------------------------------------------------------------
# Bit-planar packed coordinate transport (H2D diet). End-to-end streaming is
# host->device-link-bound (12 B/pt of raw int32 xyz), but most blocks span
# far less than 32 bits per axis: the host ships each axis as the EXACT
# k-bit residual against a per-block base (k = bit_length(max - min)),
# laid out as k//8 byte planes plus k%8 bit planes (np.packbits, little
# bit order) — e.g. a 20-bit axis costs 2.5 B/pt instead of 4. The device
# reconstructs with astype+shift+or, purely elementwise, no gathers, then
# runs the same closed-box compare against residual-space bounds
# (lo - base, hi - base). Exactness is untouched: r in [lo-base, hi-base]
# <=> x in [lo, hi] in i64, residuals fit int32 for k <= 31, and k == 32
# ships the raw two's-complement bytes with base 0. Because every plane is
# extracted from the full u32 residual, blocks of different native widths
# stack into one step at the step's max width with no re-packing — the
# higher planes of narrow blocks are simply zero. This applies the
# reference hot loop's byte economy (query/src/search/las.rs:101-119) to
# the transport link instead of RAM.
#
# Layout per axis: one (K, nbytes*B + nbits*(B//8)) u8 array; byte plane p
# of block k at [k, p*B:(p+1)*B), bit plane q at
# [k, nbytes*B + q*(B//8) : ...). B % 8 == 0 whenever nbits > 0.
# ---------------------------------------------------------------------------


def bits_width(rng_i64) -> int:
    """Residual bits needed for a non-negative int range (max - min)."""
    return max(int(rng_i64).bit_length(), 0)


def residual_u32(col_i32, k: int, base: int):
    """int32 column -> u32 residual stream for a k-bit packing.

    k == 32 with base == 0 ships the raw two's-complement words; k == 32
    with base != 0 arises when a NARROW block is stacked into a 32-bit-wide
    step (the engine forces base=0 whenever a block's own range needs 32
    bits, so these residuals always stay < 2^31 and the device's signed
    int32 compare remains exact). Mirrors the native packer's mod-2^32
    arithmetic (aqpc_native.cpp aqpc_pack_bits)."""
    import numpy as np

    if k >= 32 and base == 0:
        return np.ascontiguousarray(col_i32, np.int32).view(np.uint32)
    return (col_i32.astype(np.int64) - base).astype(np.uint32)


def pack_bits_into(out_row, col_i32, k: int, base: int, block_size: int) -> None:
    """Write the k-bit planes of (col - base) into one stacked row.

    out_row: (nbytes*B + nbits*(B//8),) u8 slice of the step operand; col
    may be shorter than B (ragged tail: trailing plane bytes are left
    unwritten — every kernel masks by n_valid). Uses the single-pass native
    packer when available (the numpy path is ~k/4 strided passes). A u8
    col (dictionary codes, base 0, k <= 8) stays u8 through the native
    packer — no int32 widening pass on the host."""
    import numpy as np

    from ..native import pack_bits as native_pack_bits
    from ..native import pack_bits_u8 as native_pack_bits_u8

    if (
        getattr(col_i32, "dtype", None) == np.uint8
        and base == 0
        and 1 <= k <= 8
        and out_row.flags.c_contiguous
    ):
        col8 = np.ascontiguousarray(col_i32, np.uint8)
        if native_pack_bits_u8(col8, k, out_row, block_size):
            return
    col = np.ascontiguousarray(col_i32, np.int32)
    if out_row.flags.c_contiguous and native_pack_bits(
        col, base, k, out_row, block_size
    ):
        return
    r_u32 = residual_u32(col, k, base)
    nbytes, nbits = k // 8, k % 8
    n = r_u32.shape[0]
    for p in range(nbytes):
        out_row[p * block_size : p * block_size + n] = (
            r_u32 >> np.uint32(8 * p)
        ).astype(np.uint8)
    if nbits:
        off = nbytes * block_size
        bb = block_size // 8
        nb = (n + 7) // 8
        for q in range(nbits):
            out_row[off + q * bb : off + q * bb + nb] = np.packbits(
                ((r_u32 >> np.uint32(8 * nbytes + q)) & np.uint32(1)).astype(
                    np.uint8
                ),
                bitorder="little",
            )


def packed_row_width(k: int, block_size: int) -> int:
    return (k // 8) * block_size + (k % 8) * (block_size // 8)


def unpack_bits_jnp(packed, k: int, block_size: int):
    """(K, nbytes*B + nbits*(B//8)) u8 -> (K, B) int32 residuals (device)."""
    rows = packed.shape[0]
    nbytes, nbits = k // 8, k % 8
    r = jnp.zeros((rows, block_size), jnp.int32)
    for p in range(nbytes):
        plane = packed[:, p * block_size : (p + 1) * block_size]
        r = r | (plane.astype(jnp.int32) << (8 * p))
    if nbits:
        off = nbytes * block_size
        bb = block_size // 8
        shifts = jnp.arange(8, dtype=jnp.int32)
        for q in range(nbits):
            bp = packed[:, off + q * bb : off + (q + 1) * bb].astype(jnp.int32)
            bits = (bp[:, :, None] >> shifts) & 1  # little bit order
            r = r | (bits.reshape(rows, block_size) << (8 * nbytes + q))
    return r


def bbox_count_packed_jnp_multi(xp, yp, zp, los, his, nvs, widths, block_size):
    """Packed-transport bbox count. widths: static (kx, ky, kz) bit tuple;
    los/his are residual-space per-block bounds (already base-shifted)."""
    xs = unpack_bits_jnp(xp, widths[0], block_size)
    ys = unpack_bits_jnp(yp, widths[1], block_size)
    zs = unpack_bits_jnp(zp, widths[2], block_size)
    return bbox_count_jnp_multi(xs, ys, zs, los, his, nvs)


def bbox_mask_packed_jnp_multi(xp, yp, zp, los, his, nvs, widths, block_size):
    xs = unpack_bits_jnp(xp, widths[0], block_size)
    ys = unpack_bits_jnp(yp, widths[1], block_size)
    zs = unpack_bits_jnp(zp, widths[2], block_size)
    return bbox_mask_jnp_multi(xs, ys, zs, los, his, nvs)


# ---------------------------------------------------------------------------
# Packed-transport GPS-time kernels. The (hi, lo) int32 split encoding ships
# 8 B/pt raw; on real flight-line data each block spans a narrow time range,
# so the hi words are near-constant (a few residual bits against the block
# min) and even the lo words often share high bits. Both columns ride the
# same bit-planar packer as xyz; the lexicographic range compare runs in
# residual space against per-block base-shifted (and saturating-clipped)
# query words. Exactness argument is the bbox one applied per word: sub-32
# widths are capped at 28 bits so residuals stay < 2^28 and never collide
# with a saturated bound — this holds for the equality compares
# (rth == qh') too, not just the orderings.
# ---------------------------------------------------------------------------


def time_count_packed_jnp_multi(thp, tlp, qs, nvs, widths, block_size):
    """Packed-transport GPS-time count. widths: static (k_hi, k_lo) bits;
    qs: (K, 4) residual-space encoded range (base-shifted, clipped)."""
    ths = unpack_bits_jnp(thp, widths[0], block_size)
    tls = unpack_bits_jnp(tlp, widths[1], block_size)
    return time_count_jnp_multi(ths, tls, qs, nvs)


def time_mask_packed_jnp_multi(thp, tlp, qs, nvs, widths, block_size):
    ths = unpack_bits_jnp(thp, widths[0], block_size)
    tls = unpack_bits_jnp(tlp, widths[1], block_size)
    return time_mask_jnp_multi(ths, tls, qs, nvs)


# ---------------------------------------------------------------------------
# Per-block class-dictionary transport. Real files rarely use more than a
# handful of ASPRS classes, so the 1 B/pt classification column (the
# reference's LAST showcase, query/src/search/last.rs:253-291) still ships
# 4-8x more entropy than it holds. The host builds a per-block dictionary
# (the sorted set of distinct class values), remaps the column to dictionary
# codes, and ships the codes as k-bit planes (k = bits for the largest
# code, pow2-rounded): <= 16 classes ride at 4 bits (0.5 B/pt), <= 2 at
# 1 bit. The device never decodes back to class values — it compares codes
# against the target's code (host-computed; a miss uses len(dict), a code no
# point carries, so the count is exactly 0). A single-class block packs to
# k = 0: ZERO plane bytes cross the link and the compare degenerates to
# 0 == tcode, i.e. all-match or all-miss decided by the target row alone.
# (The count path never ships single-class or target-absent blocks at all —
# the host resolves them to n_valid or 0 from the dictionary; the collect
# path ships every block at >= 1 bit so step operands are never zero-width.)
# ---------------------------------------------------------------------------


def class_dict_encode(cls_u8):
    """One block's u8 class column -> (present values sorted u8, codes u8).

    codes[i] = index of cls_u8[i] in present (dense, 0-based). Native path:
    one C pass (presence table + LUT gather) at memory speed; numpy
    fallback: bincount + 256-entry LUT gather (~3x the host traffic, which
    matters when the host feeder is the bottleneck)."""
    import numpy as np

    from ..native import dict_encode_u8 as native_dict_encode

    col = np.ascontiguousarray(cls_u8, np.uint8)
    native = native_dict_encode(col)
    if native is not None:
        return native
    counts = np.bincount(col, minlength=256)
    present = np.flatnonzero(counts).astype(np.uint8)
    lut = np.zeros(256, np.uint8)
    lut[present] = np.arange(len(present), dtype=np.uint8)
    return present, lut[col]


def class_dict_width(n_present: int, block_size: int) -> int:
    """Plane bits for a dictionary of n_present entries: pow2-rounded so the
    per-step static width takes few distinct values (each combo is one jit
    specialization), byte-rounded when bit planes can't be laid out."""
    k = bits_width(max(n_present - 1, 0))
    if block_size % 8:
        return 8  # bit planes need B % 8 == 0; byte planes only
    p = 1
    while p < k:
        p *= 2
    return p  # 1..8 (a single-class block still ships its 1-bit zeros)


def class_count_dict_jnp_multi(cp, targets, nvs, k, block_size):
    """Dictionary-coded class count: (K, planes) u8 -> (K,) counts.
    targets are per-block dictionary CODES (not class values)."""
    codes = unpack_bits_jnp(cp, k, block_size)
    return class_count_jnp_multi(codes, targets, nvs)


def class_mask_dict_jnp_multi(cp, targets, nvs, k, block_size):
    codes = unpack_bits_jnp(cp, k, block_size)
    return class_mask_jnp_multi(codes, targets, nvs)


# ---------------------------------------------------------------------------
# 4x-packed class scan: the u8 classification column viewed as int32
# words, 4 points per element, so the scan tests 4 points per element
# operation without touching more bytes. Per word: XOR with the 4x-replicated target
# (matching bytes become zero), then the carry-free exact zero-byte test
#   t = ~(((v & 0x7F7F7F7F) + 0x7F7F7F7F) | v | 0x7F7F7F7F)
# (0x80 at each zero byte; no cross-byte carries, unlike the classic
# (v-0x01010101)&~v&0x80808080 which false-positives above a zero byte),
# and a shift-add byte sum. The n_valid tail is
# masked per byte: the last partial word keeps only its low (little-endian)
# valid bytes. This is the device lift of the reference's 1 B/pt class-scan
# showcase (query/src/search/last.rs:253-291).
# ---------------------------------------------------------------------------

_REP = 0x01010101
_LOW7 = 0x7F7F7F7F


def pack_class_words(cls_u8):
    """Host-side zero-copy view: (.., B) u8 -> (.., B//4) int32 words (LE)."""
    import numpy as np

    assert cls_u8.dtype == np.uint8 and cls_u8.shape[-1] % 4 == 0
    return cls_u8.view(np.int32)


def _packed_match_ones(w_u32, rep_u32):
    """uint32 words -> uint32 with 0x01 at each byte equal to the target."""
    v = w_u32 ^ rep_u32
    t = ~(((v & _LOW7) + _LOW7) | v | _LOW7)
    return t >> 7


def _byte_sum(ones_u32):
    """Sum the four 0..1 byte fields -> int32 per word (0..4).

    Shift-add chain in place of the classic `(ones * 0x01010101) >> 24`.
    Byte sums stay < 8 so no cross-byte carries occur."""
    t = ones_u32 + (ones_u32 >> 16)
    t = t + (t >> 8)
    return (t & jnp.uint32(0xFF)).astype(jnp.int32)


def _packed_keep(nv, word_idx):
    """uint32 mask with 0x01 at each byte position < n_valid (LE order)."""
    c = jnp.clip(nv - 4 * word_idx, 0, 4)
    s = ((4 - c) * 4).astype(jnp.uint32)
    return (jnp.uint32(_REP) >> s) >> s  # two <=16-bit shifts: never >= 32


def class_count_packed_jnp(words, class_value, n_valid):
    """words: (W,) int32 = the (4W,) u8 class column viewed little-endian."""
    w = jax.lax.bitcast_convert_type(words, jnp.uint32)
    rep = class_value.astype(jnp.uint32) * jnp.uint32(_REP)
    ones = _packed_match_ones(w, rep)
    widx = jax.lax.iota(jnp.int32, words.shape[0])
    ones &= _packed_keep(jnp.asarray(n_valid, jnp.int32), widx)
    return jnp.sum(_byte_sum(ones), dtype=jnp.int32)


def class_count_packed_jnp_multi(words, targets, nvs):
    """(K, W) int32 words + (K,) targets/valid-counts -> (K,) counts."""
    w = jax.lax.bitcast_convert_type(words, jnp.uint32)
    rep = (targets.astype(jnp.uint32) * jnp.uint32(_REP))[:, None]
    ones = _packed_match_ones(w, rep)
    widx = jax.lax.broadcasted_iota(jnp.int32, words.shape, 1)
    ones &= _packed_keep(nvs.astype(jnp.int32)[:, None], widx)
    return jnp.sum(_byte_sum(ones), axis=1, dtype=jnp.int32)


def bbox_count(x, y, z, lo, hi, n_valid):
    """Count points in the closed int32 box lo <= (x, y, z) <= hi."""
    return _bbox_count_jit(x, y, z, lo, hi, jnp.asarray(n_valid, jnp.int32))


def class_count(cls, class_value, n_valid):
    return _class_count_jit(
        cls, jnp.asarray(class_value, jnp.int32), jnp.asarray(n_valid, jnp.int32)
    )


def bbox_mask(x, y, z, lo, hi, n_valid):
    return _bbox_mask_jit(x, y, z, lo, hi, jnp.asarray(n_valid, jnp.int32))


def class_mask(cls, class_value, n_valid):
    return _class_mask_jit(cls, jnp.asarray(class_value, jnp.int32), jnp.asarray(n_valid, jnp.int32))
