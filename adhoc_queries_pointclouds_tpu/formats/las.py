"""LAS 1.0-1.4 container codec: header parse/write, columnar record access.

This owns what the reference delegates to `pasture-io`/`las-rs` (SURVEY §2.4):
header codec, point-record decode for formats 0-10, and LAS write-back.
Unlike the reference's per-point cursor loops (query/src/search/las.rs:101-146)
we mmap the point-record block and de-interleave whole columns with numpy
strided views — one vectorized pass per attribute, which is the natural host
feeder for the device's SoA block layout.

LAS point record field offsets (LAS specification, formats 0-10):
  all:    x:i32@0  y:i32@4  z:i32@8  intensity:u16@12
  0-5:    flags:u8@14  classification:u8@15  scan_angle:i8@16
          user_data:u8@17  point_source:u16@18
  1,3-5:  gps_time:f64@20
  2:      rgb:3xu16@20      3,5: rgb@28
  6-10:   flags:u16@14 classification:u8@16 user_data:u8@17
          scan_angle:i16@18 point_source:u16@20 gps_time:f64@22
  7,8,10: rgb:3xu16@30      8,10: nir:u16@36
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

from ..utils.aabb import AABB

LAS_SIGNATURE = b"LASF"

# Minimum record length per point format (spec values).
RECORD_LENGTH = {0: 20, 1: 28, 2: 26, 3: 34, 4: 57, 5: 63, 6: 30, 7: 36, 8: 38, 9: 59, 10: 67}

# Byte offset of the RGB triple inside a record, per format
# (same table as reference las.rs:38-45 / last_reader.rs:123-135).
COLOR_OFFSET = {2: 20, 3: 28, 5: 28, 7: 30, 8: 30, 10: 30}

GPS_TIME_OFFSET = {1: 20, 3: 20, 4: 20, 5: 20, 6: 22, 7: 22, 8: 22, 9: 22, 10: 22}


def is_extended_format(fmt: int) -> bool:
    """Formats 6-10 use 2 flag bytes; classification sits at 16 instead of 15
    (reference query/src/search/las.rs:202-212)."""
    return fmt >= 6


def classification_offset(fmt: int) -> int:
    return 16 if is_extended_format(fmt) else 15


def has_color(fmt: int) -> bool:
    return fmt in COLOR_OFFSET


def has_gps_time(fmt: int) -> bool:
    return fmt in GPS_TIME_OFFSET


def has_nir(fmt: int) -> bool:
    return fmt in (8, 10)


def has_waveform(fmt: int) -> bool:
    return fmt in (4, 5, 9, 10)


# byte offset of the 29-byte wave packet inside the record
WAVE_OFFSET = {4: 28, 5: 34, 9: 30, 10: 38}
WAVE_BYTES = 29

# the wave packet's internal layout (LAS 1.3/1.4 spec)
WAVEFORM_DTYPE = np.dtype(
    {
        "names": ["wave_descriptor", "wave_offset", "wave_size",
                  "wave_return_point", "wave_xt", "wave_yt", "wave_zt"],
        "formats": ["u1", "<u8", "<u4", "<f4", "<f4", "<f4", "<f4"],
        "offsets": [0, 1, 9, 13, 17, 21, 25],
        "itemsize": WAVE_BYTES,
    }
)


def parse_waveform(raw: np.ndarray) -> np.ndarray:
    """(n, 29) u8 wave-packet bytes -> structured array of the packet
    fields (descriptor index, external byte offset/size, return-point
    location, parametric dx/dy/dt)."""
    raw = np.ascontiguousarray(np.asarray(raw, np.uint8)).reshape(-1, WAVE_BYTES)
    return np.frombuffer(raw.tobytes(), dtype=WAVEFORM_DTYPE)


@dataclasses.dataclass
class LasHeader:
    """Parsed LAS public header block (the fields this engine uses)."""

    version: tuple[int, int] = (1, 2)
    point_format: int = 0
    point_record_length: int = 20
    point_count: int = 0
    header_size: int = 227
    offset_to_point_data: int = 227
    scale: tuple[float, float, float] = (0.001, 0.001, 0.001)
    offset: tuple[float, float, float] = (0.0, 0.0, 0.0)
    # World-space dataset bounds as stored in the header.
    min: tuple[float, float, float] = (0.0, 0.0, 0.0)
    max: tuple[float, float, float] = (0.0, 0.0, 0.0)
    file_source_id: int = 0
    global_encoding: int = 0
    num_vlrs: int = 0

    @property
    def bounds(self) -> AABB:
        return AABB(self.min, self.max)

    @property
    def extended(self) -> bool:
        return is_extended_format(self.point_format)

    @property
    def has_color(self) -> bool:
        return has_color(self.point_format)


_CORE_HEADER_SIZE = 227
_V13_HEADER_SIZE = 235
_V14_HEADER_SIZE = 375


def parse_las_header_file(path) -> LasHeader:
    """Parse the header straight from a path, closing the file promptly
    (avoids one leaked fd per file during startup header sniffing)."""
    with open(path, "rb") as fh:
        return parse_las_header(fh.read(512))


def parse_las_header(buf: bytes | memoryview) -> LasHeader:
    """Parse the public header block from the first bytes of a LAS-family file.

    Also used verbatim by LAST and LAZER, which reuse the LAS header
    (readers/src/last_reader.rs:73-81, lazer_reader.rs:57-59).
    """
    buf = bytes(buf[:_V14_HEADER_SIZE])
    if len(buf) < _CORE_HEADER_SIZE or buf[:4] != LAS_SIGNATURE:
        raise ValueError("Not a LAS file (missing LASF signature)")

    file_source_id, global_encoding = struct.unpack_from("<HH", buf, 4)
    vmaj, vmin = buf[24], buf[25]
    header_size, offset_to_point_data, num_vlrs = struct.unpack_from("<HII", buf, 94)
    point_format = buf[104]
    # LAZ sets bit 7 of the format byte to mark compression; mask like the
    # reference does (readers/src/last_reader.rs:76-79).
    point_format &= 0x0F
    (point_record_length,) = struct.unpack_from("<H", buf, 105)
    (legacy_count,) = struct.unpack_from("<I", buf, 107)
    sx, sy, sz, ox, oy, oz = struct.unpack_from("<6d", buf, 131)
    max_x, min_x, max_y, min_y, max_z, min_z = struct.unpack_from("<6d", buf, 179)

    point_count = legacy_count
    if (vmaj, vmin) >= (1, 4) and len(buf) >= 255 and header_size >= _V14_HEADER_SIZE:
        (count64,) = struct.unpack_from("<Q", buf, 247)
        if count64:
            point_count = count64

    return LasHeader(
        version=(vmaj, vmin),
        point_format=point_format,
        point_record_length=point_record_length,
        point_count=point_count,
        header_size=header_size,
        offset_to_point_data=offset_to_point_data,
        scale=(sx, sy, sz),
        offset=(ox, oy, oz),
        min=(min_x, min_y, min_z),
        max=(max_x, max_y, max_z),
        file_source_id=file_source_id,
        global_encoding=global_encoding,
        num_vlrs=num_vlrs,
    )


def write_las_header(h: LasHeader) -> bytes:
    """Serialize a public header block (no VLRs)."""
    vmaj, vmin = h.version
    if vmin <= 2:
        size = _CORE_HEADER_SIZE
    elif vmin == 3:
        size = _V13_HEADER_SIZE
    else:
        size = _V14_HEADER_SIZE
    buf = bytearray(size)
    buf[0:4] = LAS_SIGNATURE
    struct.pack_into("<HH", buf, 4, h.file_source_id, h.global_encoding)
    buf[24] = vmaj
    buf[25] = vmin
    sysid = b"adhoc_queries_pointclouds_tpu"[:32]
    soft = b"aqpc-tpu 0.1"[:32]
    buf[26 : 26 + len(sysid)] = sysid
    buf[58 : 58 + len(soft)] = soft
    struct.pack_into("<HH", buf, 90, 1, 2026)  # file creation day/year
    struct.pack_into("<HII", buf, 94, size, max(h.offset_to_point_data, size), 0)
    buf[104] = h.point_format
    struct.pack_into("<H", buf, 105, h.point_record_length)
    legacy = h.point_count if h.point_count < 2**32 and vmin < 4 else (h.point_count if vmin < 4 else 0)
    if vmin >= 4 and h.point_count < 2**32:
        legacy = h.point_count  # keep legacy field populated for old readers
    struct.pack_into("<I", buf, 107, min(legacy, 2**32 - 1))
    struct.pack_into("<6d", buf, 131, *h.scale, *h.offset)
    struct.pack_into(
        "<6d", buf, 179, h.max[0], h.min[0], h.max[1], h.min[1], h.max[2], h.min[2]
    )
    if vmin >= 4:
        struct.pack_into("<Q", buf, 247, h.point_count)
    return bytes(buf)


def record_dtype(fmt: int, record_length: int) -> np.dtype:
    """Structured numpy dtype matching one point record (padding -> itemsize)."""
    fields: list[tuple[str, str]] = [("x", "<i4"), ("y", "<i4"), ("z", "<i4"), ("intensity", "<u2")]
    offsets = [0, 4, 8, 12]
    if is_extended_format(fmt):
        fields += [
            ("flags", "<u2"),
            ("classification", "u1"),
            ("user_data", "u1"),
            ("scan_angle", "<i2"),
            ("point_source", "<u2"),
        ]
        offsets += [14, 16, 17, 18, 20]
    else:
        fields += [
            ("flags", "u1"),
            ("classification", "u1"),
            ("scan_angle", "i1"),
            ("user_data", "u1"),
            ("point_source", "<u2"),
        ]
        offsets += [14, 15, 16, 17, 18]
    if fmt in GPS_TIME_OFFSET:
        fields.append(("gps_time", "<f8"))
        offsets.append(GPS_TIME_OFFSET[fmt])
    if fmt in COLOR_OFFSET:
        co = COLOR_OFFSET[fmt]
        fields += [("red", "<u2"), ("green", "<u2"), ("blue", "<u2")]
        offsets += [co, co + 2, co + 4]
    if has_nir(fmt):
        fields.append(("nir", "<u2"))
        offsets.append(36)
    if has_waveform(fmt):
        fields.append(("waveform", "(29,)u1"))
        offsets.append(WAVE_OFFSET[fmt])
    if record_length > RECORD_LENGTH[fmt]:
        # "extra bytes" past the standard record (LAS extra-bytes VLR
        # payloads etc.) are a first-class opaque column so conversion
        # never drops them
        k = record_length - RECORD_LENGTH[fmt]
        fields.append(("extra", f"({k},)u1"))
        offsets.append(RECORD_LENGTH[fmt])
    return np.dtype(
        {
            "names": [f[0] for f in fields],
            "formats": [f[1] for f in fields],
            "offsets": offsets,
            "itemsize": record_length,
        }
    )


class LasFile:
    """Zero-copy columnar view over an uncompressed .las file.

    Columns come out as numpy arrays; position columns stay raw int32 (the
    integer local coordinate space) — the scale/offset transform is applied
    only to final hits, mirroring the optimized reference path
    (query/src/search/las.rs:137-145).
    """

    extension = "las"

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._mm = np.memmap(self.path, dtype=np.uint8, mode="r")
        self.header = parse_las_header(self._mm[:_V14_HEADER_SIZE].tobytes())
        h = self.header
        self._dtype = record_dtype(h.point_format, h.point_record_length)
        end = h.offset_to_point_data + h.point_count * h.point_record_length
        if end > self._mm.size:
            raise ValueError(
                f"{self.path}: header claims {h.point_count} points "
                f"({end} bytes) but file has {self._mm.size}"
            )
        self._records = np.frombuffer(
            self._mm, dtype=self._dtype, count=h.point_count, offset=h.offset_to_point_data
        )

    @property
    def point_count(self) -> int:
        return self.header.point_count

    @property
    def file_size(self) -> int:
        return int(self._mm.size)

    def column(self, name: str, start: int = 0, stop: int | None = None) -> np.ndarray:
        """Materialize one attribute column for points [start, stop)."""
        stop = self.point_count if stop is None else stop
        if name == "position":
            recs = self._records[start:stop]
            out = np.empty((stop - start, 3), dtype=np.int32)
            out[:, 0] = recs["x"]
            out[:, 1] = recs["y"]
            out[:, 2] = recs["z"]
            return out
        if name == "color":
            if not self.header.has_color:
                return np.zeros((stop - start, 3), dtype=np.uint16)
            recs = self._records[start:stop]
            out = np.empty((stop - start, 3), dtype=np.uint16)
            out[:, 0] = recs["red"]
            out[:, 1] = recs["green"]
            out[:, 2] = recs["blue"]
            return out
        return np.ascontiguousarray(self._records[name][start:stop])

    def positions_world(self, start: int = 0, stop: int | None = None) -> np.ndarray:
        """World-space f64 positions (offset + scale * raw)."""
        raw = self.column("position", start, stop).astype(np.float64)
        return raw * np.asarray(self.header.scale) + np.asarray(self.header.offset)

    def take(self, indices: np.ndarray, attrs: tuple[str, ...]) -> dict[str, np.ndarray]:
        """Random-access gather of attribute rows for hit indices.

        The lazy-hit-fetch analog of the reference's optimized path, which
        reads classification/color bytes only for points that passed the
        bbox test (query/src/search/las.rs:121-135)."""
        recs = self._records[indices]
        out: dict[str, np.ndarray] = {}
        for name in attrs:
            if name == "position":
                pos = np.empty((len(indices), 3), dtype=np.int32)
                pos[:, 0] = recs["x"]
                pos[:, 1] = recs["y"]
                pos[:, 2] = recs["z"]
                out[name] = pos
            elif name == "color":
                col = np.zeros((len(indices), 3), dtype=np.uint16)
                if self.header.has_color:
                    col[:, 0] = recs["red"]
                    col[:, 1] = recs["green"]
                    col[:, 2] = recs["blue"]
                out[name] = col
            else:
                out[name] = np.ascontiguousarray(recs[name])
        return out

    def close(self):
        self._records = None
        self._mm = None


def writeback_header_math(
    pmin: np.ndarray, pmax: np.ndarray
) -> tuple[tuple[float, float, float], tuple[float, float, float]]:
    """The reference's write-back header derivation
    (query/src/dump_points.rs:73-89): offset = min corner, one shared scale =
    next power of ten of max_extent / i32::MAX, clamped to >= 0.001."""
    offset = tuple(float(v) for v in pmin)
    max_extent = float((np.asarray(pmax) - np.asarray(pmin)).max())
    min_scale = max_extent / (2**31 - 1)
    s = 10.0 ** np.ceil(np.log10(min_scale)) if min_scale > 0 else 0.001
    s = max(float(s), 0.001)
    return offset, (s, s, s)


def encode_point_records(
    header: LasHeader,
    positions_world: np.ndarray,
    classification: np.ndarray | None = None,
    color: np.ndarray | None = None,
    intensity: np.ndarray | None = None,
) -> np.ndarray:
    """World-space points -> packed LAS point records for header's format."""
    positions_world = np.asarray(positions_world, dtype=np.float64).reshape(-1, 3)
    n = len(positions_world)
    recs = np.zeros(n, dtype=record_dtype(header.point_format, header.point_record_length))
    local = np.round(
        (positions_world - np.asarray(header.offset)) / np.asarray(header.scale)
    ).astype(np.int64)
    recs["x"] = local[:, 0].astype(np.int32)
    recs["y"] = local[:, 1].astype(np.int32)
    recs["z"] = local[:, 2].astype(np.int32)
    if classification is not None:
        recs["classification"] = np.asarray(classification, dtype=np.uint8)
    if intensity is not None:
        recs["intensity"] = np.asarray(intensity, dtype=np.uint16)
    if color is not None and has_color(header.point_format):
        color = np.asarray(color, dtype=np.uint16).reshape(-1, 3)
        recs["red"] = color[:, 0]
        recs["green"] = color[:, 1]
        recs["blue"] = color[:, 2]
    return recs


def make_writeback_header(
    n: int,
    pmin,
    pmax,
    *,
    point_format: int = 2,
    scale: tuple[float, float, float] | None = None,
    offset: tuple[float, float, float] | None = None,
) -> LasHeader:
    pmin = np.asarray(pmin, np.float64)
    pmax = np.asarray(pmax, np.float64)
    auto_offset, auto_scale = writeback_header_math(pmin, pmax)
    return LasHeader(
        version=(1, 2),
        point_format=point_format,
        point_record_length=RECORD_LENGTH[point_format],
        point_count=n,
        offset_to_point_data=_CORE_HEADER_SIZE,
        scale=scale or auto_scale,
        offset=offset or auto_offset,
        min=tuple(pmin),
        max=tuple(pmax),
    )


def write_las(
    path: str | Path,
    positions_world: np.ndarray,
    classification: np.ndarray | None = None,
    color: np.ndarray | None = None,
    intensity: np.ndarray | None = None,
    *,
    point_format: int = 2,
    scale: tuple[float, float, float] | None = None,
    offset: tuple[float, float, float] | None = None,
) -> LasHeader:
    """Write a LAS 1.2 file from world-space positions plus attributes.

    When scale/offset are not given, uses the reference write-back header
    math (query/src/dump_points.rs:73-89) via writeback_header_math.
    """
    positions_world = np.asarray(positions_world, dtype=np.float64).reshape(-1, 3)
    n = len(positions_world)
    if n == 0:
        raise ValueError("refusing to write empty LAS file")
    pmin = positions_world.min(axis=0)
    pmax = positions_world.max(axis=0)
    header = make_writeback_header(
        n, pmin, pmax, point_format=point_format, scale=scale, offset=offset
    )
    recs = encode_point_records(header, positions_world, classification, color, intensity)
    with open(path, "wb") as f:
        f.write(write_las_header(header))
        f.write(recs.tobytes())
    return header


def write_las_chunked(
    path: str | Path,
    chunks,
    n: int,
    pmin,
    pmax,
    *,
    point_format: int = 2,
) -> LasHeader:
    """Stream a LAS file from an iterator of attribute chunks.

    chunks yields (positions_world, classification, color, intensity)
    tuples; n / pmin / pmax must describe the full point set (the caller
    tracks them while spooling) so the header math matches write_las
    exactly. Peak memory is one chunk — the streaming form of the
    reference's FileDumper (dump_points.rs:73-106), which buffers all hits.
    """
    if n == 0:
        raise ValueError("refusing to write empty LAS file")
    header = make_writeback_header(n, pmin, pmax, point_format=point_format)
    written = 0
    with open(path, "wb") as f:
        f.write(write_las_header(header))
        for pos, cls, col, inten in chunks:
            recs = encode_point_records(header, pos, cls, col, inten)
            f.write(recs.tobytes())
            written += len(recs)
    if written != n:
        raise ValueError(f"write_las_chunked: announced {n} points, wrote {written}")
    return header
