// aqpc_native — host-side native codecs for the point-cloud query engine.
//
// Implements the LZ4 block and frame formats from the public format specs
// (https://github.com/lz4/lz4/blob/dev/doc): the LAZER container stores one
// LZ4 *frame* per attribute per block (reference readers/src/lazer_reader.rs:
// 143-151 uses the Rust `lz4` crate's frame Decoder). Decode is the hot path
// that feeds the device pipeline; a real compressor is included so fixtures and
// the LAS->LAZER converter produce genuinely compressed files.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).
// ctypes calls release the GIL, so Python-level thread pools get true
// multicore decode parallelism.

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <cstdio>
#include <cmath>
#include <limits>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// xxHash32 (needed for LZ4 frame header checksums)
// ---------------------------------------------------------------------------

static const uint32_t PRIME1 = 2654435761U;
static const uint32_t PRIME2 = 2246822519U;
static const uint32_t PRIME3 = 3266489917U;
static const uint32_t PRIME4 = 668265263U;
static const uint32_t PRIME5 = 374761393U;

static inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

static inline uint32_t read_u32le(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // little-endian hosts only (x86/ARM)
}

static inline uint16_t read_u16le(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}

uint32_t aqpc_xxh32(const uint8_t* input, size_t len, uint32_t seed) {
  const uint8_t* p = input;
  const uint8_t* end = input + len;
  uint32_t h;
  if (len >= 16) {
    uint32_t v1 = seed + PRIME1 + PRIME2;
    uint32_t v2 = seed + PRIME2;
    uint32_t v3 = seed;
    uint32_t v4 = seed - PRIME1;
    const uint8_t* limit = end - 16;
    do {
      v1 = rotl32(v1 + read_u32le(p) * PRIME2, 13) * PRIME1; p += 4;
      v2 = rotl32(v2 + read_u32le(p) * PRIME2, 13) * PRIME1; p += 4;
      v3 = rotl32(v3 + read_u32le(p) * PRIME2, 13) * PRIME1; p += 4;
      v4 = rotl32(v4 + read_u32le(p) * PRIME2, 13) * PRIME1; p += 4;
    } while (p <= limit);
    h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
  } else {
    h = seed + PRIME5;
  }
  h += (uint32_t)len;
  while (p + 4 <= end) {
    h = rotl32(h + read_u32le(p) * PRIME3, 17) * PRIME4;
    p += 4;
  }
  while (p < end) {
    h = rotl32(h + (*p) * PRIME5, 11) * PRIME1;
    p++;
  }
  h ^= h >> 15; h *= PRIME2;
  h ^= h >> 13; h *= PRIME3;
  h ^= h >> 16;
  return h;
}

// ---------------------------------------------------------------------------
// LZ4 block format
// ---------------------------------------------------------------------------

// Decompress one raw LZ4 block. Returns bytes written to dst, or -1 on
// malformed input / overflow.
int64_t aqpc_lz4_block_decompress(const uint8_t* src, size_t src_len,
                                  uint8_t* dst, size_t dst_cap) {
  const uint8_t* ip = src;
  const uint8_t* iend = src + src_len;
  uint8_t* op = dst;
  uint8_t* oend = dst + dst_cap;

  while (ip < iend) {
    uint8_t token = *ip++;
    // literals
    size_t lit_len = token >> 4;
    if (lit_len == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit_len += b;
      } while (b == 255);
    }
    if ((size_t)(iend - ip) < lit_len || (size_t)(oend - op) < lit_len) return -1;
    std::memcpy(op, ip, lit_len);
    ip += lit_len;
    op += lit_len;
    if (ip >= iend) break;  // last sequence has no match part

    // match
    if (iend - ip < 2) return -1;
    size_t offset = read_u16le(ip);
    ip += 2;
    if (offset == 0 || offset > (size_t)(op - dst)) return -1;
    size_t match_len = token & 15;
    if (match_len == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        match_len += b;
      } while (b == 255);
    }
    match_len += 4;
    if ((size_t)(oend - op) < match_len) return -1;
    const uint8_t* match = op - offset;
    if (offset >= match_len && offset >= 8) {
      std::memcpy(op, match, match_len);
      op += match_len;
    } else {
      // overlapping copy must be byte-wise
      for (size_t i = 0; i < match_len; i++) op[i] = match[i];
      op += match_len;
    }
  }
  return (int64_t)(op - dst);
}

// Worst-case compressed size for n input bytes.
size_t aqpc_lz4_compress_bound(size_t n) { return n + n / 255 + 16; }

// Greedy single-pass LZ4 block compressor with a 4-byte hash table.
// Returns compressed size, or -1 if dst is too small.
int64_t aqpc_lz4_block_compress(const uint8_t* src, size_t src_len,
                                uint8_t* dst, size_t dst_cap) {
  const size_t HASH_LOG = 16;
  const size_t HASH_SIZE = 1 << HASH_LOG;
  const size_t MFLIMIT = 12;    // last 12 bytes must be literals (spec)
  const size_t MINMATCH = 4;
  const size_t MAX_OFFSET = 65535;

  uint32_t table[HASH_SIZE];
  std::memset(table, 0xFF, sizeof(table));  // 0xFFFFFFFF = empty

  const uint8_t* ip = src;
  const uint8_t* anchor = src;
  const uint8_t* iend = src + src_len;
  const uint8_t* mflimit = (src_len > MFLIMIT) ? iend - MFLIMIT : src;
  uint8_t* op = dst;
  uint8_t* oend = dst + dst_cap;

  auto hash = [](uint32_t v) -> uint32_t {
    return (v * 2654435761U) >> (32 - HASH_LOG);
  };
  auto write_length = [&](size_t len) -> bool {
    while (len >= 255) {
      if (op >= oend) return false;
      *op++ = 255;
      len -= 255;
    }
    if (op >= oend) return false;
    *op++ = (uint8_t)len;
    return true;
  };

  if (src_len > MFLIMIT) {
    while (ip < mflimit) {
      uint32_t seq = read_u32le(ip);
      uint32_t h = hash(seq);
      uint32_t cand = table[h];
      table[h] = (uint32_t)(ip - src);
      if (cand != 0xFFFFFFFFu && (size_t)(ip - src) - cand <= MAX_OFFSET &&
          read_u32le(src + cand) == seq) {
        const uint8_t* match = src + cand;
        // extend match forward
        const uint8_t* mp = match + MINMATCH;
        const uint8_t* cp = ip + MINMATCH;
        const uint8_t* climit = iend - 5;  // keep last 5 bytes literal-only
        while (cp < climit && *cp == *mp) { cp++; mp++; }
        size_t match_len = (size_t)(cp - ip) - MINMATCH;
        size_t lit_len = (size_t)(ip - anchor);

        // token
        if (op >= oend) return -1;
        uint8_t* token = op++;
        *token = 0;
        if (lit_len >= 15) {
          *token = 15 << 4;
          if (!write_length(lit_len - 15)) return -1;
        } else {
          *token = (uint8_t)(lit_len << 4);
        }
        if ((size_t)(oend - op) < lit_len + 2) return -1;
        std::memcpy(op, anchor, lit_len);
        op += lit_len;
        uint16_t off = (uint16_t)(ip - match);
        std::memcpy(op, &off, 2);
        op += 2;
        if (match_len >= 15) {
          *token |= 15;
          if (!write_length(match_len - 15)) return -1;
        } else {
          *token |= (uint8_t)match_len;
        }
        ip = cp;
        anchor = ip;
        // refresh hash at ip-2 for denser matching
        if (ip < mflimit) {
          table[hash(read_u32le(ip - 2))] = (uint32_t)(ip - 2 - src);
        }
      } else {
        ip++;
      }
    }
  }

  // trailing literals
  size_t lit_len = (size_t)(iend - anchor);
  if (op >= oend) return -1;
  uint8_t* token = op++;
  if (lit_len >= 15) {
    *token = 15 << 4;
    if (!write_length(lit_len - 15)) return -1;
  } else {
    *token = (uint8_t)(lit_len << 4);
  }
  if ((size_t)(oend - op) < lit_len) return -1;
  std::memcpy(op, anchor, lit_len);
  op += lit_len;
  return (int64_t)(op - dst);
}

// ---------------------------------------------------------------------------
// LZ4 frame format
// ---------------------------------------------------------------------------

static const uint32_t LZ4F_MAGIC = 0x184D2204U;

// Decode a whole LZ4 frame starting at src. Writes decompressed payload to
// dst. Returns bytes written; stores bytes consumed from src in *consumed.
// Returns -1 on malformed input, -2 if dst_cap is too small.
int64_t aqpc_lz4_frame_decompress(const uint8_t* src, size_t src_len,
                                  uint8_t* dst, size_t dst_cap,
                                  size_t* consumed) {
  const uint8_t* ip = src;
  const uint8_t* iend = src + src_len;
  if (src_len < 7 || read_u32le(ip) != LZ4F_MAGIC) return -1;
  ip += 4;
  uint8_t flg = *ip++;
  ip++;  // BD byte (block max size) — we size from caller's dst_cap
  int version = (flg >> 6) & 3;
  if (version != 1) return -1;
  bool block_checksum = (flg >> 4) & 1;
  bool content_size = (flg >> 3) & 1;
  bool content_checksum = (flg >> 2) & 1;
  bool dict_id = flg & 1;
  if (content_size) {
    if (iend - ip < 8) return -1;
    ip += 8;
  }
  if (dict_id) {
    if (iend - ip < 4) return -1;
    ip += 4;
  }
  if (ip >= iend) return -1;
  ip++;  // header checksum byte (not verified on decode)

  uint8_t* op = dst;
  uint8_t* oend = dst + dst_cap;
  while (true) {
    if (iend - ip < 4) return -1;
    uint32_t bsize = read_u32le(ip);
    ip += 4;
    if (bsize == 0) break;  // EndMark
    bool uncompressed = (bsize >> 31) != 0;
    bsize &= 0x7FFFFFFFu;
    if ((size_t)(iend - ip) < bsize) return -1;
    if (uncompressed) {
      if ((size_t)(oend - op) < bsize) return -2;
      std::memcpy(op, ip, bsize);
      op += bsize;
    } else {
      int64_t n = aqpc_lz4_block_decompress(ip, bsize, op, (size_t)(oend - op));
      if (n < 0) return (n == -1 && (size_t)(oend - op) < (size_t)4 * bsize) ? -2 : -1;
      op += n;
    }
    ip += bsize;
    if (block_checksum) {
      if (iend - ip < 4) return -1;
      ip += 4;
    }
  }
  if (content_checksum) {
    if (iend - ip < 4) return -1;
    ip += 4;
  }
  if (consumed) *consumed = (size_t)(ip - src);
  return (int64_t)(op - dst);
}

// Compress src into a standalone LZ4 frame (block-independent, 4 MiB max
// block size, content size recorded). Returns frame size or -1 on overflow.
int64_t aqpc_lz4_frame_compress(const uint8_t* src, size_t src_len,
                                uint8_t* dst, size_t dst_cap) {
  const size_t BLOCK = 4 * 1024 * 1024;
  uint8_t* op = dst;
  uint8_t* oend = dst + dst_cap;
  if ((size_t)(oend - op) < 15) return -1;
  uint32_t magic = LZ4F_MAGIC;
  std::memcpy(op, &magic, 4);
  op += 4;
  uint8_t* desc = op;
  uint8_t flg = (1 << 6) | (1 << 5) | (1 << 3);  // v1, block-independent, content size
  uint8_t bd = 7 << 4;                            // 4 MiB max block size
  *op++ = flg;
  *op++ = bd;
  uint64_t cs = src_len;
  std::memcpy(op, &cs, 8);
  op += 8;
  *op++ = (uint8_t)(aqpc_xxh32(desc, (size_t)(op - desc), 0) >> 8);

  size_t pos = 0;
  while (pos < src_len) {
    size_t chunk = src_len - pos < BLOCK ? src_len - pos : BLOCK;
    if ((size_t)(oend - op) < 4) return -1;
    uint8_t* size_slot = op;
    op += 4;
    int64_t csize = aqpc_lz4_block_compress(src + pos, chunk, op,
                                            (size_t)(oend - op));
    if (csize < 0 || (size_t)csize >= chunk) {
      // incompressible: store raw
      if ((size_t)(oend - op) < chunk) return -1;
      std::memcpy(op, src + pos, chunk);
      uint32_t stored = (uint32_t)chunk | 0x80000000u;
      std::memcpy(size_slot, &stored, 4);
      op += chunk;
    } else {
      uint32_t stored = (uint32_t)csize;
      std::memcpy(size_slot, &stored, 4);
      op += csize;
    }
    pos += chunk;
  }
  if ((size_t)(oend - op) < 4) return -1;
  std::memset(op, 0, 4);  // EndMark
  op += 4;
  return (int64_t)(op - dst);
}

// ---------------------------------------------------------------------------
// Batched helpers for the LAZER pipeline: decompress many independent frames
// (one per attribute-blob) in one call. Offsets/capacities are caller-provided
// arrays; returns 0 on success, index+1 of the first failing frame otherwise.
// ---------------------------------------------------------------------------

int64_t aqpc_lz4_frames_decompress(const uint8_t* src,
                                   const uint64_t* frame_offsets,
                                   const uint64_t* frame_sizes,
                                   int64_t n_frames,
                                   uint8_t* dst,
                                   const uint64_t* dst_offsets,
                                   const uint64_t* dst_caps,
                                   int64_t* out_sizes) {
  for (int64_t i = 0; i < n_frames; i++) {
    size_t consumed = 0;
    int64_t n = aqpc_lz4_frame_decompress(src + frame_offsets[i], frame_sizes[i],
                                          dst + dst_offsets[i], dst_caps[i],
                                          &consumed);
    if (n < 0) return i + 1;
    out_sizes[i] = n;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Batched --print-points line formatter. The reference's StdOutCollector
// formats one point per loop iteration (query/src/collect_points.rs:46-70);
// Python per-point f-strings cap at ~0.5 Mpts/s, so the streaming sink hands
// whole hit chunks here. snprintf's %.3f is correctly rounded (exact decimal
// ties at 3 digits are impossible for binary doubles), so bytes match
// Python's f"{v:.3f}" exactly. Returns total bytes needed; caller re-calls
// with a bigger buffer if that exceeds cap (lines beyond cap are skipped,
// never truncated mid-line).
// ---------------------------------------------------------------------------

static inline char* fmt_u64(char* p, uint64_t v) {
  char tmp[20];
  int i = 0;
  do { tmp[i++] = (char)('0' + v % 10); v /= 10; } while (v);
  while (i) *p++ = tmp[--i];
  return p;
}

// %.3f by integer math, provably equal to correctly-rounded snprintf:
// scaled = |v|*1000 carries <= 0.5 ulp error (~1.11e-16 * scaled); if the
// fractional part is farther than 2.3e-16*scaled from the 0.5 boundary the
// rounding direction of the exact product is determined (exact decimal ties
// at 3 digits are impossible for binary doubles), else -1 -> snprintf
// fallback. scaled < 9e15 < 2^53 keeps floor/subtract exact.
static inline int fmt_f3(char* p, double v) {
  double mag = std::fabs(v);
  if (!(mag < 9.0e12)) return -1;  // huge / inf / nan -> snprintf
  double scaled = mag * 1000.0;
  double fl = std::floor(scaled);
  double frac = scaled - fl;
  if (std::fabs(frac - 0.5) <= 2.3e-16 * scaled + 1e-300) return -1;
  uint64_t q = (uint64_t)fl + (frac > 0.5 ? 1 : 0);
  char* s = p;
  if (std::signbit(v)) *s++ = '-';
  s = fmt_u64(s, q / 1000);
  uint64_t fp = q % 1000;
  *s++ = '.';
  *s++ = (char)('0' + fp / 100);
  *s++ = (char)('0' + fp / 10 % 10);
  *s++ = (char)('0' + fp % 10);
  return (int)(s - p);
}

int64_t aqpc_format_points(const double* pos,       // (n, 3) world xyz
                           const uint16_t* rgb,     // (n, 3)
                           const uint8_t* cls,      // (n,)
                           const uint16_t* intensity,  // (n,)
                           int64_t n, char* out, int64_t cap) {
  int64_t total = 0;
  char line[512];
  for (int64_t i = 0; i < n; i++) {
    char* s = line;
    std::memcpy(s, "Found point: (", 14); s += 14;
    int ok = 1;
    for (int a = 0; a < 3 && ok; a++) {
      int w = fmt_f3(s, pos[i * 3 + a]);
      if (w < 0) { ok = 0; break; }
      s += w;
      if (a < 2) { *s++ = ','; *s++ = ' '; }
    }
    // Python's f"{v:.3f}" prints "nan" for BOTH nan signs; glibc %.3f
    // prints "-nan" for a sign-bit nan — normalize so the byte-identity
    // contract with the Python fallback holds even for garbage inputs.
    double px = pos[i * 3], py = pos[i * 3 + 1], pz = pos[i * 3 + 2];
    if (px != px) px = std::numeric_limits<double>::quiet_NaN();
    if (py != py) py = std::numeric_limits<double>::quiet_NaN();
    if (pz != pz) pz = std::numeric_limits<double>::quiet_NaN();
    int len;
    if (ok) {
      std::memcpy(s, ") class=", 8); s += 8;
      s = fmt_u64(s, cls[i]);
      std::memcpy(s, " rgb=(", 6); s += 6;
      s = fmt_u64(s, rgb[i * 3]); *s++ = ','; *s++ = ' ';
      s = fmt_u64(s, rgb[i * 3 + 1]); *s++ = ','; *s++ = ' ';
      s = fmt_u64(s, rgb[i * 3 + 2]);
      std::memcpy(s, ") intensity=", 12); s += 12;
      s = fmt_u64(s, intensity[i]);
      *s++ = '\n';
      len = (int)(s - line);
    } else {
      len = snprintf(line, sizeof(line),
                     "Found point: (%.3f, %.3f, %.3f) class=%u rgb=(%u, %u, %u) "
                     "intensity=%u\n",
                     px, py, pz,
                     (unsigned)cls[i], (unsigned)rgb[i * 3],
                     (unsigned)rgb[i * 3 + 1], (unsigned)rgb[i * 3 + 2],
                     (unsigned)intensity[i]);
      if (len < 0) return -1;
      if (len >= (int)sizeof(line)) {
        // absurd coordinate magnitude: heap-format this one line
        std::vector<char> big((size_t)len + 1);
        snprintf(big.data(), big.size(),
                 "Found point: (%.3f, %.3f, %.3f) class=%u rgb=(%u, %u, %u) "
                 "intensity=%u\n",
                 px, py, pz, (unsigned)cls[i],
                 (unsigned)rgb[i * 3], (unsigned)rgb[i * 3 + 1],
                 (unsigned)rgb[i * 3 + 2], (unsigned)intensity[i]);
        if (total + len <= cap) std::memcpy(out + total, big.data(), (size_t)len);
        total += len;
        continue;
      }
    }
    if (total + len <= cap) std::memcpy(out + total, line, (size_t)len);
    total += len;
  }
  return total;
}

// Bit-planar packed coordinate transport (ops/predicate.py): one pass over
// the int32 column emits k//8 byte planes (at p*B) plus k%8 bit planes
// (little bit order, at nbytes*B + q*(B/8)) of the residual (col - base).
// k == 32 with base == 0 ships raw two's-complement bytes; base != 0 at
// k == 32 (a narrow block stacked into a 32-bit step) wraps mod 2^32,
// matching ops/predicate.residual_u32. Replaces ~k/4
// strided numpy passes on the single-core host.
void aqpc_pack_bits(const int32_t* col, int64_t n, int64_t base, int k,
                    uint8_t* out, int64_t block_size) {
  const int nbytes = k / 8;
  const int nbits = k % 8;
  const int64_t bb = block_size / 8;
  uint8_t* const bit_base = out + (int64_t)nbytes * block_size;
  for (int64_t i0 = 0; i0 < n; i0 += 8) {
    uint8_t acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    const int m = (int)((n - i0 < 8) ? (n - i0) : 8);
    for (int j = 0; j < m; j++) {
      const uint32_t r = (uint32_t)((int64_t)col[i0 + j] - base);
      for (int p = 0; p < nbytes; p++)
        out[(int64_t)p * block_size + i0 + j] = (uint8_t)(r >> (8 * p));
      for (int q = 0; q < nbits; q++)
        acc[q] |= (uint8_t)(((r >> (8 * nbytes + q)) & 1u) << j);
    }
    for (int q = 0; q < nbits; q++) bit_base[(int64_t)q * bb + i0 / 8] = acc[q];
  }
}

// Dictionary-encode one u8 classification column (ops/predicate.py
// class_dict_encode): codes[i] = rank of cls[i] among the distinct values
// present; present_out (capacity 256) receives those values sorted
// ascending. Returns the dictionary size. Two sequential u8 passes at
// memory speed — replaces numpy bincount + flatnonzero + LUT gather +
// astype(int32) (~10 B/pt of host traffic) on the single-core host.
int aqpc_dict_encode_u8(const uint8_t* cls, int64_t n, uint8_t* codes,
                        uint8_t* present_out) {
  uint8_t seen[256];
  std::memset(seen, 0, sizeof(seen));
  for (int64_t i = 0; i < n; i++) seen[cls[i]] = 1;
  uint8_t lut[256];
  std::memset(lut, 0, sizeof(lut));
  int n_present = 0;
  for (int v = 0; v < 256; v++) {
    if (seen[v]) {
      present_out[n_present] = (uint8_t)v;
      lut[v] = (uint8_t)n_present;
      n_present++;
    }
  }
  for (int64_t i = 0; i < n; i++) codes[i] = lut[cls[i]];
  return n_present;
}

// u8-input variant of aqpc_pack_bits for dictionary codes (base always 0,
// k <= 8): k == 8 is a straight byte-plane copy; otherwise k little-order
// bit planes at q*(block_size/8), identical layout to aqpc_pack_bits with
// nbytes == 0. Keeps the class transport chain u8 end-to-end (no int32
// widening pass).
void aqpc_pack_bits_u8(const uint8_t* col, int64_t n, int k, uint8_t* out,
                       int64_t block_size) {
  if (k >= 8) {
    std::memcpy(out, col, (size_t)n);
    return;
  }
  const int64_t bb = block_size / 8;
  for (int64_t i0 = 0; i0 < n; i0 += 8) {
    uint8_t acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    const int m = (int)((n - i0 < 8) ? (n - i0) : 8);
    for (int j = 0; j < m; j++) {
      const uint8_t r = col[i0 + j];
      for (int q = 0; q < k; q++) acc[q] |= (uint8_t)(((r >> q) & 1u) << j);
    }
    for (int q = 0; q < k; q++) out[(int64_t)q * bb + i0 / 8] = acc[q];
  }
}

// ---------------------------------------------------------------------------
// Density host-resolution hot path (ops/density.py). The engine's exact f64
// winner resolution replicates the reference SparseGrid semantics
// (query/src/grid_sampling.rs:49-105); at paper scale (13M winner cells) the
// numpy version spends its time in ~20 vector passes per block plus 4-key
// lexsorts per merge, all on one host core. These three functions collapse
// that to: one fused pass for exact key+d2, one linear pass for per-key
// winner selection over key-sorted rows, and one linear two-pointer merge.
// Compiled with -ffp-contract=off: every f64 operation below must round
// exactly like the separate numpy ops (and the reference's Rust, which does
// not contract) — a fused multiply-add would change winners on ties.

// Exact reference cell key + f64 squared distance to the unmasked cell
// center, straight from raw int32 local coords (grid_sampling.rs:51-83):
//   w    = (f64)raw * scale + offset
//   r    = (w - bmin) * dims / ext          (NaN -> 0, <0 -> 0,
//                                            >= 2^64 -> u64::MAX, else trunc)
//   key  = (cx & mx) | ((cy & my) << xb) | ((cz & mz) << xyb)
//   c    = ((f64)cell + 0.5) * cell_size + bmin   (center of UNMASKED cell)
//   d2   = sum (w - c)^2                      (x, y, z order)
void aqpc_density_exact(
    int64_t n, const int32_t* xi, const int32_t* yi, const int32_t* zi,
    const double* scale3, const double* offset3, const double* bmin3,
    const double* ext3, const double* dimsf3, double cell_size,
    const uint64_t* masks3, int32_t xbits, int32_t xybits,
    uint64_t* out_key, double* out_d2) {
  const double TWO64 = 18446744073709551616.0;  // 2^64
  for (int64_t i = 0; i < n; i++) {
    const int32_t raw[3] = {xi[i], yi[i], zi[i]};
    uint64_t cell[3];
    double w[3];
    double d2 = 0.0;
    for (int ax = 0; ax < 3; ax++) {
      const double wv = (double)raw[ax] * scale3[ax] + offset3[ax];
      w[ax] = wv;
      double r = (wv - bmin3[ax]) * dimsf3[ax] / ext3[ax];
      uint64_t c;
      if (!(r >= 0.0)) {  // NaN or negative -> cell 0 (`as u64` saturation)
        c = 0;
      } else if (r >= TWO64) {
        c = 0xFFFFFFFFFFFFFFFFull;
      } else {
        c = (uint64_t)r;
      }
      cell[ax] = c;
      const double center = ((double)c + 0.5) * cell_size + bmin3[ax];
      const double d = wv - center;
      d2 += d * d;
    }
    (void)w;
    out_key[i] = (cell[0] & masks3[0]) | ((cell[1] & masks3[1]) << xbits) |
                 ((cell[2] & masks3[2]) << xybits);
    out_d2[i] = d2;
  }
}

// Winner comparison: strictly better = smaller (d2, seq, gidx) lexicographic
// — the reference's "first inserted wins ties" rule (grid_sampling.rs:97)
// with insertion order encoded as (file sequence, global point index). NaN
// d2 ranks last (numpy lexsort puts NaNs at the end).
static inline bool winner_better(double d2a, int32_t sa, int64_t ga,
                                 double d2b, int32_t sb, int64_t gb) {
  if (d2a != d2a) return false;            // a is NaN: never better
  if (d2b != d2b) return true;             // b is NaN, a isn't
  if (d2a != d2b) return d2a < d2b;
  if (sa != sb) return sa < sb;
  return ga < gb;
}

// Per-key winner selection over rows visited in ascending-key order via a
// precomputed permutation (np.argsort(key, kind="stable")). Emits the
// ORIGINAL index of each unique key's winner, in ascending key order.
// Returns the number of unique keys.
int64_t aqpc_winner_dedupe(
    int64_t n, const int64_t* order, const uint64_t* key, const double* d2,
    const int32_t* seq, const int64_t* gidx, int64_t* out_idx) {
  int64_t m = 0;
  uint64_t cur_key = 0;
  int64_t cur = -1;
  for (int64_t i = 0; i < n; i++) {
    const int64_t j = order[i];
    const uint64_t k = key[j];
    if (cur < 0 || k != cur_key) {
      out_idx[m++] = j;
      cur = j;
      cur_key = k;
    } else if (winner_better(d2[j], seq[j], gidx[j],
                             d2[cur], seq[cur], gidx[cur])) {
      out_idx[m - 1] = j;
      cur = j;
    }
  }
  return m;
}

// Linear merge of two winner sets, each unique-key ascending (the output of
// aqpc_winner_dedupe / a previous merge). Output arrays must hold na + nb
// rows; returns the merged unique-key count.
int64_t aqpc_winner_merge(
    int64_t na, const uint64_t* ka, const double* da, const int32_t* sa,
    const int64_t* ga, const int32_t* fa,
    int64_t nb, const uint64_t* kb, const double* db, const int32_t* sb,
    const int64_t* gb, const int32_t* fb,
    uint64_t* ko, double* d2o, int32_t* so, int64_t* go, int32_t* fo) {
  int64_t i = 0, j = 0, m = 0;
  while (i < na && j < nb) {
    if (ka[i] < kb[j]) {
      ko[m] = ka[i]; d2o[m] = da[i]; so[m] = sa[i]; go[m] = ga[i]; fo[m] = fa[i];
      i++;
    } else if (kb[j] < ka[i]) {
      ko[m] = kb[j]; d2o[m] = db[j]; so[m] = sb[j]; go[m] = gb[j]; fo[m] = fb[j];
      j++;
    } else {
      if (winner_better(db[j], sb[j], gb[j], da[i], sa[i], ga[i])) {
        ko[m] = kb[j]; d2o[m] = db[j]; so[m] = sb[j]; go[m] = gb[j]; fo[m] = fb[j];
      } else {
        ko[m] = ka[i]; d2o[m] = da[i]; so[m] = sa[i]; go[m] = ga[i]; fo[m] = fa[i];
      }
      i++; j++;
    }
    m++;
  }
  for (; i < na; i++, m++) {
    ko[m] = ka[i]; d2o[m] = da[i]; so[m] = sa[i]; go[m] = ga[i]; fo[m] = fa[i];
  }
  for (; j < nb; j++, m++) {
    ko[m] = kb[j]; d2o[m] = db[j]; so[m] = sb[j]; go[m] = gb[j]; fo[m] = fb[j];
  }
  return m;
}

}  // extern "C"
