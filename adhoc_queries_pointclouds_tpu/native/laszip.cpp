// laszip.cpp — LASzip v2 codec (LAZ read/write) for the point-cloud query engine.
//
// Implemented from the published LASzip format description (Isenburg,
// "LASzip: lossless compression of LiDAR data", PE&RS 2013) and the open
// LAZ specification: an adaptive arithmetic coder (Amir Said's FastAC
// scheme), k-bit integer residual compression, and the v2 record items
// POINT10 / GPSTIME11 / RGB12 / BYTE in a chunked container.
//
// The reference engine gets LAZ decode from the laz-rs crate inside pasture
// (query/src/search/laz.rs:27-31: no byte-level shortcut exists on LAZ;
// every query fully decompresses). Here decode produces SoA columns
// directly (the device block layout) and decodes CHUNKS IN PARALLEL across
// host threads — chunks are independent coder streams, which the reference
// never exploits.
//
// Interop note: self-roundtrip (our writer -> our reader) is exact and
// tested; decoding third-party LAZ files is spec-faithful best effort.
//
// Attribution: the LASzip bitstream format — the arithmetic-coder constants,
// context model names and sizes (e.g. m_changed_values, ic_dx(32,2)/
// ic_dy(32,22)/ic_z(32,20), number_return_map/level, StreamingMedian5) —
// was designed by Martin Isenburg and is specified by the open-source
// LASzip library (https://github.com/LASzip/LASzip, Apache License 2.0).
// Those model sizes and context rules ARE the bitstream format: any
// conforming codec must reproduce them. This file is an independent
// implementation written for SoA/columnar output and thread-parallel chunk
// decode, but its algorithmic structure necessarily follows the LASzip
// specification and credit belongs to its authors.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {

typedef uint8_t U8;
typedef uint16_t U16;
typedef uint32_t U32;
typedef uint64_t U64;
typedef int8_t I8;
typedef int16_t I16;
typedef int32_t I32;
typedef int64_t I64;

static const U32 AC_MaxLength = 0xFFFFFFFFu;
static const U32 AC_MinLength = 0x01000000u;
static const U32 DM_LengthShift = 15;
static const U32 DM_MaxCount = 1u << DM_LengthShift;
static const U32 BM_LengthShift = 13;
static const U32 BM_MaxCount = 1u << BM_LengthShift;

// ---------------------------------------------------------------------------
// adaptive symbol model
// ---------------------------------------------------------------------------

struct SymbolModel {
  std::vector<U32> distribution;
  std::vector<U32> symbol_count;
  std::vector<U32> decoder_table;
  U32 symbols = 0, last_symbol = 0, table_size = 0, table_shift = 0;
  U32 total_count = 0, update_cycle = 0, symbols_until_update = 0;
  bool compress = false;

  void init(U32 n, bool for_compress) {
    symbols = n;
    last_symbol = n - 1;
    compress = for_compress;
    if (!for_compress && n > 16) {
      U32 table_bits = 3;
      while (n > (1u << (table_bits + 2))) table_bits++;
      table_size = 1u << table_bits;
      table_shift = DM_LengthShift - table_bits;
      decoder_table.assign(table_size + 2, 0);
    } else {
      table_size = table_shift = 0;
      decoder_table.clear();
    }
    distribution.assign(n, 0);
    symbol_count.assign(n, 1);
    total_count = 0;
    update_cycle = n;
    update();
    symbols_until_update = update_cycle = (n + 6) >> 1;
  }

  void update() {
    if ((total_count += update_cycle) > DM_MaxCount) {
      total_count = 0;
      for (U32 k = 0; k < symbols; k++)
        total_count += (symbol_count[k] = (symbol_count[k] + 1) >> 1);
    }
    U32 sum = 0, s = 0;
    U32 scale = 0x80000000u / total_count;
    if (compress || (table_size == 0)) {
      for (U32 k = 0; k < symbols; k++) {
        distribution[k] = (scale * sum) >> (31 - DM_LengthShift);
        sum += symbol_count[k];
      }
    } else {
      for (U32 k = 0; k < symbols; k++) {
        distribution[k] = (scale * sum) >> (31 - DM_LengthShift);
        sum += symbol_count[k];
        U32 w = distribution[k] >> table_shift;
        while (s < w) decoder_table[++s] = k - 1;
      }
      decoder_table[0] = 0;
      while (s <= table_size) decoder_table[++s] = symbols - 1;
    }
    update_cycle = (5 * update_cycle) >> 2;
    U32 max_cycle = (symbols + 6) << 3;
    if (update_cycle > max_cycle) update_cycle = max_cycle;
    symbols_until_update = update_cycle;
  }
};

struct BitModel {
  U32 bit_0_prob = 0, bit_0_count = 0, bit_count = 0;
  U32 update_cycle = 0, bits_until_update = 0;

  void init() {
    bit_0_count = 1;
    bit_count = 2;
    bit_0_prob = 1u << (BM_LengthShift - 1);
    update_cycle = bits_until_update = 4;
  }

  void update() {
    if ((bit_count += update_cycle) > BM_MaxCount) {
      bit_count = (bit_count + 1) >> 1;
      bit_0_count = (bit_0_count + 1) >> 1;
      if (bit_0_count == bit_count) ++bit_count;
    }
    bit_0_prob = (bit_0_count << BM_LengthShift) / bit_count;
    update_cycle = (5 * update_cycle) >> 2;
    if (update_cycle > 64) update_cycle = 64;
    bits_until_update = update_cycle;
  }
};

// ---------------------------------------------------------------------------
// arithmetic decoder / encoder (FastAC scheme)
// ---------------------------------------------------------------------------

struct Decoder {
  const U8* buf = nullptr;
  size_t pos = 0, end = 0;
  U32 value = 0, length = 0;

  U8 inbyte() { return pos < end ? buf[pos++] : 0; }

  void init(const U8* b, size_t n) {
    buf = b;
    pos = 0;
    end = n;
    length = AC_MaxLength;
    value = ((U32)inbyte() << 24) | ((U32)inbyte() << 16) | ((U32)inbyte() << 8) |
            (U32)inbyte();
  }

  void renorm() {
    do {
      value = (value << 8) | inbyte();
    } while ((length <<= 8) < AC_MinLength);
  }

  U32 decodeSymbol(SymbolModel& m) {
    U32 n, sym, x, y = length;
    if (!m.decoder_table.empty()) {
      U32 dv = value / (length >>= DM_LengthShift);
      U32 t = dv >> m.table_shift;
      sym = m.decoder_table[t];
      n = m.decoder_table[t + 1] + 1;
      while (n > sym + 1) {
        U32 k = (sym + n) >> 1;
        if (m.distribution[k] > dv) n = k; else sym = k;
      }
      x = m.distribution[sym] * length;
      if (sym != m.last_symbol) y = m.distribution[sym + 1] * length;
    } else {
      x = sym = 0;
      length >>= DM_LengthShift;
      U32 k = (n = m.symbols) >> 1;
      do {
        U32 z = length * m.distribution[k];
        if (z > value) { n = k; y = z; } else { sym = k; x = z; }
      } while ((k = (sym + n) >> 1) != sym);
    }
    value -= x;
    length = y - x;
    if (length < AC_MinLength) renorm();
    ++m.symbol_count[sym];
    if (--m.symbols_until_update == 0) m.update();
    return sym;
  }

  U32 decodeBit(BitModel& m) {
    U32 x = m.bit_0_prob * (length >> BM_LengthShift);
    U32 sym = (value >= x);
    if (sym == 0) { length = x; ++m.bit_0_count; }
    else { value -= x; length -= x; }
    if (length < AC_MinLength) renorm();
    if (--m.bits_until_update == 0) m.update();
    return sym;
  }

  U32 readBits(U32 bits) {
    if (bits > 19) {
      U32 lo = readShort();
      U32 hi = readBits(bits - 16) << 16;
      return hi | lo;
    }
    U32 sym = value / (length >>= bits);
    value -= length * sym;
    if (length < AC_MinLength) renorm();
    return sym;
  }

  U32 readShort() {
    U32 sym = value / (length >>= 16);
    value -= length * sym;
    if (length < AC_MinLength) renorm();
    return sym;
  }

  U32 readInt() {
    U32 lo = readShort();
    U32 hi = readShort();
    return (hi << 16) | lo;
  }
};

struct Encoder {
  std::vector<U8> out;
  U32 base = 0, length = AC_MaxLength;

  void init() {
    out.clear();
    base = 0;
    length = AC_MaxLength;
  }

  void propagate_carry() {
    // add 1 to the last non-0xFF byte already emitted
    size_t p = out.size();
    while (p > 0 && out[p - 1] == 0xFF) out[--p] = 0;
    if (p > 0) out[p - 1]++;
  }

  void renorm() {
    do {
      out.push_back((U8)(base >> 24));
      base <<= 8;
    } while ((length <<= 8) < AC_MinLength);
  }

  void encodeSymbol(SymbolModel& m, U32 sym) {
    U32 x, init_base = base;
    if (sym == m.last_symbol) {
      x = m.distribution[sym] * (length >> DM_LengthShift);
      base += x;
      length -= x;
    } else {
      x = m.distribution[sym] * (length >>= DM_LengthShift);
      base += x;
      length = m.distribution[sym + 1] * length - x;
    }
    if (init_base > base) propagate_carry();
    if (length < AC_MinLength) renorm();
    ++m.symbol_count[sym];
    if (--m.symbols_until_update == 0) m.update();
  }

  void encodeBit(BitModel& m, U32 sym) {
    U32 x = m.bit_0_prob * (length >> BM_LengthShift);
    if (sym == 0) {
      length = x;
      ++m.bit_0_count;
    } else {
      U32 init_base = base;
      base += x;
      length -= x;
      if (init_base > base) propagate_carry();
    }
    if (length < AC_MinLength) renorm();
    if (--m.bits_until_update == 0) m.update();
  }

  void writeBits(U32 bits, U32 sym) {
    if (bits > 19) {
      writeShort(sym & 0xFFFF);
      writeBits(bits - 16, sym >> 16);
      return;
    }
    U32 init_base = base;
    base += sym * (length >>= bits);
    if (init_base > base) propagate_carry();
    if (length < AC_MinLength) renorm();
  }

  void writeShort(U32 sym) {
    U32 init_base = base;
    base += sym * (length >>= 16);
    if (init_base > base) propagate_carry();
    if (length < AC_MinLength) renorm();
  }

  void writeInt(U32 v) {
    writeShort(v & 0xFFFF);
    writeShort(v >> 16);
  }

  void done() {
    U32 init_base = base;
    if (length > 2 * AC_MinLength) {
      base += AC_MinLength;
      length = AC_MinLength >> 1;
    } else {
      base += AC_MinLength >> 1;
      length = AC_MinLength >> 9;
    }
    if (init_base > base) propagate_carry();
    renorm();
    // a couple of guard bytes so a decoder that pre-reads 4 bytes at init
    // never runs off the stream (chunk boundaries come from the chunk table)
    out.push_back(0);
    out.push_back(0);
  }
};

// ---------------------------------------------------------------------------
// integer compressor: k-bit residual coding
// ---------------------------------------------------------------------------

struct IntegerCompressor {
  U32 bits = 32, contexts = 1, bits_high = 8;
  U32 corr_bits = 32;
  U32 corr_range = 0;
  I32 corr_min = 0, corr_max = 0;
  U32 last_k = 0;
  std::vector<SymbolModel> mBits;       // one per context, corr_bits+1 symbols
  BitModel mCorrector0;
  std::vector<SymbolModel> mCorrector;  // index 1..corr_bits

  void init(U32 bits_, U32 contexts_, bool for_compress) {
    bits = bits_;
    contexts = contexts_;
    if (bits >= 32) {
      corr_bits = 32;
      corr_range = 0;  // full 32-bit wraparound
      corr_min = -0x7FFFFFFF - 1;
      corr_max = 0x7FFFFFFF;
    } else {
      corr_bits = bits;
      corr_range = 1u << bits;
      corr_min = -(I32)(corr_range >> 1);
      corr_max = corr_min + (I32)corr_range - 1;
    }
    mBits.resize(contexts);
    for (auto& m : mBits) m.init(corr_bits + 1, for_compress);
    mCorrector0.init();
    mCorrector.resize(corr_bits + 1);
    for (U32 k = 1; k <= corr_bits; k++)
      mCorrector[k].init(k <= bits_high ? (1u << k) : (1u << bits_high), for_compress);
  }

  I32 wrap(I64 v) const {
    if (corr_range == 0) return (I32)(U32)(U64)v;  // mod 2^32
    I64 c = v;
    if (c < corr_min) c += corr_range;
    else if (c > corr_max) c -= corr_range;
    return (I32)c;
  }

  I32 readCorrector(Decoder& d, SymbolModel& mb) {
    I32 c;
    U32 k = d.decodeSymbol(mb);
    last_k = k;
    if (k) {
      if (k < 32) {
        if (k <= bits_high) {
          c = (I32)d.decodeSymbol(mCorrector[k]);
        } else {
          U32 k1 = k - bits_high;
          c = (I32)d.decodeSymbol(mCorrector[k]);
          U32 c1 = d.readBits(k1);
          c = (I32)(((U32)c << k1) | c1);
        }
        if (c >= (I32)(1u << (k - 1))) c += 1;
        else c -= (I32)((1u << k) - 1);
      } else {
        c = corr_min;
      }
    } else {
      c = (I32)d.decodeBit(mCorrector0);
    }
    return c;
  }

  I32 decompress(Decoder& d, I32 pred, U32 context) {
    I64 real = (I64)pred + (I64)readCorrector(d, mBits[context]);
    return wrap(real);
  }

  void writeCorrector(Encoder& e, I32 c, SymbolModel& mb) {
    U32 k = 0;
    if (c == 0 || c == 1) {
      last_k = 0;
      e.encodeSymbol(mb, 0);
      e.encodeBit(mCorrector0, (U32)c);
      return;
    }
    U32 cc;  // the raw k-bit payload
    if (c > 1) {
      // c in [2^(k-1)+1, 2^k] -> payload c-1 in [2^(k-1), 2^k-1]
      U32 u = (U32)(c - 1);
      k = 1;
      while (u >= (1u << k)) k++;
      cc = u;
    } else {
      // c in [-(2^k - 1), -2^(k-1)] -> payload c + 2^k - 1 in [0, 2^(k-1)-1]
      U32 u = (U32)(-(I64)c);
      if (u >= 0x80000000u) {
        // c == corr_min (-2^31, 32-bit wraparound only): must be handled
        // BEFORE the k search — `1u << k` wraps at k >= 32 and the loop
        // below would never terminate (the decoder's k==32 branch is the
        // counterpart)
        last_k = 32;
        e.encodeSymbol(mb, 32);
        return;
      }
      k = 1;
      while (u > ((1u << k) - 1)) k++;
      cc = (U32)(c + (I32)((1u << k) - 1));
    }
    last_k = k;
    e.encodeSymbol(mb, k);
    if (k <= bits_high) {
      e.encodeSymbol(mCorrector[k], cc);
    } else {
      U32 k1 = k - bits_high;
      e.encodeSymbol(mCorrector[k], cc >> k1);
      e.writeBits(k1, cc & ((1u << k1) - 1));
    }
  }

  void compress(Encoder& e, I32 pred, I32 real, U32 context) {
    I64 corr = (I64)real - (I64)pred;
    if (corr_range) {
      if (corr < corr_min) corr += corr_range;
      else if (corr > corr_max) corr -= corr_range;
    } else {
      corr = (I32)(U32)((U64)corr);  // mod 2^32, reinterpret signed
    }
    writeCorrector(e, (I32)corr, mBits[context]);
  }

  U32 getK() const { return last_k; }
};

// ---------------------------------------------------------------------------
// streaming median of 5 (POINT10 dx/dy prediction)
// ---------------------------------------------------------------------------

struct StreamingMedian5 {
  I32 values[5] = {0, 0, 0, 0, 0};
  bool high = true;

  void add(I32 v) {
    if (high) {
      if (v < values[2]) {
        values[4] = values[3];
        values[3] = values[2];
        if (v < values[0]) {
          values[2] = values[1];
          values[1] = values[0];
          values[0] = v;
        } else if (v < values[1]) {
          values[2] = values[1];
          values[1] = v;
        } else {
          values[2] = v;
        }
      } else {
        if (v < values[3]) {
          values[4] = values[3];
          values[3] = v;
        } else {
          values[4] = v;
        }
        high = false;
      }
    } else {
      if (values[2] < v) {
        values[0] = values[1];
        values[1] = values[2];
        if (values[4] < v) {
          values[2] = values[3];
          values[3] = values[4];
          values[4] = v;
        } else if (values[3] < v) {
          values[2] = values[3];
          values[3] = v;
        } else {
          values[2] = v;
        }
      } else {
        if (values[1] < v) {
          values[0] = values[1];
          values[1] = v;
        } else {
          values[0] = v;
        }
        high = true;
      }
    }
  }

  I32 get() const { return values[2]; }
};

// published LASzip context tables
static const U8 number_return_map[8][8] = {
    {15, 14, 13, 12, 11, 10, 9, 8},  {14, 0, 1, 3, 6, 10, 10, 9},
    {13, 1, 2, 4, 7, 11, 11, 10},    {12, 3, 4, 5, 8, 12, 12, 11},
    {11, 6, 7, 8, 9, 13, 13, 12},    {10, 10, 11, 12, 13, 14, 14, 13},
    {9, 10, 11, 12, 13, 14, 15, 14}, {8, 9, 10, 11, 12, 13, 14, 15}};

static const U8 number_return_level[8][8] = {
    {0, 1, 2, 3, 4, 5, 6, 7}, {1, 0, 1, 2, 3, 4, 5, 6},
    {2, 1, 0, 1, 2, 3, 4, 5}, {3, 2, 1, 0, 1, 2, 3, 4},
    {4, 3, 2, 1, 0, 1, 2, 3}, {5, 4, 3, 2, 1, 0, 1, 2},
    {6, 5, 4, 3, 2, 1, 0, 1}, {7, 6, 5, 4, 3, 2, 1, 0}};

static inline U8 u8_fold(I32 v) { return (U8)(v & 0xFF); }
static inline U8 u8_clamp(I32 v) { return v < 0 ? 0 : (v > 255 ? 255 : (U8)v); }
static inline U32 zero_bit_0(U32 k) { return k & 0xFFFFFFFEu; }

// raw POINT10 record fields (the 20-byte LAS format-0 record)
struct Point10 {
  I32 x, y, z;
  U16 intensity;
  U8 bit_byte;  // return number (3) | number of returns (3) | scan dir | edge
  U8 classification;
  I8 scan_angle_rank;
  U8 user_data;
  U16 point_source;
};

// ---------------------------------------------------------------------------
// POINT10 v2 item codec
// ---------------------------------------------------------------------------

struct Point10v2 {
  Point10 last{};
  U16 last_intensity[16] = {0};
  StreamingMedian5 last_x_diff_median5[16];
  StreamingMedian5 last_y_diff_median5[16];
  I32 last_height[8] = {0};

  SymbolModel m_changed_values;
  IntegerCompressor ic_intensity;
  SymbolModel m_scan_angle_rank[2];
  IntegerCompressor ic_point_source_ID;
  std::vector<SymbolModel> m_bit_byte;         // 256, lazily initialized
  std::vector<SymbolModel> m_classification;   // 256, lazily initialized
  std::vector<SymbolModel> m_user_data;        // 256, lazily initialized
  std::vector<U8> bit_byte_init, classification_init, user_data_init;
  IntegerCompressor ic_dx, ic_dy, ic_z;
  bool for_compress = false;

  void init(const Point10& first, bool compress) {
    for_compress = compress;
    last = first;
    for (int i = 0; i < 16; i++) {
      last_intensity[i] = 0;
      last_x_diff_median5[i] = StreamingMedian5();
      last_y_diff_median5[i] = StreamingMedian5();
    }
    for (int i = 0; i < 8; i++) last_height[i] = 0;
    m_changed_values.init(64, compress);
    ic_intensity.init(16, 4, compress);
    m_scan_angle_rank[0].init(256, compress);
    m_scan_angle_rank[1].init(256, compress);
    ic_point_source_ID.init(16, 1, compress);
    m_bit_byte.assign(256, SymbolModel());
    m_classification.assign(256, SymbolModel());
    m_user_data.assign(256, SymbolModel());
    bit_byte_init.assign(256, 0);
    classification_init.assign(256, 0);
    user_data_init.assign(256, 0);
    ic_dx.init(32, 2, compress);
    ic_dy.init(32, 22, compress);
    ic_z.init(32, 20, compress);
  }

  SymbolModel& lazy(std::vector<SymbolModel>& ms, std::vector<U8>& flags, U8 i) {
    if (!flags[i]) {
      ms[i].init(256, for_compress);
      flags[i] = 1;
    }
    return ms[i];
  }

  void read(Decoder& d, Point10& p) {
    U32 changed = d.decodeSymbol(m_changed_values);
    if (changed) {
      if (changed & 32) {
        SymbolModel& m = lazy(m_bit_byte, bit_byte_init, last.bit_byte);
        last.bit_byte = (U8)d.decodeSymbol(m);
      }
      U32 r = last.bit_byte & 7;
      U32 n = (last.bit_byte >> 3) & 7;
      U32 mctx = number_return_map[n][r];
      U32 lctx = number_return_level[n][r];
      if (changed & 16) {
        U32 ctx = (mctx < 3 ? mctx : 3);
        last.intensity =
            (U16)ic_intensity.decompress(d, (I32)last_intensity[mctx], ctx);
        last_intensity[mctx] = last.intensity;
      } else {
        last.intensity = last_intensity[mctx];
      }
      if (changed & 8) {
        SymbolModel& m =
            lazy(m_classification, classification_init, last.classification);
        last.classification = (U8)d.decodeSymbol(m);
      }
      if (changed & 4) {
        U32 f = (last.bit_byte >> 6) & 1;  // scan direction flag
        U32 v = d.decodeSymbol(m_scan_angle_rank[f]);
        last.scan_angle_rank = (I8)u8_fold((I32)v + (I32)(U8)last.scan_angle_rank);
      }
      if (changed & 2) {
        SymbolModel& m = lazy(m_user_data, user_data_init, last.user_data);
        last.user_data = (U8)d.decodeSymbol(m);
      }
      if (changed & 1) {
        last.point_source =
            (U16)ic_point_source_ID.decompress(d, (I32)last.point_source, 0);
      }
    } else {
      U32 r = last.bit_byte & 7;
      U32 n = (last.bit_byte >> 3) & 7;
      U32 mctx = number_return_map[n][r];
      last.intensity = last_intensity[mctx];
    }

    U32 r = last.bit_byte & 7;
    U32 n = (last.bit_byte >> 3) & 7;
    U32 mctx = number_return_map[n][r];
    U32 lctx = number_return_level[n][r];

    // x
    I32 median = last_x_diff_median5[mctx].get();
    I32 diff = ic_dx.decompress(d, median, n == 1);
    last.x += diff;
    last_x_diff_median5[mctx].add(diff);
    // y
    U32 kx = ic_dx.getK();
    median = last_y_diff_median5[mctx].get();
    U32 ctx_y = (n == 1) + (kx < 20 ? zero_bit_0(kx) : 20);
    diff = ic_dy.decompress(d, median, ctx_y);
    last.y += diff;
    last_y_diff_median5[mctx].add(diff);
    // z
    U32 kxy = (ic_dx.getK() + ic_dy.getK()) / 2;
    U32 ctx_z = (n == 1) + (kxy < 18 ? zero_bit_0(kxy) : 18);
    last.z = ic_z.decompress(d, last_height[lctx], ctx_z);
    last_height[lctx] = last.z;

    p = last;
  }

  void write(Encoder& e, const Point10& p) {
    U32 r = p.bit_byte & 7;
    U32 n = (p.bit_byte >> 3) & 7;
    U32 mctx = number_return_map[n][r];
    U32 lctx = number_return_level[n][r];

    U32 changed = ((p.bit_byte != last.bit_byte) ? 32u : 0u) |
                  ((p.intensity != last_intensity[mctx]) ? 16u : 0u) |
                  ((p.classification != last.classification) ? 8u : 0u) |
                  ((p.scan_angle_rank != last.scan_angle_rank) ? 4u : 0u) |
                  ((p.user_data != last.user_data) ? 2u : 0u) |
                  ((p.point_source != last.point_source) ? 1u : 0u);
    e.encodeSymbol(m_changed_values, changed);
    if (changed & 32) {
      SymbolModel& m = lazy(m_bit_byte, bit_byte_init, last.bit_byte);
      e.encodeSymbol(m, p.bit_byte);
      last.bit_byte = p.bit_byte;
    }
    if (changed & 16) {
      U32 ctx = (mctx < 3 ? mctx : 3);
      ic_intensity.compress(e, (I32)last_intensity[mctx], (I32)p.intensity, ctx);
      last_intensity[mctx] = p.intensity;
    }
    if (changed & 8) {
      SymbolModel& m =
          lazy(m_classification, classification_init, last.classification);
      e.encodeSymbol(m, p.classification);
      last.classification = p.classification;
    }
    if (changed & 4) {
      U32 f = (p.bit_byte >> 6) & 1;
      U32 v = (U32)u8_fold((I32)(U8)p.scan_angle_rank - (I32)(U8)last.scan_angle_rank);
      e.encodeSymbol(m_scan_angle_rank[f], v);
      last.scan_angle_rank = p.scan_angle_rank;
    }
    if (changed & 2) {
      SymbolModel& m = lazy(m_user_data, user_data_init, last.user_data);
      e.encodeSymbol(m, p.user_data);
      last.user_data = p.user_data;
    }
    if (changed & 1) {
      ic_point_source_ID.compress(e, (I32)last.point_source, (I32)p.point_source, 0);
      last.point_source = p.point_source;
    }
    last.intensity = p.intensity;

    // x
    I32 median = last_x_diff_median5[mctx].get();
    I32 diff = p.x - last.x;
    ic_dx.compress(e, median, diff, n == 1);
    last_x_diff_median5[mctx].add(diff);
    last.x = p.x;
    // y
    U32 kx = ic_dx.getK();
    median = last_y_diff_median5[mctx].get();
    U32 ctx_y = (n == 1) + (kx < 20 ? zero_bit_0(kx) : 20);
    diff = p.y - last.y;
    ic_dy.compress(e, median, diff, ctx_y);
    last_y_diff_median5[mctx].add(diff);
    last.y = p.y;
    // z
    U32 kxy = (ic_dx.getK() + ic_dy.getK()) / 2;
    U32 ctx_z = (n == 1) + (kxy < 18 ? zero_bit_0(kxy) : 18);
    ic_z.compress(e, last_height[lctx], p.z, ctx_z);
    last_height[lctx] = p.z;
    last.z = p.z;
  }
};

// ---------------------------------------------------------------------------
// GPSTIME11 v2 item codec
// ---------------------------------------------------------------------------

static const I32 GPS_MULTI = 500;
static const I32 GPS_MULTI_MINUS = -10;
static const U32 GPS_MULTI_UNCHANGED = (U32)(GPS_MULTI - GPS_MULTI_MINUS + 1);  // 511
static const U32 GPS_MULTI_CODE_FULL = (U32)(GPS_MULTI - GPS_MULTI_MINUS + 2);  // 512
static const U32 GPS_MULTI_TOTAL = (U32)(GPS_MULTI - GPS_MULTI_MINUS + 6);      // 516

struct GpsTime11v2 {
  U64 last_gpstime[4] = {0, 0, 0, 0};
  I32 last_gpstime_diff[4] = {0, 0, 0, 0};
  I32 multi_extreme_counter[4] = {0, 0, 0, 0};
  U32 last = 0, next = 0;

  SymbolModel m_gpstime_multi, m_gpstime_0diff;
  IntegerCompressor ic_gpstime;

  void init(U64 first, bool compress) {
    for (int i = 0; i < 4; i++) {
      last_gpstime[i] = 0;
      last_gpstime_diff[i] = 0;
      multi_extreme_counter[i] = 0;
    }
    last = next = 0;
    last_gpstime[0] = first;
    m_gpstime_multi.init(GPS_MULTI_TOTAL, compress);
    m_gpstime_0diff.init(6, compress);
    ic_gpstime.init(32, 9, compress);
  }

  void read(Decoder& d, U64& out) {
    // sequence switches re-enter the decode; a loop (not recursion) keeps
    // crafted inputs from growing the stack — each iteration consumes
    // symbols, and a drained stream decodes symbol 0 which terminates
    for (;;) {
    if (last_gpstime_diff[last] == 0) {
      U32 multi = d.decodeSymbol(m_gpstime_0diff);
      if (multi == 1) {
        last_gpstime_diff[last] = ic_gpstime.decompress(d, 0, 0);
        last_gpstime[last] = (U64)((I64)last_gpstime[last] + last_gpstime_diff[last]);
        multi_extreme_counter[last] = 0;
      } else if (multi == 2) {
        next = (next + 1) & 3;
        U64 hi = (U64)(U32)ic_gpstime.decompress(
            d, (I32)(last_gpstime[last] >> 32), 8);
        U64 lo = (U64)d.readInt();
        last_gpstime[next] = (hi << 32) | lo;
        last = next;
        last_gpstime_diff[last] = 0;
        multi_extreme_counter[last] = 0;
      } else if (multi > 2) {
        last = (last + multi - 2) & 3;
        continue;  // re-decode against the switched sequence
      }
      // multi == 0: time repeats
    } else {
      U32 multi = d.decodeSymbol(m_gpstime_multi);
      if (multi == 1) {
        last_gpstime[last] = (U64)((I64)last_gpstime[last] +
                                   ic_gpstime.decompress(d, last_gpstime_diff[last], 1));
        multi_extreme_counter[last] = 0;
      } else if (multi < GPS_MULTI_UNCHANGED) {
        I32 gpstime_diff;
        if (multi == 0) {
          gpstime_diff = ic_gpstime.decompress(d, 0, 7);
          multi_extreme_counter[last]++;
          if (multi_extreme_counter[last] > 3) {
            last_gpstime_diff[last] = gpstime_diff;
            multi_extreme_counter[last] = 0;
          }
        } else if (multi < (U32)GPS_MULTI) {
          gpstime_diff = ic_gpstime.decompress(
              d, (I32)(multi * (U32)last_gpstime_diff[last]),
              multi < 10 ? 2u : 3u);
        } else if (multi == (U32)GPS_MULTI) {
          gpstime_diff = ic_gpstime.decompress(
              d, (I32)((U32)GPS_MULTI * (U32)last_gpstime_diff[last]), 4);
          multi_extreme_counter[last]++;
          if (multi_extreme_counter[last] > 3) {
            last_gpstime_diff[last] = gpstime_diff;
            multi_extreme_counter[last] = 0;
          }
        } else {  // negative multipliers: multi in (GPS_MULTI, UNCHANGED)
          I32 neg = GPS_MULTI - (I32)multi;  // -1 .. -10
          if (neg == -1) {
            gpstime_diff = ic_gpstime.decompress(d, -last_gpstime_diff[last], 5);
          } else {
            gpstime_diff = ic_gpstime.decompress(
                d, (I32)(neg * last_gpstime_diff[last]), 6);
          }
          if (neg == GPS_MULTI_MINUS) {
            multi_extreme_counter[last]++;
            if (multi_extreme_counter[last] > 3) {
              last_gpstime_diff[last] = gpstime_diff;
              multi_extreme_counter[last] = 0;
            }
          }
        }
        last_gpstime[last] = (U64)((I64)last_gpstime[last] + gpstime_diff);
      } else if (multi == GPS_MULTI_UNCHANGED) {
        // time repeats
      } else if (multi == GPS_MULTI_CODE_FULL) {
        next = (next + 1) & 3;
        U64 hi = (U64)(U32)ic_gpstime.decompress(
            d, (I32)(last_gpstime[last] >> 32), 8);
        U64 lo = (U64)d.readInt();
        last_gpstime[next] = (hi << 32) | lo;
        last = next;
        last_gpstime_diff[last] = 0;
        multi_extreme_counter[last] = 0;
      } else {  // 513..515: switch sequence
        last = (last + multi - GPS_MULTI_CODE_FULL) & 3;
        continue;  // re-decode against the switched sequence
      }
    }
    break;
    }
    out = last_gpstime[last];
  }

  void write(Encoder& e, U64 t) {
    I64 cur = (I64)t;
    I64 prev = (I64)last_gpstime[last];
    if (last_gpstime_diff[last] == 0) {
      if (cur == prev) {
        e.encodeSymbol(m_gpstime_0diff, 0);
      } else {
        // try the other three sequences for an exact match
        for (U32 i = 1; i < 4; i++) {
          U32 other = (last + i) & 3;
          if ((I64)last_gpstime[other] == cur ||
              (last_gpstime_diff[other] != 0 &&
               llabs(cur - (I64)last_gpstime[other]) < (I64)1 << 30)) {
            // switch only on exact repeat; otherwise fall through
          }
        }
        I64 diff64 = cur - prev;
        if (diff64 == (I64)(I32)diff64) {
          e.encodeSymbol(m_gpstime_0diff, 1);
          ic_gpstime.compress(e, 0, (I32)diff64, 0);
          last_gpstime_diff[last] = (I32)diff64;
          multi_extreme_counter[last] = 0;
          last_gpstime[last] = t;
        } else {
          e.encodeSymbol(m_gpstime_0diff, 2);
          ic_gpstime.compress(e, (I32)(last_gpstime[last] >> 32),
                              (I32)(U32)(t >> 32), 8);
          e.writeInt((U32)t);
          next = (next + 1) & 3;
          last_gpstime[next] = t;
          last = next;
          last_gpstime_diff[last] = 0;
          multi_extreme_counter[last] = 0;
        }
      }
    } else {
      if (cur == prev) {
        e.encodeSymbol(m_gpstime_multi, GPS_MULTI_UNCHANGED);
      } else {
        I64 diff64 = cur - prev;
        if (diff64 == (I64)(I32)diff64) {
          I32 diff = (I32)diff64;
          // estimate the multiplier against the established diff
          double m = (double)diff / (double)last_gpstime_diff[last];
          I32 multi = (I32)(m + (m >= 0 ? 0.5 : -0.5));
          if (multi == 1) {
            e.encodeSymbol(m_gpstime_multi, 1);
            ic_gpstime.compress(e, last_gpstime_diff[last], diff, 1);
            multi_extreme_counter[last] = 0;
          } else if (multi > 1 && multi < GPS_MULTI) {
            e.encodeSymbol(m_gpstime_multi, (U32)multi);
            ic_gpstime.compress(e, (I32)((U32)multi * (U32)last_gpstime_diff[last]),
                                diff, multi < 10 ? 2 : 3);
          } else if (multi >= GPS_MULTI) {
            e.encodeSymbol(m_gpstime_multi, (U32)GPS_MULTI);
            ic_gpstime.compress(
                e, (I32)((U32)GPS_MULTI * (U32)last_gpstime_diff[last]), diff, 4);
            multi_extreme_counter[last]++;
            if (multi_extreme_counter[last] > 3) {
              last_gpstime_diff[last] = diff;
              multi_extreme_counter[last] = 0;
            }
          } else if (multi == -1) {
            e.encodeSymbol(m_gpstime_multi, (U32)(GPS_MULTI - (-1)));  // 501
            ic_gpstime.compress(e, -last_gpstime_diff[last], diff, 5);
          } else if (multi < -1 && multi > GPS_MULTI_MINUS) {
            e.encodeSymbol(m_gpstime_multi, (U32)(GPS_MULTI - multi));
            ic_gpstime.compress(e, (I32)(multi * last_gpstime_diff[last]), diff, 6);
          } else if (multi <= GPS_MULTI_MINUS) {
            e.encodeSymbol(m_gpstime_multi, (U32)(GPS_MULTI - GPS_MULTI_MINUS));  // 510
            ic_gpstime.compress(
                e, (I32)(GPS_MULTI_MINUS * last_gpstime_diff[last]),
                diff, 6);
            multi_extreme_counter[last]++;
            if (multi_extreme_counter[last] > 3) {
              last_gpstime_diff[last] = diff;
              multi_extreme_counter[last] = 0;
            }
          } else {  // multi == 0
            e.encodeSymbol(m_gpstime_multi, 0);
            ic_gpstime.compress(e, 0, diff, 7);
            multi_extreme_counter[last]++;
            if (multi_extreme_counter[last] > 3) {
              last_gpstime_diff[last] = diff;
              multi_extreme_counter[last] = 0;
            }
          }
          last_gpstime[last] = t;
        } else {
          e.encodeSymbol(m_gpstime_multi, GPS_MULTI_CODE_FULL);
          ic_gpstime.compress(e, (I32)(last_gpstime[last] >> 32),
                              (I32)(U32)(t >> 32), 8);
          e.writeInt((U32)t);
          next = (next + 1) & 3;
          last_gpstime[next] = t;
          last = next;
          last_gpstime_diff[last] = 0;
          multi_extreme_counter[last] = 0;
        }
      }
    }
  }
};

// ---------------------------------------------------------------------------
// RGB12 v2 item codec
// ---------------------------------------------------------------------------

struct Rgb12v2 {
  U16 last[3] = {0, 0, 0};
  SymbolModel m_byte_used;
  SymbolModel m_rgb_diff[6];

  void init(const U16* first, bool compress) {
    last[0] = first[0];
    last[1] = first[1];
    last[2] = first[2];
    m_byte_used.init(128, compress);
    for (int i = 0; i < 6; i++) m_rgb_diff[i].init(256, compress);
  }

  void read(Decoder& d, U16* rgb) {
    U8 corr;
    I32 diff = 0;
    U32 sym = d.decodeSymbol(m_byte_used);
    U16 r, g, b;
    U8 rl, ru, gl, gu, bl, bu;
    if (sym & 1) {
      corr = (U8)d.decodeSymbol(m_rgb_diff[0]);
      rl = u8_fold(corr + (last[0] & 255));
    } else rl = last[0] & 255;
    if (sym & 2) {
      corr = (U8)d.decodeSymbol(m_rgb_diff[1]);
      ru = u8_fold(corr + (last[0] >> 8));
    } else ru = last[0] >> 8;
    r = rl | ((U16)ru << 8);
    if (sym & 64) {
      diff = (I32)rl - (I32)(last[0] & 255);
      if (sym & 4) {
        corr = (U8)d.decodeSymbol(m_rgb_diff[2]);
        gl = u8_fold(corr + u8_clamp(diff + (last[1] & 255)));
      } else gl = last[1] & 255;
      if (sym & 16) {
        corr = (U8)d.decodeSymbol(m_rgb_diff[4]);
        diff = (diff + (I32)gl - (I32)(last[1] & 255)) / 2;
        bl = u8_fold(corr + u8_clamp(diff + (last[2] & 255)));
      } else bl = last[2] & 255;
      diff = (I32)ru - (I32)(last[0] >> 8);
      if (sym & 8) {
        corr = (U8)d.decodeSymbol(m_rgb_diff[3]);
        gu = u8_fold(corr + u8_clamp(diff + (last[1] >> 8)));
      } else gu = last[1] >> 8;
      if (sym & 32) {
        corr = (U8)d.decodeSymbol(m_rgb_diff[5]);
        diff = (diff + (I32)gu - (I32)(last[1] >> 8)) / 2;
        bu = u8_fold(corr + u8_clamp(diff + (last[2] >> 8)));
      } else bu = last[2] >> 8;
      g = gl | ((U16)gu << 8);
      b = bl | ((U16)bu << 8);
    } else {
      g = r;
      b = r;
    }
    rgb[0] = last[0] = r;
    rgb[1] = last[1] = g;
    rgb[2] = last[2] = b;
  }

  void write(Encoder& e, const U16* rgb) {
    U32 sym = 0;
    bool rgb_same = (rgb[0] == rgb[1]) && (rgb[0] == rgb[2]);
    if ((rgb[0] & 255) != (last[0] & 255)) sym |= 1;
    if ((rgb[0] >> 8) != (last[0] >> 8)) sym |= 2;
    if (!rgb_same) {
      sym |= 64;
      if ((rgb[1] & 255) != (last[1] & 255)) sym |= 4;
      if ((rgb[1] >> 8) != (last[1] >> 8)) sym |= 8;
      if ((rgb[2] & 255) != (last[2] & 255)) sym |= 16;
      if ((rgb[2] >> 8) != (last[2] >> 8)) sym |= 32;
    } else {
      // g/b identical to r: only the r bits may be set
      if (rgb[1] != rgb[0] || rgb[2] != rgb[0]) sym |= 64;  // unreachable
    }
    // NOTE: when rgb_same but last g/b differ from the new value, the
    // decoder reconstructs g=b=r, which is correct since rgb_same.
    e.encodeSymbol(m_byte_used, sym);
    I32 diff = 0;
    U8 rl = rgb[0] & 255, ru = rgb[0] >> 8;
    if (sym & 1) e.encodeSymbol(m_rgb_diff[0], u8_fold((I32)rl - (I32)(last[0] & 255)));
    if (sym & 2) e.encodeSymbol(m_rgb_diff[1], u8_fold((I32)ru - (I32)(last[0] >> 8)));
    if (sym & 64) {
      diff = (I32)rl - (I32)(last[0] & 255);
      U8 gl = rgb[1] & 255, gu = rgb[1] >> 8, bl = rgb[2] & 255, bu = rgb[2] >> 8;
      if (sym & 4)
        e.encodeSymbol(m_rgb_diff[2],
                       u8_fold((I32)gl - (I32)u8_clamp(diff + (last[1] & 255))));
      if (sym & 16) {
        diff = (diff + (I32)gl - (I32)(last[1] & 255)) / 2;
        e.encodeSymbol(m_rgb_diff[4],
                       u8_fold((I32)bl - (I32)u8_clamp(diff + (last[2] & 255))));
      }
      diff = (I32)ru - (I32)(last[0] >> 8);
      if (sym & 8)
        e.encodeSymbol(m_rgb_diff[3],
                       u8_fold((I32)gu - (I32)u8_clamp(diff + (last[1] >> 8))));
      if (sym & 32) {
        diff = (diff + (I32)gu - (I32)(last[1] >> 8)) / 2;
        e.encodeSymbol(m_rgb_diff[5],
                       u8_fold((I32)bu - (I32)u8_clamp(diff + (last[2] >> 8))));
      }
    }
    last[0] = rgb[0];
    last[1] = rgb[1];
    last[2] = rgb[2];
  }
};


// ---------------------------------------------------------------------------
// Wave packet (29-byte) item codec, used inline in v2 chunks (formats 4/5,
// WAVEPACKET13 item) and as one v3 layer (formats 9/10, WAVEPACKET14 item).
// INTEROP RISK: this is a spec-shaped but self-consistent scheme (descriptor
// symbol model, sequential-offset prediction, delta-coded size/floats);
// upstream LASzip's wavepacket model details were not reproducible here.
// ---------------------------------------------------------------------------

struct Wave29 {
  U8 last_desc = 0;
  U64 last_offset = 0;
  U32 last_size = 0;
  U32 last_rpl = 0;            // return point location, f32 bits
  U32 last_t[3] = {0, 0, 0};   // parametric dx/dy/dz, f32 bits
  SymbolModel m_desc;          // 256
  SymbolModel m_offset_case;   // 4: same / sequential / 32-bit delta / full
  IntegerCompressor ic_offset, ic_size, ic_rpl, ic_t;

  static U64 rd64(const U8* p) {
    U64 v;
    std::memcpy(&v, p, 8);
    return v;
  }
  static U32 rd32(const U8* p) {
    U32 v;
    std::memcpy(&v, p, 4);
    return v;
  }

  void init(const U8* first, bool w) {
    last_desc = first[0];
    last_offset = rd64(first + 1);
    last_size = rd32(first + 9);
    last_rpl = rd32(first + 13);
    for (int i = 0; i < 3; i++) last_t[i] = rd32(first + 17 + 4 * i);
    m_desc.init(256, w);
    m_offset_case.init(4, w);
    ic_offset.init(32, 1, w);
    ic_size.init(32, 1, w);
    ic_rpl.init(32, 1, w);
    ic_t.init(32, 3, w);
  }

  void read(Decoder& d, U8* out) {
    last_desc = (U8)d.decodeSymbol(m_desc);
    U32 oc = d.decodeSymbol(m_offset_case);
    if (oc == 1) last_offset = last_offset + last_size;
    else if (oc == 2)
      last_offset = (U64)((I64)last_offset +
                          (I64)ic_offset.decompress(d, 0, 0));
    else if (oc == 3) {
      U64 lo = (U64)d.readInt();
      U64 hi = (U64)d.readInt();
      last_offset = lo | (hi << 32);
    }  // oc == 0: unchanged
    last_size = (U32)ic_size.decompress(d, (I32)last_size, 0);
    last_rpl = (U32)ic_rpl.decompress(d, (I32)last_rpl, 0);
    for (int i = 0; i < 3; i++)
      last_t[i] = (U32)ic_t.decompress(d, (I32)last_t[i], (U32)i);
    out[0] = last_desc;
    std::memcpy(out + 1, &last_offset, 8);
    std::memcpy(out + 9, &last_size, 4);
    std::memcpy(out + 13, &last_rpl, 4);
    for (int i = 0; i < 3; i++) std::memcpy(out + 17 + 4 * i, &last_t[i], 4);
  }

  void write(Encoder& e, const U8* in) {
    U8 desc = in[0];
    U64 off = rd64(in + 1);
    U32 size = rd32(in + 9);
    U32 rpl = rd32(in + 13);
    e.encodeSymbol(m_desc, desc);
    if (off == last_offset) {
      e.encodeSymbol(m_offset_case, 0);
    } else if (off == last_offset + last_size) {
      e.encodeSymbol(m_offset_case, 1);
    } else {
      I64 diff = (I64)off - (I64)last_offset;
      if (diff == (I64)(I32)diff && (U32)diff != 0x80000000u) {
        e.encodeSymbol(m_offset_case, 2);
        ic_offset.compress(e, 0, (I32)diff, 0);
      } else {
        e.encodeSymbol(m_offset_case, 3);
        e.writeInt((U32)off);
        e.writeInt((U32)(off >> 32));
      }
    }
    last_desc = desc;
    last_offset = off;
    ic_size.compress(e, (I32)last_size, (I32)size, 0);
    last_size = size;
    ic_rpl.compress(e, (I32)last_rpl, (I32)rpl, 0);
    last_rpl = rpl;
    for (int i = 0; i < 3; i++) {
      U32 t = rd32(in + 17 + 4 * i);
      ic_t.compress(e, (I32)last_t[i], (I32)t, (U32)i);
      last_t[i] = t;
    }
  }
};

// ---------------------------------------------------------------------------
// BYTE v2 item codec (extra bytes)
// ---------------------------------------------------------------------------

struct Bytev2 {
  std::vector<U8> last;
  std::vector<SymbolModel> m_byte;

  void init(const U8* first, U32 n, bool compress) {
    last.assign(first, first + n);
    m_byte.resize(n);
    for (auto& m : m_byte) m.init(256, compress);
  }

  void read(Decoder& d, U8* out) {
    for (size_t i = 0; i < last.size(); i++) {
      U32 v = d.decodeSymbol(m_byte[i]);
      out[i] = last[i] = u8_fold((I32)v + (I32)last[i]);
    }
  }

  void write(Encoder& e, const U8* in) {
    for (size_t i = 0; i < last.size(); i++) {
      e.encodeSymbol(m_byte[i], u8_fold((I32)in[i] - (I32)last[i]));
      last[i] = in[i];
    }
  }
};

// ---------------------------------------------------------------------------
// SoA column bundle shared by decode/encode entry points
// ---------------------------------------------------------------------------

struct Columns {
  I32* x;
  I32* y;
  I32* z;
  U16* intensity;
  U8* bit_byte;
  U8* classification;
  I8* scan_angle;
  U8* user_data;
  U16* point_source;
  double* gps_time;  // may be null
  U16* rgb;          // (n,3), may be null
  U8* wave;          // (n,29), may be null
  U8* extra;         // (n, extra_size), may be null
};

static void load_point(const Columns& c, I64 i, Point10& p, U64& gps, U16* rgb,
                       const U8** extra, U32 extra_size) {
  p.x = c.x[i];
  p.y = c.y[i];
  p.z = c.z[i];
  p.intensity = c.intensity ? c.intensity[i] : 0;
  p.bit_byte = c.bit_byte ? c.bit_byte[i] : 0;
  p.classification = c.classification ? c.classification[i] : 0;
  p.scan_angle_rank = c.scan_angle ? c.scan_angle[i] : 0;
  p.user_data = c.user_data ? c.user_data[i] : 0;
  p.point_source = c.point_source ? c.point_source[i] : 0;
  if (c.gps_time) {
    double t = c.gps_time[i];
    std::memcpy(&gps, &t, 8);
  }
  if (c.rgb) {
    rgb[0] = c.rgb[i * 3];
    rgb[1] = c.rgb[i * 3 + 1];
    rgb[2] = c.rgb[i * 3 + 2];
  }
  if (c.extra && extra) *extra = c.extra + i * extra_size;
}

static void store_point(const Columns& c, I64 i, const Point10& p, U64 gps,
                        const U16* rgb, const U8* extra, U32 extra_size) {
  c.x[i] = p.x;
  c.y[i] = p.y;
  c.z[i] = p.z;
  if (c.intensity) c.intensity[i] = p.intensity;
  if (c.bit_byte) c.bit_byte[i] = p.bit_byte;
  if (c.classification) c.classification[i] = p.classification;
  if (c.scan_angle) c.scan_angle[i] = p.scan_angle_rank;
  if (c.user_data) c.user_data[i] = p.user_data;
  if (c.point_source) c.point_source[i] = p.point_source;
  if (c.gps_time) {
    double t;
    std::memcpy(&t, &gps, 8);
    c.gps_time[i] = t;
  }
  if (c.rgb && rgb) {
    c.rgb[i * 3] = rgb[0];
    c.rgb[i * 3 + 1] = rgb[1];
    c.rgb[i * 3 + 2] = rgb[2];
  }
  if (c.extra && extra) std::memcpy(c.extra + i * extra_size, extra, extra_size);
}

// raw (uncompressed) first-point-of-chunk serialization: the plain LAS
// point-record layout for formats 0-3 (+ extra bytes)
static size_t raw_point_size(bool has_gps, bool has_rgb, bool has_wave,
                             U32 extra_size) {
  return 20 + (has_gps ? 8 : 0) + (has_rgb ? 6 : 0) + (has_wave ? 29 : 0) +
         extra_size;
}

static void read_raw_point(const U8* p, Point10& pt, U64& gps, U16* rgb,
                           U8* wave, U8* extra, bool has_gps, bool has_rgb,
                           bool has_wave, U32 extra_size) {
  std::memcpy(&pt.x, p, 4);
  std::memcpy(&pt.y, p + 4, 4);
  std::memcpy(&pt.z, p + 8, 4);
  std::memcpy(&pt.intensity, p + 12, 2);
  pt.bit_byte = p[14];
  pt.classification = p[15];
  pt.scan_angle_rank = (I8)p[16];
  pt.user_data = p[17];
  std::memcpy(&pt.point_source, p + 18, 2);
  size_t off = 20;
  if (has_gps) {
    std::memcpy(&gps, p + off, 8);
    off += 8;
  }
  if (has_rgb) {
    std::memcpy(rgb, p + off, 6);
    off += 6;
  }
  if (has_wave) {
    std::memcpy(wave, p + off, 29);
    off += 29;
  }
  if (extra_size) std::memcpy(extra, p + off, extra_size);
}

static void write_raw_point(std::vector<U8>& out, const Point10& pt, U64 gps,
                            const U16* rgb, const U8* wave, const U8* extra,
                            bool has_gps, bool has_rgb, bool has_wave,
                            U32 extra_size) {
  size_t base = out.size();
  out.resize(base + raw_point_size(has_gps, has_rgb, has_wave, extra_size));
  U8* p = out.data() + base;
  std::memcpy(p, &pt.x, 4);
  std::memcpy(p + 4, &pt.y, 4);
  std::memcpy(p + 8, &pt.z, 4);
  std::memcpy(p + 12, &pt.intensity, 2);
  p[14] = pt.bit_byte;
  p[15] = pt.classification;
  p[16] = (U8)pt.scan_angle_rank;
  p[17] = pt.user_data;
  std::memcpy(p + 18, &pt.point_source, 2);
  size_t off = 20;
  if (has_gps) {
    std::memcpy(p + off, &gps, 8);
    off += 8;
  }
  if (has_rgb) {
    std::memcpy(p + off, rgb, 6);
    off += 6;
  }
  if (has_wave) {
    std::memcpy(p + off, wave, 29);
    off += 29;
  }
  if (extra_size) std::memcpy(p + off, extra, extra_size);
}

// decode one chunk of `count` points starting at buf into columns[out_base..]
static int decode_chunk(const U8* buf, size_t nbytes, I64 count, const Columns& c,
                        I64 out_base, bool has_gps, bool has_rgb,
                        bool has_wave, U32 extra_size) {
  if (count <= 0) return 0;
  size_t raw = raw_point_size(has_gps, has_rgb, has_wave, extra_size);
  if (nbytes < raw) return -1;

  Point10 pt{};
  U64 gps = 0;
  U16 rgb[3] = {0, 0, 0};
  U8 wave[29] = {0};
  std::vector<U8> extra(extra_size ? extra_size : 1);
  read_raw_point(buf, pt, gps, rgb, wave, extra.data(), has_gps, has_rgb,
                 has_wave, extra_size);
  store_point(c, out_base, pt, gps, rgb, extra.data(), extra_size);
  if (c.wave) std::memcpy(c.wave + out_base * 29, wave, 29);
  if (count == 1) return 0;

  Point10v2 p10;
  GpsTime11v2 g11;
  Rgb12v2 rgb12;
  Wave29 wavec;
  Bytev2 bytev2;
  p10.init(pt, false);
  if (has_gps) g11.init(gps, false);
  if (has_rgb) rgb12.init(rgb, false);
  if (has_wave) wavec.init(wave, false);
  if (extra_size) bytev2.init(extra.data(), extra_size, false);

  Decoder d;
  d.init(buf + raw, nbytes - raw);
  for (I64 i = 1; i < count; i++) {
    p10.read(d, pt);
    if (has_gps) g11.read(d, gps);
    if (has_rgb) rgb12.read(d, rgb);
    if (has_wave) wavec.read(d, wave);
    if (extra_size) bytev2.read(d, extra.data());
    store_point(c, out_base + i, pt, gps, rgb, extra.data(), extra_size);
    if (c.wave) std::memcpy(c.wave + (out_base + i) * 29, wave, 29);
  }
  return 0;
}

// encode `count` points from columns[in_base..] into out
static const U8 kZeroWave[29] = {0};

static void encode_chunk(std::vector<U8>& out, I64 count, const Columns& c,
                         I64 in_base, bool has_gps, bool has_rgb,
                         bool has_wave, U32 extra_size) {
  Point10 pt{};
  U64 gps = 0;
  U16 rgb[3] = {0, 0, 0};
  const U8* extra = nullptr;
  std::vector<U8> zero_extra(extra_size ? extra_size : 1, 0);
  extra = zero_extra.data();

  load_point(c, in_base, pt, gps, rgb, &extra, extra_size);
  const U8* wave = c.wave ? c.wave + in_base * 29 : kZeroWave;
  write_raw_point(out, pt, gps, rgb, wave, extra, has_gps, has_rgb, has_wave,
                  extra_size);
  if (count == 1) return;

  Point10v2 p10;
  GpsTime11v2 g11;
  Rgb12v2 rgb12;
  Wave29 wavec;
  Bytev2 bytev2;
  p10.init(pt, true);
  if (has_gps) g11.init(gps, true);
  if (has_rgb) rgb12.init(rgb, true);
  if (has_wave) wavec.init(wave, true);
  if (extra_size) bytev2.init(extra, extra_size, true);

  Encoder e;
  e.init();
  for (I64 i = 1; i < count; i++) {
    load_point(c, in_base + i, pt, gps, rgb, &extra, extra_size);
    p10.write(e, pt);
    if (has_gps) g11.write(e, gps);
    if (has_rgb) rgb12.write(e, rgb);
    if (has_wave) wavec.write(e, c.wave ? c.wave + (in_base + i) * 29 : kZeroWave);
    if (extra_size) bytev2.write(e, extra);
  }
  e.done();
  out.insert(out.end(), e.out.begin(), e.out.end());
}


// ===========================================================================
// LAS 1.4 / LASzip v3 "layered" codec (point formats 6-10; POINT14, RGB14,
// RGBNIR14, BYTE14 items). Structure follows the open LASzip v3 design:
// each chunk = [raw first point][u32 byte count per layer][independent
// arithmetic-coded layer streams], with four scanner-channel contexts for
// the POINT14 models.
//
// INTEROP RISK notes (self-roundtrip is exact; third-party v3 files may
// not decode bit-exactly): the 16x16 number-return context tables are
// derived here by clamping the published 8x8 v2 tables; RGB14/NIR/BYTE14
// use single shared model instances rather than per-scanner-channel
// copies; layer-internal model choices marked below follow this file's
// self-consistent conventions where the upstream constant was uncertain.
// ===========================================================================

// 16x16 context maps for up to 15 returns, derived from the published 8x8
// tables by clamping (INTEROP RISK: upstream uses dedicated 16x16 tables)
static inline U32 nrmap6(U32 n, U32 r) {
  U8 v = number_return_map[n > 7 ? 7 : n][r > 7 ? 7 : r];
  return v > 5 ? 5 : v;
}
static inline U32 nrlevel8(U32 n, U32 r) {
  return number_return_level[n > 7 ? 7 : n][r > 7 ? 7 : r];
}

// raw LAS 1.4 point-record fields (the 30-byte format-6 core)
struct Point14 {
  I32 x = 0, y = 0, z = 0;
  U16 intensity = 0;
  U8 ret = 0;          // return number (4 bits)
  U8 nret = 0;         // number of returns (4 bits)
  U8 class_flags = 0;  // 4 bits
  U8 channel = 0;      // scanner channel, 2 bits
  U8 dir = 0, edge = 0;
  U8 classification = 0, user_data = 0;
  I16 scan_angle = 0;
  U16 point_source = 0;
  U64 gps = 0;  // f64 bits
  bool gps_time_change = false;
};

static void read_raw_point14(const U8* p, Point14& pt) {
  std::memcpy(&pt.x, p, 4);
  std::memcpy(&pt.y, p + 4, 4);
  std::memcpy(&pt.z, p + 8, 4);
  std::memcpy(&pt.intensity, p + 12, 2);
  pt.ret = p[14] & 15;
  pt.nret = p[14] >> 4;
  pt.class_flags = p[15] & 15;
  pt.channel = (p[15] >> 4) & 3;
  pt.dir = (p[15] >> 6) & 1;
  pt.edge = (p[15] >> 7) & 1;
  pt.classification = p[16];
  pt.user_data = p[17];
  std::memcpy(&pt.scan_angle, p + 18, 2);
  std::memcpy(&pt.point_source, p + 20, 2);
  std::memcpy(&pt.gps, p + 22, 8);
}

static void write_raw_point14(std::vector<U8>& out, const Point14& pt) {
  size_t base = out.size();
  out.resize(base + 30);
  U8* p = out.data() + base;
  std::memcpy(p, &pt.x, 4);
  std::memcpy(p + 4, &pt.y, 4);
  std::memcpy(p + 8, &pt.z, 4);
  std::memcpy(p + 12, &pt.intensity, 2);
  p[14] = (U8)((pt.ret & 15) | (pt.nret << 4));
  p[15] = (U8)((pt.class_flags & 15) | (pt.channel << 4) | (pt.dir << 6) |
               (pt.edge << 7));
  p[16] = pt.classification;
  p[17] = pt.user_data;
  std::memcpy(p + 18, &pt.scan_angle, 2);
  std::memcpy(p + 20, &pt.point_source, 2);
  std::memcpy(p + 22, &pt.gps, 8);
}

// one POINT14 model context (per scanner channel)
struct P14Ctx {
  bool unused = true;
  Point14 last{};
  U16 last_intensity[8];
  StreamingMedian5 medx[12], medy[12];
  I32 last_z[8];
  SymbolModel m_changed_values[8];  // 128 symbols each
  SymbolModel m_scanner_channel;    // 3
  SymbolModel m_nr[16];             // 16 each
  SymbolModel m_rn[16];             // 16 each
  SymbolModel m_rn_gps_same;        // 13
  IntegerCompressor ic_dx, ic_dy, ic_z, ic_int, ic_ang, ic_psrc;
  SymbolModel m_cls[64];    // 256 each
  SymbolModel m_flags[64];  // 64 each
  SymbolModel m_ud[64];     // 256 each
  GpsTime11v2 gps;

  void init_from(const Point14& seed, bool w) {
    unused = false;
    last = seed;
    last.gps_time_change = false;
    for (int i = 0; i < 8; i++) last_intensity[i] = seed.intensity;
    for (int i = 0; i < 12; i++) {
      medx[i] = StreamingMedian5();
      medy[i] = StreamingMedian5();
    }
    for (int i = 0; i < 8; i++) last_z[i] = seed.z;
    for (int i = 0; i < 8; i++) m_changed_values[i].init(128, w);
    m_scanner_channel.init(3, w);
    for (int i = 0; i < 16; i++) {
      m_nr[i].init(16, w);
      m_rn[i].init(16, w);
    }
    m_rn_gps_same.init(13, w);
    ic_dx.init(32, 2, w);
    ic_dy.init(32, 22, w);
    ic_z.init(32, 20, w);
    ic_int.init(16, 4, w);
    ic_ang.init(16, 2, w);
    ic_psrc.init(16, 1, w);
    for (int i = 0; i < 64; i++) {
      m_cls[i].init(256, w);
      m_flags[i].init(64, w);
      m_ud[i].init(256, w);
    }
    gps.init(seed.gps, w);
  }
};

// POINT14 v3 layer order
enum {
  L14_XY = 0, L14_Z, L14_CLS, L14_FLAGS, L14_INT, L14_ANG, L14_UD, L14_PSRC,
  L14_GPS, L14_COUNT
};

struct Point14v3Reader {
  P14Ctx ctx[4];
  U32 cc = 0;
  Decoder d[L14_COUNT];
  bool have[L14_COUNT];

  void init(const Point14& first, const U8* const* layer, const U32* nbytes) {
    for (int i = 0; i < 4; i++) ctx[i].unused = true;
    cc = first.channel;
    ctx[cc].init_from(first, false);
    for (int i = 0; i < L14_COUNT; i++) {
      have[i] = nbytes[i] > 0;
      if (have[i]) d[i].init(layer[i], nbytes[i]);
    }
  }

  void read(Point14& p) {
    P14Ctx* c = &ctx[cc];
    U32 lpr = (c->last.ret == 1 ? 1u : 0u) |
              (c->last.ret >= c->last.nret ? 2u : 0u) |
              (c->last.gps_time_change ? 4u : 0u);
    U32 chv = d[L14_XY].decodeSymbol(c->m_changed_values[lpr]);
    if (chv & 64) {  // scanner channel changed
      U32 diff = d[L14_XY].decodeSymbol(c->m_scanner_channel);
      U32 nc = (cc + diff + 1) & 3;
      if (ctx[nc].unused) ctx[nc].init_from(c->last, false);
      cc = nc;
      c = &ctx[cc];
      c->last.channel = (U8)cc;
    }
    bool psrc_change = (chv & 32) != 0;
    bool gpsc = (chv & 16) != 0;
    bool angc = (chv & 8) != 0;
    U8 n = (chv & 4) ? (U8)d[L14_XY].decodeSymbol(c->m_nr[c->last.nret])
                     : c->last.nret;
    U8 r;
    switch (chv & 3) {
      case 0: r = c->last.ret; break;
      case 1: r = (U8)((c->last.ret + 1) & 15); break;
      case 2: r = (U8)((c->last.ret + 15) & 15); break;
      default:
        if (gpsc) r = (U8)d[L14_XY].decodeSymbol(c->m_rn[c->last.ret]);
        else
          r = (U8)((c->last.ret + d[L14_XY].decodeSymbol(c->m_rn_gps_same) + 2) & 15);
    }
    U32 m = nrmap6(n, r);
    U32 l = nrlevel8(n, r);
    U32 gctx = gpsc ? 1u : 0u;
    U32 med = (m << 1) | gctx;

    I32 diffx = c->ic_dx.decompress(d[L14_XY], c->medx[med].get(), n == 1 ? 1 : 0);
    p.x = c->last.x + diffx;
    c->medx[med].add(diffx);
    U32 kb = c->ic_dx.getK();
    I32 diffy = c->ic_dy.decompress(
        d[L14_XY], c->medy[med].get(),
        (n == 1 ? 1u : 0u) + (kb < 20 ? zero_bit_0(kb) : 20u));
    p.y = c->last.y + diffy;
    c->medy[med].add(diffy);

    if (have[L14_Z]) {
      U32 kz = (c->ic_dx.getK() + c->ic_dy.getK()) / 2;
      p.z = c->ic_z.decompress(d[L14_Z], c->last_z[l],
                               (n == 1 ? 1u : 0u) + (kz < 18 ? zero_bit_0(kz) : 18u));
      c->last_z[l] = p.z;
    } else p.z = c->last.z;

    U32 cpr = (r == 1 ? 2u : 0u) + (r >= n ? 1u : 0u);
    if (have[L14_CLS]) {
      U32 ci = ((c->last.classification & 0x1F) << 1) | (cpr == 3 ? 1u : 0u);
      p.classification = (U8)d[L14_CLS].decodeSymbol(c->m_cls[ci]);
    } else p.classification = c->last.classification;

    if (have[L14_FLAGS]) {
      U32 lf = c->last.class_flags | (c->last.dir << 4) | (c->last.edge << 5);
      U32 f = d[L14_FLAGS].decodeSymbol(c->m_flags[lf]);
      p.class_flags = f & 15;
      p.dir = (f >> 4) & 1;
      p.edge = (f >> 5) & 1;
    } else {
      p.class_flags = c->last.class_flags;
      p.dir = c->last.dir;
      p.edge = c->last.edge;
    }

    if (have[L14_INT]) {
      U32 ii = (cpr << 1) | gctx;
      I32 v = c->ic_int.decompress(d[L14_INT], c->last_intensity[ii], cpr);
      p.intensity = (U16)v;
      c->last_intensity[ii] = (U16)v;
    } else p.intensity = c->last.intensity;

    if (angc && have[L14_ANG])
      p.scan_angle = (I16)c->ic_ang.decompress(d[L14_ANG], c->last.scan_angle, gctx);
    else p.scan_angle = c->last.scan_angle;

    if (have[L14_UD])
      p.user_data = (U8)d[L14_UD].decodeSymbol(c->m_ud[c->last.user_data / 4]);
    else p.user_data = c->last.user_data;

    if (psrc_change && have[L14_PSRC])
      p.point_source = (U16)c->ic_psrc.decompress(d[L14_PSRC], c->last.point_source, 0);
    else p.point_source = c->last.point_source;

    if (gpsc && have[L14_GPS]) c->gps.read(d[L14_GPS], p.gps);
    else p.gps = c->last.gps;

    p.ret = r;
    p.nret = n;
    p.channel = (U8)cc;
    p.gps_time_change = gpsc;
    c->last = p;
  }
};

struct Point14v3Writer {
  P14Ctx ctx[4];
  U32 cc = 0;
  Encoder e[L14_COUNT];
  bool used[L14_COUNT];

  void init(const Point14& first) {
    for (int i = 0; i < 4; i++) ctx[i].unused = true;
    cc = first.channel;
    ctx[cc].init_from(first, true);
    for (int i = 0; i < L14_COUNT; i++) {
      e[i].init();
      used[i] = false;
    }
  }

  void write(const Point14& p) {
    P14Ctx* c = &ctx[cc];
    U32 nc = p.channel & 3;
    const Point14& ref = (nc == cc || ctx[nc].unused) ? c->last : ctx[nc].last;
    U32 chv = 0;
    if (nc != cc) chv |= 64;
    if (p.point_source != ref.point_source) chv |= 32;
    if (p.gps != ref.gps) chv |= 16;
    if (p.scan_angle != ref.scan_angle) chv |= 8;
    if (p.nret != ref.nret) chv |= 4;
    U32 rcode;
    if (p.ret == ref.ret) rcode = 0;
    else if (p.ret == ((ref.ret + 1) & 15)) rcode = 1;
    else if (p.ret == ((ref.ret + 15) & 15)) rcode = 2;
    else rcode = 3;
    chv |= rcode;

    U32 lpr = (c->last.ret == 1 ? 1u : 0u) |
              (c->last.ret >= c->last.nret ? 2u : 0u) |
              (c->last.gps_time_change ? 4u : 0u);
    used[L14_XY] = true;
    e[L14_XY].encodeSymbol(c->m_changed_values[lpr], chv);
    if (chv & 64) {
      U32 diff = (nc + 4 - cc - 1) & 3;  // in {0,1,2}
      e[L14_XY].encodeSymbol(c->m_scanner_channel, diff);
      if (ctx[nc].unused) ctx[nc].init_from(c->last, true);
      cc = nc;
      c = &ctx[cc];
      c->last.channel = (U8)cc;
    }
    bool gpsc = (chv & 16) != 0;
    if (chv & 4) e[L14_XY].encodeSymbol(c->m_nr[c->last.nret], p.nret);
    if (rcode == 3) {
      if (gpsc) e[L14_XY].encodeSymbol(c->m_rn[c->last.ret], p.ret);
      else
        e[L14_XY].encodeSymbol(c->m_rn_gps_same,
                               (p.ret + 16 - c->last.ret - 2) & 15);
    }
    U8 n = p.nret, r = p.ret;
    U32 m = nrmap6(n, r);
    U32 l = nrlevel8(n, r);
    U32 gctx = gpsc ? 1u : 0u;
    U32 med = (m << 1) | gctx;

    I32 diffx = p.x - c->last.x;
    c->ic_dx.compress(e[L14_XY], c->medx[med].get(), diffx, n == 1 ? 1 : 0);
    c->medx[med].add(diffx);
    U32 kb = c->ic_dx.getK();
    I32 diffy = p.y - c->last.y;
    c->ic_dy.compress(e[L14_XY], c->medy[med].get(), diffy,
                      (n == 1 ? 1u : 0u) + (kb < 20 ? zero_bit_0(kb) : 20u));
    c->medy[med].add(diffy);

    used[L14_Z] = true;
    U32 kz = (c->ic_dx.getK() + c->ic_dy.getK()) / 2;
    c->ic_z.compress(e[L14_Z], c->last_z[l], p.z,
                     (n == 1 ? 1u : 0u) + (kz < 18 ? zero_bit_0(kz) : 18u));
    c->last_z[l] = p.z;

    U32 cpr = (r == 1 ? 2u : 0u) + (r >= n ? 1u : 0u);
    used[L14_CLS] = true;
    U32 ci = ((c->last.classification & 0x1F) << 1) | (cpr == 3 ? 1u : 0u);
    e[L14_CLS].encodeSymbol(c->m_cls[ci], p.classification);

    used[L14_FLAGS] = true;
    U32 lf = c->last.class_flags | (c->last.dir << 4) | (c->last.edge << 5);
    U32 f = (p.class_flags & 15) | (p.dir << 4) | (p.edge << 5);
    e[L14_FLAGS].encodeSymbol(c->m_flags[lf], f);

    used[L14_INT] = true;
    U32 ii = (cpr << 1) | gctx;
    c->ic_int.compress(e[L14_INT], c->last_intensity[ii], p.intensity, cpr);
    c->last_intensity[ii] = p.intensity;

    if (chv & 8) {
      used[L14_ANG] = true;
      c->ic_ang.compress(e[L14_ANG], c->last.scan_angle, p.scan_angle, gctx);
    }

    used[L14_UD] = true;
    e[L14_UD].encodeSymbol(c->m_ud[c->last.user_data / 4], p.user_data);

    if (chv & 32) {
      used[L14_PSRC] = true;
      c->ic_psrc.compress(e[L14_PSRC], c->last.point_source, p.point_source, 0);
    }
    if (gpsc) {
      used[L14_GPS] = true;
      c->gps.write(e[L14_GPS], p.gps);
    }
    Point14 stored = p;
    stored.gps_time_change = gpsc;
    c->last = stored;
  }
};

// NIR channel codec (RGBNIR14's second layer) — same two-byte diff scheme
// as the RGB low/high bytes
struct Nir14v3 {
  U16 last = 0;
  SymbolModel m_used;     // 4 symbols: bit0 low byte changed, bit1 high
  SymbolModel m_diff[2];  // 256 each

  void init(U16 first, bool w) {
    last = first;
    m_used.init(4, w);
    m_diff[0].init(256, w);
    m_diff[1].init(256, w);
  }
  void read(Decoder& d, U16& nir) {
    U32 sym = d.decodeSymbol(m_used);
    U8 lo = (sym & 1) ? u8_fold((I32)d.decodeSymbol(m_diff[0]) + (last & 255))
                      : (U8)(last & 255);
    U8 hi = (sym & 2) ? u8_fold((I32)d.decodeSymbol(m_diff[1]) + (last >> 8))
                      : (U8)(last >> 8);
    nir = last = (U16)(lo | ((U16)hi << 8));
  }
  void write(Encoder& e, U16 nir) {
    U32 sym = 0;
    if ((nir & 255) != (last & 255)) sym |= 1;
    if ((nir >> 8) != (last >> 8)) sym |= 2;
    e.encodeSymbol(m_used, sym);
    if (sym & 1)
      e.encodeSymbol(m_diff[0], u8_fold((I32)(nir & 255) - (I32)(last & 255)));
    if (sym & 2)
      e.encodeSymbol(m_diff[1], u8_fold((I32)(nir >> 8) - (I32)(last >> 8)));
    last = nir;
  }
};

// SoA columns for LAS 1.4 records (formats 6-8 + extra bytes)
struct Columns14 {
  I32* x;
  I32* y;
  I32* z;
  U16* intensity;
  U8* returns_byte;  // ret | nret<<4 (record byte 14)
  U8* flags_byte;    // class_flags | channel<<4 | dir<<6 | edge<<7 (byte 15)
  U8* classification;
  U8* user_data;
  I16* scan_angle;
  U16* point_source;
  double* gps_time;
  U16* rgb;   // may be null
  U16* nir;   // may be null
  U8* wave;   // (n,29), may be null
  U8* extra;  // may be null
};

static void load_point14(const Columns14& c, I64 i, Point14& p, U16* rgb,
                         U16& nir, const U8** extra, U32 extra_size) {
  p.x = c.x[i];
  p.y = c.y[i];
  p.z = c.z[i];
  p.intensity = c.intensity ? c.intensity[i] : 0;
  U8 rb = c.returns_byte ? c.returns_byte[i] : 0;
  p.ret = rb & 15;
  p.nret = rb >> 4;
  U8 fb = c.flags_byte ? c.flags_byte[i] : 0;
  p.class_flags = fb & 15;
  p.channel = (fb >> 4) & 3;
  p.dir = (fb >> 6) & 1;
  p.edge = (fb >> 7) & 1;
  p.classification = c.classification ? c.classification[i] : 0;
  p.user_data = c.user_data ? c.user_data[i] : 0;
  p.scan_angle = c.scan_angle ? c.scan_angle[i] : 0;
  p.point_source = c.point_source ? c.point_source[i] : 0;
  if (c.gps_time) {
    double t = c.gps_time[i];
    std::memcpy(&p.gps, &t, 8);
  } else p.gps = 0;
  if (c.rgb) {
    rgb[0] = c.rgb[i * 3];
    rgb[1] = c.rgb[i * 3 + 1];
    rgb[2] = c.rgb[i * 3 + 2];
  }
  nir = c.nir ? c.nir[i] : 0;
  if (c.extra && extra) *extra = c.extra + i * extra_size;
}

static void store_point14(const Columns14& c, I64 i, const Point14& p,
                          const U16* rgb, U16 nir, const U8* extra,
                          U32 extra_size) {
  c.x[i] = p.x;
  c.y[i] = p.y;
  c.z[i] = p.z;
  if (c.intensity) c.intensity[i] = p.intensity;
  if (c.returns_byte) c.returns_byte[i] = (U8)((p.ret & 15) | (p.nret << 4));
  if (c.flags_byte)
    c.flags_byte[i] =
        (U8)((p.class_flags & 15) | (p.channel << 4) | (p.dir << 6) | (p.edge << 7));
  if (c.classification) c.classification[i] = p.classification;
  if (c.user_data) c.user_data[i] = p.user_data;
  if (c.scan_angle) c.scan_angle[i] = p.scan_angle;
  if (c.point_source) c.point_source[i] = p.point_source;
  if (c.gps_time) {
    double t;
    std::memcpy(&t, &p.gps, 8);
    c.gps_time[i] = t;
  }
  if (c.rgb && rgb) {
    c.rgb[i * 3] = rgb[0];
    c.rgb[i * 3 + 1] = rgb[1];
    c.rgb[i * 3 + 2] = rgb[2];
  }
  if (c.nir) c.nir[i] = nir;
  if (c.extra && extra) std::memcpy(c.extra + i * extra_size, extra, extra_size);
}

static size_t raw_point14_size(bool has_rgb, bool has_nir, bool has_wave,
                               U32 extra_size) {
  return 30 + (has_rgb ? 6 : 0) + (has_nir ? 2 : 0) + (has_wave ? 29 : 0) +
         extra_size;
}

// decode one v3 layered chunk into columns[out_base..]
static int decode_chunk14(const U8* buf, size_t nbytes, I64 count,
                          const Columns14& c, I64 out_base, bool has_rgb,
                          bool has_nir, bool has_wave, U32 extra_size) {
  if (count <= 0) return 0;
  size_t raw = raw_point14_size(has_rgb, has_nir, has_wave, extra_size);
  if (nbytes < raw) return -1;

  Point14 pt{};
  U16 rgb[3] = {0, 0, 0};
  U16 nir = 0;
  U8 wave[29] = {0};
  std::vector<U8> extra(extra_size ? extra_size : 1, 0);
  read_raw_point14(buf, pt);
  size_t off = 30;
  if (has_rgb) {
    std::memcpy(rgb, buf + off, 6);
    off += 6;
  }
  if (has_nir) {
    std::memcpy(&nir, buf + off, 2);
    off += 2;
  }
  if (has_wave) {
    std::memcpy(wave, buf + off, 29);
    off += 29;
  }
  if (extra_size) std::memcpy(extra.data(), buf + off, extra_size);
  store_point14(c, out_base, pt, rgb, nir, extra.data(), extra_size);
  if (c.wave) std::memcpy(c.wave + out_base * 29, wave, 29);
  if (count == 1) return 0;

  U32 n_layers = L14_COUNT + (has_rgb ? 1 : 0) + (has_nir ? 1 : 0) +
                 (has_wave ? 1 : 0) + extra_size;
  if (nbytes < raw + 4ull * n_layers) return -1;
  std::vector<U32> sizes(n_layers);
  std::memcpy(sizes.data(), buf + raw, 4ull * n_layers);
  U64 total = raw + 4ull * n_layers;
  std::vector<const U8*> start(n_layers);
  for (U32 i = 0; i < n_layers; i++) {
    start[i] = buf + total;
    total += sizes[i];
    if (total > nbytes) return -1;
  }

  Point14v3Reader rd;
  rd.init(pt, start.data(), sizes.data());
  Rgb12v2 rgbc;
  Nir14v3 nirc;
  Wave29 wavec;
  Decoder d_rgb, d_nir, d_wave;
  std::vector<Decoder> d_extra(extra_size);
  std::vector<SymbolModel> m_extra(extra_size);
  std::vector<bool> have_extra(extra_size);
  U32 li = L14_COUNT;
  bool have_rgb_layer = false, have_nir_layer = false, have_wave_layer = false;
  if (has_rgb) {
    have_rgb_layer = sizes[li] > 0;
    if (have_rgb_layer) d_rgb.init(start[li], sizes[li]);
    rgbc.init(rgb, false);
    li++;
  }
  if (has_nir) {
    have_nir_layer = sizes[li] > 0;
    if (have_nir_layer) d_nir.init(start[li], sizes[li]);
    nirc.init(nir, false);
    li++;
  }
  if (has_wave) {
    have_wave_layer = sizes[li] > 0;
    if (have_wave_layer) d_wave.init(start[li], sizes[li]);
    wavec.init(wave, false);
    li++;
  }
  std::vector<U8> last_extra(extra.begin(), extra.end());
  for (U32 b = 0; b < extra_size; b++, li++) {
    have_extra[b] = sizes[li] > 0;
    if (have_extra[b]) d_extra[b].init(start[li], sizes[li]);
    m_extra[b].init(256, false);
  }

  for (I64 i = 1; i < count; i++) {
    rd.read(pt);
    if (has_rgb && have_rgb_layer) rgbc.read(d_rgb, rgb);
    if (has_nir && have_nir_layer) nirc.read(d_nir, nir);
    if (has_wave && have_wave_layer) wavec.read(d_wave, wave);
    for (U32 b = 0; b < extra_size; b++) {
      if (have_extra[b]) {
        U32 v = d_extra[b].decodeSymbol(m_extra[b]);
        last_extra[b] = u8_fold((I32)v + (I32)last_extra[b]);
      }
      extra[b] = last_extra[b];
    }
    store_point14(c, out_base + i, pt, rgb, nir, extra.data(), extra_size);
    if (c.wave) std::memcpy(c.wave + (out_base + i) * 29, wave, 29);
  }
  return 0;
}

// encode `count` points from columns[in_base..] into a v3 layered chunk
static void encode_chunk14(std::vector<U8>& out, I64 count, const Columns14& c,
                           I64 in_base, bool has_rgb, bool has_nir,
                           bool has_wave, U32 extra_size) {
  Point14 pt{};
  U16 rgb[3] = {0, 0, 0};
  U16 nir = 0;
  const U8* extra = nullptr;
  std::vector<U8> zero_extra(extra_size ? extra_size : 1, 0);
  extra = zero_extra.data();

  load_point14(c, in_base, pt, rgb, nir, &extra, extra_size);
  const U8* wave = c.wave ? c.wave + in_base * 29 : kZeroWave;
  write_raw_point14(out, pt);
  if (has_rgb) {
    size_t base = out.size();
    out.resize(base + 6);
    std::memcpy(out.data() + base, rgb, 6);
  }
  if (has_nir) {
    size_t base = out.size();
    out.resize(base + 2);
    std::memcpy(out.data() + base, &nir, 2);
  }
  if (has_wave) out.insert(out.end(), wave, wave + 29);
  if (extra_size) out.insert(out.end(), extra, extra + extra_size);
  if (count == 1) return;

  Point14v3Writer wr;
  wr.init(pt);
  Rgb12v2 rgbc;
  Nir14v3 nirc;
  Wave29 wavec;
  Encoder e_rgb, e_nir, e_wave;
  std::vector<Encoder> e_extra(extra_size);
  std::vector<SymbolModel> m_extra(extra_size);
  std::vector<U8> last_extra(extra, extra + (extra_size ? extra_size : 0));
  if (has_rgb) {
    rgbc.init(rgb, true);
    e_rgb.init();
  }
  if (has_nir) {
    nirc.init(nir, true);
    e_nir.init();
  }
  if (has_wave) {
    wavec.init(wave, true);
    e_wave.init();
  }
  for (U32 b = 0; b < extra_size; b++) {
    e_extra[b].init();
    m_extra[b].init(256, true);
  }

  for (I64 i = 1; i < count; i++) {
    load_point14(c, in_base + i, pt, rgb, nir, &extra, extra_size);
    wr.write(pt);
    if (has_rgb) rgbc.write(e_rgb, rgb);
    if (has_nir) nirc.write(e_nir, nir);
    if (has_wave) wavec.write(e_wave, c.wave ? c.wave + (in_base + i) * 29 : kZeroWave);
    for (U32 b = 0; b < extra_size; b++) {
      e_extra[b].encodeSymbol(m_extra[b], u8_fold((I32)extra[b] - (I32)last_extra[b]));
      last_extra[b] = extra[b];
    }
  }

  // finalize layers, emit [u32 sizes][streams]; gated layers never used
  // emit 0 bytes (the reader keeps last values)
  U32 n_layers = L14_COUNT + (has_rgb ? 1 : 0) + (has_nir ? 1 : 0) +
                 (has_wave ? 1 : 0) + extra_size;
  std::vector<std::vector<U8>*> streams;
  std::vector<std::vector<U8>> empty_keeper;
  empty_keeper.reserve(L14_COUNT);  // stable addresses for the pointers below
  for (int i = 0; i < L14_COUNT; i++) {
    if (wr.used[i]) {
      wr.e[i].done();
      streams.push_back(&wr.e[i].out);
    } else {
      empty_keeper.emplace_back();
      streams.push_back(&empty_keeper.back());
    }
  }
  if (has_rgb) {
    e_rgb.done();
    streams.push_back(&e_rgb.out);
  }
  if (has_nir) {
    e_nir.done();
    streams.push_back(&e_nir.out);
  }
  if (has_wave) {
    e_wave.done();
    streams.push_back(&e_wave.out);
  }
  for (U32 b = 0; b < extra_size; b++) {
    e_extra[b].done();
    streams.push_back(&e_extra[b].out);
  }
  (void)n_layers;
  size_t base = out.size();
  out.resize(base + 4ull * streams.size());
  for (size_t i = 0; i < streams.size(); i++) {
    U32 sz = (U32)streams[i]->size();
    std::memcpy(out.data() + base + 4 * i, &sz, 4);
  }
  for (auto* s : streams) out.insert(out.end(), s->begin(), s->end());
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Decode the arithmetic-coded chunk table that chunk_table_offset points at.
// Returns number of chunks, filling chunk_byte_sizes (caller-sized to
// max_chunks); -1 on error.
int64_t aqpc_laz_read_chunk_table(const uint8_t* table, size_t nbytes,
                                  uint64_t* chunk_byte_sizes,
                                  int64_t max_chunks) {
  if (nbytes < 8) return -1;
  U32 version, num;
  std::memcpy(&version, table, 4);
  std::memcpy(&num, table + 4, 4);
  if (version != 0) return -1;
  if ((int64_t)num > max_chunks) return -1;
  Decoder d;
  d.init(table + 8, nbytes - 8);
  IntegerCompressor ic;
  ic.init(32, 2, false);
  U32 prev = 0;
  for (U32 i = 0; i < num; i++) {
    U32 sz = (U32)ic.decompress(d, (I32)prev, 1);
    chunk_byte_sizes[i] = sz;
    prev = sz;
  }
  return (int64_t)num;
}

// Encode a chunk table; returns bytes written into out (caller-sized) or -1.
int64_t aqpc_laz_write_chunk_table(const uint64_t* chunk_byte_sizes,
                                   int64_t num_chunks, uint8_t* out,
                                   size_t out_cap) {
  Encoder e;
  e.init();
  IntegerCompressor ic;
  ic.init(32, 2, true);
  U32 prev = 0;
  for (int64_t i = 0; i < num_chunks; i++) {
    ic.compress(e, (I32)prev, (I32)(U32)chunk_byte_sizes[i], 1);
    prev = (U32)chunk_byte_sizes[i];
  }
  e.done();
  size_t total = 8 + e.out.size();
  if (total > out_cap) return -1;
  U32 version = 0, num = (U32)num_chunks;
  std::memcpy(out, &version, 4);
  std::memcpy(out + 4, &num, 4);
  std::memcpy(out + 8, e.out.data(), e.out.size());
  return (int64_t)total;
}

// Decode chunks [first, first+n) in parallel. chunk_offsets are absolute
// into `file`; chunk i holds `chunk_size` points except possibly the last
// overall chunk. Output columns receive point j of chunk i at
// (first+i)*chunk_size + j - out_point_offset... simplified: outputs are
// sized for exactly the decoded range and chunk i writes at i*chunk_size.
// Returns 0, or 1-based index of the first failed chunk.
int64_t aqpc_laz_decode_chunks(
    const uint8_t* file, size_t file_size, const uint64_t* chunk_offsets,
    const uint64_t* chunk_sizes_bytes, const int64_t* chunk_point_counts,
    const int64_t* out_offsets, int64_t n_chunks, int32_t* x, int32_t* y,
    int32_t* z, uint16_t* intensity, uint8_t* bit_byte,
    uint8_t* classification, int8_t* scan_angle, uint8_t* user_data,
    uint16_t* point_source, double* gps_time, uint16_t* rgb, uint8_t* wave,
    uint8_t* extra, int64_t extra_size, int32_t has_gps, int32_t has_rgb,
    int32_t has_wave, int64_t n_threads) {
  Columns cols{x, y, z, intensity, bit_byte, classification, scan_angle,
               user_data, point_source, has_gps ? gps_time : nullptr,
               has_rgb ? rgb : nullptr, has_wave ? wave : nullptr,
               extra_size ? extra : nullptr};
  std::vector<int64_t> fail(n_chunks, 0);
  auto work = [&](int64_t i) {
    U64 off = chunk_offsets[i];
    U64 sz = chunk_sizes_bytes[i];
    if (off + sz > file_size) {
      fail[i] = 1;
      return;
    }
    int r = decode_chunk(file + off, sz, chunk_point_counts[i], cols,
                         out_offsets[i], has_gps != 0, has_rgb != 0,
                         has_wave != 0, (U32)extra_size);
    if (r != 0) fail[i] = 1;
  };
  if (n_threads <= 1 || n_chunks <= 1) {
    for (int64_t i = 0; i < n_chunks; i++) work(i);
  } else {
    int64_t nt = n_threads < n_chunks ? n_threads : n_chunks;
    std::vector<std::thread> threads;
    std::vector<int64_t> counter(1, 0);
    for (int64_t t = 0; t < nt; t++) {
      threads.emplace_back([&, t]() {
        for (int64_t i = t; i < n_chunks; i += nt) work(i);
      });
    }
    for (auto& th : threads) th.join();
  }
  for (int64_t i = 0; i < n_chunks; i++)
    if (fail[i]) return i + 1;
  return 0;
}

// Encode n_points from SoA columns into LAZ chunks. Writes the concatenated
// chunk bytes into out (caller-allocated, out_cap), the per-chunk byte sizes
// into chunk_sizes_bytes (caller-sized to ceil(n/chunk_size)). Returns total
// bytes written or -1 on overflow. Chunks are encoded in parallel.
int64_t aqpc_laz_encode_chunks(
    const int32_t* x, const int32_t* y, const int32_t* z,
    const uint16_t* intensity, const uint8_t* bit_byte,
    const uint8_t* classification, const int8_t* scan_angle,
    const uint8_t* user_data, const uint16_t* point_source,
    const double* gps_time, const uint16_t* rgb, const uint8_t* wave,
    const uint8_t* extra, int64_t extra_size, int32_t has_gps,
    int32_t has_rgb, int32_t has_wave, int64_t n_points,
    int64_t chunk_size, uint8_t* out, size_t out_cap,
    uint64_t* chunk_sizes_bytes, int64_t n_threads) {
  Columns cols{(I32*)x, (I32*)y, (I32*)z, (U16*)intensity, (U8*)bit_byte,
               (U8*)classification, (I8*)scan_angle, (U8*)user_data,
               (U16*)point_source, has_gps ? (double*)gps_time : nullptr,
               has_rgb ? (U16*)rgb : nullptr, has_wave ? (U8*)wave : nullptr,
               extra_size ? (U8*)extra : nullptr};
  int64_t n_chunks = (n_points + chunk_size - 1) / chunk_size;
  std::vector<std::vector<U8>> bufs(n_chunks);
  auto work = [&](int64_t i) {
    I64 start = i * chunk_size;
    I64 count = std::min<I64>(chunk_size, n_points - start);
    encode_chunk(bufs[i], count, cols, start, has_gps != 0, has_rgb != 0,
                 has_wave != 0, (U32)extra_size);
  };
  if (n_threads <= 1 || n_chunks <= 1) {
    for (int64_t i = 0; i < n_chunks; i++) work(i);
  } else {
    int64_t nt = n_threads < n_chunks ? n_threads : n_chunks;
    std::vector<std::thread> threads;
    for (int64_t t = 0; t < nt; t++)
      threads.emplace_back([&, t]() {
        for (int64_t i = t; i < n_chunks; i += nt) work(i);
      });
    for (auto& th : threads) th.join();
  }
  size_t total = 0;
  for (int64_t i = 0; i < n_chunks; i++) {
    chunk_sizes_bytes[i] = bufs[i].size();
    total += bufs[i].size();
  }
  if (total > out_cap) return -1;
  size_t pos = 0;
  for (int64_t i = 0; i < n_chunks; i++) {
    std::memcpy(out + pos, bufs[i].data(), bufs[i].size());
    pos += bufs[i].size();
  }
  return (int64_t)total;
}


// -- variable-size chunk tables (chunk_size == u32::MAX in the VLR): the
// table holds (point count, byte size) per chunk, both delta-coded with the
// same IntegerCompressor (context 0 = counts, 1 = sizes).
int64_t aqpc_laz_read_chunk_table_var(const uint8_t* table, size_t nbytes,
                                      int64_t* chunk_point_counts,
                                      uint64_t* chunk_byte_sizes,
                                      int64_t max_chunks) {
  if (nbytes < 8) return -1;
  U32 version, num;
  std::memcpy(&version, table, 4);
  std::memcpy(&num, table + 4, 4);
  if (version != 0) return -1;
  if ((int64_t)num > max_chunks) return -1;
  Decoder d;
  d.init(table + 8, nbytes - 8);
  IntegerCompressor ic;
  ic.init(32, 2, false);
  U32 prev_count = 0, prev_size = 0;
  for (U32 i = 0; i < num; i++) {
    U32 cnt = (U32)ic.decompress(d, (I32)prev_count, 0);
    U32 sz = (U32)ic.decompress(d, (I32)prev_size, 1);
    chunk_point_counts[i] = cnt;
    chunk_byte_sizes[i] = sz;
    prev_count = cnt;
    prev_size = sz;
  }
  return (int64_t)num;
}

int64_t aqpc_laz_write_chunk_table_var(const int64_t* chunk_point_counts,
                                       const uint64_t* chunk_byte_sizes,
                                       int64_t num_chunks, uint8_t* out,
                                       size_t out_cap) {
  Encoder e;
  e.init();
  IntegerCompressor ic;
  ic.init(32, 2, true);
  U32 prev_count = 0, prev_size = 0;
  for (int64_t i = 0; i < num_chunks; i++) {
    ic.compress(e, (I32)prev_count, (I32)(U32)chunk_point_counts[i], 0);
    ic.compress(e, (I32)prev_size, (I32)(U32)chunk_byte_sizes[i], 1);
    prev_count = (U32)chunk_point_counts[i];
    prev_size = (U32)chunk_byte_sizes[i];
  }
  e.done();
  size_t total = 8 + e.out.size();
  if (total > out_cap) return -1;
  U32 version = 0, num = (U32)num_chunks;
  std::memcpy(out, &version, 4);
  std::memcpy(out + 4, &num, 4);
  std::memcpy(out + 8, e.out.data(), e.out.size());
  return (int64_t)total;
}

// -- LAS 1.4 / LASzip v3 layered chunks (point formats 6-8 + extra bytes) --

int64_t aqpc_laz14_decode_chunks(
    const uint8_t* file, size_t file_size, const uint64_t* chunk_offsets,
    const uint64_t* chunk_sizes_bytes, const int64_t* chunk_point_counts,
    const int64_t* out_offsets, int64_t n_chunks, int32_t* x, int32_t* y,
    int32_t* z, uint16_t* intensity, uint8_t* returns_byte,
    uint8_t* flags_byte, uint8_t* classification, uint8_t* user_data,
    int16_t* scan_angle, uint16_t* point_source, double* gps_time,
    uint16_t* rgb, uint16_t* nir, uint8_t* wave, uint8_t* extra,
    int64_t extra_size, int32_t has_rgb, int32_t has_nir, int32_t has_wave,
    int64_t n_threads) {
  Columns14 cols{x, y, z, intensity, returns_byte, flags_byte, classification,
                 user_data, (I16*)scan_angle, point_source, gps_time,
                 has_rgb ? rgb : nullptr, has_nir ? nir : nullptr,
                 has_wave ? wave : nullptr, extra_size ? extra : nullptr};
  std::vector<int64_t> fail(n_chunks, 0);
  auto work = [&](int64_t i) {
    U64 off = chunk_offsets[i];
    U64 sz = chunk_sizes_bytes[i];
    if (off + sz > file_size) {
      fail[i] = 1;
      return;
    }
    int r = decode_chunk14(file + off, sz, chunk_point_counts[i], cols,
                           out_offsets[i], has_rgb != 0, has_nir != 0,
                           has_wave != 0, (U32)extra_size);
    if (r != 0) fail[i] = 1;
  };
  if (n_threads <= 1 || n_chunks <= 1) {
    for (int64_t i = 0; i < n_chunks; i++) work(i);
  } else {
    int64_t nt = n_threads < n_chunks ? n_threads : n_chunks;
    std::vector<std::thread> threads;
    for (int64_t t = 0; t < nt; t++)
      threads.emplace_back([&, t]() {
        for (int64_t i = t; i < n_chunks; i += nt) work(i);
      });
    for (auto& th : threads) th.join();
  }
  for (int64_t i = 0; i < n_chunks; i++)
    if (fail[i]) return i + 1;
  return 0;
}

int64_t aqpc_laz14_encode_chunks(
    const int32_t* x, const int32_t* y, const int32_t* z,
    const uint16_t* intensity, const uint8_t* returns_byte,
    const uint8_t* flags_byte, const uint8_t* classification,
    const uint8_t* user_data, const int16_t* scan_angle,
    const uint16_t* point_source, const double* gps_time, const uint16_t* rgb,
    const uint16_t* nir, const uint8_t* wave, const uint8_t* extra,
    int64_t extra_size, int32_t has_rgb, int32_t has_nir, int32_t has_wave,
    int64_t n_points, int64_t chunk_size,
    uint8_t* out, size_t out_cap, uint64_t* chunk_sizes_bytes,
    int64_t n_threads) {
  Columns14 cols{(I32*)x, (I32*)y, (I32*)z, (U16*)intensity, (U8*)returns_byte,
                 (U8*)flags_byte, (U8*)classification, (U8*)user_data,
                 (I16*)scan_angle, (U16*)point_source, (double*)gps_time,
                 has_rgb ? (U16*)rgb : nullptr, has_nir ? (U16*)nir : nullptr,
                 has_wave ? (U8*)wave : nullptr,
                 extra_size ? (U8*)extra : nullptr};
  int64_t n_chunks = (n_points + chunk_size - 1) / chunk_size;
  std::vector<std::vector<U8>> bufs(n_chunks);
  auto work = [&](int64_t i) {
    I64 start = i * chunk_size;
    I64 count = std::min<I64>(chunk_size, n_points - start);
    encode_chunk14(bufs[i], count, cols, start, has_rgb != 0, has_nir != 0,
                   has_wave != 0, (U32)extra_size);
  };
  if (n_threads <= 1 || n_chunks <= 1) {
    for (int64_t i = 0; i < n_chunks; i++) work(i);
  } else {
    int64_t nt = n_threads < n_chunks ? n_threads : n_chunks;
    std::vector<std::thread> threads;
    for (int64_t t = 0; t < nt; t++)
      threads.emplace_back([&, t]() {
        for (int64_t i = t; i < n_chunks; i += nt) work(i);
      });
    for (auto& th : threads) th.join();
  }
  size_t total = 0;
  for (int64_t i = 0; i < n_chunks; i++) {
    chunk_sizes_bytes[i] = bufs[i].size();
    total += bufs[i].size();
  }
  if (total > out_cap) return -1;
  size_t pos = 0;
  for (int64_t i = 0; i < n_chunks; i++) {
    std::memcpy(out + pos, bufs[i].data(), bufs[i].size());
    pos += bufs[i].size();
  }
  return (int64_t)total;
}

}  // extern "C"
