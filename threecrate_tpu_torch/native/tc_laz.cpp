// LASzip 2.x codec (compressor 2, "pointwise chunked") for LAS point
// formats 0-3 — the native backend of threecrate_tpu.io.las LAZ
// support. The reference gates LAZ behind its `las_laz` cargo feature
// (threecrate-io/Cargo.toml:14, backed by pasture/laz-rs); here the
// codec is implemented directly from the published LASzip design
// (Isenburg, "LASzip: lossless compression of LiDAR data", PE&RS 2013;
// entropy stage = Amir Said's FastAC arithmetic coder):
//
//   * adaptive arithmetic coder, 32-bit renormalisation;
//   * IntegerCompressor: correctors coded as (k, k-bit offset) pairs;
//   * item codecs v2: POINT10 (xyz/intensity/flag bytes via streaming
//     medians + return-map contexts), GPSTIME11 (multi-sequence delta
//     multipliers), RGB12 (per-byte difference models);
//   * chunked stream: each chunk starts with one raw record, models
//     reset per chunk, chunk table arithmetic-coded at the end.
//
// Decompression runs chunks in parallel (std::thread) — chunks are
// independent by construction, which the reference's sequential
// laszip-style readers leave on the table.
//
// Round-trip (compress -> decompress) is bit-exact and covered by
// tests/test_io_extra.py. Cross-tool interop cannot be validated in
// this offline environment (no laszip binary, no sample .laz corpus);
// the container layout (VLR 22204, chunk table) follows the spec.

#include <cstdint>
#include <cstring>
#include <vector>
#include <memory>
#include <thread>
#include <algorithm>

typedef uint8_t U8;  typedef uint16_t U16; typedef uint32_t U32;
typedef uint64_t U64;
typedef int8_t I8;   typedef int16_t I16;  typedef int32_t I32;
typedef int64_t I64;

static const U32 AC_MinLength = 0x01000000u;
static const U32 AC_MaxLength = 0xFFFFFFFFu;
static const U32 DM_LengthShift = 15;
static const U32 DM_MaxCount = 1u << DM_LengthShift;
static const U32 BM_LengthShift = 13;
static const U32 BM_MaxCount = 1u << BM_LengthShift;

static inline U8 u8_fold(I32 v) { return (U8)(v & 0xFF); }
static inline U8 u8_clamp(I32 v) {
  return v < 0 ? 0 : (v > 255 ? 255 : (U8)v);
}

// ---------------------------------------------------------------------------
// adaptive models
// ---------------------------------------------------------------------------

struct BitModel {
  U32 bit_0_prob, bit_0_count, bit_count, update_cycle, bits_until_update;
  void init() {
    bit_0_count = 1; bit_count = 2;
    bit_0_prob = 1u << (BM_LengthShift - 1);
    update_cycle = bits_until_update = 4;
  }
  void update() {
    if ((bit_count += update_cycle) > BM_MaxCount) {
      bit_count = (bit_count + 1) >> 1;
      bit_0_count = (bit_0_count + 1) >> 1;
      if (bit_0_count == bit_count) ++bit_count;
    }
    U32 scale = 0x80000000u / bit_count;
    bit_0_prob = (bit_0_count * scale) >> (31 - BM_LengthShift);
    update_cycle = (5 * update_cycle) >> 2;
    if (update_cycle > 64) update_cycle = 64;
    bits_until_update = update_cycle;
  }
};

struct SymModel {
  U32 symbols = 0, last_symbol = 0, table_size = 0, table_shift = 0;
  U32 total_count = 0, update_cycle = 0, symbols_until_update = 0;
  bool decode = false;
  std::vector<U32> distribution, symbol_count, decoder_table;

  void init(U32 n_symbols, bool for_decoder) {
    symbols = n_symbols;
    last_symbol = n_symbols - 1;
    decode = for_decoder;
    if (for_decoder && symbols > 16) {
      U32 table_bits = 3;
      while (symbols > (1u << (table_bits + 2))) ++table_bits;
      table_size = 1u << table_bits;
      table_shift = DM_LengthShift - table_bits;
      decoder_table.assign(table_size + 2, 0);
    } else {
      table_size = table_shift = 0;
      decoder_table.clear();
    }
    distribution.assign(symbols, 0);
    symbol_count.assign(symbols, 1);
    total_count = 0;
    update_cycle = symbols;
    update();
    symbols_until_update = update_cycle = (symbols + 6) >> 1;
  }

  void update() {
    if ((total_count += update_cycle) > DM_MaxCount) {
      total_count = 0;
      for (U32 n = 0; n < symbols; n++)
        total_count += (symbol_count[n] = (symbol_count[n] + 1) >> 1);
    }
    U32 sum = 0, s = 0;
    U32 scale = 0x80000000u / total_count;
    if (table_size == 0) {
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

// ---------------------------------------------------------------------------
// arithmetic encoder / decoder (FastAC)
// ---------------------------------------------------------------------------

struct Encoder {
  std::vector<U8>* out = nullptr;
  size_t start = 0;            // out offset where this stream began
  U32 base = 0, length = AC_MaxLength;

  void init(std::vector<U8>* o) {
    out = o; start = o->size(); base = 0; length = AC_MaxLength;
  }
  void propagate_carry() {
    size_t p = out->size();
    while (p > start) {
      --p;
      if ((*out)[p] == 0xFF) { (*out)[p] = 0; }
      else { (*out)[p]++; return; }
    }
  }
  void renorm() {
    do {
      out->push_back((U8)(base >> 24));
      base <<= 8;
    } while ((length <<= 8) < AC_MinLength);
  }
  void encodeBit(BitModel& m, U32 bit) {
    U32 x = m.bit_0_prob * (length >> BM_LengthShift);
    if (bit == 0) { length = x; m.bit_0_count++; }
    else {
      U32 init_base = base;
      base += x; length -= x;
      if (init_base > base) propagate_carry();
    }
    if (length < AC_MinLength) renorm();
    if (--m.bits_until_update == 0) m.update();
  }
  void encodeSymbol(SymModel& m, U32 sym) {
    U32 x, init_base = base;
    if (sym == m.last_symbol) {
      x = m.distribution[sym] * (length >> DM_LengthShift);
      base += x; length -= x;
    } else {
      x = m.distribution[sym] * (length >>= DM_LengthShift);
      base += x;
      length = m.distribution[sym + 1] * length - x;
    }
    if (init_base > base) propagate_carry();
    if (length < AC_MinLength) renorm();
    m.symbol_count[sym]++;
    if (--m.symbols_until_update == 0) m.update();
  }
  void writeBits(U32 bits, U32 sym) {
    if (bits > 19) {
      writeBits(16, sym & 0xFFFF);
      sym >>= 16; bits -= 16;
    }
    U32 init_base = base;
    base += sym * (length >>= bits);
    if (init_base > base) propagate_carry();
    if (length < AC_MinLength) renorm();
  }
  void writeInt(U32 v) { writeBits(16, v & 0xFFFF); writeBits(16, v >> 16); }
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
  }
};

struct Decoder {
  const U8* buf = nullptr;
  I64 pos = 0, end = 0;
  U32 value = 0, length = 0;

  U8 getByte() { return pos < end ? buf[pos++] : 0; }
  void init(const U8* b, I64 p, I64 e) {
    buf = b; pos = p; end = e;
    value = ((U32)getByte() << 24) | ((U32)getByte() << 16)
          | ((U32)getByte() << 8) | getByte();
    length = AC_MaxLength;
  }
  void renorm() {
    do { value = (value << 8) | getByte(); }
    while ((length <<= 8) < AC_MinLength);
  }
  U32 decodeBit(BitModel& m) {
    U32 x = m.bit_0_prob * (length >> BM_LengthShift);
    U32 sym = (value >= x);
    if (sym == 0) { length = x; m.bit_0_count++; }
    else { value -= x; length -= x; }
    if (length < AC_MinLength) renorm();
    if (--m.bits_until_update == 0) m.update();
    return sym;
  }
  U32 decodeSymbol(SymModel& m) {
    U32 n, sym, x, y = length;
    if (!m.decoder_table.empty()) {
      U32 dv = value / (length >>= DM_LengthShift);
      U32 t = dv >> m.table_shift;
      if (t > m.table_size) t = m.table_size;   // corrupt-stream guard
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
        if (z > value) { n = k; y = z; }
        else { sym = k; x = z; }
      } while ((k = (sym + n) >> 1) != sym);
    }
    value -= x; length = y - x;
    if (length < AC_MinLength) renorm();
    m.symbol_count[sym]++;
    if (--m.symbols_until_update == 0) m.update();
    return sym;
  }
  U32 readBits(U32 bits) {
    if (bits > 19) {
      U32 lo = readBits(16);
      U32 hi = readBits(bits - 16) << 16;
      return hi | lo;
    }
    U32 sym = value / (length >>= bits);
    value -= length * sym;
    if (length < AC_MinLength) renorm();
    return sym;
  }
  U32 readInt() {
    U32 lo = readBits(16);
    U32 hi = readBits(16);
    return (hi << 16) | lo;
  }
};

// ---------------------------------------------------------------------------
// IntegerCompressor
// ---------------------------------------------------------------------------

struct IntComp {
  U32 bits = 32, contexts = 1, bits_high = 8;
  U32 corr_bits = 32, corr_range = 0;
  I32 corr_min = INT32_MIN;
  U32 k = 0;
  std::vector<SymModel> mBits, mCorr;
  BitModel mCorr0;

  void init(U32 bits_, U32 contexts_, bool for_decoder) {
    bits = bits_; contexts = contexts_;
    if (bits && bits < 32) {
      corr_bits = bits;
      corr_range = 1u << bits;
      corr_min = -(I32)(corr_range / 2);
    } else {
      corr_bits = 32; corr_range = 0; corr_min = INT32_MIN;
    }
    mBits.resize(contexts);
    for (U32 c = 0; c < contexts; c++)
      mBits[c].init(corr_bits + 1, for_decoder);
    mCorr0.init();
    mCorr.resize(corr_bits + 1);
    for (U32 i = 1; i <= corr_bits; i++)
      mCorr[i].init(i <= bits_high ? (1u << i) : (1u << bits_high),
                    for_decoder);
  }

  // ---- decompression ----
  I32 readCorrector(Decoder& dec, SymModel& model) {
    I32 c;
    k = dec.decodeSymbol(model);
    if (k) {
      if (k < 32) {
        if (k <= bits_high) {
          c = (I32)dec.decodeSymbol(mCorr[k]);
        } else {
          U32 k1 = k - bits_high;
          c = (I32)dec.decodeSymbol(mCorr[k]);
          U32 c1 = dec.readBits(k1);
          c = (I32)(((U32)c << k1) | c1);
        }
        if (c >= (1 << (k - 1))) c += 1;
        else c -= ((1 << k) - 1);
      } else {
        c = corr_min;
      }
    } else {
      c = (I32)dec.decodeBit(mCorr0);
    }
    return c;
  }
  I32 decompress(Decoder& dec, I32 pred, U32 context) {
    I32 real = (I32)((U32)pred + (U32)readCorrector(dec, mBits[context]));
    if (corr_range) {
      if (real < 0) real += (I32)corr_range;
      else if ((U32)real >= corr_range) real -= (I32)corr_range;
    }
    return real;
  }

  // ---- compression ----
  void writeCorrector(Encoder& enc, I32 c, SymModel& model) {
    U32 c1 = (c <= 0 ? (U32)(-(I64)c) : (U32)(c - 1));
    for (k = 0; c1; k++) c1 >>= 1;
    enc.encodeSymbol(model, k);
    if (k) {
      if (k < 32) {
        if (c >= 0) c -= 1;                 // [2^(k-1), 2^k - 1]
        else c += ((1 << k) - 1);           // [0, 2^(k-1) - 1]
        if (k <= bits_high) {
          enc.encodeSymbol(mCorr[k], (U32)c);
        } else {
          U32 k1 = k - bits_high;
          U32 lo = (U32)c & ((1u << k1) - 1);
          enc.encodeSymbol(mCorr[k], (U32)c >> k1);
          enc.writeBits(k1, lo);
        }
      }
      // k == 32: corrector is corr_min, nothing more to code
    } else {
      enc.encodeBit(mCorr0, (U32)c);
    }
  }
  void compress(Encoder& enc, I32 pred, I32 real, U32 context) {
    I32 corr = (I32)((U32)real - (U32)pred);
    if (corr_range) {
      if (corr < corr_min) corr += (I32)corr_range;
      else if (corr > corr_min + (I32)corr_range - 1) corr -= (I32)corr_range;
    }
    writeCorrector(enc, corr, mBits[context]);
  }
};

// ---------------------------------------------------------------------------
// POINT10 v2
// ---------------------------------------------------------------------------

struct Pt10 {
  I32 x, y, z;
  U16 intensity;
  U8 flags;        // return:3 | number:3 | scan_dir:1 | edge:1
  U8 cls;
  I8 sar;          // scan angle rank
  U8 user;
  U16 psid;
};

static void pt10_from_raw(const U8* p, Pt10& o) {
  std::memcpy(&o.x, p, 4); std::memcpy(&o.y, p + 4, 4);
  std::memcpy(&o.z, p + 8, 4);
  std::memcpy(&o.intensity, p + 12, 2);
  o.flags = p[14]; o.cls = p[15]; o.sar = (I8)p[16]; o.user = p[17];
  std::memcpy(&o.psid, p + 18, 2);
}
static void pt10_to_raw(const Pt10& o, U8* p) {
  std::memcpy(p, &o.x, 4); std::memcpy(p + 4, &o.y, 4);
  std::memcpy(p + 8, &o.z, 4);
  std::memcpy(p + 12, &o.intensity, 2);
  p[14] = o.flags; p[15] = o.cls; p[16] = (U8)o.sar; p[17] = o.user;
  std::memcpy(p + 18, &o.psid, 2);
}

static const U8 NUMBER_RETURN_MAP[8][8] = {
  { 15, 14, 13, 12, 11, 10,  9,  8 },
  { 14,  0,  1,  3,  6, 10, 10,  9 },
  { 13,  1,  2,  4,  7, 11, 11, 10 },
  { 12,  3,  4,  5,  8, 12, 12, 11 },
  { 11,  6,  7,  8,  9, 13, 13, 12 },
  { 10, 10, 11, 12, 13, 14, 14, 13 },
  {  9, 10, 11, 12, 13, 14, 15, 14 },
  {  8,  9, 10, 11, 12, 13, 14, 15 }
};
static const U8 NUMBER_RETURN_LEVEL[8][8] = {
  { 0, 1, 2, 3, 4, 5, 6, 7 },
  { 1, 0, 1, 2, 3, 4, 5, 6 },
  { 2, 1, 0, 1, 2, 3, 4, 5 },
  { 3, 2, 1, 0, 1, 2, 3, 4 },
  { 4, 3, 2, 1, 0, 1, 2, 3 },
  { 5, 4, 3, 2, 1, 0, 1, 2 },
  { 6, 5, 4, 3, 2, 1, 0, 1 },
  { 7, 6, 5, 4, 3, 2, 1, 0 }
};

struct StreamingMedian5 {
  I32 values[5];
  bool high;
  void init() { values[0]=values[1]=values[2]=values[3]=values[4]=0; high=true; }
  void add(I32 v) {
    if (high) {
      if (v < values[2]) {
        values[4] = values[3]; values[3] = values[2];
        if (v < values[0]) {
          values[2] = values[1]; values[1] = values[0]; values[0] = v;
        } else if (v < values[1]) {
          values[2] = values[1]; values[1] = v;
        } else {
          values[2] = v;
        }
      } else {
        if (v < values[3]) { values[4] = values[3]; values[3] = v; }
        else { values[4] = v; }
        high = false;
      }
    } else {
      if (values[2] < v) {
        values[0] = values[1]; values[1] = values[2];
        if (values[4] < v) {
          values[2] = values[3]; values[3] = values[4]; values[4] = v;
        } else if (values[3] < v) {
          values[2] = values[3]; values[3] = v;
        } else {
          values[2] = v;
        }
      } else {
        if (values[1] < v) { values[0] = values[1]; values[1] = v; }
        else { values[0] = v; }
        high = true;
      }
    }
  }
  I32 get() const { return values[2]; }
};

struct Point10v2 {
  bool dec_side;
  Pt10 last;
  U16 last_intensity[16];
  StreamingMedian5 med_x[16], med_y[16];
  I32 last_height[8];
  SymModel m_changed;
  SymModel m_sar[2];
  std::unique_ptr<SymModel> m_bit_byte[256], m_cls[256], m_user[256];
  IntComp ic_intensity, ic_psid, ic_dx, ic_dy, ic_z;

  void init(const Pt10& first, bool for_decoder) {
    dec_side = for_decoder;
    last = first;
    for (int i = 0; i < 16; i++) {
      last_intensity[i] = 0; med_x[i].init(); med_y[i].init();
    }
    for (int i = 0; i < 8; i++) last_height[i] = 0;
    m_changed.init(64, for_decoder);
    m_sar[0].init(256, for_decoder);
    m_sar[1].init(256, for_decoder);
    for (int i = 0; i < 256; i++) {
      m_bit_byte[i].reset(); m_cls[i].reset(); m_user[i].reset();
    }
    ic_intensity.init(16, 4, for_decoder);
    ic_psid.init(16, 1, for_decoder);
    ic_dx.init(32, 2, for_decoder);
    ic_dy.init(32, 22, for_decoder);
    ic_z.init(32, 20, for_decoder);
  }

  SymModel& lazy(std::unique_ptr<SymModel>* arr, U8 idx) {
    if (!arr[idx]) {
      arr[idx] = std::make_unique<SymModel>();
      arr[idx]->init(256, dec_side);
    }
    return *arr[idx];
  }

  void decode(Decoder& dec, Pt10& out) {
    U32 changed = dec.decodeSymbol(m_changed);
    U32 r, n, m, l;
    if (changed) {
      if (changed & 32)
        last.flags = (U8)dec.decodeSymbol(lazy(m_bit_byte, last.flags));
      r = last.flags & 7;
      n = (last.flags >> 3) & 7;
      m = NUMBER_RETURN_MAP[n][r];
      l = NUMBER_RETURN_LEVEL[n][r];
      if (changed & 16) {
        last.intensity = (U16)ic_intensity.decompress(
            dec, last_intensity[m], m < 3 ? m : 3);
        last_intensity[m] = last.intensity;
      } else {
        last.intensity = last_intensity[m];
      }
      if (changed & 8)
        last.cls = (U8)dec.decodeSymbol(lazy(m_cls, last.cls));
      if (changed & 4) {
        U32 f = (last.flags >> 6) & 1;
        U32 val = dec.decodeSymbol(m_sar[f]);
        last.sar = (I8)u8_fold((I32)val + (I32)(U8)last.sar);
      }
      if (changed & 2)
        last.user = (U8)dec.decodeSymbol(lazy(m_user, last.user));
      if (changed & 1)
        last.psid = (U16)ic_psid.decompress(dec, last.psid, 0);
    } else {
      r = last.flags & 7;
      n = (last.flags >> 3) & 7;
      m = NUMBER_RETURN_MAP[n][r];
      l = NUMBER_RETURN_LEVEL[n][r];
    }
    I32 median = med_x[m].get();
    I32 diff = ic_dx.decompress(dec, median, n == 1);
    last.x = (I32)((U32)last.x + (U32)diff);
    med_x[m].add(diff);

    median = med_y[m].get();
    U32 k_bits = ic_dx.k;
    diff = ic_dy.decompress(
        dec, median,
        (n == 1) + (k_bits < 20 ? (k_bits & ~1u) : 20));
    last.y = (I32)((U32)last.y + (U32)diff);
    med_y[m].add(diff);

    k_bits = (ic_dx.k + ic_dy.k) / 2;
    last.z = ic_z.decompress(
        dec, last_height[l],
        (n == 1) + (k_bits < 18 ? (k_bits & ~1u) : 18));
    last_height[l] = last.z;
    out = last;
  }

  void encode(Encoder& enc, const Pt10& item) {
    U32 r = item.flags & 7;
    U32 n = (item.flags >> 3) & 7;
    U32 m = NUMBER_RETURN_MAP[n][r];
    U32 l = NUMBER_RETURN_LEVEL[n][r];
    U32 changed =
        (((U32)(last.flags != item.flags)) << 5) |
        (((U32)(last_intensity[m] != item.intensity)) << 4) |
        (((U32)(last.cls != item.cls)) << 3) |
        (((U32)(last.sar != item.sar)) << 2) |
        (((U32)(last.user != item.user)) << 1) |
        ((U32)(last.psid != item.psid));
    enc.encodeSymbol(m_changed, changed);
    if (changed & 32) {
      enc.encodeSymbol(lazy(m_bit_byte, last.flags), item.flags);
      last.flags = item.flags;
    }
    if (changed & 16) {
      ic_intensity.compress(enc, last_intensity[m], item.intensity,
                            m < 3 ? m : 3);
      last_intensity[m] = item.intensity;
    }
    last.intensity = item.intensity;
    if (changed & 8) {
      enc.encodeSymbol(lazy(m_cls, last.cls), item.cls);
      last.cls = item.cls;
    }
    if (changed & 4) {
      U32 f = (item.flags >> 6) & 1;
      enc.encodeSymbol(m_sar[f],
                       u8_fold((I32)(U8)item.sar - (I32)(U8)last.sar));
      last.sar = item.sar;
    }
    if (changed & 2) {
      enc.encodeSymbol(lazy(m_user, last.user), item.user);
      last.user = item.user;
    }
    if (changed & 1) {
      ic_psid.compress(enc, last.psid, item.psid, 0);
      last.psid = item.psid;
    }

    I32 median = med_x[m].get();
    I32 diff = (I32)((U32)item.x - (U32)last.x);
    ic_dx.compress(enc, median, diff, n == 1);
    med_x[m].add(diff);
    last.x = item.x;

    median = med_y[m].get();
    U32 k_bits = ic_dx.k;
    diff = (I32)((U32)item.y - (U32)last.y);
    ic_dy.compress(enc, median, diff,
                   (n == 1) + (k_bits < 20 ? (k_bits & ~1u) : 20));
    med_y[m].add(diff);
    last.y = item.y;

    k_bits = (ic_dx.k + ic_dy.k) / 2;
    ic_z.compress(enc, last_height[l], item.z,
                  (n == 1) + (k_bits < 18 ? (k_bits & ~1u) : 18));
    last_height[l] = item.z;
    last.z = item.z;
  }
};

// ---------------------------------------------------------------------------
// GPSTIME11 v2
// ---------------------------------------------------------------------------

static const I32 GPS_MULTI = 500;
static const I32 GPS_MULTI_MINUS = -10;
static const I32 GPS_MULTI_UNCHANGED = GPS_MULTI - GPS_MULTI_MINUS + 1;  // 511
static const I32 GPS_MULTI_CODE_FULL = GPS_MULTI - GPS_MULTI_MINUS + 2;  // 512
static const I32 GPS_MULTI_TOTAL = GPS_MULTI - GPS_MULTI_MINUS + 6;      // 516

union I64F64 { I64 i64; U64 u64; double f64; };

struct GpsTime11v2 {
  U32 last_idx, next_idx;
  I64F64 last_gpstime[4];
  I32 last_diff[4];
  I32 extreme_counter[4];
  SymModel m_multi, m_0diff;
  IntComp ic;

  void init(double first, bool for_decoder) {
    last_idx = next_idx = 0;
    for (int i = 0; i < 4; i++) {
      last_gpstime[i].f64 = 0.0; last_diff[i] = 0; extreme_counter[i] = 0;
    }
    last_gpstime[0].f64 = first;
    m_multi.init(GPS_MULTI_TOTAL, for_decoder);
    m_0diff.init(6, for_decoder);
    ic.init(32, 9, for_decoder);
  }

  double decode(Decoder& dec) {
    I32 multi;
    if (last_diff[last_idx] == 0) {
      multi = (I32)dec.decodeSymbol(m_0diff);
      if (multi == 1) {
        last_diff[last_idx] = ic.decompress(dec, 0, 0);
        last_gpstime[last_idx].i64 += last_diff[last_idx];
        extreme_counter[last_idx] = 0;
      } else if (multi == 2) {
        next_idx = (next_idx + 1) & 3;
        last_gpstime[next_idx].u64 =
            ((U64)(U32)ic.decompress(
                dec, (I32)(last_gpstime[last_idx].u64 >> 32), 8)) << 32;
        last_gpstime[next_idx].u64 |= dec.readInt();
        last_idx = next_idx;
        last_diff[last_idx] = 0;
        extreme_counter[last_idx] = 0;
      } else if (multi > 2) {
        last_idx = (last_idx + multi - 2) & 3;
        return decode(dec);
      }
      // multi == 0: unchanged
    } else {
      multi = (I32)dec.decodeSymbol(m_multi);
      if (multi == 1) {
        last_gpstime[last_idx].i64 +=
            ic.decompress(dec, last_diff[last_idx], 1);
        extreme_counter[last_idx] = 0;
      } else if (multi < GPS_MULTI_UNCHANGED) {
        I32 diff;
        if (multi == 0) {
          diff = ic.decompress(dec, 0, 7);
          extreme_counter[last_idx]++;
          if (extreme_counter[last_idx] > 3) {
            last_diff[last_idx] = diff;
            extreme_counter[last_idx] = 0;
          }
        } else if (multi < GPS_MULTI) {
          diff = ic.decompress(dec, multi * last_diff[last_idx],
                               multi < 10 ? 2 : 3);
        } else if (multi == GPS_MULTI) {
          diff = ic.decompress(dec, GPS_MULTI * last_diff[last_idx], 4);
          extreme_counter[last_idx]++;
          if (extreme_counter[last_idx] > 3) {
            last_diff[last_idx] = diff;
            extreme_counter[last_idx] = 0;
          }
        } else {
          I32 am = GPS_MULTI - multi;           // -1 .. -10
          if (am == GPS_MULTI_MINUS) {
            diff = ic.decompress(dec, GPS_MULTI_MINUS * last_diff[last_idx],
                                 5);
            extreme_counter[last_idx]++;
            if (extreme_counter[last_idx] > 3) {
              last_diff[last_idx] = diff;
              extreme_counter[last_idx] = 0;
            }
          } else {
            diff = ic.decompress(dec, am * last_diff[last_idx], 6);
          }
        }
        last_gpstime[last_idx].i64 += diff;
      } else if (multi == GPS_MULTI_UNCHANGED) {
        // unchanged
      } else if (multi == GPS_MULTI_CODE_FULL) {
        next_idx = (next_idx + 1) & 3;
        last_gpstime[next_idx].u64 =
            ((U64)(U32)ic.decompress(
                dec, (I32)(last_gpstime[last_idx].u64 >> 32), 8)) << 32;
        last_gpstime[next_idx].u64 |= dec.readInt();
        last_idx = next_idx;
        last_diff[last_idx] = 0;
        extreme_counter[last_idx] = 0;
      } else {  // switch sequence
        last_idx = (last_idx + multi - GPS_MULTI_CODE_FULL) & 3;
        return decode(dec);
      }
    }
    return last_gpstime[last_idx].f64;
  }

  void encode(Encoder& enc, double gps) {
    I64F64 cur; cur.f64 = gps;
    if (last_diff[last_idx] == 0) {
      if (cur.i64 == last_gpstime[last_idx].i64) {
        enc.encodeSymbol(m_0diff, 0);
        return;
      }
      I64 d64 = cur.i64 - last_gpstime[last_idx].i64;
      I32 d32 = (I32)d64;
      if ((I64)d32 == d64) {
        enc.encodeSymbol(m_0diff, 1);
        ic.compress(enc, 0, d32, 0);
        last_diff[last_idx] = d32;
        last_gpstime[last_idx].i64 = cur.i64;
        extreme_counter[last_idx] = 0;
        return;
      }
      for (U32 i = 1; i < 4; i++) {
        I64 od = cur.i64 - last_gpstime[(last_idx + i) & 3].i64;
        if ((I64)(I32)od == od) {
          enc.encodeSymbol(m_0diff, i + 2);
          last_idx = (last_idx + i) & 3;
          encode(enc, gps);
          return;
        }
      }
      enc.encodeSymbol(m_0diff, 2);
      ic.compress(enc, (I32)(last_gpstime[last_idx].u64 >> 32),
                  (I32)(cur.u64 >> 32), 8);
      enc.writeInt((U32)(cur.u64 & 0xFFFFFFFFu));
      next_idx = (next_idx + 1) & 3;
      last_idx = next_idx;
      last_gpstime[last_idx].i64 = cur.i64;
      last_diff[last_idx] = 0;
      extreme_counter[last_idx] = 0;
    } else {
      if (cur.i64 == last_gpstime[last_idx].i64) {
        enc.encodeSymbol(m_multi, GPS_MULTI_UNCHANGED);
        return;
      }
      I64 d64 = cur.i64 - last_gpstime[last_idx].i64;
      I32 d32 = (I32)d64;
      if ((I64)d32 == d64) {
        float mf = (float)d32 / (float)last_diff[last_idx];
        I32 multi = mf >= 0.0f ? (I32)(mf + 0.5f) : (I32)(mf - 0.5f);
        if (multi == 1) {
          enc.encodeSymbol(m_multi, 1);
          ic.compress(enc, last_diff[last_idx], d32, 1);
          extreme_counter[last_idx] = 0;
        } else if (multi == 0) {
          enc.encodeSymbol(m_multi, 0);
          ic.compress(enc, 0, d32, 7);
          extreme_counter[last_idx]++;
          if (extreme_counter[last_idx] > 3) {
            last_diff[last_idx] = d32;
            extreme_counter[last_idx] = 0;
          }
        } else if (multi > 0) {
          if (multi >= GPS_MULTI) {
            enc.encodeSymbol(m_multi, GPS_MULTI);
            ic.compress(enc, GPS_MULTI * last_diff[last_idx], d32, 4);
            extreme_counter[last_idx]++;
            if (extreme_counter[last_idx] > 3) {
              last_diff[last_idx] = d32;
              extreme_counter[last_idx] = 0;
            }
          } else {
            enc.encodeSymbol(m_multi, multi);
            ic.compress(enc, multi * last_diff[last_idx], d32,
                        multi < 10 ? 2 : 3);
          }
        } else {  // multi < 0
          if (multi <= GPS_MULTI_MINUS) {
            enc.encodeSymbol(m_multi, GPS_MULTI - GPS_MULTI_MINUS);  // 510
            ic.compress(enc, GPS_MULTI_MINUS * last_diff[last_idx], d32, 5);
            extreme_counter[last_idx]++;
            if (extreme_counter[last_idx] > 3) {
              last_diff[last_idx] = d32;
              extreme_counter[last_idx] = 0;
            }
          } else {
            enc.encodeSymbol(m_multi, GPS_MULTI - multi);  // 501..509
            ic.compress(enc, multi * last_diff[last_idx], d32, 6);
          }
        }
        last_gpstime[last_idx].i64 = cur.i64;
        return;
      }
      for (U32 i = 1; i < 4; i++) {
        I64 od = cur.i64 - last_gpstime[(last_idx + i) & 3].i64;
        if ((I64)(I32)od == od) {
          enc.encodeSymbol(m_multi, GPS_MULTI_CODE_FULL + (I32)i);
          last_idx = (last_idx + i) & 3;
          encode(enc, gps);
          return;
        }
      }
      enc.encodeSymbol(m_multi, GPS_MULTI_CODE_FULL);
      ic.compress(enc, (I32)(last_gpstime[last_idx].u64 >> 32),
                  (I32)(cur.u64 >> 32), 8);
      enc.writeInt((U32)(cur.u64 & 0xFFFFFFFFu));
      next_idx = (next_idx + 1) & 3;
      last_idx = next_idx;
      last_gpstime[last_idx].i64 = cur.i64;
      last_diff[last_idx] = 0;
      extreme_counter[last_idx] = 0;
    }
  }
};

// ---------------------------------------------------------------------------
// RGB12 v2
// ---------------------------------------------------------------------------

struct Rgb12v2 {
  U16 last[3];
  SymModel m_used;
  SymModel m_diff[6];

  void init(const U16* first, bool for_decoder) {
    last[0] = first[0]; last[1] = first[1]; last[2] = first[2];
    m_used.init(128, for_decoder);
    for (int i = 0; i < 6; i++) m_diff[i].init(256, for_decoder);
  }

  void decode(Decoder& dec, U16* out) {
    U32 sym = dec.decodeSymbol(m_used);
    U16 r, g, b;
    I32 corr, diff = 0;
    if (sym & 1) {
      corr = (I32)dec.decodeSymbol(m_diff[0]);
      r = u8_fold(corr + (last[0] & 0xFF));
    } else r = last[0] & 0xFF;
    if (sym & 2) {
      corr = (I32)dec.decodeSymbol(m_diff[1]);
      r |= (U16)u8_fold(corr + (last[0] >> 8)) << 8;
    } else r |= last[0] & 0xFF00;
    if (sym & 64) {
      diff = (r & 0xFF) - (last[0] & 0xFF);
      if (sym & 4) {
        corr = (I32)dec.decodeSymbol(m_diff[2]);
        g = u8_fold(corr + u8_clamp(diff + (last[1] & 0xFF)));
      } else g = last[1] & 0xFF;
      if (sym & 16) {
        diff = (diff + (g & 0xFF) - (last[1] & 0xFF)) / 2;
        corr = (I32)dec.decodeSymbol(m_diff[4]);
        b = u8_fold(corr + u8_clamp(diff + (last[2] & 0xFF)));
      } else b = last[2] & 0xFF;
      diff = (r >> 8) - (last[0] >> 8);
      if (sym & 8) {
        corr = (I32)dec.decodeSymbol(m_diff[3]);
        g |= (U16)u8_fold(corr + u8_clamp(diff + (last[1] >> 8))) << 8;
      } else g |= last[1] & 0xFF00;
      if (sym & 32) {
        diff = (diff + (g >> 8) - (last[1] >> 8)) / 2;
        corr = (I32)dec.decodeSymbol(m_diff[5]);
        b |= (U16)u8_fold(corr + u8_clamp(diff + (last[2] >> 8))) << 8;
      } else b |= last[2] & 0xFF00;
    } else {
      g = r; b = r;
    }
    out[0] = last[0] = r; out[1] = last[1] = g; out[2] = last[2] = b;
  }

  void encode(Encoder& enc, const U16* item) {
    U16 r = item[0], g = item[1], b = item[2];
    bool gb_differ = ((r & 0xFF) != (g & 0xFF)) || ((r & 0xFF) != (b & 0xFF))
                  || ((r >> 8) != (g >> 8)) || ((r >> 8) != (b >> 8));
    U32 sym = ((U32)gb_differ) << 6;
    if ((r & 0xFF) != (last[0] & 0xFF)) sym |= 1;
    if ((r >> 8) != (last[0] >> 8)) sym |= 2;
    if (gb_differ) {
      if ((g & 0xFF) != (last[1] & 0xFF)) sym |= 4;
      if ((g >> 8) != (last[1] >> 8)) sym |= 8;
      if ((b & 0xFF) != (last[2] & 0xFF)) sym |= 16;
      if ((b >> 8) != (last[2] >> 8)) sym |= 32;
    }
    enc.encodeSymbol(m_used, sym);
    I32 diff = 0;
    if (sym & 1)
      enc.encodeSymbol(m_diff[0], u8_fold((r & 0xFF) - (last[0] & 0xFF)));
    if (sym & 2)
      enc.encodeSymbol(m_diff[1], u8_fold((r >> 8) - (last[0] >> 8)));
    if (sym & 64) {
      diff = (r & 0xFF) - (last[0] & 0xFF);
      if (sym & 4)
        enc.encodeSymbol(m_diff[2],
            u8_fold((I32)(g & 0xFF) - u8_clamp(diff + (last[1] & 0xFF))));
      if (sym & 16) {
        diff = (diff + (g & 0xFF) - (last[1] & 0xFF)) / 2;
        enc.encodeSymbol(m_diff[4],
            u8_fold((I32)(b & 0xFF) - u8_clamp(diff + (last[2] & 0xFF))));
      }
      diff = (r >> 8) - (last[0] >> 8);
      if (sym & 8)
        enc.encodeSymbol(m_diff[3],
            u8_fold((I32)(g >> 8) - u8_clamp(diff + (last[1] >> 8))));
      if (sym & 32) {
        diff = (diff + (g >> 8) - (last[1] >> 8)) / 2;
        enc.encodeSymbol(m_diff[5],
            u8_fold((I32)(b >> 8) - u8_clamp(diff + (last[2] >> 8))));
      }
    }
    last[0] = r; last[1] = g; last[2] = b;
  }
};

// ---------------------------------------------------------------------------
// record layout per LAS point format
// ---------------------------------------------------------------------------

struct Layout {
  bool has_gps = false, has_rgb = false;
  int gps_off = 0, rgb_off = 0, rec_len = 20;
};

static bool layout_for(int fmt, Layout& lo) {
  switch (fmt) {
    case 0: lo = {false, false, 0, 0, 20}; return true;
    case 1: lo = {true, false, 20, 0, 28}; return true;
    case 2: lo = {false, true, 0, 20, 26}; return true;
    case 3: lo = {true, true, 20, 28, 34}; return true;
    default: return false;
  }
}

// ---------------------------------------------------------------------------
// chunk codec
// ---------------------------------------------------------------------------

static void decode_chunk(const U8* buf, I64 start, I64 buf_end,
                         I64 n_pts, const Layout& lo, U8* out) {
  if (n_pts <= 0 || start + lo.rec_len > buf_end) return;
  // raw first record
  std::memcpy(out, buf + start, lo.rec_len);
  if (n_pts == 1) return;

  Pt10 first;
  pt10_from_raw(buf + start, first);
  Point10v2 p10; p10.init(first, true);
  GpsTime11v2 gps;
  Rgb12v2 rgb;
  if (lo.has_gps) {
    double g; std::memcpy(&g, buf + start + lo.gps_off, 8);
    gps.init(g, true);
  }
  if (lo.has_rgb) {
    U16 c[3]; std::memcpy(c, buf + start + lo.rgb_off, 6);
    rgb.init(c, true);
  }
  Decoder dec;
  dec.init(buf, start + lo.rec_len, buf_end);
  for (I64 i = 1; i < n_pts; i++) {
    U8* rec = out + i * lo.rec_len;
    Pt10 pt;
    p10.decode(dec, pt);
    pt10_to_raw(pt, rec);
    if (lo.has_gps) {
      double g = gps.decode(dec);
      std::memcpy(rec + lo.gps_off, &g, 8);
    }
    if (lo.has_rgb) {
      U16 c[3];
      rgb.decode(dec, c);
      std::memcpy(rec + lo.rgb_off, c, 6);
    }
  }
}

static void encode_chunk(const U8* records, I64 n_pts, const Layout& lo,
                         std::vector<U8>& out) {
  if (n_pts <= 0) return;
  out.insert(out.end(), records, records + lo.rec_len);  // raw first
  if (n_pts == 1) return;

  Pt10 first;
  pt10_from_raw(records, first);
  Point10v2 p10; p10.init(first, false);
  GpsTime11v2 gps;
  Rgb12v2 rgb;
  if (lo.has_gps) {
    double g; std::memcpy(&g, records + lo.gps_off, 8);
    gps.init(g, false);
  }
  if (lo.has_rgb) {
    U16 c[3]; std::memcpy(c, records + lo.rgb_off, 6);
    rgb.init(c, false);
  }
  Encoder enc;
  enc.init(&out);
  for (I64 i = 1; i < n_pts; i++) {
    const U8* rec = records + i * lo.rec_len;
    Pt10 pt;
    pt10_from_raw(rec, pt);
    p10.encode(enc, pt);
    if (lo.has_gps) {
      double g; std::memcpy(&g, rec + lo.gps_off, 8);
      gps.encode(enc, g);
    }
    if (lo.has_rgb) {
      U16 c[3]; std::memcpy(c, rec + lo.rgb_off, 6);
      rgb.encode(enc, c);
    }
  }
  enc.done();
}

// ---------------------------------------------------------------------------
// entry points
// ---------------------------------------------------------------------------

extern "C" {

// Decompress the LAZ point-data block of `file` (whole file buffer).
// point_off: absolute offset of the point data (the i64 chunk-table
// pointer lives there). Returns 0, or a negative error code.
long tc_laz_decompress(const U8* file, long file_len, long point_off,
                       long n_points, unsigned chunk_size, int fmt,
                       U8* out, int rec_len) {
  Layout lo;
  if (!layout_for(fmt, lo) || lo.rec_len != rec_len) return -3;
  if (point_off + 8 > file_len) return -1;
  if (n_points == 0) return 0;
  if (chunk_size == 0) return -1;

  I64 table_pos;
  std::memcpy(&table_pos, file + point_off, 8);
  if (table_pos < 0 || table_pos + 8 > file_len) return -2;

  U32 version, n_chunks;
  std::memcpy(&version, file + table_pos, 4);
  std::memcpy(&n_chunks, file + table_pos + 4, 4);
  if (version != 0) return -2;
  I64 expected = (n_points + (I64)chunk_size - 1) / (I64)chunk_size;
  if ((I64)n_chunks < expected || n_chunks > (1u << 30)) return -2;

  std::vector<U32> sizes(n_chunks);
  {
    Decoder dec;
    dec.init(file, table_pos + 8, file_len);
    IntComp ic;
    ic.init(32, 2, true);
    for (U32 i = 0; i < n_chunks; i++)
      sizes[i] = (U32)ic.decompress(dec, i ? (I32)sizes[i - 1] : 0, 1);
  }
  std::vector<I64> starts(n_chunks + 1);
  starts[0] = point_off + 8;
  for (U32 i = 0; i < n_chunks; i++) starts[i + 1] = starts[i] + sizes[i];
  if (starts[n_chunks] > file_len) return -2;

  // independent chunks → parallel decode
  unsigned hw = std::thread::hardware_concurrency();
  unsigned n_threads = std::min<unsigned>(hw ? hw : 1, (unsigned)expected);
  std::vector<std::thread> workers;
  for (unsigned t = 0; t < n_threads; t++) {
    workers.emplace_back([&, t]() {
      for (I64 c = t; c < expected; c += n_threads) {
        I64 first_pt = c * (I64)chunk_size;
        I64 cnt = std::min<I64>(chunk_size, n_points - first_pt);
        decode_chunk(file, starts[c], file_len, cnt, lo,
                     out + first_pt * lo.rec_len);
      }
    });
  }
  for (auto& w : workers) w.join();
  return 0;
}

// Compress n_points records into a LAZ point-data block:
// [i64 abs chunk-table pos][chunks...][chunk table]. block_file_off is
// the absolute file offset where the block will be placed (so the
// table pointer can be absolute, as LASzip stores it). Returns the
// block length, or a negative error code (-4: out_cap too small).
long tc_laz_compress(const U8* records, long n_points, int rec_len,
                     int fmt, unsigned chunk_size, long block_file_off,
                     U8* out, long out_cap) {
  Layout lo;
  if (!layout_for(fmt, lo) || lo.rec_len != rec_len) return -3;
  if (chunk_size == 0) return -1;
  I64 n_chunks = (n_points + (I64)chunk_size - 1) / (I64)chunk_size;

  std::vector<std::vector<U8>> chunks((size_t)n_chunks);
  unsigned hw = std::thread::hardware_concurrency();
  unsigned n_threads = std::min<unsigned>(hw ? hw : 1,
                                          (unsigned)std::max<I64>(n_chunks, 1));
  std::vector<std::thread> workers;
  for (unsigned t = 0; t < n_threads; t++) {
    workers.emplace_back([&, t]() {
      for (I64 c = t; c < n_chunks; c += n_threads) {
        I64 first_pt = c * (I64)chunk_size;
        I64 cnt = std::min<I64>(chunk_size, n_points - first_pt);
        encode_chunk(records + first_pt * lo.rec_len, cnt, lo,
                     chunks[(size_t)c]);
      }
    });
  }
  for (auto& w : workers) w.join();

  // chunk table
  std::vector<U8> table(8, 0);  // u32 version=0, u32 n_chunks
  U32 nc32 = (U32)n_chunks;
  std::memcpy(table.data() + 4, &nc32, 4);
  {
    Encoder enc;
    enc.init(&table);
    IntComp ic;
    ic.init(32, 2, false);
    for (I64 i = 0; i < n_chunks; i++)
      ic.compress(enc, i ? (I32)(U32)chunks[(size_t)i - 1].size() : 0,
                  (I32)(U32)chunks[(size_t)i].size(), 1);
    enc.done();
  }

  I64 total = 8;
  for (auto& c : chunks) total += (I64)c.size();
  I64 table_pos_abs = block_file_off + total;
  total += (I64)table.size();
  if (total > out_cap) return -4;

  std::memcpy(out, &table_pos_abs, 8);
  I64 off = 8;
  for (auto& c : chunks) {
    std::memcpy(out + off, c.data(), c.size());
    off += (I64)c.size();
  }
  std::memcpy(out + off, table.data(), table.size());
  return (long)total;
}

}  // extern "C"
