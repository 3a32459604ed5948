// fennec-tpu native runtime: JPEG entropy codec + PNG scanline filters.
//
// The device (JAX/XLA) owns all array math; this library owns the
// sequential byte-twiddling the reference did in compiled Go: baseline
// JPEG Huffman encode/decode (ITU T.81) and PNG filter/unfilter.
// Exposed via a C ABI consumed through ctypes (fennec_tpu/native/build.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdlib>

namespace {

// ── Zigzag ──────────────────────────────────────────────────────────────────
const int kZigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ── Standard Huffman specs (T.81 Annex K.3) ────────────────────────────────
const uint8_t kDcLumaBits[16] = {0,1,5,1,1,1,1,1,1,0,0,0,0,0,0,0};
const uint8_t kDcLumaVals[12] = {0,1,2,3,4,5,6,7,8,9,10,11};
const uint8_t kDcChromaBits[16] = {0,3,1,1,1,1,1,1,1,1,1,0,0,0,0,0};
const uint8_t kDcChromaVals[12] = {0,1,2,3,4,5,6,7,8,9,10,11};
const uint8_t kAcLumaBits[16] = {0,2,1,3,3,2,4,3,5,5,4,4,0,0,1,0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01,0x02,0x03,0x00,0x04,0x11,0x05,0x12,0x21,0x31,0x41,0x06,0x13,0x51,
    0x61,0x07,0x22,0x71,0x14,0x32,0x81,0x91,0xa1,0x08,0x23,0x42,0xb1,0xc1,
    0x15,0x52,0xd1,0xf0,0x24,0x33,0x62,0x72,0x82,0x09,0x0a,0x16,0x17,0x18,
    0x19,0x1a,0x25,0x26,0x27,0x28,0x29,0x2a,0x34,0x35,0x36,0x37,0x38,0x39,
    0x3a,0x43,0x44,0x45,0x46,0x47,0x48,0x49,0x4a,0x53,0x54,0x55,0x56,0x57,
    0x58,0x59,0x5a,0x63,0x64,0x65,0x66,0x67,0x68,0x69,0x6a,0x73,0x74,0x75,
    0x76,0x77,0x78,0x79,0x7a,0x83,0x84,0x85,0x86,0x87,0x88,0x89,0x8a,0x92,
    0x93,0x94,0x95,0x96,0x97,0x98,0x99,0x9a,0xa2,0xa3,0xa4,0xa5,0xa6,0xa7,
    0xa8,0xa9,0xaa,0xb2,0xb3,0xb4,0xb5,0xb6,0xb7,0xb8,0xb9,0xba,0xc2,0xc3,
    0xc4,0xc5,0xc6,0xc7,0xc8,0xc9,0xca,0xd2,0xd3,0xd4,0xd5,0xd6,0xd7,0xd8,
    0xd9,0xda,0xe1,0xe2,0xe3,0xe4,0xe5,0xe6,0xe7,0xe8,0xe9,0xea,0xf1,0xf2,
    0xf3,0xf4,0xf5,0xf6,0xf7,0xf8,0xf9,0xfa};
const uint8_t kAcChromaBits[16] = {0,2,1,2,4,4,3,4,7,5,4,4,0,1,2,0x77};
const uint8_t kAcChromaVals[162] = {
    0x00,0x01,0x02,0x03,0x11,0x04,0x05,0x21,0x31,0x06,0x12,0x41,0x51,0x07,
    0x61,0x71,0x13,0x22,0x32,0x81,0x08,0x14,0x42,0x91,0xa1,0xb1,0xc1,0x09,
    0x23,0x33,0x52,0xf0,0x15,0x62,0x72,0xd1,0x0a,0x16,0x24,0x34,0xe1,0x25,
    0xf1,0x17,0x18,0x19,0x1a,0x26,0x27,0x28,0x29,0x2a,0x35,0x36,0x37,0x38,
    0x39,0x3a,0x43,0x44,0x45,0x46,0x47,0x48,0x49,0x4a,0x53,0x54,0x55,0x56,
    0x57,0x58,0x59,0x5a,0x63,0x64,0x65,0x66,0x67,0x68,0x69,0x6a,0x73,0x74,
    0x75,0x76,0x77,0x78,0x79,0x7a,0x82,0x83,0x84,0x85,0x86,0x87,0x88,0x89,
    0x8a,0x92,0x93,0x94,0x95,0x96,0x97,0x98,0x99,0x9a,0xa2,0xa3,0xa4,0xa5,
    0xa6,0xa7,0xa8,0xa9,0xaa,0xb2,0xb3,0xb4,0xb5,0xb6,0xb7,0xb8,0xb9,0xba,
    0xc2,0xc3,0xc4,0xc5,0xc6,0xc7,0xc8,0xc9,0xca,0xd2,0xd3,0xd4,0xd5,0xd6,
    0xd7,0xd8,0xd9,0xda,0xe2,0xe3,0xe4,0xe5,0xe6,0xe7,0xe8,0xe9,0xea,0xf2,
    0xf3,0xf4,0xf5,0xf6,0xf7,0xf8,0xf9,0xfa};

// Encode tables: symbol -> (code, length).
struct EncTable {
  uint16_t code[256];
  uint8_t len[256];
};

void build_enc_table(const uint8_t *bits, const uint8_t *vals, EncTable *t) {
  std::memset(t->len, 0, sizeof(t->len));
  uint16_t code = 0;
  int k = 0;
  for (int length = 1; length <= 16; length++) {
    for (int i = 0; i < bits[length - 1]; i++) {
      t->code[vals[k]] = code;
      t->len[vals[k]] = (uint8_t)length;
      code++;
      k++;
    }
    code <<= 1;
  }
}

struct StdTables {
  EncTable dc_luma, ac_luma, dc_chroma, ac_chroma;
  StdTables() {
    build_enc_table(kDcLumaBits, kDcLumaVals, &dc_luma);
    build_enc_table(kAcLumaBits, kAcLumaVals, &ac_luma);
    build_enc_table(kDcChromaBits, kDcChromaVals, &dc_chroma);
    build_enc_table(kAcChromaBits, kAcChromaVals, &ac_chroma);
  }
};
const StdTables &std_tables() {
  static StdTables t;
  return t;
}

// ── Bit writer with 0xFF stuffing ───────────────────────────────────────────
struct BitWriter {
  uint8_t *out;
  long cap;
  long pos;
  uint64_t acc;
  int nbits;
  bool overflow;

  BitWriter(uint8_t *o, long c)
      : out(o), cap(c), pos(0), acc(0), nbits(0), overflow(false) {}

  inline void put_byte(uint8_t b) {
    if (pos >= cap) { overflow = true; return; }
    out[pos++] = b;
    if (b == 0xFF) {
      if (pos >= cap) { overflow = true; return; }
      out[pos++] = 0x00;
    }
  }

  inline void write(uint32_t code, int len) {
    acc = (acc << len) | (code & ((1u << len) - 1));
    nbits += len;
    while (nbits >= 8) {
      nbits -= 8;
      put_byte((uint8_t)((acc >> nbits) & 0xFF));
    }
  }

  void flush() {
    if (nbits > 0) {
      int pad = 8 - nbits;
      write((1u << pad) - 1, pad);
    }
  }

  void emit_marker(uint8_t m) {
    flush();
    if (pos + 2 > cap) { overflow = true; return; }
    out[pos++] = 0xFF;
    out[pos++] = m;
  }
};

inline int magnitude_size(int v) {
  unsigned a = (unsigned)(v < 0 ? -v : v);
  int s = 0;
  while (a) { s++; a >>= 1; }
  return s;
}

// Encode one block; returns new DC predictor.
inline int encode_block(BitWriter &w, const int32_t *block, int pred,
                        const EncTable &dc, const EncTable &ac) {
  int dc_val = block[0];
  int diff = dc_val - pred;
  int size = magnitude_size(diff);
  w.write(dc.code[size], dc.len[size]);
  if (size) {
    int bits = diff >= 0 ? diff : diff + (1 << size) - 1;
    w.write((uint32_t)bits, size);
  }
  int run = 0;
  for (int i = 1; i < 64; i++) {
    int v = block[kZigzag[i]];
    if (v == 0) { run++; continue; }
    while (run >= 16) {
      w.write(ac.code[0xF0], ac.len[0xF0]);
      run -= 16;
    }
    int s = magnitude_size(v);
    int sym = (run << 4) | s;
    w.write(ac.code[sym], ac.len[sym]);
    int bits = v >= 0 ? v : v + (1 << s) - 1;
    w.write((uint32_t)bits, s);
    run = 0;
  }
  if (run > 0) w.write(ac.code[0x00], ac.len[0x00]);
  return dc_val;
}

// ── Huffman decode tables ───────────────────────────────────────────────────
struct DecTable {
  // Fast path: 8-bit lookup -> (value, length); slow path canonical.
  int16_t fast_val[256];
  uint8_t fast_len[256];
  int32_t maxcode[17];
  int32_t mincode[17];
  int32_t valptr[17];
  uint8_t vals[256];
  int nvals;

  // Returns false (table unusable) when the file-supplied DHT is
  // inconsistent or oversized — vals[] is 256 bytes and a crafted BITS
  // array can claim up to 16*255 values, so the bound must be enforced
  // here, not trusted from the bitstream.
  bool build(const uint8_t *bits, const uint8_t *values, int n) {
    int total = 0;
    for (int i = 0; i < 16; i++) total += bits[i];
    if (n < 0 || n > 256 || total != n) return false;
    nvals = n;
    std::memcpy(vals, values, n);
    int code = 0, k = 0;
    for (int length = 1; length <= 16; length++) {
      if (bits[length - 1] > 0) {
        valptr[length] = k;
        mincode[length] = code;
        code += bits[length - 1];
        k += bits[length - 1];
        maxcode[length] = code - 1;
      } else {
        mincode[length] = 0;
        maxcode[length] = -1;
      }
      code <<= 1;
    }
    // Fast 8-bit LUT.
    for (int i = 0; i < 256; i++) { fast_len[i] = 0; fast_val[i] = -1; }
    code = 0; k = 0;
    for (int length = 1; length <= 8; length++) {
      for (int i = 0; i < bits[length - 1]; i++) {
        int prefix = code << (8 - length);
        int count = 1 << (8 - length);
        for (int j = 0; j < count; j++) {
          fast_val[prefix + j] = values[k];
          fast_len[prefix + j] = (uint8_t)length;
        }
        code++;
        k++;
      }
      code <<= 1;
    }
    return true;
  }
};

// ── Bit reader with 0xFF unstuffing ─────────────────────────────────────────
struct BitReader {
  const uint8_t *data;
  long len;
  long pos;
  uint64_t acc;
  int nbits;
  bool bad;

  BitReader(const uint8_t *d, long l, long p)
      : data(d), len(l), pos(p), acc(0), nbits(0), bad(false) {}

  inline void fill() {
    while (nbits <= 48) {
      uint8_t b = 0;
      if (pos < len) {
        b = data[pos];
        if (b == 0xFF) {
          uint8_t nxt = (pos + 1 < len) ? data[pos + 1] : 0xD9;
          if (nxt == 0x00) {
            pos += 2;
          } else {
            b = 0;  // marker: feed zeros, don't advance
          }
        } else {
          pos++;
        }
      }
      acc = (acc << 8) | b;
      nbits += 8;
    }
  }

  inline uint32_t peek8() {
    if (nbits < 8) fill();
    return (uint32_t)((acc >> (nbits - 8)) & 0xFF);
  }

  inline void drop(int n) { nbits -= n; acc &= ((uint64_t)1 << nbits) - 1; }

  inline uint32_t read_bits(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    nbits -= n;
    uint32_t v = (uint32_t)((acc >> nbits) & (((uint64_t)1 << n) - 1));
    acc &= ((uint64_t)1 << nbits) - 1;
    return v;
  }

  inline int decode(const DecTable &t) {
    uint32_t look = peek8();
    if (t.fast_len[look]) {
      drop(t.fast_len[look]);
      return t.fast_val[look];
    }
    // Slow path: lengths 9..16.
    int code = (int)read_bits(8);
    for (int length = 9; length <= 16; length++) {
      code = (code << 1) | (int)read_bits(1);
      if (t.maxcode[length] >= 0 && code <= t.maxcode[length]) {
        return t.vals[t.valptr[length] + code - t.mincode[length]];
      }
    }
    bad = true;
    return 0;
  }

  // Skip to and consume an RSTn marker.
  void align_to_rst() {
    acc = 0;
    nbits = 0;
    while (pos + 1 < len) {
      if (data[pos] == 0xFF && data[pos + 1] != 0x00) {
        if (data[pos + 1] == 0xFF) { pos++; continue; }  // fill byte (B.1.1.2)
        uint8_t m = data[pos + 1];
        pos += 2;
        if (m < 0xD0 || m > 0xD7) bad = true;
        return;
      }
      pos++;
    }
    bad = true;
  }

  // Permissive variant used by the progressive decoder: discard buffered
  // bits and consume the next marker, whatever it is (mirrors the Python
  // BitReader.align_to_marker / ProgressiveDecoder._restart semantics).
  void align_any() {
    acc = 0;
    nbits = 0;
    while (pos + 1 < len) {
      if (data[pos] == 0xFF && data[pos + 1] == 0xFF) { pos++; continue; }
      if (data[pos] == 0xFF && data[pos + 1] != 0x00) {
        pos += 2;
        return;
      }
      pos++;
    }
  }
};

inline int extend(int v, int size) {
  if (size == 0) return 0;
  if (v < (1 << (size - 1))) return v - (1 << size) + 1;
  return v;
}

}  // namespace

extern "C" {

// Count DC-size and AC-RS symbol frequencies for one scan, per table
// class (0 = luma, 1 = chroma selected by chroma[c]).  dc_freq: 2x16,
// ac_freq: 2x256 (int64, caller-zeroed). Returns 0, or -1 on geometry.
long fennec_jpeg_count_symbols(int ncomp, const int32_t **coefs,
                               const int *bw, const int *bh, const int *hs,
                               const int *vs, const int *chroma,
                               int restart_interval, int64_t *dc_freq,
                               int64_t *ac_freq) {
  if (ncomp < 1 || ncomp > 4) return -1;
  int mcus_x = hs[0] ? bw[0] / hs[0] : 0;
  int mcus_y = vs[0] ? bh[0] / vs[0] : 0;
  for (int c = 0; c < ncomp; c++) {
    if (bw[c] != mcus_x * hs[c] || bh[c] != mcus_y * vs[c]) return -1;
  }
  int pred[4] = {0, 0, 0, 0};
  int mcu_count = 0;
  for (int my = 0; my < mcus_y; my++) {
    for (int mx = 0; mx < mcus_x; mx++) {
      if (restart_interval && mcu_count == restart_interval) {
        mcu_count = 0;
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
      }
      for (int c = 0; c < ncomp; c++) {
        int cls = chroma[c] ? 1 : 0;
        int64_t *dcf = dc_freq + cls * 16;
        int64_t *acf = ac_freq + cls * 256;
        for (int dy = 0; dy < vs[c]; dy++) {
          for (int dx = 0; dx < hs[c]; dx++) {
            int by = my * vs[c] + dy;
            int bx = mx * hs[c] + dx;
            const int32_t *block = coefs[c] + ((long)by * bw[c] + bx) * 64;
            int dc = block[0];
            dcf[magnitude_size(dc - pred[c])]++;
            pred[c] = dc;
            int run = 0;
            for (int i = 1; i < 64; i++) {
              int v = block[kZigzag[i]];
              if (v == 0) { run++; continue; }
              while (run >= 16) { acf[0xF0]++; run -= 16; }
              acf[(run << 4) | magnitude_size(v)]++;
              run = 0;
            }
            if (run > 0) acf[0x00]++;
          }
        }
      }
      mcu_count++;
    }
  }
  return 0;
}

// Encode an interleaved baseline scan with custom Huffman specs.
// dc_bits/ac_bits: 2x16 BITS arrays, dc_vals/ac_vals: flattened VALS with
// per-class counts dc_nvals/ac_nvals (class 0 = luma, 1 = chroma).
long fennec_jpeg_encode_scan_custom(
    int ncomp, const int32_t **coefs, const int *bw, const int *bh,
    const int *hs, const int *vs, const int *chroma, int restart_interval,
    const uint8_t *dc_bits, const uint8_t *dc_vals, const int *dc_nvals,
    const uint8_t *ac_bits, const uint8_t *ac_vals, const int *ac_nvals,
    uint8_t *out, long out_cap) {
  if (ncomp < 1 || ncomp > 4) return -1;
  EncTable dc_t[2], ac_t[2];
  int dc_off = 0, ac_off = 0;
  for (int cls = 0; cls < 2; cls++) {
    build_enc_table(dc_bits + cls * 16, dc_vals + dc_off, &dc_t[cls]);
    build_enc_table(ac_bits + cls * 16, ac_vals + ac_off, &ac_t[cls]);
    dc_off += dc_nvals[cls];
    ac_off += ac_nvals[cls];
  }
  int mcus_x = hs[0] ? bw[0] / hs[0] : 0;
  int mcus_y = vs[0] ? bh[0] / vs[0] : 0;
  for (int c = 0; c < ncomp; c++) {
    if (bw[c] != mcus_x * hs[c] || bh[c] != mcus_y * vs[c]) return -1;
  }
  BitWriter w(out, out_cap);
  int pred[4] = {0, 0, 0, 0};
  int rst_idx = 0;
  int mcu_count = 0;
  for (int my = 0; my < mcus_y; my++) {
    for (int mx = 0; mx < mcus_x; mx++) {
      if (restart_interval && mcu_count == restart_interval) {
        w.emit_marker((uint8_t)(0xD0 + (rst_idx & 7)));
        rst_idx++;
        mcu_count = 0;
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
      }
      for (int c = 0; c < ncomp; c++) {
        int cls = chroma[c] ? 1 : 0;
        for (int dy = 0; dy < vs[c]; dy++) {
          for (int dx = 0; dx < hs[c]; dx++) {
            int by = my * vs[c] + dy;
            int bx = mx * hs[c] + dx;
            const int32_t *block = coefs[c] + ((long)by * bw[c] + bx) * 64;
            pred[c] = encode_block(w, block, pred[c], dc_t[cls], ac_t[cls]);
          }
        }
      }
      mcu_count++;
      if (w.overflow) return -1;
    }
  }
  w.flush();
  if (w.overflow) return -1;
  return w.pos;
}

// Encode an interleaved baseline scan with the standard tables.
// coefs[c]: int32 (bw*bh, 64) natural order raster. Returns bytes written,
// or -1 on overflow / bad geometry.
long fennec_jpeg_encode_scan(int ncomp, const int32_t **coefs,
                             const int *bw, const int *bh, const int *hs,
                             const int *vs, const int *chroma,
                             int restart_interval, uint8_t *out,
                             long out_cap) {
  if (ncomp < 1 || ncomp > 4) return -1;
  const StdTables &t = std_tables();
  int mcus_x = hs[0] ? bw[0] / hs[0] : 0;
  int mcus_y = vs[0] ? bh[0] / vs[0] : 0;
  for (int c = 0; c < ncomp; c++) {
    if (bw[c] != mcus_x * hs[c] || bh[c] != mcus_y * vs[c]) return -1;
  }
  BitWriter w(out, out_cap);
  int pred[4] = {0, 0, 0, 0};
  int rst_idx = 0;
  int mcu_count = 0;

  for (int my = 0; my < mcus_y; my++) {
    for (int mx = 0; mx < mcus_x; mx++) {
      if (restart_interval && mcu_count == restart_interval) {
        w.emit_marker((uint8_t)(0xD0 + (rst_idx & 7)));
        rst_idx++;
        mcu_count = 0;
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
      }
      for (int c = 0; c < ncomp; c++) {
        const EncTable &dc = chroma[c] ? t.dc_chroma : t.dc_luma;
        const EncTable &ac = chroma[c] ? t.ac_chroma : t.ac_luma;
        for (int dy = 0; dy < vs[c]; dy++) {
          for (int dx = 0; dx < hs[c]; dx++) {
            int by = my * vs[c] + dy;
            int bx = mx * hs[c] + dx;
            const int32_t *block = coefs[c] + ((long)by * bw[c] + bx) * 64;
            pred[c] = encode_block(w, block, pred[c], dc, ac);
          }
        }
      }
      mcu_count++;
      if (w.overflow) return -1;
    }
  }
  w.flush();
  if (w.overflow) return -1;
  return w.pos;
}

// Decode an interleaved baseline scan. Tables are passed per component as
// raw (BITS[16], VALS[n]) specs. out[c]: int16 (bw*bh, 64) natural order.
// Returns the byte offset past the scan, or -1 on corrupt data.
long fennec_jpeg_decode_scan(const uint8_t *data, long len, long pos,
                             int ncomp, int16_t **out, const int *bw,
                             const int *bh, const int *hs, const int *vs,
                             const uint8_t *dc_bits, const uint8_t *dc_vals,
                             const int *dc_nvals, const int *dc_voff,
                             const uint8_t *ac_bits, const uint8_t *ac_vals,
                             const int *ac_nvals, const int *ac_voff,
                             int restart_interval) {
  if (ncomp < 1 || ncomp > 4) return -1;
  DecTable dct_[4], act_[4];
  for (int c = 0; c < ncomp; c++) {
    if (!dct_[c].build(dc_bits + c * 16, dc_vals + dc_voff[c],
                       dc_nvals[c]) ||
        !act_[c].build(ac_bits + c * 16, ac_vals + ac_voff[c],
                       ac_nvals[c]))
      return -1;
    std::memset(out[c], 0, (long)bw[c] * bh[c] * 64 * sizeof(int16_t));
  }
  int mcus_x = hs[0] ? bw[0] / hs[0] : 0;
  int mcus_y = vs[0] ? bh[0] / vs[0] : 0;

  BitReader r(data, len, pos);
  int pred[4] = {0, 0, 0, 0};
  int mcu_count = 0;

  for (int my = 0; my < mcus_y; my++) {
    for (int mx = 0; mx < mcus_x; mx++) {
      if (restart_interval && mcu_count == restart_interval) {
        r.align_to_rst();
        if (r.bad) return -1;
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
        mcu_count = 0;
      }
      for (int c = 0; c < ncomp; c++) {
        for (int dy = 0; dy < vs[c]; dy++) {
          for (int dx = 0; dx < hs[c]; dx++) {
            int by = my * vs[c] + dy;
            int bx = mx * hs[c] + dx;
            int16_t *block = out[c] + ((long)by * bw[c] + bx) * 64;
            int size = r.decode(dct_[c]);
            // size comes from file-supplied VALS; >16 would shift by a
            // negative count in read_bits/extend (UB).
            if (r.bad || size > 16) return -1;
            int diff = extend((int)r.read_bits(size), size);
            pred[c] += diff;
            block[0] = (int16_t)pred[c];
            int k = 1;
            while (k < 64) {
              int rs = r.decode(act_[c]);
              int run = rs >> 4, s = rs & 0x0F;
              if (s == 0) {
                if (run == 15) { k += 16; continue; }
                break;  // EOB
              }
              k += run;
              if (k > 63) return -1;
              block[kZigzag[k]] =
                  (int16_t)extend((int)r.read_bits(s), s);
              k++;
            }
            if (r.bad) return -1;
          }
        }
      }
      mcu_count++;
    }
  }
  return r.pos;
}

// Decode one progressive (SOF2) scan — spectral selection + successive
// approximation per ITU T.81 G.2.  Behaviour mirrors the Python oracle in
// codecs/progressive.py bit for bit (including permissive restart-marker
// resync), so the two paths are interchangeable.
//
// coef[i]: int32 natural-order blocks for scan component i, row stride
// bw[i] (the interleaved grid width); accumulated across scans, updated in
// place.  DC scans (ss == 0) may interleave ns components over the
// mcus_x * mcus_y grid; a single-component scan walks its own
// non-interleaved nbw[0] * nbh[0] grid.  AC scans always have ns == 1.
// Huffman specs: per-scan-component DC (used only when ss==0 && ah==0);
// one AC table (used only when ss>0).
//
// Returns the reader's byte offset after the scan (the caller resyncs to
// the next marker from there), or -1 on corrupt data — the caller then
// restores the coefficient snapshot and falls back to the Python decoder.
long fennec_jpeg_decode_progressive_scan(
    const uint8_t *data, long len, long pos, int ns, int32_t **coef,
    const int *bw, const int *hs, const int *vs, int mcus_x, int mcus_y,
    const int *nbw, const int *nbh, int ss, int se, int ah, int al,
    const uint8_t *dc_bits, const uint8_t *dc_vals, const int *dc_nvals,
    const int *dc_voff, const uint8_t *ac_bits, const uint8_t *ac_vals,
    int ac_nvals, int restart_interval) {
  if (ns < 1 || ns > 4 || ss < 0 || se > 63 || al < 0 || al > 13) return -1;
  BitReader r(data, len, pos);

  if (ss == 0) {
    // ── DC scan ──
    DecTable dct[4];
    if (ah == 0) {
      for (int c = 0; c < ns; c++) {
        if (!dct[c].build(dc_bits + c * 16, dc_vals + dc_voff[c],
                          dc_nvals[c]))
          return -1;
      }
    }
    int pred[4] = {0, 0, 0, 0};
    bool interleaved = ns > 1;
    int gx = interleaved ? mcus_x : nbw[0];
    int gy = interleaved ? mcus_y : nbh[0];
    int mcu_count = 0;
    for (int my = 0; my < gy; my++) {
      for (int mx = 0; mx < gx; mx++) {
        if (restart_interval && mcu_count == restart_interval) {
          r.align_any();
          pred[0] = pred[1] = pred[2] = pred[3] = 0;
          mcu_count = 0;
        }
        for (int si = 0; si < ns; si++) {
          int rv = interleaved ? vs[si] : 1;
          int rh = interleaved ? hs[si] : 1;
          for (int dy = 0; dy < rv; dy++) {
            for (int dx = 0; dx < rh; dx++) {
              long by = interleaved ? (long)my * vs[si] + dy : my;
              long bx = interleaved ? (long)mx * hs[si] + dx : mx;
              int32_t *blk = coef[si] + (by * bw[si] + bx) * 64;
              if (ah == 0) {
                int size = r.decode(dct[si]);
                if (r.bad || size > 16) return -1;
                int diff = extend((int)r.read_bits(size), size);
                pred[si] += diff;
                blk[0] = pred[si] * (1 << al);
              } else {
                if (r.read_bits(1)) blk[0] |= (1 << al);
              }
            }
          }
        }
        mcu_count++;
      }
    }
    return r.pos;
  }

  // ── AC scan (always single component, non-interleaved grid) ──
  if (ns != 1) return -1;
  DecTable act;
  if (!act.build(ac_bits, ac_vals, ac_nvals)) return -1;
  const int stride = bw[0];
  const int gw = nbw[0], gh = nbh[0];
  const int plus1 = 1 << al;
  const int minus1 = -(1 << al);
  long eobrun = 0;
  int mcu_count = 0;
  for (int by = 0; by < gh; by++) {
    for (int bx = 0; bx < gw; bx++) {
      if (restart_interval && mcu_count == restart_interval) {
        r.align_any();
        eobrun = 0;
        mcu_count = 0;
      }
      int32_t *blk = coef[0] + ((long)by * stride + bx) * 64;
      if (ah == 0) {
        // First AC pass for this band.
        if (eobrun > 0) {
          eobrun--;
        } else {
          int k = ss;
          while (k <= se) {
            int rs = r.decode(act);
            if (r.bad) return -1;
            int run = rs >> 4, size = rs & 0x0F;
            if (size == 0) {
              if (run < 15) {
                eobrun = (1L << run) - 1;
                if (run) eobrun += r.read_bits(run);
                break;
              }
              k += 16;  // ZRL
              continue;
            }
            k += run;
            if (k > se) break;
            blk[kZigzag[k]] =
                extend((int)r.read_bits(size), size) * (1 << al);
            k++;
          }
        }
      } else {
        // AC refinement pass.
        int k = ss;
        if (eobrun <= 0) {
          while (k <= se) {
            int rs = r.decode(act);
            if (r.bad) return -1;
            int run = rs >> 4, size = rs & 0x0F;
            int value = 0;
            if (size == 0) {
              if (run < 15) {
                eobrun = (1L << run);
                if (run) eobrun += r.read_bits(run);
                break;
              }
              // ZRL: skip 16 zero-history coefficients.
            } else {
              value = r.read_bits(1) ? plus1 : minus1;
            }
            // Advance over `run` zero-history coefficients, applying
            // correction bits to nonzero-history ones on the way.
            while (k <= se) {
              int32_t &c = blk[kZigzag[k]];
              if (c != 0) {
                if (r.read_bits(1) && (c & plus1) == 0) {
                  c += (c >= 0) ? plus1 : minus1;
                }
              } else {
                if (run == 0) {
                  if (value != 0) c = value;
                  k++;
                  break;
                }
                run--;
              }
              k++;
            }
          }
        }
        if (eobrun > 0) {
          // Correction bits for the remainder of the band.
          while (k <= se) {
            int32_t &c = blk[kZigzag[k]];
            if (c != 0) {
              if (r.read_bits(1) && (c & plus1) == 0) {
                c += (c >= 0) ? plus1 : minus1;
              }
            }
            k++;
          }
          eobrun--;
        }
      }
      mcu_count++;
    }
  }
  return r.pos;
}

// Decode an interleaved baseline scan DIRECTLY into an int8 coefficient
// block with a sparse exception list — the upload format of the batched
// device path (engine/batched.py).  out: (sum of bw[c]*bh[c]) x 64 int8 in
// ZIGZAG order (position k of a block row = zigzag index k — photo
// blocks end early in zigzag order, so the engine can truncate the
// trailing all-zero columns before upload); components concatenated in
// raster order.  Coefficients with |v| > 127 are stored as 0 with
// (flat_base + flat_index, value) appended to the exception arrays.
// *out_maxk receives the maximum nonzero zigzag extent (highest nonzero
// zigzag index + 1) across all blocks.  One pass, no intermediate int16
// buffers.  Returns the exception count, or -1 on corrupt data, -2 on
// exception overflow (caller falls back to the dense int16 path).
long fennec_jpeg_decode_scan_i8(const uint8_t *data, long len, long pos,
                                int ncomp, int8_t *out, const int *bw,
                                const int *bh, const int *hs, const int *vs,
                                const uint8_t *dc_bits,
                                const uint8_t *dc_vals, const int *dc_nvals,
                                const int *dc_voff, const uint8_t *ac_bits,
                                const uint8_t *ac_vals, const int *ac_nvals,
                                const int *ac_voff, int restart_interval,
                                long long flat_base, int32_t *exc_idx,
                                int16_t *exc_val, long max_exc,
                                int32_t *out_maxk) {
  if (ncomp < 1 || ncomp > 4) return -1;
  DecTable dct_[4], act_[4];
  long comp_off[4];
  long off = 0;
  for (int c = 0; c < ncomp; c++) {
    if (!dct_[c].build(dc_bits + c * 16, dc_vals + dc_voff[c],
                       dc_nvals[c]) ||
        !act_[c].build(ac_bits + c * 16, ac_vals + ac_voff[c],
                       ac_nvals[c]))
      return -1;
    comp_off[c] = off;
    off += (long)bw[c] * bh[c] * 64;
  }
  std::memset(out, 0, off);
  int mcus_x = hs[0] ? bw[0] / hs[0] : 0;
  int mcus_y = vs[0] ? bh[0] / vs[0] : 0;

  BitReader r(data, len, pos);
  int pred[4] = {0, 0, 0, 0};
  int mcu_count = 0;
  long ne = 0;
  int maxk = 1;  // DC always present

  for (int my = 0; my < mcus_y; my++) {
    for (int mx = 0; mx < mcus_x; mx++) {
      if (restart_interval && mcu_count == restart_interval) {
        r.align_to_rst();
        if (r.bad) return -1;
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
        mcu_count = 0;
      }
      for (int c = 0; c < ncomp; c++) {
        for (int dy = 0; dy < vs[c]; dy++) {
          for (int dx = 0; dx < hs[c]; dx++) {
            int by = my * vs[c] + dy;
            int bx = mx * hs[c] + dx;
            long blk = comp_off[c] + ((long)by * bw[c] + bx) * 64;
            int8_t *bp = out + blk;
            int size = r.decode(dct_[c]);
            // size comes from file-supplied VALS; >16 would shift by a
            // negative count in read_bits/extend (UB).
            if (r.bad || size > 16) return -1;
            int diff = extend((int)r.read_bits(size), size);
            pred[c] += diff;
            int v = pred[c];
            if (v > 127 || v < -127) {
              if (ne >= max_exc) return -2;
              exc_idx[ne] = (int32_t)(flat_base + blk);
              exc_val[ne] = (int16_t)v;
              ne++;
            } else {
              bp[0] = (int8_t)v;
            }
            int k = 1;
            while (k < 64) {
              int rs = r.decode(act_[c]);
              int run = rs >> 4, s = rs & 0x0F;
              if (s == 0) {
                if (run == 15) { k += 16; continue; }
                break;  // EOB
              }
              k += run;
              if (k > 63) return -1;
              v = extend((int)r.read_bits(s), s);
              if (v > 127 || v < -127) {
                if (ne >= max_exc) return -2;
                exc_idx[ne] = (int32_t)(flat_base + blk + k);
                exc_val[ne] = (int16_t)v;
                ne++;
              } else {
                bp[k] = (int8_t)v;  // zigzag-order row
              }
              if (k + 1 > maxk) maxk = k + 1;
              k++;
            }
            if (r.bad) return -1;
          }
        }
      }
      mcu_count++;
    }
  }
  if (out_maxk) *out_maxk = maxk;
  return ne;
}

// Decode an interleaved baseline scan directly into the sparse COO upload
// layout: per block, the DC value (int8 plane, block-index order y|cb|cr)
// plus up to rcap AC-nonzero (zigzag position, int8 value) pairs; |v|>127
// values and slots past rcap spill to the exception list (image-local
// offsets into the flat NT*64 zigzag layout, matching decode_scan_i8).
// cnt_hist[min(count, 64)]++ per block records the slot-consuming
// AC-nonzero distribution so the caller can pick the final R bucket and
// estimate upload sizes; out_maxk reports the max zigzag extent for the
// dense-format comparison.  Returns the exception count, -1 on corrupt
// data, -2 on exception-list overflow.
long fennec_jpeg_decode_scan_coo(
    const uint8_t *data, long len, long pos, int ncomp, int8_t *dc,
    uint8_t *pos_out, int8_t *val_out, int rcap, const int *bw,
    const int *bh, const int *hs, const int *vs, const uint8_t *dc_bits,
    const uint8_t *dc_vals, const int *dc_nvals, const int *dc_voff,
    const uint8_t *ac_bits, const uint8_t *ac_vals, const int *ac_nvals,
    const int *ac_voff, int restart_interval, int32_t *exc_idx,
    int16_t *exc_val, long max_exc, int32_t *cnt_hist,
    int32_t *out_maxk) {
  if (ncomp < 1 || ncomp > 4 || rcap < 1 || rcap > 63) return -1;
  DecTable dct_[4], act_[4];
  long comp_blk[4];
  long nblocks = 0;
  for (int c = 0; c < ncomp; c++) {
    if (!dct_[c].build(dc_bits + c * 16, dc_vals + dc_voff[c],
                       dc_nvals[c]) ||
        !act_[c].build(ac_bits + c * 16, ac_vals + ac_voff[c],
                       ac_nvals[c]))
      return -1;
    comp_blk[c] = nblocks;
    nblocks += (long)bw[c] * bh[c];
  }
  std::memset(dc, 0, nblocks);
  std::memset(pos_out, 0, nblocks * (long)rcap);
  std::memset(val_out, 0, nblocks * (long)rcap);
  std::memset(cnt_hist, 0, 65 * sizeof(int32_t));
  int mcus_x = hs[0] ? bw[0] / hs[0] : 0;
  int mcus_y = vs[0] ? bh[0] / vs[0] : 0;

  BitReader r(data, len, pos);
  int pred[4] = {0, 0, 0, 0};
  int mcu_count = 0;
  long ne = 0;
  int maxk = 1;  // DC always present

  for (int my = 0; my < mcus_y; my++) {
    for (int mx = 0; mx < mcus_x; mx++) {
      if (restart_interval && mcu_count == restart_interval) {
        r.align_to_rst();
        if (r.bad) return -1;
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
        mcu_count = 0;
      }
      for (int c = 0; c < ncomp; c++) {
        for (int dy = 0; dy < vs[c]; dy++) {
          for (int dx = 0; dx < hs[c]; dx++) {
            int by = my * vs[c] + dy;
            int bx = mx * hs[c] + dx;
            long nb = comp_blk[c] + (long)by * bw[c] + bx;
            int size = r.decode(dct_[c]);
            // size comes from file-supplied VALS; >16 would shift by a
            // negative count in read_bits/extend (UB).
            if (r.bad || size > 16) return -1;
            int diff = extend((int)r.read_bits(size), size);
            pred[c] += diff;
            int v = pred[c];
            if (v > 127 || v < -127) {
              if (ne >= max_exc) return -2;
              exc_idx[ne] = (int32_t)(nb * 64);
              exc_val[ne] = (int16_t)v;
              ne++;
            } else {
              dc[nb] = (int8_t)v;
            }
            int slot = 0, count = 0;
            int8_t *vp = val_out + nb * rcap;
            uint8_t *pp = pos_out + nb * rcap;
            int k = 1;
            while (k < 64) {
              int rs = r.decode(act_[c]);
              int run = rs >> 4, s = rs & 0x0F;
              if (s == 0) {
                if (run == 15) { k += 16; continue; }
                break;  // EOB
              }
              k += run;
              if (k > 63) return -1;
              v = extend((int)r.read_bits(s), s);
              if (v > 127 || v < -127) {
                if (ne >= max_exc) return -2;
                exc_idx[ne] = (int32_t)(nb * 64 + k);
                exc_val[ne] = (int16_t)v;
                ne++;
              } else {
                count++;
                if (slot < rcap) {
                  pp[slot] = (uint8_t)k;
                  vp[slot] = (int8_t)v;
                  slot++;
                } else {
                  if (ne >= max_exc) return -2;
                  exc_idx[ne] = (int32_t)(nb * 64 + k);
                  exc_val[ne] = (int16_t)v;
                  ne++;
                }
              }
              if (k + 1 > maxk) maxk = k + 1;
              k++;
            }
            cnt_hist[count > 64 ? 64 : count]++;
            if (r.bad) return -1;
          }
        }
      }
      mcu_count++;
    }
  }
  if (out_maxk) *out_maxk = maxk;
  return ne;
}

// Pack int16 coefficients to int8 with an exception list for |v| > 127.
// Returns the exception count, or -1 if it exceeds max_exc.
long fennec_int16_to_int8_exc(const int16_t *in, long n, int8_t *out,
                              int32_t *exc_idx, int16_t *exc_val,
                              long max_exc) {
  long ne = 0;
  for (long i = 0; i < n; i++) {
    int v = in[i];
    if (v > 127 || v < -127) {
      if (ne >= max_exc) return -1;
      exc_idx[ne] = (int32_t)i;
      exc_val[ne] = (int16_t)v;
      ne++;
      out[i] = 0;
    } else {
      out[i] = (int8_t)v;
    }
  }
  return ne;
}

// ── PNG scanline filters ────────────────────────────────────────────────────

static inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// raw: h rows of (1 filter byte + stride data bytes). out: h*stride.
// Returns 0 on success, -1 on bad filter type.
int fennec_png_unfilter(const uint8_t *raw, int h, int stride, int bpp,
                        uint8_t *out) {
  const uint8_t *prev = nullptr;
  for (int y = 0; y < h; y++) {
    const uint8_t *src = raw + (long)y * (stride + 1);
    uint8_t *dst = out + (long)y * stride;
    int ftype = src[0];
    src++;
    switch (ftype) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:
        for (int x = 0; x < bpp && x < stride; x++) dst[x] = src[x];
        for (int x = bpp; x < stride; x++)
          dst[x] = (uint8_t)(src[x] + dst[x - bpp]);
        break;
      case 2:
        if (prev) {
          for (int x = 0; x < stride; x++)
            dst[x] = (uint8_t)(src[x] + prev[x]);
        } else {
          std::memcpy(dst, src, stride);
        }
        break;
      case 3:
        for (int x = 0; x < stride; x++) {
          int left = x >= bpp ? dst[x - bpp] : 0;
          int up = prev ? prev[x] : 0;
          dst[x] = (uint8_t)(src[x] + ((left + up) >> 1));
        }
        break;
      case 4:
        for (int x = 0; x < stride; x++) {
          int left = x >= bpp ? dst[x - bpp] : 0;
          int up = prev ? prev[x] : 0;
          int ul = (prev && x >= bpp) ? prev[x - bpp] : 0;
          dst[x] = (uint8_t)(src[x] + paeth(left, up, ul));
        }
        break;
      default:
        return -1;
    }
    prev = dst;
  }
  return 0;
}

// data: h*stride. out: h*(stride+1). heuristic: 0=always filter 0,
// 1=min-sum-of-absolute-differences. Returns bytes written.
long fennec_png_filter(const uint8_t *data, int h, int stride, int bpp,
                       int heuristic, uint8_t *out) {
  uint8_t *scratch = (uint8_t *)std::malloc((size_t)stride * 5);
  if (!scratch) return -1;
  long opos = 0;
  const uint8_t *prev = nullptr;
  for (int y = 0; y < h; y++) {
    const uint8_t *row = data + (long)y * stride;
    int best = 0;
    const uint8_t *best_buf = row;
    if (heuristic) {
      long best_cost = -1;
      for (int f = 0; f < 5; f++) {
        uint8_t *buf = scratch + (long)f * stride;
        for (int x = 0; x < stride; x++) {
          int left = x >= bpp ? row[x - bpp] : 0;
          int up = prev ? prev[x] : 0;
          int ul = (prev && x >= bpp) ? prev[x - bpp] : 0;
          int v;
          switch (f) {
            case 0: v = row[x]; break;
            case 1: v = row[x] - left; break;
            case 2: v = row[x] - up; break;
            case 3: v = row[x] - ((left + up) >> 1); break;
            default: v = row[x] - paeth(left, up, ul); break;
          }
          buf[x] = (uint8_t)v;
        }
        long cost = 0;
        for (int x = 0; x < stride; x++) {
          int8_t sv = (int8_t)buf[x];
          cost += sv < 0 ? -sv : sv;
        }
        if (best_cost < 0 || cost < best_cost) {
          best_cost = cost;
          best = f;
          best_buf = buf;
        }
      }
    }
    out[opos++] = (uint8_t)best;
    std::memcpy(out + opos, best_buf, stride);
    opos += stride;
    prev = row;
  }
  std::free(scratch);
  return opos;
}

// ── Optimal Huffman table construction (T.81 Annex K.2) ────────────────────
// Faithful port of codecs/huffopt.py:optimal_spec (libjpeg
// jpeg_gen_optimal_table semantics, identical tie-breaking: among equal
// minima pick the LARGEST index).  The Python version costs ~2 ms per
// table set per image — on a single-core host that is the batch
// pipeline's biggest CPU term; here it is microseconds.

static int fennec_optimal_spec_one(const int64_t *freq_in, int n,
                                   uint8_t *bits16, uint8_t *vals,
                                   int32_t *nvals) {
  int64_t f[257];
  int32_t codesize[257];
  int32_t others[257];
  int64_t total = 0;
  for (int i = 0; i < n; i++) { f[i] = freq_in[i]; total += f[i]; }
  if (total == 0) f[0] = 1;  // minimal valid table (huffopt.py:90-94)
  f[n] = 1;  // reserved symbol: no all-ones code
  for (int i = 0; i <= n; i++) { codesize[i] = 0; others[i] = -1; }

  for (;;) {
    int64_t m1 = -1; int v1 = -1; int live = 0;
    for (int i = 0; i <= n; i++) {
      if (f[i] <= 0) continue;
      live++;
      if (m1 < 0 || f[i] < m1) { m1 = f[i]; v1 = i; }
      else if (f[i] == m1) v1 = i;  // largest index among minima
    }
    if (live <= 1) break;
    int64_t m2 = -1; int v2 = -1;
    for (int i = 0; i <= n; i++) {
      if (f[i] <= 0 || i == v1) continue;
      if (m2 < 0 || f[i] < m2) { m2 = f[i]; v2 = i; }
      else if (f[i] == m2) v2 = i;
    }
    f[v1] += f[v2];
    f[v2] = 0;
    codesize[v1]++;
    while (others[v1] != -1) { v1 = others[v1]; codesize[v1]++; }
    others[v1] = v2;
    codesize[v2]++;
    while (others[v2] != -1) { v2 = others[v2]; codesize[v2]++; }
  }

  int64_t bits[33];
  for (int i = 0; i < 33; i++) bits[i] = 0;
  for (int s = 0; s <= n; s++) {
    if (codesize[s] > 32) return 1;  // parity: huffopt.py raises here —
    // clamping would oversubscribe bits[32] and break the Kraft
    // invariant the K.3 redistribution assumes (broken DHT).
    if (codesize[s] > 0) bits[codesize[s]]++;
  }

  // Limit code lengths to 16 bits (K.2 Figure K.3).
  int i = 32;
  while (i > 16) {
    while (bits[i] > 0) {
      int j = i - 2;
      while (bits[j] == 0) j--;
      bits[i] -= 2;
      bits[i - 1] += 1;
      bits[j + 1] += 2;
      bits[j] -= 1;
    }
    i--;
  }
  while (bits[i] == 0) i--;
  bits[i] -= 1;  // drop the reserved symbol's slot
  for (int k = 0; k < 16; k++) bits16[k] = (uint8_t)bits[k + 1];

  // VALS: real symbols ordered by (code length, symbol value); lengths
  // are ≤32 here (overlong codes returned 1 above).
  int m = 0;
  for (int len = 1; len <= 32 && m < n; len++)
    for (int s = 0; s < n; s++)
      if (codesize[s] == len) vals[m++] = (uint8_t)s;
  *nvals = m;
  return 0;
}

// Batch: nimg images, dc_freq (nimg,2,16) i64, ac_freq (nimg,2,256) i64 →
// dht_bits (nimg,4,16) u8, dht_vals (nimg,4,256) u8, dht_nvals (nimg,4)
// i32, table order per image: dc luma, dc chroma, ac luma, ac chroma.
// Returns 0 on success, 2 if any table's optimal code length exceeds 32
// bits (caller maps rc=2 to the same ValueError the Python builder
// raises — see huffopt.py optimal_spec).
long fennec_build_optimal_specs(long nimg, const int64_t *dc_freq,
                                const int64_t *ac_freq, uint8_t *dht_bits,
                                uint8_t *dht_vals, int32_t *dht_nvals) {
  for (long j = 0; j < nimg; j++) {
    for (int cls = 0; cls < 2; cls++) {
      if (fennec_optimal_spec_one(dc_freq + (j * 2 + cls) * 16, 16,
                                  dht_bits + (j * 4 + cls) * 16,
                                  dht_vals + (j * 4 + cls) * 256,
                                  dht_nvals + j * 4 + cls))
        return 2;
      if (fennec_optimal_spec_one(ac_freq + (j * 2 + cls) * 256, 256,
                                  dht_bits + (j * 4 + 2 + cls) * 16,
                                  dht_vals + (j * 4 + 2 + cls) * 256,
                                  dht_nvals + j * 4 + 2 + cls))
        return 2;
    }
  }
  return 0;
}

// RGB (b, h, w, 3) uint8 → the batch engine's YCbCr 4:2:0 pixel wire:
// per image [Y (ph·pw) | Cb (ph/2·pw/2) | Cr (ph/2·pw/2)] uint8, with
// ph/pw = next multiples of 16 (edge-replicate pad) and 2×2-mean
// chroma.  16.16 fixed-point (coefficients rounded to 1/65536): the
// value error vs the f32 reference path is ≤ ~0.02 pre-rounding, so
// the rounded u8 planes agree with the numpy/device float convert to
// ≤1 LSB (and only on half-integer knife edges) — inside the wire's
// documented "device convert ± u8 rounding" contract
// (tests/test_pixel_wire.py).  Integer math auto-vectorizes ~6× faster
// than the float version on the 1-core host (the wire's feeder cost is
// the whole question there).
static void yuv420_one(const uint8_t *img, int h, int w, int ps,
                       uint8_t *yo, int32_t *cb_full, int32_t *cr_full) {
  // ps = pixel stride in bytes (3 for packed RGB, 4 for RGBA views —
  // lets the batch feeder convert straight from its NRGBA images
  // without a repack pass, which costs real time on memory-bandwidth-
  // starved hosts).
  int ph = h + ((16 - (h % 16)) % 16);
  int pw = w + ((16 - (w % 16)) % 16);
  int ch = ph / 2, cw = pw / 2;
  long npix = (long)ph * pw;
  long nchr = (long)ch * cw;
  uint8_t *cbo = yo + npix;
  uint8_t *cro = cbo + nchr;
  const int32_t YR = 19595, YG = 38470, YB = 7471;        // *2^16
  const int32_t CBR = 11058, CBG = 21710, CBB = 32768;    // *2^16
  const int32_t CRR = 32768, CRG = 27439, CRB = 5329;     // *2^16
  const int32_t OFF = 128 << 16;
  for (int y = 0; y < ph; y++) {
    const uint8_t *row = img + (long)(y < h ? y : h - 1) * w * ps;
    int32_t *cbrow = cb_full + (long)y * pw;
    int32_t *crrow = cr_full + (long)y * pw;
    uint8_t *yrow = yo + (long)y * pw;
    int inner = (y < h) ? w : 0;  // pad rows copy the clamped row
    for (int x = 0; x < inner; x++) {
      const uint8_t *px = row + (long)x * ps;
      int32_t r = px[0], g = px[1], bl = px[2];
      int32_t yy = YR * r + YG * g + YB * bl;             // 16.16
      yrow[x] = (uint8_t)((yy + 32768) >> 16);            // ≤255 always
      cbrow[x] = OFF - CBR * r - CBG * g + CBB * bl;
      crrow[x] = OFF + CRR * r - CRG * g - CRB * bl;
    }
    if (y < h) {
      for (int x = w; x < pw; x++) {  // edge-replicate right pad
        yrow[x] = yrow[w - 1];
        cbrow[x] = cbrow[w - 1];
        crrow[x] = crrow[w - 1];
      }
    } else {  // edge-replicate bottom pad
      std::memcpy(yrow, yo + (long)(h - 1) * pw, pw);
      std::memcpy(cbrow, cb_full + (long)(h - 1) * pw,
                  sizeof(int32_t) * pw);
      std::memcpy(crrow, cr_full + (long)(h - 1) * pw,
                  sizeof(int32_t) * pw);
    }
  }
  for (int y = 0; y < ch; y++) {
    const int32_t *r0b = cb_full + (long)(2 * y) * pw;
    const int32_t *r1b = cb_full + (long)(2 * y + 1) * pw;
    const int32_t *r0r = cr_full + (long)(2 * y) * pw;
    const int32_t *r1r = cr_full + (long)(2 * y + 1) * pw;
    uint8_t *cbr = cbo + (long)y * cw;
    uint8_t *crr = cro + (long)y * cw;
    for (int x = 0; x < cw; x++) {
      // Mean of 4 × 16.16 values; +2 rounds the >>2, +32768 the >>16.
      int64_t mb = ((int64_t)r0b[2 * x] + r0b[2 * x + 1]
                    + r1b[2 * x] + r1b[2 * x + 1] + 2) >> 2;
      int64_t mr = ((int64_t)r0r[2 * x] + r0r[2 * x + 1]
                    + r1r[2 * x] + r1r[2 * x + 1] + 2) >> 2;
      int32_t vb = (int32_t)((mb + 32768) >> 16);
      int32_t vr = (int32_t)((mr + 32768) >> 16);
      cbr[x] = (uint8_t)(vb < 0 ? 0 : (vb > 255 ? 255 : vb));
      crr[x] = (uint8_t)(vr < 0 ? 0 : (vr > 255 ? 255 : vr));
    }
  }
}

int fennec_rgb_to_yuv420(const uint8_t *rgb, long b, int h, int w,
                         uint8_t *out) {
  int ph = h + ((16 - (h % 16)) % 16);
  int pw = w + ((16 - (w % 16)) % 16);
  long npix = (long)ph * pw;
  long nchr = (long)(ph / 2) * (pw / 2);
  // Chroma kept at 16.16 through the 2×2 mean (sum of 4 + >>2 keeps
  // the fraction), rounded once at the end.
  int32_t *cb_full = (int32_t *)std::malloc(sizeof(int32_t) * npix * 2);
  if (!cb_full) return -1;
  for (long j = 0; j < b; j++)
    yuv420_one(rgb + j * (long)h * w * 3, h, w, 3,
               out + j * (npix + 2 * nchr), cb_full, cb_full + npix);
  std::free(cb_full);
  return 0;
}

// One image, arbitrary pixel stride (4 = NRGBA views), writing its wire
// row directly into the caller's buffer: the feeder skips the packed
// RGB staging stack entirely.
int fennec_rgba_to_yuv420_one(const uint8_t *img, int h, int w, int ps,
                              uint8_t *out) {
  int ph = h + ((16 - (h % 16)) % 16);
  int pw = w + ((16 - (w % 16)) % 16);
  long npix = (long)ph * pw;
  int32_t *cb_full = (int32_t *)std::malloc(sizeof(int32_t) * npix * 2);
  if (!cb_full) return -1;
  yuv420_one(img, h, w, ps, out, cb_full, cb_full + npix);
  std::free(cb_full);
  return 0;
}

}  // extern "C"
