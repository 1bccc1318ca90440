// Huffman entropy decoding of one JPEG scan into DCT coefficient arrays,
// for data/jpeg.py (loaded through ctypes; plain C interface).
//
// Covers what libjpeg decodes with Huffman coding at 8 bits (jdhuff.c,
// jdphuff.c): sequential scans (interleaved MCUs or one component) and the
// four progressive kinds (DC first, DC refine, AC first with EOB runs, AC
// refine with correction bits), restart intervals, byte stuffing, fill
// bytes before a marker and unused bits at the end of a scan.  Each
// coefficient lands where libjpeg puts it, cast to int16 as libjpeg's
// JCOEF, including the clamped zigzag index of a corrupt run.  Where
// libjpeg warns and guesses (a code in no table, a wrong restart marker,
// a scan that runs out of data), this returns an error instead.
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

// jutils.c jpeg_natural_order, with libjpeg's 16 extra entries of 63 so a
// corrupt run past the band end writes coefficient 63
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Table {
  bool defined = false;
  // lookahead on the next kLookBits bits: code length (0: longer) and symbol
  uint8_t look_len[1 << kLookBits];
  uint8_t look_sym[1 << kLookBits];
  int32_t maxcode[18];   // largest code of each length, -1 if none
  int32_t valoffset[18]; // symbol index of a length's first code, less it
  uint8_t vals[256];
};

struct Error {
  char *buf;
  int len;
  int fail(const char *msg) {
    std::snprintf(buf, len, "%s", msg);
    return 1;
  }
};

// jdhuff.c jpeg_make_d_derived_tbl, with its checks
bool build_table(const uint8_t *bits, const uint8_t *vals, bool dc,
                 Table *t) {
  int count = 0;
  for (int l = 1; l <= 16; l++) count += bits[l];
  if (count > 256) return false;
  uint8_t size[257];
  uint32_t code[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l]; i++) size[p++] = (uint8_t)l;
  size[p] = 0;
  uint32_t c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1u << si)) return false;
    c <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (bits[l]) {
      t->valoffset[l] = p - (int32_t)code[p];
      p += bits[l];
      t->maxcode[l] = (int32_t)code[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->maxcode[17] = 0x7fffffff;
  std::memset(t->look_len, 0, sizeof t->look_len);
  p = 0;
  for (int l = 1; l <= kLookBits; l++)
    for (int i = 0; i < bits[l]; i++, p++) {
      int lo = (int)(code[p] << (kLookBits - l));
      for (int k = 0; k < (1 << (kLookBits - l)); k++) {
        t->look_len[lo + k] = (uint8_t)l;
        t->look_sym[lo + k] = vals[p];
      }
    }
  for (int i = 0; i < count; i++) {
    if (dc && vals[i] > 15) return false;
    t->vals[i] = vals[i];
  }
  t->defined = true;
  return true;
}

struct Reader {
  const uint8_t *buf;
  int64_t len, pos;
  uint64_t acc = 0;  // bits left-aligned
  int nbits = 0;
  int pad = 0;  // zero bits appended past a marker or the end of the data
  bool at_marker = false;

  // jdhuff.c jpeg_fill_bit_buffer: fill bytes 0xFF before a marker are
  // skipped, 0xFF 0x00 is a data byte 0xFF, a marker stops the reading
  // and zeros follow
  void fill() {
    while (nbits <= 56) {
      if (!at_marker && pos < len) {
        uint64_t c = buf[pos];
        int64_t next = pos + 1;
        if (c == 0xFF) {
          while (next < len && buf[next] == 0xFF) next++;
          if (next < len && buf[next] == 0) {
            next++;
          } else {
            at_marker = true;  // pos stays on the marker's first 0xFF
          }
        }
        if (!at_marker) {
          pos = next;
          acc |= c << (56 - nbits);
          nbits += 8;
          continue;
        }
      }
      at_marker = true;
      nbits += 8;
      pad += 8;
    }
  }
  // the whole stream has been read only if no appended zero was consumed
  bool ok() const { return nbits >= pad; }
  uint32_t peek16() {
    if (nbits < 16) fill();
    return (uint32_t)(acc >> 48);
  }
  void skip(int n) {
    acc <<= n;
    nbits -= n;
  }
  int get(int n) {  // n in 0..16
    if (n == 0) return 0;
    if (nbits < n) fill();
    int v = (int)(acc >> (64 - n));
    skip(n);
    return v;
  }
  // jdhuff.c jpeg_huff_decode; -1 for a code in no table
  int decode(const Table &t) {
    uint32_t look = peek16();
    int i = (int)(look >> (16 - kLookBits));
    int l = t.look_len[i];
    if (l) {
      skip(l);
      return t.look_sym[i];
    }
    for (l = kLookBits + 1; l <= 16; l++) {
      int32_t code = (int32_t)(look >> (16 - l));
      if (code <= t.maxcode[l]) {
        skip(l);
        return t.vals[t.valoffset[l] + code];
      }
    }
    return -1;
  }
  void discard() {  // restart: drop the bits of the last byte
    acc = 0;
    nbits = 0;
    pad = 0;
  }
  // the offset of the next marker's first 0xFF (libjpeg's next_marker
  // skips other bytes)
  int64_t next_marker() {
    int64_t q = pos;
    while (q + 1 < len) {
      if (buf[q] == 0xFF && buf[q + 1] != 0 && buf[q + 1] != 0xFF) return q;
      q++;
    }
    return len;
  }
};

inline int extend(int v, int s) {  // HUFF_EXTEND
  return v < (1 << (s - 1)) ? v + (-1 << s) + 1 : v;
}

struct Comp {
  int dc, ac, h, v, stride, wblocks, hblocks;
  int16_t *coef;
};

struct Scan {
  Reader r;
  Error *err;
  Table *dc, *ac;  // 4 each
  Comp comp[4];
  int ns, ss, se, ah, al, progressive;
  int last_dc[4];
  unsigned eobrun;

  int16_t *block(const Comp &c, int row, int col) {
    return c.coef + ((int64_t)row * c.stride + col) * 64;
  }

  // one block of a sequential scan (jdhuff.c decode_mcu_slow)
  int seq_block(int ci, int16_t *b) {
    const Comp &c = comp[ci];
    int s = r.decode(dc[c.dc]);
    if (s < 0) return err->fail("corrupt entropy data: a code in no table");
    if (s) s = extend(r.get(s), s);
    s += last_dc[ci];
    last_dc[ci] = s;
    b[0] = (int16_t)s;
    for (int k = 1; k < 64; k++) {
      s = r.decode(ac[c.ac]);
      if (s < 0) return err->fail("corrupt entropy data: a code in no table");
      int run = s >> 4;
      s &= 15;
      if (s) {
        k += run;
        b[kNatural[k]] = (int16_t)extend(r.get(s), s);
      } else {
        if (run != 15) break;
        k += 15;
      }
    }
    return 0;
  }

  // jdphuff.c decode_mcu_DC_first / decode_mcu_DC_refine, one block
  int dc_block(int ci, int16_t *b) {
    if (ah == 0) {
      int s = r.decode(dc[comp[ci].dc]);
      if (s < 0) return err->fail("corrupt entropy data: a code in no table");
      if (s) s = extend(r.get(s), s);
      s += last_dc[ci];
      last_dc[ci] = s;
      b[0] = (int16_t)(int)((unsigned)s << al);
    } else if (r.get(1)) {
      b[0] = (int16_t)(b[0] | (1 << al));
    }
    return 0;
  }

  // jdphuff.c decode_mcu_AC_first
  int ac_first(int16_t *b) {
    if (eobrun > 0) {
      eobrun--;
      return 0;
    }
    const Table &t = ac[comp[0].ac];
    for (int k = ss; k <= se; k++) {
      int s = r.decode(t);
      if (s < 0) return err->fail("corrupt entropy data: a code in no table");
      int run = s >> 4;
      s &= 15;
      if (s) {
        k += run;
        b[kNatural[k]] = (int16_t)(int)((unsigned)extend(r.get(s), s) << al);
      } else if (run == 15) {
        k += 15;
      } else {
        eobrun = 1u << run;
        if (run) eobrun += (unsigned)r.get(run);
        eobrun--;
        break;
      }
    }
    return 0;
  }

  // jdphuff.c decode_mcu_AC_refine
  int ac_refine(int16_t *b) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    const Table &t = ac[comp[0].ac];
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int s = r.decode(t);
        if (s < 0)
          return err->fail("corrupt entropy data: a code in no table");
        int run = s >> 4;
        s &= 15;
        if (s) {
          if (s != 1)
            return err->fail("corrupt entropy data: a refinement "
                             "coefficient of size other than 1");
          s = r.get(1) ? p1 : m1;
        } else if (run != 15) {
          eobrun = 1u << run;
          if (run) eobrun += (unsigned)r.get(run);
          break;
        }
        do {
          int16_t *c = b + kNatural[k];
          if (*c != 0) {
            if (r.get(1) && (*c & p1) == 0)
              *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
          } else if (--run < 0) {
            break;
          }
          k++;
        } while (k <= se);
        if (s) b[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t *c = b + kNatural[k];
        if (*c != 0 && r.get(1) && (*c & p1) == 0)
          *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
      }
      eobrun--;
    }
    return 0;
  }

  int unit_block(int ci, int16_t *b) {
    if (!progressive) return seq_block(ci, b);
    if (ss == 0) return dc_block(ci, b);
    return ah == 0 ? ac_first(b) : ac_refine(b);
  }
};

}  // namespace

extern "C" {

// Decodes the scan whose entropy-coded data starts at buf[start].
//   huff_bits [8][17]: the BITS counts of DC tables 0-3 then AC tables 0-3
//     (index 1..16), all zero for an undefined table; huff_vals [8][256].
//   comps [ns][7]: DC table, AC table, h, v, the coefficient array's row
//     stride in blocks, the component's width and height in blocks;
//     coefs [ns]: each component's int16 array [rows][stride][64].
//   mcus_x, mcus_y: the MCU grid of an interleaved scan (ns > 1).
//   progressive, ss, se, ah, al: the scan's spectral selection and
//     successive approximation (sequential: 0, 0, 63, 0, 0).
// Writes the offset of the marker that ends the scan to *end.  Returns 0,
// or 1 with a message in err.
int jpeg_decode_scan(const uint8_t *buf, int64_t len, int64_t start,
                     const uint8_t *huff_bits, const uint8_t *huff_vals,
                     const int32_t *comps, int16_t **coefs, int ns,
                     int mcus_x, int mcus_y, int restart_interval,
                     int progressive, int ss, int se, int ah, int al,
                     int64_t *end, char *err, int errlen) {
  Error e{err, errlen};
  static thread_local Table tables[8];
  Scan sc;
  sc.err = &e;
  sc.dc = tables;
  sc.ac = tables + 4;
  sc.ns = ns;
  sc.ss = ss;
  sc.se = se;
  sc.ah = ah;
  sc.al = al;
  sc.progressive = progressive;
  sc.eobrun = 0;
  sc.r.buf = buf;
  sc.r.len = len;
  sc.r.pos = start;
  if (ns < 1 || ns > 4) return e.fail("a scan of 1 to 4 components");
  for (int i = 0; i < 8; i++) tables[i].defined = false;
  for (int i = 0; i < ns; i++) {
    const int32_t *c = comps + 7 * i;
    sc.comp[i] = Comp{c[0], c[1], c[2], c[3], c[4], c[5], c[6], coefs[i]};
    sc.last_dc[i] = 0;
    bool need_dc = !progressive || (ss == 0 && ah == 0);
    bool need_ac = !progressive ? true : ss > 0;
    for (int which = 0; which < 2; which++) {
      int slot = which == 0 ? c[0] : 4 + c[1];
      if (!(which == 0 ? need_dc : need_ac)) continue;
      if (slot < 0 || slot >= 8) return e.fail("a Huffman table index past 3");
      if (tables[slot].defined) continue;
      const uint8_t *bits = huff_bits + 17 * slot;
      int count = 0;
      for (int l = 1; l <= 16; l++) count += bits[l];
      if (count == 0) return e.fail("a scan uses an undefined Huffman table");
      if (!build_table(bits, huff_vals + 256 * slot, which == 0,
                       &tables[slot]))
        return e.fail("a bad Huffman table");
    }
  }

  int64_t units;  // MCUs, or blocks of a one-component scan
  int ux = 0;
  if (ns == 1) {
    ux = sc.comp[0].wblocks;
    units = (int64_t)ux * sc.comp[0].hblocks;
  } else {
    ux = mcus_x;
    units = (int64_t)mcus_x * mcus_y;
  }
  int restarts_to_go = restart_interval;
  int next_rst = 0;
  for (int64_t u = 0; u < units; u++) {
    if (restart_interval) {
      if (restarts_to_go == 0) {
        // jdhuff.c process_restart and jdmarker.c read_restart_marker
        if (!sc.r.ok())
          return e.fail("corrupt entropy data: a restart interval ran "
                        "past its data");
        sc.r.discard();
        int64_t q = sc.r.next_marker();
        if (q + 1 >= len || buf[q + 1] != 0xD0 + next_rst)
          return e.fail("corrupt entropy data: a missing or wrong restart "
                        "marker");
        sc.r.pos = q + 2;
        sc.r.at_marker = false;
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < ns; i++) sc.last_dc[i] = 0;
        sc.eobrun = 0;
        restarts_to_go = restart_interval;
      }
      restarts_to_go--;
    }
    int uy = (int)(u / ux), uxx = (int)(u % ux);
    if (ns == 1) {
      if (sc.unit_block(0, sc.block(sc.comp[0], uy, uxx))) return 1;
      continue;
    }
    for (int i = 0; i < ns; i++) {
      const Comp &c = sc.comp[i];
      for (int y = 0; y < c.v; y++)
        for (int x = 0; x < c.h; x++)
          if (sc.unit_block(i, sc.block(c, uy * c.v + y, uxx * c.h + x)))
            return 1;
    }
  }
  if (!sc.r.ok())
    return e.fail("corrupt or truncated entropy data: the scan ran past "
                  "its data");
  *end = sc.r.next_marker();
  return 0;
}

}  // extern "C"
