/* JPEG decoding on the host for the port's image codec
 * (dehaze_tpu_torch/data/images.py), which parses the markers in Python and
 * calls two entry points here through ctypes (each call releases the
 * interpreter lock, so the data pipeline's threads decode in parallel):
 *
 *   jpeg_decode_scan  one scan's Huffman decode into the coefficient
 *                     buffers: baseline and extended sequential, and every
 *                     kind of progressive scan (DC first and refinement,
 *                     AC first and refinement with end-of-band runs), with
 *                     restart intervals; it reports where it stopped
 *                     reading, from where the markers are parsed on;
 *   jpeg_output       dequantisation, the integer inverse DCT, chroma
 *                     upsampling and colour conversion into 8-bit RGB.
 *
 * The target is what the JAX package's cv2.imdecode(IMREAD_COLOR) returns,
 * byte for byte: libjpeg-turbo's default decode. That is the "islow" integer
 * IDCT (jidctint.c: 13-bit constants, two passes) as its x86 SIMD code
 * computes it in 16-bit lanes (only coefficients from corrupt data tell it
 * from jidctint.c; see idct_islow), fancy upsampling (jdsample.c: the
 * triangle filters h2v1 and h2v2 when a component is more than two samples wide, h1v2 always,
 * plain replication for every other integral factor; the edges repeat the
 * last real sample row and column), no merged upsampler (libjpeg-turbo uses
 * it only without fancy upsampling), and the fixed-point YCbCr -> RGB of
 * jdcolor.c (16-bit tables, rounding as there). A grayscale image is
 * repeated to three channels; an image that libjpeg takes as RGB (Adobe
 * transform 0, or component ids 'R', 'G', 'B') is copied through.
 *
 * Entropy-coded data that runs into a marker before a scan is complete is
 * padded with zero bits for the block that needs them, and the rest of that
 * restart interval is left zero (libjpeg's "insufficient data").
 *
 * The input is untrusted (it comes from HTTP bodies): every table and buffer
 * index below is bounded by what the Huffman tables and the scan
 * description allow, and a Huffman table whose codes do not fit their
 * lengths is refused before any lookup entry is written.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* zigzag position -> natural (row-major) position; the 16 extra entries
 * catch a corrupt run past 63, as libjpeg's table does */
static const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum {
  kOk = 0,
  kBadHuffmanTable = 1,
  kMissingHuffmanTable = 2,
  kBadScan = 3,
};

/* ---- Huffman tables ---------------------------------------------------- */

#define LOOK_BITS 9

typedef struct {
  uint8_t look_len[1 << LOOK_BITS]; /* 0: longer than LOOK_BITS */
  uint8_t look_sym[1 << LOOK_BITS];
  int32_t maxcode[18];              /* largest code of each length, or -1 */
  int32_t valoff[17];               /* symbol index - code, per length */
  uint8_t vals[256];
  int present;
} Huff;

/* spec: 16 counts (BITS) then 256 symbols (HUFFVAL), as in the DHT
 * segment; counts all zero means the table was never defined. A DC table's
 * symbols (bit counts) must not exceed 15, as libjpeg requires. */
static int huff_build(Huff* t, const uint8_t* spec, int dc) {
  int total = 0, l, i, k = 0;
  int32_t code = 0;
  memset(t, 0, sizeof(*t));
  for (l = 1; l <= 16; ++l) total += spec[l - 1];
  if (total == 0) return kMissingHuffmanTable;
  if (total > 256) return kBadHuffmanTable;
  memcpy(t->vals, spec + 16, (size_t)total);
  for (i = 0; dc && i < total; ++i) {
    if (t->vals[i] > 15) return kBadHuffmanTable;
  }
  for (l = 1; l <= 16; ++l) {
    const int n = spec[l - 1];
    /* libjpeg (jdhuff.c) refuses a table whose codes overflow their length;
     * no code may be all ones. Checked before the lookup entries of this
     * length are written, so their index stays below 1 << LOOK_BITS. */
    if (code + n >= (1L << l)) return kBadHuffmanTable;
    if (n) {
      t->valoff[l] = k - code;
      for (i = 0; i < n; ++i, ++k, ++code) {
        if (l <= LOOK_BITS) {
          const int shift = LOOK_BITS - l;
          int j;
          for (j = 0; j < (1 << shift); ++j) {
            t->look_len[(code << shift) | j] = (uint8_t)l;
            t->look_sym[(code << shift) | j] = t->vals[k];
          }
        }
      }
      t->maxcode[l] = code - 1;
    } else {
      t->maxcode[l] = -1;
    }
    code <<= 1;
  }
  t->maxcode[17] = 0x7fffffff;
  t->present = 1;
  return kOk;
}

/* ---- bit reader ---------------------------------------------------------- */

typedef struct {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf;      /* bits, most significant first; zeros below them */
  int bits;          /* bits of data in buf */
  int at_marker;     /* the data ended or reached a marker */
  int insufficient;  /* zero bits were consumed past the data */
} Bits;

static void fill(Bits* b) {
  while (b->bits <= 56) {
    int c;
    if (b->at_marker || b->p >= b->end) {
      b->at_marker = 1;
      return;
    }
    c = *b->p;
    if (c == 0xFF) { /* fill bytes, then 0x00 for a data byte 0xFF */
      const uint8_t* q = b->p + 1;
      while (q < b->end && *q == 0xFF) ++q;
      if (q >= b->end || *q != 0x00) { /* a marker (or the end) */
        b->at_marker = 1;
        return;
      }
      b->p = q + 1;
    } else {
      b->p += 1;
    }
    b->buf |= (uint64_t)c << (56 - b->bits);
    b->bits += 8;
  }
}

/* at least n (<= 32) bits in buf where the data has them; past its end
 * buf reads as zero bits */
static inline void need(Bits* b, int n) {
  if (b->bits < n) fill(b);
}

/* n bits consumed; more than the data held sets `insufficient` */
static inline void consume(Bits* b, int n) {
  b->buf <<= n;
  b->bits -= n;
  if (b->bits < 0) {
    b->insufficient = 1;
    b->bits = 0;
  }
}

static inline int get_bits(Bits* b, int n) {
  int v;
  if (n == 0) return 0;
  need(b, n);
  v = (int)(b->buf >> (64 - n));
  consume(b, n);
  return v;
}

static inline int get_bit(Bits* b) { return get_bits(b, 1); }

/* one Huffman symbol; a code no table holds gives 0 after 17 bits, as in
 * libjpeg (jdhuff.c, jpeg_huff_decode) */
static inline int decode_sym(Bits* b, const Huff* t) {
  int l;
  int32_t code;
  need(b, 17);
  {
    const int look = (int)(b->buf >> (64 - LOOK_BITS));
    const int len = t->look_len[look];
    if (len) {
      consume(b, len);
      return t->look_sym[look];
    }
  }
  code = (int32_t)(b->buf >> (64 - LOOK_BITS));
  l = LOOK_BITS;
  while (l < 16 && code > t->maxcode[l]) {
    ++l;
    code = (int32_t)(b->buf >> (64 - l));
  }
  if (code > t->maxcode[l]) {
    consume(b, 17);
    return 0;
  }
  consume(b, l);
  return t->vals[(t->valoff[l] + code) & 0xff];
}

static inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + (int)((unsigned)-1 << s) + 1 : v;
}

/* At the end of a restart interval: drop the buffered bits and find the
 * RSTn marker, resynchronising as libjpeg does (jdmarker.c,
 * read_restart_marker and jpeg_resync_to_restart). The expected RSTn, or
 * one too far from it to be a neighbour, is stepped over and decoding goes
 * on; one of the next two RSTs, any other valid marker, or the end of the
 * data is left in place, so the interval reads zero bits (then nothing, as
 * below); one of the previous two RSTs, or an invalid marker (below SOF0),
 * is skipped and the search goes on. */
static void restart(Bits* b, int* next_rst) {
  const uint8_t* p = b->p;
  const int want = *next_rst;
  b->buf = 0;
  b->bits = 0;
  *next_rst = (want + 1) & 7;
  for (;;) {
    int m, d;
    while (p + 1 < b->end &&
           !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF)) {
      ++p;
    }
    if (p + 1 >= b->end) break; /* the data ends without a marker */
    m = p[1];
    if (m < 0xC0) { /* not a valid marker: skipped */
      p += 2;
      continue;
    }
    if (m < 0xD0 || m > 0xD7) break; /* another marker: left */
    d = (m - 0xD0 - want) & 7;
    if (d == 1 || d == 2) break;  /* the next two: left for later */
    if (d == 6 || d == 7) {       /* the previous two: skipped */
      p += 2;
      continue;
    }
    b->p = p + 2; /* the expected one, or too far away to tell */
    b->at_marker = 0;
    b->insufficient = 0;
    return;
  }
  b->p = p;
  b->at_marker = 1;
}

/* ---- scans --------------------------------------------------------------- */

typedef struct {
  int16_t* coef;  /* [rows of blocks][bw][64], natural order */
  int bw;         /* blocks per row of the buffer */
  int h, v;       /* sampling factors */
  int wib, hib;   /* blocks of the component's real samples */
  const Huff* dc;
  const Huff* ac;
  int pred;       /* DC predictor */
} ScanComp;

/* data: the scan's entropy-coded data, up to the end of the file (the
 * decode stops at the first marker that is not an expected RST). desc:
 * progressive, Ss, Se, Ah, Al, restart interval, number of scan components
 * n, MCUs per row, MCU rows, then per scan component: its buffer index
 * (0..3), h, v, buffer blocks per row, blocks wide, blocks high, DC table
 * (0..3), AC table (0..3). coef: four buffers (unused ones null). huff: 8
 * tables of 16 + 256 bytes, DC 0..3 then AC 0..3. *stop: the offset of the
 * first byte not read, where libjpeg looks for the next marker (len when
 * the data ran out without one). */
int jpeg_decode_scan(const uint8_t* data, int64_t len, const int32_t* desc,
                     int16_t* coef0, int16_t* coef1, int16_t* coef2,
                     int16_t* coef3, const uint8_t* huff, int64_t* stop) {
  int16_t* bufs[4] = {coef0, coef1, coef2, coef3};
  const int prog = desc[0], Ss = desc[1], Se = desc[2], Ah = desc[3];
  const int Al = desc[4], interval = desc[5], n = desc[6];
  const int mcux = desc[7], mcuy = desc[8];
  Huff* tables;
  ScanComp comps[4];
  Bits b;
  int i, err = kOk, next_rst = 0, eobrun = 0, mcu, left;
  *stop = 0;
  if (n < 1 || n > 4) return kBadScan;
  tables = (Huff*)malloc(8 * sizeof(Huff));
  if (tables == NULL) return kBadScan;
  memset(tables, 0, 8 * sizeof(Huff));
  for (i = 0; i < n; ++i) {
    const int32_t* c = desc + 9 + 8 * i;
    ScanComp* s = &comps[i];
    s->coef = bufs[c[0]];
    s->h = c[1];
    s->v = c[2];
    s->bw = c[3];
    s->wib = c[4];
    s->hib = c[5];
    s->pred = 0;
    s->dc = s->ac = NULL;
    /* the tables this scan decodes with */
    if (!prog || (Ss == 0 && Ah == 0)) {
      Huff* t = &tables[c[6]];
      if (!t->present) {
        err = huff_build(t, huff + c[6] * 272, 1);
        if (err) goto done;
      }
      s->dc = t;
    }
    if (!prog || Ss > 0) {
      Huff* t = &tables[4 + c[7]];
      if (!t->present) {
        err = huff_build(t, huff + (4 + c[7]) * 272, 0);
        if (err) goto done;
      }
      s->ac = t;
    }
    if (s->coef == NULL) {
      err = kBadScan;
      goto done;
    }
  }
  b.p = data;
  b.end = data + len;
  b.buf = 0;
  b.bits = 0;
  b.at_marker = 0;
  b.insufficient = 0;
  left = interval;
  for (mcu = 0; mcu < mcux * mcuy; ++mcu) {
    const int mx = mcu % mcux, my = mcu / mcux;
    int ci;
    if (interval && left == 0) {
      restart(&b, &next_rst);
      for (ci = 0; ci < n; ++ci) comps[ci].pred = 0;
      eobrun = 0;
      left = interval;
    }
    --left;
    if (b.insufficient) continue; /* the rest of the interval stays zero */
    for (ci = 0; ci < n; ++ci) {
      ScanComp* s = &comps[ci];
      /* one block for a single-component scan, else h x v */
      const int bh = n == 1 ? 1 : s->v, bwn = n == 1 ? 1 : s->h;
      int by, bx;
      for (by = 0; by < bh; ++by) {
        for (bx = 0; bx < bwn; ++bx) {
          const int row = n == 1 ? my : my * s->v + by;
          const int col = n == 1 ? mx : mx * s->h + bx;
          int16_t* blk = s->coef + ((int64_t)row * s->bw + col) * 64;
          int k;
          if (!prog) { /* sequential: the whole block */
            int t = decode_sym(&b, s->dc);
            if (t) t = extend(get_bits(&b, t), t);
            s->pred = (int)((unsigned)s->pred + (unsigned)t);
            blk[0] = (int16_t)s->pred;
            for (k = 1; k < 64; ++k) {
              int r, sym = decode_sym(&b, s->ac);
              r = sym >> 4;
              sym &= 15;
              if (sym) {
                k += r;
                blk[kNatural[k]] = (int16_t)extend(get_bits(&b, sym), sym);
              } else {
                if (r != 15) break;
                k += 15;
              }
            }
          } else if (Ss == 0) { /* DC, first scan or refinement */
            if (Ah == 0) {
              int t = decode_sym(&b, s->dc);
              if (t) t = extend(get_bits(&b, t), t);
              s->pred = (int)((unsigned)s->pred + (unsigned)t);
              blk[0] = (int16_t)((unsigned)s->pred << Al);
            } else if (get_bit(&b)) {
              blk[0] = (int16_t)(blk[0] | (1 << Al));
            }
          } else if (Ah == 0) { /* AC first scan */
            if (eobrun > 0) {
              --eobrun;
              continue;
            }
            for (k = Ss; k <= Se; ++k) {
              int r, sym = decode_sym(&b, s->ac);
              r = sym >> 4;
              sym &= 15;
              if (sym) {
                k += r;
                blk[kNatural[k]] = (int16_t)(
                    (unsigned)extend(get_bits(&b, sym), sym) << Al);
              } else {
                if (r == 15) {
                  k += 15;
                } else {
                  eobrun = 1 << r;
                  if (r) eobrun += get_bits(&b, r);
                  --eobrun;
                  break;
                }
              }
            }
          } else { /* AC refinement (libjpeg's decode_mcu_AC_refine) */
            const int p1 = 1 << Al, m1 = (int)((unsigned)-1 << Al);
            k = Ss;
            if (eobrun == 0) {
              for (; k <= Se; ++k) {
                int r, sym = decode_sym(&b, s->ac), val = 0;
                r = sym >> 4;
                sym &= 15;
                if (sym) {
                  val = get_bit(&b) ? p1 : m1;
                } else if (r != 15) {
                  eobrun = 1 << r;
                  if (r) eobrun += get_bits(&b, r);
                  break;
                }
                /* over nonzero coefficients (a correction bit each) and r
                 * zero ones */
                do {
                  int16_t* c = blk + kNatural[k];
                  if (*c != 0) {
                    if (get_bit(&b) && (*c & p1) == 0) {
                      *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
                    }
                  } else if (--r < 0) {
                    break;
                  }
                  ++k;
                } while (k <= Se);
                if (val) blk[kNatural[k]] = (int16_t)val;
              }
            }
            if (eobrun > 0) {
              for (; k <= Se; ++k) {
                int16_t* c = blk + kNatural[k];
                if (*c != 0 && get_bit(&b) && (*c & p1) == 0) {
                  *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
                }
              }
              --eobrun;
            }
          }
        }
      }
    }
  }
  *stop = b.p - data;
done:
  free(tables);
  return err;
}

/* ---- output -------------------------------------------------------------- */

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 2446
#define FIX_0_390180644 3196
#define FIX_0_541196100 4433
#define FIX_0_765366865 6270
#define FIX_0_899976223 7373
#define FIX_1_175875602 9633
#define FIX_1_501321110 12299
#define FIX_1_847759065 15137
#define FIX_1_961570560 16069
#define FIX_2_053119869 16819
#define FIX_2_562915447 20995
#define FIX_3_072711026 25172
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

typedef struct {
  /* jdcolor.c's YCbCr -> RGB tables, SCALEBITS 16 */
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
} Tables;

static void init_tables(Tables* t) {
  int i;
  for (i = 0; i < 256; ++i) {
    const int64_t x = i - 128;
    const int64_t half = (int64_t)1 << 15;
    t->cr_r[i] = (int)((91881 * x + half) >> 16);   /* FIX(1.40200) */
    t->cb_b[i] = (int)((116130 * x + half) >> 16);  /* FIX(1.77200) */
    t->cr_g[i] = -46802 * x;                        /* -FIX(0.71414) */
    t->cb_g[i] = -22554 * x + half;                 /* -FIX(0.34414) */
  }
}

static inline int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

/* 16-bit lanes: a wrapped value, and a saturated one */
static inline int w16(int64_t x) { return (int16_t)(uint16_t)x; }
static inline int s16(int64_t x) {
  return x > 32767 ? 32767 : (x < -32768 ? -32768 : (int)x);
}

/* One 8-point pass of the islow IDCT on in[0..7] (each a 16-bit value, at
 * `step` apart), into out[0..7] descaled by `shift` and saturated to 16
 * bits. The products and their sums are jidctint.c's exactly (no 32-bit
 * sum can overflow for 16-bit inputs); in0 +- in4, in7 + in3 and in5 + in1
 * are 16-bit sums, as in the SIMD code's lanes. */
static void idct_pass(const int* in, int step, int* out, int shift) {
  const int64_t i0 = in[0], i1 = in[step], i2 = in[2 * step];
  const int64_t i3 = in[3 * step], i4 = in[4 * step], i5 = in[5 * step];
  const int64_t i6 = in[6 * step], i7 = in[7 * step];
  const int64_t t3 = i2 * (FIX_0_541196100 + FIX_0_765366865) +
                     i6 * FIX_0_541196100;
  const int64_t t2 = i2 * FIX_0_541196100 +
                     i6 * (FIX_0_541196100 - FIX_1_847759065);
  const int64_t t0 = (int64_t)w16(i0 + i4) * (1 << CONST_BITS);
  const int64_t t1 = (int64_t)w16(i0 - i4) * (1 << CONST_BITS);
  const int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
  const int64_t z3 = w16(i7 + i3), z4 = w16(i5 + i1);
  const int64_t z3b = z3 * (FIX_1_175875602 - FIX_1_961570560) +
                      z4 * FIX_1_175875602;
  const int64_t z4b = z3 * FIX_1_175875602 +
                      z4 * (FIX_1_175875602 - FIX_0_390180644);
  const int64_t o0 = i7 * (FIX_0_298631336 - FIX_0_899976223) -
                     i1 * FIX_0_899976223 + z3b;
  const int64_t o3 = -i7 * FIX_0_899976223 +
                     i1 * (FIX_1_501321110 - FIX_0_899976223) + z4b;
  const int64_t o1 = i5 * (FIX_2_053119869 - FIX_2_562915447) -
                     i3 * FIX_2_562915447 + z4b;
  const int64_t o2 = -i5 * FIX_2_562915447 +
                     i3 * (FIX_3_072711026 - FIX_2_562915447) + z3b;
  out[0] = s16(DESCALE(t10 + o3, shift));
  out[7] = s16(DESCALE(t10 - o3, shift));
  out[1] = s16(DESCALE(t11 + o2, shift));
  out[6] = s16(DESCALE(t11 - o2, shift));
  out[2] = s16(DESCALE(t12 + o1, shift));
  out[5] = s16(DESCALE(t12 - o1, shift));
  out[3] = s16(DESCALE(t13 + o0, shift));
  out[4] = s16(DESCALE(t13 - o0, shift));
}

/* Dequantise and invert one block into 8 rows of out, as libjpeg-turbo's
 * x86 SIMD islow IDCT (jidctint-avx2.asm), which cv2 runs, computes it: the
 * arithmetic of jidctint.c in 16-bit lanes. Where nothing leaves 16 bits,
 * which holds for every block an encoder writes from 8-bit samples, that
 * is jidctint.c's result; for coefficients from corrupt data, the
 * dequantised values wrap, the first pass saturates, and the result is
 * clamped to 0..255 (jidctint.c would wrap it). A block whose rows 1-7
 * are all zero takes the SIMD code's shortcut: each column's dequantised
 * DC shifted left by PASS1_BITS in 16 bits (wrapped, where the full pass
 * saturates). The column and row shortcuts below give the full passes'
 * results exactly. */
static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                       int64_t stride) {
  int dq[64], ws[64], row[8], r, c, ac = 0;
  for (c = 0; c < 64; ++c) {
    dq[c] = w16((int64_t)in[c] * q[c]);
    if (c >= 8) ac |= in[c];
  }
  for (c = 0; c < 8; ++c) {
    int col_ac = 0;
    for (r = 1; r < 8; ++r) col_ac |= in[r * 8 + c];
    if (col_ac) {
      idct_pass(dq + c, 8, row, CONST_BITS - PASS1_BITS);
      for (r = 0; r < 8; ++r) ws[r * 8 + c] = row[r];
    } else {
      const int v = ac ? s16(dq[c] * (1 << PASS1_BITS))
                       : w16(dq[c] * (1 << PASS1_BITS));
      for (r = 0; r < 8; ++r) ws[r * 8 + c] = v;
    }
  }
  for (r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if ((w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7]) == 0) {
      memset(o, clampi((w[0] + 16) >> 5, -128, 127) + 128, 8);
      continue;
    }
    idct_pass(w, 1, row, CONST_BITS + PASS1_BITS + 3);
    for (c = 0; c < 8; ++c) o[c] = (uint8_t)(clampi(row[c], -128, 127) + 128);
  }
}


/* One component's samples at full size, H x W, from its IDCT plane (dw x
 * dh real samples, `stride` apart) with libjpeg-turbo's upsampler: sums
 * over a row padded by one repeated sample at each end (the triangle
 * filters' edge cases are exactly that repetition), the rows above the
 * first and below the last repeating those. */
static int upsample(const uint8_t* pl, int64_t stride, int dw, int dh, int hr,
                    int vr, uint8_t* out, int H, int W) {
  int y, x, j;
  int* sum = (int*)malloc(sizeof(int) * (size_t)(dw + 2));
  uint8_t* row = (uint8_t*)malloc((size_t)(2 * dw + 2));
  if (sum == NULL || row == NULL) {
    free(sum);
    free(row);
    return kBadScan;
  }
  for (y = 0; y < H; ++y) {
    uint8_t* o = out + (int64_t)y * W;
    const int i = y / vr;
    const uint8_t* in0 = pl + i * stride;
    if (hr == 1 && vr == 1) {
      memcpy(o, in0, (size_t)W);
    } else if (hr == 2 && dw > 2 && (vr == 1 || vr == 2)) {
      /* h2v1: sum = 4 x sample (one shift serves both), rounding biases
       * 1 and 2 (x 4); h2v2: the vertical triangle 3 x nearer row +
       * farther row, biases 8 and 7 */
      const int lower = y & 1;
      const uint8_t* in1 =
          pl + clampi(lower ? i + 1 : i - 1, 0, dh - 1) * stride;
      const int b0 = vr == 1 ? 4 : 8, b1 = vr == 1 ? 8 : 7;
      int* c = sum + 1;
      for (j = 0; j < dw; ++j) {
        c[j] = vr == 1 ? 4 * in0[j] : 3 * in0[j] + in1[j];
      }
      c[-1] = c[0];
      c[dw] = c[dw - 1];
      for (j = 0; j < dw; ++j) {
        row[2 * j] = (uint8_t)((3 * c[j] + c[j - 1] + b0) >> 4);
        row[2 * j + 1] = (uint8_t)((3 * c[j] + c[j + 1] + b1) >> 4);
      }
      memcpy(o, row, (size_t)W);
    } else if (hr == 1 && vr == 2) { /* h1v2 */
      const int lower = y & 1, bias = lower ? 2 : 1;
      const uint8_t* in1 =
          pl + clampi(lower ? i + 1 : i - 1, 0, dh - 1) * stride;
      for (x = 0; x < W; ++x) {
        o[x] = (uint8_t)((3 * in0[x] + in1[x] + bias) >> 2);
      }
    } else { /* any other integral factor: replication */
      for (x = 0; x < W; ++x) o[x] = in0[x / hr];
    }
  }
  free(sum);
  free(row);
  return kOk;
}

/* comp: per component h, v, buffer blocks per row, blocks wide, blocks
 * high (the real samples' blocks); coef as for jpeg_decode_scan; quant: per
 * component 64 divisors in natural order. color: 0 gray (one component,
 * repeated), 1 YCbCr -> RGB, 2 RGB as it is. out: H x W x 3 RGB. Returns 0,
 * or kBadScan for a sampling factor libjpeg does not upsample (fractional)
 * or a failed allocation. */
int jpeg_output(int H, int W, int ncomp, const int32_t* comp, int16_t* coef0,
                int16_t* coef1, int16_t* coef2, int16_t* coef3,
                const uint16_t* quant, int color, uint8_t* out) {
  int16_t* bufs[4] = {coef0, coef1, coef2, coef3};
  uint8_t* full[3] = {NULL, NULL, NULL};
  int hmax = 1, vmax = 1, c, err = kOk;
  int64_t i, npix = (int64_t)H * W;
  Tables t;
  init_tables(&t);
  if (ncomp != 1 && ncomp != 3) return kBadScan;
  for (c = 0; c < ncomp; ++c) {
    if (comp[5 * c] > hmax) hmax = comp[5 * c];
    if (comp[5 * c + 1] > vmax) vmax = comp[5 * c + 1];
  }
  for (c = 0; c < ncomp; ++c) {
    const int h = comp[5 * c], v = comp[5 * c + 1], bw = comp[5 * c + 2];
    const int wib = comp[5 * c + 3], hib = comp[5 * c + 4];
    const int64_t stride = (int64_t)wib * 8;
    const int dw = (int)(((int64_t)W * h + hmax - 1) / hmax);
    const int dh = (int)(((int64_t)H * v + vmax - 1) / vmax);
    uint8_t* plane;
    int by, bx;
    if (hmax % h || vmax % v) {
      err = kBadScan;
      goto done;
    }
    plane = (uint8_t*)malloc((size_t)(stride * hib * 8));
    full[c] = (uint8_t*)malloc((size_t)npix);
    if (plane == NULL || full[c] == NULL) {
      free(plane);
      err = kBadScan;
      goto done;
    }
    for (by = 0; by < hib; ++by) {
      for (bx = 0; bx < wib; ++bx) {
        idct_islow(bufs[c] + ((int64_t)by * bw + bx) * 64, quant + 64 * c,
                   plane + (int64_t)by * 8 * stride + bx * 8, stride);
      }
    }
    err = upsample(plane, stride, dw, dh, hmax / h, vmax / v, full[c], H, W);
    free(plane);
    if (err) goto done;
  }
  if (color == 0 || ncomp == 1) {
    for (i = 0; i < npix; ++i) {
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = full[0][i];
    }
  } else if (color == 2) {
    for (i = 0; i < npix; ++i) {
      out[3 * i] = full[0][i];
      out[3 * i + 1] = full[1][i];
      out[3 * i + 2] = full[2][i];
    }
  } else {
    for (i = 0; i < npix; ++i) {
      const int y = full[0][i], cb = full[1][i], cr = full[2][i];
      out[3 * i] = (uint8_t)clampi(y + t.cr_r[cr], 0, 255);
      out[3 * i + 1] = (uint8_t)clampi(
          y + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16), 0, 255);
      out[3 * i + 2] = (uint8_t)clampi(y + t.cb_b[cb], 0, 255);
    }
  }
done:
  for (c = 0; c < 3; ++c) free(full[c]);
  return err;
}
