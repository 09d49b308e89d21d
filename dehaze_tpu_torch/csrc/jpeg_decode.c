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
 *   jpeg_decode_scan_arith
 *                     the same for an arithmetic-coded scan (SOF9, SOF10),
 *                     as libjpeg's jdarith.c decodes it, with the DAC
 *                     conditioning;
 *   jpeg_output       dequantisation (with libjpeg's block smoothing for a
 *                     progressive image whose low coefficients are not all
 *                     refined), the integer inverse DCT, chroma upsampling
 *                     and colour conversion into 8-bit RGB (CMYK and YCCK
 *                     as OpenCV converts libjpeg's CMYK).
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
 * restart interval is left zero (libjpeg's "insufficient data"); an
 * arithmetic-coded scan reads zero bytes from there on. Data that ends with
 * no marker at all is different: cv2's source manager cannot supply more,
 * so libjpeg suspends (Huffman) or fails (arithmetic) wherever it asks for
 * a byte past the end, and cv2 returns nothing. Whether libjpeg-turbo asks
 * depends on how far its bit buffer reads ahead, so a sequential Huffman
 * scan replays its reads alongside the decode (see Lj) and reports
 * kSuspended where libjpeg-turbo would ask.
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
  kSuspended = 4,
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
  uint8_t* ev;       /* if set, the reads of this MCU (see Lj) */
  int nev;
} Bits;

/* the read log: a Huffman symbol of n bits is EV_SYM + n, n value bits n */
#define EV_SYM 32
#define EV_MAX 2048 /* above 10 blocks x (1 + 63) x 2 reads */

static inline void log_read(Bits* b, int e) {
  if (b->ev != NULL && b->nev < EV_MAX) b->ev[b->nev++] = (uint8_t)e;
}

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
  log_read(b, n);
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
      log_read(b, EV_SYM + len);
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
    log_read(b, EV_SYM + 17);
    consume(b, 17);
    return 0;
  }
  log_read(b, EV_SYM + l);
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
 * is skipped and the search goes on. Returns 1 when the data ends before any
 * marker (libjpeg then waits for more data, which cv2 cannot give). */
static int restart(Bits* b, int* next_rst) {
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
    return 0;
  }
  b->p = p;
  b->at_marker = 1;
  return p + 1 >= b->end;
}

/* ---- libjpeg-turbo's bit buffer, replayed ------------------------------ */

/* Where the data ends with no marker, whether cv2 decodes a sequential
 * Huffman scan depends on libjpeg-turbo's reads, not on the bits the scan
 * needs: its bit buffer refills to at least 57 bits whenever a read finds
 * fewer bits than it needs (8 to look a symbol up, 9 and then 1 at a time
 * for a longer code, n for n value bits), and a refill that meets the end
 * of the data suspends (jdhuff.c, jpeg_fill_bit_buffer). An MCU with at
 * least 512 bytes per block left and no restart interval goes through the
 * fast decoder instead, which refills by 6 bytes whenever 16 bits or fewer
 * remain and starts the MCU over on the slow path if it meets 0xFF before a
 * byte other than 0 (decode_mcu_fast). Lj follows those reads over the log
 * of each MCU's reads; only whether it suspends is used. */
typedef struct {
  const uint8_t* p;
  const uint8_t* end;
  int left;      /* bits_left */
  int marker;    /* unread_marker set: no more reads */
  int suspended;
} Lj;

#define LJ_MIN_GET_BITS 57

static void lj_fill(Lj* s, int nbits) {
  while (!s->marker && s->left < LJ_MIN_GET_BITS) {
    int c;
    if (s->p >= s->end) {
      s->suspended = 1;
      return;
    }
    c = *s->p++;
    if (c == 0xFF) {
      do {
        if (s->p >= s->end) {
          s->suspended = 1;
          return;
        }
        c = *s->p++;
      } while (c == 0xFF);
      if (c != 0) {
        s->marker = 1;
        break;
      }
    }
    s->left += 8;
  }
  if (s->marker && nbits > s->left) s->left = LJ_MIN_GET_BITS;
}

static void lj_need(Lj* s, int n) {
  if (s->left < n) lj_fill(s, n);
}

/* the fast path's refill; 0 when it meets a marker (or 0xFF 0xFF) */
static int lj_fill_fast(Lj* s) {
  int i, ok = 1;
  if (s->left > 16) return 1;
  for (i = 0; i < 6; ++i) {
    if (s->p + 1 >= s->end) return 0;
    s->left += 8;
    if (s->p[0] == 0xFF) {
      if (s->p[1] != 0) { /* backed out: the byte stays unread */
        s->left -= 8;
        ok = 0;
        continue;
      }
      s->p += 2;
    } else {
      s->p += 1;
    }
  }
  return ok;
}

static void lj_mcu(Lj* s, const uint8_t* ev, int nev, int blocks,
                   int interval) {
  int i;
  if (!interval && s->end - s->p >= 512 * (int64_t)blocks && !s->marker) {
    const Lj saved = *s;
    int ok = 1;
    for (i = 0; i < nev && ok; ++i) {
      ok = lj_fill_fast(s);
      s->left -= ev[i] >= EV_SYM ? ev[i] - EV_SYM : ev[i];
    }
    if (ok) return;
    *s = saved;
  }
  for (i = 0; i < nev && !s->suspended; ++i) {
    int n = ev[i];
    if (n >= EV_SYM) { /* a symbol of n bits */
      n -= EV_SYM;
      lj_need(s, 8);
      if (n <= 8) {
        s->left -= n;
      } else {
        lj_need(s, 9);
        s->left -= 9;
        for (n -= 9; n > 0; --n) {
          lj_need(s, 1);
          s->left -= 1;
        }
      }
    } else {
      lj_need(s, n);
      s->left -= n;
    }
  }
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
  int dc_tbl, ac_tbl;
  int dc_context; /* arithmetic DC conditioning */
} ScanComp;

/* desc (see jpeg_decode_scan) into comps; 0 or kBadScan */
static int scan_comps(const int32_t* desc, int16_t* const* bufs,
                      ScanComp* comps) {
  const int n = desc[6];
  int i;
  if (n < 1 || n > 4) return kBadScan;
  for (i = 0; i < n; ++i) {
    const int32_t* c = desc + 9 + 8 * i;
    ScanComp* s = &comps[i];
    if (c[0] < 0 || c[0] > 3 || bufs[c[0]] == NULL) return kBadScan;
    s->coef = bufs[c[0]];
    s->h = c[1];
    s->v = c[2];
    s->bw = c[3];
    s->wib = c[4];
    s->hib = c[5];
    s->dc_tbl = c[6] & 15;
    s->ac_tbl = c[7] & 15;
    s->pred = 0;
    s->dc_context = 0;
    s->dc = s->ac = NULL;
  }
  return kOk;
}

/* the block of scan component s at block row, column of MCU mcu, block
 * (by, bx) in it; one block per MCU in a single-component scan */
static inline int16_t* mcu_block(const ScanComp* s, int n, int mcu, int mcux,
                                 int by, int bx) {
  const int mx = mcu % mcux, my = mcu / mcux;
  const int row = n == 1 ? my : my * s->v + by;
  const int col = n == 1 ? mx : mx * s->h + bx;
  return s->coef + ((int64_t)row * s->bw + col) * 64;
}

/* data: the scan's entropy-coded data, up to the end of the file (the
 * decode stops at the first marker that is not an expected RST). desc:
 * progressive, Ss, Se, Ah, Al, restart interval, number of scan components
 * n, MCUs per row, MCU rows, then per scan component: its buffer index
 * (0..3), h, v, buffer blocks per row, blocks wide, blocks high, DC table,
 * AC table (0..3 for Huffman, 0..15 for arithmetic; a table the scan does
 * not use is not looked at). coef: four buffers (unused ones null). huff: 8
 * tables of 16 + 256 bytes, DC 0..3 then AC 0..3. *stop: the offset of the
 * first byte not read, where libjpeg looks for the next marker (len when
 * the data ran out without one); stop[1]: the last MCU begun before the data
 * ran short (libjpeg's last good iMCU row comes from it). */
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
  Lj lj;
  uint8_t* ev = NULL;
  int i, err, next_rst = 0, eobrun = 0, mcu, left, blocks = 0;
  stop[0] = stop[1] = 0;
  err = scan_comps(desc, bufs, comps);
  if (err) return err;
  tables = (Huff*)calloc(8, sizeof(Huff));
  if (!prog) ev = (uint8_t*)malloc(EV_MAX);
  if (tables == NULL || (!prog && ev == NULL)) {
    err = kBadScan;
    goto done;
  }
  for (i = 0; i < n; ++i) {
    ScanComp* s = &comps[i];
    blocks += n == 1 ? 1 : s->h * s->v;
    /* the tables this scan decodes with */
    if (!prog || (Ss == 0 && Ah == 0)) {
      Huff* t = &tables[s->dc_tbl & 3];
      if (s->dc_tbl > 3) {
        err = kBadScan;
        goto done;
      }
      if (!t->present) {
        err = huff_build(t, huff + s->dc_tbl * 272, 1);
        if (err) goto done;
      }
      s->dc = t;
    }
    if (!prog || Ss > 0) {
      Huff* t = &tables[4 + (s->ac_tbl & 3)];
      if (s->ac_tbl > 3) {
        err = kBadScan;
        goto done;
      }
      if (!t->present) {
        err = huff_build(t, huff + (4 + s->ac_tbl) * 272, 0);
        if (err) goto done;
      }
      s->ac = t;
    }
  }
  b.p = data;
  b.end = data + len;
  b.buf = 0;
  b.bits = 0;
  b.at_marker = 0;
  b.insufficient = 0;
  b.ev = ev;
  b.nev = 0;
  lj.p = data;
  lj.end = data + len;
  lj.left = 0;
  lj.marker = 0;
  lj.suspended = 0;
  left = interval;
  for (mcu = 0; mcu < mcux * mcuy; ++mcu) {
    int ci;
    if (interval && left == 0) {
      if (restart(&b, &next_rst)) lj.suspended = 1;
      for (ci = 0; ci < n; ++ci) comps[ci].pred = 0;
      eobrun = 0;
      left = interval;
      lj.p = b.p;
      lj.left = 0;
      lj.marker = b.at_marker;
    }
    --left;
    if (b.insufficient) continue; /* the rest of the interval stays zero */
    stop[1] = mcu;
    b.nev = 0;
    for (ci = 0; ci < n; ++ci) {
      ScanComp* s = &comps[ci];
      /* one block for a single-component scan, else h x v */
      const int bh = n == 1 ? 1 : s->v, bwn = n == 1 ? 1 : s->h;
      int by, bx;
      for (by = 0; by < bh; ++by) {
        for (bx = 0; bx < bwn; ++bx) {
          int16_t* blk = mcu_block(s, n, mcu, mcux, by, bx);
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
    if (!prog && !lj.suspended) lj_mcu(&lj, ev, b.nev, blocks, interval);
  }
  stop[0] = b.p - data;
  if (lj.suspended) err = kSuspended;
done:
  free(tables);
  free(ev);
  return err;
}

/* ---- arithmetic decoding (jdarith.c) ------------------------------------ */

/* ITU-T T.81 Table D.2 as libjpeg packs it (jaricom.c): Qe << 16, the next
 * index after an MPS << 8, the MPS switch << 7, the next index after an LPS;
 * entry 113 is the fixed probability 0.5 (T.851) */
#define V(qe, lps, mps, sw) \
  (((int32_t)(qe) << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
static const int32_t kAritab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0),    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),    V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0),   V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),   V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0),   V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),   V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0),   V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),   V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0),   V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),   V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0),   V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),   V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0),   V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),   V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0),   V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),   V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0), V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0), V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0), V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V

typedef struct {
  const uint8_t* p;
  const uint8_t* end;
  int64_t c;    /* base of the coding interval, and the input bits */
  int64_t a;    /* size of the coding interval */
  int ct;       /* bits of input left in c; -16 before the first two bytes */
  int marker;   /* reached a marker: zero bytes from here */
  int suspended; /* the data ended with no marker */
  int error;    /* a spectral or magnitude overflow: nothing more is read */
} Arith;

/* the next entropy-coded byte, as jdarith.c's arith_decode reads it: a
 * stuffed 0xFF 0x00 is 0xFF; a marker stays unread (p at its last 0xFF)
 * and gives zero bytes from then on */
static int arith_byte(Arith* e) {
  const uint8_t* q;
  if (e->marker) return 0;
  if (e->p >= e->end) {
    e->suspended = 1;
    return 0;
  }
  if (*e->p != 0xFF) return *e->p++;
  q = e->p + 1;
  while (q < e->end && *q == 0xFF) ++q;
  if (q >= e->end) {
    e->suspended = 1;
    return 0;
  }
  if (*q == 0) {
    e->p = q + 1;
    return 0xFF;
  }
  e->p = q - 1;
  e->marker = 1;
  return 0;
}

/* one binary decision with statistics bin st (T.81 D.2.4-D.2.6) */
static int arith_decode(Arith* e, uint8_t* st) {
  int64_t qe, temp;
  int sv, nl, nm;
  while (e->a < 0x8000) {
    if (--e->ct < 0) {
      e->c = (e->c << 8) | arith_byte(e);
      if ((e->ct += 8) < 0) {
        if (++e->ct == 0) e->a = 0x8000; /* the first two bytes are in */
      }
    }
    e->a <<= 1;
  }
  sv = *st;
  qe = kAritab[sv & 0x7F];
  nl = (int)(qe & 0xFF);
  qe >>= 8;
  nm = (int)(qe & 0xFF);
  qe >>= 8;
  temp = e->a - qe;
  e->a = temp;
  temp <<= e->ct;
  if (e->c >= temp) {
    e->c -= temp;
    if (e->a < qe) {
      e->a = qe;
      *st = (uint8_t)((sv & 0x80) ^ nm);
    } else {
      e->a = qe;
      *st = (uint8_t)((sv & 0x80) ^ nl);
      sv ^= 0x80;
    }
  } else if (e->a < 0x8000) {
    if (e->a < qe) {
      *st = (uint8_t)((sv & 0x80) ^ nl);
      sv ^= 0x80;
    } else {
      *st = (uint8_t)((sv & 0x80) ^ nm);
    }
  }
  return sv >> 7;
}

/* F.1.4.4.1 / F.2.4.1: one DC difference with its conditioning; updates the
 * component's context and predictor. 0, or 1 on a magnitude overflow */
static int arith_dc(Arith* e, uint8_t* dc_stats, ScanComp* s, int L, int U) {
  uint8_t* st = dc_stats + s->dc_context;
  int sign, m, v;
  if (arith_decode(e, st) == 0) {
    s->dc_context = 0;
    return 0;
  }
  sign = arith_decode(e, st + 1);
  st += 2 + sign;
  if ((m = arith_decode(e, st)) != 0) {
    st = dc_stats + 20;
    while (arith_decode(e, st)) {
      if ((m <<= 1) == 0x8000) return 1;
      st += 1;
    }
  }
  if (m < (int)((1L << L) >> 1)) {
    s->dc_context = 0;
  } else if (m > (int)((1L << U) >> 1)) {
    s->dc_context = 12 + sign * 4;
  } else {
    s->dc_context = 4 + sign * 4;
  }
  v = m;
  st += 14;
  while (m >>= 1) {
    if (arith_decode(e, st)) v |= m;
  }
  v += 1;
  if (sign) v = -v;
  s->pred = (s->pred + v) & 0xffff;
  return 0;
}

/* F.2.4.2: AC coefficients Ss..Se of one block, each scaled by << Al. 0, or
 * 1 on a spectral or magnitude overflow */
static int arith_ac(Arith* e, uint8_t* ac_stats, uint8_t* fixed_bin,
                    int16_t* blk, int Ss, int Se, int Al, int K) {
  int k;
  for (k = Ss; k <= Se; ++k) {
    uint8_t* st = ac_stats + 3 * (k - 1);
    int sign, m, v;
    if (arith_decode(e, st)) break; /* end of block */
    while (arith_decode(e, st + 1) == 0) {
      st += 3;
      if (++k > Se) return 1;
    }
    sign = arith_decode(e, fixed_bin);
    st += 2;
    if ((m = arith_decode(e, st)) != 0) {
      if (arith_decode(e, st)) {
        m <<= 1;
        st = ac_stats + (k <= K ? 189 : 217);
        while (arith_decode(e, st)) {
          if ((m <<= 1) == 0x8000) return 1;
          st += 1;
        }
      }
    }
    v = m;
    st += 14;
    while (m >>= 1) {
      if (arith_decode(e, st)) v |= m;
    }
    v += 1;
    if (sign) v = -v;
    blk[kNatural[k]] = (int16_t)((unsigned)v << Al);
  }
  return 0;
}

/* As jpeg_decode_scan, for an arithmetic-coded scan: cond holds the DAC
 * conditioning, L[16], U[16] (DC) then K[16] (AC). A scan that reads past
 * the end of the data without meeting a marker (libjpeg cannot suspend an
 * arithmetic decode, and fails) returns kSuspended. */
int jpeg_decode_scan_arith(const uint8_t* data, int64_t len,
                           const int32_t* desc, int16_t* coef0,
                           int16_t* coef1, int16_t* coef2, int16_t* coef3,
                           const uint8_t* cond, int64_t* stop) {
  int16_t* bufs[4] = {coef0, coef1, coef2, coef3};
  const int prog = desc[0], Ss = desc[1], Se = desc[2], Ah = desc[3];
  const int Al = desc[4], interval = desc[5], n = desc[6];
  const int mcux = desc[7], mcuy = desc[8];
  const int dc_scan = !prog || (Ss == 0 && Ah == 0), ac_scan = !prog || Ss;
  uint8_t dc_stats[16][64], ac_stats[16][256], fixed_bin[4] = {113, 0, 0, 0};
  ScanComp comps[4];
  Bits b; /* for restart(): the position and the marker state */
  Arith e;
  int err, next_rst = 0, mcu, left;
  stop[0] = 0;
  stop[1] = (int64_t)mcux * mcuy - 1; /* never short of data */
  err = scan_comps(desc, bufs, comps);
  if (err) return err;
  e.p = data;
  e.end = data + len;
  e.marker = e.suspended = e.error = 0;
  b.end = data + len;
  b.ev = NULL;
  left = interval;
  for (mcu = 0; mcu < mcux * mcuy && !e.suspended; ++mcu) {
    int ci;
    if (mcu == 0 || (interval && left == 0)) {
      /* statistics, predictors and the decoder start over */
      if (mcu > 0) {
        b.p = e.p;
        b.at_marker = e.marker;
        if (restart(&b, &next_rst)) {
          e.suspended = 1;
          break;
        }
        e.p = b.p;
        e.marker = b.at_marker;
      }
      for (ci = 0; ci < n; ++ci) {
        if (dc_scan) {
          memset(dc_stats[comps[ci].dc_tbl], 0, 64);
          comps[ci].pred = 0;
          comps[ci].dc_context = 0;
        }
        if (ac_scan) memset(ac_stats[comps[ci].ac_tbl], 0, 256);
      }
      e.c = 0;
      e.a = 0;
      e.ct = -16;
      e.error = 0;
      left = interval;
    }
    --left;
    /* after an overflow the rest of the interval is left as it is; a DC
     * refinement scan has no overflow and goes on */
    if (e.error && !(prog && Ss == 0 && Ah)) continue;
    if (prog && Ss == 0 && Ah) { /* DC refinement: the next bit of each */
      for (ci = 0; ci < n; ++ci) {
        ScanComp* s = &comps[ci];
        const int bh = n == 1 ? 1 : s->v, bwn = n == 1 ? 1 : s->h;
        int by, bx;
        for (by = 0; by < bh; ++by) {
          for (bx = 0; bx < bwn; ++bx) {
            int16_t* blk = mcu_block(s, n, mcu, mcux, by, bx);
            if (arith_decode(&e, fixed_bin)) {
              blk[0] = (int16_t)(blk[0] | (1 << Al));
            }
          }
        }
      }
      continue;
    }
    if (prog && Ss && Ah) { /* AC refinement (decode_mcu_AC_refine) */
      ScanComp* s = &comps[0];
      int16_t* blk = mcu_block(s, n, mcu, mcux, 0, 0);
      const int p1 = 1 << Al, m1 = (int)((unsigned)-1 << Al);
      uint8_t* stats = ac_stats[s->ac_tbl];
      int k, kex;
      for (kex = Se; kex > 0; --kex) {
        if (blk[kNatural[kex]]) break;
      }
      for (k = Ss; k <= Se && !e.error; ++k) {
        uint8_t* st = stats + 3 * (k - 1);
        if (k > kex && arith_decode(&e, st)) break; /* end of block */
        for (;;) {
          int16_t* c = blk + kNatural[k];
          if (*c) { /* nonzero before: a correction bit */
            if (arith_decode(&e, st + 2)) {
              *c = (int16_t)(*c < 0 ? *c + m1 : *c + p1);
            }
            break;
          }
          if (arith_decode(&e, st + 1)) { /* newly nonzero */
            *c = (int16_t)(arith_decode(&e, fixed_bin) ? m1 : p1);
            break;
          }
          st += 3;
          if (++k > Se) {
            e.error = 1;
            break;
          }
        }
      }
      continue;
    }
    for (ci = 0; ci < n && !e.error; ++ci) {
      ScanComp* s = &comps[ci];
      const int bh = n == 1 ? 1 : s->v, bwn = n == 1 ? 1 : s->h;
      int by, bx;
      for (by = 0; by < bh && !e.error; ++by) {
        for (bx = 0; bx < bwn && !e.error; ++bx) {
          int16_t* blk = mcu_block(s, n, mcu, mcux, by, bx);
          if (dc_scan) {
            if (arith_dc(&e, dc_stats[s->dc_tbl], s, cond[s->dc_tbl],
                         cond[16 + s->dc_tbl])) {
              e.error = 1;
              break;
            }
            blk[0] = (int16_t)(prog ? (unsigned)s->pred << Al
                                    : (unsigned)s->pred);
          }
          if (ac_scan &&
              arith_ac(&e, ac_stats[s->ac_tbl], fixed_bin, blk,
                       prog ? Ss : 1, prog ? Se : 63, prog ? Al : 0,
                       cond[32 + s->ac_tbl])) {
            e.error = 1;
          }
        }
      }
    }
  }
  stop[0] = e.p - data;
  return e.suspended ? kSuspended : kOk;
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

/* ---- block smoothing (jdcoefct.c, decompress_smooth_data) --------------- */

/* One smoothed estimate: pred = round(Q00 * num / (Q << 8)), clamped below
 * 1 << Al when Al > 0 (the coefficient is known to be smaller) */
static int smooth_pred(int64_t q00, int64_t q, int64_t sum, int Al) {
  const int64_t num = q00 * sum;
  int pred;
  if (num >= 0) {
    pred = (int)(((q << 7) + num) / (q << 8));
    if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
  } else {
    pred = (int)(((q << 7) - num) / (q << 8));
    if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
    pred = -pred;
  }
  return pred;
}

/* The smoothed estimates of one block (ws, a copy of it): dc holds the DCs
 * of the 5 x 5 blocks around, DCrc with r, c = 1..5 from the upper left;
 * bits and change_dc as in smooth_component. */
static void smooth_block(int16_t* ws, const int dc[5][5], const int32_t* bits,
                         int change_dc, const uint16_t* quant) {
  const int64_t Q00 = quant[0], Q01 = quant[1], Q10 = quant[8];
  const int64_t Q20 = quant[16], Q11 = quant[9], Q02 = quant[2];
  const int64_t Q03 = quant[3], Q12 = quant[10], Q21 = quant[17];
  const int64_t Q30 = quant[24];
  const int DC01 = dc[0][0], DC02 = dc[0][1], DC03 = dc[0][2];
  const int DC04 = dc[0][3], DC05 = dc[0][4], DC06 = dc[1][0];
  const int DC07 = dc[1][1], DC08 = dc[1][2], DC09 = dc[1][3];
  const int DC10 = dc[1][4], DC11 = dc[2][0], DC12 = dc[2][1];
  const int DC13 = dc[2][2], DC14 = dc[2][3], DC15 = dc[2][4];
  const int DC16 = dc[3][0], DC17 = dc[3][1], DC18 = dc[3][2];
  const int DC19 = dc[3][3], DC20 = dc[3][4], DC21 = dc[4][0];
  const int DC22 = dc[4][1], DC23 = dc[4][2], DC24 = dc[4][3];
  const int DC25 = dc[4][4];
  int Al;
  if ((Al = bits[1]) != 0 && ws[1] == 0) { /* AC01 */
    ws[1] = (int16_t)smooth_pred(Q00, Q01, change_dc ?
        (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
         13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 +
         3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 -
         DC21 - DC22 + DC24 + DC25) :
        (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15), Al);
  }
  if ((Al = bits[2]) != 0 && ws[8] == 0) { /* AC10 */
    ws[8] = (int16_t)smooth_pred(Q00, Q10, change_dc ?
        (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
         13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
         13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
         3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
        (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23), Al);
  }
  if ((Al = bits[3]) != 0 && ws[16] == 0) { /* AC20 */
    ws[16] = (int16_t)smooth_pred(Q00, Q20, change_dc ?
        (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
         14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 +
         DC23) :
        (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23), Al);
  }
  if ((Al = bits[4]) != 0 && ws[9] == 0) { /* AC11 */
    ws[9] = (int16_t)smooth_pred(Q00, Q11, change_dc ?
        (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 +
         DC21 - DC25) :
        (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
         DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09), Al);
  }
  if ((Al = bits[5]) != 0 && ws[2] == 0) { /* AC02 */
    ws[2] = (int16_t)smooth_pred(Q00, Q02, change_dc ?
        (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
         14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
         2 * DC19) :
        (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15), Al);
  }
  if (change_dc) {
    int64_t num;
    int pred;
    if ((Al = bits[6]) != 0 && ws[3] == 0) { /* AC03 */
      ws[3] = (int16_t)smooth_pred(Q00, Q03,
          DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19, Al);
    }
    if ((Al = bits[7]) != 0 && ws[10] == 0) { /* AC12 */
      ws[10] = (int16_t)smooth_pred(Q00, Q12,
          DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19, Al);
    }
    if ((Al = bits[8]) != 0 && ws[17] == 0) { /* AC21 */
      ws[17] = (int16_t)smooth_pred(Q00, Q21,
          DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19, Al);
    }
    if ((Al = bits[9]) != 0 && ws[24] == 0) { /* AC30 */
      ws[24] = (int16_t)smooth_pred(Q00, Q30,
          DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19, Al);
    }
    num = Q00 *
          (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
           6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
           8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
           6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
           2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
    if (num >= 0) {
      pred = (int)(((Q00 << 7) + num) / (Q00 << 8));
    } else {
      pred = -(int)(((Q00 << 7) - num) / (Q00 << 8));
    }
    ws[0] = (int16_t)pred;
  }
}

/* libjpeg-turbo's 5 x 5 smoothing of one component's blocks before the
 * IDCT, for a progressive image whose scans leave some of the first 10
 * coefficients (zigzag) unrefined. bits: the component's coefficient
 * precision (coef_bits) for those 10, -1 where no scan sent one, then the
 * same before the component's last scan, which iMCU rows after last_good
 * use (the last scan ran short of data there); when no AC coefficient was
 * sent at all the DC is smoothed too. The neighbours' DCs
 * are read as libjpeg reads them: columns clamped to the component's
 * blocks, block rows by iMCU row, quirk included (in the last iMCU row the
 * rows above are clamped by a count of that row's blocks, not the image's
 * block row). */
static void smooth_component(const int16_t* coef, int bw, int v, int wib,
                             int hib, int imcu_rows, const uint16_t* quant,
                             const int32_t* latch, int last_good,
                             uint8_t* plane, int64_t stride) {
  const int last_col = wib - 1;
  int r, b;
  for (r = 0; r < imcu_rows; ++r) {
    const int32_t* bits = latch + (r > last_good ? 10 : 0);
    const int change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 &&
                          bits[4] == -1 && bits[5] == -1 && bits[6] == -1 &&
                          bits[7] == -1 && bits[8] == -1 && bits[9] == -1;
    int block_rows = v;
    int64_t image_rows;
    if (r == imcu_rows - 1) {
      block_rows = hib % v;
      if (block_rows == 0) block_rows = v;
    }
    image_rows = (int64_t)block_rows * imcu_rows;
    for (b = 0; b < block_rows; ++b) {
      const int64_t row = (int64_t)r * v + b;           /* in the buffer */
      const int64_t irow = (int64_t)r * block_rows + b; /* libjpeg's count */
      const int16_t* cur = coef + row * bw * 64;
      const int16_t* prev = irow > 0 ? cur - bw * 64 : cur;
      const int16_t* pprev = irow > 1 ? cur - 2 * bw * 64 : prev;
      const int16_t* next = irow < image_rows - 1 ? cur + bw * 64 : cur;
      const int16_t* nnext = irow < image_rows - 2 ? cur + 2 * bw * 64 : next;
      int col;
      for (col = 0; col <= last_col; ++col) {
        /* the DCs of the 5 x 5 blocks around, columns clamped to the
         * component's blocks */
        int dc[5][5], i, j;
        int16_t ws[64];
        const int16_t* rows[5] = {pprev, prev, cur, next, nnext};
        for (i = 0; i < 5; ++i) {
          for (j = 0; j < 5; ++j) {
            const int cc = clampi(col + j - 2, 0, last_col);
            dc[i][j] = rows[i][(int64_t)cc * 64];
          }
        }
        memcpy(ws, cur + (int64_t)col * 64, sizeof(ws));
        smooth_block(ws, dc, bits, change_dc, quant);
        idct_islow(ws, quant, plane + row * 8 * stride + col * 8, stride);
      }
    }
  }
}

/* OpenCV's CMYK -> BGR of libjpeg's CMYK output (grfmt_jpeg.cpp, as cv2
 * 5.0 computes it: each of C, M, Y scaled by K) */
static inline uint8_t cmyk_channel(int x, int k) {
  return (uint8_t)(k - (((255 - x) * k) >> 8));
}

/* comp: per component h, v, buffer blocks per row, blocks wide, blocks
 * high (the real samples' blocks); coef as for jpeg_decode_scan; quant: per
 * component 64 divisors in natural order. color: 0 gray (one component,
 * repeated), 1 YCbCr -> RGB, 2 RGB as it is, 3 CMYK and 4 YCCK (four
 * components, libjpeg's CMYK output converted as OpenCV converts it).
 * smooth: null, or per component the 10 coefficient precisions with which
 * libjpeg smooths a progressive image's blocks and the 10 before the
 * component's last scan, then the last iMCU row that uses the first ten.
 * out: H x W x 3 RGB. Returns 0, or kBadScan for a sampling factor libjpeg
 * does not upsample (fractional) or a failed allocation. */
int jpeg_output(int H, int W, int ncomp, const int32_t* comp, int16_t* coef0,
                int16_t* coef1, int16_t* coef2, int16_t* coef3,
                const uint16_t* quant, int color, const int32_t* smooth,
                uint8_t* out) {
  int16_t* bufs[4] = {coef0, coef1, coef2, coef3};
  uint8_t* full[4] = {NULL, NULL, NULL, NULL};
  int hmax = 1, vmax = 1, c, err = kOk;
  int64_t i, npix = (int64_t)H * W;
  Tables t;
  init_tables(&t);
  if (ncomp != 1 && ncomp != 3 && ncomp != 4) return kBadScan;
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
    if (smooth != NULL) {
      smooth_component(bufs[c], bw, v, wib, hib,
                       (H + 8 * vmax - 1) / (8 * vmax), quant + 64 * c,
                       smooth + 20 * c, smooth[20 * ncomp], plane, stride);
    } else {
      for (by = 0; by < hib; ++by) {
        for (bx = 0; bx < wib; ++bx) {
          idct_islow(bufs[c] + ((int64_t)by * bw + bx) * 64, quant + 64 * c,
                     plane + (int64_t)by * 8 * stride + bx * 8, stride);
        }
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
  } else if (ncomp == 4) {
    for (i = 0; i < npix; ++i) {
      int cc = full[0][i], m = full[1][i], y = full[2][i];
      const int k = full[3][i];
      if (color == 4) { /* YCCK -> CMYK (jdcolor.c, ycck_cmyk_convert) */
        const int yy = cc, cb = m, cr = y;
        cc = 255 - clampi(yy + t.cr_r[cr], 0, 255);
        m = 255 - clampi(yy + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16), 0, 255);
        y = 255 - clampi(yy + t.cb_b[cb], 0, 255);
      }
      out[3 * i] = cmyk_channel(cc, k);
      out[3 * i + 1] = cmyk_channel(m, k);
      out[3 * i + 2] = cmyk_channel(y, k);
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
  for (c = 0; c < 4; ++c) free(full[c]);
  return err;
}
