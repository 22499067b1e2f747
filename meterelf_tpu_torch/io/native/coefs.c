/* coefs.c — the coefficient reader of the port's JPEG feed.
 *
 * Entropy-decodes the DCT-coefficient window of baseline 8-bit YCbCr
 * 4:2:0 JPEG streams on the host (pthreads), for the device back-half
 * (meterelf_tpu_torch/ops/jpegdec.py, csrc/jpeg.cu) to finish. A copy of
 * the fast baseline reader of meterelf_tpu/io/native/meterelf_jpeg.c
 * (mej_fast_coefs and its helpers, the compact packer and the batch
 * workers) that needs no libjpeg: it carries its own jpeg_natural_order
 * table and DCTSIZE2, and builds with
 *
 *     gcc -O3 -fPIC -shared -pthread coefs.c -o libmeterelf_coefs.so
 *
 * (meterelf_tpu_torch/io/native/build.py). Differences from the original:
 *  - no libjpeg suspension fallback: a stream the fast reader rejects
 *    (progressive, 4:4:4, 16-bit DQT, truncated, restart mismatch, ...)
 *    returns nonzero and the caller marks the frame not loaded;
 *  - the per-thread Huffman-table cache compares the stored counts and
 *    symbols with memcmp on a hash hit instead of trusting the 64-bit
 *    hash alone, so a hash collision cannot decode with a wrong table.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <pthread.h>

#define DCTSIZE2 64

/* zigzag index -> natural (row-major) index, with 16 extra entries of 63
 * so that a corrupt run cannot index past the block (jutils.c) */
static const int jpeg_natural_order[DCTSIZE2 + 16] = {
     0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63,
    63, 63, 63, 63, 63, 63, 63, 63
};

/* ---------------- fast baseline coefficient reader ----------------
 *
 * Hand-rolled Huffman decode of the coefficient window for the common
 * case: a CLEAN (untruncated, restart-consistent) 8-bit baseline
 * sequential Huffman YCbCr 4:2:0 stream — i.e. every frame the camera
 * actually produces. Compared to driving libjpeg's
 * jpeg_read_coefficients it skips the whole-image virtual coefficient
 * arrays (~1 MB alloc + zero per 640x480 frame), the per-image
 * decompress-object lifecycle, and the chunked suspension machinery;
 * coefficients land straight in the caller's window buffer and the
 * entropy scan early-stops at the window's last iMCU row exactly like
 * the libjpeg path.
 *
 * Returns 0 only on a fully clean decode. ANY anomaly — truncation,
 * marker surprises, bogus Huffman runs, restart mismatch, unsupported
 * layout, frame-size or window mismatch — returns nonzero, and the
 * frame is reported as not loaded (this reader has no libjpeg path to
 * fall back to; the comments below that name one describe where the
 * original reader hands such a stream on).
 *
 * Output conventions match libjpeg's decoder: coefficients stored in
 * natural (raster) order via jpeg_natural_order (jdhuff.c does the
 * same), quant tables are the last DQT definitions preceding SOS in
 * natural order (as quant_tbl_ptrs holds them). */

typedef struct {
    uint8_t len;              /* code length for LUT hits; 0 = escape */
    uint8_t sym;
} mej_hlut;

/* Multi-symbol AC table: ONE 10-bit peek resolves up to TWO
 * coefficients — Huffman code(s) plus appended value bits — when they
 * fit the window. Corpus stats (quality-92 webcam frames): 65% of AC
 * coefficients are followed by another short coefficient and 77% of
 * EOBs directly follow a short coefficient, so most hot-loop
 * iterations retire two symbols from a single table load. The 10-bit
 * key keeps the table at 8 KB (1024 x 8 B) — the same L1 footprint as
 * the single-symbol 12-bit table it replaces; a 12-bit x 8 B variant
 * measured SLOWER (32 KB/table thrashes L1 against the second
 * component's table and the stream data).
 *
 * Measured design notes (v5e host VM, corpus A/B, ~+-8% machine
 * noise): fusing a trailing EOB into the coefficient's entry (77% of
 * EOBs follow a short coefficient) is at-or-slightly-above parity and
 * retires the block's final two symbols in one load; full
 * (coef, coef) pairing — 65% of coefficients pair-fit — was tried in
 * two forms (per-kind branch chain, fully branchless masked stores)
 * and measured 15-20% SLOWER than the single-symbol loop despite 31%
 * fewer iterations: the extra per-iteration machinery loses more than
 * the saved table-load trips on this core. Kept single-symbol + EOB
 * fusion.
 *
 * u64 entry layout:
 *   bits 0-5   nb     total bits consumed, value bits and any fused
 *                     EOB included (0 = full escape to peekdec)
 *   bits 6-7   kd     0 coefficient/EOB, 1 ZRL, 2 coef code resolved
 *                     with value bits pending (v1 = size, nb = len)
 *   bit  8     brk    end of block after this entry (bare EOB, or a
 *                     coefficient with the following EOB fused in)
 *   bit  9     st1    store v1 (0 = bare EOB)
 *   bits 10-15 r1     zero run before the coefficient
 *   bits 16-21 nb1    bits of the coefficient alone — a fused-EOB
 *                     entry demotes to this when the coefficient lands
 *                     on index 63 (the block ends there; the EOB code
 *                     in the entry belongs to the next block)
 *   bits 40-51 v1    (12-bit signed; |coef| <= 1023 for size <= 10) */
typedef struct {
    mej_hlut lut[4096];       /* first 12 bits -> (len, symbol) */
    uint64_t lutp[1024];      /* first 10 bits -> up to 2 coefficients */
    int32_t maxcode[17];      /* per length; -1 when no codes */
    int32_t mincode[17];
    int32_t valptr[17];
    uint8_t huffval[256];
    int valid;
} mej_htbl;

static inline int mej_extend(uint32_t v, int s)
{
    /* branchless sign extension (jdhuff HUFF_EXTEND semantics): the
     * top bit of the s received bits decides positive vs negative, a
     * ~50/50 data-dependent branch the predictor cannot learn — the
     * arithmetic form is measurably faster in the hot loop */
    int32_t neg = (int32_t)(v >> (s - 1)) - 1;   /* 0 or -1 */
    return (int32_t)v + (neg & (1 - (1 << s)));
}

static int mej_htbl_build(mej_htbl *t, const uint8_t counts[16],
                          const uint8_t *symbols, int nsym)
{
    memset(t->lut, 0, sizeof(t->lut));
    int32_t code = 0;
    int k = 0;
    for (int l = 1; l <= 16; l++) {
        t->valptr[l] = k;
        t->mincode[l] = code;
        for (int i = 0; i < counts[l - 1]; i++, k++) {
            if (k >= nsym || k >= 256)
                return -1;
            t->huffval[k] = symbols[k];
            if (code >= (1 << l))
                return -1;          /* overfull table */
            if (l <= 12) {
                int shift = 12 - l;
                int base = code << shift;
                for (int f = 0; f < (1 << shift); f++) {
                    t->lut[base + f].len = (uint8_t)l;
                    t->lut[base + f].sym = symbols[k];
                }
            }
            code++;
        }
        t->maxcode[l] = counts[l - 1] ? code - 1 : -1;
        code <<= 1;
    }
    /* second pass: the pair table (interpreting sym as (r,s); built
     * unconditionally — DC decode never consults lutp). The per-thread
     * table cache amortizes this across a stream batch: webcam feeds
     * reuse identical DHT definitions, so each distinct table is built
     * once per thread, not once per image. */
    memset(t->lutp, 0, sizeof(t->lutp));
    for (int key = 0; key < 1024; key++) {
        /* decode the symbol from the top of the 10-bit window via the
         * 12-bit lut (bottom 2 bits zero-padded) */
        mej_hlut e1 = t->lut[key << 2];
        if (!e1.len || e1.len > 10)
            continue;               /* full escape */
        int r1 = e1.sym >> 4, sz1 = e1.sym & 15;
        if (sz1 == 0) {
            if (r1 == 15)           /* ZRL */
                t->lutp[key] = (uint64_t)e1.len | (1ull << 6);
            else                    /* bare EOB */
                t->lutp[key] = (uint64_t)e1.len | (1ull << 8);
            continue;
        }
        if (e1.len + sz1 > 10) {    /* code resolved, value pending */
            t->lutp[key] = (uint64_t)e1.len | (2ull << 6)
                           | ((uint64_t)r1 << 10)
                           | ((uint64_t)(sz1 & 0xFFF) << 40);
            continue;
        }
        int nb1 = e1.len + sz1;
        uint32_t vbits1 = ((uint32_t)key >> (10 - nb1))
                          & ((1u << sz1) - 1);
        int v1 = mej_extend(vbits1, sz1);
        uint64_t ent = (uint64_t)nb1
                       | (1ull << 9) | ((uint64_t)r1 << 10)
                       | ((uint64_t)nb1 << 16)
                       | ((uint64_t)(v1 & 0xFFF) << 40);
        /* fuse a directly-following EOB when its code fits the
         * remaining window bits (77% of corpus EOBs do) */
        int rem = 10 - nb1;
        if (rem >= 2) {
            int key2 = ((key << nb1) & 1023) << 2;    /* re-aligned */
            mej_hlut e2 = t->lut[key2];
            if (e2.len && e2.len <= rem
                && (e2.sym & 15) == 0 && (e2.sym >> 4) != 15)
                ent = (ent & ~63ull) | (uint64_t)(nb1 + e2.len)
                      | (1ull << 8);
        }
        t->lutp[key] = ent;
    }
    t->valid = 1;
    return 0;
}

/* Per-thread Huffman-table cache. Building the widened LUTs costs
 * ~8 us/table; a camera stream reuses identical DHT payloads frame
 * after frame, so cache built tables keyed by an FNV-1a hash of the
 * raw definition. A hash hit counts only when the stored definition
 * (counts and symbols) is byte-equal to the requested one, so a hash
 * collision builds a table of its own instead of decoding with a wrong
 * one. Per-thread (the batch decoder is pthreaded), and
 * slots claimed by the CURRENT stream are never evicted within it
 * (generation counter), so table pointers stay valid across the whole
 * entropy scan. 12 slots >> the 8 baseline table ids. */
typedef struct {
    uint64_t hash;
    uint32_t gen;                 /* stream generation that claimed it */
    int used;
    int nsym;                     /* the raw definition the table was */
    uint8_t counts[16];           /* built from, compared on a hash hit */
    uint8_t syms[256];
    mej_htbl tbl;
} mej_tslot;

static __thread mej_tslot mej_tcache[12];
static __thread uint32_t mej_tgen;
static __thread int mej_tvictim;

static uint64_t mej_thash(const uint8_t counts[16], const uint8_t *syms,
                          int nsym)
{
    uint64_t h = 1469598103934665603ull;
    for (int i = 0; i < 16; i++)
        h = (h ^ counts[i]) * 1099511628211ull;
    for (int i = 0; i < nsym; i++)
        h = (h ^ syms[i]) * 1099511628211ull;
    h = (h ^ (uint64_t)nsym) * 1099511628211ull;
    return h | 1;                 /* 0 marks an empty slot */
}

static const mej_htbl *mej_htbl_cached(const uint8_t counts[16],
                                       const uint8_t *syms, int nsym)
{
    uint64_t h = mej_thash(counts, syms, nsym);
    for (int i = 0; i < 12; i++)
        if (mej_tcache[i].used && mej_tcache[i].hash == h
            && mej_tcache[i].nsym == nsym
            && memcmp(mej_tcache[i].counts, counts, 16) == 0
            && memcmp(mej_tcache[i].syms, syms, (size_t)nsym) == 0) {
            mej_tcache[i].gen = mej_tgen;
            return &mej_tcache[i].tbl;
        }
    for (int tries = 0; tries < 12; tries++) {
        mej_tslot *s = &mej_tcache[mej_tvictim];
        mej_tvictim = (mej_tvictim + 1) % 12;
        if (s->used && s->gen == mej_tgen)
            continue;             /* claimed by the current stream */
        if (mej_htbl_build(&s->tbl, counts, syms, nsym)) {
            s->used = 0;
            return NULL;
        }
        s->hash = h;
        s->gen = mej_tgen;
        s->used = 1;
        s->nsym = nsym;
        memcpy(s->counts, counts, 16);
        memcpy(s->syms, syms, (size_t)nsym);
        return &s->tbl;
    }
    return NULL;                  /* all slots claimed (cannot happen) */
}

typedef struct {
    const uint8_t *p, *end;
    uint64_t acc;             /* top-aligned bit buffer */
    int n;                    /* valid bits in acc */
    int marker;               /* 0, or marker code byte seen (consumed) */
} mej_br;

static void mej_br_fill(mej_br *b)
{
    /* fast refill: grab as many whole bytes as fit in one 8-byte load
     * when none of them is 0xFF (the overwhelmingly common case) */
    while (b->n <= 56) {
        if (b->marker)
            return;
        if (b->p + 8 <= b->end) {
            int nb = (64 - b->n) >> 3;
            uint64_t v;
            memcpy(&v, b->p, 8);
            v = __builtin_bswap64(v);
            v &= ~0ULL << (64 - 8 * nb);      /* keep top nb bytes */
            uint64_t t = v ^ ~0ULL;           /* FF bytes -> 00 */
            if (((t - 0x0101010101010101ULL) & ~t
                 & 0x8080808080808080ULL) == 0) {
                b->acc |= v >> b->n;
                b->p += nb;
                b->n += 8 * nb;
                continue;
            }
        }
        if (b->p >= b->end)
            return;
        uint8_t v = *b->p++;
        if (v == 0xFF) {
            /* skip optional 0xFF fill bytes, then: 0x00 = stuffed data
             * byte 0xFF, anything else = a marker (consume its code) */
            while (b->p < b->end && *b->p == 0xFF)
                b->p++;
            if (b->p >= b->end)
                return;   /* truncated at a trailing 0xFF: the caller's
                           * bit-count checks flag the starved decode */
            if (*b->p == 0x00) {
                b->p++;       /* v stays 0xFF */
            } else {
                b->marker = *b->p++;
                return;
            }
        }
        b->acc |= (uint64_t)v << (56 - b->n);
        b->n += 8;
    }
}

/* Decode the next Huffman code from the (already filled) buffer.
 * Returns the symbol and stores the code length, or -1 on fault. The
 * buffer's unfilled low bits are zero, so peeks are naturally
 * zero-padded at stream end; the caller's length-vs-n check ensures a
 * code never consumes padding. */
static inline int mej_peekdec(mej_br *b, const mej_htbl *t, int *len)
{
    mej_hlut e = t->lut[(uint32_t)(b->acc >> 52)];
    if (e.len) {
        *len = e.len;
        return e.sym;
    }
    uint32_t peek = (uint32_t)(b->acc >> 48);
    for (int l = 13; l <= 16; l++) {
        int32_t c = (int32_t)(peek >> (16 - l));
        if (t->maxcode[l] >= 0 && c <= t->maxcode[l]) {
            int idx = t->valptr[l] + (c - t->mincode[l]);
            if (idx < 0 || idx >= 256)
                return -1;
            *len = l;
            return t->huffval[idx];
        }
    }
    return -1;
}

/* Decode one block; store into out (natural order, zeroed here — the
 * caller's buffer is NOT assumed pre-zeroed) unless out is NULL.
 * rstride is the output row stride in elements: 8 for the contiguous
 * [64] block layout, the plane width for the frequency-plane layout
 * (coefficient (r, c) lands at out[r*rstride + c] — out points at the
 * block's top-left element either way).
 * Hot-loop shape: ONE refill check per coefficient covers both the
 * Huffman code (<=16 bits) and its value bits (<=15), decoded from a
 * single top-aligned peek. */
static int mej_fast_block(mej_br *br, const mej_htbl *dc,
                          const mej_htbl *ac, int *pred, int16_t *outp,
                          int rstride)
{
    int16_t *const out = outp;
    if (out) {
        if (rstride == 8) {
            memset(out, 0, 64 * sizeof(int16_t));
        } else {
            for (int r = 0; r < 8; r++)
                memset(out + (size_t)r * rstride, 0, 8 * sizeof(int16_t));
        }
    }
    int len;
    /* The bit reader lives in LOCALS across the loop: the coefficient
     * stores go through computed pointers the compiler must assume may
     * alias *br, so keeping acc/n in br-> forces a reload on the
     * decode's critical dependency chain every iteration. Synced back
     * around refills and at every exit. */
    uint64_t acc = br->acc;
    int n = br->n;
#define MEJ_SYNC_OUT() (br->acc = acc, br->n = n)
#define MEJ_REFILL() \
    do { if (n < 32) { MEJ_SYNC_OUT(); mej_br_fill(br); \
         acc = br->acc; n = br->n; } } while (0)

    MEJ_REFILL();
    MEJ_SYNC_OUT();               /* peekdec reads br->acc */
    int s = mej_peekdec(br, dc, &len);
    if (s < 0 || s > 15)
        return -1;
    if (s) {
        if (len + s > n)
            return -1;
        uint32_t v = (uint32_t)((acc << len) >> (64 - s));
        acc <<= len + s;
        n -= len + s;
        *pred += mej_extend(v, s);
    } else {
        if (len > n)
            return -1;
        acc <<= len;
        n -= len;
    }
    if (out)
        out[0] = (int16_t)*pred;
    int k = 1;
    while (k < 64) {
        MEJ_REFILL();
        /* multi-symbol fast path: one 10-bit peek resolves up to TWO
         * coefficients (codes AND value bits) per table load, through
         * ONE branch-unified sequence — see the mej_htbl lutp layout
         * comment for why the kinds are merged */
        uint64_t e = ac->lutp[(uint32_t)(acc >> 54)];
        unsigned nb = (unsigned)e & 63;
        if (nb) {
            unsigned kd = ((unsigned)e >> 6) & 3;
            int k1 = k + (int)((e >> 10) & 63);
            if (kd) {
                if (kd == 1) {                /* ZRL (~0.004%) */
                    if ((int)nb > n)
                        return -1;
                    acc <<= nb;
                    n -= (int)nb;
                    k += 16;
                    continue;
                }
                /* value bits pending: code resolved, size in v1 */
                int sz2 = (int)((e >> 40) & 0xFFF);
                if ((int)nb + sz2 > n)
                    return -1;
                if (k1 > 63)
                    return -1;    /* bogus run: let libjpeg deal */
                uint32_t v = (uint32_t)((acc << nb) >> (64 - sz2));
                acc <<= nb + sz2;
                n -= (int)nb + sz2;
                if (out) {
                    int no = jpeg_natural_order[k1];
                    out[(no >> 3) * (size_t)rstride + (no & 7)] =
                        (int16_t)mej_extend(v, sz2);
                }
                k = k1 + 1;
                continue;
            }
            if ((e & (3ull << 8)) == (3ull << 8) && k1 >= 63)
                /* a FUSED entry whose coefficient lands on index 63:
                 * the block ends there, so the fused EOB code belongs
                 * to the NEXT block — consume the coefficient's bits
                 * only (st1 required: a bare EOB at k == 63 must keep
                 * its own length) */
                nb = (unsigned)(e >> 16) & 63;
            if ((int)nb > n)
                return -1;
            acc <<= nb;
            n -= (int)nb;
            if (!(e & (1ull << 9)))
                break;                        /* bare EOB */
            if (k1 > 63)
                return -1;        /* bogus run: let libjpeg deal */
            if (out) {
                int no = jpeg_natural_order[k1];
                out[(no >> 3) * (size_t)rstride + (no & 7)] =
                    (int16_t)((int64_t)(e << 12) >> 52);
            }
            if (e & (1ull << 8))
                break;                        /* fused (coef, EOB) */
            k = k1 + 1;
            continue;
        }
        MEJ_SYNC_OUT();
        int rs = mej_peekdec(br, ac, &len);
        if (rs < 0)
            return -1;
        int r = rs >> 4, sz = rs & 15;
        if (sz == 0) {
            if (len > n)
                return -1;
            acc <<= len;
            n -= len;
            if (r != 15)
                break;            /* EOB */
            k += 16;
        } else {
            k += r;
            if (k > 63)
                return -1;        /* bogus run: let libjpeg deal */
            if (len + sz > n)
                return -1;
            uint32_t v = (uint32_t)((acc << len) >> (64 - sz));
            acc <<= len + sz;
            n -= len + sz;
            if (out) {
                int no = jpeg_natural_order[k];
                out[(no >> 3) * (size_t)rstride + (no & 7)] =
                    (int16_t)mej_extend(v, sz);
            }
            k++;
        }
    }
    MEJ_SYNC_OUT();
#undef MEJ_REFILL
#undef MEJ_SYNC_OUT
    return 0;
}
static int mej_fast_coefs(const unsigned char *data, unsigned long size,
                          int lbx0, int lby0, int lbw, int lbh,
                          int exp_w, int exp_h, int plane,
                          int16_t *coefY, int16_t *coefCb,
                          int16_t *coefCr, uint16_t *qt /* [3*64] */)
{
    const uint8_t *p = data, *end = data + size;
    uint16_t qtab[4][64];
    int qdef[4] = {0, 0, 0, 0};
    const mej_htbl *dctbl[4], *actbl[4];
    int w = 0, h = 0, ncomp = 0, dri = 0;
    int comp_tq[3] = {0, 0, 0}, comp_id[3] = {0, 0, 0};
    int comp_dc[3] = {0, 0, 0}, comp_ac[3] = {0, 0, 0};
    int have_sof = 0;
    int saw_jfif = 0, saw_adobe = 0, adobe_transform = 0;
    memset(dctbl, 0, sizeof(dctbl));
    memset(actbl, 0, sizeof(actbl));
    mej_tgen++;                 /* new stream: un-claim cached tables */

    if (size < 4 || p[0] != 0xFF || p[1] != 0xD8)
        return -1;
    p += 2;
    for (;;) {
        /* next marker (skip fill bytes) */
        if (p + 2 > end)
            return -1;
        if (*p != 0xFF)
            return -1;
        while (p < end && *p == 0xFF)
            p++;
        if (p >= end)
            return -1;
        uint8_t m = *p++;
        if (m == 0xD8 || m == 0xD9 || (m >= 0xD0 && m <= 0xD7) || m == 0x01)
            return -1;            /* unexpected before SOS */
        if (p + 2 > end)
            return -1;
        unsigned int len = ((unsigned int)p[0] << 8) | p[1];
        if (len < 2 || p + len > end)
            return -1;
        const uint8_t *q = p + 2, *qend = p + len;
        p += len;
        if (m == 0xC0 || m == 0xC1) {            /* SOF0/1 */
            if (have_sof || qend - q != 6 + 3 * 3)
                return -1;        /* exact length: libjpeg ERREXITs on
                                   * any SOF length anomaly (jdmarker
                                   * get_sof "Bogus marker length") */
            if (q[0] != 8)
                return -1;
            h = (q[1] << 8) | q[2];
            w = (q[3] << 8) | q[4];
            ncomp = q[5];
            q += 6;
            if (ncomp != 3 || qend - q < 9 || w <= 0 || h <= 0)
                return -1;
            for (int c = 0; c < 3; c++) {
                comp_id[c] = q[0];
                int samp = q[1];
                comp_tq[c] = q[2];
                q += 3;
                if (comp_tq[c] > 3)
                    return -1;
                if (c == 0 && samp != 0x22)
                    return -1;
                if (c > 0 && samp != 0x11)
                    return -1;
            }
            have_sof = 1;
        } else if (m == 0xC4) {                  /* DHT */
            while (q < qend) {
                if (qend - q < 17)
                    return -1;
                int tc = q[0] >> 4, th = q[0] & 15;
                if (tc > 1 || th > 3)
                    return -1;
                uint8_t counts[16];
                int nsym = 0;
                for (int i = 0; i < 16; i++) {
                    counts[i] = q[1 + i];
                    nsym += counts[i];
                }
                q += 17;
                if (qend - q < nsym || nsym > 256)
                    return -1;
                const mej_htbl *t = mej_htbl_cached(counts, q, nsym);
                if (!t)
                    return -1;
                if (tc)
                    actbl[th] = t;
                else
                    dctbl[th] = t;
                q += nsym;
            }
        } else if (m == 0xDB) {                  /* DQT */
            while (q < qend) {
                int pq = q[0] >> 4, tq = q[0] & 15;
                if (pq != 0 || tq > 3)
                    return -1;    /* 16-bit tables: libjpeg path */
                q++;
                if (qend - q < 64)
                    return -1;
                for (int i = 0; i < 64; i++)
                    qtab[tq][jpeg_natural_order[i]] = q[i];
                qdef[tq] = 1;
                q += 64;
            }
        } else if (m == 0xDD) {                  /* DRI */
            if (qend - q != 2)
                return -1;        /* libjpeg requires length == 4 */
            dri = (q[0] << 8) | q[1];
        } else if (m == 0xDA) {                  /* SOS */
            if (!have_sof || qend - q != 1 + 2 * 3 + 3 || q[0] != 3)
                return -1;        /* exact length, like libjpeg */
            q++;
            for (int c = 0; c < 3; c++) {
                if (q[0] != comp_id[c])
                    return -1;    /* comps out of SOF order: fallback */
                comp_dc[c] = q[1] >> 4;
                comp_ac[c] = q[1] & 15;
                if (comp_dc[c] > 3 || comp_ac[c] > 3)
                    return -1;
                q += 2;
            }
            if (q[0] != 0 || q[1] != 63 || q[2] != 0)
                return -1;        /* not sequential full-band */
            break;                /* entropy data follows at p */
        } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
            /* APPn/COM are skipped, but APP0/APP14 feed libjpeg's
             * color-space determination (jdmarker examine_app0/14):
             * a stream that would NOT resolve to JCS_YCbCr must take
             * the libjpeg pixel path (the device graph hardwires
             * YCbCr->BGR) */
            if (m == 0xE0 && qend - q >= 14
                && q[0] == 0x4A && q[1] == 0x46 && q[2] == 0x49
                && q[3] == 0x46 && q[4] == 0)
                saw_jfif = 1;     /* "JFIF\0", >= APP0_DATA_LEN */
            if (m == 0xEE && qend - q >= 12
                && q[0] == 0x41 && q[1] == 0x64 && q[2] == 0x6F
                && q[3] == 0x62 && q[4] == 0x65) {
                saw_adobe = 1;    /* "Adobe", >= APP14_DATA_LEN */
                adobe_transform = q[11];
            }
        } else {
            return -1;            /* SOF2+, DAC, DNL, ...: libjpeg path */
        }
    }

    /* color space must resolve to JCS_YCbCr under libjpeg's rules
     * (jdapimin.c default_decompress_parms, 3-component case):
     * JFIF seen -> YCbCr; else Adobe transform 1 -> YCbCr (0 -> RGB,
     * others get a libjpeg warning we don't replicate -> fallback);
     * neither marker -> component-ID heuristic, where IDs 'R','G','B'
     * mean RGB.  Anything non-YCbCr falls back to the pixel path. */
    if (!saw_jfif) {
        if (saw_adobe) {
            if (adobe_transform != 1)
                return -1;
        } else if (comp_id[0] == 0x52 && comp_id[1] == 0x47
                   && comp_id[2] == 0x42) {
            return -1;
        }
    }

    /* frame/window geometry (mirrors the libjpeg path's checks) */
    if (exp_w > 0 && (w != exp_w || h != exp_h))
        return -1;
    int wb_pad = 2 * ((w + 15) / 16);   /* MCU-padded luma block grid */
    int hb_pad = 2 * ((h + 15) / 16);
    int cbw_img = (w + 15) / 16, cbh_img = (h + 15) / 16;
    int cbx0 = lbx0 / 2, cby0 = lby0 / 2;
    int cbw = lbw / 2, cbh = lbh / 2;
    if (lbx0 < 0 || lby0 < 0 || lbw <= 0 || lbh <= 0
        || ((lbx0 | lby0 | lbw | lbh) & 1)
        || lbx0 + lbw > wb_pad || lby0 + lbh > hb_pad
        || cbx0 + cbw > cbw_img || cby0 + cbh > cbh_img)
        return -1;
    for (int c = 0; c < 3; c++) {
        if (!qdef[comp_tq[c]] || !dctbl[comp_dc[c]]
            || !actbl[comp_ac[c]])
            return -1;
        for (int i = 0; i < 64; i++)
            qt[c * 64 + i] = qtab[comp_tq[c]][i];
    }

    mej_br br;
    br.p = p;
    br.end = end;
    br.acc = 0;
    br.n = 0;
    br.marker = 0;

    int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
    int stop_imcu = (lby0 + lbh + 1) / 2;
    if (stop_imcu > mcuy)
        stop_imcu = mcuy;
    int pred[3] = {0, 0, 0};
    int togo = dri, rstn = 0;
    const mej_htbl *ydc = dctbl[comp_dc[0]], *yac = actbl[comp_ac[0]];
    const mej_htbl *bdc = dctbl[comp_dc[1]], *bac = actbl[comp_ac[1]];
    const mej_htbl *rdc = dctbl[comp_dc[2]], *rac = actbl[comp_ac[2]];

    for (int my = 0; my < stop_imcu; my++) {
        for (int mx = 0; mx < mcux; mx++) {
            if (dri && togo == 0) {
                /* restart boundary: discard pad bits, expect RSTn */
                br.acc = 0;
                br.n = 0;
                if (!br.marker) {
                    const uint8_t *r = br.p;
                    if (r >= br.end || *r != 0xFF)
                        return -1;
                    while (r < br.end && *r == 0xFF)
                        r++;
                    if (r >= br.end)
                        return -1;
                    br.marker = *r++;
                    br.p = r;
                }
                if (br.marker != 0xD0 + rstn)
                    return -1;    /* resync needed: libjpeg path */
                br.marker = 0;
                rstn = (rstn + 1) & 7;
                pred[0] = pred[1] = pred[2] = 0;
                togo = dri;
            }
            for (int sub = 0; sub < 4; sub++) {
                int by = 2 * my + (sub >> 1), bx = 2 * mx + (sub & 1);
                int16_t *out = NULL;
                if (bx >= lbx0 && bx < lbx0 + lbw
                    && by >= lby0 && by < lby0 + lbh)
                    out = plane
                        ? coefY + ((size_t)(by - lby0) * 8 * (lbw * 8)
                                   + (size_t)(bx - lbx0) * 8)
                        : coefY + ((size_t)(by - lby0) * lbw
                                   + (bx - lbx0)) * 64;
                if (mej_fast_block(&br, ydc, yac, &pred[0], out,
                                   plane ? lbw * 8 : 8))
                    return -1;
            }
            {
                int in_cwin = (mx >= cbx0 && mx < cbx0 + cbw
                               && my >= cby0 && my < cby0 + cbh);
                int cstride = plane ? cbw * 8 : 8;
                size_t coff = plane
                    ? ((size_t)(my - cby0) * 8 * (cbw * 8)
                       + (size_t)(mx - cbx0) * 8)
                    : ((size_t)(my - cby0) * cbw + (mx - cbx0)) * 64;
                if (mej_fast_block(&br, bdc, bac, &pred[1],
                                   in_cwin ? coefCb + coff : NULL, cstride))
                    return -1;
                if (mej_fast_block(&br, rdc, rac, &pred[2],
                                   in_cwin ? coefCr + coff : NULL, cstride))
                    return -1;
            }
            if (dri)
                togo--;
        }
    }
    return 0;
}

typedef struct {
    const unsigned char *const *datas;
    const unsigned long *sizes;
    int16_t *coefY;           /* N * lbh*lbw*64 */
    int16_t *coefCb;          /* N * (lbh/2)*(lbw/2)*64 */
    int16_t *coefCr;
    uint16_t *qt;             /* N * 3*64 */
    int *ok;                  /* N: 0 = success (else not loaded) */
    int8_t *cmpY, *cmpCb, *cmpCr; /* compact wire outputs (NULL = off):
                                    * per frame, plane lo8 rows followed
                                    * by the row-pair nibble rows —
                                    * [rows*3/2, cols] int8 */
    int lbx0, lby0, lbw, lbh;
    int exp_w, exp_h;
    int plane;                /* 1 = frequency-plane output layout */
    int n;
    int next;
    pthread_mutex_t lock;
} mej_coef_job;

/* Compact wire format (round-5 H2D work): coefficient v ships as
 * lo = v & 0xFF (int8) plus a 4-bit hi part, row-PAIR packed two
 * nibbles per byte (hi row r holds plane rows 2r | 2r+1 << 4).
 * sign-extend-12(hi << 8 | lo) reconstructs v exactly for the full
 * baseline-JPEG coefficient range [-2047, 2047]; a stream pushing the
 * unclamped DC predictor beyond +-2048 (not producible by a conforming
 * encoder) is detected here and the frame reported as not read.
 * Runs per frame right after its decode, while the plane data is still
 * cache-hot. Returns nonzero on range overflow. */
static int mej_compact_plane(const int16_t *src, int rows, int cols,
                             int8_t *lo, uint8_t *hi)
{
    int of = 0;
    for (int r = 0; r < rows; r += 2) {
        const int16_t *s0 = src + (size_t)r * cols;
        const int16_t *s1 = s0 + cols;
        int8_t *l0 = lo + (size_t)r * cols;
        int8_t *l1 = l0 + cols;
        uint8_t *h = hi + (size_t)(r >> 1) * cols;
        for (int c = 0; c < cols; c++) {
            int v0 = s0[c], v1 = s1[c];
            of |= ((v0 + 2048) | (v1 + 2048)) & ~4095;
            l0[c] = (int8_t)(v0 & 255);
            l1[c] = (int8_t)(v1 & 255);
            h[c] = (uint8_t)(((v0 >> 8) & 15)
                             | (((v1 >> 8) & 15) << 4));
        }
    }
    return of;
}

static void *mej_coef_worker(void *arg)
{
    mej_coef_job *job = (mej_coef_job *)arg;
    size_t y_stride = (size_t)job->lbh * job->lbw * DCTSIZE2;
    size_t c_stride = y_stride / 4;
    for (;;) {
        pthread_mutex_lock(&job->lock);
        int i = job->next++;
        pthread_mutex_unlock(&job->lock);
        if (i >= job->n)
            break;
        int16_t *py = job->coefY + (size_t)i * y_stride;
        int16_t *pb = job->coefCb + (size_t)i * c_stride;
        int16_t *pr = job->coefCr + (size_t)i * c_stride;
        job->ok[i] = mej_fast_coefs(
            job->datas[i], job->sizes[i],
            job->lbx0, job->lby0, job->lbw, job->lbh,
            job->exp_w, job->exp_h, job->plane,
            py, pb, pr, job->qt + (size_t)i * 3 * 64);
        if (job->cmpY && job->plane && job->ok[i] == 0) {
            int yr = job->lbh * 8, yc = job->lbw * 8;
            int cr2 = job->lbh * 4, cc = job->lbw * 4;
            int8_t *cy8 = job->cmpY + (size_t)i * (y_stride * 3 / 2);
            int8_t *cb8 = job->cmpCb + (size_t)i * (c_stride * 3 / 2);
            int8_t *cr8 = job->cmpCr + (size_t)i * (c_stride * 3 / 2);
            int of = mej_compact_plane(
                py, yr, yc, cy8, (uint8_t *)(cy8 + y_stride));
            of |= mej_compact_plane(
                pb, cr2, cc, cb8, (uint8_t *)(cb8 + c_stride));
            of |= mej_compact_plane(
                pr, cr2, cc, cr8, (uint8_t *)(cr8 + c_stride));
            if (of)
                job->ok[i] = 1;   /* out of wire range: not read */
        }
    }
    return NULL;
}

void mej_read_coefs_region_batch_compact(
    const unsigned char *const *datas,
    const unsigned long *sizes, int n,
    int lbx0, int lby0, int lbw, int lbh,
    int exp_w, int exp_h, int plane,
    int16_t *coefY, int16_t *coefCb,
    int16_t *coefCr, uint16_t *qt,
    int *ok, int num_threads,
    int8_t *cmpY, int8_t *cmpCb, int8_t *cmpCr)
{
    mej_coef_job job;
    job.plane = plane;
    job.cmpY = cmpY;
    job.cmpCb = cmpCb;
    job.cmpCr = cmpCr;
    job.datas = datas;
    job.sizes = sizes;
    job.coefY = coefY;
    job.coefCb = coefCb;
    job.coefCr = coefCr;
    job.qt = qt;
    job.ok = ok;
    job.lbx0 = lbx0;
    job.lby0 = lby0;
    job.lbw = lbw;
    job.lbh = lbh;
    job.exp_w = exp_w;
    job.exp_h = exp_h;
    job.n = n;
    job.next = 0;
    pthread_mutex_init(&job.lock, NULL);

    if (num_threads < 1)
        num_threads = 1;
    if (num_threads > n)
        num_threads = n;
    pthread_t threads[64];
    if (num_threads > 64)
        num_threads = 64;

    for (int t = 0; t < num_threads; t++)
        pthread_create(&threads[t], NULL, mej_coef_worker, &job);
    for (int t = 0; t < num_threads; t++)
        pthread_join(threads[t], NULL);
    pthread_mutex_destroy(&job.lock);
}

void mej_read_coefs_region_batch(const unsigned char *const *datas,
                                 const unsigned long *sizes, int n,
                                 int lbx0, int lby0, int lbw, int lbh,
                                 int exp_w, int exp_h, int plane,
                                 int16_t *coefY, int16_t *coefCb,
                                 int16_t *coefCr, uint16_t *qt,
                                 int *ok, int num_threads)
{
    mej_read_coefs_region_batch_compact(
        datas, sizes, n, lbx0, lby0, lbw, lbh, exp_w, exp_h, plane,
        coefY, coefCb, coefCr, qt, ok, num_threads,
        NULL, NULL, NULL);
}
