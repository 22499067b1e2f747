/* coefs.c — the coefficient reader of the port's JPEG feed.
 *
 * Entropy-decodes the DCT-coefficient window of 8-bit YCbCr 4:2:0 JPEG
 * streams on the host (pthreads), for the device back-half
 * (meterelf_tpu_torch/ops/jpegdec.py, csrc/jpeg.cu) to finish. A copy of
 * the fast baseline reader of meterelf_tpu/io/native/meterelf_jpeg.c
 * (mej_fast_coefs and its helpers, the compact packer and the batch
 * workers) that needs no libjpeg. A stream the fast reader rejects
 * (16-bit DQT, truncation, a restart mismatch, stray markers, missing
 * tables, ...) goes to decoder.c's mej_general_coefs, as the JAX reader
 * hands it to libjpeg's jpeg_read_coefficients; progressive,
 * arithmetic-coded, non-4:2:0 and non-YCbCr streams stay rejected there,
 * as in the JAX reader (rc 6), and so does a sequential frame in several
 * scans, which the JAX reader misreads (decoder.c). The
 * marker parser, the Huffman tables and their per-thread cache (which
 * compares the stored definition with memcmp on a hash hit) live in
 * jpeg_common.c. Built with decoder.c and jpeg_common.c into one library
 * by meterelf_tpu_torch/_build.py (gcc, at first use).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <pthread.h>

#include "jpeg_common.h"

/* ---------------- fast baseline coefficient reader ----------------
 *
 * Hand-rolled Huffman decode of the coefficient window for the common
 * case: a CLEAN (untruncated, restart-consistent) 8-bit baseline
 * sequential Huffman YCbCr 4:2:0 stream, i.e. every frame the camera
 * actually produces. Coefficients land straight in the caller's window
 * buffer and the entropy scan stops at the window's last iMCU row.
 *
 * Returns 0 only on a fully clean decode. ANY anomaly (truncation,
 * marker surprises, bogus Huffman runs, restart mismatch, 16-bit DQT,
 * missing tables, unsupported layout) returns nonzero, and the caller
 * hands the stream to decoder.c's general reader, which owns all
 * failure semantics (libjpeg's jpeg_read_coefficients in the JAX
 * package's reader).
 *
 * Output conventions match libjpeg's decoder: coefficients stored in
 * natural (raster) order via jpeg_natural_order (jdhuff.c does the
 * same), quant tables are the last DQT definitions preceding SOS in
 * natural order (as quant_tbl_ptrs holds them).
 *
 * The multi-symbol AC table (mej_htbl.lutp, built in jpeg_common.c):
 * ONE 10-bit peek resolves a coefficient (Huffman code plus value bits)
 * and a directly following EOB when they fit the window.
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

static inline int mej_extend(uint32_t v, int s)
{
    /* branchless sign extension (jdhuff HUFF_EXTEND semantics): the
     * top bit of the s received bits decides positive vs negative, a
     * ~50/50 data-dependent branch the predictor cannot learn — the
     * arithmetic form is measurably faster in the hot loop */
    int32_t neg = (int32_t)(v >> (s - 1)) - 1;   /* 0 or -1 */
    return (int32_t)v + (neg & (1 - (1 << s)));
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
    mej_src s;
    mej_hdr hd;
    mej_htbl_new_generation();  /* new stream: un-claim cached tables */
    if (mej_src_start(&s, data, size, &hd)
        || mej_read_markers(&s, &hd) != MEJ_AT_SOS)
        return -1;
    /* the camera's layout only: baseline or extended sequential, 8-bit
     * tables, YCbCr 4:2:0 in one interleaved full-band scan in SOF
     * order, every table defined, no stray markers before the scan */
    if ((hd.sof != 0xC0 && hd.sof != 0xC1) || hd.precision != 8
        || hd.ncomp != 3 || hd.q16 || hd.odd_markers || hd.ns != 3
        || hd.Ss != 0 || hd.Se != 63 || hd.Ah != 0 || hd.Al != 0)
        return -1;
    const mej_htbl *ydc = NULL, *yac = NULL, *bdc = NULL, *bac = NULL;
    const mej_htbl *rdc = NULL, *rac = NULL;
    for (int c = 0; c < 3; c++) {
        const mej_comp *cp = &hd.comp[c];
        if (cp->h != (c ? 1 : 2) || cp->v != (c ? 1 : 2) || cp->tq > 3
            || !hd.qdef[cp->tq] || hd.scomp[c] != c
            || hd.sdc[c] > 3 || hd.sac[c] > 3
            || !hd.dht[0][hd.sdc[c]].defined
            || !hd.dht[1][hd.sac[c]].defined)
            return -1;
        const mej_dht *d = &hd.dht[0][hd.sdc[c]];
        const mej_dht *a = &hd.dht[1][hd.sac[c]];
        const mej_htbl *dt = mej_htbl_cached(d->counts, d->syms, d->nsym);
        const mej_htbl *at = mej_htbl_cached(a->counts, a->syms, a->nsym);
        if (!dt || !at)
            return -1;
        for (int i = 0; i < d->nsym; i++)
            if (d->syms[i] > 15)
                return -1;        /* libjpeg refuses such DC tables */
        if (c == 0) { ydc = dt; yac = at; }
        else if (c == 1) { bdc = dt; bac = at; }
        else { rdc = dt; rac = at; }
        for (int i = 0; i < 64; i++)
            qt[c * 64 + i] = hd.qtab[cp->tq][i];
    }
    /* colour space must resolve to JCS_YCbCr (jdapimin.c
     * default_decompress_parms): JFIF -> YCbCr; else an Adobe marker with
     * transform 1 (0 means RGB; other values are left to the general
     * reader); neither -> the component IDs, where 'R','G','B' is RGB */
    if (!hd.saw_jfif) {
        if (hd.saw_adobe) {
            if (hd.adobe_transform != 1)
                return -1;
        } else if (hd.comp[0].id == 0x52 && hd.comp[1].id == 0x47
                   && hd.comp[2].id == 0x42) {
            return -1;
        }
    }
    int w = hd.w, h = hd.h, dri = hd.dri;
    const uint8_t *p = s.p, *end = s.end;

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
        if (job->ok[i])           /* libjpeg's path in the JAX reader */
            job->ok[i] = mej_general_coefs(
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
