/* decoder.c — the port's general JPEG decoder, without libjpeg.
 *
 * Reads every stream class the JAX package's libjpeg build (libjpeg-turbo
 * 2.1, 8-bit, BGR out) reads on the pixel and coefficient paths, and
 * produces libjpeg's output bit for bit:
 *
 *  - SOF0/SOF1 sequential and SOF2 progressive Huffman scans (DC first
 *    and refine, AC first and refine with EOB runs), interleaved or not,
 *    in any number of scans (jdhuff.c, jdphuff.c);
 *  - SOF9 sequential and SOF10 progressive arithmetic-coded scans
 *    (jdarith.c: the Q-coder with its probability table, the DC and AC
 *    statistics bins, DAC conditioning and its defaults, restarts, and
 *    libjpeg's handling of bad data: a spectral or magnitude overflow
 *    stops the decoder until the next restart, a marker met in the data
 *    is read as zeros);
 *  - 8-bit and 16-bit DQT, the standard Huffman tables where a sequential
 *    image's table id 0/1 was never defined (jstdhuff.c; a progressive
 *    image gets none, as in jdphuff.c);
 *  - restart intervals, with libjpeg's resync when a marker is missing or
 *    out of sequence (jdmarker.c read_restart_marker,
 *    jpeg_resync_to_restart);
 *  - truncated and corrupt data as libjpeg's memory source and Huffman
 *    decoder handle it: past the end the stream reads as an EOI marker
 *    (FF D9, also inside a segment that the end cuts); a decode that
 *    needs bits past a marker gets zero bits and sets the segment's
 *    "insufficient data" flag, after which whole MCUs are skipped (left
 *    zero) until a restart marker clears it;
 *  - block smoothing of a progressive image whose first AC bands are not
 *    all final (libjpeg-turbo 2.1's jdcoefct.c: the 5x5 DC neighbourhood,
 *    DC interpolation where no AC band was seen, the progression status
 *    before the last scan for the iMCU rows past where its data ended);
 *  - 1 or 3 components at sampling factors 1 to 4, with libjpeg's MCU
 *    limit of 10 blocks and its upsamplers (jdsample.c: fancy h2v1, h1v2
 *    and h2v2 where the ratio is 2, plain replication for h2v1/h2v2 when
 *    the component is at most 2 samples wide, int_upsample for the other
 *    integral ratios);
 *  - the ISLOW IDCT as libjpeg-turbo's x86 SIMD code computes it (equal
 *    to jidctint.c on well-formed data; idct_block says where not);
 *  - YCbCr -> BGR through libjpeg's fixed-point tables (jdcolor.c), RGB
 *    (Adobe APP14 transform 0, or component ids 'R','G','B'), grayscale
 *    (replicated to 3 channels, as the JAX reader does).
 *
 * What libjpeg refuses (12-bit, lossless, hierarchical, CMYK/YCCK to BGR,
 * a sampling ratio that is not an integer, more than 10 blocks in an MCU,
 * bad markers and tables) is refused as an error (MEJ_ERROR).
 *
 * Entry points (plain C, GIL-free, pthreads):
 *  - mej_decode_full_batch: whole frames as BGR;
 *  - mej_decode_packed_batch: the meter rect of each frame, packed
 *    b | g<<8 | r<<16 into a zero-padded [ph, pw] i32 slot;
 *  - mej_general_coefs: the coefficient window, for coefs.c's batch
 *    reader when its fast path rejects a stream (the JAX reader's
 *    jpeg_read_coefficients path). It refuses (MEJ_REFUSED) a sequential
 *    4:2:0 frame in several scans, which the JAX reader misreads
 *    (ROADMAP, open faults on the reference side): such a frame goes to
 *    the feed's fallback slots, decoded whole.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <pthread.h>

#include "jpeg_common.h"

#define MAX_FRAME 4096            /* the JAX reader's full-frame bound */
#define MAX_BLOCKS_IN_MCU 10      /* D_MAX_BLOCKS_IN_MCU */

/* ITU-T T.81 Annex K.3 tables (what libjpeg uses for an undefined id) */
static const uint8_t std_dc_counts[2][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
static const uint8_t std_dc_syms[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10,
                                        11};
static const uint8_t std_ac_counts[2][16] = {
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
static const uint8_t std_ac_syms[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
     0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
     0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24,
     0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a,
     0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38,
     0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53,
     0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66,
     0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
     0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93,
     0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
     0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7,
     0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
     0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
     0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
     0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15,
     0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17,
     0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37,
     0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a,
     0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65,
     0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
     0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a,
     0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5,
     0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
     0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9,
     0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

typedef struct {
    int h, v;
    int wib, hib;             /* the component's blocks (unpadded) */
    int bw, bh;               /* allocated block grid (MCU-padded) */
    int dw, dh;               /* downsampled size in samples */
    int16_t *coef;            /* [bh][bw][64], natural order */
    int coef_bits[64];        /* progressive: last Al per band, -1 unseen */
    int prev_bits[64];        /* coef_bits before the last scan of this
                               * component (jdphuff.c, jdarith.c) */
    int latched;              /* quant table latched at its first scan */
    uint16_t qt[64];
} dcomp;

typedef struct {
    mej_src s;
    mej_hdr h;
    dcomp c[MEJ_MAX_COMPS];
    int maxh, maxv, mcux, mcuy;
    int progressive, arith;
    int scan_number;          /* libjpeg's input_scan_number */
    int last_good;            /* last_good_iMCU_row (jdcoefct.c) */
    /* bit reader: acc is top-aligned, bits below the n valid ones zero */
    uint64_t acc;
    int n;
    int insufficient;         /* libjpeg's entropy->insufficient_data */
    int next_restart_num;
    int last_dc[MEJ_MAX_COMPS];
    int eobrun;
    /* arithmetic decoder (jdarith.c): C and A registers, bit counter
     * (-16 before the first two bytes, -1 after an error), DC context per
     * scan slot, statistics bins per table, the fixed 0.5 bin */
    int64_t ac_c, ac_a;
    int ac_ct;
    int dc_context[MEJ_MAX_COMPS];
    uint8_t dc_stats[16][64], ac_stats[16][256];
    uint8_t fixed_bin[4];
} jdec;

/* ---------------------------- bit reader ---------------------------- */

static void br_fill(jdec *d)
{
    mej_src *s = &d->s;
    while (d->n <= 56 && s->unread_marker == 0) {
        int c;
        if (s->p < s->end) {
            c = *s->p++;
        } else if (s->fake_d9) {              /* the D9 of a fake EOI */
            s->fake_d9 = 0;
            c = 0xD9;
        } else {
            s->unread_marker = 0xD9;          /* the source's fake EOI */
            break;
        }
        if (c == 0xFF) {
            int c2 = 0xD9;
            while (s->p < s->end && (c2 = *s->p++) == 0xFF)
                ;
            if (c2 == 0xFF)
                c2 = 0xD9;                    /* ran out among fill bytes */
            if (c2 != 0) {
                s->unread_marker = c2;
                break;
            }
        }
        d->acc |= (uint64_t)c << (56 - d->n);
        d->n += 8;
    }
}

/* make k bits available; past a marker they are zeros (jdhuff.c
 * jpeg_fill_bit_buffer) and the segment is flagged */
static inline void br_need(jdec *d, int k)
{
    if (d->n < k) {
        br_fill(d);
        if (d->n < k) {
            d->insufficient = 1;
            d->n = 64;
        }
    }
}

static inline int br_bits(jdec *d, int k)
{
    br_need(d, k);
    int v = (int)(d->acc >> (64 - k));
    d->acc <<= k;
    d->n -= k;
    return v;
}

static inline int extend(int v, int s)
{
    return v < (1 << (s - 1)) ? v + (int)(~0u << s) + 1 : v;
}

/* jdhuff.c HUFF_DECODE / jpeg_huff_decode: a code that is no code reads
 * 17 bits and decodes as 0 */
static int br_huff(jdec *d, const mej_htbl *t)
{
    if (d->n < 16)
        br_fill(d);
    mej_hlut e = t->lut[d->acc >> 52];
    int len = e.len, sym = e.sym;
    if (!len) {
        uint32_t peek = (uint32_t)(d->acc >> 48);
        len = 17;
        sym = 0;
        for (int l = 13; l <= 16; l++) {
            int32_t c = (int32_t)(peek >> (16 - l));
            if (t->maxcode[l] >= 0 && c <= t->maxcode[l]) {
                len = l;
                sym = t->huffval[(t->valptr[l] + c - t->mincode[l]) & 255];
                break;
            }
        }
    }
    if (len > d->n) {
        br_fill(d);
        if (len > d->n) {
            d->insufficient = 1;
            d->n = 64;
        }
    }
    d->acc <<= len;
    d->n -= len;
    return sym;
}

/* ---------------------------- restarts ---------------------------- */

static void resync_to_restart(jdec *d, int desired)
{
    for (;;) {
        int m = d->s.unread_marker, action;
        if (m < 0xC0)
            action = 2;
        else if (m < 0xD0 || m > 0xD7)
            action = 3;
        else if (m == 0xD0 + ((desired + 1) & 7)
                 || m == 0xD0 + ((desired + 2) & 7))
            action = 3;
        else if (m == 0xD0 + ((desired - 1) & 7)
                 || m == 0xD0 + ((desired - 2) & 7))
            action = 2;
        else
            action = 1;
        if (action == 1) {
            d->s.unread_marker = 0;
            return;
        }
        if (action == 3)
            return;
        mej_next_marker(&d->s);
    }
}

/* jdmarker.c read_restart_marker */
static void read_restart_marker(jdec *d)
{
    if (d->s.unread_marker == 0)
        mej_next_marker(&d->s);
    if (d->s.unread_marker == 0xD0 + d->next_restart_num)
        d->s.unread_marker = 0;
    else
        resync_to_restart(d, d->next_restart_num);
    d->next_restart_num = (d->next_restart_num + 1) & 7;
}

static void process_restart(jdec *d)
{
    d->acc = 0;
    d->n = 0;
    read_restart_marker(d);
    for (int i = 0; i < MEJ_MAX_COMPS; i++)
        d->last_dc[i] = 0;
    d->eobrun = 0;
    if (d->s.unread_marker == 0)
        d->insufficient = 0;
}

/* ---------------------------- frame setup ---------------------------- */

/* upsampling methods (upsampler, by component_plane) */
enum { UP_FULL, UP_H2V1, UP_H1V2, UP_H2V2, UP_INT, UP_FRACT };
static int upsampler(const jdec *d, const dcomp *k);

static int setup_frame(jdec *d)
{
    mej_hdr *h = &d->h;
    if (h->precision != 8)
        return MEJ_ERROR;         /* JERR_BAD_PRECISION (8-bit libjpeg) */
    d->progressive = h->sof == 0xC2 || h->sof == 0xCA;
    d->arith = h->sof == 0xC9 || h->sof == 0xCA;
    d->fixed_bin[0] = 113;    /* jinit_arith_decoder */
    d->maxh = d->maxv = 1;
    for (int c = 0; c < h->ncomp; c++) {
        if (h->comp[c].h > d->maxh)
            d->maxh = h->comp[c].h;
        if (h->comp[c].v > d->maxv)
            d->maxv = h->comp[c].v;
    }
    d->mcux = (h->w + 8 * d->maxh - 1) / (8 * d->maxh);
    d->mcuy = (h->h + 8 * d->maxv - 1) / (8 * d->maxv);
    for (int c = 0; c < h->ncomp; c++) {
        dcomp *k = &d->c[c];
        k->h = h->comp[c].h;
        k->v = h->comp[c].v;
        k->dw = (h->w * k->h + d->maxh - 1) / d->maxh;
        k->dh = (h->h * k->v + d->maxv - 1) / d->maxv;
        k->wib = (k->dw + 7) / 8;
        k->hib = (k->dh + 7) / 8;
        k->bw = d->mcux * k->h;
        k->bh = d->mcuy * k->v;
        k->coef = (int16_t *)calloc((size_t)k->bw * k->bh * 64,
                                    sizeof(int16_t));
        if (!k->coef)
            return MEJ_ERROR;
        for (int i = 0; i < 64; i++) {
            k->coef_bits[i] = -1;
            k->prev_bits[i] = 0;
        }
        k->latched = 0;
        if (upsampler(d, k) == UP_FRACT)
            return MEJ_ERROR;     /* JERR_FRACT_SAMPLE_NOTIMPL */
    }
    return 0;
}

static void free_frame(jdec *d)
{
    for (int c = 0; c < MEJ_MAX_COMPS; c++) {
        free(d->c[c].coef);
        d->c[c].coef = NULL;
    }
}

/* the decoding table of a scan's table id, or NULL (libjpeg:
 * JERR_NO_HUFF_TABLE / JERR_BAD_HUFF_TABLE). An undefined id 0 or 1 takes
 * the standard table in a sequential image (jdhuff.c installs them); the
 * progressive decoder installs none (jdphuff.c). */
static const mej_htbl *scan_table(jdec *d, int cls, int id)
{
    if (id < 0 || id > 3)
        return NULL;
    const mej_dht *t = &d->h.dht[cls][id];
    const mej_htbl *r;
    if (t->defined) {
        if (cls == 0)
            for (int i = 0; i < t->nsym; i++)
                if (t->syms[i] > 15)
                    return NULL;
        r = mej_htbl_cached(t->counts, t->syms, t->nsym);
    } else if (id <= 1 && !d->progressive) {
        r = cls ? mej_htbl_cached(std_ac_counts[id], std_ac_syms[id], 162)
                : mej_htbl_cached(std_dc_counts[id], std_dc_syms, 12);
    } else {
        r = NULL;
    }
    return r;
}

/* ------------------------ arithmetic decoding ------------------------ */

/* jaricom.c jpeg_aritab: T.81 Table D.2, Qe << 16 | Next_Index_MPS << 8 |
 * Switch_MPS << 7 | Next_Index_LPS; the last entry is the fixed 0.5
 * estimate (T.851) */
#define AV(a, b, c, d) (((int64_t)(a) << 16) | ((c) << 8) | ((d) << 7) | (b))
static const int64_t aritab[114] = {
    AV(0x5a1d, 1, 1, 1), AV(0x2586, 14, 2, 0), AV(0x1114, 16, 3, 0),
    AV(0x080b, 18, 4, 0), AV(0x03d8, 20, 5, 0), AV(0x01da, 23, 6, 0),
    AV(0x00e5, 25, 7, 0), AV(0x006f, 28, 8, 0), AV(0x0036, 30, 9, 0),
    AV(0x001a, 33, 10, 0), AV(0x000d, 35, 11, 0), AV(0x0006, 9, 12, 0),
    AV(0x0003, 10, 13, 0), AV(0x0001, 12, 13, 0), AV(0x5a7f, 15, 15, 1),
    AV(0x3f25, 36, 16, 0), AV(0x2cf2, 38, 17, 0), AV(0x207c, 39, 18, 0),
    AV(0x17b9, 40, 19, 0), AV(0x1182, 42, 20, 0), AV(0x0cef, 43, 21, 0),
    AV(0x09a1, 45, 22, 0), AV(0x072f, 46, 23, 0), AV(0x055c, 48, 24, 0),
    AV(0x0406, 49, 25, 0), AV(0x0303, 51, 26, 0), AV(0x0240, 52, 27, 0),
    AV(0x01b1, 54, 28, 0), AV(0x0144, 56, 29, 0), AV(0x00f5, 57, 30, 0),
    AV(0x00b7, 59, 31, 0), AV(0x008a, 60, 32, 0), AV(0x0068, 62, 33, 0),
    AV(0x004e, 63, 34, 0), AV(0x003b, 32, 35, 0), AV(0x002c, 33, 9, 0),
    AV(0x5ae1, 37, 37, 1), AV(0x484c, 64, 38, 0), AV(0x3a0d, 65, 39, 0),
    AV(0x2ef1, 67, 40, 0), AV(0x261f, 68, 41, 0), AV(0x1f33, 69, 42, 0),
    AV(0x19a8, 70, 43, 0), AV(0x1518, 72, 44, 0), AV(0x1177, 73, 45, 0),
    AV(0x0e74, 74, 46, 0), AV(0x0bfb, 75, 47, 0), AV(0x09f8, 77, 48, 0),
    AV(0x0861, 78, 49, 0), AV(0x0706, 79, 50, 0), AV(0x05cd, 48, 51, 0),
    AV(0x04de, 50, 52, 0), AV(0x040f, 50, 53, 0), AV(0x0363, 51, 54, 0),
    AV(0x02d4, 52, 55, 0), AV(0x025c, 53, 56, 0), AV(0x01f8, 54, 57, 0),
    AV(0x01a4, 55, 58, 0), AV(0x0160, 56, 59, 0), AV(0x0125, 57, 60, 0),
    AV(0x00f6, 58, 61, 0), AV(0x00cb, 59, 62, 0), AV(0x00ab, 61, 63, 0),
    AV(0x008f, 61, 32, 0), AV(0x5b12, 65, 65, 1), AV(0x4d04, 80, 66, 0),
    AV(0x412c, 81, 67, 0), AV(0x37d8, 82, 68, 0), AV(0x2fe8, 83, 69, 0),
    AV(0x293c, 84, 70, 0), AV(0x2379, 86, 71, 0), AV(0x1edf, 87, 72, 0),
    AV(0x1aa9, 87, 73, 0), AV(0x174e, 72, 74, 0), AV(0x1424, 72, 75, 0),
    AV(0x119c, 74, 76, 0), AV(0x0f6b, 74, 77, 0), AV(0x0d51, 75, 78, 0),
    AV(0x0bb6, 77, 79, 0), AV(0x0a40, 77, 48, 0), AV(0x5832, 80, 81, 1),
    AV(0x4d1c, 88, 82, 0), AV(0x438e, 89, 83, 0), AV(0x3bdd, 90, 84, 0),
    AV(0x34ee, 91, 85, 0), AV(0x2eae, 92, 86, 0), AV(0x299a, 93, 87, 0),
    AV(0x2516, 86, 71, 0), AV(0x5570, 88, 89, 1), AV(0x4ca9, 95, 90, 0),
    AV(0x44d9, 96, 91, 0), AV(0x3e22, 97, 92, 0), AV(0x3824, 99, 93, 0),
    AV(0x32b4, 99, 94, 0), AV(0x2e17, 93, 86, 0), AV(0x56a8, 95, 96, 1),
    AV(0x4f46, 101, 97, 0), AV(0x47e5, 102, 98, 0), AV(0x41cf, 103, 99, 0),
    AV(0x3c3d, 104, 100, 0), AV(0x375e, 99, 93, 0), AV(0x5231, 105, 102, 0),
    AV(0x4c0f, 106, 103, 0), AV(0x4639, 107, 104, 0),
    AV(0x415e, 103, 99, 0), AV(0x5627, 105, 106, 1),
    AV(0x50e7, 108, 107, 0), AV(0x4b85, 109, 103, 0),
    AV(0x5597, 110, 109, 0), AV(0x504f, 111, 107, 0),
    AV(0x5a10, 110, 111, 1), AV(0x5522, 112, 109, 0),
    AV(0x59eb, 112, 111, 1), AV(0x5a1d, 113, 113, 0)};
#undef AV

/* jdarith.c get_byte over the memory source: past the end the source
 * supplies a fake EOI, FF D9, again and again */
static int arith_byte(jdec *d)
{
    if (d->s.p < d->s.end)
        return *d->s.p++;
    d->s.fake_d9 ^= 1;
    return d->s.fake_d9 ? 0xFF : 0xD9;
}

/* jdarith.c arith_decode: one binary decision with the estimate in *st.
 * A marker met in the data is legal: it is kept as the unread marker and
 * zero bytes are fed from then on. */
static int arith_decode(jdec *d, uint8_t *st)
{
    while (d->ac_a < 0x8000) {
        if (--d->ac_ct < 0) {
            int data;
            if (d->s.unread_marker) {
                data = 0;
            } else {
                data = arith_byte(d);
                if (data == 0xFF) {
                    do
                        data = arith_byte(d);
                    while (data == 0xFF);
                    if (data == 0) {
                        data = 0xFF;          /* a stuffed zero */
                    } else {
                        d->s.unread_marker = data;
                        data = 0;
                    }
                }
            }
            d->ac_c = (d->ac_c << 8) | data;
            if ((d->ac_ct += 8) < 0)          /* still filling */
                if (++d->ac_ct == 0)          /* got the 2 initial bytes */
                    d->ac_a = 0x8000;         /* 0x10000 after the shift */
        }
        d->ac_a <<= 1;
    }
    int sv = *st;
    int64_t qe = aritab[sv & 0x7F];
    int nl = (int)(qe & 0xFF);
    qe >>= 8;
    int nm = (int)(qe & 0xFF);
    qe >>= 8;
    int64_t temp = d->ac_a - qe;
    d->ac_a = temp;
    temp <<= d->ac_ct;
    if (d->ac_c >= temp) {
        d->ac_c -= temp;
        if (d->ac_a < qe) {                   /* conditional exchange */
            d->ac_a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nm);
        } else {
            d->ac_a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        }
    } else if (d->ac_a < 0x8000) {
        if (d->ac_a < qe) {
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        } else {
            *st = (uint8_t)((sv & 0x80) ^ nm);
        }
    }
    return sv >> 7;
}

/* the statistics a scan (re)starts with (jdarith.c start_pass and
 * process_restart), and the decoder registers */
static void arith_reset(jdec *d)
{
    const mej_hdr *h = &d->h;
    for (int i = 0; i < h->ns; i++) {
        if (!d->progressive || (h->Ss == 0 && h->Ah == 0)) {
            memset(d->dc_stats[h->sdc[i]], 0, 64);
            d->last_dc[i] = 0;
            d->dc_context[i] = 0;
        }
        if (!d->progressive || h->Ss)
            memset(d->ac_stats[h->sac[i]], 0, 256);
    }
    d->ac_c = 0;
    d->ac_a = 0;
    d->ac_ct = -16;
}

/* Figures F.19-F.24: a DC difference into slot's predictor; -1 on a
 * magnitude overflow (JWRN_ARITH_BAD_CODE: the decoder stops, ct = -1) */
static int arith_dc(jdec *d, int slot, int tbl)
{
    uint8_t *st = d->dc_stats[tbl] + d->dc_context[slot];
    if (arith_decode(d, st) == 0) {
        d->dc_context[slot] = 0;
        return 0;
    }
    int sign = arith_decode(d, st + 1);
    st += 2 + sign;
    int m = arith_decode(d, st);
    if (m) {
        st = d->dc_stats[tbl] + 20;
        while (arith_decode(d, st)) {
            if ((m <<= 1) == 0x8000) {
                d->ac_ct = -1;
                return -1;
            }
            st++;
        }
    }
    if (m < (int)((1L << d->h.arith_dc_L[tbl]) >> 1))
        d->dc_context[slot] = 0;
    else if (m > (int)((1L << d->h.arith_dc_U[tbl]) >> 1))
        d->dc_context[slot] = 12 + sign * 4;
    else
        d->dc_context[slot] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
        if (arith_decode(d, st))
            v |= m;
    v += 1;
    if (sign)
        v = -v;
    d->last_dc[slot] = (d->last_dc[slot] + v) & 0xffff;
    return 0;
}

/* Figure F.20: the band Ss..Se of one block (decode_mcu with 1..63, and
 * decode_mcu_AC_first); -1 on a spectral or magnitude overflow */
static int arith_ac(jdec *d, int16_t *o, int tbl, int Ss, int Se, int Al)
{
    for (int k = Ss; k <= Se; k++) {
        uint8_t *st = d->ac_stats[tbl] + 3 * (k - 1);
        if (arith_decode(d, st))
            break;                            /* EOB */
        while (arith_decode(d, st + 1) == 0) {
            st += 3;
            if (++k > Se) {
                d->ac_ct = -1;                /* spectral overflow */
                return -1;
            }
        }
        int sign = arith_decode(d, d->fixed_bin);
        st += 2;
        int m = arith_decode(d, st);
        if (m && arith_decode(d, st)) {
            m <<= 1;
            st = d->ac_stats[tbl] + (k <= d->h.arith_ac_K[tbl] ? 189 : 217);
            while (arith_decode(d, st)) {
                if ((m <<= 1) == 0x8000) {
                    d->ac_ct = -1;            /* magnitude overflow */
                    return -1;
                }
                st++;
            }
        }
        int v = m;
        st += 14;
        while (m >>= 1)
            if (arith_decode(d, st))
                v |= m;
        v += 1;
        if (sign)
            v = -v;
        o[jpeg_natural_order[k]] = (int16_t)((unsigned)v << Al);
    }
    return 0;
}

/* decode_mcu_AC_refine, one block */
static void arith_ac_refine(jdec *d, int16_t *o, int tbl, int Ss, int Se,
                            int Al)
{
    const int p1 = 1 << Al, m1 = (int)(~0u << Al);
    int kex;
    for (kex = Se; kex > 0; kex--)            /* the previous stage's EOB */
        if (o[jpeg_natural_order[kex]])
            break;
    for (int k = Ss; k <= Se; k++) {
        uint8_t *st = d->ac_stats[tbl] + 3 * (k - 1);
        if (k > kex && arith_decode(d, st))
            break;                            /* EOB */
        for (;;) {
            int16_t *c = o + jpeg_natural_order[k];
            if (*c) {                         /* previously nonzero */
                if (arith_decode(d, st + 2))
                    *c = (int16_t)(*c < 0 ? *c + (int16_t)m1
                                          : *c + (int16_t)p1);
                break;
            }
            if (arith_decode(d, st + 1)) {    /* newly nonzero */
                *c = (int16_t)(arith_decode(d, d->fixed_bin) ? m1 : p1);
                break;
            }
            st += 3;
            if (++k > Se) {
                d->ac_ct = -1;                /* spectral overflow */
                return;
            }
        }
    }
}

/* ---------------------------- scans ---------------------------- */

typedef struct {
    int comp, slot, dx, dy;   /* frame component, scan slot, block in MCU */
} mcu_block;

static inline int16_t *block_at(dcomp *k, int bx, int by)
{
    return k->coef + ((size_t)by * k->bw + bx) * 64;
}

/* The scan kinds; each decodes one block of an MCU as libjpeg does. */
enum { SEQUENTIAL, DC_FIRST, DC_REFINE, AC_FIRST, AC_REFINE };

/* jdhuff.c decode_mcu_slow, one block: the DC difference (added to the
 * slot's predictor) and the run-length coded AC coefficients. A corrupt
 * run past 63 lands on jpeg_natural_order's padding entries. */
static void block_sequential(jdec *d, int16_t *o, int slot,
                             const mej_htbl *dc, const mej_htbl *ac)
{
    int s = br_huff(d, dc);
    if (s)
        s = extend(br_bits(d, s), s);
    d->last_dc[slot] += s;
    o[0] = (int16_t)d->last_dc[slot];
    for (int k = 1; k < 64; k++) {
        int rs = br_huff(d, ac);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            o[jpeg_natural_order[k]] = (int16_t)extend(br_bits(d, s), s);
        } else {
            if (r != 15)
                break;
            k += 15;
        }
    }
}

/* jdphuff.c decode_mcu_DC_first, one block */
static void block_dc_first(jdec *d, int16_t *o, int slot,
                           const mej_htbl *dc, int Al)
{
    int s = br_huff(d, dc);
    if (s)
        s = extend(br_bits(d, s), s);
    d->last_dc[slot] += s;
    o[0] = (int16_t)((unsigned)d->last_dc[slot] << Al);
}

/* jdphuff.c decode_mcu_AC_first: the band Ss..Se of one block, or one
 * block of a running EOB run */
static void block_ac_first(jdec *d, int16_t *o, const mej_htbl *ac,
                           int Ss, int Se, int Al)
{
    if (d->eobrun > 0) {
        d->eobrun--;
        return;
    }
    for (int k = Ss; k <= Se; k++) {
        int rs = br_huff(d, ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
            k += r;
            s = extend(br_bits(d, s), s);
            o[jpeg_natural_order[k]] = (int16_t)((unsigned)s << Al);
        } else if (r == 15) {
            k += 15;
        } else {
            d->eobrun = (1 << r) - 1;
            if (r)
                d->eobrun += br_bits(d, r);
            break;
        }
    }
}

/* a correction bit for an already nonzero coefficient: 1 raises its
 * magnitude by p1 (unless that bit is set already) */
static inline void refine_coef(jdec *d, int16_t *c, int p1, int m1)
{
    if (br_bits(d, 1) && (*c & p1) == 0)
        *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
}

/* jdphuff.c decode_mcu_AC_refine, one block: newly nonzero coefficients
 * (magnitude 1 << Al) and correction bits for the nonzero ones */
static void block_ac_refine(jdec *d, int16_t *o, const mej_htbl *ac,
                            int Ss, int Se, int Al)
{
    const int p1 = 1 << Al, m1 = (int)(~0u << Al);
    int k = Ss;
    if (d->eobrun == 0) {
        for (; k <= Se; k++) {
            int rs = br_huff(d, ac);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                s = br_bits(d, 1) ? p1 : m1;
            } else if (r != 15) {
                d->eobrun = 1 << r;
                if (r)
                    d->eobrun += br_bits(d, r);
                break;
            }
            /* skip r zero coefficients, refining the nonzero ones */
            do {
                int16_t *c = o + jpeg_natural_order[k];
                if (*c != 0)
                    refine_coef(d, c, p1, m1);
                else if (--r < 0)
                    break;
                k++;
            } while (k <= Se);
            if (s)
                o[jpeg_natural_order[k]] = (int16_t)s;
        }
    }
    if (d->eobrun > 0) {
        for (; k <= Se; k++)
            if (o[jpeg_natural_order[k]] != 0)
                refine_coef(d, o + jpeg_natural_order[k], p1, m1);
        d->eobrun--;
    }
}

/* One MCU of an arithmetic-coded scan (jdarith.c decode_mcu,
 * decode_mcu_DC_first, _DC_refine, _AC_first, _AC_refine). After an
 * error (ct = -1) the MCUs up to the next restart are left as they are;
 * DC refinement does not check it. */
static void decode_mcu_arith(jdec *d, int kind, int16_t **blk,
                             const mcu_block *mb, int nb)
{
    const mej_hdr *h = &d->h;
    if (kind == DC_REFINE) {
        for (int b = 0; b < nb; b++)
            if (arith_decode(d, d->fixed_bin))
                blk[b][0] |= (int16_t)(1 << h->Al);
        return;
    }
    if (d->ac_ct == -1)
        return;
    if (kind == AC_FIRST) {
        arith_ac(d, blk[0], h->sac[0], h->Ss, h->Se, h->Al);
        return;
    }
    if (kind == AC_REFINE) {
        arith_ac_refine(d, blk[0], h->sac[0], h->Ss, h->Se, h->Al);
        return;
    }
    for (int b = 0; b < nb; b++) {
        const int slot = mb[b].slot;
        if (arith_dc(d, slot, h->sdc[slot]))
            return;
        if (kind == DC_FIRST) {
            blk[b][0] = (int16_t)((unsigned)d->last_dc[slot] << h->Al);
        } else {
            blk[b][0] = (int16_t)d->last_dc[slot];
            if (arith_ac(d, blk[b], h->sac[slot], 1, 63, 0))
                return;
        }
    }
}

/* Decode one scan (the SOS just read), stopping after stop_rows MCU rows
 * (< 0: all). Returns 0 or an error. */
static int decode_scan(jdec *d, int stop_rows)
{
    mej_hdr *h = &d->h;
    const int ns = h->ns;
    mcu_block mb[MAX_BLOCKS_IN_MCU];
    int nb = 0, mcux, mcuy;
    if (ns == 1) {
        dcomp *k = &d->c[h->scomp[0]];
        mcux = k->wib;
        mcuy = k->hib;
        mb[nb++] = (mcu_block){h->scomp[0], 0, 0, 0};
    } else {
        mcux = d->mcux;
        mcuy = d->mcuy;
        for (int i = 0; i < ns; i++) {
            dcomp *k = &d->c[h->scomp[i]];
            for (int y = 0; y < k->v; y++)
                for (int x = 0; x < k->h; x++) {
                    if (nb == MAX_BLOCKS_IN_MCU)
                        return MEJ_ERROR;     /* JERR_BAD_MCU_SIZE */
                    mb[nb++] = (mcu_block){h->scomp[i], i, x, y};
                }
        }
    }
    /* latch quant tables at a component's first scan (jdinput.c) */
    for (int i = 0; i < ns; i++) {
        dcomp *k = &d->c[h->scomp[i]];
        int tq = h->comp[h->scomp[i]].tq;
        if (!k->latched) {
            if (tq > 3 || !h->qdef[tq])
                return MEJ_ERROR;             /* JERR_NO_QUANT_TABLE */
            memcpy(k->qt, h->qtab[tq], sizeof(k->qt));
            k->latched = 1;
        }
    }

    mej_htbl_new_generation();
    const mej_htbl *dct[MEJ_MAX_COMPS] = {0}, *act[MEJ_MAX_COMPS] = {0};
    const int Ss = h->Ss, Se = h->Se, Ah = h->Ah, Al = h->Al;
    int kind;
    d->scan_number++;
    if (!d->progressive) {
        /* arithmetic sequential scans take 1..63 whatever Ss, Se, Ah and
         * Al say (jdarith.c warns only); Huffman ones need their tables */
        kind = SEQUENTIAL;
        for (int i = 0; !d->arith && i < ns; i++) {
            dct[i] = scan_table(d, 0, h->sdc[i]);
            act[i] = scan_table(d, 1, h->sac[i]);
            if (!dct[i] || !act[i])
                return MEJ_ERROR;
        }
    } else {
        const int dc_band = Ss == 0;
        if ((dc_band ? Se != 0 : (Ss > Se || Se > 63 || ns != 1))
            || (Ah != 0 && Al != Ah - 1) || Al > 13)
            return MEJ_ERROR;                 /* JERR_BAD_PROGRESSION */
        kind = dc_band ? (Ah == 0 ? DC_FIRST : DC_REFINE)
                       : (Ah == 0 ? AC_FIRST : AC_REFINE);
        for (int i = 0; i < ns; i++) {
            /* progression status, and its state before this scan, which
             * block smoothing reads (start_pass_phuff_decoder) */
            dcomp *k = &d->c[h->scomp[i]];
            for (int j = Ss < 1 ? Ss : 1; j <= (Se > 9 ? Se : 9); j++)
                k->prev_bits[j] = d->scan_number > 1 ? k->coef_bits[j] : 0;
            for (int j = Ss; j <= Se; j++)
                k->coef_bits[j] = Al;
            if (d->arith)
                continue;
            if (kind == DC_FIRST && !(dct[i] = scan_table(d, 0, h->sdc[i])))
                return MEJ_ERROR;
            if (!dc_band && !(act[i] = scan_table(d, 1, h->sac[i])))
                return MEJ_ERROR;
        }
    }

    d->acc = 0;
    d->n = 0;
    d->insufficient = 0;
    d->eobrun = 0;
    d->next_restart_num = 0;
    for (int i = 0; i < MEJ_MAX_COMPS; i++)
        d->last_dc[i] = 0;
    if (d->arith)
        arith_reset(d);
    const int dri = h->dri;
    int togo = dri;
    if (stop_rows >= 0 && stop_rows < mcuy)
        mcuy = stop_rows;
    /* block rows of an iMCU row: a non-interleaved scan's MCU is a block */
    const int imcu_v = ns == 1 ? d->c[h->scomp[0]].v : 1;

    for (int my = 0; my < mcuy; my++) {
        for (int mx = 0; mx < mcux; mx++) {
            if (dri && togo == 0) {
                if (d->arith) {
                    read_restart_marker(d);
                    arith_reset(d);
                } else {
                    process_restart(d);
                }
                togo = dri;
            }
            if (!d->insufficient)
                d->last_good = my / imcu_v;
            int16_t *blk[MAX_BLOCKS_IN_MCU];
            for (int b = 0; b < nb; b++) {
                dcomp *k = &d->c[mb[b].comp];
                blk[b] = ns == 1 ? block_at(k, mx, my)
                    : block_at(k, mx * k->h + mb[b].dx,
                               my * k->v + mb[b].dy);
            }
            if (d->arith) {
                decode_mcu_arith(d, kind, blk, mb, nb);
            } else if (kind == DC_REFINE || !d->insufficient) {
                /* DC refinement reads on past the data (zero bits change
                 * nothing); the other kinds leave a whole MCU untouched
                 * once the segment ran out of data */
                for (int b = 0; b < nb; b++) {
                    int16_t *o = blk[b];
                    const int slot = mb[b].slot;
                    switch (kind) {
                    case SEQUENTIAL:
                        block_sequential(d, o, slot, dct[slot], act[slot]);
                        break;
                    case DC_FIRST:
                        block_dc_first(d, o, slot, dct[slot], Al);
                        break;
                    case DC_REFINE:
                        if (br_bits(d, 1))
                            o[0] |= (int16_t)(1 << Al);
                        break;
                    case AC_FIRST:
                        block_ac_first(d, o, act[0], Ss, Se, Al);
                        break;
                    default:
                        block_ac_refine(d, o, act[0], Ss, Se, Al);
                    }
                }
            }
            if (dri)
                togo--;
        }
    }
    d->acc = 0;               /* finish_pass: drop the buffered bits */
    d->n = 0;
    return 0;
}

/* Parse through the first SOS and set the frame up. */
static int begin(jdec *d, const uint8_t *data, unsigned long size)
{
    memset(d, 0, sizeof(*d));
    int rc = mej_src_start(&d->s, data, size, &d->h);
    if (rc)
        return rc;
    rc = mej_read_markers(&d->s, &d->h);
    if (rc == MEJ_AT_EOI)
        return MEJ_ERROR;     /* JERR_NO_IMAGE */
    if (rc != MEJ_AT_SOS)
        return rc;
    return setup_frame(d);
}

/* Every scan to the EOI. */
static int decode_all(jdec *d)
{
    for (;;) {
        int rc = decode_scan(d, -1);
        if (rc)
            return rc;
        rc = mej_read_markers(&d->s, &d->h);
        if (rc == MEJ_AT_EOI)
            return 0;
        if (rc != MEJ_AT_SOS)
            return rc;
    }
}

/* jdcoefct.c smoothing_ok (libjpeg-turbo 2.1): a progressive image is
 * smoothed when every component's quant table is latched with its DC and
 * first 9 AC values nonzero, every DC is at least partly known, and some
 * component's zigzag coefficients 1-9 are not all final. */
static int smoothing_ok(jdec *d)
{
    static const int qpos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    if (!d->progressive)
        return 0;
    int useful = 0;
    for (int c = 0; c < d->h.ncomp; c++) {
        dcomp *k = &d->c[c];
        if (!k->latched)
            return 0;
        for (int i = 0; i < 10; i++)
            if (k->qt[qpos[i]] == 0)
                return 0;
        if (k->coef_bits[0] < 0)
            return 0;
        for (int i = 1; i < 10; i++)
            if (k->coef_bits[i] != 0)
                useful = 1;
    }
    return useful;
}

/* ---------------------------- pixels ---------------------------- */

/* The ISLOW IDCT as libjpeg-turbo's x86 SIMD build computes it
 * (jidctint-sse2/avx2), which is what libjpeg runs on this platform. On
 * a well-formed stream it equals jidctint.c; on extreme coefficients
 * (corrupt data) the SIMD lanes decide the result, so they are followed
 * exactly: the dequantising multiply keeps the low 16 bits (pmullw);
 * the sums in0 + in4, in0 - in4, in7 + in3 and in5 + in1 wrap at 16
 * bits (paddw) before the 32-bit multiply-adds (pmaddwd, with the
 * constants regrouped so no other sum is formed in 16 bits); pass 1
 * descales by 11 and saturates to int16 (packssdw); a block whose rows
 * 1-7 are all zero takes pass 1's shortcut, DC << 2 in 16 bits (psllw);
 * pass 2 descales by 18 and saturates to int16 and then to int8
 * (packssdw, packsswb) before the +128 level shift. The 32-bit steps
 * run in uint32 (mod 2^32, as the lanes do). */
#define F_0_298 2446u
#define F_0_390 3196u
#define F_0_541 4433u
#define F_0_765 6270u
#define F_0_899 7373u
#define F_1_175 9633u
#define F_1_501 12299u
#define F_1_847 15137u
#define F_1_961 16069u
#define F_2_053 16819u
#define F_2_562 20995u
#define F_3_072 25172u

static inline int16_t sat16(int32_t x)
{
    return (int16_t)(x < -32768 ? -32768 : x > 32767 ? 32767 : x);
}

static inline uint32_t w16(int32_t x)   /* 16-bit wrap, sign-extended */
{
    return (uint32_t)(int32_t)(int16_t)x;
}

#define DESC(x, n) ((int32_t)((x) + (1u << ((n) - 1))) >> (n))

static void idct_1d_simd(const int16_t *in, int stride, int32_t *out,
                         int shift)
{
    const uint32_t i0 = (uint32_t)(int32_t)in[0];
    const uint32_t i1 = (uint32_t)(int32_t)in[stride];
    const uint32_t i2 = (uint32_t)(int32_t)in[2 * stride];
    const uint32_t i3 = (uint32_t)(int32_t)in[3 * stride];
    const uint32_t i4 = (uint32_t)(int32_t)in[4 * stride];
    const uint32_t i5 = (uint32_t)(int32_t)in[5 * stride];
    const uint32_t i6 = (uint32_t)(int32_t)in[6 * stride];
    const uint32_t i7 = (uint32_t)(int32_t)in[7 * stride];
    /* even part */
    uint32_t t0 = w16((int32_t)(i0 + i4)) << 13;
    uint32_t t1 = w16((int32_t)(i0 - i4)) << 13;
    uint32_t t2 = i2 * F_0_541 + i6 * (F_0_541 - F_1_847);
    uint32_t t3 = i2 * (F_0_541 + F_0_765) + i6 * F_0_541;
    uint32_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
    /* odd part */
    uint32_t z3 = w16((int32_t)(i7 + i3)), z4 = w16((int32_t)(i5 + i1));
    uint32_t z3m = z3 * (F_1_175 - F_1_961) + z4 * F_1_175;
    uint32_t z4m = z3 * F_1_175 + z4 * (F_1_175 - F_0_390);
    uint32_t o0 = i7 * (F_0_298 - F_0_899) + i1 * (0u - F_0_899) + z3m;
    uint32_t o3 = i7 * (0u - F_0_899) + i1 * (F_1_501 - F_0_899) + z4m;
    uint32_t o1 = i5 * (F_2_053 - F_2_562) + i3 * (0u - F_2_562) + z4m;
    uint32_t o2 = i5 * (0u - F_2_562) + i3 * (F_3_072 - F_2_562) + z3m;
    out[0] = DESC(t10 + o3, shift);
    out[7] = DESC(t10 - o3, shift);
    out[1] = DESC(t11 + o2, shift);
    out[6] = DESC(t11 - o2, shift);
    out[2] = DESC(t12 + o1, shift);
    out[5] = DESC(t12 - o1, shift);
    out[3] = DESC(t13 + o0, shift);
    out[4] = DESC(t13 - o0, shift);
}

static void idct_block(const int16_t *coef, const uint16_t *qt,
                       uint8_t *out, int ostride)
{
    int16_t d[64], ws[64];
    int32_t o[8];
    int ac = 0;
    for (int i = 0; i < 64; i++) {
        d[i] = (int16_t)(coef[i] * (int32_t)(int16_t)qt[i]);
        ac |= i >= 8 && coef[i];
    }
    if (!ac) {                     /* rows 1-7 zero: the DC shortcut */
        for (int i = 0; i < 64; i++)
            ws[i] = (int16_t)(d[i & 7] * 4);
    } else {
        for (int c = 0; c < 8; c++) {   /* pass 1: columns */
            idct_1d_simd(d + c, 8, o, 11);
            for (int r = 0; r < 8; r++)
                ws[8 * r + c] = sat16(o[r]);
        }
    }
    for (int r = 0; r < 8; r++) {       /* pass 2: rows */
        idct_1d_simd(ws + 8 * r, 1, o, 18);
        for (int c = 0; c < 8; c++) {
            int v = sat16(o[c]);
            v = v < -128 ? -128 : v > 127 ? 127 : v;
            out[r * ostride + c] = (uint8_t)(v + 128);
        }
    }
}

/* libjpeg-turbo 2.1's block smoothing (jdcoefct.c
 * decompress_smooth_data) of component ci into its sample plane sp (row
 * stride ps): the first 9 AC coefficients of each block that are still
 * zero and not known to full precision are estimated from the DC values
 * of the 5x5 blocks around it; where no AC band has been seen at all the
 * DC is interpolated too. An iMCU row past the last one the final scan
 * decoded with data (last_good_iMCU_row) reads the progression status as
 * it stood before that scan. The neighbours are fetched as libjpeg does:
 * the rows two above and below come from the previous and next block
 * row only when the block row or the iMCU row allows it (so in the second
 * and the next-to-last iMCU rows of a component with 2 block rows an
 * iMCU row the outer ones repeat the inner), the columns through its
 * sliding registers (so a 1- or 2-block-wide component reads stale values
 * at its right edge). Blocks libjpeg never outputs (padding) are
 * transformed plainly. */
static int16_t smooth_pred(int64_t num, int64_t q, int Al)
{
    int pred = (int)((((q << 7) + (num >= 0 ? num : -num))) / (q << 8));
    if (Al > 0 && pred >= (1 << Al))
        pred = (1 << Al) - 1;
    return (int16_t)(num >= 0 ? pred : -pred);
}

static void smooth_component(jdec *d, int ci, uint8_t *sp, int ps)
{
    dcomp *k = &d->c[ci];
    const uint16_t *qt = k->qt;
    const int64_t Q00 = qt[0], Q01 = qt[1], Q10 = qt[8], Q20 = qt[16],
                  Q11 = qt[9], Q02 = qt[2], Q03 = qt[3], Q12 = qt[10],
                  Q21 = qt[17], Q30 = qt[24];
    int now[10], before[10];                  /* the two latches */
    for (int i = 0; i < 10; i++) {
        now[i] = k->coef_bits[i];
        before[i] = d->scan_number > 1 ? k->prev_bits[i] : -1;
    }
    const int v = k->v, total = d->mcuy;
    for (int by = 0; by < k->bh; by++)        /* padding rows, plainly */
        for (int bx = 0; bx < k->bw; bx++)
            idct_block(block_at(k, bx, by), qt,
                       sp + (size_t)by * 8 * ps + bx * 8, ps);
    for (int r = 0; r < total; r++) {
        int rows = v;
        if (r == total - 1 && k->hib % v)
            rows = k->hib % v;
        const int *bits = r > d->last_good ? before : now;
        int change_dc = 1;
        for (int i = 1; i < 10; i++)
            change_dc &= bits[i] == -1;
        for (int br = 0; br < rows; br++) {
            /* the neighbour rows as libjpeg picks them: by block row
             * within the iMCU row, or by iMCU row */
            const int by = r * v + br, last_r = total - 1;
            const int16_t *cu = block_at(k, 0, by);
            const int16_t *pv = br > 0 || r > 0 ? block_at(k, 0, by - 1) : cu;
            const int16_t *pp = br > 1 || r > 1 ? block_at(k, 0, by - 2) : pv;
            const int16_t *nx = br < rows - 1 || r < last_r
                ? block_at(k, 0, by + 1) : cu;
            const int16_t *nn = br < rows - 2 || r + 1 < last_r
                ? block_at(k, 0, by + 2) : nx;
            int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10,
                DC11, DC12, DC13, DC14, DC15, DC16, DC17, DC18, DC19, DC20,
                DC21, DC22, DC23, DC24, DC25;
            DC01 = DC02 = DC03 = DC04 = DC05 = pp[0];
            DC06 = DC07 = DC08 = DC09 = DC10 = pv[0];
            DC11 = DC12 = DC13 = DC14 = DC15 = cu[0];
            DC16 = DC17 = DC18 = DC19 = DC20 = nx[0];
            DC21 = DC22 = DC23 = DC24 = DC25 = nn[0];
            const int last = k->wib - 1;
            for (int bx = 0; bx <= last; bx++) {
                const int o = bx * 64;
                int16_t ws[64];
                memcpy(ws, cu + o, sizeof(ws));
                if (bx == 0 && bx < last) {
                    DC04 = pp[o + 64];
                    DC09 = pv[o + 64];
                    DC14 = cu[o + 64];
                    DC19 = nx[o + 64];
                    DC24 = nn[o + 64];
                }
                if (bx + 1 < last) {
                    DC05 = pp[o + 128];
                    DC10 = pv[o + 128];
                    DC15 = cu[o + 128];
                    DC20 = nx[o + 128];
                    DC25 = nn[o + 128];
                }
                if (bits[1] != 0 && ws[1] == 0)           /* AC01 */
                    ws[1] = smooth_pred(Q00 * (change_dc ?
                        (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07
                         - 13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12
                         - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17
                         - 13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24
                         + DC25) :
                        (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)),
                        Q01, bits[1]);
                if (bits[2] != 0 && ws[8] == 0)           /* AC10 */
                    ws[8] = smooth_pred(Q00 * (change_dc ?
                        (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05
                         - DC06 + 13 * DC07 + 38 * DC08 + 13 * DC09 - DC10
                         + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20
                         + DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
                        (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)),
                        Q10, bits[2]);
                if (bits[3] != 0 && ws[16] == 0)          /* AC20 */
                    ws[16] = smooth_pred(Q00 * (change_dc ?
                        (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12
                         - 14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18
                         + 2 * DC19 + DC23) :
                        (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)),
                        Q20, bits[3]);
                if (bits[4] != 0 && ws[9] == 0)           /* AC11 */
                    ws[9] = smooth_pred(Q00 * (change_dc ?
                        (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17
                         + 9 * DC19 + DC21 - DC25) :
                        (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20
                         + DC22 - DC24 + DC04 - DC06 + 10 * DC07
                         - 10 * DC09)),
                        Q11, bits[4]);
                if (bits[5] != 0 && ws[2] == 0)           /* AC02 */
                    ws[2] = smooth_pred(Q00 * (change_dc ?
                        (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12
                         - 14 * DC13 + 7 * DC14 + DC15 + 2 * DC17
                         - 5 * DC18 + 2 * DC19) :
                        (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)),
                        Q02, bits[5]);
                if (change_dc) {
                    if (bits[6] != 0 && ws[3] == 0)       /* AC03 */
                        ws[3] = smooth_pred(Q00 * (DC07 - DC09 + 2 * DC12
                                                   - 2 * DC14 + DC17 - DC19),
                                            Q03, bits[6]);
                    if (bits[7] != 0 && ws[10] == 0)      /* AC12 */
                        ws[10] = smooth_pred(Q00 * (DC07 - 3 * DC08 + DC09
                                                    - DC17 + 3 * DC18 - DC19),
                                             Q12, bits[7]);
                    if (bits[8] != 0 && ws[17] == 0)      /* AC21 */
                        ws[17] = smooth_pred(Q00 * (DC07 - DC09 - 3 * DC12
                                                    + 3 * DC14 + DC17 - DC19),
                                             Q21, bits[8]);
                    if (bits[9] != 0 && ws[24] == 0)      /* AC30 */
                        ws[24] = smooth_pred(Q00 * (DC07 + 2 * DC08 + DC09
                                                    - DC17 - 2 * DC18 - DC19),
                                             Q30, bits[9]);
                    ws[0] = smooth_pred(Q00 *                  /* DC */
                        (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05
                         - 6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09
                         - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13
                         + 42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17
                         + 42 * DC18 + 6 * DC19 - 6 * DC20 - 2 * DC21
                         - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25),
                        Q00, 0);
                }
                idct_block(ws, qt, sp + (size_t)by * 8 * ps + bx * 8, ps);
                DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
                DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
                DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
                DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
                DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
            }
        }
    }
}

/* libjpeg's upsampler of a component (jdsample.c jinit_upsampler, with
 * fancy upsampling on, as the library's default): full size, the fancy
 * (triangle) filters where the ratio is 2 (plain replication for h2v1 and
 * h2v2 when the component is at most 2 samples wide), and replication
 * (int_upsample) for the other integral ratios; a ratio that is not an
 * integer is refused (JERR_FRACT_SAMPLE_NOTIMPL). */
static int upsampler(const jdec *d, const dcomp *k)
{
    const int hin = k->h, vin = k->v, hout = d->maxh, vout = d->maxv;
    if (hin == hout && vin == vout)
        return UP_FULL;
    if (hin * 2 == hout && vin == vout)
        return k->dw > 2 ? UP_H2V1 : UP_INT;
    if (hin == hout && vin * 2 == vout)
        return UP_H1V2;
    if (hin * 2 == hout && vin * 2 == vout)
        return k->dw > 2 ? UP_H2V2 : UP_INT;
    if (hout % hin == 0 && vout % vin == 0)
        return UP_INT;
    return UP_FRACT;
}

/* component c's samples (block-smoothed when smooth) upsampled to the
 * output size [H][W] */
static int component_plane(jdec *d, int c, uint8_t *up, int smooth)
{
    dcomp *k = &d->c[c];
    const int W = d->h.w, H = d->h.h;
    const int ps = k->bw * 8;
    uint8_t *sp = (uint8_t *)malloc((size_t)ps * k->bh * 8);
    if (!sp)
        return MEJ_ERROR;
    if (smooth)
        smooth_component(d, c, sp, ps);
    else
        for (int by = 0; by < k->bh; by++)
            for (int bx = 0; bx < k->bw; bx++)
                idct_block(block_at(k, bx, by), k->qt,
                           sp + (size_t)by * 8 * ps + bx * 8, ps);
    const int rh = d->maxh / k->h, rv = d->maxv / k->v;
    const int dw = k->dw, dh = k->dh;
    const int method = upsampler(d, k);
    for (int y = 0; y < H; y++) {
        uint8_t *o = up + (size_t)y * W;
        const int iy = y / rv;
        const uint8_t *r0 = sp + (size_t)iy * ps;
        if (method == UP_FULL) {
            memcpy(o, r0, (size_t)W);
            continue;
        }
        if (method == UP_INT) {       /* replication by rh x rv */
            for (int x = 0; x < W; x++)
                o[x] = r0[x / rh];
            continue;
        }
        /* the context row: above for even output rows, below for odd,
         * clamped to the component's rows (jdmainct.c) */
        int ny = (y & 1) ? iy + 1 : iy - 1;
        ny = ny < 0 ? 0 : ny > dh - 1 ? dh - 1 : ny;
        const uint8_t *r1 = sp + (size_t)ny * ps;
        if (method == UP_H1V2) {
            const int bias = (y & 1) ? 2 : 1;
            for (int x = 0; x < W; x++)
                o[x] = (uint8_t)((r0[x] * 3 + r1[x] + bias) >> 2);
        } else if (method == UP_H2V1) {
            for (int x = 0; x < W; x++) {
                int i = x >> 1;
                if (x & 1) {
                    int nx = i + 1 > dw - 1 ? dw - 1 : i + 1;
                    o[x] = (uint8_t)((r0[i] * 3 + r0[nx] + 2) >> 2);
                } else {
                    int px = i > 0 ? i - 1 : 0;
                    o[x] = (uint8_t)((r0[i] * 3 + r0[px] + 1) >> 2);
                }
            }
        } else {                      /* UP_H2V2 */
            for (int x = 0; x < W; x++) {
                int i = x >> 1;
                int j = (x & 1) ? (i + 1 > dw - 1 ? dw - 1 : i + 1)
                                : (i > 0 ? i - 1 : 0);
                int t = r0[i] * 3 + r1[i], n = r0[j] * 3 + r1[j];
                o[x] = (uint8_t)((t * 3 + n + ((x & 1) ? 7 : 8)) >> 4);
            }
        }
    }
    free(sp);
    return 0;
}

/* jdcolor.c build_ycc_rgb_table, SCALEBITS 16 */
static int ycc_tab[4][256];
static pthread_once_t ycc_once = PTHREAD_ONCE_INIT;

static void ycc_init(void)
{
    for (int i = 0; i < 256; i++) {
        int64_t x = i - 128;
        ycc_tab[0][i] = (int)((91881 * x + 32768) >> 16);      /* Cr->R */
        ycc_tab[1][i] = (int)((116130 * x + 32768) >> 16);     /* Cb->B */
        ycc_tab[2][i] = (int)(-46802 * x);                     /* Cr->G */
        ycc_tab[3][i] = (int)(-22554 * x + 32768);             /* Cb->G */
    }
}

static inline uint8_t clamp255(int v)
{
    return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

/* The whole frame as BGR [H][W][3] (malloc'd into *out). */
static int decode_frame(const uint8_t *data, unsigned long size,
                        uint8_t **out, int *ow, int *oh)
{
    jdec *d = (jdec *)calloc(1, sizeof(jdec));
    if (!d)
        return MEJ_ERROR;
    uint8_t *planes = NULL, *bgr = NULL;
    int rc = begin(d, data, size);
    int nc = d->h.ncomp;
    int rgb = 0;
    if (!rc && nc == 3) {
        if (d->h.saw_jfif)
            rgb = 0;
        else if (d->h.saw_adobe)
            rgb = d->h.adobe_transform == 0;
        else
            rgb = d->h.comp[0].id == 0x52 && d->h.comp[1].id == 0x47
                  && d->h.comp[2].id == 0x42;
    } else if (!rc && nc != 1) {
        rc = MEJ_ERROR;       /* no conversion to BGR (JERR_CONVERSION_NOTIMPL) */
    }
    if (!rc && (d->h.w > MAX_FRAME || d->h.h > MAX_FRAME))
        rc = MEJ_ERROR;
    if (!rc)
        rc = decode_all(d);
    const int smooth = !rc && smoothing_ok(d);
    const size_t npx = (size_t)d->h.w * d->h.h;
    if (!rc) {
        planes = (uint8_t *)malloc(npx * nc);
        bgr = (uint8_t *)malloc(npx * 3);
        if (!planes || !bgr)
            rc = MEJ_ERROR;
    }
    for (int c = 0; !rc && c < nc; c++)
        rc = component_plane(d, c, planes + npx * c, smooth);
    if (!rc) {
        pthread_once(&ycc_once, ycc_init);
        for (size_t i = 0; i < npx; i++) {
            uint8_t *o = bgr + 3 * i;
            if (nc == 1) {
                o[0] = o[1] = o[2] = planes[i];
            } else if (rgb) {
                o[0] = planes[2 * npx + i];
                o[1] = planes[npx + i];
                o[2] = planes[i];
            } else {
                int y = planes[i], cb = planes[npx + i],
                    cr = planes[2 * npx + i];
                o[2] = clamp255(y + ycc_tab[0][cr]);
                o[1] = clamp255(y + ((ycc_tab[3][cb] + ycc_tab[2][cr])
                                     >> 16));
                o[0] = clamp255(y + ycc_tab[1][cb]);
            }
        }
        *out = bgr;
        *ow = d->h.w;
        *oh = d->h.h;
        bgr = NULL;
    }
    free(bgr);
    free(planes);
    free_frame(d);
    free(d);
    return rc;
}

/* ------------------------ coefficient window ------------------------ */

/* The coefficient window of a frame the fast reader rejected, with the
 * checks and the early stop of the JAX reader's jpeg_read_coefficients
 * path (meterelf_jpeg.c mej_read_coefs_region_inner): 8-bit sequential
 * Huffman YCbCr 4:2:0 in one interleaved scan, quant values <= 255,
 * entropy decode stopped after the window's last iMCU row. */
int mej_general_coefs(const unsigned char *data, unsigned long size,
                      int lbx0, int lby0, int lbw, int lbh,
                      int exp_w, int exp_h, int plane,
                      int16_t *coefY, int16_t *coefCb, int16_t *coefCr,
                      uint16_t *qt)
{
    jdec *d = (jdec *)calloc(1, sizeof(jdec));
    if (!d)
        return MEJ_ERROR;
    mej_hdr *h = &d->h;
    int rc = begin(d, data, size);
    if (!rc) {
        int ycc = h->saw_jfif || (h->saw_adobe ? h->adobe_transform != 0
                                  : !(h->comp[0].id == 0x52
                                      && h->comp[1].id == 0x47
                                      && h->comp[2].id == 0x42));
        if (h->ncomp != 3 || !ycc || d->progressive || d->arith
            || h->comp[0].h != 2 || h->comp[0].v != 2
            || h->comp[1].h != 1 || h->comp[1].v != 1
            || h->comp[2].h != 1 || h->comp[2].v != 1)
            rc = 6;
        else if (h->ns != 3)
            rc = MEJ_REFUSED;     /* sequential in several scans: the
                                   * JAX reader's early stop can end in
                                   * its first (Y) scan, leaving the
                                   * chroma zero; decoded whole instead */
        else if (exp_w > 0 && (h->w != exp_w || h->h != exp_h))
            rc = 5;
    }
    if (!rc)
        rc = decode_scan(d, (lby0 + lbh + 1) / 2);
    if (!rc) {
        int cbx0 = lbx0 / 2, cby0 = lby0 / 2, cbw = lbw / 2, cbh = lbh / 2;
        if (lbx0 < 0 || lby0 < 0 || lbw <= 0 || lbh <= 0
            || ((lbx0 | lby0 | lbw | lbh) & 1)
            || lbx0 + lbw > ((d->c[0].wib + 1) & ~1)
            || lby0 + lbh > ((d->c[0].hib + 1) & ~1)
            || cbx0 + cbw > d->c[1].wib || cby0 + cbh > d->c[1].hib)
            rc = 8;
        for (int c = 0; !rc && c < 3; c++)
            for (int i = 0; i < 64; i++) {
                if (d->c[c].qt[i] > 255)
                    rc = 15;      /* 16-bit values: pixel fallback */
                qt[c * 64 + i] = d->c[c].qt[i];
            }
        for (int c = 0; !rc && c < 3; c++) {
            dcomp *k = &d->c[c];
            int16_t *dst = c == 0 ? coefY : c == 1 ? coefCb : coefCr;
            int x0 = c ? cbx0 : lbx0, y0 = c ? cby0 : lby0;
            int bw = c ? cbw : lbw, bh = c ? cbh : lbh;
            for (int y = 0; y < bh; y++)
                for (int x = 0; x < bw; x++) {
                    const int16_t *src = block_at(k, x0 + x, y0 + y);
                    if (plane) {
                        for (int r = 0; r < 8; r++)
                            memcpy(dst + ((size_t)y * 8 + r) * (bw * 8)
                                       + (size_t)x * 8,
                                   src + r * 8, 8 * sizeof(int16_t));
                    } else {
                        memcpy(dst + ((size_t)y * bw + x) * 64, src,
                               64 * sizeof(int16_t));
                    }
                }
        }
    }
    free_frame(d);
    free(d);
    return rc;
}

/* ------------------------------ batches ------------------------------ */

typedef struct {
    const unsigned char *const *datas;
    const unsigned long *sizes;
    int n, next;
    pthread_mutex_t lock;
    /* full frames */
    uint8_t *frames;          /* N * max_h * max_w * 3 */
    int max_w, max_h;
    int *widths, *heights;
    /* packed crops */
    int32_t *packed;          /* N * ph * pw, pre-zeroed */
    int pw, ph, rx, ry, rw, rh;
    int *ok;                  /* 0 = decoded */
} mej_pix_job;

static void decode_one(mej_pix_job *job, int i)
{
    uint8_t *img = NULL;
    int w = 0, h = 0;
    int rc = decode_frame(job->datas[i], job->sizes[i], &img, &w, &h);
    if (!rc && job->frames) {
        if (w > job->max_w || h > job->max_h) {
            rc = 2;
        } else {
            memcpy(job->frames + (size_t)i * job->max_w * job->max_h * 3,
                   img, (size_t)w * h * 3);
            job->widths[i] = w;
            job->heights[i] = h;
        }
    }
    if (!rc && job->packed) {
        if (job->rx < 0 || job->ry < 0 || job->rx + job->rw > w
            || job->ry + job->rh > h || job->rw > job->pw
            || job->rh > job->ph) {
            rc = 4;               /* the meter rect is not in the frame */
        } else {
            int32_t *o = job->packed + (size_t)i * job->pw * job->ph;
            for (int y = 0; y < job->rh; y++) {
                const uint8_t *s = img + ((size_t)(job->ry + y) * w
                                          + job->rx) * 3;
                for (int x = 0; x < job->rw; x++)
                    o[(size_t)y * job->pw + x] =
                        (int32_t)s[3 * x] | ((int32_t)s[3 * x + 1] << 8)
                        | ((int32_t)s[3 * x + 2] << 16);
            }
        }
    }
    free(img);
    job->ok[i] = rc;
}

static void *pix_worker(void *arg)
{
    mej_pix_job *job = (mej_pix_job *)arg;
    for (;;) {
        pthread_mutex_lock(&job->lock);
        int i = job->next++;
        pthread_mutex_unlock(&job->lock);
        if (i >= job->n)
            break;
        decode_one(job, i);
    }
    return NULL;
}

static void run_pix_job(mej_pix_job *job, int num_threads)
{
    job->next = 0;
    pthread_mutex_init(&job->lock, NULL);
    if (num_threads > job->n)
        num_threads = job->n;
    if (num_threads > 64)
        num_threads = 64;
    if (num_threads < 1)
        num_threads = 1;
    pthread_t threads[64];
    for (int t = 0; t < num_threads; t++)
        pthread_create(&threads[t], NULL, pix_worker, job);
    for (int t = 0; t < num_threads; t++)
        pthread_join(threads[t], NULL);
    pthread_mutex_destroy(&job->lock);
}

/* Whole frames: out [n, max_h, max_w, 3] BGR (rows of width w packed at
 * the start of each frame slot), widths/heights [n], ok [n] (0 = read;
 * otherwise the frame was not decoded). */
void mej_decode_full_batch(const unsigned char *const *datas,
                           const unsigned long *sizes, int n,
                           uint8_t *out, int max_w, int max_h,
                           int *widths, int *heights, int *ok,
                           int num_threads)
{
    mej_pix_job job;
    memset(&job, 0, sizeof(job));
    job.datas = datas;
    job.sizes = sizes;
    job.n = n;
    job.frames = out;
    job.max_w = max_w;
    job.max_h = max_h;
    job.widths = widths;
    job.heights = heights;
    job.ok = ok;
    run_pix_job(&job, num_threads);
}

/* The region (rx, ry, rw, rh) of each frame packed b | g<<8 | r<<16 into
 * out [n, ph, pw] i32 (pre-zeroed; the region lands at [0:rh, 0:rw]). */
void mej_decode_packed_batch(const unsigned char *const *datas,
                             const unsigned long *sizes, int n,
                             int32_t *out, int pw, int ph,
                             int rx, int ry, int rw, int rh, int *ok,
                             int num_threads)
{
    mej_pix_job job;
    memset(&job, 0, sizeof(job));
    job.datas = datas;
    job.sizes = sizes;
    job.n = n;
    job.packed = out;
    job.pw = pw;
    job.ph = ph;
    job.rx = rx;
    job.ry = ry;
    job.rw = rw;
    job.rh = rh;
    job.ok = ok;
    run_pix_job(&job, num_threads);
}
