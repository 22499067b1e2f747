/* jpeg_common.c — the marker parser, the Huffman tables and the table
 * cache that coefs.c and decoder.c share (declarations in
 * jpeg_common.h). The parser follows libjpeg's jdmarker.c: a stream it
 * reports as MEJ_ERROR is one libjpeg refuses as well. */

#include <string.h>

#include "jpeg_common.h"

const int jpeg_natural_order[DCTSIZE2 + 16] = {
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

static inline int mej_extend_c(uint32_t v, int s)
{
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
    /* second pass: the fast reader's pair table (interpreting sym as
     * (r,s); DC decoding never consults lutp). The per-thread cache
     * amortizes this across a stream batch: webcam feeds reuse identical
     * DHT definitions, so each distinct table is built once per thread. */
    memset(t->lutp, 0, sizeof(t->lutp));
    for (int key = 0; key < 1024; key++) {
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
        int v1 = mej_extend_c(vbits1, sz1);
        uint64_t ent = (uint64_t)nb1
                       | (1ull << 9) | ((uint64_t)r1 << 10)
                       | ((uint64_t)nb1 << 16)
                       | ((uint64_t)(v1 & 0xFFF) << 40);
        /* fuse a directly-following EOB when its code fits the
         * remaining window bits */
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

/* Per-thread Huffman-table cache, keyed by an FNV-1a hash of the raw
 * definition. A hash hit counts only when the stored definition (counts
 * and symbols) is byte-equal to the requested one, so a hash collision
 * builds a table of its own instead of decoding with a wrong one. Slots
 * claimed in the current generation are never evicted within it, so
 * table pointers stay valid across an entropy scan. 12 slots > the 8
 * table ids a scan can name. */
typedef struct {
    uint64_t hash;
    uint32_t gen;                 /* generation that claimed it */
    int used;
    int nsym;                     /* the raw definition the table was */
    uint8_t counts[16];           /* built from, compared on a hash hit */
    uint8_t syms[256];
    mej_htbl tbl;
} mej_tslot;

static __thread mej_tslot mej_tcache[12];
static __thread uint32_t mej_tgen;
static __thread int mej_tvictim;

void mej_htbl_new_generation(void)
{
    mej_tgen++;
}

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

const mej_htbl *mej_htbl_cached(const uint8_t counts[16],
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
            continue;             /* claimed in this generation */
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

/* ---------------------------- markers ---------------------------- */

int mej_src_start(mej_src *s, const uint8_t *data, unsigned long size,
                  mej_hdr *h)
{
    memset(h, 0, sizeof(*h));
    s->p = data;
    s->end = data + size;
    s->unread_marker = 0;
    s->fake_d9 = 0;
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8)
        return MEJ_ERROR;         /* jdmarker first_marker: no SOI */
    s->p += 2;
    for (int i = 0; i < 16; i++) {
        h->arith_dc_L[i] = 0;
        h->arith_dc_U[i] = 1;
        h->arith_ac_K[i] = 5;
    }
    return 0;
}

int mej_next_marker(mej_src *s)
{
    for (;;) {
        while (s->p < s->end && *s->p != 0xFF)
            s->p++;               /* garbage before the marker */
        while (s->p < s->end && *s->p == 0xFF)
            s->p++;               /* fill bytes */
        if (s->p >= s->end)
            return s->unread_marker = 0xD9;  /* the source's fake EOI */
        int c = *s->p++;
        if (c != 0)
            return s->unread_marker = c;
        /* FF 00: stuffed data, keep looking */
    }
}

/* The body of a marker segment: [*q, *qend) after its length field.
 * Returns its length field (-1 when the data ends inside the field). */
static int mej_segment(mej_src *s, const uint8_t **q, const uint8_t **qend)
{
    if (s->end - s->p < 2)
        return -1;
    int len = (s->p[0] << 8) | s->p[1];
    *q = s->p + 2;
    *qend = s->p + (len >= 2 ? len : 2);
    return len;
}

static int mej_get_sof(mej_hdr *h, const uint8_t *q, const uint8_t *qend,
                       int len, int marker)
{
    if (len < 8 || qend > q + (len - 2))
        return MEJ_ERROR;
    h->sof = marker;
    h->precision = q[0];
    h->h = (q[1] << 8) | q[2];
    h->w = (q[3] << 8) | q[4];
    h->ncomp = q[5];
    if (h->saw_sof)
        return MEJ_ERROR;         /* JERR_SOF_DUPLICATE */
    if (h->w <= 0 || h->h <= 0 || h->ncomp <= 0)
        return MEJ_ERROR;         /* JERR_EMPTY_IMAGE */
    if (len - 8 != h->ncomp * 3)
        return MEJ_ERROR;         /* JERR_BAD_LENGTH */
    if (h->ncomp > MEJ_MAX_COMPS)
        return MEJ_ERROR;         /* no BGR conversion in libjpeg either */
    q += 6;
    for (int c = 0; c < h->ncomp; c++, q += 3) {
        h->comp[c].id = q[0];
        h->comp[c].h = q[1] >> 4;
        h->comp[c].v = q[1] & 15;
        h->comp[c].tq = q[2];
        if (h->comp[c].h < 1 || h->comp[c].h > 4
            || h->comp[c].v < 1 || h->comp[c].v > 4)
            return MEJ_ERROR;     /* JERR_BAD_SAMPLING */
    }
    h->saw_sof = 1;
    return 0;
}

static int mej_get_dht(mej_hdr *h, const uint8_t *q, const uint8_t *qend)
{
    long length = qend - q;
    while (length > 16) {
        int index = q[0];
        int count = 0;
        for (int i = 0; i < 16; i++)
            count += q[1 + i];
        length -= 17;
        if (count > 256 || count > length)
            return MEJ_ERROR;     /* JERR_BAD_HUFF_TABLE */
        int cls = 0;
        if (index & 0x10) {
            index -= 0x10;
            cls = 1;
        }
        if (index < 0 || index >= 4)
            return MEJ_ERROR;     /* JERR_DHT_INDEX */
        mej_dht *d = &h->dht[cls][index];
        memcpy(d->counts, q + 1, 16);
        memset(d->syms, 0, sizeof(d->syms));
        memcpy(d->syms, q + 17, (size_t)count);
        d->nsym = count;
        d->defined = 1;
        q += 17 + count;
        length -= count;
    }
    return length != 0 ? MEJ_ERROR : 0;
}

static int mej_get_dqt(mej_hdr *h, const uint8_t *q, const uint8_t *qend)
{
    long length = qend - q;
    while (length > 0) {
        length--;
        int n = *q++;
        int prec = n >> 4;
        n &= 15;
        if (n >= 4)
            return MEJ_ERROR;     /* JERR_DQT_INDEX */
        int count;
        if (prec) {
            h->q16 = 1;
            count = length < 128 ? (int)(length >> 1) : 64;
        } else {
            count = length < 64 ? (int)length : 64;
        }
        if (count < 64)           /* short table: libjpeg fills with 1 */
            for (int i = 0; i < 64; i++)
                h->qtab[n][i] = 1;
        for (int i = 0; i < count; i++) {
            int v = prec ? (q[0] << 8) | q[1] : q[0];
            q += prec ? 2 : 1;
            h->qtab[n][jpeg_natural_order[i]] = (uint16_t)v;
        }
        h->qdef[n] = 1;
        length -= count;
        if (prec)
            length -= count;
    }
    return length != 0 ? MEJ_ERROR : 0;
}

/* jdmarker.c get_dac: (index, value) pairs; index < 16 sets a DC
 * table's L (low nibble) and U (high nibble), L <= U; 16..31 an AC
 * table's K */
static int mej_get_dac(mej_hdr *h, const uint8_t *q, const uint8_t *qend)
{
    long length = qend - q;
    if (length & 1)
        return MEJ_ERROR;         /* JERR_BAD_LENGTH */
    for (; length > 0; length -= 2, q += 2) {
        int index = q[0], val = q[1];
        if (index >= 32)
            return MEJ_ERROR;     /* JERR_DAC_INDEX */
        if (index >= 16) {
            h->arith_ac_K[index - 16] = (uint8_t)val;
        } else {
            h->arith_dc_L[index] = (uint8_t)(val & 0x0F);
            h->arith_dc_U[index] = (uint8_t)(val >> 4);
            if (h->arith_dc_L[index] > h->arith_dc_U[index])
                return MEJ_ERROR; /* JERR_DAC_VALUE */
        }
    }
    return 0;
}

static int mej_get_sos(mej_hdr *h, const uint8_t *q, const uint8_t *qend,
                       int len)
{
    if (!h->saw_sof)
        return MEJ_ERROR;         /* JERR_SOF_BEFORE */
    if (len < 3)
        return MEJ_ERROR;
    int n = q[0];
    if (len != n * 2 + 6 || n < 1 || n > 4 || qend - q != len - 2)
        return MEJ_ERROR;         /* JERR_BAD_LENGTH */
    q++;
    h->ns = n;
    for (int i = 0; i < n; i++, q += 2) {
        int c = 0;
        while (c < h->ncomp && h->comp[c].id != q[0])
            c++;
        if (c == h->ncomp)
            return MEJ_ERROR;     /* JERR_BAD_COMPONENT_ID */
        for (int j = 0; j < i; j++)
            if (h->scomp[j] == c)
                return MEJ_ERROR; /* a component twice in one scan */
        h->scomp[i] = c;
        h->sdc[i] = q[1] >> 4;
        h->sac[i] = q[1] & 15;
    }
    h->Ss = q[0];
    h->Se = q[1];
    h->Ah = q[2] >> 4;
    h->Al = q[2] & 15;
    return 0;
}

/* A segment [*q, *qend) cut by the end of the data: libjpeg reads the
 * memory source's fake EOI, FF D9 again and again, as the rest of its
 * body (and then meets the EOI). The body is rebuilt so in buf. */
static void cut_segment(mej_src *s, const uint8_t **q, const uint8_t **qend,
                        uint8_t *buf)
{
    long have = s->end - *q, body = *qend - *q;
    for (long i = 0; i < body; i++)
        buf[i] = i < have ? (*q)[i] : (i - have) & 1 ? 0xD9 : 0xFF;
    *q = buf;
    *qend = buf + body;
    s->p = s->end;
    s->fake_d9 = (int)((body - have) & 1);
}

int mej_read_markers(mej_src *s, mej_hdr *h)
{
    static __thread uint8_t cut_seg[65535];
    for (;;) {
        if (s->unread_marker == 0)
            mej_next_marker(s);
        int m = s->unread_marker;
        s->unread_marker = 0;
        const uint8_t *q = NULL, *qend = NULL;
        int len, rc = 0;
        switch (m) {
        case 0xC0: case 0xC1: case 0xC2:          /* SOF0/1/2 */
        case 0xC9: case 0xCA:                      /* SOF9/10: arithmetic */
            len = mej_segment(s, &q, &qend);
            if (len < 0 || qend > s->end)
                return MEJ_ERROR;
            rc = mej_get_sof(h, q, qend, len, m);
            s->p = qend;
            break;
        case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC8:
        case 0xCB: case 0xCD: case 0xCE: case 0xCF:
            return MEJ_ERROR;                      /* JERR_SOF_UNSUPPORTED */
        case 0xD8:
            return MEJ_ERROR;                      /* JERR_SOI_DUPLICATE */
        case 0xD9:
            return MEJ_AT_EOI;
        case 0xDA:                                 /* SOS */
            len = mej_segment(s, &q, &qend);
            if (len < 0)
                return MEJ_ERROR;
            if (len >= 2 && qend > s->end) {
                cut_segment(s, &q, &qend, cut_seg);
            } else {
                s->p = qend;
            }
            rc = mej_get_sos(h, q, qend, len);
            if (rc)
                return rc;
            return MEJ_AT_SOS;
        case 0xC4:                                 /* DHT */
        case 0xDB:                                 /* DQT */
        case 0xDD:                                 /* DRI */
        case 0xCC:                                 /* DAC */
            len = mej_segment(s, &q, &qend);
            if (len < 2)
                return MEJ_ERROR;
            if (qend > s->end) {
                cut_segment(s, &q, &qend, cut_seg);
            } else {
                s->p = qend;
            }
            if (m == 0xCC) {
                rc = mej_get_dac(h, q, qend);
                h->odd_markers = 1;
            } else if (m == 0xC4)
                rc = mej_get_dht(h, q, qend);
            else if (m == 0xDB)
                rc = mej_get_dqt(h, q, qend);
            else if (len != 4)
                rc = MEJ_ERROR;                    /* JERR_BAD_LENGTH */
            else
                h->dri = (q[0] << 8) | q[1];
            break;
        case 0xD0: case 0xD1: case 0xD2: case 0xD3:
        case 0xD4: case 0xD5: case 0xD6: case 0xD7:
        case 0x01:                                 /* RSTn, TEM: no body */
            h->odd_markers = 1;
            break;
        default:
            if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE
                || m == 0xDC) {                    /* APPn, COM, DNL */
                len = mej_segment(s, &q, &qend);
                if (len < 0) {
                    s->p = s->end;
                    break;
                }
                long avail = s->end - q;
                long body = len - 2;
                long seen = body < avail ? body : avail;
                if (m == 0xE0 && seen >= 14 && q[0] == 0x4A && q[1] == 0x46
                    && q[2] == 0x49 && q[3] == 0x46 && q[4] == 0)
                    h->saw_jfif = 1;               /* "JFIF\0" */
                if (m == 0xEE && seen >= 12 && q[0] == 0x41 && q[1] == 0x64
                    && q[2] == 0x6F && q[3] == 0x62 && q[4] == 0x65) {
                    h->saw_adobe = 1;              /* "Adobe" */
                    h->adobe_transform = q[11];
                }
                if (m == 0xDC)
                    h->odd_markers = 1;
                s->p = qend > s->end ? s->end : qend;
                break;
            }
            return MEJ_ERROR;                      /* JERR_UNKNOWN_MARKER */
        }
        if (rc)
            return rc;
    }
}
