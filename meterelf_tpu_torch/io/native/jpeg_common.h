/* jpeg_common.h — what the port's two host JPEG readers share.
 *
 * coefs.c (the fast baseline coefficient reader) and decoder.c (the
 * general decoder: every scan type the port reads, libjpeg's recovery
 * from truncated and corrupt data, and the pixel back-end) read a stream
 * through the same marker parser, the same Huffman tables and the same
 * per-thread table cache (jpeg_common.c). Neither needs libjpeg.
 */
#pragma once

#include <stdint.h>

#define DCTSIZE2 64
#define MEJ_MAX_COMPS 4

/* zigzag index -> natural (row-major) index, with 16 extra entries of 63
 * so that a corrupt run cannot index past the block (jutils.c) */
extern const int jpeg_natural_order[DCTSIZE2 + 16];

typedef struct {
    uint8_t len;              /* code length for LUT hits; 0 = escape */
    uint8_t sym;
} mej_hlut;

/* A Huffman table ready to decode: a 12-bit single-symbol LUT, the
 * canonical maxcode/valptr arrays for codes of 13-16 bits, and the fast
 * reader's multi-symbol AC table (layout in coefs.c). */
typedef struct {
    mej_hlut lut[4096];       /* first 12 bits -> (len, symbol) */
    uint64_t lutp[1024];      /* first 10 bits -> up to 2 coefficients */
    int32_t maxcode[17];      /* per length; -1 when no codes */
    int32_t mincode[17];
    int32_t valptr[17];
    uint8_t huffval[256];
    int valid;
} mej_htbl;

/* The table for a raw DHT definition from the calling thread's cache
 * (built on a miss; a hash hit counts only when the stored counts and
 * symbols are byte-equal). NULL when the definition is not a valid code
 * (libjpeg refuses it too). Tables claimed since the last
 * mej_htbl_new_generation() stay valid until the next one. */
const mej_htbl *mej_htbl_cached(const uint8_t counts[16],
                                const uint8_t *syms, int nsym);
void mej_htbl_new_generation(void);

/* ---- the marker parser (libjpeg's jdmarker.c read_markers rules) ---- */

typedef struct {
    const uint8_t *p, *end;   /* next unread byte */
    int unread_marker;        /* a marker read but not yet processed */
    int fake_d9;              /* past the end the memory source supplies
                               * FF D9 FF D9 ...; 1 when a cut segment
                               * took an FF of it, so D9 comes next */
} mej_src;

typedef struct {
    int id, h, v, tq;
} mej_comp;

typedef struct {
    int defined;
    uint8_t counts[16];
    uint8_t syms[256];
    int nsym;
} mej_dht;

typedef struct {
    /* frame */
    int saw_sof;
    int sof;                  /* SOF marker code (0xC0-0xC2, 0xC9, 0xCA) */
    int precision, w, h, ncomp;
    mej_comp comp[MEJ_MAX_COMPS];
    /* tables, as last defined */
    uint16_t qtab[4][64];     /* natural order */
    int qdef[4];
    int q16;                  /* a 16-bit (Pq = 1) DQT was read */
    mej_dht dht[2][4];        /* [class: 0 DC, 1 AC][id] */
    int dri;
    /* arithmetic conditioning (DAC), per table; SOI sets the defaults
     * L = 0, U = 1, K = 5 (jdmarker.c get_soi) */
    uint8_t arith_dc_L[16], arith_dc_U[16], arith_ac_K[16];
    int saw_jfif, saw_adobe, adobe_transform;
    int odd_markers;          /* RSTn, TEM, DNL or DAC met before an SOS */
    /* the scan of the last SOS */
    int ns;
    int scomp[MEJ_MAX_COMPS]; /* frame component index per scan slot */
    int sdc[MEJ_MAX_COMPS], sac[MEJ_MAX_COMPS];
    int Ss, Se, Ah, Al;
} mej_hdr;

enum {
    MEJ_ERROR = -1,           /* libjpeg refuses the stream too */
    MEJ_REFUSED = -2,         /* libjpeg reads it; a reader does not: the
                               * coefficient reader takes one interleaved
                               * sequential 4:2:0 scan only (the decoder
                               * reads every class libjpeg's 8-bit BGR
                               * decode reads) */
    MEJ_AT_SOS = 1,
    MEJ_AT_EOI = 2
};

/* Start a stream: checks the SOI at its first two bytes. */
int mej_src_start(mej_src *s, const uint8_t *data, unsigned long size,
                  mej_hdr *h);
/* Read markers until an SOS (its scan fields filled, the entropy data
 * next in *s) or the EOI. Past the end of the data the stream reads as
 * an EOI, as libjpeg's memory source makes it. */
int mej_read_markers(mej_src *s, mej_hdr *h);
/* libjpeg's next_marker: skip to the next marker, store its code in
 * s->unread_marker and return it. */
int mej_next_marker(mej_src *s);

/* decoder.c: the coefficient window of a stream the fast reader rejects
 * (0 = read), with the JAX reader's libjpeg-path checks. */
int mej_general_coefs(const unsigned char *data, unsigned long size,
                      int lbx0, int lby0, int lbw, int lbh,
                      int exp_w, int exp_h, int plane,
                      int16_t *coefY, int16_t *coefCb, int16_t *coefCr,
                      uint16_t *qt);
