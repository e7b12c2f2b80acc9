/* Native serial entropy layer: Thor bitstream frame parser.
 *
 * Clean-room C implementation of the host-side parse stage designed in
 * thor_tpu/dec/parse.py (itself mirroring the normative decode syntax
 * of dec/read_bits.c / dec/decode_block.c / dec/getvlc.c): the serial
 * VLC scan is the one inherently sequential stage of the TPU decoder,
 * so it runs as native code feeding SoA parameter planes to the batched
 * device kernels.
 *
 * Exposed as a plain C ABI consumed via ctypes (no pybind11 in this
 * environment). All outputs are caller-allocated numpy buffers.
 */

#include <stdint.h>
#include <string.h>

#define MAX_BLOCK_SIZE 64
#define MIN_BLOCK_SIZE 8
#define MIN_PB_SIZE 4
#define MAX_QUANT_SIZE 16

#define MODE_SKIP 0
#define MODE_INTRA 1
#define MODE_INTER 2
#define MODE_BIPRED 3
#define MODE_MERGE 4

#define I_FRAME 0
#define P_FRAME 1
#define B_FRAME 2

/* ------------------------------------------------------------------ */
/* Bit reader (MSB-first; reads past the payload return zero bits)     */

typedef struct {
    const uint8_t *data;
    int nbits;
    int pos;
} BitReader;

static int rd_showbits(BitReader *br, int n)
{
    int v = 0, pos = br->pos;
    for (int i = 0; i < n; i++) {
        v <<= 1;
        if (pos < br->nbits)
            v |= (br->data[pos >> 3] >> (7 - (pos & 7))) & 1;
        pos++;
    }
    return v;
}

static int rd_getbits(BitReader *br, int n)
{
    int v = rd_showbits(br, n);
    br->pos += n;
    return v;
}

static int rd_getbits1(BitReader *br) { return rd_getbits(br, 1); }

/* VLC tables 0-13 (bounded against runaway prefixes on corrupt data) */
static int get_vlc0_limit(int maxbit, BitReader *br)
{
    int tmp = 0, nbit = 0;
    while (tmp == 0 && nbit < maxbit) {
        tmp = rd_getbits1(br);
        nbit++;
    }
    return tmp == 0 ? maxbit : nbit - 1;
}

static int get_vlc(int n, BitReader *br)
{
    if (n < 6) {
        int zeroes = 0, done = 0, cw = 0;
        while (!done && zeroes < 6) {
            if (rd_getbits1(br)) {
                cw = rd_getbits(br, n);
                done = 1;
            } else
                zeroes++;
        }
        if (done)
            return (zeroes << n) + cw;
        int lead = n;
        for (;;) {
            if (rd_showbits(br, 1) == 0) {
                lead++;
                br->pos++;
                if (lead > 32) return -1;
            } else {
                int tmp = rd_getbits(br, lead + 1);
                return 6 * (1 << n) + tmp - (1 << n);
            }
        }
    } else if (n < 8) {
        int zeroes = 0;
        for (;;) {
            if (rd_getbits1(br))
                return (zeroes << (n - 4)) + rd_getbits(br, n - 4);
            zeroes++;
            if (zeroes > 64) return -1;
        }
    } else if (n == 8) {
        if (rd_getbits1(br)) return 0;
        if (rd_getbits1(br)) return 1;
        return 2;
    } else if (n == 9) {
        if (rd_getbits1(br)) {
            if (rd_getbits1(br)) return rd_getbits(br, 3) + 3;
            if (rd_getbits1(br)) return rd_getbits1(br) + 1;
            return 0;
        }
        int zeroes = 0;
        for (;;) {
            if (rd_getbits1(br))
                return (zeroes << 4) + rd_getbits(br, 4) + 11;
            zeroes++;
            if (zeroes > 64) return -1;
        }
    } else if (n == 10) {
        int lead = 0;
        for (;;) {
            if (rd_showbits(br, 1) == 0) {
                lead++;
                br->pos++;
                if (lead > 32) return -1;
            } else
                return rd_getbits(br, lead + 1) - 1;
        }
    } else if (n == 11) {
        if (rd_getbits1(br)) return 0;
        if (rd_getbits1(br)) return 1;
        int val = 0;
        for (;;) {
            int tmp = rd_getbits1(br);
            val += 2;
            if (tmp) break;
            if (val > 128) return -1;
        }
        return val + rd_getbits1(br);
    } else if (n == 12) {
        int val = 0;
        while (val < 4) {
            if (rd_getbits1(br)) break;
            val++;
        }
        return val;
    } else if (n == 13) {
        int val = 0;
        while (val < 6) {
            if (rd_getbits1(br)) break;
            val++;
        }
        return val;
    }
    return -1;
}

/* ------------------------------------------------------------------ */
/* Zigzag tables (normative scan order)                                */

static const int zigzag16[16] = {
    0, 1, 5, 6, 2, 4, 7, 12, 3, 8, 11, 13, 9, 10, 14, 15};
static const int zigzag64[64] = {
    0, 1, 5, 6, 14, 15, 27, 28, 2, 4, 7, 13, 16, 26, 29, 42,
    3, 8, 12, 17, 25, 30, 41, 43, 9, 11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};
static const int zigzag256[256] = {
    0, 1, 5, 6, 14, 15, 27, 28, 44, 45, 65, 66, 90, 91, 119, 120,
    2, 4, 7, 13, 16, 26, 29, 43, 46, 64, 67, 89, 92, 118, 121, 150,
    3, 8, 12, 17, 25, 30, 42, 47, 63, 68, 88, 93, 117, 122, 149, 151,
    9, 11, 18, 24, 31, 41, 48, 62, 69, 87, 94, 116, 123, 148, 152, 177,
    10, 19, 23, 32, 40, 49, 61, 70, 86, 95, 115, 124, 147, 153, 176, 178,
    20, 22, 33, 39, 50, 60, 71, 85, 96, 114, 125, 146, 154, 175, 179, 200,
    21, 34, 38, 51, 59, 72, 84, 97, 113, 126, 145, 155, 174, 180, 199, 201,
    35, 37, 52, 58, 73, 83, 98, 112, 127, 144, 156, 173, 181, 198, 202, 219,
    36, 53, 57, 74, 82, 99, 111, 128, 143, 157, 172, 182, 197, 203, 218, 220,
    54, 56, 75, 81, 100, 110, 129, 142, 158, 171, 183, 196, 204, 217, 221, 234,
    55, 76, 80, 101, 109, 130, 141, 159, 170, 184, 195, 205, 216, 222, 233, 235,
    77, 79, 102, 108, 131, 140, 160, 169, 185, 194, 206, 215, 223, 232, 236, 245,
    78, 103, 107, 132, 139, 161, 168, 186, 193, 207, 214, 224, 231, 237, 244, 246,
    104, 106, 133, 138, 162, 167, 187, 192, 208, 213, 225, 230, 238, 243, 247, 252,
    105, 134, 137, 163, 166, 188, 191, 209, 212, 226, 229, 239, 242, 248, 251, 253,
    135, 136, 164, 165, 189, 190, 210, 211, 227, 228, 240, 241, 249, 250, 254, 255};

/* ------------------------------------------------------------------ */
/* Side-information map (SoA over the 4x4 grid, caller-allocated)      */

typedef struct {
    int32_t *mode, *size, *tb_split, *pb_part;
    int32_t *cbp_y, *cbp_u, *cbp_v;
    int32_t *mv0x, *mv0y, *mv1x, *mv1y;
    int32_t *ref_idx0, *ref_idx1, *bipred_flag;
    int gh, gw;
} DD;

typedef struct {
    int32_t mv0x, mv0y, mv1x, mv1y;
    int32_t ref_idx0, ref_idx1, bipred_flag;
} InterPredC;

static InterPredC dd_at(const DD *dd, int flat)
{
    InterPredC p;
    p.mv0x = dd->mv0x[flat];
    p.mv0y = dd->mv0y[flat];
    p.mv1x = dd->mv1x[flat];
    p.mv1y = dd->mv1y[flat];
    p.ref_idx0 = dd->ref_idx0[flat];
    p.ref_idx1 = dd->ref_idx1[flat];
    p.bipred_flag = dd->bipred_flag[flat];
    return p;
}

static const InterPredC ZERO_PRED = {0, 0, 0, 0, 0, 0, 0};

/* Availability rules (quadtree decode order) */
static int get_upright_available(int ypos, int xpos, int size, int width)
{
    int avail = (ypos > 0) && (xpos + size < width);
    if (size == 32 && (ypos % 64) == 32) avail = 0;
    if (size == 16 && ((ypos % 32) == 16
                       || ((ypos % 64) == 32 && (xpos % 32) == 16)))
        avail = 0;
    if (size == 8 && ((ypos % 16) == 8
                      || ((ypos % 32) == 16 && (xpos % 16) == 8)
                      || ((ypos % 64) == 32 && (xpos % 32) == 24)))
        avail = 0;
    return avail;
}

static int get_downleft_available(int ypos, int xpos, int size, int height)
{
    int avail = (xpos > 0) && (ypos + size < height);
    if (size == 64) avail = 0;
    if (size == 32 && (ypos % 64) == 32) avail = 0;
    if (size == 16 && ((ypos % 64) == 48
                       || ((ypos % 64) == 16 && (xpos % 32) == 16)))
        avail = 0;
    if (size == 8 && ((ypos % 64) == 56
                      || ((ypos % 16) == 8 && (xpos % 16) == 8)
                      || ((ypos % 64) == 24 && (xpos % 32) == 16)))
        avail = 0;
    return avail;
}

/* Median MV predictor over availability-selected neighbors */
static void get_mv_pred(int ypos, int xpos, int width, int height, int size,
                        const DD *dd, int32_t *mvpx, int32_t *mvpy)
{
    int bs = size / MIN_PB_SIZE;
    int stride = width / MIN_PB_SIZE;
    int bi = (ypos / MIN_PB_SIZE) * stride + (xpos / MIN_PB_SIZE);

    int up0 = bi - stride;
    int up1 = bi - stride + (bs - 1) / 2;
    int up2 = bi - stride + bs - 1;
    int left0 = bi - 1;
    int left1 = bi + stride * ((bs - 1) / 2) - 1;
    int left2 = bi + stride * (bs - 1) - 1;
    int downleft = bi + stride * bs - 1;
    int upright = bi - stride + bs;
    int upleft = bi - stride - 1;

    int U = ypos > 0;
    int L = xpos > 0;
    int UR = get_upright_available(ypos, xpos, size, width);
    int DL = get_downleft_available(ypos, xpos, size, height);

    InterPredC a, b, c;
    if (!U && !UR && !L && !DL) {
        a = b = c = ZERO_PRED;
    } else if (U && !UR && !L && !DL) {
        a = dd_at(dd, up0); b = dd_at(dd, up1); c = dd_at(dd, up2);
    } else if (U && UR && !L && !DL) {
        a = dd_at(dd, up0); b = dd_at(dd, up2); c = dd_at(dd, upright);
    } else if (!U && !UR && L && !DL) {
        a = dd_at(dd, left0); b = dd_at(dd, left1); c = dd_at(dd, left2);
    } else if (U && !UR && L && !DL) {
        a = dd_at(dd, upleft); b = dd_at(dd, up2); c = dd_at(dd, left2);
    } else if (U && UR && L && !DL) {
        a = dd_at(dd, up0); b = dd_at(dd, upright); c = dd_at(dd, left2);
    } else if (!U && !UR && L && DL) {
        a = dd_at(dd, left0); b = dd_at(dd, left2); c = dd_at(dd, downleft);
    } else if (U && !UR && L && DL) {
        a = dd_at(dd, up2); b = dd_at(dd, left0); c = dd_at(dd, downleft);
    } else {
        a = dd_at(dd, up0); b = dd_at(dd, upright); c = dd_at(dd, left0);
    }

#define MEDIAN3(p, q, r) \
    ((p) < (q) ? ((q) < (r) ? (q) : ((p) < (r) ? (r) : (p))) \
               : ((p) < (r) ? (p) : ((q) < (r) ? (r) : (q))))
    *mvpx = MEDIAN3(a.mv0x, b.mv0x, c.mv0x);
    *mvpy = MEDIAN3(a.mv0y, b.mv0y, c.mv0y);
#undef MEDIAN3
}

/* LIMITED_SKIP two-candidate derivation with dedup (skip & merge) */
static int get_mv_skip_merge(int ypos, int xpos, int width, int height,
                             int size, const DD *dd, InterPredC *out)
{
    int bs = size / MIN_PB_SIZE;
    int stride = width / MIN_PB_SIZE;
    int bi = (ypos / MIN_PB_SIZE) * stride + (xpos / MIN_PB_SIZE);

    int up0 = bi - stride;
    int up2 = bi - stride + bs - 1;
    int left0 = bi - 1;
    int left2 = bi + stride * (bs - 1) - 1;
    int upright = bi - stride + bs;

    int up_av = ypos > 0;
    int left_av = xpos > 0;
    int upright_av = get_upright_available(ypos, xpos, size, width);

    if (ypos + size > height) left2 = left0;
    if (xpos + size > width) up2 = up0;

    InterPredC c0 = left_av ? dd_at(dd, left2) : ZERO_PRED;
    InterPredC c1 = upright_av ? dd_at(dd, upright)
                   : (up_av ? dd_at(dd, up2) : ZERO_PRED);

    out[0] = c0;
    int n = 1;
    int dup = (c1.mv0x == c0.mv0x && c1.mv0y == c0.mv0y
               && c1.ref_idx0 == c0.ref_idx0
               && c1.mv1x == c0.mv1x && c1.mv1y == c0.mv1y
               && c1.ref_idx1 == c0.ref_idx1
               && (c1.bipred_flag == c0.bipred_flag
                   || c1.bipred_flag == (int32_t)-1));
    if (!dup)
        out[n++] = c1;
    return n;
}

/* Block context (common/common_block.c:158-178 semantics) */
typedef struct { int split, cbp, index; } BlockCtx;

static BlockCtx find_block_contexts(int ypos, int xpos, int height,
                                    int width, int size, const DD *dd,
                                    int enable)
{
    BlockCtx bc = {-1, -1, -1};
    if (ypos >= MIN_BLOCK_SIZE && xpos >= MIN_BLOCK_SIZE
        && ypos + size < height && xpos + size < width && enable
        && size <= 64) {
        int stride = width / MIN_PB_SIZE;
        int by = ypos / MIN_PB_SIZE, bx = xpos / MIN_PB_SIZE;
        int up = (by - 1) * stride + bx;
        int left = by * stride + bx - 1;
        int split = (dd->size[up] < size) + (dd->size[left] < size);
        int cbp1 = (dd->cbp_y[up] > 0) + (dd->cbp_y[left] > 0);
        int cbp2 = ((dd->cbp_y[up] > 0 || dd->cbp_u[up] > 0
                     || dd->cbp_v[up] > 0)
                    + (dd->cbp_y[left] > 0 || dd->cbp_u[left] > 0
                       || dd->cbp_v[left] > 0));
        bc.split = split;
        bc.cbp = cbp1;
        bc.index = 3 * split + cbp2;
    }
    return bc;
}

/* ------------------------------------------------------------------ */
/* Frame parse                                                         */

typedef struct {
    int32_t width, height, pb_split, tb_split_enable, max_num_ref;
    int32_t interp_ref, max_delta_qp, deblocking, clpf;
    int32_t use_block_contexts, bipred;
} SeqHdr;

typedef struct {
    int32_t frame_type, stat_frame_type, qp, num_intra_modes, num_ref;
    int32_t ref_array[8];
    int32_t interp_ref_frame, display_frame_num;
    int32_t clpf_frame_enable, clpf_all;
} FrameHdr;

/* Per-block SoA outputs (caller-allocated, capacity >= #8x8 cells) */
typedef struct {
    int32_t *ypos, *xpos, *size, *mode, *dir;
    int32_t *ref_idx0, *ref_idx1, *intra_mode, *tb_split, *qp;
    int32_t *cbp;                 /* bit0 y, bit1 u, bit2 v */
    int32_t *mv0x, *mv0y, *mv1x, *mv1y;   /* [4] per block, stride 4 */
    int16_t *coeff_y, *coeff_u, *coeff_v; /* compact, offsets below */
    int64_t *coff_y, *coff_u, *coff_v;    /* per-block start offsets */
    int32_t *clpf_bits;          /* per-SB; -1 = not read */
    int nblocks;
    int64_t ny, nu, nv;
} Out;

typedef struct {
    const SeqHdr *seq;
    FrameHdr *fh;
    BitReader br;
    DD dd;
    Out *out;
    const int32_t *ref_frame_nums;
    int qpb, mode, ref_idx;
    BlockCtx bc;
} Parser;

static const int CBP_TABLE[8] = {1, 0, 5, 2, 6, 3, 7, 4};

static void read_mv(Parser *ps, int32_t px, int32_t py, int32_t *ox,
                    int32_t *oy)
{
    int code = get_vlc(10, &ps->br);
    int mvdx = (code & 1) ? -((code + 1) / 2) : code / 2;
    code = get_vlc(10, &ps->br);
    int mvdy = (code & 1) ? -((code + 1) / 2) : code / 2;
    *ox = (int16_t)(px + mvdx);
    *oy = (int16_t)(py + mvdy);
}

static int find_index(int code, int maxrun, int type)
{
    int maxrun2 = maxrun > 4 ? maxrun : 4;
    if (type) {
        if (code == 0) return -1;
        if (code <= 5) return code - 1;
        if (code == 6) return maxrun2 + 1;
        if (code == 7) return maxrun2 + 2;
        if (code <= maxrun2 + 3) return code - 3;
        return code - 1;
    }
    if (code <= 1) return code;
    if (code == 2) return -1;
    if (code <= 5) return code - 1;
    if (code == 6) return maxrun2 + 1;
    if (code == 7) return maxrun2 + 2;
    if (code <= maxrun2 + 3) return code - 3;
    return code - 1;
}

/* Coefficient run/level decode; writes a (size x size) int16 plane with
 * inverse zigzag applied into dst (row-major, stride = size). */
static void read_coeff(Parser *ps, int size, int type, int16_t *dst,
                       int dstride)
{
    BitReader *br = &ps->br;
    int qsize = size < MAX_QUANT_SIZE ? size : MAX_QUANT_SIZE;
    int N = qsize * qsize;
    int chroma_flag = type & 1;
    int intra_flag = (type >> 1) & 1;
    int vlc_adaptive = (intra_flag && !chroma_flag) ? 1 : 0;
    int16_t scoeff[256];
    memset(scoeff, 0, sizeof(int16_t) * N);
    int pos = 0;

    if (chroma_flag == 1) {
        if (rd_getbits1(br)) {
            int sign = rd_getbits1(br);
            scoeff[0] = sign ? -1 : 1;
            pos = N;
        }
    }

    int level_mode = 1, level = 1;
    while (pos < N) {
        if (level_mode) {
            while (pos < N && level > 0) {
                level = get_vlc(vlc_adaptive, br);
                int sign = level ? rd_getbits1(br) : 1;
                scoeff[pos] = sign ? -level : level;
                if (chroma_flag == 0)
                    vlc_adaptive = level > 3 ? 1 : 0;
                pos++;
            }
        }
        if (pos >= N) break;

        int maxrun = N - pos - 1;
        int code;
        if (chroma_flag && size <= 8)
            code = get_vlc(10, br);
        else {
            if (rd_showbits(br, 2) == 2)
                code = rd_getbits(br, 2) - 2;
            else
                code = get_vlc(2, br) - 1;
        }
        int index = find_index(code, maxrun, chroma_flag);
        /* corrupt-stream guard: code == -1 (vlc2 prefix 0) reaches the
           chroma branch of find_index, which maps it to -2, and C's %
           would then drive pos negative */
        if (index < 0) break;
        int maxrun2 = maxrun > 4 ? maxrun : 4;
        int level_flag = index / (maxrun2 + 1);
        int run = index % (maxrun2 + 1);
        pos += run;
        /* corrupt-stream guard: the table allows run > maxrun when
           maxrun < 4, which would write past scoeff[N] (valid encoders
           never emit it) */
        if (pos >= N) break;
        int sign;
        if (level_flag) {
            int tmp = get_vlc(0, br);
            sign = tmp & 1;
            level = (tmp >> 1) + 2;
        } else {
            level = 1;
            sign = rd_getbits1(br);
        }
        scoeff[pos] = sign ? -level : level;
        level_mode = level > 1 ? 1 : 0;
        pos++;
    }

    const int *zz = qsize == 4 ? zigzag16 : (qsize == 8 ? zigzag64
                                                        : zigzag256);
    for (int i = 0; i < qsize; i++)
        for (int j = 0; j < qsize; j++)
            dst[i * dstride + j] = scoeff[zz[i * qsize + j]];
}

static int read_delta_qp(Parser *ps)
{
    int abs_dqp = get_vlc(0, &ps->br);
    int sign = abs_dqp > 0 ? rd_getbits(&ps->br, 1) : 0;
    return sign ? -abs_dqp : abs_dqp;
}

static int decode_super_mode(Parser *ps, int size, int decode_this_size)
{
    BitReader *br = &ps->br;
    ps->mode = MODE_SKIP;

    if (ps->fh->frame_type == I_FRAME) {
        ps->mode = MODE_INTRA;
        if (size > MIN_BLOCK_SIZE && decode_this_size)
            return rd_getbits1(br);
        return decode_this_size ? 0 : 1;
    }
    if (!decode_this_size)
        return rd_getbits1(br) ? 0 : 1;

    int num_ref = ps->fh->num_ref;
    int bipred_possible = num_ref > 1 && ps->seq->bipred;
    int split_possible = size > MIN_BLOCK_SIZE;
    int maxbit = 2 + num_ref + (split_possible ? 1 : 0)
        + (bipred_possible ? 1 : 0);
    int code = get_vlc0_limit(maxbit, br);
    BlockCtx bc = ps->bc;

    if (ps->fh->interp_ref_frame) {
        if ((bc.index == 2 || bc.index > 3) && size > MIN_BLOCK_SIZE)
            if (code < 3) code = (code + 1) % 3;
        if (split_possible && code == 1) return 1;
        if (!split_possible && code > 0) code++;
        if (!bipred_possible && code >= 3) code++;
        if (code == 0) ps->mode = MODE_SKIP;
        else if (code == 2) ps->mode = MODE_MERGE;
        else if (code == 3) ps->mode = MODE_BIPRED;
        else if (code == 4) ps->mode = MODE_INTRA;
        else if (code == 4 + num_ref) { ps->mode = MODE_INTER; ps->ref_idx = 0; }
        else { ps->mode = MODE_INTER; ps->ref_idx = code - 4; }
    } else {
        if ((bc.index == 2 || bc.index > 3) && size > MIN_BLOCK_SIZE)
            if (code < 4) code = (code + 1) % 4;
        if (split_possible && code == 1) return 1;
        if (!split_possible && code > 0) code++;
        if (!bipred_possible && code >= 4) code++;
        if (code == 0) ps->mode = MODE_SKIP;
        else if (code == 2) { ps->mode = MODE_INTER; ps->ref_idx = 0; }
        else if (code == 3) ps->mode = MODE_MERGE;
        else if (code == 4) ps->mode = MODE_BIPRED;
        else if (code == 5) ps->mode = MODE_INTRA;
        else { ps->mode = MODE_INTER; ps->ref_idx = code - 5; }
    }
    return 0;
}

static void dd_store_block(Parser *ps, int ypos, int xpos, int bwidth,
                           int bheight, int size, int mode,
                           int cbp_y, int cbp_u, int cbp_v, int tb_split,
                           int pb_part, const int32_t mv0x[4],
                           const int32_t mv0y[4], const int32_t mv1x[4],
                           const int32_t mv1y[4], int ref0, int ref1,
                           int dirf)
{
    DD *dd = &ps->dd;
    int by = ypos / MIN_PB_SIZE, bx = xpos / MIN_PB_SIZE;
    int div = size / (2 * MIN_PB_SIZE);
    for (int m = 0; m < bheight / MIN_PB_SIZE; m++) {
        for (int n = 0; n < bwidth / MIN_PB_SIZE; n++) {
            int m0 = div > 0 ? m / div : 0;
            int n0 = div > 0 ? n / div : 0;
            int index = 2 * m0 + n0;
            int f = (by + m) * dd->gw + bx + n;
            dd->cbp_y[f] = cbp_y;
            dd->cbp_u[f] = cbp_u;
            dd->cbp_v[f] = cbp_v;
            dd->tb_split[f] = tb_split > 0 ? 1 : 0;
            dd->pb_part[f] = pb_part;
            dd->size[f] = size;
            dd->mode[f] = mode;
            dd->mv0x[f] = mv0x[index];
            dd->mv0y[f] = mv0y[index];
            dd->ref_idx0[f] = ref0;
            dd->mv1x[f] = mv1x[index];
            dd->mv1y[f] = mv1y[index];
            dd->ref_idx1[f] = ref1;
            dd->bipred_flag[f] = dirf;
        }
    }
}

static void read_block(Parser *ps, int size, int ypos, int xpos)
{
    const SeqHdr *seq = ps->seq;
    BitReader *br = &ps->br;
    FrameHdr *fh = ps->fh;
    Out *o = ps->out;
    int width = seq->width, height = seq->height;
    int mode = ps->mode;
    int i = o->nblocks;

    int bwidth = size < width - xpos ? size : width - xpos;
    int bheight = size < height - ypos ? size : height - ypos;
    int coeff_block_type = (mode == MODE_INTRA ? 1 : 0) << 1;

    o->ypos[i] = ypos;
    o->xpos[i] = xpos;
    o->size[i] = size;
    o->mode[i] = mode;
    o->qp[i] = ps->qpb;
    o->intra_mode[i] = 0;
    o->dir[i] = 0;
    o->ref_idx0[i] = 0;
    o->ref_idx1[i] = 0;

    int32_t mv0x[4] = {0, 0, 0, 0}, mv0y[4] = {0, 0, 0, 0};
    int32_t mv1x[4] = {0, 0, 0, 0}, mv1y[4] = {0, 0, 0, 0};
    int pb_part = 0;

    if (mode == MODE_SKIP || mode == MODE_MERGE) {
        InterPredC cands[2];
        int num = get_mv_skip_merge(ypos, xpos, width, height, size,
                                    &ps->dd, cands);
        int skip_idx;
        if (num == 4) skip_idx = rd_getbits(br, 2);
        else if (num == 3)
            skip_idx = rd_getbits1(br) ? 0 : 1 + rd_getbits1(br);
        else if (num == 2) skip_idx = rd_getbits1(br);
        else skip_idx = 0;
        InterPredC c = cands[skip_idx];
        o->ref_idx0[i] = c.ref_idx0;
        o->ref_idx1[i] = c.ref_idx1;
        for (int k = 0; k < 4; k++) {
            mv0x[k] = c.mv0x; mv0y[k] = c.mv0y;
            mv1x[k] = c.mv1x; mv1y[k] = c.mv1y;
        }
        o->dir[i] = c.bipred_flag;
    } else if (mode == MODE_INTER) {
        if (seq->pb_split) {
            if (rd_getbits1(br)) pb_part = 0;
            else if (rd_getbits1(br)) pb_part = 1;
            else pb_part = 3 - rd_getbits1(br);
        }
        int ref_idx = fh->num_ref > 1 ? ps->ref_idx : 0;
        int32_t px, py;
        get_mv_pred(ypos, xpos, width, height, size, &ps->dd, &px, &py);
        if (pb_part == 0) {
            read_mv(ps, px, py, &mv0x[0], &mv0y[0]);
            for (int k = 1; k < 4; k++) { mv0x[k] = mv0x[0]; mv0y[k] = mv0y[0]; }
        } else if (pb_part == 1) {
            read_mv(ps, px, py, &mv0x[0], &mv0y[0]);
            read_mv(ps, mv0x[0], mv0y[0], &mv0x[2], &mv0y[2]);
            mv0x[1] = mv0x[0]; mv0y[1] = mv0y[0];
            mv0x[3] = mv0x[2]; mv0y[3] = mv0y[2];
        } else if (pb_part == 2) {
            read_mv(ps, px, py, &mv0x[0], &mv0y[0]);
            read_mv(ps, mv0x[0], mv0y[0], &mv0x[1], &mv0y[1]);
            mv0x[2] = mv0x[0]; mv0y[2] = mv0y[0];
            mv0x[3] = mv0x[1]; mv0y[3] = mv0y[1];
        } else {
            read_mv(ps, px, py, &mv0x[0], &mv0y[0]);
            read_mv(ps, mv0x[0], mv0y[0], &mv0x[1], &mv0y[1]);
            read_mv(ps, mv0x[0], mv0y[0], &mv0x[2], &mv0y[2]);
            read_mv(ps, mv0x[0], mv0y[0], &mv0x[3], &mv0y[3]);
        }
        memcpy(mv1x, mv0x, sizeof(mv0x));
        memcpy(mv1y, mv0y, sizeof(mv0y));
        o->ref_idx0[i] = ref_idx;
        o->ref_idx1[i] = ref_idx;
    } else if (mode == MODE_BIPRED) {
        int32_t px, py;
        get_mv_pred(ypos, xpos, width, height, size, &ps->dd, &px, &py);
        read_mv(ps, px, py, &mv0x[0], &mv0y[0]);
        for (int k = 1; k < 4; k++) { mv0x[k] = mv0x[0]; mv0y[k] = mv0y[0]; }
        if (fh->stat_frame_type == B_FRAME) { px = mv0x[0]; py = mv0y[0]; }
        read_mv(ps, px, py, &mv1x[0], &mv1y[0]);
        for (int k = 1; k < 4; k++) { mv1x[k] = mv1x[0]; mv1y[k] = mv1y[0]; }
        if (fh->stat_frame_type == B_FRAME) {
            o->ref_idx0[i] = fh->interp_ref_frame ? 1 : 0;
            o->ref_idx1[i] = fh->interp_ref_frame ? 2 : 1;
        } else {
            if (fh->num_ref == 2) {
                int code = get_vlc0_limit(3, br);
                o->ref_idx0[i] = (code >> 1) & 1;
                o->ref_idx1[i] = code & 1;
            } else {
                int code = get_vlc(10, br);
                o->ref_idx0[i] = (code >> 2) & 3;
                o->ref_idx1[i] = code & 3;
            }
        }
        o->dir[i] = 2;
    } else { /* MODE_INTRA */
        int n = fh->num_intra_modes;
        int intra_mode;
        if (n <= 4) {
            intra_mode = rd_getbits(br, 2);
        } else if (n <= 8) {
            static const int inv[10] = {3, 2, 0, 9, 8, 4, 7, 6, 1, 5};
            int tmp = rd_getbits(br, 2);
            int code;
            if (tmp < 3) code = tmp;
            else {
                tmp = rd_getbits(br, 2);
                code = tmp < 3 ? 3 + tmp : 6 + rd_getbits1(br);
            }
            intra_mode = inv[code];
        } else {
            static const int inv[10] = {3, 2, 0, 1, 9, 8, 4, 7, 6, 5};
            int code;
            if (rd_getbits1(br)) code = rd_getbits1(br);
            else if (rd_getbits1(br)) code = 2 + rd_getbits1(br);
            else if (rd_getbits1(br)) code = 4 + rd_getbits1(br);
            else code = 6 + rd_getbits(br, 2);
            intra_mode = inv[code];
        }
        o->intra_mode[i] = intra_mode;
        o->dir[i] = -1;
    }

    /* cbp + tb_split + coefficients */
    int sizeC = size / 2;
    int tb_split = 0;
    int cbp_y = 0, cbp_u = 0, cbp_v = 0;
    int16_t *cy = o->coeff_y + o->ny;
    int16_t *cu = o->coeff_u + o->nu;
    int16_t *cv = o->coeff_v + o->nv;
    o->coff_y[i] = o->ny;
    o->coff_u[i] = o->nu;
    o->coff_v[i] = o->nv;
    memset(cy, 0, sizeof(int16_t) * size * size);
    memset(cu, 0, sizeof(int16_t) * sizeC * sizeC);
    memset(cv, 0, sizeof(int16_t) * sizeC * sizeC);

    if (mode != MODE_SKIP) {
        int code = get_vlc(0, br);
        if (seq->tb_split_enable
            && (mode == MODE_INTRA || mode == MODE_INTER)) {
            tb_split = code == 2 ? 1 : 0;
            if (code > 2) code -= 1;
        }
        if (tb_split == 0) {
            if (mode == MODE_MERGE) {
                if (code == 7) code = 1;
                else if (code > 0) code = code + 1;
            }
            int tmp = 0;
            while (tmp < 8 && code != CBP_TABLE[tmp]) tmp++;
            if (mode != MODE_MERGE) {
                if (ps->bc.cbp == 0 && tmp < 2) tmp = 1 - tmp;
            }
            cbp_y = tmp & 1;
            cbp_u = (tmp >> 1) & 1;
            cbp_v = (tmp >> 2) & 1;
            if (cbp_y) read_coeff(ps, size, coeff_block_type | 0, cy, size);
            if (cbp_u) read_coeff(ps, sizeC, coeff_block_type | 1, cu, sizeC);
            if (cbp_v) read_coeff(ps, sizeC, coeff_block_type | 1, cv, sizeC);
        } else {
            if (size > 8) {
                int h2 = size / 2, c2 = sizeC / 2;
                for (int index = 0; index < 4; index++) {
                    int code2 = get_vlc(0, br);
                    int tmp = 0;
                    while (code2 != CBP_TABLE[tmp] && tmp < 8) tmp++;
                    if (ps->bc.cbp == 0 && tmp < 2) tmp = 1 - tmp;
                    int ccy = tmp & 1, ccu = (tmp >> 1) & 1,
                        ccv = (tmp >> 2) & 1;
                    int ii = (index >> 1) & 1, jj = index & 1;
                    if (ccy)
                        read_coeff(ps, h2, coeff_block_type | 0,
                                   cy + ii * h2 * size + jj * h2, size);
                    if (ccu)
                        read_coeff(ps, c2, coeff_block_type | 1,
                                   cu + ii * c2 * sizeC + jj * c2, sizeC);
                    if (ccv)
                        read_coeff(ps, c2, coeff_block_type | 1,
                                   cv + ii * c2 * sizeC + jj * c2, sizeC);
                }
                cbp_y = cbp_u = cbp_v = 1;
            } else {
                int h2 = size / 2;
                for (int index = 0; index < 4; index++) {
                    int ccy = rd_getbits1(br);
                    int ii = (index >> 1) & 1, jj = index & 1;
                    if (ccy)
                        read_coeff(ps, h2, coeff_block_type | 0,
                                   cy + ii * h2 * size + jj * h2, size);
                }
                int ccu, ccv;
                if (rd_getbits1(br)) { ccu = ccv = 0; }
                else if (rd_getbits1(br)) { ccu = 1; ccv = 0; }
                else if (rd_getbits1(br)) { ccu = 0; ccv = 1; }
                else { ccu = 1; ccv = 1; }
                if (ccu) read_coeff(ps, sizeC, coeff_block_type | 1, cu, sizeC);
                if (ccv) read_coeff(ps, sizeC, coeff_block_type | 1, cv, sizeC);
                cbp_y = cbp_u = cbp_v = 1;
            }
        }
    }
    o->tb_split[i] = tb_split;
    o->cbp[i] = cbp_y | (cbp_u << 1) | (cbp_v << 2);
    for (int k = 0; k < 4; k++) {
        o->mv0x[i * 4 + k] = mv0x[k];
        o->mv0y[i * 4 + k] = mv0y[k];
        o->mv1x[i * 4 + k] = mv1x[k];
        o->mv1y[i * 4 + k] = mv1y[k];
    }

    int pb_part_stored = mode == MODE_INTER ? pb_part : 0;
    dd_store_block(ps, ypos, xpos, bwidth, bheight, size, mode, cbp_y,
                   cbp_u, cbp_v, tb_split, pb_part_stored, mv0x, mv0y,
                   mv1x, mv1y, o->ref_idx0[i], o->ref_idx1[i], o->dir[i]);

    o->ny += (int64_t)size * size;
    o->nu += (int64_t)sizeC * sizeC;
    o->nv += (int64_t)sizeC * sizeC;
    o->nblocks++;
}

static void process_block_dec(Parser *ps, int size, int ypos, int xpos)
{
    const SeqHdr *seq = ps->seq;
    int width = seq->width, height = seq->height;
    if (ypos >= height || xpos >= width)
        return;
    int decode_this_size = (ypos + size <= height) && (xpos + size <= width);
    int decode_rectangular = !decode_this_size
        && ps->fh->frame_type != I_FRAME;

    ps->bc = find_block_contexts(ypos, xpos, height, width, size, &ps->dd,
                                 seq->use_block_contexts != 0);
    int split_flag = decode_super_mode(ps, size, decode_this_size);

    if (size == MAX_BLOCK_SIZE
        && (split_flag || ps->mode != MODE_SKIP)
        && seq->max_delta_qp > 0)
        ps->qpb = ps->fh->qp + read_delta_qp(ps);

    if (split_flag) {
        int h = size / 2;
        process_block_dec(ps, h, ypos, xpos);
        process_block_dec(ps, h, ypos + h, xpos);
        process_block_dec(ps, h, ypos, xpos + h);
        process_block_dec(ps, h, ypos + h, xpos + h);
    } else if (decode_this_size || decode_rectangular) {
        read_block(ps, size, ypos, xpos);
    }
}

/* Entry point. Returns number of blocks parsed, or -1 on error. */
int thor_parse_frame(
    const uint8_t *payload, int64_t payload_len, int32_t start_bit,
    const SeqHdr *seq, const int32_t *ref_frame_nums,
    /* dd planes, each gh*gw int32 */
    int32_t *dd_mode, int32_t *dd_size, int32_t *dd_tb_split,
    int32_t *dd_pb_part, int32_t *dd_cbp_y, int32_t *dd_cbp_u,
    int32_t *dd_cbp_v, int32_t *dd_mv0x, int32_t *dd_mv0y,
    int32_t *dd_mv1x, int32_t *dd_mv1y, int32_t *dd_ref_idx0,
    int32_t *dd_ref_idx1, int32_t *dd_bipred_flag,
    /* frame header out */
    FrameHdr *fh,
    /* block SoA out */
    int32_t *b_ypos, int32_t *b_xpos, int32_t *b_size, int32_t *b_mode,
    int32_t *b_dir, int32_t *b_ref0, int32_t *b_ref1, int32_t *b_imode,
    int32_t *b_tb, int32_t *b_qp, int32_t *b_cbp,
    int32_t *b_mv0x, int32_t *b_mv0y, int32_t *b_mv1x, int32_t *b_mv1y,
    int16_t *coeff_y, int16_t *coeff_u, int16_t *coeff_v,
    int64_t *coff_y, int64_t *coff_u, int64_t *coff_v,
    int32_t *clpf_bits)
{
    Parser ps;
    memset(&ps, 0, sizeof(ps));
    ps.seq = seq;
    ps.fh = fh;
    ps.br.data = payload;
    ps.br.nbits = (int)(payload_len * 8);
    ps.br.pos = start_bit;
    ps.ref_frame_nums = ref_frame_nums;

    ps.dd.gh = seq->height / MIN_PB_SIZE;
    ps.dd.gw = seq->width / MIN_PB_SIZE;
    ps.dd.mode = dd_mode; ps.dd.size = dd_size;
    ps.dd.tb_split = dd_tb_split; ps.dd.pb_part = dd_pb_part;
    ps.dd.cbp_y = dd_cbp_y; ps.dd.cbp_u = dd_cbp_u; ps.dd.cbp_v = dd_cbp_v;
    ps.dd.mv0x = dd_mv0x; ps.dd.mv0y = dd_mv0y;
    ps.dd.mv1x = dd_mv1x; ps.dd.mv1y = dd_mv1y;
    ps.dd.ref_idx0 = dd_ref_idx0; ps.dd.ref_idx1 = dd_ref_idx1;
    ps.dd.bipred_flag = dd_bipred_flag;
    memset(dd_mode, 0, sizeof(int32_t) * ps.dd.gh * ps.dd.gw);
    memset(dd_size, 0, sizeof(int32_t) * ps.dd.gh * ps.dd.gw);
    memset(dd_tb_split, 0, sizeof(int32_t) * ps.dd.gh * ps.dd.gw);
    memset(dd_pb_part, 0, sizeof(int32_t) * ps.dd.gh * ps.dd.gw);
    memset(dd_cbp_y, 0, sizeof(int32_t) * ps.dd.gh * ps.dd.gw);
    memset(dd_cbp_u, 0, sizeof(int32_t) * ps.dd.gh * ps.dd.gw);
    memset(dd_cbp_v, 0, sizeof(int32_t) * ps.dd.gh * ps.dd.gw);
    memset(dd_mv0x, 0, sizeof(int32_t) * ps.dd.gh * ps.dd.gw);
    memset(dd_mv0y, 0, sizeof(int32_t) * ps.dd.gh * ps.dd.gw);
    memset(dd_mv1x, 0, sizeof(int32_t) * ps.dd.gh * ps.dd.gw);
    memset(dd_mv1y, 0, sizeof(int32_t) * ps.dd.gh * ps.dd.gw);
    memset(dd_ref_idx0, 0, sizeof(int32_t) * ps.dd.gh * ps.dd.gw);
    memset(dd_ref_idx1, 0, sizeof(int32_t) * ps.dd.gh * ps.dd.gw);
    memset(dd_bipred_flag, 0, sizeof(int32_t) * ps.dd.gh * ps.dd.gw);

    Out out;
    memset(&out, 0, sizeof(out));
    out.ypos = b_ypos; out.xpos = b_xpos; out.size = b_size;
    out.mode = b_mode; out.dir = b_dir; out.ref_idx0 = b_ref0;
    out.ref_idx1 = b_ref1; out.intra_mode = b_imode; out.tb_split = b_tb;
    out.qp = b_qp; out.cbp = b_cbp;
    out.mv0x = b_mv0x; out.mv0y = b_mv0y;
    out.mv1x = b_mv1x; out.mv1y = b_mv1y;
    out.coeff_y = coeff_y; out.coeff_u = coeff_u; out.coeff_v = coeff_v;
    out.coff_y = coff_y; out.coff_u = coff_u; out.coff_v = coff_v;
    out.clpf_bits = clpf_bits;
    ps.out = &out;

    BitReader *br = &ps.br;

    /* frame header */
    fh->frame_type = rd_getbits1(br);
    fh->qp = rd_getbits(br, 8);
    fh->num_intra_modes = rd_getbits(br, 4);
    fh->interp_ref_frame = 0;
    int num_ref = 0;
    if (fh->frame_type != I_FRAME) {
        num_ref = rd_getbits(br, 2) + 1;
        for (int r = 0; r < num_ref; r++) {
            int v = rd_getbits(br, 6) - 1;
            fh->ref_array[r] = v;
            if (v == -1)
                fh->interp_ref_frame = 1;
        }
        if (num_ref == 2 && fh->ref_array[0] == -1) {
            fh->ref_array[num_ref] = rd_getbits(br, 5) - 1;
            num_ref++;
        }
    }
    fh->num_ref = num_ref;
    fh->display_frame_num = rd_getbits(br, 16);

    fh->stat_frame_type = fh->frame_type;
    for (int r = 0; r < num_ref; r++) {
        int v = fh->ref_array[r];
        if (v != -1 && ref_frame_nums[v] > fh->display_frame_num)
            fh->stat_frame_type = B_FRAME;
    }

    ps.qpb = fh->qp;
    ps.mode = MODE_SKIP;
    ps.ref_idx = 0;

    int nsb_h = (seq->width + MAX_BLOCK_SIZE - 1) / MAX_BLOCK_SIZE;
    int nsb_v = (seq->height + MAX_BLOCK_SIZE - 1) / MAX_BLOCK_SIZE;
    for (int k = 0; k < nsb_v; k++)
        for (int l = 0; l < nsb_h; l++)
            process_block_dec(&ps, MAX_BLOCK_SIZE, k * MAX_BLOCK_SIZE,
                              l * MAX_BLOCK_SIZE);

    /* CLPF signalling (after the SB loop) */
    fh->clpf_frame_enable = 0;
    fh->clpf_all = 0;
    int nfb_h = seq->width / MAX_BLOCK_SIZE;
    int nfb_v = seq->height / MAX_BLOCK_SIZE;
    for (int m = 0; m < nfb_v * nfb_h; m++)
        clpf_bits[m] = -1;
    if (seq->clpf) {
        fh->clpf_frame_enable = rd_getbits1(br);
        if (fh->clpf_frame_enable) {
            fh->clpf_all = rd_getbits1(br);
            if (!fh->clpf_all) {
                for (int k = 0; k < nfb_v; k++) {
                    for (int l = 0; l < nfb_h; l++) {
                        int cand = 0;
                        for (int m = 0; m < 8 && !cand; m++) {
                            for (int n = 0; n < 8 && !cand; n++) {
                                int gy = (k * 64 + m * 8) / 4;
                                int gx = (l * 64 + n * 8) / 4;
                                int f = gy * ps.dd.gw + gx;
                                if (ps.dd.mode[f] != MODE_BIPRED
                                    && (ps.dd.cbp_y[f] || ps.dd.cbp_u[f]
                                        || ps.dd.cbp_v[f]))
                                    cand = 1;
                            }
                        }
                        if (cand)
                            clpf_bits[k * nfb_h + l] = rd_getbits1(br);
                    }
                }
            }
        }
    }
    return out.nblocks;
}

/* Sequence header parse */
void thor_parse_seq_header(const uint8_t *payload, int64_t len, SeqHdr *s,
                           int32_t *bits_read)
{
    BitReader br = {payload, (int)(len * 8), 0};
    s->width = rd_getbits(&br, 16);
    s->height = rd_getbits(&br, 16);
    s->pb_split = rd_getbits1(&br);
    s->tb_split_enable = rd_getbits1(&br);
    s->max_num_ref = rd_getbits(&br, 2) + 1;
    s->interp_ref = rd_getbits1(&br);
    s->max_delta_qp = rd_getbits(&br, 3);
    s->deblocking = rd_getbits1(&br);
    s->clpf = rd_getbits1(&br);
    s->use_block_contexts = rd_getbits1(&br);
    s->bipred = rd_getbits1(&br);
    *bits_read = br.pos;
}
