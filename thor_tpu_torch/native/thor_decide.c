/* Device-encoder decision walk - native twin of
 * enc/device_inter.py:_decide_frame (behavioral reference:
 * enc/encode_block.c:2787-3033's bottom-up recursion).
 *
 * The walk is inherently sequential (skip/merge candidates and block
 * contexts derive from the evolving side-info map), but each step is
 * tiny integer work; in Python it dominated the device-encode host
 * time at 1080p. All RD costs are exact mirrors of the Python
 * implementation (which remains the parity oracle).
 *
 * Self-contained: the small side-info helpers are duplicated from
 * thor_entropy.c (they are file-static there).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define MIN_PB_SIZE 4
#define MIN_BLOCK_SIZE 8
#define MAX_BLOCK_SIZE 64

#define MODE_SKIP 0
#define MODE_INTRA 1
#define MODE_INTER 2
#define MODE_BIPRED 3
#define MODE_MERGE 4

/* ------------------------------------------------------------------ */
/* Measured maps for one block size (arrays [K, N] / [HB, WB])         */

typedef struct {
    const int32_t *mvx, *mvy, *slot;       /* [K, N] */
    const int64_t *ssd_coded, *ssd_pred;   /* [K, N] */
    const int32_t *bits;                   /* [K, N] */
    const uint8_t *cbp_y, *cbp_u, *cbp_v;  /* [K, N] */
    const int64_t *intra_cost;             /* [HB, WB] */
    const int32_t *intra_mode;             /* [HB, WB] */
    const int32_t *mvx1, *mvy1, *slot1;    /* [K, N] second list */
    /* tb-split trial outputs (sizes > 8 on tb-enabled configs):
       quadrant cbp masks carry bit (3-k) for quadrant k */
    const int64_t *ssd_tb;                 /* [K, N] */
    const int32_t *bits_tb;                /* [K, N] */
    const uint8_t *cbp_tb_y, *cbp_tb_u, *cbp_tb_v; /* [K, N] masks */
    int32_t K, N, HB, WB;
    int32_t K_uni;         /* variants [K_uni, K) are bipred pairs */
    int32_t has_tb;
} SizeMeas;

typedef struct {
    int32_t ypos, xpos, size, mode;
    int32_t mvx, mvy, ref;
    int32_t skip_idx, intra_mode, use_cbp, k, idx;
    int32_t mv1x, mv1y, ref1, dir;
    int32_t tb;            /* INTER leaf codes its residual tb-split */
} LeafOut;

/* ------------------------------------------------------------------ */
/* Side-info map + derivations (twin of thor_entropy.c's statics)      */

typedef struct {
    int32_t mv0x, mv0y, mv1x, mv1y;
    int32_t ref_idx0, ref_idx1, bipred_flag;
} InterPredC;

static const InterPredC ZERO_PRED = {0, 0, 0, 0, 0, 0, 0};

typedef struct {
    int32_t *mode, *size, *cbp_y, *cbp_u, *cbp_v;
    int32_t *mv0x, *mv0y, *mv1x, *mv1y;
    int32_t *ref_idx0, *ref_idx1, *bipred_flag;
    int gh, gw;
} DDm;

static InterPredC dd_at(const DDm *dd, int i)
{
    InterPredC p = {dd->mv0x[i], dd->mv0y[i], dd->mv1x[i], dd->mv1y[i],
                    dd->ref_idx0[i], dd->ref_idx1[i], dd->bipred_flag[i]};
    return p;
}

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

static void get_mv_pred(int ypos, int xpos, int width, int height, int size,
                        const DDm *dd, int32_t *mvpx, int32_t *mvpy)
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

static int get_mv_skip_merge(int ypos, int xpos, int width, int height,
                             int size, const DDm *dd, InterPredC *out)
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

typedef struct { int split, cbp, index; } BlockCtx;

static BlockCtx find_block_contexts(int ypos, int xpos, int height,
                                    int width, int size, const DDm *dd,
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

static void dd_store(DDm *dd, int ypos, int xpos, int size, int mode,
                     int cbp_y, int cbp_u, int cbp_v,
                     int32_t mv0x, int32_t mv0y, int32_t mv1x,
                     int32_t mv1y, int ref0, int ref1, int dirf)
{
    /* full square blocks only (the decide walk never stores partial) */
    int by = ypos / MIN_PB_SIZE, bx = xpos / MIN_PB_SIZE;
    int n = size / MIN_PB_SIZE;
    for (int m = 0; m < n; m++) {
        int f = (by + m) * dd->gw + bx;
        for (int q = 0; q < n; q++, f++) {
            dd->cbp_y[f] = cbp_y;
            dd->cbp_u[f] = cbp_u;
            dd->cbp_v[f] = cbp_v;
            dd->size[f] = size;
            dd->mode[f] = mode;
            dd->mv0x[f] = mv0x;
            dd->mv0y[f] = mv0y;
            dd->ref_idx0[f] = ref0;
            dd->mv1x[f] = mv1x;
            dd->mv1y[f] = mv1y;
            dd->ref_idx1[f] = ref1;
            dd->bipred_flag[f] = dirf;
        }
    }
}

/* ------------------------------------------------------------------ */
/* Bit-cost mirrors (bitstream/writer.py:quote_vlc etc.)               */

static int log2i(int v)
{
    int r = 0;
    while (v >>= 1) r++;
    return r;
}

static int quote_vlc0(int cn)
{
    if (cn < 6) return 1 + cn;
    return 6 + 1 + 2 * log2i(cn - 6 + 1);
}

static int quote_vlc10(int cn)
{
    return 1 + 2 * log2i(cn + 1);
}

static int quote_mv_bits(int dy, int dx)
{
    int b = 0;
    b += quote_vlc10(2 * abs(dx) - (dx < 0 ? 1 : 0));
    b += quote_vlc10(2 * abs(dy) - (dy < 0 ? 1 : 0));
    return b;
}

/* enc/write_bits.c:293 */
static const int CBP_TABLE[8] = {1, 0, 5, 2, 6, 3, 7, 4};

static int quote_cbp(int cy, int cu, int cv, int ctx_cbp0, int merge,
                     int tb_enabled)
{
    int code = CBP_TABLE[cy + 2 * cu + 4 * cv];
    if (merge) {
        if (code == 1) code = 7;
        else if (code > 1) code -= 1;
    } else {
        if (ctx_cbp0 && code < 2) code = 1 - code;
        if (tb_enabled && code > 1) code += 1;
    }
    return quote_vlc0(code);
}

/* tb_split payload header bits: the tb escape (code 2) plus four
 * per-quadrant cbp codes (enc/write_bits.c:287-347, size > 8) */
static int quote_cbp_tb(int my, int mu, int mv, int ctx_cbp0)
{
    int bits = quote_vlc0(2);
    for (int k = 0; k < 4; k++) {
        int sh = 3 - k;
        int code = CBP_TABLE[((my >> sh) & 1) + 2 * ((mu >> sh) & 1)
                             + 4 * ((mv >> sh) & 1)];
        if (ctx_cbp0 && code < 2) code = 1 - code;
        bits += quote_vlc0(code);
    }
    return bits;
}

static int skip_idx_bits(int nvec, int idx)
{
    if (nvec >= 4) return 2;
    if (nvec == 3) return idx == 0 ? 1 : 2;
    if (nvec == 2) return 1;
    return 0;
}

/* enc/write_bits.c:268-380 counting (device_inter._quote_super_mode) */
static int quote_super_mode(int size, BlockCtx bc, int num_ref,
                            int enable_bipred, int interp_ref, int mode,
                            int ref_idx0)
{
    int bipred_possible = num_ref > 1 && enable_bipred;
    int split_possible = size > MIN_BLOCK_SIZE;
    int maxbit = 2 + num_ref + (split_possible ? 1 : 0)
        + (bipred_possible ? 1 : 0);
    int code;
    if (interp_ref) {
        if (mode == MODE_SKIP) code = 0;
        else if (mode == MODE_MERGE) code = 2;
        else if (mode == MODE_INTRA) code = 4;
        else if (mode == MODE_INTER && ref_idx0 > 0) code = 4 + ref_idx0;
        else code = 4 + num_ref;
        if (!bipred_possible && code > 3) code -= 1;
        if (!split_possible && code > 1) code -= 1;
        if ((bc.index == 2 || bc.index > 3) && size > MIN_BLOCK_SIZE) {
            if (code < 3) code = (code + 2) % 3;
        }
    } else {
        if (mode == MODE_SKIP) code = 0;
        else if (mode == MODE_INTER && ref_idx0 == 0) code = 2;
        else if (mode == MODE_MERGE) code = 3;
        else if (mode == MODE_INTRA) code = 5;
        else code = 5 + ref_idx0;
        if (!bipred_possible && code > 4) code -= 1;
        if (!split_possible && code > 1) code -= 1;
        if ((bc.index == 2 || bc.index > 3) && size > MIN_BLOCK_SIZE) {
            if (code < 4) code = (code + 3) % 4;
        }
    }
    return code == maxbit ? maxbit : code + 1;
}

/* ------------------------------------------------------------------ */
/* The walk                                                            */

typedef struct {
    int W, H, num_ref, enable_bipred, interp_ref, use_block_contexts;
    int frame_type;        /* 0 I, 1 P, 2 B (BIPRED mv/ref coding) */
    int tb_cfg;            /* config enables tb_split (shifts the
                              INTER ntb cbp code space) */
    double lam, lam_me;
    SizeMeas meas[4];      /* sizes 8, 16, 32, 64 */
    DDm dd;
    LeafOut *leaves;
    int n_leaves;
} Walk;

static int size_slot(int s)
{
    return s == 8 ? 0 : (s == 16 ? 1 : (s == 32 ? 2 : 3));
}

/* best leaf choice at (s, y0, x0); returns cost and fills *lf */
static int64_t leaf_candidates(Walk *w, int s, int y0, int x0, LeafOut *lf)
{
    const SizeMeas *m = &w->meas[size_slot(s)];
    int HBW = w->W / s;
    int idx = (y0 / s) * HBW + (x0 / s);
    int K = m->K, N = m->N;
    BlockCtx bc = find_block_contexts(y0, x0, w->H, w->W, s, &w->dd,
                                      w->use_block_contexts);
    int ctx_cbp0 = bc.cbp == 0;

    InterPredC cands[2];
    int ncand = get_mv_skip_merge(y0, x0, w->W, w->H, s, &w->dd, cands);
    int32_t mvpx, mvpy;
    get_mv_pred(y0, x0, w->W, w->H, s, &w->dd, &mvpx, &mvpy);

    int64_t best_cost = -1;
    LeafOut best;
    memset(&best, 0, sizeof(best));

    int sm_skip = quote_super_mode(s, bc, w->num_ref, w->enable_bipred,
                                   w->interp_ref, MODE_SKIP, 0);
    int sm_merge = quote_super_mode(s, bc, w->num_ref, w->enable_bipred,
                                    w->interp_ref, MODE_MERGE, 0);

    int K_uni = m->K_uni > 0 ? m->K_uni : K;
    for (int ci = 0; ci < ncand; ci++) {
        InterPredC *c = &cands[ci];
        int k = -1;
        if (c->bipred_flag == 2) {
            for (int kk = K_uni; kk < K; kk++) {
                if (m->mvx[kk * N + idx] == c->mv0x
                    && m->mvy[kk * N + idx] == c->mv0y
                    && m->slot[kk * N + idx] == c->ref_idx0
                    && m->mvx1[kk * N + idx] == c->mv1x
                    && m->mvy1[kk * N + idx] == c->mv1y
                    && m->slot1[kk * N + idx] == c->ref_idx1) {
                    k = kk;
                    break;
                }
            }
        } else if (c->bipred_flag == 0) {
            for (int kk = 0; kk < K_uni; kk++) {
                if (m->mvx[kk * N + idx] == c->mv0x
                    && m->mvy[kk * N + idx] == c->mv0y
                    && m->slot[kk * N + idx] == c->ref_idx0) {
                    k = kk;
                    break;
                }
            }
        }
        if (k < 0)
            continue;
        {
            int bits = sm_skip + skip_idx_bits(ncand, ci);
            int64_t cost = m->ssd_pred[k * N + idx]
                + (int64_t)(w->lam * bits + 0.5);
            if (best_cost < 0 || cost < best_cost) {
                best_cost = cost;
                memset(&best, 0, sizeof(best));
                best.ypos = y0; best.xpos = x0; best.size = s;
                best.mode = MODE_SKIP;
                best.mvx = c->mv0x; best.mvy = c->mv0y;
                best.ref = c->ref_idx0;
                best.mv1x = c->mv1x; best.mv1y = c->mv1y;
                best.ref1 = c->ref_idx1; best.dir = c->bipred_flag;
                best.skip_idx = ci; best.idx = idx; best.k = k;
            }
        }
        int cy = m->cbp_y[k * N + idx];
        int cu = m->cbp_u[k * N + idx];
        int cv = m->cbp_v[k * N + idx];
        if (cy || cu || cv) {
            int bits = sm_merge + skip_idx_bits(ncand, ci)
                + quote_cbp(cy, cu, cv, ctx_cbp0, 1, 0)
                + m->bits[k * N + idx];
            int64_t cost = m->ssd_coded[k * N + idx]
                + (int64_t)(w->lam * bits + 0.5);
            if (cost < best_cost) {
                best_cost = cost;
                memset(&best, 0, sizeof(best));
                best.ypos = y0; best.xpos = x0; best.size = s;
                best.mode = MODE_MERGE;
                best.mvx = c->mv0x; best.mvy = c->mv0y;
                best.ref = c->ref_idx0;
                best.mv1x = c->mv1x; best.mv1y = c->mv1y;
                best.ref1 = c->ref_idx1; best.dir = c->bipred_flag;
                best.skip_idx = ci; best.idx = idx; best.use_cbp = 1;
                best.k = k;
            }
        }
    }

    /* INTER at the ME MV (k = 0): coded, zero-residual and - on
       tb-enabled configs for sizes > 8 - tb-split variants */
    {
        int mvx = m->mvx[idx], mvy = m->mvy[idx];
        int ref = m->slot[idx];
        int mvbits = quote_mv_bits(mvy - mvpy, mvx - mvpx);
        int smbits = quote_super_mode(s, bc, w->num_ref, w->enable_bipred,
                                      w->interp_ref, MODE_INTER, ref);
        int cy = m->cbp_y[idx], cu = m->cbp_u[idx], cv = m->cbp_v[idx];
        int tbe = w->tb_cfg;
        int cbp0_bits = quote_cbp(0, 0, 0, ctx_cbp0, 0, tbe);
        int64_t cost_zero = m->ssd_pred[idx]
            + (int64_t)(w->lam * (smbits + mvbits + cbp0_bits) + 0.5);
        int64_t cost_coded = m->ssd_coded[idx]
            + (int64_t)(w->lam * (smbits + mvbits + m->bits[idx]
                                  + quote_cbp(cy, cu, cv, ctx_cbp0, 0,
                                              tbe))
                        + 0.5);
        int64_t cost;
        int use_cbp, tb_pick = 0;
        if ((cy || cu || cv) && cost_coded < cost_zero) {
            cost = cost_coded; use_cbp = 1;
        } else {
            cost = cost_zero; use_cbp = 0;
        }
        if (m->has_tb) {
            int my = m->cbp_tb_y[idx], mu = m->cbp_tb_u[idx];
            int mvq = m->cbp_tb_v[idx];
            if (my || mu || mvq) {
                int64_t cost_tb = m->ssd_tb[idx]
                    + (int64_t)(w->lam * (smbits + mvbits
                                          + quote_cbp_tb(my, mu, mvq,
                                                         ctx_cbp0)
                                          + m->bits_tb[idx]) + 0.5);
                if (cost_tb < cost) {
                    cost = cost_tb; use_cbp = 1; tb_pick = 1;
                }
            }
        }
        if (best_cost < 0 || cost < best_cost) {
            best_cost = cost;
            memset(&best, 0, sizeof(best));
            best.ypos = y0; best.xpos = x0; best.size = s;
            best.mode = MODE_INTER;
            best.mvx = mvx; best.mvy = mvy; best.ref = ref;
            best.idx = idx; best.use_cbp = use_cbp; best.k = 0;
            best.tb = tb_pick;
        }
    }

    /* BIPRED at every measured bi pair (device_inter.leaf_candidates;
       ref enc/encode_block.c:2379-2427) */
    if (K_uni < K) {
        int smbits = quote_super_mode(s, bc, w->num_ref,
                                      w->enable_bipred, w->interp_ref,
                                      MODE_BIPRED, 0);
        int ctx_cbp0_bits = quote_cbp(0, 0, 0, ctx_cbp0, 0, 0);
        for (int k = K_uni; k < K; k++) {
            int mv0x = m->mvx[k * N + idx], mv0y = m->mvy[k * N + idx];
            int mv1x = m->mvx1[k * N + idx], mv1y = m->mvy1[k * N + idx];
            int r0 = m->slot[k * N + idx], r1 = m->slot1[k * N + idx];
            int mvbits = quote_mv_bits(mv0y - mvpy, mv0x - mvpx);
            int p2x = w->frame_type == 2 ? mv0x : mvpx;
            int p2y = w->frame_type == 2 ? mv0y : mvpy;
            mvbits += quote_mv_bits(mv1y - p2y, mv1x - p2x);
            int refbits = 0;
            if (w->frame_type == 1) {
                if (w->num_ref == 2) {
                    int code = 2 * r0 + r1;
                    refbits = code == 3 ? 3 : code + 1;
                } else {
                    refbits = quote_vlc10(4 * r0 + r1);
                }
            }
            int cy = m->cbp_y[k * N + idx];
            int cu = m->cbp_u[k * N + idx];
            int cv = m->cbp_v[k * N + idx];
            int hdr = smbits + mvbits + refbits;
            int64_t cost_zero = m->ssd_pred[k * N + idx]
                + (int64_t)(w->lam * (hdr + ctx_cbp0_bits) + 0.5);
            int64_t cost_coded = m->ssd_coded[k * N + idx]
                + (int64_t)(w->lam * (hdr + m->bits[k * N + idx]
                                      + quote_cbp(cy, cu, cv, ctx_cbp0,
                                                  0, 0)) + 0.5);
            int64_t cost;
            int use_cbp;
            if ((cy || cu || cv) && cost_coded < cost_zero) {
                cost = cost_coded; use_cbp = 1;
            } else {
                cost = cost_zero; use_cbp = 0;
            }
            if (cost < best_cost) {
                best_cost = cost;
                memset(&best, 0, sizeof(best));
                best.ypos = y0; best.xpos = x0; best.size = s;
                best.mode = MODE_BIPRED;
                best.mvx = mv0x; best.mvy = mv0y; best.ref = r0;
                best.mv1x = mv1x; best.mv1y = mv1y; best.ref1 = r1;
                best.dir = 2;
                best.idx = idx; best.use_cbp = use_cbp; best.k = k;
            }
        }
    }

    /* INTRA */
    {
        int smbits = quote_super_mode(s, bc, w->num_ref, w->enable_bipred,
                                      w->interp_ref, MODE_INTRA, 0);
        int64_t ic = m->intra_cost[(y0 / s) * m->WB + (x0 / s)]
            + (int64_t)(w->lam * smbits + 0.5);
        if (ic < best_cost) {
            best_cost = ic;
            memset(&best, 0, sizeof(best));
            best.ypos = y0; best.xpos = x0; best.size = s;
            best.mode = MODE_INTRA;
            best.intra_mode = m->intra_mode[(y0 / s) * m->WB + (x0 / s)];
            best.idx = idx;
        }
    }

    *lf = best;
    return best_cost;
}

static void store_leaf(Walk *w, const LeafOut *lf)
{
    const SizeMeas *m = &w->meas[size_slot(lf->size)];
    int N = m->N;
    int cy = 0, cu = 0, cv = 0;
    if (lf->use_cbp && lf->tb) {
        cy = m->cbp_tb_y[lf->k * N + lf->idx] != 0;
        cu = m->cbp_tb_u[lf->k * N + lf->idx] != 0;
        cv = m->cbp_tb_v[lf->k * N + lf->idx] != 0;
    } else if (lf->use_cbp) {
        cy = m->cbp_y[lf->k * N + lf->idx];
        cu = m->cbp_u[lf->k * N + lf->idx];
        cv = m->cbp_v[lf->k * N + lf->idx];
    }
    if (lf->mode == MODE_SKIP || lf->mode == MODE_MERGE) {
        dd_store(&w->dd, lf->ypos, lf->xpos, lf->size, lf->mode,
                 cy, cu, cv, lf->mvx, lf->mvy, lf->mv1x, lf->mv1y,
                 lf->ref, lf->ref1, lf->dir);
    } else if (lf->mode == MODE_INTER) {
        dd_store(&w->dd, lf->ypos, lf->xpos, lf->size, MODE_INTER,
                 cy, cu, cv, lf->mvx, lf->mvy, 0, 0, lf->ref, 0, 0);
    } else if (lf->mode == MODE_BIPRED) {
        dd_store(&w->dd, lf->ypos, lf->xpos, lf->size, MODE_BIPRED,
                 cy, cu, cv, lf->mvx, lf->mvy, lf->mv1x, lf->mv1y,
                 lf->ref, lf->ref1, 2);
    } else {
        dd_store(&w->dd, lf->ypos, lf->xpos, lf->size, MODE_INTRA,
                 1, 1, 1, 0, 0, 0, 0, 0, 0, -1);
    }
}

static int64_t rec(Walk *w, int s, int y0, int x0)
{
    if (y0 >= w->H || x0 >= w->W)
        return 0;
    int full = (y0 + s <= w->H) && (x0 + s <= w->W);
    if (!full) {
        int h = s / 2;
        int64_t cost = 0;
        cost += rec(w, h, y0, x0);
        cost += rec(w, h, y0 + h, x0);
        cost += rec(w, h, y0, x0 + h);
        cost += rec(w, h, y0 + h, x0 + h);
        return cost;
    }
    if (s > MIN_BLOCK_SIZE) {
        int mark = w->n_leaves;
        int h = s / 2;
        int64_t cost_small = 0;
        cost_small += rec(w, h, y0, x0);
        cost_small += rec(w, h, y0 + h, x0);
        cost_small += rec(w, h, y0, x0 + h);
        cost_small += rec(w, h, y0 + h, x0 + h);
        cost_small += (int64_t)(w->lam * 2 + 0.5);
        LeafOut lf;
        int64_t cost_here = leaf_candidates(w, s, y0, x0, &lf);
        if (cost_here <= cost_small) {
            w->n_leaves = mark;      /* rewind the children's leaves */
            store_leaf(w, &lf);
            w->leaves[w->n_leaves++] = lf;
            return cost_here;
        }
        return cost_small;
    }
    LeafOut lf;
    int64_t cost = leaf_candidates(w, s, y0, x0, &lf);
    store_leaf(w, &lf);
    w->leaves[w->n_leaves++] = lf;
    return cost;
}

/* Entry point: meas arrays ordered (size 8, 16, 32, 64).
 * leaves_out must hold (W/8)*(H/8 + 8) entries. Returns leaf count. */
int thor_decide_frame(
    int W, int H, int num_ref, int enable_bipred, int interp_ref,
    int use_block_contexts, int frame_type, double lam, double lam_me,
    const SizeMeas *meas4, LeafOut *leaves_out)
{
    Walk w;
    memset(&w, 0, sizeof(w));
    w.W = W; w.H = H;
    w.num_ref = num_ref;
    w.enable_bipred = enable_bipred;
    w.interp_ref = interp_ref;
    w.frame_type = frame_type;
    w.use_block_contexts = use_block_contexts;
    w.lam = lam; w.lam_me = lam_me;
    for (int i = 0; i < 4; i++)
        w.meas[i] = meas4[i];
    w.tb_cfg = meas4[1].has_tb || meas4[2].has_tb || meas4[3].has_tb;
    int gh = H / MIN_PB_SIZE, gw = W / MIN_PB_SIZE;
    int32_t *cells = (int32_t *)calloc((size_t)gh * gw * 12,
                                       sizeof(int32_t));
    w.dd.mode = cells;
    w.dd.size = cells + (size_t)gh * gw;
    w.dd.cbp_y = cells + (size_t)gh * gw * 2;
    w.dd.cbp_u = cells + (size_t)gh * gw * 3;
    w.dd.cbp_v = cells + (size_t)gh * gw * 4;
    w.dd.mv0x = cells + (size_t)gh * gw * 5;
    w.dd.mv0y = cells + (size_t)gh * gw * 6;
    w.dd.mv1x = cells + (size_t)gh * gw * 7;
    w.dd.mv1y = cells + (size_t)gh * gw * 8;
    w.dd.ref_idx0 = cells + (size_t)gh * gw * 9;
    w.dd.ref_idx1 = cells + (size_t)gh * gw * 10;
    w.dd.bipred_flag = cells + (size_t)gh * gw * 11;
    w.dd.gh = gh; w.dd.gw = gw;
    w.leaves = leaves_out;
    w.n_leaves = 0;

    for (int k = 0; k < H; k += MAX_BLOCK_SIZE)
        for (int l = 0; l < W; l += MAX_BLOCK_SIZE)
            rec(&w, MAX_BLOCK_SIZE, k, l);

    free(cells);
    return w.n_leaves;
}

/* ================================================================== */
/* Syntax emission for the device P-frame path - native twin of
 * device_inter.py's emit loop + enc/syntax.py's writers
 * (enc/write_bits.c:268-650, enc/putbits.c, enc/putvlc.c:34-131).
 * Restricted toolset: PART_NONE, tb_param 0, dqp always 0; modes
 * SKIP/MERGE (uni or bi candidates), INTER, BIPRED, INTRA.           */

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

typedef struct {
    uint8_t *buf;
    size_t nbytes, cap;
    uint32_t bitbuf;
    int bitrest;
} BW;

static void bw_put(BW *w, int n, uint32_t val)
{
    if (n <= w->bitrest) {
        w->bitbuf |= (uint32_t)((uint64_t)(val & ((n == 32 ? 0xFFFFFFFFu
                     : ((1u << n) - 1)))) << (w->bitrest - n));
        w->bitrest -= n;
    } else {
        int rest = n - w->bitrest;
        w->bitbuf |= (val >> rest) & ((w->bitrest == 32 ? 0xFFFFFFFFu
                     : ((1u << w->bitrest) - 1)));
        w->buf[w->nbytes++] = (uint8_t)(w->bitbuf >> 24);
        w->buf[w->nbytes++] = (uint8_t)(w->bitbuf >> 16);
        w->buf[w->nbytes++] = (uint8_t)(w->bitbuf >> 8);
        w->buf[w->nbytes++] = (uint8_t)(w->bitbuf);
        w->bitbuf = (uint32_t)((uint64_t)(val & ((1u << rest) - 1))
                               << (32 - rest));
        w->bitrest = 32 - rest;
    }
}

/* enc/putvlc.c:34-131 (tables used by the device path: 0, 2, 10) */
static void put_vlc_c(int n, int cn, BW *w)
{
    int code, length;
    if (n <= 5) {
        if (cn < 6 * (1 << n)) {
            int tmp = 1 << n;
            code = tmp + (cn & (tmp - 1));
            length = 1 + n + (cn >> n);
        } else {
            code = cn - 6 * (1 << n) + (1 << n);
            length = (6 - n) + 1 + 2 * log2i(code);
        }
    } else if (n == 10) {
        code = cn + 1;
        length = 1 + 2 * log2i(code);
    } else {
        /* unreachable for the device toolset */
        code = 0; length = 0;
    }
    bw_put(w, length, (uint32_t)code);
}

static void write_mv_c(BW *w, int mvx, int mvy, int mvpx, int mvpy)
{
    int d[2] = {mvx - mvpx, mvy - mvpy};
    for (int i = 0; i < 2; i++) {
        int a = d[i] < 0 ? -d[i] : d[i];
        put_vlc_c(10, 2 * a - (d[i] < 0 ? 1 : 0), w);
    }
}

/* enc/write_bits.c:71-108 */
static int find_code(int run, int level, int maxrun, int chroma_flag,
                     int eob)
{
    int maxrun2 = maxrun > 4 ? maxrun : 4;
    int index = run + (level > 1 ? 1 : 0) * (maxrun2 + 1);
    if (chroma_flag) {
        if (eob) return 0;
        if (index <= 4) return index + 1;
        if (index <= maxrun2) return index + 3;
        if (index == maxrun2 + 1) return 6;
        if (index == maxrun2 + 2) return 7;
        return index + 1;
    }
    if (eob) return 2;
    if (index < 2) return index;
    if (index <= 4) return index + 1;
    if (index <= maxrun2) return index + 3;
    if (index == maxrun2 + 1) return 6;
    if (index == maxrun2 + 2) return 7;
    return index + 1;
}

/* enc/write_bits.c:110-253; coeff: qsize x qsize at (ptr, stride) */
static void write_coeff_c(BW *w, const int16_t *coeff, int stride,
                          int size, int type)
{
    int qsize = size < 16 ? size : 16;
    int N = qsize * qsize;
    int chroma_flag = type & 1;
    int intra_flag = (type >> 1) & 1;
    int vlc_adaptive = (intra_flag && !chroma_flag) ? 1 : 0;
    const int *zz = qsize == 4 ? zigzag16
                   : (qsize == 8 ? zigzag64 : zigzag256);
    int32_t scoeff[256];
    memset(scoeff, 0, sizeof(int32_t) * N);
    for (int i = 0; i < qsize; i++)
        for (int j = 0; j < qsize; j++)
            scoeff[zz[i * qsize + j]] = coeff[i * stride + j];

    int pos = N - 1;
    while (scoeff[pos] == 0 && pos > 0) pos--;
    int last_pos = pos;

    pos = 0;
    if (chroma_flag) {
        int a0 = scoeff[0] < 0 ? -scoeff[0] : scoeff[0];
        if (last_pos == 0 && a0 == 1) {
            bw_put(w, 1, 1);
            bw_put(w, 1, scoeff[0] < 0 ? 1 : 0);
            pos = N;
        } else {
            bw_put(w, 1, 0);
        }
    }

    int level_mode = 1, level = 1;
    while (pos <= last_pos) {
        if (level_mode) {
            while (pos <= last_pos && level > 0) {
                int c = scoeff[pos];
                level = c < 0 ? -c : c;
                put_vlc_c(vlc_adaptive, level, w);
                if (level > 0)
                    bw_put(w, 1, c < 0 ? 1 : 0);
                if (chroma_flag == 0)
                    vlc_adaptive = level > 3 ? 1 : 0;
                pos++;
            }
        }
        int maxrun = N - pos - 1;
        int run = 0, c = 0;
        while (c == 0 && pos <= last_pos) {
            c = scoeff[pos];
            if (c == 0) {
                run++;
            } else {
                level = c < 0 ? -c : c;
                int sign = c < 0 ? 1 : 0;
                int cn = find_code(run, level, maxrun, chroma_flag, 0);
                if (chroma_flag && size <= 8) {
                    put_vlc_c(10, cn, w);
                } else {
                    if (cn == 0) bw_put(w, 2, 2);
                    else put_vlc_c(2, cn + 1, w);
                }
                if (level > 1)
                    put_vlc_c(0, 2 * (level - 2) + sign, w);
                else
                    bw_put(w, 1, sign);
                run = 0;
            }
            pos++;
            level_mode = level > 1 ? 1 : 0;
        }
    }

    if (pos < N && level_mode) {
        int c = scoeff[pos];
        level = c < 0 ? -c : c;
        put_vlc_c(vlc_adaptive, level, w);
        if (level > 0)
            bw_put(w, 1, c < 0 ? 1 : 0);
        pos++;
    }
    if (pos < N) {
        int cn = find_code(0, 0, 0, chroma_flag, 1);
        if (chroma_flag && size <= 8) {
            put_vlc_c(0, cn, w);
        } else {
            if (cn == 0) bw_put(w, 2, 2);
            else put_vlc_c(2, cn + 1, w);
        }
    }
}

/* enc/write_bits.c:268-380 (P-frame branch; split or final mode) */
static void write_super_mode_c(BW *w, int size, BlockCtx bc, int num_ref,
                               int enable_bipred, int interp_ref,
                               int mode, int ref_idx0, int split_flag)
{
    if (split_flag) {
        int code = 1;
        if (bc.index == 2 || bc.index > 3)
            code = (code + 3) % 4;
        bw_put(w, code + 1, 1);
        return;
    }
    int bipred_possible = num_ref > 1 && enable_bipred;
    int split_possible = size > MIN_BLOCK_SIZE;
    int maxbit = 2 + num_ref + (split_possible ? 1 : 0)
        + (bipred_possible ? 1 : 0);
    int code;
    if (interp_ref) {
        if (mode == MODE_SKIP) code = 0;
        else if (mode == MODE_MERGE) code = 2;
        else if (mode == MODE_BIPRED) code = 3;
        else if (mode == MODE_INTRA) code = 4;
        else if (mode == MODE_INTER && ref_idx0 > 0) code = 4 + ref_idx0;
        else code = 4 + num_ref;
        if (!bipred_possible && code > 3) code -= 1;
        if (!split_possible && code > 1) code -= 1;
        if ((bc.index == 2 || bc.index > 3) && size > MIN_BLOCK_SIZE) {
            if (code < 3) code = (code + 2) % 3;
        }
    } else {
        if (mode == MODE_SKIP) code = 0;
        else if (mode == MODE_INTER && ref_idx0 == 0) code = 2;
        else if (mode == MODE_MERGE) code = 3;
        else if (mode == MODE_BIPRED) code = 4;
        else if (mode == MODE_INTRA) code = 5;
        else code = 5 + ref_idx0;
        if (!bipred_possible && code > 4) code -= 1;
        if (!split_possible && code > 1) code -= 1;
        if ((bc.index == 2 || bc.index > 3) && size > MIN_BLOCK_SIZE) {
            if (code < 4) code = (code + 3) % 4;
        }
    }
    if (code == maxbit)
        bw_put(w, maxbit, 0);
    else
        bw_put(w, code + 1, 1);
}

/* intra-mode signalling tables (enc/write_bits.c:418-437) */
static const int IM_MAP8[10] = {2, 8, 1, 0, 5, 9, 7, 6, 4, 3};
static const int IM_LEN8[8] = {2, 2, 2, 4, 4, 4, 5, 5};
static const int IM_CODE8[8] = {0, 1, 2, 12, 13, 14, 30, 31};
static const int IM_MAP10[10] = {2, 3, 1, 0, 6, 9, 8, 7, 5, 4};
static const int IM_LEN10[10] = {2, 2, 3, 3, 4, 4, 5, 5, 5, 5};
static const int IM_CODE10[10] = {2, 3, 2, 3, 2, 3, 0, 1, 2, 3};

typedef struct {
    const int16_t *qy, *qu, *qv;   /* [n, ydim, ydim] / [n, cdim, cdim] */
    int32_t ydim, cdim;
} BankC;

typedef struct {
    int32_t W, H, num_ref, enable_bipred, interp_ref, use_block_contexts;
    int32_t num_intra_modes, max_num_tb_part, max_num_pb_part;
    int32_t max_delta_qp, frame_type;
    uint32_t bitbuf;
    int32_t bitrest;
} EmitParams;

/* dd output arrays (each int32 [gh, gw]) in DeblockData field order */
typedef struct {
    int32_t *mode, *size, *tb_split, *pb_part;
    int32_t *cbp_y, *cbp_u, *cbp_v;
    int32_t *mv0x, *mv0y, *mv1x, *mv1y;
    int32_t *ref_idx0, *ref_idx1, *bipred_flag;
} DDOut;

typedef struct {
    EmitParams p;
    BW w;
    DDm dd;
    DDOut *ddo;
    const LeafOut *leaves;
    const int32_t *bank_row, *cbp3;
    int n_leaves;
    const BankC *banks;   /* 4 coded (8..64) + 1 intra */
    /* position -> leaf lookup over the 8-grid */
    int32_t *leaf_at;     /* [(H/8)*(W/8)] leaf index of the leaf whose
                             origin covers this 8-cell, else -1 */
} Emit;

static void ddo_store(Emit *e, int ypos, int xpos, int size, int mode,
                      int cy, int cu, int cv, int32_t mv0x, int32_t mv0y,
                      int32_t mv1x, int32_t mv1y, int ref0, int ref1,
                      int dirf, int tb)
{
    /* mirror both the walk's scratch map (for candidate derivation)
       and the caller's DeblockData arrays (store_deblock_data) */
    dd_store(&e->dd, ypos, xpos, size, mode, cy, cu, cv, mv0x, mv0y,
             mv1x, mv1y, ref0, ref1, dirf);
    DDOut *o = e->ddo;
    int gw = e->dd.gw;
    int by = ypos / MIN_PB_SIZE, bx = xpos / MIN_PB_SIZE;
    int n = size / MIN_PB_SIZE;
    for (int m = 0; m < n; m++) {
        int f = (by + m) * gw + bx;
        for (int q = 0; q < n; q++, f++) {
            o->mode[f] = mode;
            o->size[f] = size;
            o->tb_split[f] = tb ? 1 : 0;
            o->pb_part[f] = 0;
            o->cbp_y[f] = cy;
            o->cbp_u[f] = cu;
            o->cbp_v[f] = cv;
            o->mv0x[f] = mv0x;
            o->mv0y[f] = mv0y;
            o->mv1x[f] = mv1x;
            o->mv1y[f] = mv1y;
            o->ref_idx0[f] = ref0;
            o->ref_idx1[f] = ref1;
            o->bipred_flag[f] = dirf;
        }
    }
}

static void emit_cbp_and_coeffs(Emit *e, const LeafOut *lf, int cy,
                                int cu, int cv, int merge, BlockCtx bc,
                                const BankC *bank, int row, int intra,
                                int tb)
{
    /* merge: 0 normal, 1 MERGE (tb1 + merge cbp remap),
       2 BIPRED (tb1, normal cbp remap).
       tb: INTER tb_split payload - cy/cu/cv are 4-bit quadrant masks
       (bit 3-k) and the bank row holds the quadrant-layout coeffs
       (enc/write_bits.c size > 8 tb branch). */
    BW *w = &e->w;
    int size = lf->size;
    int coeff_type = (intra ? 1 : 0) << 1;
    int max_tb;
    if (merge) max_tb = 1;
    else if (!intra) max_tb = e->p.max_num_tb_part > 1 ? 2 : 1;
    else max_tb = e->p.max_num_tb_part;

    if (tb) {
        const int16_t *qy = bank->qy
            + (size_t)row * bank->ydim * bank->ydim;
        const int16_t *qu = bank->qu
            + (size_t)row * bank->cdim * bank->cdim;
        const int16_t *qv = bank->qv
            + (size_t)row * bank->cdim * bank->cdim;
        int s2 = size / 2, s4 = size / 4;
        put_vlc_c(0, 2, w);            /* tb_split escape */
        for (int k = 0; k < 4; k++) {
            int sh = 3 - k;
            int qi = (k >> 1) & 1, qj = k & 1;
            int ccy = (cy >> sh) & 1, ccu = (cu >> sh) & 1,
                ccv = (cv >> sh) & 1;
            int code = CBP_TABLE[ccy + 2 * ccu + 4 * ccv];
            if (bc.cbp == 0 && code < 2) code = 1 - code;
            put_vlc_c(0, code, w);
            if (ccy)
                write_coeff_c(w, qy + (size_t)(qi * s2) * bank->ydim
                              + qj * s2, bank->ydim, s2,
                              coeff_type | 0);
            if (ccu)
                write_coeff_c(w, qu + (size_t)(qi * s4) * bank->cdim
                              + qj * s4, bank->cdim, s4,
                              coeff_type | 1);
            if (ccv)
                write_coeff_c(w, qv + (size_t)(qi * s4) * bank->cdim
                              + qj * s4, bank->cdim, s4,
                              coeff_type | 1);
        }
        return;
    }

    int cbp = cy + (cu << 1) + (cv << 2);
    int code = CBP_TABLE[cbp];
    if (max_tb > 1) {
        if (bc.cbp == 0 && code < 2) code = 1 - code;
        if (code > 1) code += 1;
    } else if (merge == 1) {
        if (code == 1) code = 7;
        else if (code > 1) code = code - 1;
    } else {
        if (bc.cbp == 0 && code < 2) code = 1 - code;
    }
    put_vlc_c(0, code, w);

    if (cy)
        write_coeff_c(w, bank->qy + (size_t)row * bank->ydim * bank->ydim,
                      bank->ydim, size, coeff_type | 0);
    if (cu)
        write_coeff_c(w, bank->qu + (size_t)row * bank->cdim * bank->cdim,
                      bank->cdim, size / 2, coeff_type | 1);
    if (cv)
        write_coeff_c(w, bank->qv + (size_t)row * bank->cdim * bank->cdim,
                      bank->cdim, size / 2, coeff_type | 1);
}

static void emit_rec(Emit *e, int s, int y0, int x0)
{
    const EmitParams *p = &e->p;
    if (y0 >= p->H || x0 >= p->W)
        return;
    int full = (y0 + s <= p->H) && (x0 + s <= p->W);
    int g8w = p->W / 8;
    int li = -1;
    if (full && (y0 / 8) * g8w + (x0 / 8) >= 0) {
        int cand = e->leaf_at[(y0 / 8) * g8w + (x0 / 8)];
        if (cand >= 0 && e->leaves[cand].ypos == y0
            && e->leaves[cand].xpos == x0 && e->leaves[cand].size == s)
            li = cand;
    }
    BlockCtx bc = find_block_contexts(y0, x0, p->H, p->W, s, &e->dd,
                                      p->use_block_contexts);
    if (li < 0) {
        int h = s / 2;
        if (full)
            write_super_mode_c(&e->w, s, bc, p->num_ref,
                               p->enable_bipred, p->interp_ref,
                               MODE_SKIP, 0, 1);
        else
            bw_put(&e->w, 1, 0);
        if (s == MAX_BLOCK_SIZE && p->max_delta_qp)
            put_vlc_c(0, 0, &e->w);   /* split 64-SB: dqp = 0 */
        emit_rec(e, h, y0, x0);
        emit_rec(e, h, y0 + h, x0);
        emit_rec(e, h, y0, x0 + h);
        emit_rec(e, h, y0 + h, x0 + h);
        return;
    }
    const LeafOut *lf = &e->leaves[li];
    InterPredC cands[2];
    int nvec = get_mv_skip_merge(y0, x0, p->W, p->H, s, &e->dd, cands);
    int32_t mvpx, mvpy;
    get_mv_pred(y0, x0, p->W, p->H, s, &e->dd, &mvpx, &mvpy);

    write_super_mode_c(&e->w, s, bc, p->num_ref, p->enable_bipred,
                       p->interp_ref, lf->mode, lf->ref, 0);
    if (s == MAX_BLOCK_SIZE && lf->mode != MODE_SKIP && p->max_delta_qp)
        put_vlc_c(0, 0, &e->w);       /* unsplit 64 leaf: dqp = 0 */

    int tb = lf->tb;
    int cy, cu, cv;
    if (tb) {
        /* tb leaf: cbp3 packs the three 4-bit quadrant masks */
        cy = e->cbp3[li] & 15;
        cu = (e->cbp3[li] >> 4) & 15;
        cv = (e->cbp3[li] >> 8) & 15;
    } else {
        cy = (e->cbp3[li] >> 0) & 1;
        cu = (e->cbp3[li] >> 1) & 1;
        cv = (e->cbp3[li] >> 2) & 1;
    }
    int row = e->bank_row[li];

    if (lf->mode == MODE_INTRA) {
        int n = p->num_intra_modes;
        if (n <= 4) {
            bw_put(&e->w, 2, lf->intra_mode);
        } else if (n <= 8) {
            int code = IM_MAP8[lf->intra_mode];
            bw_put(&e->w, IM_LEN8[code], IM_CODE8[code]);
        } else {
            int code = IM_MAP10[lf->intra_mode];
            bw_put(&e->w, IM_LEN10[code], IM_CODE10[code]);
        }
        emit_cbp_and_coeffs(e, lf, cy, cu, cv, 0, bc, &e->banks[4],
                            row, 1, 0);
        ddo_store(e, y0, x0, s, MODE_INTRA, cy, cu, cv,
                  0, 0, 0, 0, 0, 0, -1, 0);
        return;
    }

    if (lf->mode == MODE_SKIP || lf->mode == MODE_MERGE) {
        InterPredC *c = &cands[lf->skip_idx];
        /* skip/merge index bits */
        if (nvec == 4) {
            bw_put(&e->w, 2, lf->skip_idx);
        } else if (nvec == 3) {
            if (lf->skip_idx == 0) bw_put(&e->w, 1, 1);
            else if (lf->skip_idx == 1) bw_put(&e->w, 2, 0);
            else bw_put(&e->w, 2, 1);
        } else if (nvec == 2) {
            bw_put(&e->w, 1, lf->skip_idx);
        }
        if (lf->mode == MODE_MERGE)
            emit_cbp_and_coeffs(e, lf, cy, cu, cv, 1, bc,
                                &e->banks[size_slot(s)], row, 0, 0);
        ddo_store(e, y0, x0, s, lf->mode, lf->use_cbp ? cy : 0,
                  lf->use_cbp ? cu : 0, lf->use_cbp ? cv : 0,
                  c->mv0x, c->mv0y, c->mv1x, c->mv1y,
                  c->ref_idx0, c->ref_idx1, c->bipred_flag, 0);
        return;
    }

    if (lf->mode == MODE_BIPRED) {
        /* BIPRED_PART=0: no pb-part signal; mv1 is predicted from mv0
           on B frames, from mvp on P frames which also code the ref
           pair (enc/write_bits.c:452-476) */
        write_mv_c(&e->w, lf->mvx, lf->mvy, mvpx, mvpy);
        if (p->frame_type == 2)
            write_mv_c(&e->w, lf->mv1x, lf->mv1y, lf->mvx, lf->mvy);
        else
            write_mv_c(&e->w, lf->mv1x, lf->mv1y, mvpx, mvpy);
        if (p->frame_type == 1) {
            if (p->num_ref == 2) {
                int code = 2 * lf->ref + lf->ref1;
                if (code == 3) bw_put(&e->w, 3, 0);
                else bw_put(&e->w, code + 1, 1);
            } else {
                put_vlc_c(10, 4 * lf->ref + lf->ref1, &e->w);
            }
        }
        if (lf->use_cbp)
            emit_cbp_and_coeffs(e, lf, cy, cu, cv, 2, bc,
                                &e->banks[size_slot(s)], row, 0, 0);
        else
            emit_cbp_and_coeffs(e, lf, 0, 0, 0, 2, bc,
                                &e->banks[size_slot(s)], row, 0, 0);
        ddo_store(e, y0, x0, s, MODE_BIPRED, lf->use_cbp ? cy : 0,
                  lf->use_cbp ? cu : 0, lf->use_cbp ? cv : 0,
                  lf->mvx, lf->mvy, lf->mv1x, lf->mv1y,
                  lf->ref, lf->ref1, 2, 0);
        return;
    }

    /* MODE_INTER, PART_NONE */
    if (p->max_num_pb_part > 1)
        bw_put(&e->w, 1, 1);     /* pb_part = PART_NONE */
    write_mv_c(&e->w, lf->mvx, lf->mvy, mvpx, mvpy);
    if (lf->use_cbp)
        emit_cbp_and_coeffs(e, lf, cy, cu, cv, 0, bc,
                            &e->banks[size_slot(s)], row, 0, tb);
    else
        emit_cbp_and_coeffs(e, lf, 0, 0, 0, 0, bc,
                            &e->banks[size_slot(s)], row, 0, 0);
    ddo_store(e, y0, x0, s, MODE_INTER, lf->use_cbp ? (cy != 0) : 0,
              lf->use_cbp ? (cu != 0) : 0, lf->use_cbp ? (cv != 0) : 0,
              lf->mvx, lf->mvy, 0, 0, lf->ref, 0, 0, tb);
}

/* Entry: emits the SB payload for the decided frame. Returns the
 * number of whole bytes appended to out_bytes; the trailing partial
 * bit state is returned through params->bitbuf/bitrest. */
long thor_emit_frame(EmitParams *params, const LeafOut *leaves,
                     int n_leaves, const int32_t *bank_row,
                     const int32_t *cbp3, const BankC *banks,
                     DDOut *ddo, uint8_t *out_bytes, long cap)
{
    Emit e;
    memset(&e, 0, sizeof(e));
    e.p = *params;
    e.w.buf = out_bytes;
    e.w.cap = (size_t)cap;
    e.w.bitbuf = params->bitbuf;
    e.w.bitrest = params->bitrest;
    e.leaves = leaves;
    e.n_leaves = n_leaves;
    e.bank_row = bank_row;
    e.cbp3 = cbp3;
    e.banks = banks;
    e.ddo = ddo;

    int gh = e.p.H / MIN_PB_SIZE, gw = e.p.W / MIN_PB_SIZE;
    int32_t *cells = (int32_t *)calloc((size_t)gh * gw * 12,
                                       sizeof(int32_t));
    e.dd.mode = cells;
    e.dd.size = cells + (size_t)gh * gw;
    e.dd.cbp_y = cells + (size_t)gh * gw * 2;
    e.dd.cbp_u = cells + (size_t)gh * gw * 3;
    e.dd.cbp_v = cells + (size_t)gh * gw * 4;
    e.dd.mv0x = cells + (size_t)gh * gw * 5;
    e.dd.mv0y = cells + (size_t)gh * gw * 6;
    e.dd.mv1x = cells + (size_t)gh * gw * 7;
    e.dd.mv1y = cells + (size_t)gh * gw * 8;
    e.dd.ref_idx0 = cells + (size_t)gh * gw * 9;
    e.dd.ref_idx1 = cells + (size_t)gh * gw * 10;
    e.dd.bipred_flag = cells + (size_t)gh * gw * 11;
    e.dd.gh = gh; e.dd.gw = gw;

    int g8h = e.p.H / 8, g8w = e.p.W / 8;
    e.leaf_at = (int32_t *)malloc((size_t)g8h * g8w * sizeof(int32_t));
    for (int i = 0; i < g8h * g8w; i++)
        e.leaf_at[i] = -1;
    for (int i = 0; i < n_leaves; i++)
        e.leaf_at[(leaves[i].ypos / 8) * g8w + (leaves[i].xpos / 8)] = i;

    for (int k = 0; k < e.p.H; k += MAX_BLOCK_SIZE)
        for (int l = 0; l < e.p.W; l += MAX_BLOCK_SIZE)
            emit_rec(&e, MAX_BLOCK_SIZE, k, l);

    params->bitbuf = e.w.bitbuf;
    params->bitrest = e.w.bitrest;
    free(cells);
    free(e.leaf_at);
    return (long)e.w.nbytes;
}
