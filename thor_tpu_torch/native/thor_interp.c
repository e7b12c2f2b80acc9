/* Temporal frame interpolation - native twin of ops/temporal_interp.py
 * (behavioral reference: common/temporal_interp.c:972-1053).
 *
 * The per-block bidirectional ME has a raster dependency through the
 * skip/merge candidate vectors, so the whole pyramid runs serially on
 * the host; this C version replaces the Python implementation on the
 * hot path (~100x) while the Python stays as the parity oracle.
 *
 * Inputs are the codec's padded planes (PAD_Y=96 / PAD_C=48 for level
 * 0), outputs are unpadded planes. All arithmetic is integer-exact.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>

#define BLOCK_STEP 16
#define MAX_CANDS 20
#define COST_MAX 0x3FFFFFFF
#define TI_LAMBDA ((3000 * BLOCK_STEP) / 16)
#define LAMBDA_SHIFT 4
#define SKIP_THRESHOLD 8
#define ACC_BITS 3
#define ACC_ROUND (1 << (ACC_BITS - 1))
#define TI_MAX_LEVELS 4

typedef struct { int32_t x, y; } MV;

typedef struct {
    uint8_t *y;            /* padded plane, stride = width + 2*pad */
    int pad, width, height;
    const uint8_t *u, *v;  /* level 0 only */
    int pad_c;
    int owns;
} Level;

typedef struct {
    int step, bw, bh, bbs, bs;
    int skip_thr;
    MV skip_mv, scaled_skip_mv;
    MV *mv0, *mv1;
    uint8_t *bgmap;
    int ratio, reversed, wt0, wt1, pos;
} MvData;

static inline const uint8_t *lvl_at(const Level *l, int r, int c)
{
    int stride = l->width + 2 * l->pad;
    return l->y + (l->pad + r) * stride + (l->pad + c);
}

static int32_t scale_val(int64_t v, int64_t numer, int64_t denom)
{
    if (denom == 0) return 0;
    int64_t prod = v * numer;
    if (denom < 0) { denom = -denom; prod = -prod; }
    if (prod >= 0) return (int32_t)((prod + denom / 2) / denom);
    return (int32_t)(-((-prod + denom / 2) / denom));
}

static MV scale_mv(MV mv, int numer, int denom)
{
    if (numer == denom) return mv;
    if (numer == -denom) { MV r = {-mv.x, -mv.y}; return r; }
    MV r = {scale_val(mv.x, numer, denom), scale_val(mv.y, numer, denom)};
    return r;
}

/* scale_frame_down2x2: (a+b+1)>>1 vertically then (c+d)>>1, edge pad */
static Level downscale2x2(const Level *in, int pad)
{
    int w = in->width >> 1, h = in->height >> 1;
    int stride = w + 2 * pad;
    Level out;
    out.y = (uint8_t *)malloc((size_t)stride * (h + 2 * pad));
    out.pad = pad; out.width = w; out.height = h;
    out.u = out.v = NULL; out.pad_c = 0; out.owns = 1;
    int istride = in->width + 2 * in->pad;
    for (int r = 0; r < h; r++) {
        const uint8_t *s0 = lvl_at(in, 2 * r, 0);
        const uint8_t *s1 = s0 + istride;
        uint8_t *d = out.y + (pad + r) * stride + pad;
        for (int c = 0; c < w; c++) {
            int col0 = (s0[2 * c] + s1[2 * c] + 1) >> 1;
            int col1 = (s0[2 * c + 1] + s1[2 * c + 1] + 1) >> 1;
            d[c] = (uint8_t)((col0 + col1) >> 1);
        }
    }
    /* edge-replication padding */
    for (int r = 0; r < h; r++) {
        uint8_t *row = out.y + (pad + r) * stride;
        memset(row, row[pad], pad);
        memset(row + pad + w, row[pad + w - 1], pad);
    }
    for (int r = 0; r < pad; r++) {
        memcpy(out.y + r * stride, out.y + pad * stride, stride);
        memcpy(out.y + (pad + h + r) * stride,
               out.y + (pad + h - 1) * stride, stride);
    }
    return out;
}

static MV mv_absdist_filter(const MV *lst, int n)
{
    int best_idx = 0;
    int64_t best_cost = COST_MAX;
    for (int j = 0; j < n; j++) {
        int64_t cost = 0;
        for (int i = 0; i < n; i++)
            cost += labs((long)lst[i].x - lst[j].x)
                + labs((long)lst[i].y - lst[j].y);
        if (cost <= best_cost) { best_idx = j; best_cost = cost; }
    }
    return lst[best_idx];
}

static int64_t ti_sad(const Level *p0, const Level *p1, int xs0, int ys0,
                      int xs1, int ys1, int size)
{
    int pad = p0->pad;
    int wP = p0->width + pad, hP = p0->height + pad;
    int stride0 = p0->width + 2 * p0->pad;
    int stride1 = p1->width + 2 * p1->pad;
    int64_t s = 0;
    if (xs0 >= -pad && xs0 + size <= wP && ys0 >= -pad && ys0 + size <= hP
        && xs1 >= -pad && xs1 + size <= wP && ys1 >= -pad
        && ys1 + size <= hP) {
        const uint8_t *a = lvl_at(p0, ys0, xs0);
        const uint8_t *b = lvl_at(p1, ys1, xs1);
        for (int r = 0; r < size; r++) {
            for (int c = 0; c < size; c++)
                s += abs((int)a[c] - (int)b[c]);
            a += stride0;
            b += stride1;
        }
        return s;
    }
    for (int r = 0; r < size; r++) {
        int y0 = r + ys0, y1 = r + ys1;
        y0 = y0 < -pad ? -pad : (y0 > hP - 1 ? hP - 1 : y0);
        y1 = y1 < -pad ? -pad : (y1 > hP - 1 ? hP - 1 : y1);
        for (int c = 0; c < size; c++) {
            int x0 = c + xs0, x1 = c + xs1;
            x0 = x0 < -pad ? -pad : (x0 > wP - 1 ? wP - 1 : x0);
            x1 = x1 < -pad ? -pad : (x1 > wP - 1 ? wP - 1 : x1);
            s += abs((int)*lvl_at(p0, y0, x0) - (int)*lvl_at(p1, y1, x1));
        }
    }
    return s;
}

static int64_t sad_cost(int xstart, int ystart, const Level *p0,
                        const Level *p1, MV mv0, MV mv1, int size,
                        int64_t cost_start)
{
    int xs0 = xstart + ((mv0.x + ACC_ROUND) >> ACC_BITS);
    int xs1 = xstart + ((mv1.x + ACC_ROUND) >> ACC_BITS);
    int ys0 = ystart + ((mv0.y + ACC_ROUND) >> ACC_BITS);
    int ys1 = ystart + ((mv1.y + ACC_ROUND) >> ACC_BITS);
    return cost_start + ti_sad(p0, p1, xs0, ys0, xs1, ys1, size);
}

static int64_t get_mv_cost(MV mv, const MvData *md, int xp, int yp,
                           int xs, int ys, int lam)
{
    int bw = md->bw;
    const MV *arr = md->mv1;
    int64_t diff = 0;
    if (xp == 0 && yp == 0) {
        diff = 0;
    } else if (yp > 0 && xp > 0 && xp < bw - xs) {
        int ps[4] = {(yp - ys) * bw + xp + xs, (yp - ys) * bw + xp,
                     (yp - ys) * bw + xp - xs, yp * bw + xp - xs};
        for (int i = 0; i < 4; i++)
            diff += abs(mv.x - arr[ps[i]].x) + abs(mv.y - arr[ps[i]].y);
    } else if (yp == 0) {
        int p = xp - xs;
        diff = abs(mv.x - arr[p].x) + abs(mv.y - arr[p].y);
    } else if (xp == 0) {
        int ps[2] = {(yp - ys) * bw + xp + xs, (yp - ys) * bw + xp};
        for (int i = 0; i < 2; i++)
            diff += abs(mv.x - arr[ps[i]].x) + abs(mv.y - arr[ps[i]].y);
    }
    return (diff * lam) >> (LAMBDA_SHIFT + ACC_BITS);
}

static void add_cand(MV *lst, int *n, int max_c, MV cand)
{
    if (*n >= max_c) return;
    for (int i = 0; i < *n; i++)
        if (lst[i].x == cand.x && lst[i].y == cand.y) return;
    lst[(*n)++] = cand;
}

static int get_cands(const MvData *md, const MvData *guide, MV *lst,
                     int xp, int yp, int xstep, int ystep)
{
    int n = 0;
    int pos = yp * md->bw + xp;
    MV zero = {0, 0};
    add_cand(lst, &n, MAX_CANDS, zero);
    if (guide) {
        int numer = md->reversed == guide->reversed ? md->wt0 : -md->wt0;
        add_cand(lst, &n, MAX_CANDS,
                 scale_mv(guide->mv1[pos], numer, guide->wt0));
    }
    if (yp > 0 && xp < md->bw - xstep)
        add_cand(lst, &n, MAX_CANDS,
                 md->mv1[(yp - ystep) * md->bw + xp + xstep]);
    if (xp > 0)
        add_cand(lst, &n, MAX_CANDS, md->mv1[yp * md->bw + xp - xstep]);
    if (yp > 0)
        add_cand(lst, &n, MAX_CANDS, md->mv1[(yp - ystep) * md->bw + xp]);
    return n;
}

static int get_merge_cands(const MvData *md, MV *lst, int xp, int yp)
{
    int n = 0;
    int yoff = (yp & 1) ? 2 : 1;
    int xoff = yoff;   /* sic: the reference keys xoff on yp too */
    add_cand(lst, &n, MAX_CANDS, md->mv1[yp * md->bw + xp]);
    if (yp - yoff >= 0)
        add_cand(lst, &n, MAX_CANDS, md->mv1[(yp - yoff) * md->bw + xp]);
    if (yp + yoff < md->bh)
        add_cand(lst, &n, MAX_CANDS, md->mv1[(yp + yoff) * md->bw + xp]);
    if (xp - xoff >= 0)
        add_cand(lst, &n, MAX_CANDS, md->mv1[yp * md->bw + xp - xoff]);
    if (xp + xoff < md->bw)
        add_cand(lst, &n, MAX_CANDS, md->mv1[yp * md->bw + xp + xoff]);
    return n;
}

static void make_skip_vector(MvData *md, int xp, int yp, int xstep,
                             int ystep)
{
    int bw = md->bw;
    MV vlist[3];
    int n = 0;
    if (yp > 0 && xp < bw - xstep)
        vlist[n++] = md->mv1[(yp - ystep) * bw + xp + xstep];
    if (xp > 0)
        vlist[n++] = md->mv1[yp * bw + xp - xstep];
    if (yp > 0)
        vlist[n++] = md->mv1[(yp - ystep) * bw + xp];
    MV zero = {0, 0};
    md->skip_mv = n ? mv_absdist_filter(vlist, n) : zero;
    md->scaled_skip_mv = scale_mv(md->skip_mv, -md->wt1, md->wt0);
}

static void skip_test(MvData *md, const Level *p0, const Level *p1,
                      int xp, int yp)
{
    int xstart = xp * md->bs, ystart = yp * md->bs;
    MV mv1 = md->skip_mv, mv0 = md->scaled_skip_mv;
    int pos = yp * md->bw + xp;
    int size = md->bbs;
    int64_t thr = (int64_t)md->skip_thr * 8 * 8;
    int pad = p0->pad;
    int hP = p0->height + pad, wP = p0->width + pad;
    int skip = 1;
    for (int p = ystart; skip && p < ystart + size; p += 8) {
        for (int q = xstart; q < xstart + size; q += 8) {
            int xs0 = q + ((mv0.x + ACC_ROUND) >> ACC_BITS);
            int xs1 = q + ((mv1.x + ACC_ROUND) >> ACC_BITS);
            int ys0 = p + ((mv0.y + ACC_ROUND) >> ACC_BITS);
            int ys1 = p + ((mv1.y + ACC_ROUND) >> ACC_BITS);
            if (xs0 >= -pad && xs0 + 8 <= wP && ys0 >= -pad
                && ys0 + 8 <= hP && xs1 >= -pad && xs1 + 8 <= wP
                && ys1 >= -pad && ys1 + 8 <= hP) {
                if (ti_sad(p0, p1, xs0, ys0, xs1, ys1, 8) > thr) {
                    skip = 0;
                    break;
                }
            } else {
                skip = 0;
                break;
            }
        }
    }
    if (skip) {
        md->bgmap[pos] = 1;
        md->mv1[pos] = md->skip_mv;
        md->mv0[pos] = md->scaled_skip_mv;
    }
    int bw = md->bw;
    int offs[3] = {1, bw, bw + 1};
    for (int i = 0; i < 3; i++) {
        md->mv0[pos + offs[i]] = md->mv0[pos];
        md->mv1[pos + offs[i]] = md->mv1[pos];
        md->bgmap[pos + offs[i]] = md->bgmap[pos];
    }
}

static void adaptive_search(MvData *md, int guided, const MV *cands,
                            int ncands, const Level *p0, const Level *p1,
                            int xp, int yp, int xstep, int ystep)
{
    int xstart = xp * md->bs, ystart = yp * md->bs;
    int size = md->bbs;
    MV best_mv = cands[0];
    MV best_scaled = scale_mv(best_mv, -md->wt1, md->wt0);
    int64_t best_cost = COST_MAX;
    int lam = guided ? TI_LAMBDA / 4 : TI_LAMBDA;

    for (int c = 0; c < ncands; c++) {
        MV mv1 = cands[c];
        MV mv0 = scale_mv(mv1, -md->wt1, md->wt0);
        int64_t cost = get_mv_cost(mv1, md, xp, yp, xstep, ystep, lam);
        cost = sad_cost(xstart, ystart, p0, p1, mv0, mv1, size, cost);
        MV ref_mv = mv1, ref_scaled = mv0;

        if (((4 + c) * cost) / 8 < best_cost) {
            int shift = (guided ? 0 : 3) + ACC_BITS;
            int count = guided ? 8 : 64;
            while (shift >= ACC_BITS && count > 0) {
                int off = 1 << shift;
                int better = 0;
                MV trials[4] = {
                    {ref_mv.x - off, ref_mv.y}, {ref_mv.x + off, ref_mv.y},
                    {ref_mv.x, ref_mv.y - off}, {ref_mv.x, ref_mv.y + off}};
                for (int t = 0; t < 4; t++) {
                    MV m0 = scale_mv(trials[t], -md->wt1, md->wt0);
                    int64_t bcost = get_mv_cost(trials[t], md, xp, yp,
                                                xstep, ystep, lam);
                    bcost = sad_cost(xstart, ystart, p0, p1, m0,
                                     trials[t], size, bcost);
                    if (bcost < cost) {
                        cost = bcost;
                        ref_mv = trials[t];
                        ref_scaled = m0;
                        better = 1;
                    }
                }
                if (!better) shift -= 1;
                count -= 4;
            }
        }
        if (cost < best_cost) {
            best_mv = ref_mv;
            best_scaled = ref_scaled;
            best_cost = cost;
        }
    }
    int pos = yp * md->bw + xp;
    md->mv1[pos] = best_mv;
    md->mv0[pos] = best_scaled;
}

static void motion_estimate_bi(MvData *md, const MvData *guide,
                               const Level *in0, const Level *in1)
{
    int bw = md->bw, bh = md->bh, step = md->step;
    if (!guide) {
        memset(md->mv0, 0, sizeof(MV) * bw * bh);
        memset(md->mv1, 0, sizeof(MV) * bw * bh);
    }
    memset(md->bgmap, 0, (size_t)bw * bh);

    const Level *p0 = md->reversed ? in1 : in0;
    const Level *p1 = md->reversed ? in0 : in1;

    for (int i = 0; i < bh; i += step) {
        for (int j = 0; j < bw; j += step) {
            make_skip_vector(md, j, i, step, step);
            skip_test(md, p0, p1, j, i);
            int pos = i * bw + j;
            if (md->bgmap[pos] == 0) {
                MV cands[MAX_CANDS];
                int n = get_cands(md, guide, cands, j, i, step, step);
                adaptive_search(md, guide != NULL, cands, n, p0, p1,
                                j, i, step, step);
            }
            MV mv0 = md->mv0[pos], mv1 = md->mv1[pos];
            uint8_t bg = md->bgmap[pos];
            for (int q = 0; q < step; q++)
                for (int p = 0; p < step; p++) {
                    md->mv0[pos + q * bw + p] = mv0;
                    md->mv1[pos + q * bw + p] = mv1;
                    md->bgmap[pos + q * bw + p] = bg;
                }
        }
    }

    /* merge smoothing pass on 8x8 cells */
    MV *nmv0 = (MV *)malloc(sizeof(MV) * bw * bh);
    MV *nmv1 = (MV *)malloc(sizeof(MV) * bw * bh);
    memcpy(nmv0, md->mv0, sizeof(MV) * bw * bh);
    memcpy(nmv1, md->mv1, sizeof(MV) * bw * bh);
    for (int i = 0; i < bh; i++) {
        for (int j = 0; j < bw; j++) {
            MV cands[MAX_CANDS];
            int n = get_merge_cands(md, cands, j, i);
            if (n > 1) {
                int64_t best_cost = COST_MAX;
                MV best_mv = {0, 0}, best_scaled = {0, 0};
                for (int c = 0; c < n; c++) {
                    MV m0 = scale_mv(cands[c], -md->wt1, md->wt0);
                    int64_t cc = sad_cost(j * md->bs, i * md->bs, p0, p1,
                                          m0, cands[c], md->bs, 0);
                    if (cc < best_cost) {
                        best_cost = cc;
                        best_mv = cands[c];
                        best_scaled = m0;
                    }
                }
                nmv1[i * bw + j] = best_mv;
                nmv0[i * bw + j] = best_scaled;
            }
        }
    }
    free(md->mv0);
    free(md->mv1);
    md->mv0 = nmv0;
    md->mv1 = nmv1;
}

static void upscale_mv(const MvData *in, MvData *out)
{
    int bwo = out->bw, bho = out->bh, bwi = in->bw;
    for (int i = 0; i < bho; i++)
        for (int j = 0; j < bwo; j++) {
            int po = i * bwo + j;
            int pi = (i / 2) * bwi + (j / 2);
            MV mv1 = {in->mv1[pi].x * 2, in->mv1[pi].y * 2};
            out->mv1[po] = mv1;
            out->mv0[po] = scale_mv(mv1, -out->wt1, out->wt0);
        }
}

/* r0/r1: padded source planes (spad); out: padded dest plane (opad) */
static void mot_comp_avg(int xstart, int ystart, const uint8_t *r0,
                         int s0pad, int s0w, const uint8_t *r1, int s1pad,
                         int s1w, uint8_t *out, int opad, int ow, MV mv0,
                         MV mv1, int wP, int hP, int pad, int size)
{
    int xs0 = xstart + ((mv0.x + ACC_ROUND) >> ACC_BITS);
    int xs1 = xstart + ((mv1.x + ACC_ROUND) >> ACC_BITS);
    int ys0 = ystart + ((mv0.y + ACC_ROUND) >> ACC_BITS);
    int ys1 = ystart + ((mv1.y + ACC_ROUND) >> ACC_BITS);
    int s0stride = s0w + 2 * s0pad;
    int s1stride = s1w + 2 * s1pad;
    int ostride = ow + 2 * opad;

    int in0 = (xs0 >= -pad && xs0 + size <= wP && ys0 >= -pad
               && ys0 + size <= hP);
    int in1 = (xs1 >= -pad && xs1 + size <= wP && ys1 >= -pad
               && ys1 + size <= hP);

    uint8_t *dst = out + (opad + ystart) * ostride + opad + xstart;
    if (in0 && in1) {
        const uint8_t *a = r0 + (s0pad + ys0) * s0stride + s0pad + xs0;
        const uint8_t *b = r1 + (s1pad + ys1) * s1stride + s1pad + xs1;
        for (int r = 0; r < size; r++) {
            for (int c = 0; c < size; c++)
                dst[c] = (uint8_t)((a[c] + b[c] + 1) >> 1);
            a += s0stride; b += s1stride; dst += ostride;
        }
    } else if (in1) {
        const uint8_t *b = r1 + (s1pad + ys1) * s1stride + s1pad + xs1;
        for (int r = 0; r < size; r++) {
            memcpy(dst, b, size);
            b += s1stride; dst += ostride;
        }
    } else if (in0) {
        const uint8_t *a = r0 + (s0pad + ys0) * s0stride + s0pad + xs0;
        for (int r = 0; r < size; r++) {
            memcpy(dst, a, size);
            a += s0stride; dst += ostride;
        }
    } else {
        for (int r = 0; r < size; r++) {
            int y0 = r + ys0, y1 = r + ys1;
            y0 = y0 < -pad ? -pad : (y0 > hP - 1 ? hP - 1 : y0);
            y1 = y1 < -pad ? -pad : (y1 > hP - 1 ? hP - 1 : y1);
            for (int c = 0; c < size; c++) {
                int x0 = c + xs0, x1 = c + xs1;
                x0 = x0 < -pad ? -pad : (x0 > wP - 1 ? wP - 1 : x0);
                x1 = x1 < -pad ? -pad : (x1 > wP - 1 ? wP - 1 : x1);
                int a = r0[(s0pad + y0) * s0stride + s0pad + x0];
                int b = r1[(s1pad + y1) * s1stride + s1pad + x1];
                dst[c] = (uint8_t)((a + b + 1) >> 1);
            }
            dst += ostride;
        }
    }
}

static void md_init(MvData *md, int w, int h, int bs, int bbs, int ratio,
                    int k)
{
    md->step = bbs / bs;
    md->bw = md->step * ((w + bbs - 1) / bbs);
    md->bh = md->step * ((h + bbs - 1) / bbs);
    md->bbs = bbs;
    md->bs = bs;
    md->skip_thr = SKIP_THRESHOLD;
    md->skip_mv.x = md->skip_mv.y = 0;
    md->scaled_skip_mv.x = md->scaled_skip_mv.y = 0;
    md->mv0 = (MV *)calloc((size_t)md->bw * md->bh, sizeof(MV));
    md->mv1 = (MV *)calloc((size_t)md->bw * md->bh, sizeof(MV));
    md->bgmap = (uint8_t *)calloc((size_t)md->bw * md->bh, 1);
    md->ratio = ratio;
    md->reversed = k > ratio / 2;
    md->wt0 = md->reversed ? k : ratio - k;
    md->wt1 = ratio - md->wt0;
    md->pos = k;
}

static void md_free(MvData *md)
{
    free(md->mv0);
    free(md->mv1);
    free(md->bgmap);
}

/* interpolate_frame (pad = bs/2 = 4); outputs written at opad 96/48 */
static void interpolate_frame(const MvData *md, const Level *in0,
                              const Level *in1, int w, int h, uint8_t *oy,
                              uint8_t *ou, uint8_t *ov)
{
    const Level *p0 = md->reversed ? in1 : in0;
    const Level *p1 = md->reversed ? in0 : in1;
    int bs = md->bs;
    int pad = bs / 2;
    int wP = w + pad, hP = h + pad;
    int wPc = wP / 2, hPc = hP / 2, padc = pad / 2;
    int opy = 96, opc = 48;

    for (int yp = 0; yp < md->bh; yp++) {
        for (int xp = 0; xp < md->bw; xp++) {
            MV mv0 = md->mv0[yp * md->bw + xp];
            MV mv1 = md->mv1[yp * md->bw + xp];
            mot_comp_avg(xp * bs, yp * bs, p0->y, p0->pad, p0->width,
                         p1->y, p1->pad, p1->width, oy, opy, w, mv0, mv1,
                         wP, hP, pad, bs);
            MV cmv1 = {mv1.x >> 1, mv1.y >> 1};
            MV cmv0 = scale_mv(cmv1, -md->wt1, md->wt0);
            int bsc = bs / 2;
            mot_comp_avg(xp * bsc, yp * bsc, p0->u, p0->pad_c, w / 2,
                         p1->u, p1->pad_c, w / 2, ou, opc, w / 2, cmv0,
                         cmv1, wPc, hPc, padc, bsc);
            mot_comp_avg(xp * bsc, yp * bsc, p0->v, p0->pad_c, w / 2,
                         p1->v, p1->pad_c, w / 2, ov, opc, w / 2, cmv0,
                         cmv1, wPc, hPc, padc, bsc);
        }
    }
}

/* Entry point.
 * y0/y1: padded luma (pad 96, stride w+192); u/v: padded chroma
 * (pad 48, stride w/2+96). ratio/pos per interpolate_frames.
 * out_y/out_u/out_v: unpadded planes (w*h, w/2*h/2). */
void thor_interpolate_frames(
    const uint8_t *y0, const uint8_t *u0, const uint8_t *v0,
    const uint8_t *y1, const uint8_t *u1, const uint8_t *v1,
    int w, int h, int ratio, int pos,
    uint8_t *out_y, uint8_t *out_u, uint8_t *out_v)
{
    int PAD_Y = 96, PAD_C = 48;
    int minwh = w < h ? w : h;
    int max_levels = (int)(log10((double)minwh) / log10(2.0) - 4.0);
    if (max_levels > TI_MAX_LEVELS) max_levels = TI_MAX_LEVELS;

    Level levels0[TI_MAX_LEVELS], levels1[TI_MAX_LEVELS];
    levels0[0].y = (uint8_t *)y0;
    levels0[0].pad = PAD_Y; levels0[0].width = w; levels0[0].height = h;
    levels0[0].u = u0; levels0[0].v = v0; levels0[0].pad_c = PAD_C;
    levels0[0].owns = 0;
    levels1[0] = levels0[0];
    levels1[0].y = (uint8_t *)y1; levels1[0].u = u1; levels1[0].v = v1;
    for (int l = 1; l < max_levels; l++) {
        levels0[l] = downscale2x2(&levels0[l - 1], 32);
        levels1[l] = downscale2x2(&levels1[l - 1], 32);
    }

    MvData mds[TI_MAX_LEVELS], spatial[TI_MAX_LEVELS];
    for (int j = 0; j < max_levels; j++) {
        md_init(&mds[j], w >> j, h >> j, BLOCK_STEP / 2, BLOCK_STEP,
                ratio, pos);
        md_init(&spatial[j], w >> j, h >> j, BLOCK_STEP / 2, BLOCK_STEP,
                ratio, pos);
    }

    int opy = 96, opc = 48;
    int oystride = w + 2 * opy, ocstride = w / 2 + 2 * opc;
    uint8_t *oy = (uint8_t *)calloc((size_t)oystride * (h + 2 * opy), 1);
    uint8_t *ou = (uint8_t *)calloc((size_t)ocstride * (h / 2 + 2 * opc), 1);
    uint8_t *ov = (uint8_t *)calloc((size_t)ocstride * (h / 2 + 2 * opc), 1);

    for (int lvl = max_levels - 1; lvl >= 0; lvl--) {
        const MvData *guide = lvl == max_levels - 1 ? NULL : &spatial[lvl];
        motion_estimate_bi(&mds[lvl], guide, &levels0[lvl], &levels1[lvl]);
        if (lvl == 0)
            interpolate_frame(&mds[0], &levels0[0], &levels1[0], w, h,
                              oy, ou, ov);
        if (lvl > 0)
            upscale_mv(&mds[lvl], &spatial[lvl - 1]);
    }

    for (int r = 0; r < h; r++)
        memcpy(out_y + (size_t)r * w, oy + (opy + r) * oystride + opy, w);
    for (int r = 0; r < h / 2; r++) {
        memcpy(out_u + (size_t)r * (w / 2),
               ou + (opc + r) * ocstride + opc, w / 2);
        memcpy(out_v + (size_t)r * (w / 2),
               ov + (opc + r) * ocstride + opc, w / 2);
    }

    free(oy); free(ou); free(ov);
    for (int j = 0; j < max_levels; j++) {
        md_free(&mds[j]);
        md_free(&spatial[j]);
    }
    for (int l = 1; l < max_levels; l++) {
        free(levels0[l].y);
        free(levels1[l].y);
    }
}
