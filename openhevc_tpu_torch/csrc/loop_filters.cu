// In-loop filters for Hopper (sm_90a): the deblocking filter (H.265
// 8.7.2) and sample adaptive offset (8.7.3) of a whole picture in at
// most THREE launches: vertical edges, horizontal edges, SAO.
//
// Replaces no Pallas kernel: the JAX package filters with jnp ops
// (openhevc_tpu/ops/filters_jax.py `apply_filters_device`), and so did
// the port until these kernels: ops/filters.py `apply_filters_ref`,
// about 1,000 torch launches a 1080p picture (windowed, rolled and
// masked whole-plane passes), 18-23 ms of dispatch on the decoding
// thread while the card waited. That plain version stays as the
// yardstick; these kernels equal it sample for sample, including where
// it reads across a band's wrap (the rows of a halo band that the mesh
// throws away).
//
// What bounds them on this card: the latency of a launch. A 1080p 4:2:0
// picture moves about 75 MB in the three passes (each reads and writes
// every int32 sample once), about 22 us at 3.35 TB/s; a 4K picture about
// four times that. So the design keeps the launches few and each sample's
// reads and writes bounded:
//   - launch 1 (`deblock_kernel<true>`): one thread per 4-line vertical
//     edge segment of luma and of both chroma planes in one grid. It
//     reads its 4 x 8 samples (a window from 4 before the edge to 4
//     after; chroma 2 before and 6 after) and its beta / tc and
//     no-filter flags from the int16 arrays `edge_params` made, decides
//     strong / normal / off (8.7.2.5.3-7) and writes its window to a new
//     plane. Edges lie 8 samples apart, so the windows tile the plane:
//     no two threads write one sample, and none reads what another
//     writes.
//   - launch 2 (`deblock_kernel<false>`): the same across horizontal
//     edges on launch 1's output, in place, except for the chroma of a
//     16x16-CTB picture with SAO: there SAO reads some neighbours from
//     the vertical stage (the reference's CTB schedule), so launch 1's
//     chroma output is kept as it is and launch 2 writes a new plane.
//   - launch 3 (`sao_kernel`): one thread per sample of the three
//     planes: the CTB's type, band position or edge class and four
//     offsets from the int16 SAO array, the 3x3 neighbourhood from the
//     deblocked planes (the vertical stage where the stale-read masks say
//     so), the picture's true rows in a halo band, and the restore of
//     PCM / transquant-bypass blocks (the reference's chroma quadrant
//     quirk comes with the restore map that ops/filters.py makes).
// Integers throughout; bit-exact with `apply_filters_ref`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// One plane of a pass: samples read from src (row pitch sp) and written
// to dst (row pitch dp); src == dst for a pass in place.
struct Plane {
    const int32_t* src;
    int32_t* dst;
    int h, w, sp, dp;
};

// A plane's edge parameters in the pass's direction, int16 [rows, cols]
// row-major: beta (luma only), tc, and the no-filter flags of the P and
// Q sides (null where the picture has none).
struct Edges {
    const int16_t* beta;
    const int16_t* tc;
    const int16_t* nop;
    const int16_t* noq;
};

struct DeblockArgs {
    Plane pl[3];
    Edges e[3];
    int n[3];               // edge segments of each plane
    int maxv[2];            // largest luma / chroma sample
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

// Position k (0..7) of the window across edge `edge` (the edge at 8 *
// edge) on an axis of n samples: first = 4 for luma, 2 for chroma
// samples before the edge. Edge 0, the picture's (or band's) first,
// takes its P side from the axis' end, as the plain version's rolled
// windows do; its parameters are 0 on a whole picture.
__device__ __forceinline__ int window_pos(int edge, int k, int first,
                                          int n) {
    const int p = 8 * edge - first + k;
    return p < 0 ? p + n : p;
}

__device__ __forceinline__ int ld(const Plane& p, int r, int c) {
    return p.src[(long)r * p.sp + c];
}

__device__ __forceinline__ void st(const Plane& p, int r, int c, int v) {
    p.dst[(long)r * p.dp + c] = v;
}

__device__ __forceinline__ bool strong_line(const int* s, int d, int beta,
                                            int tc) {
    return 2 * d < (beta >> 2) &&
           abs(s[0] - s[3]) + abs(s[4] - s[7]) < (beta >> 3) &&
           abs(s[3] - s[4]) < ((5 * tc + 1) >> 1);
}

// One 4-line luma edge segment, i-th of the plane's segments: vertical
// edges [h / 4, w / 8], horizontal ones [h / 8, w / 4], the edge index
// fastest. s[l][k]: line l, window position k = p3 p2 p1 p0 q0 q1 q2 q3.
template <bool kVertical>
__device__ void luma_segment(const Plane& p, const Edges& e, int i,
                             int maxv) {
    const int per = kVertical ? p.w >> 3 : p.w >> 2;
    const int a = i / per, b = i % per;
    const int edge = kVertical ? b : a, across = kVertical ? a : b;
    const int n = kVertical ? p.w : p.h;
    int pos[8], s[4][8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
        pos[k] = window_pos(edge, k, 4, n);
#pragma unroll
    for (int l = 0; l < 4; ++l)
#pragma unroll
        for (int k = 0; k < 8; ++k)
            s[l][k] = kVertical ? ld(p, 4 * across + l, pos[k])
                                : ld(p, pos[k], 4 * across + l);
    const int beta = e.beta[i], tc = e.tc[i];
    const bool keep_p = e.nop && e.nop[i] > 0;
    const bool keep_q = e.noq && e.noq[i] > 0;
    const int dp0 = abs(s[0][1] - 2 * s[0][2] + s[0][3]);
    const int dq0 = abs(s[0][6] - 2 * s[0][5] + s[0][4]);
    const int dp3 = abs(s[3][1] - 2 * s[3][2] + s[3][3]);
    const int dq3 = abs(s[3][6] - 2 * s[3][5] + s[3][4]);
    const int d0 = dp0 + dq0, d3 = dp3 + dq3;
    const bool filt = tc > 0 && d0 + d3 < beta;
    const bool strong = filt && strong_line(s[0], d0, beta, tc) &&
                        strong_line(s[3], d3, beta, tc);
    const int side = (beta + (beta >> 1)) >> 3;
    const bool nd_p = dp0 + dp3 < side, nd_q = dq0 + dq3 < side;
    const int tc2 = 2 * tc, tch = tc >> 1;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
        int* x = s[l];
        const int p3 = x[0], p2 = x[1], p1 = x[2], p0 = x[3];
        const int q0 = x[4], q1 = x[5], q2 = x[6], q3 = x[7];
        int o[6] = {p2, p1, p0, q0, q1, q2};
        if (strong) {
            o[2] = clampi((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                          p0 - tc2, p0 + tc2);
            o[1] = clampi((p2 + p1 + p0 + q0 + 2) >> 2, p1 - tc2, p1 + tc2);
            o[0] = clampi((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                          p2 - tc2, p2 + tc2);
            o[3] = clampi((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                          q0 - tc2, q0 + tc2);
            o[4] = clampi((p0 + q0 + q1 + q2 + 2) >> 2, q1 - tc2, q1 + tc2);
            o[5] = clampi((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3,
                          q2 - tc2, q2 + tc2);
        } else if (filt) {
            const int delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
            if (abs(delta0) < 10 * tc) {
                const int delta = clampi(delta0, -tc, tc);
                o[2] = clampi(p0 + delta, 0, maxv);
                o[3] = clampi(q0 - delta, 0, maxv);
                if (nd_p)
                    o[1] = clampi(p1 + clampi((((p2 + p0 + 1) >> 1) - p1 +
                                               delta) >> 1, -tch, tch),
                                  0, maxv);
                if (nd_q)
                    o[4] = clampi(q1 + clampi((((q2 + q0 + 1) >> 1) - q1 -
                                               delta) >> 1, -tch, tch),
                                  0, maxv);
            }
        }
#pragma unroll
        for (int k = 0; k < 6; ++k)
            if (!(k < 3 ? keep_p : keep_q))
                x[k + 1] = o[k];
    }
    // out of place the window is copied whole; in place only p2..q2 move
    const bool whole = p.src != p.dst;
#pragma unroll
    for (int l = 0; l < 4; ++l)
#pragma unroll
        for (int k = 0; k < 8; ++k)
            if (whole || (k > 0 && k < 7)) {
                if (kVertical)
                    st(p, 4 * across + l, pos[k], s[l][k]);
                else
                    st(p, pos[k], 4 * across + l, s[l][k]);
            }
}

// One 4-line chroma edge segment: vertical edges [h / 4, ceil(w / 8)],
// horizontal ones [ceil(h / 8), w / 4]. The window (p1 p0 q0 q1 and four
// more) runs from 2 before the edge to 6 after on the axis padded to a
// multiple of 8, where samples past the plane read 0 and are not written.
template <bool kVertical>
__device__ void chroma_segment(const Plane& p, const Edges& e, int i,
                               int maxv) {
    const int per = kVertical ? (p.w + 7) >> 3 : p.w >> 2;
    const int a = i / per, b = i % per;
    const int edge = kVertical ? b : a, across = kVertical ? a : b;
    const int n = kVertical ? p.w : p.h;
    const int padded = (n + 7) & ~7;
    int pos[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
        pos[k] = window_pos(edge, k, 2, padded);
    const int tc = e.tc[i];
    const bool keep_p = e.nop && e.nop[i] > 0;
    const bool keep_q = e.noq && e.noq[i] > 0;
    const bool whole = p.src != p.dst;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
        const int r = 4 * across + l;
        int s[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
            s[k] = pos[k] >= n ? 0
                               : kVertical ? ld(p, r, pos[k])
                                           : ld(p, pos[k], r);
        if (tc > 0) {
            const int p1 = s[0], p0 = s[1], q0 = s[2], q1 = s[3];
            const int delta = clampi((4 * (q0 - p0) + p1 - q1 + 4) >> 3,
                                     -tc, tc);
            if (!keep_p)
                s[1] = clampi(p0 + delta, 0, maxv);
            if (!keep_q)
                s[2] = clampi(q0 - delta, 0, maxv);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k)
            if (pos[k] < n && (whole || k == 1 || k == 2)) {
                if (kVertical)
                    st(p, r, pos[k], s[k]);
                else
                    st(p, pos[k], r, s[k]);
            }
    }
}

// Launch 1 (kVertical) or 2: every edge segment of luma, Cb and Cr in
// one grid, in that order.
template <bool kVertical>
__global__ void __launch_bounds__(kThreads) deblock_kernel(DeblockArgs a) {
    int i = blockIdx.x * kThreads + threadIdx.x;
    if (i < a.n[0]) {
        luma_segment<kVertical>(a.pl[0], a.e[0], i, a.maxv[0]);
        return;
    }
    i -= a.n[0];
    int c = 1;
    if (i >= a.n[1]) {
        i -= a.n[1];
        c = 2;
        if (i >= a.n[2])
            return;
    }
    chroma_segment<kVertical>(a.pl[c], a.e[c], i, a.maxv[1]);
}

// One plane of SAO: the deblocked samples (src, row pitch sp), the
// vertical-stage plane (vst, pitch vp; null unless the stale-read masks
// apply), the output (dst, contiguous [h, w]).
struct SaoPlane {
    const int32_t* src;
    const int32_t* vst;
    int32_t* dst;
    int h, w, sp, vp;
    int csy, csx;           // a CTB in this plane's samples
    int ytop, ybot;         // the picture's true rows in this plane
    const int16_t* nf;      // restore map (null: none), a flag per
    int nf_cols, nfy, nfx;  // nfy x nfx samples, nf_cols to a row
};

struct SaoArgs {
    SaoPlane pl[3];
    const int16_t* sao;     // [ctb rows, sao_cols, 3, 6]: type, band
    int sao_cols;           // position or edge class, four offsets
    const int16_t* st[3];   // stale-read masks b0, b2, a3 ([h, w] chroma)
    int n[3];               // samples of each plane
    int bd[2];              // luma / chroma bit depth
};

// neighbours a and b (dx, dy) of the four edge classes
__constant__ int8_t kNeigh[4][4] = {
    {-1, 0, 1, 0}, {0, -1, 0, 1}, {-1, -1, 1, 1}, {1, -1, -1, 1}};

__device__ __forceinline__ int wrap_row(int y, int h) {
    return y < 0 ? y + h : (y >= h ? y - h : y);
}

__device__ __forceinline__ int sgn(int v) { return (v > 0) - (v < 0); }

// Launch 3: one thread per sample of luma, Cb and Cr.
__global__ void __launch_bounds__(kThreads) sao_kernel(SaoArgs a) {
    int i = blockIdx.x * kThreads + threadIdx.x;
    int c = 0;
    while (c < 3 && i >= a.n[c])
        i -= a.n[c++];
    if (c == 3)
        return;
    const SaoPlane& p = a.pl[c];
    const int y = i / p.w, x = i % p.w;
    const int v = p.src[(long)y * p.sp + x];
    const int bd = a.bd[c > 0], maxv = (1 << bd) - 1;
    const int16_t* q =
        a.sao + ((long)((y / p.csy) * a.sao_cols + x / p.csx) * 3 + c) * 6;
    const int typ = q[0], sec = q[1];
    int out = v;
    if (typ == 1) {                          // band offset
        const int band = v >> (bd - 5);
        int add = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k)
            if (band == ((sec + k) & 31))
                add += q[2 + k];
        out = clampi(v + add, 0, maxv);
    } else if (typ == 2 && sec >= 0 && sec < 4) {    // edge offset
        const int8_t* nb = kNeigh[sec];
        const int inner = sec != 1;          // the class reads across x
        const int across_y = sec != 0;       // ... and across y
        if (x >= inner && x < p.w - inner && y >= p.ytop + across_y &&
            y < p.ybot - across_y) {
            const int ya = wrap_row(y + nb[1], p.h);
            const int yb = wrap_row(y + nb[3], p.h);
            const int xa = x + nb[0], xb = x + nb[2];
            const int* pa = p.src;
            const int* pb = p.src;
            int pap = p.sp, pbp = p.sp;
            if (p.vst) {
                const long m = (long)y * p.w + x;
                if ((sec == 0 && a.st[0][m] > 0) ||
                    (sec == 2 && a.st[1][m] > 0)) {
                    pb = p.vst;
                    pbp = p.vp;
                } else if (sec == 3 && a.st[2][m] > 0) {
                    pa = p.vst;
                    pap = p.vp;
                }
            }
            const int va = pa[(long)ya * pap + xa];
            const int vb = pb[(long)yb * pbp + xb];
            const int idx = 2 + sgn(v - va) + sgn(v - vb);
            const int add = idx == 0 ? q[2] : idx == 1 ? q[3]
                          : idx == 3 ? q[4] : idx == 4 ? q[5] : 0;
            out = clampi(v + add, 0, maxv);
        }
    }
    if (p.nf && p.nf[(y / p.nfy) * p.nf_cols + x / p.nfx] > 0)
        out = v;                             // no-filter block: restored
    p.dst[i] = out;
}

int blocks(long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

// Launch 1 (vertical != 0) or 2 over the three planes. src, dst: the
// planes' int32 samples (Y, Cb, Cr); dims: per plane h, w, src pitch,
// dst pitch (in samples); params: per plane beta, tc, nop, noq (int16
// edge arrays, beta null for chroma, nop / noq null where absent).
// Returns the cudaError_t of the launch.
extern "C" int deblock_launch(int vertical, const void* const* src,
                              void* const* dst, const int* dims,
                              const void* const* params, int bd, int bdc,
                              void* stream) {
    DeblockArgs a;
    long total = 0;
    for (int c = 0; c < 3; ++c) {
        const int* d = dims + 4 * c;
        a.pl[c] = Plane{(const int32_t*)src[c], (int32_t*)dst[c], d[0], d[1],
                        d[2], d[3]};
        const void* const* e = params + 4 * c;
        a.e[c] = Edges{(const int16_t*)e[0], (const int16_t*)e[1],
                       (const int16_t*)e[2], (const int16_t*)e[3]};
        const int h = d[0], w = d[1];
        if (c == 0)
            a.n[c] = vertical ? (h >> 2) * (w >> 3) : (h >> 3) * (w >> 2);
        else
            a.n[c] = vertical ? (h >> 2) * ((w + 7) >> 3)
                              : ((h + 7) >> 3) * (w >> 2);
        total += a.n[c];
    }
    a.maxv[0] = (1 << bd) - 1;
    a.maxv[1] = (1 << bdc) - 1;
    if (vertical)
        deblock_kernel<true><<<blocks(total), kThreads, 0,
                               (cudaStream_t)stream>>>(a);
    else
        deblock_kernel<false><<<blocks(total), kThreads, 0,
                                (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// Launch 3. src, vst, dst: per plane the deblocked samples, the vertical
// stage (null but for the chroma of a 16x16-CTB picture with the
// stale-read masks) and the output; dims: per plane h, w, src pitch, vst
// pitch, CTB rows, CTB cols, true top row, true bottom row; nf: the luma
// and chroma restore maps or null, nf_dims: per plane map cols, rows and
// cols of samples a flag; st: the stale-read masks b0, b2, a3 or null;
// sao: int16 [ctb rows, sao_cols, 3, 6].
extern "C" int sao_launch(const void* const* src, const void* const* vst,
                          void* const* dst, const int* dims,
                          const void* const* nf, const int* nf_dims,
                          const void* const* st, const void* sao,
                          int sao_cols, int bd, int bdc, void* stream) {
    SaoArgs a;
    long total = 0;
    for (int c = 0; c < 3; ++c) {
        const int* d = dims + 8 * c;
        const int* f = nf_dims + 3 * c;
        a.pl[c] = SaoPlane{(const int32_t*)src[c], (const int32_t*)vst[c],
                           (int32_t*)dst[c], d[0], d[1], d[2], d[3], d[4],
                           d[5], d[6], d[7],
                           (const int16_t*)nf[c > 0], f[0], f[1], f[2]};
        a.n[c] = d[0] * d[1];
        a.st[c] = (const int16_t*)st[c];
        total += a.n[c];
    }
    a.sao = (const int16_t*)sao;
    a.sao_cols = sao_cols;
    a.bd[0] = bd;
    a.bd[1] = bdc;
    sao_kernel<<<blocks(total), kThreads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
