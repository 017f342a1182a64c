// Deblocking edge parameters for Hopper (sm_90a): the boundary strength
// of every 4-sample edge segment of a picture and, from it, the luma
// beta / tc and the chroma tc of both chroma components, in ONE launch.
//
// Replaces no TPU kernel: the JAX package makes these parameters with
// numpy on the host (openhevc_tpu/ops/filters_jax.py `prep_filters`,
// `boundary_strengths_vec`, `_mv_bs_vec`), and so did the port until
// this kernel, at about 50 ms a 1080p inter picture on the decoding
// thread while the card waited. Here the host uploads the per-4x4 grids
// the parser already made (prediction mode, luma cbf, TU / PU edge
// flags, QP_Y; on a picture with inter blocks its prediction flags, MVs
// and reference POCs) and the card writes the eight int16 arrays that
// ops/filters.py `apply_filters_device` takes. Bit-exact with the
// numpy version (integers throughout; H.265 8.7.2.4 boundary strength,
// 8.7.2.5.3 beta / tc, 8.7.2.5.5 chroma QP).
//
// What bounds it on this card: the latency of one launch. A 1080p
// inter picture moves 3.5 MB (the grids read, the parameters written),
// about 1 us at 3.35 TB/s, so the design keeps it to one small launch:
// one thread per 4-sample edge segment, every output array in one grid
// (luma vertical, luma horizontal, chroma vertical, chroma horizontal
// segments in turn), the boundary strength kept in registers and never
// stored. Every output element is written, the picture's first column
// and row of edges (picture edges, never filtered) with 0.
//
// The MV rule needs no reference index: where two blocks have equal
// prediction flags, MVs and reference POCs, the POC and MV tests below
// already give strength 0, so `_mv_bs_vec`'s extra "identical motion"
// test (which also compares reference indices) never changes a result.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQpLut = 96;          // chroma QP table entries, QP -32..63

__constant__ int8_t kBeta[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8,
    9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34,
    36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
__constant__ int8_t kTc[54] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4,
    5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24};

// The picture's per-4x4 grids, [rows, pitch] row-major (the parser's
// CTB-padded grids); pf / mv / poc are null on a picture without inter
// blocks.
struct Grids {
    const uint8_t* pm;      // prediction mode: 1 intra
    const uint8_t* cbf;     // luma cbf
    const uint8_t* bv;      // TU / PU edge at the block's left side
    const uint8_t* bh;      // ... at its top side
    const int8_t* qp;       // QP_Y
    const uint8_t* pf;      // prediction flags: bit 0 list 0, bit 1 list 1
    const int16_t* mv;      // [.., list, x / y]
    const int32_t* poc;     // [.., list] the reference's POC
    int pitch;
};

struct Params {
    int h4, w8, h8, w4;         // luma edges: vertical [h4, w8], horizontal
                                // [h8, w4]
    int hc4, wc8, hc8, wc4;     // chroma: [hc4, wc8], [hc8, wc4]
    int hs, vs, bd, bdc, beta_offset, tc_offset;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ bool near_mv(const int16_t* a, const int16_t* b) {
    return abs(int(a[0]) - int(b[0])) < 4 && abs(int(a[1]) - int(b[1])) < 4;
}

// 1 where the motion of blocks p and q differs enough for an edge
// between them (8.7.2.4, and `_mv_bs_vec`), else 0.
__device__ int mv_bs(const Grids& g, int p, int q) {
    const int fp = g.pf[p], fq = g.pf[q];
    const int16_t* mp = g.mv + 4 * p;      // list l at mp + 2 * l
    const int16_t* mq = g.mv + 4 * q;
    const int p0 = g.poc[2 * p], p1 = g.poc[2 * p + 1];
    const int q0 = g.poc[2 * q], q1 = g.poc[2 * q + 1];
    const bool ns0 = near_mv(mp, mq), ns1 = near_mv(mp + 2, mq + 2);
    const bool nx0 = near_mv(mp + 2, mq), nx1 = near_mv(mp, mq + 2);
    const bool straight = ns0 && ns1, crossed = nx0 && nx1;
    if (fp == 3 && fq == 3) {               // both bi-predicted
        bool zero;
        if (q0 == p0 && q0 == q1 && p0 == p1)
            zero = straight || crossed;
        else if (p0 == q0 && p1 == q1)
            zero = straight;
        else if (p1 == q0 && p0 == q1)
            zero = crossed;
        else
            zero = false;
        return zero ? 0 : 1;
    }
    if (fp != 3 && fq != 3) {               // both one list
        const bool lp0 = (fp & 1) != 0, lq0 = (fq & 1) != 0;
        const int pu = lp0 ? p0 : p1, qu = lq0 ? q0 : q1;
        const bool near = lp0 == lq0 ? (lp0 ? ns0 : ns1)
                                     : (lp0 ? nx1 : nx0);
        return pu == qu && near ? 0 : 1;
    }
    return 1;
}

// Boundary strength of the edge between 4x4 blocks p and q (flat grid
// indices); tu: the edge is a TU or PU edge.
__device__ int bs_at(const Grids& g, int p, int q, int tu) {
    if (g.pm[p] == 1 || g.pm[q] == 1)
        return tu ? 2 : 0;
    if (tu && (g.cbf[p] || g.cbf[q]))
        return 1;
    return g.pf ? mv_bs(g, p, q) : 0;
}

__device__ __forceinline__ int avg_qp(const Grids& g, int p, int q) {
    return (int(g.qp[p]) + int(g.qp[q]) + 1) >> 1;
}

// Luma beta and tc of an edge of strength bs between p and q.
__device__ void luma(const Grids& g, const Params& d, int p, int q, int bs,
                     int16_t* beta, int16_t* tc) {
    int b = 0, t = 0;
    if (bs > 0) {
        const int qp = avg_qp(g, p, q);
        b = int(kBeta[clampi(qp + d.beta_offset, 0, 51)]) << (d.bd - 8);
        t = int(kTc[clampi(qp + 2 * (bs - 1) + d.tc_offset, 0, 53)])
            << (d.bd - 8);
    }
    *beta = (int16_t)b;
    *tc = (int16_t)t;
}

// Chroma tc of both components (only strength 2 filters chroma).
__device__ void chroma(const Grids& g, const Params& d, const int32_t* qlut,
                       int p, int q, int bs, int16_t* tc1, int16_t* tc2) {
    int t1 = 0, t2 = 0;
    if (bs == 2) {
        const int c = clampi(avg_qp(g, p, q), -32, 63) + 32;
        t1 = int(kTc[clampi(qlut[c] + 2 + d.tc_offset, 0, 53)])
             << (d.bdc - 8);
        t2 = int(kTc[clampi(qlut[kQpLut + c] + 2 + d.tc_offset, 0, 53)])
             << (d.bdc - 8);
    }
    *tc1 = (int16_t)t1;
    *tc2 = (int16_t)t2;
}

// out: the eight arrays back to back in apply_filters_device's order:
// beta_v, tc_v [h4, w8], beta_h, tc_h [h8, w4], tc_cv1 [hc4, wc8],
// tc_ch1 [hc8, wc4], tc_cv2, tc_ch2.
__global__ void __launch_bounds__(kThreads)
edge_params_kernel(Grids g, const int32_t* qlut, Params d, int16_t* out) {
    const int n0 = d.h4 * d.w8, n1 = d.h8 * d.w4;
    const int n2 = d.hc4 * d.wc8, n3 = d.hc8 * d.wc4;
    int16_t* beta_v = out;
    int16_t* tc_v = beta_v + n0;
    int16_t* beta_h = tc_v + n0;
    int16_t* tc_h = beta_h + n1;
    int16_t* tc_cv1 = tc_h + n1;
    int16_t* tc_ch1 = tc_cv1 + n2;
    int16_t* tc_cv2 = tc_ch1 + n3;
    int16_t* tc_ch2 = tc_cv2 + n2;
    int i = blockIdx.x * kThreads + threadIdx.x;
    if (i < n0) {                            // luma, vertical edge x8
        const int y4 = i / d.w8, x8 = i % d.w8;
        const int q = y4 * g.pitch + 2 * x8, p = q - 1;
        const int bs = x8 ? bs_at(g, p, q, g.bv[q]) : 0;
        luma(g, d, p, q, bs, beta_v + i, tc_v + i);
        return;
    }
    if ((i -= n0) < n1) {                    // luma, horizontal edge y8
        const int y8 = i / d.w4, x4 = i % d.w4;
        const int q = 2 * y8 * g.pitch + x4, p = q - g.pitch;
        const int bs = y8 ? bs_at(g, p, q, g.bh[q]) : 0;
        luma(g, d, p, q, bs, beta_h + i, tc_h + i);
        return;
    }
    // chroma edges every 8 chroma samples: the luma edge (x8 << hs) of
    // luma row (y4 << vs), and the same for horizontal edges
    if ((i -= n1) < n2) {
        const int cy4 = i / d.wc8, cx8 = i % d.wc8;
        const int q = (cy4 << d.vs) * g.pitch + 2 * (cx8 << d.hs), p = q - 1;
        const int bs = cx8 ? bs_at(g, p, q, g.bv[q]) : 0;
        chroma(g, d, qlut, p, q, bs, tc_cv1 + i, tc_cv2 + i);
        return;
    }
    if ((i -= n2) < n3) {
        const int cy8 = i / d.wc4, cx4 = i % d.wc4;
        const int q = 2 * (cy8 << d.vs) * g.pitch + (cx4 << d.hs);
        const int p = q - g.pitch;
        const int bs = cy8 ? bs_at(g, p, q, g.bh[q]) : 0;
        chroma(g, d, qlut, p, q, bs, tc_ch1 + i, tc_ch2 + i);
    }
}

}  // namespace

// One launch over every segment of a H x W picture with chroma shifts
// hs / vs; returns the cudaError_t of the launch. pf / mv / poc may be
// null (a picture without inter blocks). out: int16, 2 * (h4 * w8 +
// h8 * w4 + hc4 * wc8 + hc8 * wc4) elements, laid out as above.
extern "C" int edge_params_launch(const void* pm, const void* cbf,
                                  const void* bv, const void* bh,
                                  const void* qp, const void* pf,
                                  const void* mv, const void* poc, int pitch,
                                  const void* qlut, void* out, int H, int W,
                                  int hs, int vs, int bd, int bdc,
                                  int beta_offset, int tc_offset,
                                  void* stream) {
    const Grids g{(const uint8_t*)pm, (const uint8_t*)cbf, (const uint8_t*)bv,
                  (const uint8_t*)bh, (const int8_t*)qp, (const uint8_t*)pf,
                  (const int16_t*)mv, (const int32_t*)poc, pitch};
    const int Hc = H >> vs, Wc = W >> hs;
    const Params d{H >> 2, W >> 3, H >> 3, W >> 2,
                   Hc >> 2, (Wc + 7) >> 3, (Hc + 7) >> 3, Wc >> 2,
                   hs, vs, bd, bdc, beta_offset, tc_offset};
    const long total = (long)d.h4 * d.w8 + (long)d.h8 * d.w4 +
                       (long)d.hc4 * d.wc8 + (long)d.hc8 * d.wc4;
    const int blocks = (int)((total + kThreads - 1) / kThreads);
    edge_params_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        g, (const int32_t*)qlut, d, (int16_t*)out);
    return (int)cudaGetLastError();
}
