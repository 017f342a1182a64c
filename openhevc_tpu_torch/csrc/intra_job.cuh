// The per-TU body of the fused intra kernels (csrc/intra_fused.cu and
// csrc/intra_fused_banded.cu): one intra TU run by a team of 1 to T
// warps, each warp on its own.
//
// Counterpart of `_job` in openhevc_tpu/ops/intra_fused.py (:230-445),
// bit-exact with openhevc_tpu/ops/intra_np.py: gather the 4s+1
// neighbours, substitute unavailable ones (H.265 8.4.4.2.2), filter
// (8.4.4.2.3: [1,2,1] or the 32x32 strong bilinear), build the angular
// reference with its negative-angle projection, then predict (planar /
// DC / angular) the s*s samples, add the residual, clip and store.
//
// What bounds a job on this card is latency, not bytes or operations: a
// 4x4 TU (most jobs of a 4K frame) reads 17 samples and writes 16. So
// the job is sized to the smallest group that covers it. A warp holds a
// job: its 16 meta fields arrive in one load instruction (lane k loads
// field k), the phases are separated by __syncwarp() (not a block-wide
// barrier), a 4x4 or 8x8 TU takes one pass of each phase, and a 32x32 TU
// (129 references, 1024 samples) takes 5 and 32. The body is compiled
// once per TU size (template on log2 size), so every pass count is a
// constant, every loop is unrolled, and the global loads of a phase are
// all started before the first is used: one memory latency per phase,
// not one per pass. Each lane resolves its own sample's substitution
// with bit scans over the 33-bit availability word (no serial scan);
// the DC sum is one warp reduction.
//
// A 32x32 TU's 32 store passes would make it the long pole of its
// level (measured: ~1.4 us of a 4.2 us level at 4K), so a job may be
// shared by the T warps of a team: every warp that has a pass prepares
// the references for itself (129 samples at most: cheaper than a
// barrier and a broadcast), then takes the passes part, part + T, ...
// of the predict-and-store loop. A 4x4 TU (one pass) keeps one warp,
// an 8x8 two, 16x16 and 32x32 all T; the other warps of the team skip
// the job. Each warp has its own 1940 B of scratch. The TPU workarounds of the Pallas body (one-hot MXU gathers,
// lane rolls, reversal matmuls, bf16 byte splits) become indexed loads.
//
// Jobs of one wavefront level run on different SMs, whose L1 caches are
// not coherent: the neighbour gather reads the planes with ld.global.cg
// (L2 only) and the samples are stored with st.global.cg. The residual
// and the meta are read-only and go through the read-only path; all of
// a job's residual is loaded into registers BEFORE the warp waits for
// its level (the `ready` hook of `intra_job`), off the dependency chain.
//
// All 32 lanes of a warp must call these functions with the same job.
// `intra_job` ends with a __syncwarp(), so the scratch may be reused at
// once; joining the team's warps and making the stores visible to other
// SMs is the caller's part (csrc/intra_sched.cuh).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace intra {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxRef = 4 * 32 + 1;
constexpr int kMetaRows = 16;

// Shared-memory scratch of one job, i.e. of one warp (1940 bytes).
struct Scratch {
    int raw[kMaxRef];      // gathered neighbours, spec order
    int sub[kMaxRef];      // after substitution
    int flt[kMaxRef];      // after filtering
    int rr[3 * 32 + 2];    // angular reference, offset s
};

// The padded planes the jobs read and write (int32; chroma is [2, hc, wc]).
struct Planes {
    int32_t* luma;
    int wl;
    int32_t* chroma;
    int hc, wc;
    const int32_t* res_l;
    const int32_t* res_c;
};

// One job's fields, uniform across the warp (meta rows: 0 y(buf)
// 1 x(buf) 2 size_log2-2 3 mode 4 plane 5 do_filter 6 avail word0
// 7 avail word1 8 angle 9 inv_angle 10 strong_allowed 12 edge_filters
// 13 avail bit 32), and the plane it works on.
struct Job {
    int y, x, sl, mode, do_filter, angle, inv, strong, edge;
    uint64_t w;            // s+1 availability group bits
    int32_t* buf;
    const int32_t* res;
    int ws;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// Job j of meta [16, npad]: lane k < 16 loads field k (one instruction
// for the warp), then the fields are broadcast.
__device__ __forceinline__ Job load_job(const int32_t* meta, int npad, int j,
                                        const Planes& pl, int lane) {
    const int f = lane < kMetaRows ? __ldg(meta + (size_t)lane * npad + j)
                                   : 0;
    Job jb;
    jb.y = __shfl_sync(kFull, f, 0);
    jb.x = __shfl_sync(kFull, f, 1);
    jb.sl = __shfl_sync(kFull, f, 2) & 3;
    jb.mode = __shfl_sync(kFull, f, 3);
    const int plane = __shfl_sync(kFull, f, 4);
    jb.do_filter = __shfl_sync(kFull, f, 5);
    const uint64_t w0 = (uint32_t)__shfl_sync(kFull, f, 6) & 0xFFFFu;
    const uint64_t w1 = (uint32_t)__shfl_sync(kFull, f, 7) & 0xFFFFu;
    jb.angle = __shfl_sync(kFull, f, 8);
    jb.inv = __shfl_sync(kFull, f, 9);
    jb.strong = __shfl_sync(kFull, f, 10);
    jb.edge = __shfl_sync(kFull, f, 12);
    const uint64_t hi = (uint32_t)__shfl_sync(kFull, f, 13) & 1u;
    jb.w = (w0 | (w1 << 16) | (hi << 32)) & ((2ull << (4 << jb.sl)) - 1);
    if (plane == 0) {
        jb.buf = pl.luma;
        jb.res = pl.res_l;
        jb.ws = pl.wl;
    } else {
        const size_t off = (size_t)(plane - 1) * pl.hc * pl.wc;
        jb.buf = pl.chroma + off;
        jb.res = pl.res_c + off;
        jb.ws = pl.wc;
    }
    return jb;
}

// availability group of spec reference sample i (layout: left 2s samples
// bottom->top | corner | top 2s samples), and the first / last sample of
// group g in that order (the corner group holds one sample)
__device__ __forceinline__ int group_of(int i, int s) {
    if (i < 2 * s) return i >> 2;
    if (i == 2 * s) return s >> 1;
    return (s >> 1) + 1 + ((i - 2 * s - 1) >> 2);
}

__device__ __forceinline__ int first_pos(int g, int s) {
    const int h = s >> 1;
    if (g < h) return 4 * g;
    if (g == h) return 2 * s;
    return 2 * s + 1 + 4 * (g - h - 1);
}

__device__ __forceinline__ int last_pos(int g, int s) {
    const int h = s >> 1;
    return g == h ? 2 * s : first_pos(g, s) + 3;
}

// This warp's share (`part` of T) of one job of size 4 << SL. `ready()`
// is called once the residual loads are under way and before the first
// neighbour is read: the scheduler waits for the job's level there. A
// warp without a pass returns at once, without calling it.
template <int SL, int T, class Ready>
__device__ __forceinline__ void intra_job(const Job& jb, int bd, Scratch& sc,
                                          int lane, int part,
                                          const Ready& ready) {
    constexpr int s = 4 << SL, log2s = 2 + SL;
    constexpr int nref = 4 * s + 1;
    constexpr int kRefPasses = (nref + kWarp - 1) / kWarp;
    constexpr int kAllPasses = (s * s + kWarp - 1) / kWarp;
    constexpr int kPasses = (kAllPasses + T - 1) / T;   // of this warp
    if (part >= kAllPasses) return;
    const int mode = jb.mode;
    const int y = jb.y, x = jb.x, ws = jb.ws;
    const int maxv = (1 << bd) - 1;
    const uint64_t w = jb.w;
    int32_t* buf = jb.buf;

    // ---- residual: depends on nothing the kernel writes ---------------------
    int res[kPasses];
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
        const int t = lane + (part + k * T) * kWarp;
        res[k] = t < s * s
            ? __ldg(jb.res + (size_t)(y + (t >> log2s)) * ws + x +
                    (t & (s - 1)))
            : 0;
    }
    ready();

    // ---- gather (L2 only: another SM wrote these samples) -----------------
    int raw[kRefPasses];
#pragma unroll
    for (int k = 0; k < kRefPasses; ++k) {
        const int i = lane + k * kWarp;
        size_t o;
        if (i < 2 * s) o = (size_t)(y + 2 * s - 1 - i) * ws + x - 1;
        else o = (size_t)(y - 1) * ws + x - 1 + (i - 2 * s);
        raw[k] = i < nref ? __ldcg(buf + o) : 0;
    }
#pragma unroll
    for (int k = 0; k < kRefPasses; ++k) {
        const int i = lane + k * kWarp;
        if (i < nref) sc.raw[i] = raw[k];
    }
    __syncwarp();

    // ---- substitution (8.4.4.2.2) ------------------------------------------
#pragma unroll
    for (int k = 0; k < kRefPasses; ++k) {
        const int i = lane + k * kWarp;
        if (i >= nref) break;
        int v;
        if (w == 0) {
            v = 1 << (bd - 1);
        } else {
            const int g = group_of(i, s);
            if ((w >> g) & 1) {
                v = raw[k];
            } else {
                const uint64_t before = w & ((1ull << g) - 1);
                v = before
                    ? sc.raw[last_pos(63 - __clzll((long long)before), s)]
                    : sc.raw[first_pos(__ffsll((long long)w) - 1, s)];
            }
        }
        sc.sub[i] = v;
    }
    __syncwarp();

    // ---- filtering (8.4.4.2.3) --------------------------------------------
    bool bilinear = false;
    if (s == 32 && jb.do_filter && jb.strong) {
        const int c = sc.sub[64], r0 = sc.sub[0], rn = sc.sub[128];
        const int th = 1 << (bd - 5);
        bilinear = abs(c + rn - 2 * sc.sub[96]) < th &&
                   abs(c + r0 - 2 * sc.sub[32]) < th;
    }
#pragma unroll
    for (int k = 0; k < kRefPasses; ++k) {
        const int i = lane + k * kWarp;
        if (i >= nref) break;
        int v = sc.sub[i];
        if (bilinear) {
            const int c = sc.sub[64];
            if (i > 64 && i < 128) {
                const int q = i - 65;
                v = ((63 - q) * c + (q + 1) * sc.sub[128] + 32) >> 6;
            } else if (i >= 1 && i < 64) {
                const int q = 63 - i;
                v = ((63 - q) * c + (q + 1) * sc.sub[0] + 32) >> 6;
            }
        } else if (jb.do_filter && i >= 1 && i < nref - 1) {
            v = (sc.sub[i - 1] + 2 * v + sc.sub[i + 1] + 2) >> 2;
        }
        sc.flt[i] = v;
    }
    __syncwarp();

    // left[k] = p[-1][k] (top->bottom), top[k] = p[k][-1]
#define LEFT(k) sc.flt[2 * s - 1 - (k)]
#define TOP(k) sc.flt[2 * s + 1 + (k)]
    const int corner = sc.flt[2 * s];
    const bool ver = mode >= 18;
    const int angle = jb.angle;

    // ---- angular reference with negative-angle projection -----------------
    if (mode >= 2) {
#pragma unroll
        for (int k = 0; k < (3 * s + 2 + kWarp - 1) / kWarp; ++k) {
            const int i = lane + k * kWarp;
            if (i >= 3 * s + 2) break;
            int v = 0;
            if (i == s) {
                v = corner;
            } else if (i > s && i <= 3 * s) {
                v = ver ? TOP(i - s - 1) : LEFT(i - s - 1);
            } else if (i < s && angle < 0) {
                const int q = s - 1 - i;
                const int p = clampi(-1 + ((-(q + 1) * jb.inv + 128) >> 8),
                                     0, 2 * s - 1);
                v = ver ? LEFT(p) : TOP(p);
            }
            sc.rr[i] = v;
        }
        __syncwarp();
    }

    int dc = 0;
    if (mode == 1) {           // s <= 32: one lane per top / left pair
        const int v = lane < s ? TOP(lane) + LEFT(lane) : 0;
        dc = (__reduce_add_sync(kFull, v) + s) >> (log2s + 1);
    }

    // ---- predict + residual + clip + store ----------------------------------
    const bool edge = jb.edge != 0;
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
        const int t = lane + (part + k * T) * kWarp;
        if (t >= s * s) break;
        const int yy = t >> log2s, xx = t & (s - 1);
        int p;
        if (mode == 0) {
            p = ((s - 1 - xx) * LEFT(yy) + (xx + 1) * TOP(s) +
                 (s - 1 - yy) * TOP(xx) + (yy + 1) * LEFT(s) + s) >>
                (log2s + 1);
        } else if (mode == 1) {
            p = dc;
            if (edge) {
                if (xx == 0 && yy == 0)
                    p = (LEFT(0) + 2 * dc + TOP(0) + 2) >> 2;
                else if (yy == 0)
                    p = (TOP(xx) + 3 * dc + 2) >> 2;
                else if (xx == 0)
                    p = (LEFT(yy) + 3 * dc + 2) >> 2;
            }
        } else {
            const int a = ver ? yy : xx;   // step along the side
            const int b = ver ? xx : yy;   // position along main
            const int prod = (a + 1) * angle;
            const int idx = prod >> 5, fact = prod & 31;
            p = ((32 - fact) * sc.rr[s + b + idx + 1] +
                 fact * sc.rr[s + b + idx + 2] + 16) >> 5;
            if (edge && mode == 26 && xx == 0)
                p = clampi(TOP(0) + ((LEFT(yy) - corner) >> 1), 0, maxv);
            if (edge && mode == 10 && yy == 0)
                p = clampi(LEFT(0) + ((TOP(xx) - corner) >> 1), 0, maxv);
        }
        __stcg(buf + (size_t)(y + yy) * ws + x + xx,
               clampi(p + res[k], 0, maxv));
    }
#undef LEFT
#undef TOP
    __syncwarp();
}

// This warp's share of one job of any size.
template <int T, class Ready>
__device__ __forceinline__ void intra_job_any(const Job& jb, int bd,
                                              Scratch& sc, int lane,
                                              int part, const Ready& ready) {
    switch (jb.sl) {
    case 0: intra_job<0, T>(jb, bd, sc, lane, part, ready); break;
    case 1: intra_job<1, T>(jb, bd, sc, lane, part, ready); break;
    case 2: intra_job<2, T>(jb, bd, sc, lane, part, ready); break;
    default: intra_job<3, T>(jb, bd, sc, lane, part, ready); break;
    }
}

}  // namespace intra
