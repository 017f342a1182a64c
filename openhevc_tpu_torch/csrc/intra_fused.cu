// Fused intra reconstruction for Hopper (sm_90a): every intra TU of a
// frame, in decode order, in ONE launch.
//
// Replaces the TPU kernel openhevc_tpu/ops/intra_fused.py::_build (the
// whole-frame Pallas kernel, pallas_call at :490; per-TU body `_job`
// :230-445). Same inputs, same padded plane layout, bit-exact with
// openhevc_tpu/ops/intra_np.py (H.265 8.4.4.2.2 substitution, 8.4.4.2.3
// filtering, planar / DC / angular prediction).
//
// What bounds it on this card. The bytes are small: the kernel must read
// the job meta, the residual and the prefilled planes and write the
// reconstructed planes once, a few MB per 832x480 frame, i.e. a few
// microseconds at 3.35 TB/s. In practice the bound is the serial
// dependency chain: a TU reads the reconstructed samples of its left
// and top neighbours, so the ~10k jobs of a frame form n_levels
// wavefront levels (ij_meta column 6 of the native parser) that no
// amount of bandwidth shortens.
//
// Design for now: right and simple. One thread block walks the jobs in
// meta order (luma and chroma jobs interleave; they are never
// reordered). Per job the block gathers the 4s+1 reference samples into
// shared memory, substitutes unavailable ones (each thread resolves its
// own sample with bit scans over the 33-bit group word: no serial scan),
// filters, builds the angular projection, then predicts the s*s samples,
// adds the residual, clips and stores. A __syncthreads() after the store
// makes the job's writes visible to the next job's neighbour reads. The
// TPU workarounds of the Pallas kernel (one-hot MXU gathers, lane rolls,
// reversal matmuls, bf16 byte splits) become plain indexed loads.
// Making it fast -- one CTA per TU per wavefront level, folded into a
// persistent launch or a CUDA graph -- is later work (ROADMAP.md).
//
// The planes are updated in place; the kernel allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRef = 4 * 32 + 1;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
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

__global__ void __launch_bounds__(kThreads, 1)
intra_fused_kernel(const int32_t* __restrict__ meta, int npad, int n,
                   int32_t* luma, int wl, int32_t* chroma, int hc, int wc,
                   const int32_t* __restrict__ res_l,
                   const int32_t* __restrict__ res_c, int bd) {
    __shared__ int raw[kMaxRef];      // gathered neighbours, spec order
    __shared__ int sub[kMaxRef];      // after substitution
    __shared__ int flt[kMaxRef];      // after filtering
    __shared__ int rr[3 * 32 + 2];    // angular reference, offset s
    const int tid = threadIdx.x;
    const int maxv = (1 << bd) - 1;

    for (int j = 0; j < n; ++j) {
        const int y = meta[0 * npad + j];
        const int x = meta[1 * npad + j];
        const int sl = meta[2 * npad + j];
        const int mode = meta[3 * npad + j];
        const int plane = meta[4 * npad + j];
        const int do_filter = meta[5 * npad + j];
        const uint64_t w0 = (uint32_t)meta[6 * npad + j] & 0xFFFFu;
        const uint64_t w1 = (uint32_t)meta[7 * npad + j] & 0xFFFFu;
        const int angle = meta[8 * npad + j];
        const int inv = meta[9 * npad + j];
        const int strong = meta[10 * npad + j];
        const int edge = meta[12 * npad + j];
        const uint64_t hi = (uint32_t)meta[13 * npad + j] & 1u;
        const int s = 4 << sl;
        const int log2s = 2 + sl;
        const int nref = 4 * s + 1;
        const uint64_t w = (w0 | (w1 << 16) | (hi << 32)) &
                           ((2ull << s) - 1);        // s+1 group bits

        int32_t* buf = luma;
        const int32_t* res = res_l;
        int ws = wl;
        if (plane != 0) {
            const size_t off = (size_t)(plane - 1) * hc * wc;
            buf = chroma + off;
            res = res_c + off;
            ws = wc;
        }

        // ---- gather ------------------------------------------------------
        if (tid < nref) {
            size_t o;
            if (tid < 2 * s) o = (size_t)(y + 2 * s - 1 - tid) * ws + x - 1;
            else o = (size_t)(y - 1) * ws + x - 1 + (tid - 2 * s);
            raw[tid] = buf[o];
        }
        __syncthreads();

        // ---- substitution (8.4.4.2.2) --------------------------------------
        if (tid < nref) {
            int v;
            if (w == 0) {
                v = 1 << (bd - 1);
            } else {
                const int g = group_of(tid, s);
                if ((w >> g) & 1) {
                    v = raw[tid];
                } else {
                    const uint64_t before = w & ((1ull << g) - 1);
                    v = before
                        ? raw[last_pos(63 - __clzll((long long)before), s)]
                        : raw[first_pos(__ffsll((long long)w) - 1, s)];
                }
            }
            sub[tid] = v;
        }
        __syncthreads();

        // ---- filtering (8.4.4.2.3) ----------------------------------------
        if (tid < nref) {
            int v = sub[tid];
            if (do_filter) {
                bool bilinear = false;
                if (s == 32 && strong) {
                    const int c = sub[64], r0 = sub[0], rn = sub[128];
                    const int th = 1 << (bd - 5);
                    bilinear = abs(c + rn - 2 * sub[96]) < th &&
                               abs(c + r0 - 2 * sub[32]) < th;
                    if (bilinear) {
                        if (tid > 64 && tid < 128) {
                            const int k = tid - 65;
                            v = ((63 - k) * c + (k + 1) * rn + 32) >> 6;
                        } else if (tid >= 1 && tid < 64) {
                            const int k = 63 - tid;
                            v = ((63 - k) * c + (k + 1) * r0 + 32) >> 6;
                        }
                    }
                }
                if (!bilinear && tid >= 1 && tid < nref - 1)
                    v = (sub[tid - 1] + 2 * sub[tid] + sub[tid + 1] + 2) >> 2;
            }
            flt[tid] = v;
        }
        __syncthreads();

        // left[k] = p[-1][k] (top->bottom), top[k] = p[k][-1]
#define LEFT(k) flt[2 * s - 1 - (k)]
#define TOP(k) flt[2 * s + 1 + (k)]
        const int corner = flt[2 * s];
        const bool ver = mode >= 18;

        // ---- angular reference with negative-angle projection ---------------
        if (mode >= 2) {
            if (tid < 3 * s + 2) {
                int v = 0;
                if (tid == s) {
                    v = corner;
                } else if (tid > s && tid <= 3 * s) {
                    v = ver ? TOP(tid - s - 1) : LEFT(tid - s - 1);
                } else if (tid < s && angle < 0) {
                    const int k = s - 1 - tid;
                    const int p = clampi(-1 + ((-(k + 1) * inv + 128) >> 8),
                                         0, 2 * s - 1);
                    v = ver ? LEFT(p) : TOP(p);
                }
                rr[tid] = v;
            }
            __syncthreads();
        }

        int dc = 0;
        if (mode == 1) {
            int sum = s;
            for (int k = 0; k < s; ++k) sum += TOP(k) + LEFT(k);
            dc = sum >> (log2s + 1);
        }

        // ---- predict + residual + clip + store ------------------------------
        for (int t = tid; t < s * s; t += kThreads) {
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
                p = ((32 - fact) * rr[s + b + idx + 1] +
                     fact * rr[s + b + idx + 2] + 16) >> 5;
                if (edge && mode == 26 && xx == 0)
                    p = clampi(TOP(0) + ((LEFT(yy) - corner) >> 1), 0, maxv);
                if (edge && mode == 10 && yy == 0)
                    p = clampi(LEFT(0) + ((TOP(xx) - corner) >> 1), 0, maxv);
            }
            const size_t o = (size_t)(y + yy) * ws + x + xx;
            buf[o] = clampi(p + res[o], 0, maxv);
        }
#undef LEFT
#undef TOP
        __syncthreads();
    }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).
extern "C" int intra_fused_launch(const void* meta, int npad, int n,
                                  void* luma, int wl, void* chroma, int hc,
                                  int wc, const void* res_l,
                                  const void* res_c, int bd, void* stream) {
    if (n <= 0) return 0;
    intra_fused_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)meta, npad, n, (int32_t*)luma, wl,
        (int32_t*)chroma, hc, wc, (const int32_t*)res_l,
        (const int32_t*)res_c, bd);
    return (int)cudaGetLastError();
}
