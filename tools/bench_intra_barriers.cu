// Level hand-over variants for the port's fused intra kernels, for
// tools/bench_intra_barriers.py only (no decode path loads this file).
//
// The shipped kernels (openhevc_tpu_torch/csrc/intra_fused.cu,
// intra_fused_banded.cu) hand over from wavefront level to level through
// the done-count soft barrier of csrc/intra_sched.cuh. This file runs
// the SAME scheduler and per-TU body with the hand-over swapped for the
// alternatives it was chosen against, and with other team sizes (warps
// that share a job), so that each can be timed on the same frame:
//   0  done-count soft barrier (intra::DoneCount, the one shipped),
//      teams of `team` = 1, 2, 4 or 8 warps
//   1  cooperative_groups grid.sync() after every level
//   2  hand-rolled grid barrier: every block arrives on one counter and
//      waits for all blocks, after every level
//   3  one thread-block cluster (hardware barrier.cluster after every
//      level); a level wider than the cluster's teams loops
//   4  the shipped hand-over with NO job body: a team still loads its
//      job's meta, waits for its level, meets at its barrier and adds
//      to the counter, so the time is what a level costs before any
//      sample is predicted (the planes are left untouched)
// Variants 1-4 use the shipped team size (intra::kTeam).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_sched.cuh"

namespace cg = cooperative_groups;

namespace {

struct GridSync {
    __device__ __forceinline__ void wait(int, int) const {}
    __device__ __forceinline__ void arrive(int, bool) const {
        cg::this_grid().sync();
    }
};

struct ArriveCounter {
    unsigned* count;
    mutable unsigned epoch = 0;
    __device__ __forceinline__ void wait(int, int) const {}
    __device__ __forceinline__ void arrive(int, bool) const {
        ++epoch;
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0) {
            atomicAdd(count, 1u);
            while (intra::ld_acquire(count) < epoch * gridDim.x) {}
        }
        __syncthreads();
    }
};

struct ClusterSync {
    __device__ __forceinline__ void wait(int, int) const {}
    __device__ __forceinline__ void arrive(int, bool) const {
        __threadfence();
        cg::this_cluster().sync();
    }
};

template <int T, class Sync>
__device__ __forceinline__ void body(const intra::Schedule& sd,
                                     const intra::Planes& pl, int bd,
                                     const Sync& sync) {
    __shared__ intra::Scratch sc[intra::kWarpsPerBlock];
    intra::run_levels<T>(sd, pl, bd, sc[threadIdx.x / intra::kWarp], sync);
}

template <int T>
__global__ void __launch_bounds__(intra::kThreads)
k_done(intra::Schedule sd, intra::Planes pl, int bd, unsigned* c) {
    body<T>(sd, pl, bd, intra::DoneCount{c});
}
// intra::run_levels without intra_job_any
__global__ void __launch_bounds__(intra::kThreads)
k_handover(intra::Schedule sd, intra::Planes pl, int, unsigned* c) {
    constexpr int T = intra::kTeam;
    const intra::DoneCount sync{c};
    const int lane = threadIdx.x & (intra::kWarp - 1);
    const int part = (threadIdx.x / intra::kWarp) % T;
    const int nteams = gridDim.x * (intra::kWarpsPerBlock / T);
    const int slot = (threadIdx.x / (T * intra::kWarp)) * gridDim.x +
                     blockIdx.x;
    int lo = 0, sink = 0;
    for (int lv = 1; lv <= sd.n_levels; ++lv) {
        const int hi = intra::clampi(__ldg(sd.level_bounds + lv), lo, sd.n);
        int mine = 0;
        for (int t = lo + slot; t < hi; t += nteams) {
            const int j = intra::clampi(__ldg(sd.order + t), 0, sd.n - 1);
            sink += intra::load_job(sd.meta, sd.npad, j, pl, lane).mode;
            if (mine == 0 && part == 0) sync.wait(lo, lane);
            ++mine;
        }
        if (mine) intra::team_sync<T>();
        sync.arrive(mine, part == 0 && lane == 0);
        lo = hi;
    }
    if (sink == 0x7fffffff) atomicAdd(c, 1u);    // keep the meta loads
}

__global__ void __launch_bounds__(intra::kThreads)
k_grid(intra::Schedule sd, intra::Planes pl, int bd, unsigned*) {
    body<intra::kTeam>(sd, pl, bd, GridSync{});
}
__global__ void __launch_bounds__(intra::kThreads)
k_arrive(intra::Schedule sd, intra::Planes pl, int bd, unsigned* c) {
    body<intra::kTeam>(sd, pl, bd, ArriveCounter{c});
}
__global__ void __launch_bounds__(intra::kThreads)
k_cluster(intra::Schedule sd, intra::Planes pl, int bd, unsigned*) {
    body<intra::kTeam>(sd, pl, bd, ClusterSync{});
}

}  // namespace

// Co-resident blocks of the shipped shape (variant 0, team kTeam).
extern "C" int bench_max_grid(int* blocks) {
    return intra::max_coresident_blocks(k_done<intra::kTeam>, blocks);
}

// One launch of `variant` on `grid` blocks (variant 3: one cluster of
// `grid` blocks, at most 16) with teams of `team` warps (variant 0
// only); `counter` is a zeroed word. Returns the cudaError_t (a grid
// that is not co-resident is refused by the runtime).
extern "C" int bench_launch(int variant, int team, const void* meta, int npad, int n,
                            const void* order, const void* level_bounds,
                            int n_levels, void* counter, int grid,
                            void* luma, int wl, void* chroma, int hc, int wc,
                            const void* res_l, const void* res_c, int bd,
                            void* stream) {
    intra::Schedule sd{(const int32_t*)meta, npad, n, (const int32_t*)order,
                       (const int32_t*)level_bounds, n_levels};
    intra::Planes pl{(int32_t*)luma, wl, (int32_t*)chroma, hc, wc,
                     (const int32_t*)res_l, (const int32_t*)res_c};
    unsigned* c = (unsigned*)counter;
    if (variant == 3) {
        cudaError_t e = cudaFuncSetAttribute(
            k_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return (int)e;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(grid);
        cfg.blockDim = dim3(intra::kThreads);
        cfg.stream = (cudaStream_t)stream;
        cudaLaunchAttribute attr;
        attr.id = cudaLaunchAttributeClusterDimension;
        attr.val.clusterDim.x = grid;
        attr.val.clusterDim.y = 1;
        attr.val.clusterDim.z = 1;
        cfg.attrs = &attr;
        cfg.numAttrs = 1;
        return (int)cudaLaunchKernelEx(&cfg, k_cluster, sd, pl, bd, c);
    }
    const void* fn = variant == 1 ? (const void*)k_grid
                   : variant == 2 ? (const void*)k_arrive
                   : variant == 4 ? (const void*)k_handover
                   : team == 1 ? (const void*)k_done<1>
                   : team == 2 ? (const void*)k_done<2>
                   : team == 4 ? (const void*)k_done<4>
                               : (const void*)k_done<8>;
    void* args[] = {&sd, &pl, &bd, &c};
    return (int)cudaLaunchCooperativeKernel(fn, dim3(grid),
                                            dim3(intra::kThreads), args, 0,
                                            (cudaStream_t)stream);
}
