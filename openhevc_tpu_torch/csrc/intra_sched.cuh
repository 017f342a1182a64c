// The level-parallel scheduler of the fused intra kernels: every intra
// TU of a frame in ONE launch, the jobs of one wavefront level running
// side by side across the card, with no per-level dispatch from the
// host. Shared by csrc/intra_fused.cu and csrc/intra_fused_banded.cu;
// the per-TU body is csrc/intra_job.cuh.
//
// What bounds the kernels on this card is the dependency chain: a TU
// reads the reconstruction of its left and top neighbours, so a frame's
// jobs form n_levels wavefront levels (595 on an 832x480 frame, 3,050 on
// a 4K frame) of, on average, 15 to 48 independent jobs. The bytes
// (meta + residual read + reconstruction written once) would take
// microseconds. So the floor is n_levels x (one level hand-over + the
// level's longest job), and the design spends everything on making
// both short.
//
// Design. The jobs come with a level schedule: `order` [n] lists them
// by level (stable, so decode or band order inside a level) and
// `level_bounds` [n_levels + 1] rises from 0 to n; level L (1-based)
// holds order[level_bounds[L-1] .. level_bounds[L]). Level 0 is "already
// in the planes" (PCM samples today, inter blocks later) and holds no
// job. A persistent cooperative grid (co-residency guaranteed by
// cudaLaunchCooperativeKernel) is cut into teams of kTeam warps of one
// block, and every team has a fixed slot: job i of a level goes to slot
// i mod nteams, slots numbered block-first so that a level's jobs
// spread over the SMs. A team therefore knows its jobs from
// level_bounds alone: no ticket, no queue. Inside a team the warps
// share a job's store passes (csrc/intra_job.cuh) and meet at a named
// barrier (bar.sync on the team's warps only) when the job is done.
//
// The hand-over is a soft barrier on one counter, `done` = jobs
// finished so far. Before its first job of level L a warp waits until
// done >= level_bounds[L-1] (lane 0 spins on ld.acquire.gpu); after the
// team's jobs of the level its leader fences and adds their number
// (release). Nobody waits to ARRIVE: a team with no job in a level does
// not touch the counter and runs ahead to its next level, where it
// loads its job's meta and residual BEFORE it waits, so that only the
// neighbour gather, the arithmetic and the store sit on the chain.
// Jobs of one level never read what another job of that level writes
// (an available neighbour is of a strictly lower level), so nothing
// else orders them. Measured on an H100 (tools/bench_intra_barriers.py):
// a level costs 2.4-2.9 us, of which this hand-over alone (no job body)
// is 1.2-1.4 us and the level's longest job the rest; grid.sync() or an
// all-blocks arrive counter after every level cost 0.4-0.6 us a level
// more, and a single cluster's hardware barrier more still on a 4K
// frame, whose levels are wider than a cluster's teams.
//
// Memory order. A job's samples are stored st.global.cg; the team's
// warps meet at their barrier, then the leader lane fences
// (__threadfence, cumulative over what the barrier ordered before it)
// and adds to `done`. The waiting lane 0 reads `done` with
// ld.acquire.gpu and syncs its warp; the gather then reads L2
// (ld.global.cg), never a stale L1 line.
//
// Indices from the schedule are clamped into [0, n], so malformed
// order / level_bounds give wrong samples, never a wild access.

#pragma once

#include "intra_job.cuh"

namespace intra {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * kWarp;
constexpr int kTeam = 4;           // warps that share a job

struct Schedule {
    const int32_t* meta;           // [16, npad]
    int npad, n;
    const int32_t* order;          // [n]
    const int32_t* level_bounds;   // [n_levels + 1]
    int n_levels;
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

// Barrier over the T warps of this thread's team (team k of the block
// uses hardware barrier 1 + k; 0 is __syncthreads's).
template <int T>
__device__ __forceinline__ void team_sync() {
    if (T == 1) {
        __syncwarp();
    } else {
        const int id = 1 + threadIdx.x / (T * kWarp);
        asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(T * kWarp)
                     : "memory");
    }
}

// The soft barrier: wait(target) until `done` jobs >= target, by a
// warp; arrive(k) after its team finished k jobs of a level, by every
// thread, after the team's barrier.
struct DoneCount {
    unsigned* done;

    __device__ __forceinline__ void wait(int target, int lane) const {
        if (lane == 0 && target > 0)
            while ((int)ld_acquire(done) < target) {}
        __syncwarp();
    }

    __device__ __forceinline__ void arrive(int k, bool leader) const {
        if (leader && k > 0) {
            __threadfence();
            atomicAdd(done, (unsigned)k);
        }
    }
};

// Run every level with teams of T warps. Sync: wait(jobs that must be
// done, lane) by each warp before its first neighbour read of a level;
// arrive(jobs the team ran, is the team's leader lane) by every thread
// for every level, after the team's barrier.
template <int T, class Sync>
__device__ __forceinline__ void run_levels(const Schedule& sd,
                                           const Planes& pl, int bd,
                                           Scratch& sc, const Sync& sync) {
    static_assert(kWarpsPerBlock % T == 0, "teams tile the block");
    const int lane = threadIdx.x & (kWarp - 1);
    const int part = (threadIdx.x / kWarp) % T;
    const int nteams = gridDim.x * (kWarpsPerBlock / T);
    const int slot = (threadIdx.x / (T * kWarp)) * gridDim.x + blockIdx.x;
    int lo = 0;
    for (int lv = 1; lv <= sd.n_levels; ++lv) {
        const int hi = clampi(__ldg(sd.level_bounds + lv), lo, sd.n);
        int mine = 0;
        bool waited = false;
        for (int t = lo + slot; t < hi; t += nteams) {
            const int j = clampi(__ldg(sd.order + t), 0, sd.n - 1);
            const Job jb = load_job(sd.meta, sd.npad, j, pl, lane);
            intra_job_any<T>(jb, bd, sc, lane, part, [&] {
                if (!waited) sync.wait(lo, lane);
                waited = true;
            });
            ++mine;
        }
        if (mine) team_sync<T>();
        sync.arrive(mine, part == 0 && lane == 0);
        lo = hi;
    }
}

// The same body walked by ONE warp over jobs 0..n-1 in meta order (decode
// order, or band order on band-sorted meta). For checking only: it is
// the yardstick that shows level order == decode order on the card.
__device__ __forceinline__ void run_serial(const int32_t* meta, int npad,
                                           int n, const Planes& pl, int bd,
                                           Scratch& sc) {
    const int lane = threadIdx.x & (kWarp - 1);
    for (int j = 0; j < n; ++j) {
        const Job jb = load_job(meta, npad, j, pl, lane);
        intra_job_any<1>(jb, bd, sc, lane, 0, [] {});
    }
}

// ---- host side ------------------------------------------------------------

// Blocks of `kernel` (kThreads threads, static shared memory only) that
// are co-resident on the current device; returns the cudaError_t.
template <class K>
int max_coresident_blocks(K kernel, int* blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    *blocks = sms * per_sm;
    return (int)e;
}

}  // namespace intra
