// Banded fused intra reconstruction for Hopper (sm_90a): every intra TU
// of a large frame in ONE launch, the jobs of each wavefront level side
// by side.
//
// Replaces the TPU kernel openhevc_tpu/ops/intra_fused.py::_build_banded
// (pallas_call at :627; per-TU body `_job` :230-445). Same inputs: the
// job meta [16, npad] stably pre-sorted by CTB-row band
// (ops/intra_fused.py::sort_meta_by_band) and the planes at band_plan's
// dims. Same output as _build_banded, which is the same as _build's.
//
// What carries over and what does not. On the TPU the planes sit in HBM
// and each band (8-row halo + band + 64-row pad) is DMA'd through VMEM,
// bands strictly in order. Here a 4K band with halo and pad is
// (8+64+64)*4224*4 B = 2.3 MB of luma recon alone, ten times an SM's
// shared memory, so the planes stay in global memory / the 50 MB L2 and
// nothing is staged. And the bands must NOT be walked in order: a band's
// own wavefront is over a thousand levels long at 4K, 34 bands of it
// would multiply the chain, and the level of a job already encodes every
// dependency, the above-right one across a CTB-row boundary included.
// What carries over is the band as the tie-break of the level order
// (key: level, then band, then decode order: a stable sort by level of
// the band-sorted meta), which keeps a level's neighbouring jobs close
// together in L2.
//
// What bounds it on this card: the frame-wide wavefront chain (~3,050
// levels on a 4K frame), not the ~109 MB of meta, residual and
// reconstruction (~33 us at 3.35 TB/s). The level-parallel scheduler of
// csrc/intra_sched.cuh runs a level's jobs on as many teams of warps
// across the SMs and hands over through one counter in global memory
// (design and memory order: see there; per-TU body:
// csrc/intra_job.cuh).
//
// The planes are updated in place; the kernel allocates nothing (`done`
// is the caller's zeroed counter).

#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_sched.cuh"

namespace {

__global__ void __launch_bounds__(intra::kThreads)
intra_fused_banded_kernel(intra::Schedule sd, intra::Planes pl, int bd,
                          unsigned* done) {
    __shared__ intra::Scratch sc[intra::kWarpsPerBlock];
    intra::run_levels<intra::kTeam>(sd, pl, bd,
                                    sc[threadIdx.x / intra::kWarp],
                                    intra::DoneCount{done});
}

}  // namespace

// Blocks that may be launched (all co-resident); returns the cudaError_t.
extern "C" int intra_fused_banded_max_grid(int* blocks) {
    return intra::max_coresident_blocks(intra_fused_banded_kernel, blocks);
}

// Cooperative launch on `grid` blocks; returns the cudaError_t (a grid
// larger than what is co-resident is refused by the runtime).
extern "C" int intra_fused_banded_launch(const void* meta, int npad, int n,
                                         const void* order,
                                         const void* level_bounds,
                                         int n_levels, void* done, int grid,
                                         void* luma, int wl, void* chroma,
                                         int hc, int wc, const void* res_l,
                                         const void* res_c, int bd,
                                         void* stream) {
    intra::Schedule sd{(const int32_t*)meta, npad, n, (const int32_t*)order,
                       (const int32_t*)level_bounds, n_levels};
    intra::Planes pl{(int32_t*)luma, wl, (int32_t*)chroma, hc, wc,
                     (const int32_t*)res_l, (const int32_t*)res_c};
    unsigned* d = (unsigned*)done;
    void* args[] = {&sd, &pl, &bd, &d};
    return (int)cudaLaunchCooperativeKernel(
        (const void*)intra_fused_banded_kernel, dim3(grid),
        dim3(intra::kThreads), args, 0, (cudaStream_t)stream);
}
