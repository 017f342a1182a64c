// Fused intra reconstruction for Hopper (sm_90a): every intra TU of a
// frame in ONE launch, the jobs of each wavefront level side by side.
//
// Replaces the TPU kernel openhevc_tpu/ops/intra_fused.py::_build (the
// whole-frame Pallas kernel, pallas_call at :490; per-TU body `_job`
// :230-445). Same meta [16, npad] in decode order, same padded plane
// layout, bit-exact with openhevc_tpu/ops/intra_np.py (H.265 8.4.4.2.2
// substitution, 8.4.4.2.3 filtering, planar / DC / angular prediction).
//
// What bounds it on this card: not the bytes (a few MB per 832x480
// frame, microseconds at 3.35 TB/s) but the wavefront chain of the
// frame, n_levels dependent steps. The Pallas kernel walks the jobs one
// by one on the TPU's single core; here the level-parallel scheduler of
// csrc/intra_sched.cuh runs a level's jobs on as many teams of warps
// across the SMs and hands over from level to level through one counter
// in global memory, inside the one launch (design and memory order: see
// there; the per-TU body, run by the warps of a team:
// csrc/intra_job.cuh).
//
// This file also holds the serial-order entry kept for checking: one
// warp walks the jobs in meta order with the same body.
//
// The planes are updated in place; the kernels allocate nothing (`done`
// is the caller's zeroed counter).

#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_sched.cuh"

namespace {

__global__ void __launch_bounds__(intra::kThreads)
intra_fused_kernel(intra::Schedule sd, intra::Planes pl, int bd,
                   unsigned* done) {
    __shared__ intra::Scratch sc[intra::kWarpsPerBlock];
    intra::run_levels<intra::kTeam>(sd, pl, bd,
                                    sc[threadIdx.x / intra::kWarp],
                                    intra::DoneCount{done});
}

__global__ void __launch_bounds__(intra::kWarp)
intra_fused_serial_kernel(const int32_t* meta, int npad, int n,
                          intra::Planes pl, int bd) {
    __shared__ intra::Scratch sc;
    intra::run_serial(meta, npad, n, pl, bd, sc);
}

}  // namespace

// Blocks that may be launched (all co-resident); returns the cudaError_t.
extern "C" int intra_fused_max_grid(int* blocks) {
    return intra::max_coresident_blocks(intra_fused_kernel, blocks);
}

// Cooperative launch on `grid` blocks; returns the cudaError_t (a grid
// larger than what is co-resident is refused by the runtime).
extern "C" int intra_fused_launch(const void* meta, int npad, int n,
                                  const void* order,
                                  const void* level_bounds, int n_levels,
                                  void* done, int grid, void* luma, int wl,
                                  void* chroma, int hc, int wc,
                                  const void* res_l, const void* res_c,
                                  int bd, void* stream) {
    intra::Schedule sd{(const int32_t*)meta, npad, n, (const int32_t*)order,
                       (const int32_t*)level_bounds, n_levels};
    intra::Planes pl{(int32_t*)luma, wl, (int32_t*)chroma, hc, wc,
                     (const int32_t*)res_l, (const int32_t*)res_c};
    unsigned* d = (unsigned*)done;
    void* args[] = {&sd, &pl, &bd, &d};
    return (int)cudaLaunchCooperativeKernel(
        (const void*)intra_fused_kernel, dim3(grid), dim3(intra::kThreads),
        args, 0, (cudaStream_t)stream);
}

// One warp, jobs 0..n-1 in meta order; returns the cudaError_t.
extern "C" int intra_fused_serial_launch(const void* meta, int npad, int n,
                                         void* luma, int wl, void* chroma,
                                         int hc, int wc, const void* res_l,
                                         const void* res_c, int bd,
                                         void* stream) {
    const intra::Planes pl{(int32_t*)luma, wl, (int32_t*)chroma, hc, wc,
                           (const int32_t*)res_l, (const int32_t*)res_c};
    intra_fused_serial_kernel<<<1, intra::kWarp, 0, (cudaStream_t)stream>>>(
        (const int32_t*)meta, npad, n, pl, bd);
    return (int)cudaGetLastError();
}
