// Hopper kernel for one chunk of DAVIS lane sub-steps (sm_90a): K4.
//
// Replaces the TPU kernel adder_tpu/ops/fused_resident.py::make_resident_call
// in its DAVIS mode (dvs="davis"; make_davis_chunk_resident_compact :1361,
// reached through make_davis_chunk_resident_packed :1411; the DAVIS body of
// _kernel_body :268-300). The DAVIS source (davis.rs:235-465) plans the DVS
// events of a packet into lanes, lane k holding each pixel's k-th event, and
// each lane is ONE sub-step: pop_top, integrate the held intensity over the
// gap, pop_top, then the contrast stage (pop_best, base_val, set_d) against
// the post-ln-step frame value. A chunk is T <= 128 lanes over the whole
// plane, in Continuous mode, AbsoluteT, at arena depth 16 (K = 19 event
// slots per sub-step, in the order d0, d8, pop_best x 16, d7). Per sub-step
// and pixel the inputs are four (T, n) planes: first_int f32, dt_ticks f32,
// fval f32 and fv8 | active << 8 i32. The plain PyTorch version it is held
// against is adder_tpu_torch/ops/fused_resident.py::davis_chunk_resident_plain.
//
// Design. K3's (dvs_resident.cu), with the DAVIS step of adder_interval.cuh
// (run_davis_event) in place of run_interval: one thread per pixel, the
// depth-16 arena in registers across all T sub-steps, COUNT ->
// adder_exclusive_scan -> WRITE writing events in (sub-step, raster pixel,
// slot) order, VOID for the Empty sink. An inactive pixel skips the sub-step
// (the TPU kernel computes it and restores every field; the on-card check
// holds the skip against the plain version's literal restore). The c_thresh
// increment (u32(dt_ticks) // ref_time) % 256 is per pixel. Only what the
// path runs is instantiated: depth 16 x Continuous x AbsoluteT x {Normal,
// Collapse} x {COUNT, WRITE, VOID} = 6 kernels.
//
// What bounds it. A DAVIS346 sub-step has a few hundred active pixels of
// 89,960, so most threads read one word of fvw and move on, and a warp runs
// the full state machine whenever one of its 32 pixels is active. What the
// data needs is small: 20 bytes per active cell (the carrier row) plus the
// state of the active pixels (347 bytes each at depth 16), read once and
// written once. The kernel moves far more: the fvw word of every cell (46 MB
// for T = 128) and the state of all 89,960 pixels, once per pass, and it
// diverges; it is not bound by arithmetic. The depth-16 arena and the 19
// slot pairs of the WRITE pass press on the register limit of
// __launch_bounds__(256); ptxas -v reports any spill. Walking each pixel's
// own rows instead of dense planes would remove the plane scatter and most
// of the reads.

#include "adder_interval.cuh"

namespace {

constexpr int kDavisDepth = 16;

}  // namespace

extern "C" {

int adder_davis_chunk(const AdderChunkArgs* a, void* stream) {
  if (!chunk_args_ok(a) || a->dvs != SRC_DAVIS || a->depth != kDavisDepth ||
      a->runnings != nullptr || a->mode != 1 || a->abs_time != 1 ||
      a->inten == nullptr || a->tspan == nullptr || a->fvw == nullptr ||
      a->fval == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const KArgs k = make_kargs(a);
  cudaStream_t st = (cudaStream_t)stream;
  if (a->multi_mode == 1) {
    launch_pass<kDavisDepth, false, true, true, SRC_DAVIS>(k, a->pass, st);
  } else {
    launch_pass<kDavisDepth, false, false, true, SRC_DAVIS>(k, a->pass, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
