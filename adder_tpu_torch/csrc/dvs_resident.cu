// Hopper kernel for one chunk of DVS lane sub-steps (sm_90a): K3.
//
// Replaces the TPU kernel adder_tpu/ops/fused_resident.py::make_resident_call
// in its DVS mode (dvs=True; make_dvs_chunk_resident :1017, reached through
// _compact :1074, _packed :1159 and _packed8 :1214; kernel body
// _kernel_body :243-332). The Prophesee source (prophesee.rs:116-297) plans
// each window of events into lanes, lane k holding each pixel's k-th event;
// a lane runs as two sub-steps (the held intensity over the gap, then one
// source tick of the new intensity). A chunk is T = 2 x lanes <= 128
// sub-steps over the whole plane, in Continuous mode, AbsoluteT, at arena
// depth 16 (K = 19 event slots per sub-step). Per sub-step and pixel the
// inputs are three (T, n) planes: intensity f32, ticks spanned f32 and
// fv | active << 8 i32. The plain PyTorch version it is held against is
// adder_tpu_torch/ops/fused_resident.py::dvs_chunk_resident_plain.
//
// Design. The framed kernel's, with the interval fed from the planes: one
// thread per pixel, the depth-16 arena in registers across all T sub-steps,
// the same COUNT -> adder_exclusive_scan -> WRITE passes writing events in
// (sub-step, raster pixel, slot) order, and VOID for the Empty sink (see
// fused_resident.cu). What differs from the framed kernel:
//   - intensity, ticks spanned and fv are per pixel and per sub-step, so the
//     c_thresh increment (u32(time) // ref_time) % 256 is computed in the
//     kernel (integrate.py:606-609); gap spans reach gap_n x ref_time;
//   - an inactive pixel skips the sub-step. The TPU kernel computes every
//     pixel and then restores the inactive ones (every state field, every
//     slot masked, no overflow count: ovf_mask = active); skipping is the
//     same function, and the on-card check holds it against the plain
//     version's literal restore;
//   - only what the path runs is instantiated: depth 16 x Continuous x
//     AbsoluteT x {Normal, Collapse} x {COUNT, WRITE, VOID} = 6 kernels.
//
// What bounds it. Lanes are sparse: a typical sub-step has a few percent of
// the plane active, so most threads read one word of fvw and move on, and a
// warp runs the full state machine whenever one of its 32 pixels is active.
// What the data needs is small: 16 bytes per active cell (its pixel and
// three plane words) plus the state of the active pixels, read once and
// written once. The kernel moves far more: the fvw word of every cell (157
// MB for T = 128 at 640 x 480) and the state of every pixel, once per pass,
// and it diverges; it is not bound by arithmetic. The depth-16 arena (80
// values) and the 19 slot pairs of the WRITE pass press on the 255-register
// limit of __launch_bounds__(256); ptxas -v reports any spill. Walking each
// pixel's own rows instead of dense planes is the redesign that removes both
// the plane scatter and most of the reads.

#include "adder_interval.cuh"

namespace {

constexpr int kDvsDepth = 16;

}  // namespace

extern "C" {

int adder_dvs_chunk(const AdderChunkArgs* a, void* stream) {
  if (!chunk_args_ok(a) || a->dvs != SRC_DVS || a->depth != kDvsDepth ||
      a->mode != 1 || a->abs_time != 1 || a->inten == nullptr ||
      a->tspan == nullptr || a->fvw == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const KArgs k = make_kargs(a);
  cudaStream_t st = (cudaStream_t)stream;
  if (a->multi_mode == 1) {
    launch_pass<kDvsDepth, false, true, true, SRC_DVS>(k, a->pass, st);
  } else {
    launch_pass<kDvsDepth, false, false, true, SRC_DVS>(k, a->pass, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
