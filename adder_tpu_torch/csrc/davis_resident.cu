// Hopper kernel for one chunk of DAVIS lane sub-steps (sm_90a): K4, by rows.
//
// Replaces the TPU kernel adder_tpu/ops/fused_resident.py::make_resident_call
// in its DAVIS mode (dvs="davis"; make_davis_chunk_resident_compact :1361,
// reached through make_davis_chunk_resident_packed :1411; the DAVIS body of
// _kernel_body :268-300). The DAVIS source (davis.rs:235-465) plans the DVS
// events of a packet into lanes, lane k holding each pixel's k-th event, and
// each lane is ONE sub-step: pop_top, integrate the held intensity over the
// gap, pop_top, then the contrast stage (pop_best, base_val, set_d) against
// the post-ln-step frame value. A chunk is T <= 128 lanes, in Continuous
// mode, AbsoluteT, at arena depth 16 (K = 19 event slots per sub-step, in
// the order d0, d8, pop_best x 16, d7). The input of adder_davis_rows is the
// (5, E) i32 carrier itself, the input of make_davis_chunk_resident_packed
// (pack_davis_plan: pix | lane << 20 | active << 27, fv8, the bits of
// first_int, dt_ticks and fval): one row per (lane, pixel) that has an
// event, and no plane is made. The plain PyTorch version it is held against
// is adder_tpu_torch/ops/fused_resident.py::davis_rows_resident_plain (the
// carrier scattered into dense (T, N) planes and run through
// davis_chunk_resident_plain).
//
// What bounds it. A DAVIS346 sub-step has a few hundred active pixels of
// 89,960. What the data needs is small: 20 bytes per carrier row, the state
// of the pixels that have rows (347 bytes each at depth 16) read once and
// written once, 8 bytes per event: a few microseconds. The work is the
// state machine: a few hundred dependent scalar operations per sub-step, run
// serially along each pixel's rows, so the pixel with the most events in
// the chunk sets the floor.
//
// Design. The DVS row walk of dvs_resident.cu (adder_lane_rows_kernel in
// adder_interval.cuh, SRC_DAVIS), with the DAVIS step run_davis_rows in
// place of run_interval, one sub-step per row:
//   - the grouping glue is the DVS one with one sub-step per lane
//     (fused_resident.group_dvs_rows(..., per_lane=1)): the rows of each
//     pixel in lane order, and for each row its cell, its rank among the
//     rows in (lane, raster pixel) order; so the events leave in
//     (sub-step, raster pixel, slot) order through one walk that stages
//     each cell's events in its own 19 slots, adder_exclusive_scan of the
//     cell counts and adder_rows_copy (dvs_resident.cu); the void walk for
//     the Empty sink stages nothing;
//   - one thread per pixel that has rows walks that pixel's rows only, once;
//     each event is written to its cell's slots as it is produced; an
//     inactive row counts 0 events and leaves the state alone (the
//     reference computes it and restores every field; the plain version's
//     literal restore holds the skip to that);
//   - the c_thresh increment (u32(dt_ticks) // ref_time) % 256 is per row;
//     every f32 operation is an _rn intrinsic (--fmad=false as well);
//   - pop_best and integrate follow the arena's length, as in K3;
//   - the state is updated in place, for the pixels that have rows only.
// Only what the path runs is instantiated: depth 16 x Continuous x AbsoluteT
// x {Normal, Collapse} x {events staged, void} = 4 kernels; ptxas -v
// reports their registers and any spill.

#include "adder_interval.cuh"

extern "C" {

int adder_davis_rows(const AdderRowsArgs* a, void* stream) {
  return launch_rows<SRC_DAVIS>(a, stream);
}

}  // extern "C"
