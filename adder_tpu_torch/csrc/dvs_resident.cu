// Hopper kernels for one chunk of DVS lane sub-steps (sm_90a): K3, by two
// routes.
//
// Replaces the TPU kernel adder_tpu/ops/fused_resident.py::make_resident_call
// in its DVS mode (dvs=True; make_dvs_chunk_resident :1017, reached through
// _compact :1074, _packed :1159 and _packed8 :1214; kernel body
// _kernel_body :243-332). The Prophesee source (prophesee.rs:116-297) plans
// each window of events into lanes, lane k holding each pixel's k-th event;
// a lane runs as two sub-steps (the held intensity over the gap, then one
// source tick of the new intensity). A chunk is T = 2 x lanes <= 128
// sub-steps over the whole plane, in Continuous mode, AbsoluteT, at arena
// depth 16 (K = 19 event slots per sub-step). Both routes write the events
// in (sub-step, raster pixel, slot) order through COUNT -> scan -> WRITE
// (see fused_resident.cu), VOID for the Empty sink, and fold the largest
// per-cell event count and the depth flag into `flags`. Only what the path
// runs is instantiated: depth 16 x Continuous x AbsoluteT x {Normal,
// Collapse} x {COUNT, WRITE, VOID}, 6 kernels a route.
//
// adder_dvs_rows: the lane groups, which are sparse (about 1% of the
// (sub-step, pixel) cells of a T = 128 group are active). Its input is the
// (5, E) i32 carrier itself, the input of make_dvs_chunk_resident_packed
// (pack_dvs_plan: pix | lane << 20 | gap_on << 27 | tick_on << 28, the two
// fv bytes, the bits of gap_int, gap_time and tick_int), and it makes no
// plane. The plain PyTorch version it is held against is
// adder_tpu_torch/ops/fused_resident.py::dvs_rows_resident_plain.
//   What bounds it: not bytes (16 B per active cell, the state of the pixels
//   that have rows, 8 B per event: a few tens of microseconds) but the state
//   machine: a few hundred dependent scalar operations per sub-step, run
//   serially along each pixel's rows, so the longest pixel (up to 128
//   sub-steps) sets the floor, twice on the fetched path.
//   What the design does about it (adder_lane_rows_kernel in
//   adder_interval.cuh):
//   - glue on the card, without a host read (fused_resident.group_dvs_rows:
//     two sorts and the ranks of the cells): the rows of each pixel in lane
//     order, and for each row the rank of its gap cell and of its tick cell
//     among the 2 E cells in (sub-step, pixel) order;
//   - one thread per pixel that has rows: it gathers that pixel's state,
//     walks its rows only (no loop over T, no barrier, no word read for an
//     inactive cell) and writes each cell's event count at the cell's rank;
//     the exclusive scan over the 2 E counts then gives every cell its
//     offset, and WRITE repeats the walk and writes each cell's events
//     there. The state machine runs once per active cell, not once per warp
//     that holds one;
//   - the threads of a warp do not walk in step, so integrate's node walk
//     branches past its end (SKIP) instead of running all 16 nodes
//     predicated off; most arenas hold one to three nodes;
//   - the state is updated in place, for the pixels that have rows only;
//     COUNT writes none, so WRITE starts from the same state;
//   - blocks of 64 threads, so a block that holds a long pixel keeps few
//     others waiting; threads take the pixels in raster order, so gathers
//     of neighbours coalesce (longest pixel first was measured and lost);
//   - kept from the dense kernel: run_interval and every _rn intrinsic, the
//     per-sub-step c_thresh increment, the flags; the SRC template parameter
//     stays, so the DAVIS step can take the same walk.
//
// adder_dvs_chunk: the chunks that are dense by nature (the bootstrap, the
// end-of-stream flush, DAVIS's frame and gap chunks, T = 1 or 2, where most
// pixels are active). Per sub-step and pixel the inputs are three (T, n)
// planes: intensity f32, ticks spanned f32 and fv | active << 8 i32. The
// plain PyTorch version it is held against is
// adder_tpu_torch/ops/fused_resident.py::dvs_chunk_resident_plain. It is
// the framed kernel fed from the planes: one thread per pixel of the plane,
// the depth-16 arena in registers across all T sub-steps. What differs from
// the framed kernel:
//   - intensity, ticks spanned and fv are per pixel and per sub-step, so the
//     c_thresh increment (u32(time) // ref_time) % 256 is computed in the
//     kernel (integrate.py:606-609); gap spans reach gap_n x ref_time;
//   - an inactive pixel skips the sub-step. The TPU kernel computes every
//     pixel and then restores the inactive ones (every state field, every
//     slot masked, no overflow count: ovf_mask = active); skipping is the
//     same function, and the on-card check holds it against the plain
//     version's literal restore.
//   What bounds it: on a dense chunk the state of every pixel, read and
//   written once, and the planes. On a sparse lane group it reads the fvw
//   word of every cell and the state of every pixel and runs the state
//   machine for a whole warp whenever one of its 32 pixels is active, which
//   is why the lane groups no longer come here.
// The depth-16 arena (80 values) and the 19 slot pairs of the WRITE pass
// press on the 255-register limit in both routes; ptxas -v reports any
// spill.

#include "adder_interval.cuh"

namespace {

constexpr int kDvsDepth = 16;

// --- the grouping glue of the row route (fused_resident.group_dvs_rows; its
// plain version is group_dvs_rows_plain): three small kernels around two
// sorts and one exclusive scan, so a group costs a dozen launches and no
// host read. Keys: pix << 7 | lane sorts the rows by pixel, then lane;
// lane << 20 | pix (the carrier's own low 27 bits) ranks them in output
// order. ---------------------------------------------------------------------

constexpr int kGlueBlock = 256;

__global__ void __launch_bounds__(kGlueBlock)
    rows_keys_kernel(const int* __restrict__ meta, long long rows,
                     int* __restrict__ key_pl, int* __restrict__ key_lp) {
  const long long i = (long long)blockIdx.x * kGlueBlock + threadIdx.x;
  if (i < rows) {
    const int k = meta[i] & 0x7FFFFFF;
    key_lp[i] = k;
    key_pl[i] = ((k & 0xFFFFF) << 7) | (k >> 20);
  }
}

// First index of the sorted keys `a` that holds a value >= v.
__device__ __forceinline__ long long lower_bound(const int* a, long long n,
                                                 int v) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// skey: the sorted pix << 7 | lane keys; lkey, lorder: the sorted
// lane << 20 | pix keys and the rows they came from. Writes the run heads of
// skey (a pixel's first row) for the scan, each row's gap and tick cell, and
// the first cell of each of the T sub-steps, then 2 E. Lane k's rows are
// ranks [ls, le) of lkey: its gap cells are 2 ls + (rank - ls), its tick
// cells follow them.
__global__ void __launch_bounds__(kGlueBlock)
    rows_rank_kernel(const int* __restrict__ skey,
                     const int* __restrict__ lkey,
                     const long long* __restrict__ lorder, long long rows,
                     int T, int* __restrict__ head,
                     long long* __restrict__ cell_gap,
                     long long* __restrict__ cell_tick,
                     long long* __restrict__ sub_start) {
  const long long i = (long long)blockIdx.x * kGlueBlock + threadIdx.x;
  if (i < rows) {
    head[i] = i == 0 || (skey[i] >> 7) != (skey[i - 1] >> 7);
    const int lane = lkey[i] >> 20;
    const long long row = lorder[i];
    cell_gap[row] = i + lower_bound(lkey, rows, lane << 20);
    cell_tick[row] = i + lower_bound(lkey, rows, (lane + 1) << 20);
  }
  if (i < T) {
    const int lane = (int)(i >> 1);
    const long long ls = lower_bound(lkey, rows, lane << 20);
    const long long le = lower_bound(lkey, rows, (lane + 1) << 20);
    sub_start[i] = (i & 1) ? ls + le : 2 * ls;
  } else if (i == T) {
    sub_start[i] = 2 * rows;
  }
}

// pos: the exclusive scan of head, its total (the number of pixels that
// have rows) last. row_start[j] is the first sorted row of the j-th such
// pixel; every later entry, up to row_start[rows + 1], is `rows`.
__global__ void __launch_bounds__(kGlueBlock)
    rows_starts_kernel(const int* __restrict__ head,
                       const long long* __restrict__ pos, long long rows,
                       long long* __restrict__ row_start) {
  const long long i = (long long)blockIdx.x * kGlueBlock + threadIdx.x;
  if (i < rows && head[i]) row_start[pos[i]] = i;
  if (i >= pos[rows] && i <= rows + 1) row_start[i] = rows;
}

inline int glue_grid(long long threads) {
  return (int)((threads + kGlueBlock - 1) / kGlueBlock);
}

}  // namespace

extern "C" {

int adder_dvs_chunk(const AdderChunkArgs* a, void* stream) {
  if (!chunk_args_ok(a) || a->dvs != SRC_DVS || a->depth != kDvsDepth ||
      a->runnings != nullptr || a->mode != 1 || a->abs_time != 1 ||
      a->inten == nullptr || a->tspan == nullptr || a->fvw == nullptr) {
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

int adder_rows_keys(const void* meta, long long rows, void* key_pl,
                    void* key_lp, void* stream) {
  if (rows < 1 || rows >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  rows_keys_kernel<<<glue_grid(rows), kGlueBlock, 0, (cudaStream_t)stream>>>(
      (const int*)meta, rows, (int*)key_pl, (int*)key_lp);
  return (int)cudaGetLastError();
}

int adder_rows_rank(const void* skey, const void* lkey, const void* lorder,
                    long long rows, int T, void* head, void* cell_gap,
                    void* cell_tick, void* sub_start, void* stream) {
  if (rows < 1 || rows >= (1LL << 30) || T < 1 || T > 256) {
    return (int)cudaErrorInvalidValue;
  }
  const long long threads = rows > T + 1 ? rows : T + 1;
  rows_rank_kernel<<<glue_grid(threads), kGlueBlock, 0,
                     (cudaStream_t)stream>>>(
      (const int*)skey, (const int*)lkey, (const long long*)lorder, rows, T,
      (int*)head, (long long*)cell_gap, (long long*)cell_tick,
      (long long*)sub_start);
  return (int)cudaGetLastError();
}

int adder_rows_starts(const void* head, const void* pos, long long rows,
                      void* row_start, void* stream) {
  if (rows < 1 || rows >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  rows_starts_kernel<<<glue_grid(rows + 2), kGlueBlock, 0,
                       (cudaStream_t)stream>>>(
      (const int*)head, (const long long*)pos, rows, (long long*)row_start);
  return (int)cudaGetLastError();
}

int adder_dvs_rows(const AdderRowsArgs* a, void* stream) {
  if (a->pass < PASS_COUNT || a->pass > PASS_VOID || a->src != SRC_DVS ||
      a->depth != kDvsDepth || a->n < 1 || a->n > (1LL << 20) ||
      a->rows < 1 || a->rows >= (1LL << 30) || a->ref_time < 1 ||
      a->carrier == nullptr || a->order == nullptr ||
      a->row_start == nullptr || a->n_active == nullptr ||
      a->cell_gap == nullptr || a->cell_tick == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const RArgs r = make_rargs(a);
  cudaStream_t st = (cudaStream_t)stream;
  if (a->multi_mode == 1) {
    launch_rows_pass<kDvsDepth, true, SRC_DVS>(r, a->pass, st);
  } else {
    launch_rows_pass<kDvsDepth, false, SRC_DVS>(r, a->pass, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
