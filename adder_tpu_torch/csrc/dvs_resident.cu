// Hopper kernel for one chunk of DVS lane sub-steps (sm_90a): K3, by rows,
// on the 20-byte carrier (adder_dvs_rows) and on the 8-byte one
// (adder_dvs_rows8), and the grouping glue the row kernels of K3 and K4
// share.
//
// Replaces the TPU kernel adder_tpu/ops/fused_resident.py::make_resident_call
// in its DVS mode (dvs=True; make_dvs_chunk_resident :1017, reached through
// _compact :1074, _packed :1159 and _packed8 :1214; kernel body
// _kernel_body :243-332). The Prophesee source (prophesee.rs:116-297) plans
// each window of events into lanes, lane k holding each pixel's k-th event;
// a lane runs as two sub-steps (the held intensity over the gap, then one
// source tick of the new intensity). A chunk is T = 2 x lanes <= 128
// sub-steps, in Continuous mode, AbsoluteT, at arena depth 16 (K = 19 event
// slots per sub-step). Events leave in (sub-step, raster pixel, slot) order
// through one walk that stages each cell's events, the exclusive scan of
// the cell counts and adder_rows_copy (below); the void walk (the Empty
// sink) stages nothing; every walk folds the largest per-cell event count
// and the depth flag into `flags`. Only what the path runs is
// instantiated: depth 16 x Continuous x AbsoluteT x {Normal, Collapse} x
// {events staged, void}, 4 kernels.
//
// adder_dvs_rows is the one route of every DVS chunk: the lane groups, which
// are sparse (about 1% of the (sub-step, pixel) cells of a T = 128 group are
// active), and the chunks of one row per pixel in raster order (the
// Prophesee bootstrap and end-of-stream flush, DAVIS's frame and the gap to
// it, T = 2 with the tick half off where there is no tick). Its input is
// the (5, E) i32 carrier itself, the input of make_dvs_chunk_resident_packed
// (pack_dvs_plan: pix | lane << 20 | gap_on << 27 | tick_on << 28, the two
// fv bytes, the bits of gap_int, gap_time and tick_int), and it makes no
// plane. The plain PyTorch version it is held against is
// adder_tpu_torch/ops/fused_resident.py::dvs_rows_resident_plain.
//   What bounds it: not bytes (20 B per carrier row, the state of the pixels
//   that have rows, 8 B per event: a few tens of microseconds) but the state
//   machine: a few hundred dependent scalar operations per sub-step, run
//   serially along each pixel's rows, so the longest pixel (up to 128
//   sub-steps) sets the floor.
//   What the design does about it (adder_lane_rows_kernel in
//   adder_interval.cuh):
//   - glue on the card, without a host read (fused_resident.group_dvs_rows:
//     two sorts and the ranks of the cells, below): the rows of each pixel in
//     lane order, and for each row the rank of its gap cell and of its tick
//     cell among the 2 E cells in (sub-step, pixel) order. A chunk of one row
//     per pixel in raster order needs none: its grouping is known
//     (fused_resident.raster_row_groups);
//   - one thread per pixel that has rows walks that pixel's rows only, once
//     (no loop over T, no barrier, no word read for an inactive cell). Each
//     sub-step writes its events as they are produced into its cell's own
//     19 staging slots and its count at the cell's rank; the exclusive scan
//     of the 2 E counts gives every cell its offset, and adder_rows_copy
//     moves the staged events there. The state machine runs once per active
//     cell, where a count pass and a write pass ran it twice;
//   - the serial sub-step is short: no slot arrays (sd/st) are built and
//     then stored; pop_best and integrate's tail searches follow the arena's
//     length (most arenas hold one to three nodes), not its depth; the walk
//     leaves integrate's node loop at its first inactive node; pop_top keeps
//     the full shift, since the nodes past the length are carried state the
//     plain version shifts too; the next row's words are loaded while a
//     row's sub-steps run;
//   - the arena stays in registers: the tail node is read through `opaque`
//     (adder_interval.cuh), since a tail search by index comparison lets
//     the compiler merge its loads into one at a dynamic index, which puts
//     the whole arena in local memory and stores every write to it there;
//   - the state is updated in place, for the pixels that have rows only, on
//     the staged and the void walk alike;
//   - blocks of 64 threads, so a block that holds a long pixel keeps few
//     others waiting; threads take the pixels in raster order, so gathers
//     of neighbours coalesce;
//   - run_interval's arithmetic and every _rn intrinsic, the per-sub-step
//     c_thresh increment, the flags are those of the framed kernel.
// ptxas -v reports the registers and any spill of each instantiation.
//
// adder_dvs_rows8 runs the same walk from the 8-byte carrier of
// make_dvs_chunk_resident_packed8 (:1214; pack_dvs_plan8 :1284-1336, the
// decode unpack_dvs_carrier8 :1254-1281), which the Prophesee source takes
// by default (the fused native planner adder_plan_dvs_pack8 writes it):
// (2, E + 64) i32, two u32 words a row (pix in pb bits, the lane, the two
// on bits, gap_n in a hi/lo split, two 6-bit dictionary indices), then a
// dictionary of 64 (f32 value, fv) pairs. Its plain version is
// adder_tpu_torch/ops/fused_resident.py::dvs_rows8_resident_plain.
//   What bounds it: as adder_dvs_rows, the serial state machine; the bytes
//   it must move fall to 8 per active row plus the 512-byte dictionary.
//   What the design does about it:
//   - the decode is in the walk, not a separate 8 -> 20 byte pass: such a
//     pass would add a launch per lane group and write the 20-byte rows
//     back to HBM, where the point of the layout is that only 8 bytes a row
//     move;
//   - each block stages the dictionary once in shared memory (512 B); the
//     gap's intensity is the f32 product value x f32(gap_n) and its span
//     the exact i32 product gap_n x ref_time rounded once (__fmul_rn,
//     __int2float_rn: no contraction), the planner's own definitions, so
//     the decoded fields equal the 20-byte carrier's bit for bit;
//   - the glue keys the rows with the same lane << 20 | pix
//     (rows_keys_kernel<true>), so everything after the keys is shared.

#include "adder_interval.cuh"

extern "C" {

// Mirrored by adder_tpu_torch/ops/fused_resident.py::_RowsCopyArgs.
struct AdderRowsCopyArgs {
  long long cells;       // C
  int slots;             // staging slots a cell, depth + 3 <= 32
  long long cap;         // entries of out_pixd / out_t; an event past it is
                         // not written
  const void* counts;    // (C,) i32
  const void* offsets;   // (C + 1,) i64 exclusive offsets, the total last
  const void* stage;     // (C x slots,) u64
  void* out_pixd;        // (cap,) u32 pix << 8 | d
  void* out_t;           // (cap,) u32 t
};

}  // extern "C"

namespace {

// --- the grouping glue of the row route (fused_resident.group_dvs_rows; its
// plain version is group_dvs_rows_plain), for the DVS and the DAVIS carrier
// alike: the low 27 bits of row 0 are lane << 20 | pix in both. Three small
// kernels around two sorts and one exclusive scan, so a group costs a dozen
// launches and no host read. Keys: pix << 7 | lane sorts the rows by pixel,
// then lane; lane << 20 | pix ranks them in output order. The planners give
// each (lane, pixel) at most one row, so the keys are unique and the sorts
// need not be stable. -----------------------------------------------------

constexpr int kGlueBlock = 256;

// EIGHT: row 0 of pack_dvs_plan8's carrier, pix in the low pb bits and the
// lane in the 6 above; else the low 27 bits of the 20-byte carriers.
template <bool EIGHT>
__global__ void __launch_bounds__(kGlueBlock)
    rows_keys_kernel(const int* __restrict__ meta, long long rows, int pb,
                     int* __restrict__ key_pl, int* __restrict__ key_lp) {
  const long long i = (long long)blockIdx.x * kGlueBlock + threadIdx.x;
  if (i < rows) {
    const unsigned w = (unsigned)meta[i];
    const int k =
        EIGHT ? (int)((((w >> pb) & 63u) << 20) | (w & ((1u << pb) - 1u)))
              : (int)(w & 0x7FFFFFFu);
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
// lane << 20 | pix keys and the rows they came from; per_lane: the sub-steps
// of a lane, 2 for DVS (gap, tick), 1 for DAVIS. Writes the run heads of
// skey (a pixel's first row) for the scan, each row's cells, and the first
// cell of each of the T sub-steps, then per_lane x E. Lane k's rows are
// ranks [ls, le) of lkey. DVS: its gap cells are 2 ls + (rank - ls), its
// tick cells follow them. DAVIS: a row's one cell is its rank.
__global__ void __launch_bounds__(kGlueBlock)
    rows_rank_kernel(const int* __restrict__ skey,
                     const int* __restrict__ lkey,
                     const long long* __restrict__ lorder, long long rows,
                     int T, int per_lane, int* __restrict__ head,
                     long long* __restrict__ cell_gap,
                     long long* __restrict__ cell_tick,
                     long long* __restrict__ sub_start) {
  const long long i = (long long)blockIdx.x * kGlueBlock + threadIdx.x;
  if (i < rows) {
    head[i] = i == 0 || (skey[i] >> 7) != (skey[i - 1] >> 7);
    const long long row = lorder[i];
    if (per_lane == 1) {
      cell_gap[row] = i;
    } else {
      const int lane = lkey[i] >> 20;
      cell_gap[row] = i + lower_bound(lkey, rows, lane << 20);
      cell_tick[row] = i + lower_bound(lkey, rows, (lane + 1) << 20);
    }
  }
  if (i < T) {
    const int lane = (int)(i / per_lane);
    const long long ls = lower_bound(lkey, rows, lane << 20);
    if (per_lane == 1) {
      sub_start[i] = ls;
    } else {
      const long long le = lower_bound(lkey, rows, (lane + 1) << 20);
      sub_start[i] = (i & 1) ? ls + le : 2 * ls;
    }
  } else if (i == T) {
    sub_start[i] = per_lane * rows;
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

// --- the compaction of the row walk (adder_rows_copy; its plain version is
// fused_resident.rows_copy_plain), for K3 and K4 alike. In the JAX package
// the resident chunk's events leave through its host assembler
// (assemble_resident_events), with no pl.pallas_call of their own; here the
// walk stages each cell's events in the cell's own slots, and this kernel
// moves them to the cell's exclusive offset, so they leave in (sub-step,
// raster pixel, slot) order. What bounds it: bytes (each cell's count and
// offset read, each event's 8 staged bytes read and 8 output bytes
// written). Design: each warp takes 32 consecutive cells, reads their
// counts and offsets once (coalesced), and copies each non-empty cell's
// events with its lanes, one event a lane, from the cell's contiguous slots
// to its contiguous output; an event past `cap` is not written. ---------
constexpr int kCopyBlock = 256;

__global__ void __launch_bounds__(kCopyBlock)
    adder_rows_copy_kernel(const long long cells, const int slots,
                           const long long cap,
                           const int* __restrict__ counts,
                           const long long* __restrict__ offsets,
                           const unsigned long long* __restrict__ stage,
                           unsigned* __restrict__ out_pixd,
                           unsigned* __restrict__ out_t) {
  const int lane = threadIdx.x & 31;
  const long long base = ((long long)blockIdx.x * kCopyBlock + threadIdx.x)
                         & ~31LL;
  const long long cell = base + lane;
  int cnt = 0;
  long long off = 0;
  if (cell < cells) {
    cnt = counts[cell];
    off = offsets[cell];
  }
  unsigned busy = __ballot_sync(kFull, cnt > 0);
  while (busy) {
    const int b = __ffs(busy) - 1;
    busy &= busy - 1;
    const int c = __shfl_sync(kFull, cnt, b);
    const long long o = __shfl_sync(kFull, off, b) + lane;
    if (lane < c && o < cap) {
      const unsigned long long v = stage[(base + b) * slots + lane];
      out_pixd[o] = (unsigned)v;
      out_t[o] = (unsigned)(v >> 32);
    }
  }
}

inline int launch_rows_copy(const AdderRowsCopyArgs* c, void* stream) {
  if (c->cells < 1 || c->slots < 1 || c->slots > 32 || c->cap < 0 ||
      c->counts == nullptr || c->offsets == nullptr ||
      c->stage == nullptr ||
      (c->cap > 0 && (c->out_pixd == nullptr || c->out_t == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const long long grid = (c->cells + kCopyBlock - 1) / kCopyBlock;
  adder_rows_copy_kernel<<<(unsigned)grid, kCopyBlock, 0,
                           (cudaStream_t)stream>>>(
      c->cells, c->slots, c->cap, (const int*)c->counts,
      (const long long*)c->offsets, (const unsigned long long*)c->stage,
      (unsigned*)c->out_pixd, (unsigned*)c->out_t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {



int adder_rows_keys(const void* meta, long long rows, void* key_pl,
                    void* key_lp, void* stream) {
  if (rows < 1 || rows >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  rows_keys_kernel<false>
      <<<glue_grid(rows), kGlueBlock, 0, (cudaStream_t)stream>>>(
          (const int*)meta, rows, 0, (int*)key_pl, (int*)key_lp);
  return (int)cudaGetLastError();
}

// The keys of an 8-byte carrier's rows (row 0 of pack_dvs_plan8's, whose
// pixel field has pb <= 20 bits, so lane << 20 | pix keeps both).
int adder_rows_keys8(const void* meta, long long rows, int pb, void* key_pl,
                     void* key_lp, void* stream) {
  if (rows < 1 || rows >= (1LL << 30) || pb < 1 || pb > 20) {
    return (int)cudaErrorInvalidValue;
  }
  rows_keys_kernel<true>
      <<<glue_grid(rows), kGlueBlock, 0, (cudaStream_t)stream>>>(
          (const int*)meta, rows, pb, (int*)key_pl, (int*)key_lp);
  return (int)cudaGetLastError();
}

// cell_tick is written only for per_lane == 2 (the DVS carrier).
int adder_rows_rank(const void* skey, const void* lkey, const void* lorder,
                    long long rows, int T, int per_lane, void* head,
                    void* cell_gap, void* cell_tick, void* sub_start,
                    void* stream) {
  if (rows < 1 || rows >= (1LL << 30) || T < 1 || T > 256 ||
      (per_lane != 1 && per_lane != 2) ||
      (per_lane == 2 && cell_tick == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long threads = rows > T + 1 ? rows : T + 1;
  rows_rank_kernel<<<glue_grid(threads), kGlueBlock, 0,
                     (cudaStream_t)stream>>>(
      (const int*)skey, (const int*)lkey, (const long long*)lorder, rows, T,
      per_lane, (int*)head, (long long*)cell_gap, (long long*)cell_tick,
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
  return launch_rows<SRC_DVS>(a, stream);
}

int adder_dvs_rows8(const AdderRowsArgs* a, void* stream) {
  return launch_rows<SRC_DVS8>(a, stream);
}

// The compaction of K3's and K4's row walks.
int adder_rows_copy(const AdderRowsCopyArgs* c, void* stream) {
  return launch_rows_copy(c, stream);
}

}  // extern "C"
