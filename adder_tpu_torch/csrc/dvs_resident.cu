// Hopper kernel for one chunk of DVS lane sub-steps (sm_90a): K3, by rows,
// on the 20-byte carrier (adder_dvs_rows) and on the 8-byte one
// (adder_dvs_rows8), and the grouping and the rows copy the row kernels of
// K3 and K4 share.
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
//   - the grouping on the card, without a host read and without a sort
//     (fused_resident.group_dvs_rows: bitmaps and one look-back scan,
//     below): the rows of each pixel in lane order, and for each row the
//     rank of its gap cell and of its tick cell among the 2 E cells in
//     (sub-step, pixel) order. A chunk of one row per pixel in raster order
//     needs none: its grouping is known (fused_resident.raster_row_groups);
//   - one thread per pixel that has rows walks that pixel's rows only, once
//     (no loop over T, no barrier, no word read for an inactive cell). Each
//     sub-step writes its events as they are produced into its cell's own
//     19 staging slots (slot-major) and its count at the cell's rank; the
//     exclusive scan of the 2 E counts gives every cell its offset, and
//     adder_rows_copy moves the staged events there. The state machine runs
//     once per active cell, where a count pass and a write pass ran it twice;
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
//   - the grouping reads the 8-byte key's fields (row_key with pb), so
//     everything after the keys is shared.

#include "adder_interval.cuh"

extern "C" {

// Mirrored by adder_tpu_torch/ops/fused_resident.py::_RowsCopyArgs.
struct AdderRowsCopyArgs {
  long long cells;       // C
  long long cap;         // entries of out_pixd / out_t; an event past it is
                         // not written
  const void* counts;    // (C,) i32
  const void* offsets;   // (C + 1,) i64, the exclusive scan of counts, the
                         // total last
  const void* stage;     // (19 x C,) u64, slot k of cell c at k C + c
  void* out_pixd;        // (cap,) u32 pix << 8 | d
  void* out_t;           // (cap,) u32 t
};

// Mirrored by adder_tpu_torch/ops/fused_resident.py::_RowsGroupArgs.
struct AdderRowsGroupArgs {
  const void* meta;   // (E,) i32, row 0 of the carrier's rows
  long long rows;     // E >= 1
  int pb;             // 0: the key lane << 20 | pix in the low 27 bits (the
                      // 20-byte DVS and the DAVIS carriers); 1..20: pix in
                      // the low pb bits, the lane in the 6 above (8 bytes)
  int per_lane;       // sub-steps a lane: 2 (DVS), 1 (DAVIS)
  int T;              // sub-steps of the group, per_lane x lanes
  long long n;        // pixels of the plane
  void* scratch;      // adder_rows_group_scratch's words, 16-byte aligned;
                      // the keys entry clears its first part
  void* order;        // (E,) i64
  void* row_start;    // (E + 2,) i64
  void* n_active;     // (1,) i64
  void* cell_gap;     // (E,) i64
  void* cell_tick;    // (E,) i64, per_lane 2 only
  void* sub_start;    // (T + 1,) i64
};

}  // extern "C"

namespace {

// --- the grouping of the row route (fused_resident.group_dvs_rows; its
// plain version is group_dvs_rows_plain), for the DVS and the DAVIS carrier
// alike. The JAX package builds dense planes in XLA glue instead
// (build_dvs_planes, adder_tpu/ops/fused_resident.py:1115), no pl.pallas_call
// of its own. What it must give: the rows of each pixel in lane order
// (order, row_start, n_active) and each row's cells ranked in (sub-step,
// raster pixel) order (cell_gap, cell_tick, sub_start). What bounds it: not
// operations, and bytes only at E x 36 (the keys read, four i64 arrays
// written); a comparison sort of the keys needs several passes and
// launches, and binary searches of about 18 dependent steps a row. Design:
// the keys are dense and small (lane < 128, pix < n <= 2^20) and each
// (lane, pixel) holds at most one row (the planners guarantee it), so both
// orders come from counting, in three launches and no sort:
//   keys  one thread a row sets its bit in a lane-major bitmap
//         bits[lane][pix / 32] and its lane's bit in the pixel's lane mask
//         masks[pix] (64 or 128 bits);
//   scan  one decoupled look-back (lookback_exclusive) over two sequences
//         at once, warp 0 publishing the one and warp 1 the other: the
//         popcounts of the bitmap's words in lane-major order (a word's
//         rank in (lane, pixel) order, each lane's first rank), and per
//         pixel rows << 21 | active (its first row in (pixel, lane) order
//         and its index among the pixels that have rows). A non-zero word
//         or mask leaves with its prefix in the scratch's second part;
//   rank  one thread a row reads its word and its mask from there and
//         writes order[first row + popc(mask below its lane)], the head's
//         row_start, its cells (rank + lane start, + next lane start for
//         the tick) and, for its index, sub_start and the tail of row_start.
// The keys entry clears the bitmap, the masks and the look-back words with
// one cudaMemsetAsync before its kernel; they stay in L2 (2.5 MB each at
// 640 x 480 x 64 lanes).
// A row whose pixel is past the plane or whose lane is past the group's is
// left out (its outputs undefined): no key the 27-bit field can hold writes
// outside the scratch. -------------------------------------------------

constexpr int kGlueBlock = 256;
constexpr int kScanWords = 4;   // bitmap words a thread of the scan
constexpr int kScanPixels = 2;  // pixels a thread of the scan
constexpr long long kActiveBits = 21;  // rows << 21 | active pixels

// Where each part of the scratch lies, in 64-bit words, for a plane of n
// pixels and a group of `lanes` lanes: first the parts the keys entry
// clears, then those the scan writes.
struct GroupLayout {
  long long nw;    // bitmap words a lane, a multiple of kScanWords
  int mw;          // 64-bit words of a pixel's lane mask
  int nblk;        // blocks of the scan
  long long bits;  // lanes x nw u32
  long long masks;  // n x mw u64
  long long look;  // the block ticket, then 2 x nblk look-back words
  long long cleared;  // the words cleared
  long long pa;    // lanes x nw u64, a non-zero word << 32 | its rank
  long long pm;    // n x (mw + 1) u64, an active pixel's mask words, then
                   // its rows << 21 | active prefix
  long long ls;    // lanes + 1 i64, each lane's first rank, the total
  long long words;
};

inline GroupLayout group_layout(long long n, int lanes) {
  GroupLayout g;
  g.nw = (n + 32 * kScanWords - 1) / (32 * kScanWords) * kScanWords;
  g.mw = lanes > 64 ? 2 : 1;
  const long long ta = (long long)kGlueBlock * kScanWords;
  const long long tp = (long long)kGlueBlock * kScanPixels;
  const long long ba = (lanes * g.nw + ta - 1) / ta, bp = (n + tp - 1) / tp;
  g.nblk = (int)(ba > bp ? ba : bp);
  g.bits = 0;
  g.masks = lanes * g.nw / 2;
  g.look = g.masks + n * g.mw;
  g.cleared = g.look + 1 + 2LL * g.nblk;
  g.pa = g.cleared;
  g.pm = g.pa + lanes * g.nw;
  g.ls = g.pm + n * (g.mw + 1);
  g.words = g.ls + lanes + 1;
  return g;
}

struct GArgs {
  GroupLayout L;
  const int* meta;
  long long rows, n;
  int pb, per_lane, T, lanes;
  unsigned* bits;
  unsigned long long* masks;
  unsigned long long* look;
  unsigned long long* pa;
  unsigned long long* pm;
  long long* ls;
  long long *order, *row_start, *n_active, *cell_gap, *cell_tick, *sub_start;
};

// Row i's lane and pixel; false for a row outside the plane or the group.
__device__ __forceinline__ bool row_key(const GArgs& g, long long i, int& lane,
                                        long long& pix) {
  const unsigned w = (unsigned)g.meta[i];
  if (g.pb == 0) {
    pix = w & 0xFFFFFu;
    lane = (int)((w >> 20) & 127u);
  } else {
    pix = w & ((1u << g.pb) - 1u);
    lane = (int)((w >> g.pb) & 63u);
  }
  return pix < g.n && lane < g.lanes;
}

__global__ void __launch_bounds__(kGlueBlock)
    rows_group_keys_kernel(const GArgs g) {
  const long long i = (long long)blockIdx.x * kGlueBlock + threadIdx.x;
  int lane;
  long long pix;
  if (i < g.rows && row_key(g, i, lane, pix)) {
    atomicOr(&g.bits[lane * g.L.nw + (pix >> 5)], 1u << (pix & 31));
    atomicOr(&g.masks[pix * g.L.mw + (lane >> 6)], 1ull << (lane & 63));
  }
}

template <int MW>
__global__ void __launch_bounds__(kGlueBlock)
    rows_group_scan_kernel(const GArgs g) {
  constexpr int kWarps = kGlueBlock / 32;
  __shared__ int s_blk;
  __shared__ long long s_pre[2][kWarps];
  if (threadIdx.x == 0) s_blk = (int)atomicAdd(g.look, 1ull);
  __syncthreads();
  const int blk = s_blk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t = (long long)blk * kGlueBlock + threadIdx.x;
  // the bitmap's words, lane-major (16-byte loads: nw is a multiple of 4)
  const long long words = g.lanes * g.L.nw, w0 = t * kScanWords;
  uint4 wv = make_uint4(0u, 0u, 0u, 0u);
  if (w0 < words) wv = *reinterpret_cast<const uint4*>(g.bits + w0);
  const int ca = __popc(wv.x) + __popc(wv.y) + __popc(wv.z) + __popc(wv.w);
  // the pixels' lane masks
  const long long p0 = t * kScanPixels;
  unsigned long long m[kScanPixels][MW];
  long long cb = 0;
#pragma unroll
  for (int q = 0; q < kScanPixels; ++q) {
    int c = 0;
#pragma unroll
    for (int k = 0; k < MW; ++k) {
      m[q][k] = p0 + q < g.n ? g.masks[(p0 + q) * MW + k] : 0ull;
      c += __popcll(m[q][k]);
    }
    cb += ((long long)c << kActiveBits) | (c > 0);
  }
  const long long xa = warp_inclusive_scan((long long)ca, lane);
  const long long xb = warp_inclusive_scan(cb, lane);
  if (lane == 31) {
    s_pre[0][warp] = xa;
    s_pre[1][warp] = xb;
  }
  __syncthreads();
  if (warp < 2) {  // warp 0 the words, warp 1 the pixels, side by side
    const long long v = lane < kWarps ? s_pre[warp][lane] : 0;
    const long long y = warp_inclusive_scan(v, lane);
    const long long total = __shfl_sync(kFull, y, 31);
    const long long excl = lookback_exclusive(
        g.look + 1 + (long long)warp * g.L.nblk, blk, total, 0, lane);
    if (lane < kWarps) s_pre[warp][lane] = excl + y - v;
    if (blk == g.L.nblk - 1 && lane == 0) {
      if (warp == 0) {
        g.ls[g.lanes] = excl + total;
      } else {
        *g.n_active = (excl + total) & ((1LL << kActiveBits) - 1);
      }
    }
  }
  __syncthreads();
  if (w0 < words) {
    long long ra = s_pre[0][warp] + xa - ca;
    // a lane's first word starts a thread's words (nw is a multiple of 4)
    if (w0 % g.L.nw == 0) g.ls[w0 / g.L.nw] = ra;
    const unsigned wk[kScanWords] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int k = 0; k < kScanWords; ++k) {
      if (wk[k]) {
        g.pa[w0 + k] = ((unsigned long long)wk[k] << 32) | (unsigned)ra;
      }
      ra += __popc(wk[k]);
    }
  }
  long long rb = s_pre[1][warp] + xb - cb;
#pragma unroll
  for (int q = 0; q < kScanPixels; ++q) {
    int c = 0;
#pragma unroll
    for (int k = 0; k < MW; ++k) c += __popcll(m[q][k]);
    if (c) {
      const long long p = p0 + q;
#pragma unroll
      for (int k = 0; k < MW; ++k) g.pm[p * (MW + 1) + k] = m[q][k];
      g.pm[p * (MW + 1) + MW] = (unsigned long long)rb;
    }
    rb += ((long long)c << kActiveBits) | (c > 0);
  }
}

template <int MW>
__global__ void __launch_bounds__(kGlueBlock)
    rows_group_rank_kernel(const GArgs g) {
  const long long i = (long long)blockIdx.x * kGlueBlock + threadIdx.x;
  const long long total = g.ls[g.lanes];
  int lane;
  long long pix;
  if (i < g.rows && row_key(g, i, lane, pix)) {
    const unsigned long long a = g.pa[lane * g.L.nw + (pix >> 5)];
    const long long rank =
        (long long)(unsigned)a +
        __popc((unsigned)(a >> 32) & ((1u << (pix & 31)) - 1u));
    if (g.per_lane == 1) {
      g.cell_gap[i] = rank;
    } else {
      g.cell_gap[i] = rank + g.ls[lane];
      g.cell_tick[i] = rank + g.ls[lane + 1];
    }
    const unsigned long long* e = g.pm + pix * (MW + 1);
    int below = 0;
#pragma unroll
    for (int k = 0; k < MW; ++k) {
      const int bit = lane - 64 * k;
      const unsigned long long mk = e[k];
      below += bit >= 64 ? __popcll(mk)
               : bit > 0 ? __popcll(mk & ((1ull << bit) - 1ull))
                         : 0;
    }
    const unsigned long long pre = e[MW];
    const long long first = (long long)(pre >> kActiveBits);
    g.order[first + below] = i;
    if (below == 0) {  // the pixel's first row heads its run
      g.row_start[pre & ((1ull << kActiveBits) - 1)] = first;
    }
  }
  if (i < g.T) {
    const int l = (int)(i / g.per_lane);
    g.sub_start[i] = g.per_lane == 1 ? g.ls[l]
                     : (i & 1)       ? g.ls[l] + g.ls[l + 1]
                                     : 2 * g.ls[l];
  } else if (i == g.T) {
    g.sub_start[i] = g.per_lane * total;
  }
  if (i >= *g.n_active && i <= g.rows + 1) g.row_start[i] = total;
}

inline int glue_grid(long long threads) {
  return (int)((threads + kGlueBlock - 1) / kGlueBlock);
}

// The group's arguments, checked; false for arguments the kernels refuse.
inline bool group_args(const AdderRowsGroupArgs* a, GArgs& g) {
  if (a->rows < 1 || a->rows >= (1LL << 30) || a->n < 1 ||
      a->n > (1LL << 20) || a->pb < 0 || a->pb > 20 ||
      (a->per_lane != 1 && a->per_lane != 2) || a->T < a->per_lane ||
      a->T > kMaxT || a->T % a->per_lane != 0 ||
      (a->pb > 0 && a->per_lane != 2) || a->meta == nullptr ||
      a->scratch == nullptr || a->order == nullptr ||
      a->row_start == nullptr || a->n_active == nullptr ||
      a->cell_gap == nullptr || a->sub_start == nullptr ||
      (a->per_lane == 2 && a->cell_tick == nullptr) ||
      ((uintptr_t)a->scratch & 15) != 0) {
    return false;
  }
  g.lanes = a->T / a->per_lane;
  g.L = group_layout(a->n, g.lanes);
  g.meta = (const int*)a->meta;
  g.rows = a->rows;
  g.n = a->n;
  g.pb = a->pb;
  g.per_lane = a->per_lane;
  g.T = a->T;
  unsigned long long* s = (unsigned long long*)a->scratch;
  g.bits = (unsigned*)(s + g.L.bits);
  g.masks = s + g.L.masks;
  g.look = s + g.L.look;
  g.pa = s + g.L.pa;
  g.pm = s + g.L.pm;
  g.ls = (long long*)(s + g.L.ls);
  g.order = (long long*)a->order;
  g.row_start = (long long*)a->row_start;
  g.n_active = (long long*)a->n_active;
  g.cell_gap = (long long*)a->cell_gap;
  g.cell_tick = (long long*)a->cell_tick;
  g.sub_start = (long long*)a->sub_start;
  return true;
}

// --- the compaction of the row walk (adder_rows_copy; its plain version is
// fused_resident.rows_copy_plain), for K3 and K4 alike. In the JAX package
// the resident chunk's events leave through its host assembler
// (assemble_resident_events), with no pl.pallas_call of their own; here the
// walk stages each cell's events in the cell's own slots, slot-major, and
// this kernel moves them to the cell's exclusive offset, so they leave in
// (sub-step, raster pixel, slot) order. What bounds it: bytes (each cell's
// count read, one offset a warp of 32 cells, each event's 8 staged bytes
// read and 8 output bytes written).
// Design: each warp takes 32 consecutive cells; one coalesced load of their
// counts, a warp prefix of them and one broadcast load of the first cell's
// offset give every cell its place. The warp's events are then one run of
// outputs: lane l takes the warp's events l, l + 32, ..., finds its cell by
// a binary search of the prefix through shuffles (5 steps) and its slot
// from the cell's exclusive prefix, so every lane works in every step and
// the stores are contiguous; a slot-major staging puts the first events of
// neighbouring cells in the same sectors. An event past `cap` is not
// written. ------------------------------------------------------------------
constexpr int kCopyBlock = 256;

__global__ void __launch_bounds__(kCopyBlock)
    adder_rows_copy_kernel(const long long cells, const long long cap,
                           const int* __restrict__ counts,
                           const long long* __restrict__ offsets,
                           const unsigned long long* __restrict__ stage,
                           unsigned* __restrict__ out_pixd,
                           unsigned* __restrict__ out_t) {
  const int lane = threadIdx.x & 31;
  const long long base = ((long long)blockIdx.x * kCopyBlock + threadIdx.x)
                         & ~31LL;
  if (base >= cells) return;  // the whole warp
  const int cnt = base + lane < cells ? counts[base + lane] : 0;
  const int incl = warp_inclusive_scan(cnt, lane);
  const int excl = incl - cnt;
  const int total = __shfl_sync(kFull, incl, 31);
  if (total == 0) return;
  const long long off = offsets[base];
  if (off >= cap) return;
  for (int r = 0; r < total; r += 32) {
    const int e = r + lane;
    // j: the number of the warp's cells whose inclusive prefix is <= e
    int j = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      if (__shfl_sync(kFull, incl, j + step - 1) <= e) j += step;
    }
    const int k = e - __shfl_sync(kFull, excl, j);
    const long long o = off + e;
    if (e < total && o < cap) {
      const unsigned long long v = stage[k * cells + base + j];
      out_pixd[o] = (unsigned)v;
      out_t[o] = (unsigned)(v >> 32);
    }
  }
}

inline int launch_rows_copy(const AdderRowsCopyArgs* c, void* stream) {
  if (c->cells < 1 || c->cap < 0 ||
      c->counts == nullptr || c->offsets == nullptr ||
      c->stage == nullptr ||
      (c->cap > 0 && (c->out_pixd == nullptr || c->out_t == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const long long grid = (c->cells + kCopyBlock - 1) / kCopyBlock;
  adder_rows_copy_kernel<<<(unsigned)grid, kCopyBlock, 0,
                           (cudaStream_t)stream>>>(
      c->cells, c->cap, (const int*)c->counts, (const long long*)c->offsets,
      (const unsigned long long*)c->stage, (unsigned*)c->out_pixd,
      (unsigned*)c->out_t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The 64-bit words of the grouping's scratch for a plane of n pixels and a
// group of `lanes` lanes, into *words.
int adder_rows_group_scratch(long long n, int lanes, void* words) {
  if (n < 1 || n > (1LL << 20) || lanes < 1 || lanes > kMaxT ||
      words == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  *(long long*)words = group_layout(n, lanes).words;
  return 0;
}

// The grouping's three launches, in this order on one stream.
int adder_rows_group_keys(const AdderRowsGroupArgs* a, void* stream) {
  GArgs g;
  if (!group_args(a, g)) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      cudaMemsetAsync(a->scratch, 0, (size_t)g.L.cleared * 8,
                      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  rows_group_keys_kernel<<<glue_grid(g.rows), kGlueBlock, 0,
                           (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

int adder_rows_group_scan(const AdderRowsGroupArgs* a, void* stream) {
  GArgs g;
  if (!group_args(a, g)) return (int)cudaErrorInvalidValue;
  if (g.L.mw == 1) {
    rows_group_scan_kernel<1>
        <<<g.L.nblk, kGlueBlock, 0, (cudaStream_t)stream>>>(g);
  } else {
    rows_group_scan_kernel<2>
        <<<g.L.nblk, kGlueBlock, 0, (cudaStream_t)stream>>>(g);
  }
  return (int)cudaGetLastError();
}

int adder_rows_group_rank(const AdderRowsGroupArgs* a, void* stream) {
  GArgs g;
  if (!group_args(a, g)) return (int)cudaErrorInvalidValue;
  const long long threads = g.rows + 2 > g.T + 1 ? g.rows + 2 : g.T + 1;
  if (g.L.mw == 1) {
    rows_group_rank_kernel<1><<<glue_grid(threads), kGlueBlock, 0,
                                (cudaStream_t)stream>>>(g);
  } else {
    rows_group_rank_kernel<2><<<glue_grid(threads), kGlueBlock, 0,
                                (cudaStream_t)stream>>>(g);
  }
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
