// Hopper kernels for one framed -> ADΔER transcode chunk (sm_90a).
//
// Replaces the TPU kernel adder_tpu/ops/fused_resident.py::make_resident_call
// (body _kernel_body, :113-672) in its two framed modes:
//   - events fetched: make_fused_chunk_resident (:848) -> the chunk kernel
//     with its staging, adder_exclusive_scan, adder_segment_copy
//   - Empty sink:     make_group_chunk_resident (:915) -> the chunk kernel
//     without its staging
// The per-pixel logic is adder_tpu/ops/integrate.py::_interval_core
// (:638-678) and its helpers (:219-613), shared with the lane kernels in
// adder_interval.cuh (which also lists the exactness rules); the plain
// PyTorch versions the kernels are held against are
// adder_tpu_torch/ops/fused_resident.py::fused_chunk_resident_plain,
// group_chunk_resident_plain and segment_copy_plain. adder_wire_pack (below
// the segment copy) has no TPU counterpart: it writes a chunk's events as
// .adder records on the card, in place of the host's encode_events; its
// plain version is wire_pack_plain.
//
// The display (emit_running=True, fused_resident.py:336-357, :890-899): when
// the caller passes run0 and runnings, the chunk kernel also writes the
// (T, n) u8 display frame after each interval, carried forward from run0 in
// a register (the JAX wrapper's lax.scan over run_val / run_has has no
// counterpart). It is a template parameter (RUN), not a runtime branch, so
// the display-off kernels compile to the code they would have without it.
//
// Design. One thread per pixel-channel. The pixel's whole arena (nd, ni, ndt,
// bd, bdt x DEPTH plus nine scalars) is loaded once into registers and stays
// there across all T intervals of the chunk: this takes the place of the TPU
// kernel's VMEM residency across its sequential interval grid axis. DEPTH is
// a template parameter (6 or 8) and every arena loop is fully unrolled with
// compile-time indices, so the arrays never leave registers (-Xptxas -v
// reports spills). Mode, PixelMultiMode and TimeMode are template parameters
// too, so each of the 8 mode cases compiles to straight-line code; EVENTS
// and RUN make 4 kernels of each (64 in all).
//
// Event order is the reference's single-thread order (interval, raster
// pixel, slot), written with no host reordering and no host read, in one
// pass over the state machine:
//   the chunk kernel  runs every pixel through its T intervals once and
//               writes, per (interval, warp), the warp's event count; with
//               EVENTS the warp's events of the interval go to a staging
//               pool in slabs it takes with one atomic each (adder_interval
//               .cuh describes the slabs), and the segment's start.
//   adder_exclusive_scan turns the (T, n / 32) counts, row-major, into int64
//               offsets (K*T*N exceeds 2^31 for 1080p colour at T = 64) and
//               the total: one launch of many blocks joined by a decoupled
//               look-back (below). The lane kernels (K3 and K4, by rows)
//               use it too, on their own counts.
//   adder_segment_copy moves each segment from the pool to its offset,
//               coalesced; it writes nothing at or past the caller's
//               capacity, and nothing at all after a staging overflow.
// The caller sizes the pool and the output from its capacity (the JAX
// resident chunk's event_cap): the total is exact whatever the capacity, so
// the caller sees an overflow without a host read inside the chunk, and
// reruns. The kernel folds the largest per-(interval, pixel) event count and
// the arena-depth flag into flags[0] (atomicMax) and flags[1] (atomicOr).
// None of the TPU machinery is carried over: no (8, LN) reshapes, no
// log-shift or band compactors, no head/carry replay, no DMA semaphores, no
// bit-31 validity marker.
//
// What bounds it. Per interval a pixel reads one byte of frame (loaded one
// interval ahead) and does a few hundred scalar operations; the state is
// read and written once per chunk, not per interval. So the kernel is bound
// by the instruction issue and the latency of the per-pixel state machine,
// not by device memory. What the design does about it: the arena walk
// branches past the arena's end (integrate's SKIP), so a warp whose pixels
// hold short arenas skips the nodes none of them has; there is no block
// barrier, so a warp never waits for another; the block is small
// (kChunkBlock, 128 threads) so that the registers, not the block, set the
// warps per SM. The staging adds 8 bytes per event written and read
// once more, and the scan and the copy are short launches beside it.
//
// The event layout. Below 2^24 pixel-channels an event leaves the copy as
// two u32 words, pix << 8 | d and t (8 bytes), as the TPU kernel's do. At
// 2^24 and above (3840 x 2160 x 3 is 24,883,200) that index cannot hold
// the pixel, and the chunk takes the wide layout, a template parameter of
// K1's pass (WIDE, whose narrow instantiations compile as they did) and of
// the segment copy's and the wire pack's bodies (their wide kernels are
// their own, so the narrow ones keep their code and names): the staged word
// stays 8 bytes
// (lane << 8 | d, t), the copy writes a u64 pix << 8 | d beside the u32 t
// (12 bytes), and the pack reads the u64. Every slot count, capacity and
// byte offset on the path is 64-bit: K_SLOTS x N x T passes 2^31 at 4K.

#include "adder_interval.cuh"

namespace {

// --- exclusive scan of i32 counts into i64 offsets, total at out[count]: one
// launch of many blocks. A block takes a ticket, loads its contiguous tile
// with 16-byte loads (ITEMS counts per thread), scans it in registers and
// shared memory, and gets the sum of the tiles before it by the decoupled
// look-back of adder_interval.cuh; it then writes its offsets with 16-byte
// stores. What bounds it: latency (one load, two block-wide steps and the
// look-back's hop through L2), not bytes: 129,600 counts are 1.5 MB. So the
// tile is small enough to spread a framed chunk's counts over a wave of
// blocks and the look-back reads 32 predecessors at once. `scratch` is
// (blocks + 1) zeroed 64-bit words: the look-back words, then the ticket. --

template <int THREADS, int ITEMS>
__global__ void __launch_bounds__(THREADS)
    adder_exclusive_scan_kernel(const int* __restrict__ in,
                                long long* __restrict__ out, long long count,
                                int nblk, bool vec,
                                unsigned long long* scratch) {
  static_assert(ITEMS % 4 == 0, "whole int4 loads");
  constexpr int kScanWarps = THREADS / 32;
  __shared__ int s_blk;
  __shared__ long long s_tot[kScanWarps];
  __shared__ long long s_pre[kScanWarps];
  __shared__ long long s_base;
  if (threadIdx.x == 0) s_blk = atomicAdd((int*)(scratch + nblk), 1);
  __syncthreads();
  const int blk = s_blk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long i0 =
      ((long long)blk * THREADS + threadIdx.x) * (long long)ITEMS;
  int v[ITEMS];
#pragma unroll
  for (int q = 0; q < ITEMS; q += 4) {
    if (vec && i0 + q + 3 < count) {
      const int4 x = *reinterpret_cast<const int4*>(in + i0 + q);
      v[q] = x.x;
      v[q + 1] = x.y;
      v[q + 2] = x.z;
      v[q + 3] = x.w;
    } else {
#pragma unroll
      for (int j = q; j < q + 4; ++j) v[j] = i0 + j < count ? in[i0 + j] : 0;
    }
  }
  long long local = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) local += v[j];
  const long long x = warp_inclusive_scan(local, lane);
  if (lane == 31) s_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const long long w = lane < kScanWarps ? s_tot[lane] : 0;
    const long long y = warp_inclusive_scan(w, lane);
    if (lane < kScanWarps) s_pre[lane] = y - w;
    const long long total = __shfl_sync(kFull, y, 31);
    const long long excl = lookback_exclusive(scratch, blk, total, 0, lane);
    if (lane == 0) {
      s_base = excl;
      if (blk == nblk - 1) out[count] = excl + total;
    }
  }
  __syncthreads();
  long long run = s_base + s_pre[warp] + (x - local);
#pragma unroll
  for (int j = 0; j < ITEMS; j += 2) {
    const long long r1 = run + v[j];
    if (i0 + j + 1 < count) {  // out is 16-byte aligned and i0 + j even
      *reinterpret_cast<longlong2*>(out + i0 + j) = make_longlong2(run, r1);
    } else if (i0 + j < count) {
      out[i0 + j] = run;
    }
    run = r1 + v[j + 1];
  }
}

template <int THREADS, int ITEMS>
int launch_scan(const void* counts, void* out, long long count, void* scratch,
                cudaStream_t st) {
  constexpr long long tile = (long long)THREADS * ITEMS;
  const long long nblk = count > 0 ? (count + tile - 1) / tile : 1;
  if (nblk > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const bool vec = ((uintptr_t)counts & 15) == 0;
  adder_exclusive_scan_kernel<THREADS, ITEMS><<<(int)nblk, THREADS, 0, st>>>(
      (const int*)counts, (long long*)out, count, (int)nblk, vec,
      (unsigned long long*)scratch);
  return (int)cudaGetLastError();
}

// --- the segment copy: each segment of the staging pool to its offset in
// the output, which the exclusive scan of seg_counts gives in reference
// order (interval, raster pixel, slot). One warp takes 32 consecutive
// segments, each lane reading one segment's count, offset and start; the
// warp then copies its non-empty segments one after another, lane i taking
// entries i, i + 32, ..., so loads and stores are coalesced. Entries at or
// past `cap` are not written; after a staging overflow (flags[2]) nothing
// is, since the chunk's events outgrew the capacity and the caller reruns
// it. WIDE, the wide layout: the staged low word is lane << 8 | d, and the
// segment (interval, warp), warp = segment % n_warps, gives the pixel, so
// the copy writes a u64 pix << 8 | d, (32 warp << 8) + the low word. -----

constexpr int kCopyBlock = 256;

struct CopyArgs {
  const int* counts;            // (segments,) i32
  const long long* offsets;     // (segments + 1,) i64 exclusive
  const long long* seg_start;   // (segments,) i64
  const int* link;              // (pool / slab,) i32
  const unsigned long long* stage;
  const int* flags;
  unsigned* out_pixd;           // (cap,); WIDE: (cap,) u64
  unsigned* out_t;              // (cap,)
  long long segments, cap;
  int slab;
};

template <bool WIDE>
__device__ __forceinline__ void segment_copy(const CopyArgs& a,
                                             long long n_warps) {
  if (a.flags[2]) return;
  const int lane = threadIdx.x & 31;
  const long long j =
      (long long)blockIdx.x * kCopyBlock + threadIdx.x;  // this lane's segment
  int c = 0;
  long long off = 0, start = 0;
  unsigned long long pbase = 0;  // WIDE: the segment's 32 warp << 8
  if (j < a.segments) {
    c = a.counts[j];
    if (c) {
      off = a.offsets[j];
      start = a.seg_start[j];
      if (WIDE) pbase = (unsigned long long)(j % n_warps) << 13;
    }
  }
  unsigned todo = __ballot_sync(kFull, c > 0);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int cs = __shfl_sync(kFull, c, src);
    const long long os = __shfl_sync(kFull, off, src);
    const long long ss = __shfl_sync(kFull, start, src);
    const int first = min(cs, a.slab - (int)(ss % a.slab));
    const long long next =
        cs > first ? (long long)a.link[ss / a.slab] * a.slab : 0;
    unsigned long long pb = 0;
    if (WIDE) pb = __shfl_sync(kFull, pbase, src);
    for (int i = lane; i < cs && os + i < a.cap; i += 32) {
      const unsigned long long e =
          a.stage[i < first ? ss + i : next + (i - first)];
      if (WIDE) {
        reinterpret_cast<unsigned long long*>(a.out_pixd)[os + i] =
            pb + (unsigned)e;
      } else {
        a.out_pixd[os + i] = (unsigned)e;
      }
      a.out_t[os + i] = (unsigned)(e >> 32);
    }
  }
}

__global__ void __launch_bounds__(kCopyBlock)
    adder_segment_copy_kernel(const CopyArgs a) {
  segment_copy<false>(a, 0);
}

__global__ void __launch_bounds__(kCopyBlock)
    adder_segment_copy_wide_kernel(const CopyArgs a, long long n_warps) {
  segment_copy<true>(a, n_warps);
}

// --- the .adder wire records of a chunk's events. Replaces no TPU kernel:
// the JAX package, and the port's host route, fetch the (pixd, t) pairs and
// serialise them on the host (codec/raw.py::encode_events, after Video.
// _events_from_flat splits pix into x, y and c). This writes the same bytes
// on the card, so the host fetches finished records. Each event's record,
// big-endian, R bytes:
//   R = 9  (mono):   x:u16 y:u16 d:u8 t:u32
//   R = 11 (colour): x:u16 y:u16 tag:u8 (= 1) c:u8 d:u8 t:u32
// with c = pix % C, x = (pix / C) % W, y = (pix / C) / W.
// What bounds it: bytes, 8 read (12 in the wide layout) and R written an
// event (a 1080p Raw chunk, 4.3 M events, 73 MB: 0.022 ms at 3.35 TB/s); a
// few integer operations an event. The records are not word-aligned, so a thread's byte stores would
// be scattered and narrow: instead each block builds its kPackEvents records
// in shared memory (one thread an event, coalesced 4-byte loads), then the
// block stores its kPackEvents x R contiguous bytes with aligned 16-byte
// stores (kPackEvents is a multiple of 16, so every block's first byte is
// 16-byte aligned when `out` is). -------------------------------------------

constexpr int kPackThreads = 256;
constexpr int kPackItems = 4;  // events a thread
constexpr int kPackEvents = kPackThreads * kPackItems;

template <int R, typename PD>
__device__ __forceinline__ void wire_pack(const PD* __restrict__ pixd,
                                          const unsigned* __restrict__ t,
                                          unsigned char* __restrict__ out,
                                          long long n, unsigned width,
                                          unsigned channels) {
  static_assert(R == 9 || R == 11, "mono or colour records");
  __shared__ __align__(16) unsigned char rec[kPackEvents * R];
  const long long e0 = (long long)blockIdx.x * kPackEvents;
  const int m = (int)min((long long)kPackEvents, n - e0);
#pragma unroll
  for (int q = 0; q < kPackItems; ++q) {
    const int i = q * kPackThreads + threadIdx.x;
    if (i < m) {
      const PD pd = pixd[e0 + i];
      const unsigned tt = t[e0 + i];
      unsigned xy = (unsigned)(pd >> 8), c = 0;
      if (R == 11) {
        c = xy % channels;
        xy /= channels;
      }
      const unsigned y = xy / width, x = xy - y * width;
      unsigned char* r = rec + i * R;
      r[0] = (unsigned char)(x >> 8);
      r[1] = (unsigned char)x;
      r[2] = (unsigned char)(y >> 8);
      r[3] = (unsigned char)y;
      if (R == 11) {
        r[4] = 1;
        r[5] = (unsigned char)c;
      }
      r[R - 5] = (unsigned char)pd;
      r[R - 4] = (unsigned char)(tt >> 24);
      r[R - 3] = (unsigned char)(tt >> 16);
      r[R - 2] = (unsigned char)(tt >> 8);
      r[R - 1] = (unsigned char)tt;
    }
  }
  __syncthreads();
  const int bytes = m * R, words = bytes / 16;
  unsigned char* dst = out + e0 * R;
  for (int i = threadIdx.x; i < words; i += kPackThreads) {
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(rec)[i];
  }
  for (int i = words * 16 + threadIdx.x; i < bytes; i += kPackThreads) {
    dst[i] = rec[i];
  }
}

template <int R>
__global__ void __launch_bounds__(kPackThreads)
    adder_wire_pack_kernel(const unsigned* __restrict__ pixd,
                           const unsigned* __restrict__ t,
                           unsigned char* __restrict__ out, long long n,
                           unsigned width, unsigned channels) {
  wire_pack<R>(pixd, t, out, n, width, channels);
}

// The wide layout's records: pixd is u64 pix << 8 | d (pix below 2^32).
template <int R>
__global__ void __launch_bounds__(kPackThreads)
    adder_wire_pack_wide_kernel(const unsigned long long* __restrict__ pixd,
                                const unsigned* __restrict__ t,
                                unsigned char* __restrict__ out, long long n,
                                unsigned width, unsigned channels) {
  wire_pack<R>(pixd, t, out, n, width, channels);
}

}  // namespace

extern "C" {

// Mirrored by adder_tpu_torch/ops/fused_resident.py::_CopyArgs.
struct AdderCopyArgs {
  long long segments;
  long long cap;
  int slab;
  const void* counts;
  const void* offsets;
  const void* seg_start;
  const void* link;
  const void* stage;
  const void* flags;
  void* out_pixd;
  void* out_t;
  int wide;           // 1: the wide layout, out_pixd (cap,) u64
  long long n_warps;  // wide: the segments of one interval
};

}  // extern "C"

namespace {

// --- host-side dispatch over the template parameters ------------------------

template <int D, bool FP, bool CO>
void launch_time(const KArgs& k, bool events, bool wide, bool abs_time,
                 cudaStream_t st) {
  if (abs_time) {
    launch_chunk<D, FP, CO, true>(k, events, wide, st);
  } else {
    launch_chunk<D, FP, CO, false>(k, events, wide, st);
  }
}

template <int D, bool FP>
void launch_multi(const KArgs& k, bool events, bool wide, bool collapse,
                  bool abs_time, cudaStream_t st) {
  if (collapse) {
    launch_time<D, FP, true>(k, events, wide, abs_time, st);
  } else {
    launch_time<D, FP, false>(k, events, wide, abs_time, st);
  }
}

template <int D>
void launch_mode(const KArgs& k, bool events, bool wide, bool fp,
                 bool collapse, bool abs_time, cudaStream_t st) {
  if (fp) {
    launch_multi<D, true>(k, events, wide, collapse, abs_time, st);
  } else {
    launch_multi<D, false>(k, events, wide, collapse, abs_time, st);
  }
}

}  // namespace

extern "C" {

int adder_resident_chunk(const AdderChunkArgs* a, void* stream) {
  const bool events = a->events != 0, wide = a->wide != 0;
  if (!chunk_args_ok(a) || (a->depth != 6 && a->depth != 8) ||
      a->view_mode < 0 || a->view_mode > 3 || a->seg_counts == nullptr ||
      a->flags == nullptr || (wide && (!events || a->run0 != nullptr)) ||
      (events && (a->seg_start == nullptr || a->link == nullptr ||
                  a->stage == nullptr || a->cursor == nullptr ||
                  a->pool < 1 || a->pool % (32 * (a->depth + 3)) != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const KArgs k = make_kargs(a);
  cudaStream_t st = (cudaStream_t)stream;
  const bool fp = a->mode == 0, collapse = a->multi_mode == 1;
  const bool abs_time = a->abs_time != 0;
  if (a->depth == 6) {
    launch_mode<6>(k, events, wide, fp, collapse, abs_time, st);
  } else {
    launch_mode<8>(k, events, wide, fp, collapse, abs_time, st);
  }
  return (int)cudaGetLastError();
}

// The staged events of a chunk to their offsets: (segments + 1) offsets
// from adder_exclusive_scan over the chunk's seg_counts, `slab` the chunk
// kernel's (32 x (depth + 3)), `cap` the length of out_pixd and out_t; in
// the wide layout out_pixd is u64 and the segments are (T, n_warps).
int adder_segment_copy(const AdderCopyArgs* a, void* stream) {
  if (a->segments < 1 || a->cap < 0 || a->slab < 1 ||
      (a->wide && (a->n_warps < 1 || a->segments % a->n_warps != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  CopyArgs c;
  c.counts = (const int*)a->counts;
  c.offsets = (const long long*)a->offsets;
  c.seg_start = (const long long*)a->seg_start;
  c.link = (const int*)a->link;
  c.stage = (const unsigned long long*)a->stage;
  c.flags = (const int*)a->flags;
  c.out_pixd = (unsigned*)a->out_pixd;
  c.out_t = (unsigned*)a->out_t;
  c.segments = a->segments;
  c.cap = a->cap;
  c.slab = a->slab;
  const long long grid = (a->segments + kCopyBlock - 1) / kCopyBlock;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (a->wide) {
    adder_segment_copy_wide_kernel<<<(int)grid, kCopyBlock, 0,
                                     (cudaStream_t)stream>>>(c, a->n_warps);
  } else {
    adder_segment_copy_kernel<<<(int)grid, kCopyBlock, 0,
                                (cudaStream_t)stream>>>(c);
  }
  return (int)cudaGetLastError();
}

// A block takes 256 x 8 = 2048 counts (SCAN_TILE in
// adder_tpu_torch/ops/fused_resident.py, which sizes `scratch` from it):
// (ceil(count / 2048), at least 1) + 1 zeroed 64-bit words. `out` holds
// count + 1 i64 and is 16-byte aligned.
int adder_exclusive_scan(const void* counts, void* out, long long count,
                         void* scratch, void* stream) {
  if (count < 0 || ((uintptr_t)out & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_scan<256, 8>(counts, out, count, scratch,
                             (cudaStream_t)stream);
}

// The first n events of a chunk (pixd = pix << 8 | d and t, u32 each; with
// `wide`, pixd u64) to their .adder records in `out` (n x 9 bytes when
// channels is 1, else n x 11; 16-byte aligned), for a plane `width` pixels
// wide. n = 0 launches nothing.
int adder_wire_pack(const void* pixd, const void* t, void* out, long long n,
                    int width, int channels, int wide, void* stream) {
  if (n < 0 || width < 1 || channels < 1 || ((uintptr_t)out & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  const long long grid = (n + kPackEvents - 1) / kPackEvents;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned w = (unsigned)width, ch = (unsigned)channels;
  unsigned char* o = (unsigned char*)out;
  const unsigned* tt = (const unsigned*)t;
  if (wide) {
    const unsigned long long* pd = (const unsigned long long*)pixd;
    if (channels == 1) {
      adder_wire_pack_wide_kernel<9>
          <<<(int)grid, kPackThreads, 0, st>>>(pd, tt, o, n, w, 1u);
    } else {
      adder_wire_pack_wide_kernel<11>
          <<<(int)grid, kPackThreads, 0, st>>>(pd, tt, o, n, w, ch);
    }
  } else if (channels == 1) {
    adder_wire_pack_kernel<9><<<(int)grid, kPackThreads, 0, st>>>(
        (const unsigned*)pixd, (const unsigned*)t, (unsigned char*)out, n,
        (unsigned)width, 1u);
  } else {
    adder_wire_pack_kernel<11><<<(int)grid, kPackThreads, 0, st>>>(
        (const unsigned*)pixd, (const unsigned*)t, (unsigned char*)out, n,
        (unsigned)width, (unsigned)channels);
  }
  return (int)cudaGetLastError();
}

const char* adder_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
