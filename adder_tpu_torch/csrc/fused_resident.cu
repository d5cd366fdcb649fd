// Hopper kernels for one framed -> ADΔER transcode chunk (sm_90a).
//
// Replaces the TPU kernel adder_tpu/ops/fused_resident.py::make_resident_call
// (body _kernel_body, :113-672) in its two framed modes:
//   - events fetched: make_fused_chunk_resident (:848)  -> PASS_COUNT, scan, PASS_WRITE
//   - Empty sink:     make_group_chunk_resident (:915)  -> PASS_VOID
// The per-pixel logic is adder_tpu/ops/integrate.py::_interval_core (:638-678)
// and its helpers (:219-613), emit_running=False branch, shared with the DVS
// kernel in adder_interval.cuh (which also lists the exactness rules); the
// plain PyTorch version the kernels are held against is
// adder_tpu_torch/ops/integrate.py.
//
// Design. One thread per pixel-channel. The pixel's whole arena (nd, ni, ndt,
// bd, bdt x DEPTH plus nine scalars) is loaded once into registers and stays
// there across all T intervals of the chunk: this takes the place of the TPU
// kernel's VMEM residency across its sequential interval grid axis. DEPTH is
// a template parameter (6 or 8) and every arena loop is fully unrolled with
// compile-time indices, so the arrays never leave registers (-Xptxas -v
// reports spills). Mode, PixelMultiMode and TimeMode are template parameters
// too, so each of the 8 mode cases compiles to straight-line code.
//
// Event order is the reference's single-thread order (interval, raster
// pixel, slot), written directly, with no host reordering:
//   PASS_COUNT  runs the chunk and writes per-(interval, block) event counts;
//               no state is written.
//   adder_exclusive_scan turns those counts, row-major, into int64 offsets
//               (K*T*N exceeds 2^31 for 1080p colour at T = 64) and the total:
//               one launch of many blocks joined by a decoupled look-back
//               (below). The lane kernels (K3 dense and by rows, K4) use it
//               too, on their own counts.
//   PASS_WRITE  re-runs the chunk from the same input state; per interval a
//               block-wide exclusive scan of the threads' counts places each
//               pixel's events at offset[interval, block] + prefix. It writes
//               the final state.
//   PASS_VOID   (the Empty sink) writes state and counts, no events.
// Every pass folds the largest per-(interval, pixel) event count and the
// arena-depth flag into flags[0] (atomicMax) and flags[1] (atomicOr).
// None of the TPU machinery is carried over: no (8, LN) reshapes, no
// log-shift or band compactors, no head/carry replay, no DMA semaphores, no
// bit-31 validity marker.
//
// What bounds it. Per interval a pixel reads one byte of frame and does a few
// hundred scalar ops; the state is read and written once per chunk, not per
// interval. So the kernel is bound by instruction issue and divergence of the
// per-pixel state machine, not by device memory. The fetched path pays two
// passes over the state machine (COUNT and WRITE) to write events in order
// without a host-side assembler.

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

// --- host-side dispatch over the template parameters ------------------------

template <int D, bool FP, bool CO>
void launch_time(const KArgs& k, int pass, bool abs_time, cudaStream_t st) {
  if (abs_time) {
    launch_pass<D, FP, CO, true, SRC_FRAMED>(k, pass, st);
  } else {
    launch_pass<D, FP, CO, false, SRC_FRAMED>(k, pass, st);
  }
}

template <int D, bool FP>
void launch_multi(const KArgs& k, int pass, bool collapse, bool abs_time,
                  cudaStream_t st) {
  if (collapse) {
    launch_time<D, FP, true>(k, pass, abs_time, st);
  } else {
    launch_time<D, FP, false>(k, pass, abs_time, st);
  }
}

template <int D>
void launch_mode(const KArgs& k, int pass, bool fp, bool collapse,
                 bool abs_time, cudaStream_t st) {
  if (fp) {
    launch_multi<D, true>(k, pass, collapse, abs_time, st);
  } else {
    launch_multi<D, false>(k, pass, collapse, abs_time, st);
  }
}

}  // namespace

extern "C" {

int adder_resident_chunk(const AdderChunkArgs* a, void* stream) {
  if (!chunk_args_ok(a) || a->dvs != SRC_FRAMED ||
      (a->depth != 6 && a->depth != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  const KArgs k = make_kargs(a);
  cudaStream_t st = (cudaStream_t)stream;
  const bool fp = a->mode == 0, collapse = a->multi_mode == 1;
  const bool abs_time = a->abs_time != 0;
  if (a->depth == 6) {
    launch_mode<6>(k, a->pass, fp, collapse, abs_time, st);
  } else {
    launch_mode<8>(k, a->pass, fp, collapse, abs_time, st);
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

const char* adder_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
