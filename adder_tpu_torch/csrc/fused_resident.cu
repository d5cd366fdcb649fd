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
//               (K*T*N exceeds 2^31 for 1080p colour at T = 64) and the total.
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

// --- exclusive scan of the (T, nblk) counts: one block walks the array in
// tiles, carrying the running sum; int64 offsets, total at out[count]. ------

constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;

__global__ void __launch_bounds__(kScanThreads)
    adder_exclusive_scan_kernel(const int* __restrict__ in,
                                long long* __restrict__ out,
                                long long count) {
  __shared__ long long s_tot[32];
  __shared__ long long s_pre[32];
  __shared__ long long s_carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_carry = 0;
  __syncthreads();
  for (long long base = 0; base < count;
       base += (long long)kScanThreads * kScanItems) {
    const long long i0 = base + (long long)threadIdx.x * kScanItems;
    long long v[kScanItems];
    long long local = 0;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      v[j] = i0 + j < count ? (long long)in[i0 + j] : 0;
      local += v[j];
    }
    const long long x = warp_inclusive_scan(local, lane);
    if (lane == 31) s_tot[warp] = x;
    __syncthreads();
    if (warp == 0) {
      const long long w = s_tot[lane];
      s_pre[lane] = warp_inclusive_scan(w, lane) - w;
    }
    __syncthreads();
    long long run = s_carry + s_pre[warp] + (x - local);
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      if (i0 + j < count) out[i0 + j] = run;
      run += v[j];
    }
    __syncthreads();  // every thread has read s_carry
    if (threadIdx.x == kScanThreads - 1) s_carry = run;
    __syncthreads();
  }
  if (threadIdx.x == 0) out[count] = s_carry;
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

int adder_exclusive_scan(const void* counts, void* out, long long count,
                         void* stream) {
  if (count < 0) return (int)cudaErrorInvalidValue;
  adder_exclusive_scan_kernel<<<1, kScanThreads, 0, (cudaStream_t)stream>>>(
      (const int*)counts, (long long*)out, count);
  return (int)cudaGetLastError();
}

const char* adder_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
