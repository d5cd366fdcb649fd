// Hopper kernel for one framed interval with its events in reference order
// (sm_90a): K5.
//
// Replaces the TPU kernel adder_tpu/ops/fused_kernel.py::make_fused_interval
// (call :617, body _kernel_body :218), the per-interval step of the fused
// one-interval engine (adder_tpu/ops/integrate.py::make_fused_chunk, chosen
// by ADDER_TPU_RESIDENT=0). The per-pixel logic is _interval_core and
// _running_intensity (integrate.py:638-707) through adder_interval.cuh,
// which lists the exactness rules; the plain PyTorch version the kernel is
// held against is adder_tpu_torch/ops/fused_kernel.py::fused_interval_plain.
//
// Design. One thread per pixel-channel runs one interval (arena depth 6 or 8
// in registers), writes the new state and, with emit_running, the display
// intensity. Its events (the slots whose bit is set, in slot order; the
// first `pack` of them, the count beyond reported) go to the chunk buffers
// as (pix << 8 | d, t) in (pixel, slot) order, starting at the running
// offset, which stays on the device: one pass, with a single-pass scan
// across blocks (decoupled look-back).
//   - Each block takes a ticket on entry (an atomic counter), so a block
//     only ever waits on blocks that started before it: no deadlock,
//     whatever order the hardware schedules blocks in.
//   - A block scans its threads' kept counts, publishes its aggregate, then
//     looks back over its predecessors' words, a warp's width at a time,
//     until it meets an inclusive prefix, and publishes its own
//     (lookback_exclusive in adder_interval.cuh, shared with the exclusive
//     scan of fused_resident.cu). Block 0 starts from offset_in; the last
//     block writes offset_out.
//   - Events at or past `cap` are dropped; the offset still counts them,
//     so capacity overflow shows as offset > cap without a host read.
//   - flags[0] gets the largest per-pixel count of a real pixel
//     (atomicMax), flags[1] the depth-overflow bit of any pixel (atomicOr);
//     both accumulate over a chunk's launches.
// None of the TPU machinery is carried over: no pltpu interleave, no
// log-shift compaction, no colpick matmul, no staging rows or head replay.
//
// What bounds it. Per pixel it must read the frame byte and the state (147 B
// at depth 6) and write the state and, with emit_running, 2 B of display;
// each event writes 8 B. So device memory: the state crosses HBM every
// interval, where the resident kernel (K1) keeps it on chip for T of them.

#include "adder_interval.cuh"

namespace {

template <int D, bool FP, bool CO, bool AB, bool RUN>
__global__ void __launch_bounds__(kBlock)
    adder_fused_interval_kernel(const IArgs a) {
  constexpr int K = D + 3;
  __shared__ int s_blk;
  __shared__ int s_warp_tot[kWarps];
  __shared__ int s_warp_pre[kWarps];
  __shared__ long long s_base;
  if (threadIdx.x == 0) s_blk = atomicAdd(a.ticket, 1);
  __syncthreads();
  const int blk = s_blk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n = a.n;
  const long long pix = (long long)blk * kBlock + threadIdx.x;

  int sd[K];
  unsigned st[K];
  unsigned m = 0;
  bool ovf = false;
  if (pix < n) {
    Pixel<D> s;
    load_state(s, a.in, pix, n);
    const int fv = a.frame[pix];
    m = run_interval<D, FP, CO, AB>(s, __int2float_rn(fv), fv, a.P.time,
                                    a.P.c_inc, a.P, sd, st, ovf);
    store_state(s, a.out, pix, n);
    const bool has = RUN && s.bd[0] >= 0;
    a.run_has[pix] = has;
    a.run_val[pix] = has ? running_intensity(s, a.P) : 0;
    if (pix >= a.n_real) m = 0;  // plane padding: no events
  }
  const int cnt = __popc(m);
  const int kept = min(cnt, a.pack);

  // block-wide exclusive scan of the kept counts: raster order
  const int x = warp_inclusive_scan(kept, lane);
  if (lane == 31) s_warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kWarps ? s_warp_tot[lane] : 0;
    const int y = warp_inclusive_scan(v, lane);
    if (lane < kWarps) s_warp_pre[lane] = y - v;
    const long long total = __shfl_sync(kFull, y, kWarps - 1);
    const long long excl = lookback_exclusive(
        a.tile, blk, total, blk == 0 ? *a.offset_in : 0, lane);
    if (lane == 0) {
      if (blk == a.nblk - 1) *a.offset_out = excl + total;
      s_base = excl;
    }
  }
  __syncthreads();

  if (kept) {
    long long off = s_base + s_warp_pre[warp] + (x - kept);
    const unsigned pbase = (unsigned)pix << 8;
    int j = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (((m >> k) & 1u) && j < kept) {
        if (off < a.cap) {
          a.out_pixd[off] = pbase | ((unsigned)sd[k] & 0xFFu);
          a.out_t[off] = st[k];
        }
        ++off;
        ++j;
      }
    }
  }
  const int wmax = __reduce_max_sync(kFull, cnt);
  const unsigned wovf = __reduce_or_sync(kFull, ovf ? 1u : 0u);
  if (lane == 0) {
    if (wmax > 0) atomicMax(&a.flags[0], wmax);
    if (wovf) atomicOr(&a.flags[1], 1);
  }
}

template <int D, bool RUN>
struct Launch {
  const IArgs& k;
  cudaStream_t st;
  template <bool FP, bool CO, bool AB>
  void go() {
    adder_fused_interval_kernel<D, FP, CO, AB, RUN>
        <<<k.nblk, kBlock, 0, st>>>(k);
  }
};

template <int D, bool RUN>
void launch(const AdderIntervalArgs* a, const IArgs& k, cudaStream_t st) {
  Launch<D, RUN> l{k, st};
  dispatch_modes(a, l);
}

}  // namespace

extern "C" {

int adder_fused_interval(const AdderIntervalArgs* a, void* stream) {
  if (!interval_args_ok(a) || (a->depth != 6 && a->depth != 8) ||
      a->pack < 1 || a->pack > 16 || a->cap < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const IArgs k = make_iargs(a);
  cudaStream_t st = (cudaStream_t)stream;
  if (a->depth == 6) {
    a->emit_running ? launch<6, true>(a, k, st) : launch<6, false>(a, k, st);
  } else {
    a->emit_running ? launch<8, true>(a, k, st) : launch<8, false>(a, k, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
