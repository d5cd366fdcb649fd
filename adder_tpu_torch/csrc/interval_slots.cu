// Hopper kernel for one framed interval as K slot planes (sm_90a): K6.
//
// Replaces the TPU kernel adder_tpu/ops/pallas_kernel.py::make_interval_pallas
// (call :177, body _kernel_body :38), the per-interval step of the
// interval-slot engine (adder_tpu/ops/integrate.py::make_transcode_chunk with
// pallas_block > 0, chosen by ADDER_TPU_FUSED=0). The per-pixel logic is
// _interval_core and _running_intensity (integrate.py:638-707) through
// adder_interval.cuh, which lists the exactness rules; the plain PyTorch
// version the kernel is held against is
// adder_tpu_torch/ops/pallas_kernel.py::interval_slots_plain.
//
// Design. One thread per pixel-channel runs one interval of the depth-8
// arena in registers and writes the new state, the K = 11 slot planes
// (slot_d i32, slot_t u32, slot_m u8: (K, n), so a warp's stores are
// contiguous along n; a slot whose mask is clear holds 0), the display
// intensity (run_val, run_has) and adds the block's arena-overflow count
// (__syncthreads_count, then one atomicAdd per block) to the state's
// counter. The TPU block layout ((1, B) rows, the per-block overflow
// broadcast) is not carried over. The compaction into reference order stays
// in the torch glue (integrate.transcode_chunk).
//
// What bounds it. Per pixel it must read the frame byte and the state (187 B
// at depth 8) and write the state, 99 B of slots and 2 B of display: about
// 476 B per pixel, so device memory, at a few hundred scalar ops per pixel.

#include "adder_interval.cuh"

namespace {

template <bool FP, bool CO, bool AB>
__global__ void __launch_bounds__(kBlock)
    adder_interval_slots_kernel(const IArgs a) {
  constexpr int D = 8, K = D + 3;
  const long long n = a.n;
  const long long pix = (long long)blockIdx.x * kBlock + threadIdx.x;
  bool ovf = false;
  if (pix < n) {
    Pixel<D> s;
    load_state(s, a.in, pix, n);
    int sd[K];
    unsigned st[K];
    const int fv = a.frame[pix];
    const unsigned m = run_interval<D, FP, CO, AB>(
        s, __int2float_rn(fv), fv, a.P.time, a.P.c_inc, a.P, sd, st, ovf);
    store_state(s, a.out, pix, n);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool on = (m >> k) & 1u;
      a.slot_d[k * n + pix] = on ? sd[k] : 0;
      a.slot_t[k * n + pix] = on ? st[k] : 0u;
      a.slot_m[k * n + pix] = on;
    }
    const bool has = s.bd[0] >= 0;
    a.run_has[pix] = has;
    a.run_val[pix] = has ? running_intensity(s, a.P) : 0;
  }
  const int n_ovf = __syncthreads_count(ovf);
  if (threadIdx.x == 0 && n_ovf) atomicAdd(a.overflow, n_ovf);
}

struct Launch {
  const IArgs& k;
  cudaStream_t st;
  template <bool FP, bool CO, bool AB>
  void go() {
    adder_interval_slots_kernel<FP, CO, AB><<<k.nblk, kBlock, 0, st>>>(k);
  }
};

}  // namespace

extern "C" {

int adder_interval_slots(const AdderIntervalArgs* a, void* stream) {
  if (!interval_args_ok(a) || a->depth != 8) {
    return (int)cudaErrorInvalidValue;
  }
  const IArgs k = make_iargs(a);
  Launch l{k, (cudaStream_t)stream};
  dispatch_modes(a, l);
  return (int)cudaGetLastError();
}

}  // extern "C"
