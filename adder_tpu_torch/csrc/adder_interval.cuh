// The per-pixel ADΔER state machine shared by the Hopper chunk kernels
// (fused_resident.cu: framed, K1/K2, and the exclusive scan;
// dvs_resident.cu: DVS lanes, K3, from planes and by rows;
// davis_resident.cu: DAVIS lanes, K4) and by the one-interval kernels
// (fused_interval.cu: K5; interval_slots.cu: K6).
//
// The per-pixel logic is adder_tpu/ops/integrate.py::_interval_core
// (:638-678) and its helpers (:219-613), emit_running=False branch, and the
// DAVIS step adder_tpu/ops/dvs_batch.py::davis_event_interval (:520-572),
// composed from the same helpers; the plain PyTorch versions the kernels
// are held against are adder_tpu_torch/ops/integrate.py and
// adder_tpu_torch/ops/dvs_batch.py. The design notes, and what each kernel
// replaces, are in the .cu files. Everything here sits in an anonymous
// namespace: each translation unit instantiates what it launches.
//
// Exactness (each line is a place where the reference's f32 semantics could
// break):
//   - Division: the payload division (integrate.py:499-501,579-584, there
//     exact_div / exact_div_uint24) is __fdiv_rn, IEEE round-to-nearest.
//   - FMA contraction: built with --fmad=false, and the fenced sites
//     (t_prop / i_prop, dt + t_prop, i_cur - i_prop, t_cur - t_prop;
//     integrate.py:512-514,532-533,592-593) use __fmul_rn / __fadd_rn /
//     __fsub_rn, which never contract. Never -use_fast_math, never -ftz=true.
//   - as_u32 (integrate.py:253-261): Rust `f32 as u32`, truncating,
//     saturating, NaN -> 0, following the XLA branch (clamp at 4294967295.0,
//     which is 2^32 in f32), not the Mosaic one at 2^31.
//   - u32 arithmetic: the FramePerfect rounding of last_fired_t to ref_time
//     (:273-277) is unsigned and wraps as u32 does. The adaptive c_thresh
//     update (:602-613) takes (velocity - 1) % 256 from the host and the
//     increment (u32(time) // ref_time) % 256 from the host for a framed
//     chunk (one time for all pixels) or per pixel for a DVS sub-step;
//     min(..., 255) stays here.
//   - Bitcasts (_d_from_intensity / _dshift_f32, :219-235) are
//     __float_as_int / __int_as_float.
//   - The 24-bit pixel field: pix << 8 | d aliases planes of 2^24
//     pixel-channels or more; the wrappers and the entry points refuse them.
//   - state.overflow is passed through unchanged, as the resident TPU kernel
//     does (fused_resident.py:836); the depth flag reports overflow instead.
//   - Depth is a template parameter; a caller compares state at equal depth.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // pixels per block; BLOCK in fused_resident.py
constexpr int kWarps = kBlock / 32;
constexpr int kMaxT = 128;  // intervals per chunk; MAX_T in fused_resident.py
constexpr int D_MAX = 127;
constexpr int D_ZERO = 128;  // D_ZERO_INTEGRATION
constexpr int D_EMPTY = 255;
constexpr float F32_EPS = 1.1920929e-07f;
constexpr unsigned kFull = 0xFFFFFFFFu;

enum { PASS_COUNT = 0, PASS_WRITE = 1, PASS_VOID = 2 };
// What a sub-step reads: a framed u8 plane, the DVS planes or the DAVIS planes
enum { SRC_FRAMED = 0, SRC_DVS = 1, SRC_DAVIS = 2 };

struct Params {
  float time;   // framed: ticks spanned by one interval
  float ref_f;  // f32(ref_time)
  float dtm_f;  // f32(delta_t_max)
  unsigned ref_u;
  int c_thresh_max;
  int vel_m1;  // (c_increase_velocity - 1) % 256
  int c_inc;   // framed: (u32(time) // ref_time) % 256
  int view_mode;  // display intensity: 0 Intensity, 1 D, 2 DeltaT, 3 SAE
  float pdm;      // D view: f32(log2(255 * delta_t_max / ref_time))
};

struct StateIn {
  const int* nd;
  const float* ni;
  const float* ndt;
  const int* bd;
  const float* bdt;
  const int* length;
  const int* base_val;
  const int* c_thresh;
  const int* cic;
  const float* lft;
  const float* running_t;
  const uint8_t* need_pop;
  const uint8_t* dtm_reached;
  const uint8_t* popped_dtm;
};

struct StateOut {
  int* nd;
  float* ni;
  float* ndt;
  int* bd;
  float* bdt;
  int* length;
  int* base_val;
  int* c_thresh;
  int* cic;
  float* lft;
  float* running_t;
  uint8_t* need_pop;
  uint8_t* dtm_reached;
  uint8_t* popped_dtm;
};

struct KArgs {
  StateIn in;
  StateOut out;
  const uint8_t* frames;  // framed: (T, n) u8
  const float* inten;     // DVS: (T, n) f32 intensity; DAVIS: first_int
  const float* tspan;     // DVS: (T, n) f32 ticks spanned; DAVIS: dt_ticks
  const int* fvw;         // DVS, DAVIS: (T, n) i32 fv | active << 8
  const float* fval;      // DAVIS: (T, n) f32 post-ln-step frame value
  long long n;
  int T;
  int nblk;
  Params P;
  int* block_counts;        // (T, nblk) i32: COUNT, VOID
  const long long* offsets; // (T, nblk) i64 exclusive offsets: WRITE
  unsigned* out_pixd;       // (total,) pix << 8 | d: WRITE
  unsigned* out_t;          // (total,) event t: WRITE
  int* flags;               // [max per-pixel count, depth overflow]
};

template <int D>
struct Pixel {
  int nd[D];
  float ni[D];
  float ndt[D];
  int bd[D];
  float bdt[D];
  int length, base_val, c_thresh, cic;
  float lft, running_t;
  bool need_pop, dtm_reached, popped_dtm;
};

// --- f32 exponent-bit helpers (integrate.py:219-235) -------------------------

__device__ __forceinline__ int d_from_intensity(float x) {
  const int e = ((__float_as_int(x) >> 23) & 0xFF) - 127;
  return x < 1.0f ? D_ZERO : min(e, D_MAX);
}

__device__ __forceinline__ float dshift(int d) {
  return d >= 128 ? 0.0f : __int_as_float((min(d, D_MAX) + 127) << 23);
}

// Rust `f32 as u32` (integrate.py:253-261, XLA branch)
__device__ __forceinline__ unsigned as_u32(float x) {
  if (!(x > 0.0f)) return 0u;  // NaN, zeros, negatives, -inf
  if (x >= 4294967296.0f) return kFull;
  return __float2uint_rz(x);
}

// delta_t -> event t and the new last_fired_t (integrate.py:267-287)
template <bool FP, bool ABS>
__device__ __forceinline__ unsigned emit_abs(float lft, float dt, unsigned ref,
                                             float& new_lft) {
  if (!ABS) {
    new_lft = lft;
    return as_u32(dt);
  }
  const float dtt = __fadd_rn(dt, lft);
  new_lft = dtt;
  if (FP) {
    const unsigned lf = as_u32(dtt);
    const unsigned rounded = (lf % ref == 0u) ? lf : (lf / ref + 1u) * ref;
    new_lft = __uint2float_rn(rounded);
  }
  return as_u32(dtt);
}

// --- pop_top_event (integrate.py:293-340); called where need_pop ------------

template <int D, bool FP, bool ABS>
__device__ __forceinline__ void pop_top(Pixel<D>& s, float next_i,
                                        const Params& P, int& ev_d,
                                        unsigned& ev_t) {
  const float n0_integ = s.ni[0], n0_dt = s.ndt[0];
  const int n0_best = s.bd[0];
  const bool has_best = n0_best >= 0;
  const bool zero_case = !has_best && n0_integ == 0.0f && n0_dt > 0.0f;
  const bool synth_case = !has_best && !zero_case;
  const int synth_d = n0_integ < 1.0f ? D_ZERO : d_from_intensity(n0_integ);
  ev_d = zero_case ? D_ZERO : (has_best ? n0_best : synth_d);
  float new_lft;
  ev_t = emit_abs<FP, ABS>(s.lft, has_best ? s.bdt[0] : n0_dt, P.ref_u,
                           new_lft);
  if (ABS) s.lft = new_lft;
  if (!zero_case) {
#pragma unroll
    for (int i = 0; i < D - 1; ++i) {
      s.nd[i] = s.nd[i + 1];
      s.ni[i] = s.ni[i + 1];
      s.ndt[i] = s.ndt[i + 1];
      s.bd[i] = s.bd[i + 1];
      s.bdt[i] = s.bdt[i + 1];
    }
  }
  const int new_d0 = d_from_intensity(next_i);
  if (synth_case) {
    s.nd[0] = new_d0;
    s.ni[0] = 0.0f;
    s.ndt[0] = 0.0f;
    s.bd[0] = -1;
  }
  if (zero_case) {
    s.ndt[0] = 0.0f;
    s.nd[0] = new_d0;
  }
  s.length = synth_case ? 1 : (has_best ? s.length - 1 : s.length);
  s.need_pop = false;
  s.popped_dtm = true;
}

// --- pop_best_events (integrate.py:346-420); called where the contrast
// threshold is crossed. Fills slots OFF..OFF+D-1 of sd/st and their bits in
// m (OFF is 1 in the framed slot order, 2 in the DAVIS one). ----------------

template <int D, bool FP, bool ABS, bool COLLAPSE, int OFF>
__device__ __forceinline__ void pop_best(Pixel<D>& s, float intensity,
                                         const Params& P, int (&sd)[D + 3],
                                         unsigned (&st)[D + 3], unsigned& m) {
  bool any_emit = false, tail_zeroed = false;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const bool has_best = s.bd[k] >= 0;
    const bool zero_ev = !has_best && s.ndt[k] > 0.0f && s.ni[k] == 0.0f;
    const bool emit = k < s.length && (has_best || zero_ev);
    float new_lft;
    sd[OFF + k] = has_best ? s.bd[k] : D_ZERO;
    st[OFF + k] = emit_abs<FP, ABS>(s.lft, has_best ? s.bdt[k] : s.ndt[k],
                                    P.ref_u, new_lft);
    if (emit) {
      m |= 1u << (OFF + k);
      if (ABS) s.lft = new_lft;
    }
    any_emit = any_emit || emit;
    tail_zeroed = tail_zeroed || (emit && zero_ev && s.length - 1 == k);
  }
  bool collapse = false;
  if (COLLAPSE && s.popped_dtm && any_emit) {
    // keep the first event plus a D_EMPTY filler at running_t (ref :249-265)
    collapse = true;
    int first_d = 0;
    unsigned first_t = 0;
    bool found = false;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const bool e = (m >> (OFF + k)) & 1u;
      if (e && !found) {
        first_d = sd[OFF + k];
        first_t = st[OFF + k];
      }
      found = found || e;
    }
    sd[OFF] = first_d;
    st[OFF] = first_t;
    sd[OFF + 1] = D_EMPTY;
    st[OFF + 1] = as_u32(s.running_t);
    m = (m & ~(((1u << D) - 1u) << OFF)) | (1u << OFF) | (1u << (OFF + 1));
    s.lft = s.running_t;
  }
  // arena reset: normal -> arena[0] = tail node; collapse -> fresh node
  int tail_d = 0;
  float tail_integ = 0.0f, tail_dt = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (s.length - 1 == k) {
      tail_d = s.nd[k];
      tail_integ = s.ni[k];
      tail_dt = s.ndt[k];
    }
  }
  if (tail_zeroed) tail_dt = 0.0f;
  s.nd[0] = collapse ? d_from_intensity(intensity) : tail_d;
  s.ni[0] = collapse ? 0.0f : tail_integ;
  s.ndt[0] = collapse ? 0.0f : tail_dt;
  s.bd[0] = -1;
  s.length = 1;
  s.need_pop = false;
  s.dtm_reached = false;
  s.popped_dtm = false;
}

// --- set_d_for_continuous (integrate.py:426-435); Continuous mode, called
// where the contrast threshold is crossed. Returns whether the filler fires. --

template <int D, bool ABS>
__device__ __forceinline__ bool set_d_for_continuous(Pixel<D>& s,
                                                     float intensity,
                                                     const Params& P,
                                                     unsigned& ev_t) {
  const int next_d = d_from_intensity(intensity);
  const bool fire = next_d < s.nd[0] && s.ndt[0] > 0.0f;
  float new_lft;
  ev_t = emit_abs<false, ABS>(s.lft, s.ndt[0], P.ref_u, new_lft);
  if (fire) {
    if (ABS) s.lft = new_lft;
    s.ndt[0] = 0.0f;
    s.ni[0] = 0.0f;
  }
  s.nd[0] = next_d;
  return fire;
}

// --- integrate (integrate.py:441-613). Returns whether the last node fired
// (the arena outgrew DEPTH). With SKIP the walk branches over the nodes past
// its end instead of running them predicated off: the same function (a
// node past the end changes nothing), cheaper where the threads of a warp
// do not walk in step anyway (the row walk). ----------------------------------

template <int D, bool FP, bool COLLAPSE, bool SKIP = false>
__device__ __forceinline__ bool integrate(Pixel<D>& s, float intensity,
                                          float time, int c_inc,
                                          const Params& P) {
  // tail D re-aim for virgin tail nodes (ref :332-335)
  float tail_integ = 0.0f, tail_dt = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (s.length - 1 == k) {
      tail_integ = s.ni[k];
      tail_dt = s.ndt[k];
    }
  }
  const bool tail_virgin = tail_dt == 0.0f && tail_integ == 0.0f;
  const int d_aim = d_from_intensity(intensity);
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (s.length - 1 == k && tail_virgin) s.nd[k] = d_aim;
  }

  s.running_t = __fadd_rn(s.running_t, time);
  float i_cur = intensity, t_cur = time;
  bool active = true, ovf = false;
  const bool collapse_brk = COLLAPSE && s.popped_dtm;
  // FramePerfect: the walk stops at the first fire, so the payload division
  // runs once, after the walk, from the firing node's pre-fire values
  unsigned fire_ks = 0;
  int snap_d = 0;
  float snap_integ = 0.0f, snap_dt = 0.0f;
  const int child_d0 = d_from_intensity(i_cur);

#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (SKIP && !active) continue;
    const int d = s.nd[k];
    const float integ = s.ni[k], dt = s.ndt[k];
    const float total = __fadd_rn(integ, i_cur);
    const bool fire = active && total >= dshift(d);
    const int new_d = d_from_intensity(total);
    float fired_best_dt = 0.0f, next_i = 0.0f, next_t = 0.0f;
    if (FP) {
      if (fire) {
        fire_ks |= 1u << k;
        snap_d = d;
        snap_integ = integ;
        snap_dt = dt;
      }
    } else {
      float prop = __fdiv_rn(__fsub_rn(dshift(new_d), integ), i_cur);
      if (new_d == D_ZERO || d == D_ZERO || i_cur < F32_EPS) prop = 1.0f;
      const float t_prop = __fmul_rn(t_cur, prop);
      const float i_prop = __fmul_rn(i_cur, prop);
      fired_best_dt = __fadd_rn(dt, t_prop);
      const float rem_i = __fsub_rn(i_cur, i_prop);
      const float rem_t = __fsub_rn(t_cur, t_prop);
      const bool neg = rem_i < 0.0f;
      next_i = neg ? 0.0f : rem_i;
      next_t = neg ? 0.0f : rem_t;
    }
    // D bump for continued integration (ref :449-461)
    const bool bump = new_d < D_MAX;
    const int d_bumped = min(new_d + 1, 128);
    const bool accum = active && !fire;
    const bool grow = (fire && bump) || accum;
    s.nd[k] = fire ? (bump ? d_bumped : new_d) : d;
    s.ni[k] = grow ? total : integ;
    s.ndt[k] = grow ? __fadd_rn(dt, t_cur) : dt;
    if (!FP && fire) {
      s.bd[k] = new_d;
      s.bdt[k] = fired_best_dt;
    }
    // child creation at k + 1 (ref :344-355)
    const int child_d = FP ? child_d0 : d_from_intensity(i_cur);
    if (k + 1 < D) {
      if (fire) {
        s.nd[k + 1] = child_d;
        s.ni[k + 1] = 0.0f;
        s.ndt[k + 1] = 0.0f;
        s.bd[k + 1] = -1;
      }
    } else {
      ovf = ovf || fire;
    }
    if (fire) s.length = k + 2;

    bool brk = collapse_brk;
    if (FP) {
      brk = brk || fire;
    } else {
      if (fire) {
        i_cur = next_i;
        t_cur = next_t;
      }
      if (k + 1 < D && fire && !collapse_brk && t_cur > P.ref_f) {
        s.nd[k + 1] = d_from_intensity(i_cur);
      }
      brk = brk || (fire && i_cur == 0.0f);
    }
    brk = brk || (k + 1 >= s.length);
    active = active && !brk;
  }

  if (FP && fire_ks) {
    const float total_f = __fadd_rn(snap_integ, i_cur);
    const int new_d_f = d_from_intensity(total_f);
    float prop = __fdiv_rn(__fsub_rn(dshift(new_d_f), snap_integ), i_cur);
    if (new_d_f == D_ZERO || snap_d == D_ZERO || i_cur < F32_EPS) prop = 1.0f;
    const float best_dt_f = __fadd_rn(snap_dt, __fmul_rn(t_cur, prop));
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if ((fire_ks >> k) & 1u) {
        s.bd[k] = new_d_f;
        s.bdt[k] = best_dt_f;
      }
    }
  }

  s.length = min(s.length, D);  // overflow containment
  s.dtm_reached = s.ndt[0] >= P.dtm_f;
  s.need_pop = s.nd[0] == D_MAX || (s.dtm_reached && !s.popped_dtm);

  // adaptive c_thresh (ref :402-412)
  const bool adapting = s.c_thresh < P.c_thresh_max;
  if (adapting && s.cic >= P.vel_m1) {
    s.c_thresh = min(s.c_thresh + 1, 255);
    s.cic = 0;
  } else if (adapting) {
    s.cic = min(s.cic + c_inc, 255);
  }
  return ovf;
}

// --- one interval for one pixel (integrate.py:638-678). Slot k of the
// reference is bit k of the returned mask: 0 pre-integration pop_top,
// 1..D pop_best, D+1 set_d filler, D+2 post-integration pop_top. Framed
// intervals pass intensity = f32(fv) and the chunk's time; DVS sub-steps
// pass their per-pixel planes. -----------------------------------------------

template <int D, bool FP, bool COLLAPSE, bool ABS, bool SKIP = false>
__device__ __forceinline__ unsigned run_interval(
    Pixel<D>& s, float intensity, int fv, float time, int c_inc,
    const Params& P, int (&sd)[D + 3], unsigned (&st)[D + 3], bool& ovf) {
  unsigned m = 0;
  if (s.need_pop) {
    pop_top<D, FP, ABS>(s, intensity, P, sd[0], st[0]);
    m |= 1u;
  }
  const int bv = s.base_val, c = s.c_thresh;
  if (fv < max(bv - c, 0) || fv > min(bv + c, 255)) {
    pop_best<D, FP, ABS, COLLAPSE, 1>(s, intensity, P, sd, st, m);
    s.base_val = fv;
    if (!FP && set_d_for_continuous<D, ABS>(s, intensity, P, st[D + 1])) {
      sd[D + 1] = D_EMPTY;
      m |= 1u << (D + 1);
    }
  }
  ovf = integrate<D, FP, COLLAPSE, SKIP>(s, intensity, time, c_inc, P);
  if (s.need_pop) {
    pop_top<D, FP, ABS>(s, intensity, P, sd[D + 2], st[D + 2]);
    m |= 1u << (D + 2);
  }
  return m;
}

// --- one DAVIS DVS event for one pixel (dvs_batch.py::davis_event_interval,
// :520-572; ref davis.rs:235-465). Continuous mode. The op order differs
// from run_interval: pop_top, integrate the held intensity first_int over
// the gap dt_ticks, pop_top, then the contrast stage against the
// post-ln-step frame value (fv8 for the threshold test, fval for pop_best
// and set_d). Slot k of the pixel's chronological order is bit k of the
// returned mask: 0 pre-integration pop_top, 1 post-integration pop_top,
// 2..D+1 pop_best, D+2 set_d filler. --------------------------------------

template <int D, bool COLLAPSE, bool ABS>
__device__ __forceinline__ unsigned run_davis_event(
    Pixel<D>& s, float first_int, float dt_ticks, float fval, int fv8,
    int c_inc, const Params& P, int (&sd)[D + 3], unsigned (&st)[D + 3],
    bool& ovf) {
  unsigned m = 0;
  if (s.need_pop) {
    pop_top<D, false, ABS>(s, first_int, P, sd[0], st[0]);
    m |= 1u;
  }
  ovf = integrate<D, false, COLLAPSE>(s, first_int, dt_ticks, c_inc, P);
  if (s.need_pop) {
    pop_top<D, false, ABS>(s, first_int, P, sd[1], st[1]);
    m |= 2u;
  }
  // base_val and c_thresh as integrate left them (the adaptive update)
  const int bv = s.base_val, c = s.c_thresh;
  if (fv8 < max(bv - c, 0) || fv8 > min(bv + c, 255)) {
    pop_best<D, false, ABS, COLLAPSE, 2>(s, fval, P, sd, st, m);
    s.base_val = fv8;
    if (set_d_for_continuous<D, ABS>(s, fval, P, st[D + 2])) {
      sd[D + 2] = D_EMPTY;
      m |= 1u << (D + 2);
    }
  }
  return m;
}

// --- the display intensity (integrate.py:681-707) of a pixel whose root
// holds a best event (s.bd[0] >= 0): every division __fdiv_rn, the product
// after it __fmul_rn, then a truncating clip to u8. --------------------------

template <int D>
__device__ __forceinline__ uint8_t running_intensity(const Pixel<D>& s,
                                                     const Params& P) {
  const int bd = s.bd[0];
  const float bdt = s.bdt[0];
  float val;
  if (P.view_mode == 1) {  // D
    val = __fmul_rn(__fdiv_rn(__int2float_rn(bd), P.pdm), 255.0f);
  } else if (P.view_mode == 2) {  // DeltaT
    val = __fmul_rn(__fdiv_rn(bdt, P.dtm_f), 255.0f);
  } else if (P.view_mode == 3) {  // SAE
    val = __fmul_rn(__fdiv_rn(__fsub_rn(s.running_t, s.lft), P.dtm_f),
                    255.0f);
  } else {  // Intensity: 2^d / dt * ticks per frame
    val = __fmul_rn(__fdiv_rn(dshift(bd), bdt == 0.0f ? 1.0f : bdt), P.ref_f);
  }
  return (uint8_t)__float2int_rz(fminf(fmaxf(val, 0.0f), 255.0f));
}

template <int D>
__device__ __forceinline__ void load_state(Pixel<D>& s, const StateIn& in,
                                           long long pix, long long n) {
#pragma unroll
  for (int k = 0; k < D; ++k) {
    s.nd[k] = in.nd[k * n + pix];
    s.ni[k] = in.ni[k * n + pix];
    s.ndt[k] = in.ndt[k * n + pix];
    s.bd[k] = in.bd[k * n + pix];
    s.bdt[k] = in.bdt[k * n + pix];
  }
  s.length = in.length[pix];
  s.base_val = in.base_val[pix];
  s.c_thresh = in.c_thresh[pix];
  s.cic = in.cic[pix];
  s.lft = in.lft[pix];
  s.running_t = in.running_t[pix];
  s.need_pop = in.need_pop[pix] != 0;
  s.dtm_reached = in.dtm_reached[pix] != 0;
  s.popped_dtm = in.popped_dtm[pix] != 0;
}

template <int D>
__device__ __forceinline__ void store_state(const Pixel<D>& s,
                                            const StateOut& out,
                                            long long pix, long long n) {
#pragma unroll
  for (int k = 0; k < D; ++k) {
    out.nd[k * n + pix] = s.nd[k];
    out.ni[k * n + pix] = s.ni[k];
    out.ndt[k * n + pix] = s.ndt[k];
    out.bd[k * n + pix] = s.bd[k];
    out.bdt[k * n + pix] = s.bdt[k];
  }
  out.length[pix] = s.length;
  out.base_val[pix] = s.base_val;
  out.c_thresh[pix] = s.c_thresh;
  out.cic[pix] = s.cic;
  out.lft[pix] = s.lft;
  out.running_t[pix] = s.running_t;
  out.need_pop[pix] = s.need_pop;
  out.dtm_reached[pix] = s.dtm_reached;
  out.popped_dtm[pix] = s.popped_dtm;
}

template <typename V>
__device__ __forceinline__ V warp_inclusive_scan(V x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const V y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// --- decoupled look-back: the exclusive prefix of one block's total across
// the blocks of a single launch (fused_interval.cu: K5's event offsets;
// fused_resident.cu: the exclusive scan). `blk` is the block's ticket (an
// atomic counter taken on entry), so a block waits only on blocks that
// started before it, whatever order the hardware schedules them in. A word
// of `tile` (zeroed before the launch) is value << 2 | status in one 64-bit
// location, written with atomicExch and read volatile, so a status is never
// seen without its value and no fence is needed. Every lane of one warp
// calls this with the same arguments; the warp reads 32 predecessors at a
// time and stops at the nearest one that has published its inclusive
// prefix. Block 0 starts from `first`. -----------------------------------

constexpr unsigned long long kAggregate = 1, kInclusive = 2;

__device__ __forceinline__ void lookback_publish(unsigned long long* word,
                                                 unsigned long long status,
                                                 long long value) {
  atomicExch(word, ((unsigned long long)value << 2) | status);
}

__device__ __forceinline__ long long lookback_exclusive(
    unsigned long long* tile, int blk, long long total, long long first,
    int lane) {
  long long excl = first;
  if (blk > 0) {
    if (lane == 0) lookback_publish(&tile[blk], kAggregate, total);
    excl = 0;
    for (int base = blk - 1; base >= 0; base -= 32) {
      const int j = base - lane;
      unsigned long long w = kInclusive;  // before block 0: a prefix of 0
      if (j >= 0) {
        do {
          w = *(volatile unsigned long long*)&tile[j];
        } while ((w & 3ull) == 0);
      }
      const unsigned inc = __ballot_sync(kFull, (w & 3ull) == kInclusive);
      const int stop = inc ? __ffs(inc) - 1 : 31;
      long long v = lane <= stop ? (long long)(w >> 2) : 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
      excl += v;
      if (inc) break;
    }
  }
  if (lane == 0) lookback_publish(&tile[blk], kInclusive, excl + total);
  return excl;
}

// --- the chunk kernel: one thread per pixel, the arena in registers across
// the T intervals (framed) or sub-steps (DVS, DAVIS). DVS sub-steps read
// three planes, DAVIS sub-steps four; a pixel whose active bit is clear
// skips the sub-step, which equals the reference's compute-then-restore
// (every field restored, every slot masked, no overflow count: ovf_mask =
// active). -------------------------------------------------------------------

template <int D, bool FP, bool COLLAPSE, bool ABS, int PASS, int SRC>
__global__ void __launch_bounds__(kBlock)
    adder_resident_chunk_kernel(const KArgs a) {
  constexpr int K = D + 3;
  __shared__ int s_counts[kMaxT];   // COUNT / VOID: block's events per interval
  __shared__ int s_warp_tot[kWarps];  // WRITE: per-warp event totals
  __shared__ int s_warp_pre[kWarps];  // WRITE: their exclusive prefix
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n = a.n;
  const long long pix = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool valid = pix < n;  // the ragged last block

  if (PASS != PASS_WRITE) {
    for (int i = threadIdx.x; i < a.T; i += kBlock) s_counts[i] = 0;
    __syncthreads();
  }
  Pixel<D> s;
  if (valid) load_state(s, a.in, pix, n);
  int maxcnt = 0;
  bool ovf_any = false;

  for (int t = 0; t < a.T; ++t) {
    int sd[K];
    unsigned st[K];
    unsigned m = 0;
    if (valid) {
      const long long idx = (long long)t * n + pix;
      bool ovf = false;
      if constexpr (SRC == SRC_DVS || SRC == SRC_DAVIS) {
        const int w = a.fvw[idx];
        if ((w >> 8) & 1) {
          const float tspan = a.tspan[idx];
          // (u32(time) // ref_time) % 256 per pixel (integrate.py:606-609)
          const int c_inc = (int)((as_u32(tspan) / a.P.ref_u) % 256u);
          if constexpr (SRC == SRC_DVS) {
            m = run_interval<D, FP, COLLAPSE, ABS>(s, a.inten[idx], w & 0xFF,
                                                   tspan, c_inc, a.P, sd, st,
                                                   ovf);
          } else {
            m = run_davis_event<D, COLLAPSE, ABS>(s, a.inten[idx], tspan,
                                                  a.fval[idx], w & 0xFF,
                                                  c_inc, a.P, sd, st, ovf);
          }
        }
      } else {
        const int fv = a.frames[idx];
        m = run_interval<D, FP, COLLAPSE, ABS>(s, __int2float_rn(fv), fv,
                                               a.P.time, a.P.c_inc, a.P, sd,
                                               st, ovf);
      }
      ovf_any = ovf_any || ovf;
    }
    const int cnt = __popc(m);
    maxcnt = max(maxcnt, cnt);
    if (PASS == PASS_WRITE) {
      // block-wide exclusive scan of the per-pixel counts: raster order
      const int x = warp_inclusive_scan(cnt, lane);
      if (lane == 31) s_warp_tot[warp] = x;
      __syncthreads();
      if (warp == 0) {
        const int v = lane < kWarps ? s_warp_tot[lane] : 0;
        const int y = warp_inclusive_scan(v, lane);
        if (lane < kWarps) s_warp_pre[lane] = y - v;
      }
      __syncthreads();
      if (cnt) {
        long long off = a.offsets[(long long)t * a.nblk + blockIdx.x] +
                        s_warp_pre[warp] + (x - cnt);
        const unsigned pbase = (unsigned)pix << 8;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if ((m >> k) & 1u) {
            a.out_pixd[off] = pbase | ((unsigned)sd[k] & 0xFFu);
            a.out_t[off] = st[k];
            ++off;
          }
        }
      }
    } else {
      const int wsum = __reduce_add_sync(kFull, cnt);
      if (lane == 0 && wsum) atomicAdd(&s_counts[t], wsum);
    }
  }

  if (PASS != PASS_COUNT && valid) store_state(s, a.out, pix, n);
  if (PASS != PASS_WRITE) {
    __syncthreads();
    for (int i = threadIdx.x; i < a.T; i += kBlock) {
      a.block_counts[(long long)i * a.nblk + blockIdx.x] = s_counts[i];
    }
  }
  const int wmax = __reduce_max_sync(kFull, maxcnt);
  const unsigned wovf = __reduce_or_sync(kFull, ovf_any ? 1u : 0u);
  if (lane == 0) {
    if (wmax > 0) atomicMax(&a.flags[0], wmax);
    if (wovf) atomicOr(&a.flags[1], 1);
  }
}

}  // namespace

extern "C" {

// Mirrored by adder_tpu_torch/ops/fused_resident.py::_ChunkArgs.
struct AdderChunkArgs {
  int pass;        // PASS_COUNT, PASS_WRITE, PASS_VOID
  int mode;        // Mode: 0 FramePerfect, 1 Continuous
  int multi_mode;  // PixelMultiMode: 0 Normal, 1 Collapse
  int abs_time;    // TimeMode == AbsoluteT
  int depth;       // framed: 6 or 8; DVS: 16
  int T;
  long long n;
  float time;      // framed only
  int ref_time;
  int delta_t_max;
  int c_thresh_max;
  int vel_m1;
  int c_inc;       // framed only
  const void* frames;
  const void* state_in[14];
  void* state_out[14];
  void* block_counts;
  const void* offsets;
  void* out_pixd;
  void* out_t;
  void* flags;
  int dvs;         // which entry point: SRC_FRAMED, SRC_DVS or SRC_DAVIS
  const void* inten;
  const void* tspan;
  const void* fvw;
  const void* fval;  // DAVIS only
};

}  // extern "C"

namespace {

// The checks both entry points share; the caller adds its own on depth,
// mode and inputs.
inline bool chunk_args_ok(const AdderChunkArgs* a) {
  return a->pass >= PASS_COUNT && a->pass <= PASS_VOID && a->T >= 1 &&
         a->T <= kMaxT && a->n >= 1 && a->n < (1LL << 24) &&
         a->ref_time >= 1;
}

inline KArgs make_kargs(const AdderChunkArgs* a) {
  KArgs k;
  k.in.nd = (const int*)a->state_in[0];
  k.in.ni = (const float*)a->state_in[1];
  k.in.ndt = (const float*)a->state_in[2];
  k.in.bd = (const int*)a->state_in[3];
  k.in.bdt = (const float*)a->state_in[4];
  k.in.length = (const int*)a->state_in[5];
  k.in.base_val = (const int*)a->state_in[6];
  k.in.c_thresh = (const int*)a->state_in[7];
  k.in.cic = (const int*)a->state_in[8];
  k.in.lft = (const float*)a->state_in[9];
  k.in.running_t = (const float*)a->state_in[10];
  k.in.need_pop = (const uint8_t*)a->state_in[11];
  k.in.dtm_reached = (const uint8_t*)a->state_in[12];
  k.in.popped_dtm = (const uint8_t*)a->state_in[13];
  k.out.nd = (int*)a->state_out[0];
  k.out.ni = (float*)a->state_out[1];
  k.out.ndt = (float*)a->state_out[2];
  k.out.bd = (int*)a->state_out[3];
  k.out.bdt = (float*)a->state_out[4];
  k.out.length = (int*)a->state_out[5];
  k.out.base_val = (int*)a->state_out[6];
  k.out.c_thresh = (int*)a->state_out[7];
  k.out.cic = (int*)a->state_out[8];
  k.out.lft = (float*)a->state_out[9];
  k.out.running_t = (float*)a->state_out[10];
  k.out.need_pop = (uint8_t*)a->state_out[11];
  k.out.dtm_reached = (uint8_t*)a->state_out[12];
  k.out.popped_dtm = (uint8_t*)a->state_out[13];
  k.frames = (const uint8_t*)a->frames;
  k.inten = (const float*)a->inten;
  k.tspan = (const float*)a->tspan;
  k.fvw = (const int*)a->fvw;
  k.fval = (const float*)a->fval;
  k.n = a->n;
  k.T = a->T;
  k.nblk = (int)((a->n + kBlock - 1) / kBlock);
  k.P.time = a->time;
  k.P.ref_f = (float)a->ref_time;
  k.P.dtm_f = (float)a->delta_t_max;
  k.P.ref_u = (unsigned)a->ref_time;
  k.P.c_thresh_max = a->c_thresh_max;
  k.P.vel_m1 = a->vel_m1;
  k.P.c_inc = a->c_inc;
  k.block_counts = (int*)a->block_counts;
  k.offsets = (const long long*)a->offsets;
  k.out_pixd = (unsigned*)a->out_pixd;
  k.out_t = (unsigned*)a->out_t;
  k.flags = (int*)a->flags;
  return k;
}

// One launch of PASS for one template instantiation.
template <int D, bool FP, bool CO, bool AB, int SRC>
void launch_pass(const KArgs& k, int pass, cudaStream_t st) {
  if (pass == PASS_COUNT) {
    adder_resident_chunk_kernel<D, FP, CO, AB, PASS_COUNT, SRC>
        <<<k.nblk, kBlock, 0, st>>>(k);
  } else if (pass == PASS_WRITE) {
    adder_resident_chunk_kernel<D, FP, CO, AB, PASS_WRITE, SRC>
        <<<k.nblk, kBlock, 0, st>>>(k);
  } else {
    adder_resident_chunk_kernel<D, FP, CO, AB, PASS_VOID, SRC>
        <<<k.nblk, kBlock, 0, st>>>(k);
  }
}

}  // namespace

// --- the row-walk lane kernel (dvs_resident.cu: adder_dvs_rows): a lane
// group given as its carrier rows, not as dense (T, n) planes. One thread
// per pixel that has rows; it walks that pixel's rows in lane order. ------

extern "C" {

// Mirrored by adder_tpu_torch/ops/fused_resident.py::_RowsArgs. Every index
// array is i64 on the device, as torch's sort, cumsum and searchsorted
// leave it.
struct AdderRowsArgs {
  int pass;        // PASS_COUNT, PASS_WRITE, PASS_VOID
  int multi_mode;  // PixelMultiMode: 0 Normal, 1 Collapse
  int depth;       // 16
  int src;         // SRC_DVS
  long long n;     // pixels of the plane
  long long rows;  // E >= 1 carrier rows
  int ref_time;
  int delta_t_max;
  int c_thresh_max;
  int vel_m1;
  void* state[14];        // read and, on WRITE and VOID, written in place
  const void* carrier;    // (5, E) i32, pack_dvs_plan's layout
  const void* order;      // (E,) rows sorted by (pixel, lane)
  const void* row_start;  // (E + 2,) run starts in `order`, one per
                          // pixel that has rows, then E
  const void* n_active;   // (1,) number of pixels that have rows
  const void* cell_gap;   // (E,) each row's gap cell in (sub-step, pixel)
  const void* cell_tick;  //      order, and its tick cell
  void* cell_counts;      // (2 E,) i32 events per cell: COUNT, VOID
  const void* offsets;    // (2 E + 1,) i64 exclusive offsets: WRITE
  void* out_pixd;
  void* out_t;
  void* flags;            // [max per-cell count, depth overflow]
};

}  // extern "C"

namespace {

constexpr int kRowsBlock = 64;  // threads per block of the row walk

struct RArgs {
  StateIn in;
  StateOut out;
  const int* carrier;
  const long long* order;
  const long long* row_start;
  const long long* n_active;
  const long long* cell_gap;
  const long long* cell_tick;
  long long n, rows;
  Params P;
  int* cell_counts;
  const long long* offsets;
  unsigned* out_pixd;
  unsigned* out_t;
  int* flags;
};

inline RArgs make_rargs(const AdderRowsArgs* a) {
  // the state pointers through the chunk kernels' own mapping
  AdderChunkArgs c = {};
  for (int i = 0; i < 14; ++i) {
    c.state_in[i] = a->state[i];
    c.state_out[i] = a->state[i];
  }
  c.n = a->n;
  c.ref_time = a->ref_time;
  c.delta_t_max = a->delta_t_max;
  c.c_thresh_max = a->c_thresh_max;
  c.vel_m1 = a->vel_m1;
  const KArgs k = make_kargs(&c);
  RArgs r;
  r.in = k.in;
  r.out = k.out;
  r.P = k.P;
  r.carrier = (const int*)a->carrier;
  r.order = (const long long*)a->order;
  r.row_start = (const long long*)a->row_start;
  r.n_active = (const long long*)a->n_active;
  r.cell_gap = (const long long*)a->cell_gap;
  r.cell_tick = (const long long*)a->cell_tick;
  r.n = a->n;
  r.rows = a->rows;
  r.cell_counts = (int*)a->cell_counts;
  r.offsets = (const long long*)a->offsets;
  r.out_pixd = (unsigned*)a->out_pixd;
  r.out_t = (unsigned*)a->out_t;
  r.flags = (int*)a->flags;
  return r;
}

// One thread per pixel that has rows: gather its state, walk its rows in
// lane order (per row the gap sub-step, then the tick sub-step; a half that
// is off counts 0 events), scatter its state back. No loop over T and no
// barrier: a thread's events of one cell go to that cell's own offset.
// SRC picks what a row holds; SRC_DVS is the (5, E) carrier of
// pack_dvs_plan, two sub-steps of run_interval per row.
template <int D, bool COLLAPSE, int PASS, int SRC>
__global__ void __launch_bounds__(kRowsBlock)
    adder_lane_rows_kernel(const RArgs a) {
  static_assert(SRC == SRC_DVS, "the row walk is built for the DVS carrier");
  constexpr int K = D + 3;
  const int lane = threadIdx.x & 31;
  const long long j = (long long)blockIdx.x * kRowsBlock + threadIdx.x;
  int maxcnt = 0;
  bool ovf_any = false;
  if (j < *a.n_active) {
    const long long r0 = a.row_start[j], r1 = a.row_start[j + 1];
    const int* meta_row = a.carrier;
    const int* fv_row = a.carrier + a.rows;
    const int* gap_int = a.carrier + 2 * a.rows;
    const int* gap_time = a.carrier + 3 * a.rows;
    const int* tick_int = a.carrier + 4 * a.rows;
    const long long pix = meta_row[a.order[r0]] & 0xFFFFF;
    const unsigned pbase = (unsigned)pix << 8;
    Pixel<D> s;
    load_state(s, a.in, pix, a.n);
    for (long long i = r0; i < r1; ++i) {
      const long long row = a.order[i];
      const int meta = meta_row[row], fvs = fv_row[row];
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {  // the gap sub-step, then the tick
        const bool on = (meta >> (27 + h)) & 1;
        const long long cell = h ? a.cell_tick[row] : a.cell_gap[row];
        int cnt = 0;
        if (on) {
          const float inten =
              __int_as_float(h ? tick_int[row] : gap_int[row]);
          // a tick spans one source tick, f32(ref_time)
          const float tspan = h ? a.P.ref_f : __int_as_float(gap_time[row]);
          const int fv = (fvs >> (8 * h)) & 0xFF;
          // (u32(time) // ref_time) % 256 per sub-step (integrate.py:606-609)
          const int c_inc = (int)((as_u32(tspan) / a.P.ref_u) % 256u);
          int sd[K];
          unsigned st[K];
          bool ovf = false;
          const unsigned m = run_interval<D, false, COLLAPSE, true, true>(
              s, inten, fv, tspan, c_inc, a.P, sd, st, ovf);
          ovf_any = ovf_any || ovf;
          cnt = __popc(m);
          if (PASS == PASS_WRITE && cnt) {
            long long off = a.offsets[cell];
#pragma unroll
            for (int k = 0; k < K; ++k) {
              if ((m >> k) & 1u) {
                a.out_pixd[off] = pbase | ((unsigned)sd[k] & 0xFFu);
                a.out_t[off] = st[k];
                ++off;
              }
            }
          }
        }
        maxcnt = max(maxcnt, cnt);
        if (PASS != PASS_WRITE) a.cell_counts[cell] = cnt;
      }
    }
    if (PASS != PASS_COUNT) store_state(s, a.out, pix, a.n);
  }
  const int wmax = __reduce_max_sync(kFull, maxcnt);
  const unsigned wovf = __reduce_or_sync(kFull, ovf_any ? 1u : 0u);
  if (lane == 0) {
    if (wmax > 0) atomicMax(&a.flags[0], wmax);
    if (wovf) atomicOr(&a.flags[1], 1);
  }
}

template <int D, bool CO, int SRC>
void launch_rows_pass(const RArgs& r, int pass, cudaStream_t st) {
  const int grid = (int)((r.rows + kRowsBlock - 1) / kRowsBlock);
  if (pass == PASS_COUNT) {
    adder_lane_rows_kernel<D, CO, PASS_COUNT, SRC>
        <<<grid, kRowsBlock, 0, st>>>(r);
  } else if (pass == PASS_WRITE) {
    adder_lane_rows_kernel<D, CO, PASS_WRITE, SRC>
        <<<grid, kRowsBlock, 0, st>>>(r);
  } else {
    adder_lane_rows_kernel<D, CO, PASS_VOID, SRC>
        <<<grid, kRowsBlock, 0, st>>>(r);
  }
}

}  // namespace

// --- the one-interval kernels (fused_interval.cu: K5; interval_slots.cu:
// K6): one frame, one thread per pixel-channel. ------------------------------

extern "C" {

// Mirrored by adder_tpu_torch/ops/pallas_kernel.py::IntervalArgs.
struct AdderIntervalArgs {
  int mode;        // Mode: 0 FramePerfect, 1 Continuous
  int multi_mode;  // PixelMultiMode: 0 Normal, 1 Collapse
  int abs_time;    // TimeMode == AbsoluteT
  int depth;       // K5: 6 or 8; K6: 8
  long long n;
  long long n_real;  // K5: events only from pixels below it
  float time;
  int ref_time;
  int delta_t_max;
  int c_thresh_max;
  int vel_m1;
  int c_inc;
  int view_mode;
  float pdm;
  int emit_running;  // K5: write the display intensity (K6 always does)
  int pack;          // K5: events kept per pixel, 1..16
  long long cap;     // K5: length of out_pixd / out_t
  const void* frame;  // (n,) u8
  const void* state_in[14];
  void* state_out[14];
  void* run_val;     // (n,) u8
  void* run_has;     // (n,) u8 (bool)
  void* slot_d;      // K6: (K, n) i32
  void* slot_t;      // K6: (K, n) u32
  void* slot_m;      // K6: (K, n) u8 (bool)
  void* overflow;    // K6: i32 arena-overflow count, added to
  const void* offset_in;  // K5: i64 running offset before the interval
  void* offset_out;       // K5: i64 running offset after it
  void* out_pixd;    // K5: (cap,) u32 pix << 8 | d
  void* out_t;       // K5: (cap,) u32 event t
  void* flags;       // K5: i32 [max per-pixel count, depth overflow]
  void* scratch;     // K5: (nblk + 1) i64 zeroed: look-back words, ticket
};

}  // extern "C"

namespace {

struct IArgs {
  StateIn in;
  StateOut out;
  const uint8_t* frame;
  long long n, n_real, cap;
  int nblk, pack;
  Params P;
  uint8_t* run_val;
  uint8_t* run_has;
  int* slot_d;
  unsigned* slot_t;
  uint8_t* slot_m;
  int* overflow;
  const long long* offset_in;
  long long* offset_out;
  unsigned* out_pixd;
  unsigned* out_t;
  int* flags;
  unsigned long long* tile;  // (nblk,) look-back words: value << 2 | status
  int* ticket;               // blocks in the order they start
};

inline bool interval_args_ok(const AdderIntervalArgs* a) {
  return a->n >= 1 && a->n < (1LL << 24) && a->n_real >= 0 &&
         a->n_real <= a->n && a->ref_time >= 1 && a->view_mode >= 0 &&
         a->view_mode <= 3;
}

inline IArgs make_iargs(const AdderIntervalArgs* a) {
  IArgs k;
  k.in.nd = (const int*)a->state_in[0];
  k.in.ni = (const float*)a->state_in[1];
  k.in.ndt = (const float*)a->state_in[2];
  k.in.bd = (const int*)a->state_in[3];
  k.in.bdt = (const float*)a->state_in[4];
  k.in.length = (const int*)a->state_in[5];
  k.in.base_val = (const int*)a->state_in[6];
  k.in.c_thresh = (const int*)a->state_in[7];
  k.in.cic = (const int*)a->state_in[8];
  k.in.lft = (const float*)a->state_in[9];
  k.in.running_t = (const float*)a->state_in[10];
  k.in.need_pop = (const uint8_t*)a->state_in[11];
  k.in.dtm_reached = (const uint8_t*)a->state_in[12];
  k.in.popped_dtm = (const uint8_t*)a->state_in[13];
  k.out.nd = (int*)a->state_out[0];
  k.out.ni = (float*)a->state_out[1];
  k.out.ndt = (float*)a->state_out[2];
  k.out.bd = (int*)a->state_out[3];
  k.out.bdt = (float*)a->state_out[4];
  k.out.length = (int*)a->state_out[5];
  k.out.base_val = (int*)a->state_out[6];
  k.out.c_thresh = (int*)a->state_out[7];
  k.out.cic = (int*)a->state_out[8];
  k.out.lft = (float*)a->state_out[9];
  k.out.running_t = (float*)a->state_out[10];
  k.out.need_pop = (uint8_t*)a->state_out[11];
  k.out.dtm_reached = (uint8_t*)a->state_out[12];
  k.out.popped_dtm = (uint8_t*)a->state_out[13];
  k.frame = (const uint8_t*)a->frame;
  k.n = a->n;
  k.n_real = a->n_real;
  k.cap = a->cap;
  k.nblk = (int)((a->n + kBlock - 1) / kBlock);
  k.pack = a->pack;
  k.P.time = a->time;
  k.P.ref_f = (float)a->ref_time;
  k.P.dtm_f = (float)a->delta_t_max;
  k.P.ref_u = (unsigned)a->ref_time;
  k.P.c_thresh_max = a->c_thresh_max;
  k.P.vel_m1 = a->vel_m1;
  k.P.c_inc = a->c_inc;
  k.P.view_mode = a->view_mode;
  k.P.pdm = a->pdm;
  k.run_val = (uint8_t*)a->run_val;
  k.run_has = (uint8_t*)a->run_has;
  k.slot_d = (int*)a->slot_d;
  k.slot_t = (unsigned*)a->slot_t;
  k.slot_m = (uint8_t*)a->slot_m;
  k.overflow = (int*)a->overflow;
  k.offset_in = (const long long*)a->offset_in;
  k.offset_out = (long long*)a->offset_out;
  k.out_pixd = (unsigned*)a->out_pixd;
  k.out_t = (unsigned*)a->out_t;
  k.flags = (int*)a->flags;
  k.tile = (unsigned long long*)a->scratch;
  k.ticket = (int*)((unsigned long long*)a->scratch + k.nblk);
  return k;
}

// Host dispatch over the three mode switches, the rest of the template
// arguments fixed by the caller: L::template go<FP, CO, AB>() launches.
template <class L>
void dispatch_modes(const AdderIntervalArgs* a, L& l) {
  const bool fp = a->mode == 0, co = a->multi_mode == 1, ab = a->abs_time;
  if (fp) {
    if (co) {
      ab ? l.template go<true, true, true>() : l.template go<true, true, false>();
    } else {
      ab ? l.template go<true, false, true>()
         : l.template go<true, false, false>();
    }
  } else {
    if (co) {
      ab ? l.template go<false, true, true>()
         : l.template go<false, true, false>();
    } else {
      ab ? l.template go<false, false, true>()
         : l.template go<false, false, false>();
    }
  }
}

}  // namespace
