// Copy of adder_tpu/ops/native/dvs_plan.cpp, built for the port by adder_tpu_torch/ops/native_build.py.
// Native DVS lane planners: the host side of the batched device path
// (SURVEY P5). These replay the reference's sequential per-pixel
// log-intensity chains (adder-codec-rs prophesee.rs:175-249 and
// davis.rs:235-465) exactly — same f64 libm math, same clamp rules, same
// drop rules — and emit the compact lane-major row plan the device
// scatter kernels consume (ops/dvs_batch.DvsCompact / DavisCompact).
//
// The numpy planners (ops/dvs_batch.plan_dvs_batch_compact_np /
// plan_davis_events_compact_np) are the pinned reference: they pay an
// O(E * k_max) lane loop of full-array selections, which on a slow host
// is the DVS end-to-end wall once the kernel itself runs at Mev/s. This
// walk is O(E): one chain pass in stream order (per-pixel order is all
// the chain needs) + one counting-sort scatter to lane-major order.
//
// Built on demand with g++ (ops/native_build.py), bound with ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {
// log1p(128/255): the mid-gray log intensity the reference resets to on
// out-of-range values (ref: transcoder/mod.rs mid clamp).
const double kMidLn = std::log1p(128.0 / 255.0);

// Bit-exact exp() memo: the chain's ln values live on a small lattice
// (+-theta steps from the mid-clamp reset plus first-touch starts), so a
// tiny open-addressed table keyed by the f64 BITS of x serves almost
// every call. A hit returns the cached std::exp(x) of the identical x —
// bit-exact by construction; a miss computes and replaces (no probing:
// collisions just evict, correctness is unaffected). exp() is the
// planner's dominant per-event libm cost.
struct ExpMemo {
  static constexpr int kBits = 12;
  uint64_t keys[1 << kBits];
  double vals[1 << kBits];
  ExpMemo() {
    // sentinel: the bit pattern of a signaling-NaN payload no lattice ln
    // takes; a (astronomically unlikely) query of this exact pattern
    // would recompute exp every time, never return a wrong value
    for (auto& k : keys) k = 0xFFF8DEADBEEFDEADull;
  }
  double operator()(double x) {
    uint64_t b;
    std::memcpy(&b, &x, 8);
    const uint32_t h =
        static_cast<uint32_t>((b * 0x9E3779B97F4A7C15ull) >> (64 - kBits));
    if (keys[h] == b) return vals[h];
    const double v = std::exp(x);
    keys[h] = b;
    vals[h] = v;
    return v;
  }
};

// Open-addressed (key -> small index) map for the pack8 carrier
// dictionary: 256 slots for <= 64 entries keeps probe chains short.
struct DictMap {
  uint64_t keys[256];
  int32_t idxs[256];
  uint64_t order[64];
  int32_t n = 0;
  DictMap() {
    for (auto& k : keys) k = 0xFFF8DEADBEEFDEADull;
  }
  // returns the entry index, or -1 when full and the key is new
  int32_t intern(uint64_t key) {
    uint32_t h = static_cast<uint32_t>((key * 0x9E3779B97F4A7C15ull) >> 56);
    for (;;) {
      if (keys[h] == key) return idxs[h];
      if (keys[h] == 0xFFF8DEADBEEFDEADull) {
        if (n >= 64) return -1;
        keys[h] = key;
        idxs[h] = n;
        order[n] = key;
        return n++;
      }
      h = (h + 1) & 255;
    }
  }
};
}  // namespace

extern "C" {

// Prophesee planner (ref: prophesee.rs:175-249; numpy twin:
// plan_dvs_batch_compact_np).
//
// Inputs: per-event time (i64 ticks), flat pixel index (i32), polarity
// (u8, 0 = OFF); chain state last_t (u32) / last_ln (f64), both length
// n_pixels and updated in place. Outputs are caller-allocated at
// capacity n_events (<= one row per event); rows land lane-major
// (stable within a lane = stream order). Returns the number of emitted
// rows, or -1 on a bad pixel index.
// val_cache (f64, n_pixels) memoizes exp(last_ln[i]) between events and
// between windows — the chain needs exp of the STORED ln at every event
// head, and that value was already computed when the ln was stored (or is
// the constant exp(kMidLn) after a clamp). NaN = not cached (lazy fill);
// the caller owns the array alongside last_ln and must reset it to NaN if
// it ever mutates last_ln by other means. Halves the libm exp() count —
// the planner's dominant cost. Bit-exact: the same exp of the same input,
// just not recomputed.
long adder_plan_dvs(const int64_t* t, const int32_t* pix, const uint8_t* pol,
                    long n_events, long n_pixels, uint32_t* last_t,
                    double* last_ln, double* val_cache, double theta,
                    double ref_time,
                    int32_t* out_pix, int32_t* out_lane, uint8_t* out_gap_on,
                    int32_t* out_gap_fv, float* out_gap_int,
                    float* out_gap_time, uint8_t* out_tick_on,
                    int32_t* out_tick_fv, float* out_tick_int,
                    float* out_tick_time, float* out_gap_val,
                    int64_t* out_gap_n) {
  const double kMidExp = std::exp(kMidLn);
  ExpMemo exp_memo;
  std::vector<int32_t> occ(n_pixels, 0);  // per-pixel occurrence counter
  // stream-order staging (scattered to lane-major afterwards)
  std::vector<int32_t> s_pix, s_lane, s_gfv, s_tfv;
  std::vector<uint8_t> s_gon, s_ton;
  std::vector<float> s_gint, s_gtime, s_tint, s_gval;
  std::vector<int64_t> s_gn;
  s_pix.reserve(n_events);
  s_lane.reserve(n_events);
  int32_t max_lane = -1;
  for (long e = 0; e < n_events; ++e) {
    const int32_t i = pix[e];
    if (i < 0 || i >= n_pixels) return -1;
    const int32_t lane = occ[i]++;
    const int64_t te = t[e];
    const int64_t lt = static_cast<int64_t>(last_t[i]);
    const bool keep = te >= lt;  // ref: prophesee.rs:180 (drop out-of-order)
    const bool gap_on = keep && (te > lt + 1);
    const bool tick_on = keep && (te > lt);

    const double ln = last_ln[i];
    double exp_ln = val_cache[i];
    if (std::isnan(exp_ln)) exp_ln = exp_memo(ln);
    double last_val = (exp_ln - 1.0) * 255.0;
    double ln_c = ln;
    if (last_val < 0.0 || last_val > 255.0) {  // mid clamp
      last_val = 128.0;
      ln_c = kMidLn;
    }
    const int64_t gap_n = te - lt - 1;
    // the mid-clamp of the held ln applies only on the gap branch
    // (ref: prophesee.rs:203-212 — the reassignment is branch-local)
    const double base_ln = gap_on ? ln_c : ln;
    const double new_ln =
        keep ? base_ln + (pol[e] == 0 ? -theta : theta) : ln;
    const double exp_new = exp_memo(new_ln);
    double new_val = (exp_new - 1.0) * 255.0;
    double new_ln_c = new_ln;
    double exp_after = exp_new;
    if (new_val < 0.0 || new_val > 255.0) {
      new_val = 128.0;
      new_ln_c = kMidLn;
      if (tick_on) exp_after = kMidExp;  // clamped ln persists on tick
    }
    // the tick branch re-clamps and stores the clamped ln
    // (ref: prophesee.rs:243-247); without a tick the raw step persists
    const double ln_after = tick_on ? new_ln_c : new_ln;
    if (keep) {
      last_ln[i] = ln_after;
      last_t[i] = static_cast<uint32_t>(te);
      val_cache[i] = exp_after;
    }
    if (!(gap_on || tick_on)) continue;
    if (lane > max_lane) max_lane = lane;
    s_pix.push_back(i);
    s_lane.push_back(lane);
    s_gon.push_back(gap_on ? 1 : 0);
    s_gfv.push_back(static_cast<int32_t>(static_cast<int64_t>(last_val)));
    // gap intensity is DEFINED as the f32 product of the f32-rounded held
    // value and the f32-rounded gap tick count (not f32(f64 product)):
    // the device-side compact carrier reconstructs it from a dictionary
    // index + gap_n with the exact same two roundings, so the wire needs
    // 8 bytes/event instead of 20 (fused_resident.pack_dvs_plan8). The
    // scalar oracle path and the numpy twin use the identical definition.
    const float last_val_f = static_cast<float>(last_val);
    s_gval.push_back(last_val_f);
    s_gn.push_back(gap_n);
    s_gint.push_back(last_val_f * static_cast<float>(gap_n));
    s_gtime.push_back(static_cast<float>(
        gap_n * static_cast<int64_t>(ref_time)));
    s_ton.push_back(tick_on ? 1 : 0);
    s_tfv.push_back(static_cast<int32_t>(static_cast<int64_t>(new_val)));
    s_tint.push_back(static_cast<float>(new_val));
  }
  // counting-sort scatter to lane-major (stable: stream order per lane)
  const long rows = static_cast<long>(s_pix.size());
  std::vector<int64_t> off(static_cast<size_t>(max_lane + 2), 0);
  for (long r = 0; r < rows; ++r) off[s_lane[r] + 1]++;
  for (int32_t k = 0; k <= max_lane; ++k) off[k + 1] += off[k];
  const float tick_time = static_cast<float>(ref_time);
  for (long r = 0; r < rows; ++r) {
    const int64_t o = off[s_lane[r]]++;
    out_pix[o] = s_pix[r];
    out_lane[o] = s_lane[r];
    out_gap_on[o] = s_gon[r];
    out_gap_fv[o] = s_gfv[r];
    out_gap_int[o] = s_gint[r];
    out_gap_time[o] = s_gtime[r];
    out_tick_on[o] = s_ton[r];
    out_tick_fv[o] = s_tfv[r];
    out_tick_int[o] = s_tint[r];
    out_tick_time[o] = tick_time;
    out_gap_val[o] = s_gval[r];
    out_gap_n[o] = s_gn[r];
  }
  return rows;
}

// Fused Prophesee planner + 8-byte carrier pack (host side of
// fused_resident.make_dvs_chunk_resident_packed8; numpy twins:
// plan_dvs_batch_compact_np + pack_dvs_plan8). Identical ln chain to
// adder_plan_dvs (same libm calls, same clamp/drop rules — bit-exact),
// but the counting-sort scatter writes the carrier's TWO u32 rows per
// event instead of the twelve plan arrays (~8 B vs ~50 B of scattered
// writes per row), and the (value, fv) dictionary is built inline, so
// the separate numpy pack pass (np.unique over 2E int64 keys) is gone.
//
// Row bit layout == pack_dvs_plan8 (the device unpack is shared):
//   row0: pix[0:pb] | (lane & 63)[pb:pb+6] | gap_on | tick_on | gn_hi
//   row1: gn_lo[0:20] | gap_idx[20:26] | tick_idx[26:32]
// lane & 63 == lane - group_base because groups are 64-aligned slices of
// the lane-major row order (out_lane_off gives the per-lane boundaries).
// Dictionary order is insertion order (numpy's np.unique sorts keys);
// the carrier bytes differ but the unpacked fields are identical — the
// parity tests compare unpacked fields, which is what the kernel sees.
//
// Returns rows >= 0, or -2 when the window does not fit the factored
// layout (gap_n out of field/product range, dictionary > 64 entries) or
// -3 when a lane exceeds lane_cap. On ANY negative return the chain
// state (last_t/last_ln/val_cache) HAS been partially advanced — the
// caller must snapshot and restore before falling back.
long adder_plan_dvs_pack8(
    const int64_t* t, const int32_t* pix, const uint8_t* pol,
    long n_events, long n_pixels, uint32_t* last_t, double* last_ln,
    double* val_cache, double theta, double ref_time, int32_t pb,
    int64_t gn_max, long lane_cap,
    uint32_t* out_row0, uint32_t* out_row1,
    uint32_t* out_dict0, uint32_t* out_dict1, int32_t* out_ndict,
    int64_t* out_lane_off, int64_t* out_gap_cnt, int64_t* out_tick_cnt,
    int32_t* out_nlanes) {
  const double kMidExp = std::exp(kMidLn);
  ExpMemo exp_memo;
  std::vector<int32_t> occ(n_pixels, 0);
  std::vector<uint32_t> s_r0, s_r1;
  std::vector<int32_t> s_lane;
  s_r0.reserve(n_events);
  s_r1.reserve(n_events);
  s_lane.reserve(n_events);
  // insertion-order dictionary of (f32 bits of value) << 32 | u32(fv),
  // <= 64 entries by construction (the values live on the +-theta ln
  // lattice), interned through a 256-slot open-addressed map
  DictMap dict;
  int32_t max_lane = -1;
  for (long e = 0; e < n_events; ++e) {
    const int32_t i = pix[e];
    if (i < 0 || i >= n_pixels) return -1;
    const int32_t lane = occ[i]++;
    const int64_t te = t[e];
    const int64_t lt = static_cast<int64_t>(last_t[i]);
    const bool keep = te >= lt;
    const bool gap_on = keep && (te > lt + 1);
    const bool tick_on = keep && (te > lt);

    const double ln = last_ln[i];
    double exp_ln = val_cache[i];
    if (std::isnan(exp_ln)) exp_ln = exp_memo(ln);
    double last_val = (exp_ln - 1.0) * 255.0;
    double ln_c = ln;
    if (last_val < 0.0 || last_val > 255.0) {
      last_val = 128.0;
      ln_c = kMidLn;
    }
    const int64_t gap_n = te - lt - 1;
    const double base_ln = gap_on ? ln_c : ln;
    const double new_ln =
        keep ? base_ln + (pol[e] == 0 ? -theta : theta) : ln;
    const double exp_new = exp_memo(new_ln);
    double new_val = (exp_new - 1.0) * 255.0;
    double new_ln_c = new_ln;
    double exp_after = exp_new;
    if (new_val < 0.0 || new_val > 255.0) {
      new_val = 128.0;
      new_ln_c = kMidLn;
      if (tick_on) exp_after = kMidExp;
    }
    const double ln_after = tick_on ? new_ln_c : new_ln;
    if (keep) {
      last_ln[i] = ln_after;
      last_t[i] = static_cast<uint32_t>(te);
      val_cache[i] = exp_after;
    }
    if (!(gap_on || tick_on)) continue;
    if (lane >= lane_cap) return -3;
    if (lane > max_lane) max_lane = lane;
    const int64_t gn = gap_on ? gap_n : 0;
    if (gn > gn_max) return -2;
    const float gval_f = static_cast<float>(last_val);
    const float tval_f = static_cast<float>(new_val);
    const int32_t gfv = static_cast<int32_t>(static_cast<int64_t>(last_val));
    const int32_t tfv = static_cast<int32_t>(static_cast<int64_t>(new_val));
    uint32_t gbits, tbits;
    std::memcpy(&gbits, &gval_f, 4);
    std::memcpy(&tbits, &tval_f, 4);
    const uint64_t gkey =
        (static_cast<uint64_t>(gbits) << 32) | static_cast<uint32_t>(gfv);
    const uint64_t tkey =
        (static_cast<uint64_t>(tbits) << 32) | static_cast<uint32_t>(tfv);
    const int32_t gidx = dict.intern(gkey);
    if (gidx < 0) return -2;
    const int32_t tidx = dict.intern(tkey);
    if (tidx < 0) return -2;
    s_r0.push_back(static_cast<uint32_t>(i) |
                   (static_cast<uint32_t>(lane & 63) << pb) |
                   (static_cast<uint32_t>(gap_on ? 1 : 0) << (pb + 6)) |
                   (static_cast<uint32_t>(tick_on ? 1 : 0) << (pb + 7)) |
                   (static_cast<uint32_t>(gn >> 20) << (pb + 8)));
    s_r1.push_back(static_cast<uint32_t>(gn & 0xFFFFF) |
                   (static_cast<uint32_t>(gidx) << 20) |
                   (static_cast<uint32_t>(tidx) << 26));
    s_lane.push_back(lane);
    out_gap_cnt[lane] += gap_on ? 1 : 0;
    out_tick_cnt[lane] += tick_on ? 1 : 0;
  }
  const long rows = static_cast<long>(s_r0.size());
  const int32_t n_lanes = max_lane + 1;
  std::vector<int64_t> off(static_cast<size_t>(n_lanes) + 1, 0);
  for (long r = 0; r < rows; ++r) off[s_lane[r] + 1]++;
  for (int32_t k = 0; k < n_lanes; ++k) off[k + 1] += off[k];
  for (int32_t k = 0; k <= n_lanes; ++k) out_lane_off[k] = off[k];
  for (long r = 0; r < rows; ++r) {
    const int64_t o = off[s_lane[r]]++;
    out_row0[o] = s_r0[r];
    out_row1[o] = s_r1[r];
  }
  for (int32_t k = 0; k < dict.n; ++k) {
    out_dict0[k] = static_cast<uint32_t>(dict.order[k] >> 32);
    out_dict1[k] = static_cast<uint32_t>(dict.order[k] & 0xFFFFFFFFu);
  }
  *out_ndict = dict.n;
  *out_nlanes = n_lanes;
  return rows;
}

// DAVIS planner (ref: davis.rs:235-465 integrate_dvs_events; numpy twin:
// plan_davis_events_compact_np). The ln step is MULTIPLICATIVE
// (last_ln *= exp(+-c)) and last_t updates on the skip path too
// (davis.rs:303). last_t is i64 microseconds here.
// val_cache memoizes exp(last_ln[i]) exactly as in adder_plan_dvs (NaN =
// not cached; caller owns it alongside last_ln).
long adder_plan_davis(const int64_t* t, const int32_t* pix,
                      const uint8_t* on, long n_events, long n_pixels,
                      int64_t* last_t, double* last_ln, double* val_cache,
                      double dvs_c,
                      double ref_time, double ticks_per_micro,
                      int32_t* out_pix, int32_t* out_lane,
                      float* out_first_int, float* out_dt_ticks,
                      float* out_fval, int32_t* out_fv8) {
  const double step_on = std::exp(dvs_c);
  const double step_off = std::exp(-dvs_c);
  const double ln_hi = std::log1p(1.0);  // clamp_u8 high-side ln
  const double exp_hi = std::exp(ln_hi);
  ExpMemo exp_memo;
  std::vector<int32_t> occ(n_pixels, 0);
  std::vector<int32_t> s_pix, s_lane, s_fv8;
  std::vector<float> s_fi, s_dt, s_fv;
  s_pix.reserve(n_events);
  int32_t max_lane = -1;
  for (long e = 0; e < n_events; ++e) {
    const int32_t i = pix[e];
    if (i < 0 || i >= n_pixels) return -1;
    const int32_t lane = occ[i]++;
    const int64_t te = t[e];
    const int64_t dt_us = te - last_t[i];
    const bool active = !((dt_us == te) || (dt_us < 0));  // davis.rs:300-305

    const double ln = last_ln[i];
    double exp_ln = val_cache[i];
    if (std::isnan(exp_ln)) exp_ln = exp_memo(ln);
    const double last_val = (exp_ln - 1.0) * 255.0;
    const double dt_ticks = static_cast<double>(dt_us) * ticks_per_micro;
    double first_int = last_val / ref_time * dt_ticks;
    if (!(first_int > 0.0)) first_int = 0.0;

    double ln2 = ln * (on[e] ? step_on : step_off);
    const double exp_ln2 = exp_memo(ln2);
    double fval = (exp_ln2 - 1.0) * 255.0;
    double exp_after = exp_ln2;
    if (fval <= 0.0) {
      fval = 0.0;
      ln2 = 0.0;
      exp_after = 1.0;  // exp(0)
    } else if (fval > 255.0) {
      fval = 255.0;
      ln2 = ln_hi;
      exp_after = exp_hi;
    }
    if (active) {
      last_ln[i] = ln2;
      val_cache[i] = exp_after;
    }
    last_t[i] = te;  // set on the skip path too (davis.rs:303)
    if (!active) continue;
    if (lane > max_lane) max_lane = lane;
    s_pix.push_back(i);
    s_lane.push_back(lane);
    s_fi.push_back(static_cast<float>(first_int));
    s_dt.push_back(static_cast<float>(dt_ticks));
    s_fv.push_back(static_cast<float>(fval));
    s_fv8.push_back(static_cast<int32_t>(static_cast<int64_t>(fval)));
  }
  const long rows = static_cast<long>(s_pix.size());
  std::vector<int64_t> off(static_cast<size_t>(max_lane + 2), 0);
  for (long r = 0; r < rows; ++r) off[s_lane[r] + 1]++;
  for (int32_t k = 0; k <= max_lane; ++k) off[k + 1] += off[k];
  for (long r = 0; r < rows; ++r) {
    const int64_t o = off[s_lane[r]]++;
    out_pix[o] = s_pix[r];
    out_lane[o] = s_lane[r];
    out_first_int[o] = s_fi[r];
    out_dt_ticks[o] = s_dt[r];
    out_fval[o] = s_fv[r];
    out_fv8[o] = s_fv8[r];
  }
  return rows;
}

}  // extern "C"
