// Copy of adder_tpu/ops/native/framer_fill.cpp, built for the port by adder_tpu_torch/ops/native_build.py.
// Native framer ingest: the full per-pixel reconstruction chain of
// framer/driver.py::ingest_event_array as one serial C++ walk.
//
// ref: adder-codec-rs/src/framer/driver.rs:984-1133 (ingest_event_for_chunk)
// and scale_intensity.rs:54-270 (FrameValue). The reference ingests one
// event at a time per rayon chunk; the Python driver reformulates the
// recurrences as segmented numpy scans. On 1-core hosts the numpy constant
// factors dominate (u64 cummax ~260 ns/elem here), so this native path
// counting-sorts the batch by pixel once and replays the reference's exact
// per-event recurrence per pixel segment — O(E + n_pix + fills), with the
// span fill writing straight into the frame buffers.
//
// Two passes share one sort:
//   adder_framer_plan : counting sort by pixel + dry chain walk; returns the
//                       max fired frame index so the caller can pre-create
//                       frame buffers (the Python dict-of-frames stays the
//                       source of truth).
//   adder_framer_exec : the real walk — mutates per-pixel state, computes
//                       frame values (all four view modes + EventCoordless),
//                       fills spans first-write-wins, counts fills per frame.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline long pix_of(uint16_t x, uint16_t y, uint8_t c, long width, long channels) {
  long cc = (c == 255) ? 0 : (long)c;  // NO_CHANNEL -> 0
  return ((long)y * width + (long)x) * channels + cc;
}

inline uint64_t round_up(uint64_t t, uint64_t ref) {
  return ((t + ref - 1) / ref) * ref;
}

struct ChainState {
  uint64_t rts;
  int64_t lf;
};

// One event's chain step. Returns keep; outputs v (pre-rounding running ts),
// dt (intensity delta-t), prev_chain, and updates rts in place.
inline bool chain_step(uint64_t te, uint64_t ref, bool absolute, bool framed_round,
                       uint64_t &rts, uint64_t &v, uint64_t &dt, uint64_t &prev_chain) {
  if (absolute) {
    uint64_t rt = framed_round ? round_up(te, ref) : te;
    prev_chain = rts;
    bool keep = te > rts;
    if (rt > rts) rts = rt;
    v = te;
    dt = (te >= prev_chain) ? te - prev_chain : 0;
    return keep;
  }
  uint64_t step = framed_round ? round_up(te, ref) : te;
  prev_chain = rts;
  v = rts + te;
  dt = te;
  rts += step;
  return true;
}

inline int64_t frame_index(uint64_t v, uint64_t tpf) {
  uint64_t vv = v > 1 ? v - 1 : 0;
  return (int64_t)(vv / tpf);
}

}  // namespace

extern "C" {

// Counting sort by pixel (stable) + dry chain walk.
// order[n] out; returns max fired frame index, or -1 when nothing fires
// (frame buffers below frames_written are never written).
long adder_framer_plan(const uint16_t *x, const uint16_t *y, const uint8_t *c,
                       const uint32_t *t, long n, long width, long channels,
                       long n_pix, const uint64_t *running_ts,
                       const int64_t *last_filled, uint64_t ref, uint64_t tpf,
                       int absolute, int framed_round, int64_t *order) {
  std::vector<uint32_t> cnt((size_t)n_pix + 1, 0);
  std::vector<int64_t> pix((size_t)n);
  for (long i = 0; i < n; ++i) {
    long p = pix_of(x[i], y[i], c[i], width, channels);
    if (p < 0 || p >= n_pix) return -2;
    pix[(size_t)i] = p;
    cnt[(size_t)p + 1]++;
  }
  for (long p = 0; p < n_pix; ++p) cnt[(size_t)p + 1] += cnt[(size_t)p];
  for (long i = 0; i < n; ++i) order[cnt[(size_t)pix[(size_t)i]]++] = i;

  long max_f = -1;
  long i = 0;
  while (i < n) {
    long e0 = (long)order[i];
    long p = pix[(size_t)e0];
    uint64_t rts = running_ts[p];
    int64_t lf = last_filled[p];
    long j = i;
    for (; j < n; ++j) {
      long e = (long)order[j];
      if (pix[(size_t)e] != p) break;
      uint64_t v, dt, prev;
      bool keep = chain_step(t[e], ref, absolute != 0, framed_round != 0, rts, v,
                             dt, prev);
      if (!keep) continue;
      int64_t fi = frame_index(v, tpf);
      if (fi > lf) {
        if (fi > max_f) max_f = fi;
        lf = fi;
      }
    }
    i = j;
  }
  return max_f;
}

// The real ingest walk. values_ptrs/filled_ptrs index frames
// [frames_written, frames_written + nf). Returns the number of fired
// events (>=0), or a negative error code.
//
// view_mode: 0=Intensity 1=D 2=DeltaT 3=SAE (scale_intensity.py);
// coordless packs (d, dt) into u64 and ignores view_mode.
long adder_framer_exec(const uint16_t *x, const uint16_t *y, const uint8_t *c,
                       const uint8_t *d, const uint32_t *t, long n,
                       const int64_t *order, long width, long channels,
                       long n_pix, uint64_t *running_ts, int64_t *last_filled,
                       uint8_t *last_intensity, long out_elem, uint64_t ref,
                       uint64_t tpf, int absolute, int framed_round,
                       long frames_written, int view_mode, int coordless,
                       double tpf_value, double src_max, double out_max,
                       double practical_d_max, double delta_t_max,
                       uint8_t **values_ptrs, uint8_t **filled_ptrs, long nf,
                       int64_t *fill_counts) {
  if (out_elem != 1 && out_elem != 2 && out_elem != 4 && out_elem != 8)
    return -3;
  long fires_total = 0;
  long i = 0;
  while (i < n) {
    long e0 = (long)order[i];
    long p = pix_of(x[e0], y[e0], c[e0], width, channels);
    if (p < 0 || p >= n_pix) return -2;
    uint64_t rts = running_ts[p];
    int64_t lf = last_filled[p];
    // carried intensity in stored-dtype bits
    uint64_t cur = 0;
    std::memcpy(&cur, last_intensity + (size_t)p * out_elem, (size_t)out_elem);
    long j = i;
    for (; j < n; ++j) {
      long e = (long)order[j];
      if (pix_of(x[e], y[e], c[e], width, channels) != p) break;
      uint64_t v, dt, prev;
      bool keep = chain_step(t[e], ref, absolute != 0, framed_round != 0, rts, v,
                             dt, prev);
      if (!keep) continue;
      int64_t fi = frame_index(v, tpf);
      if (fi <= lf) continue;
      // fired
      ++fires_total;
      int de = d[e];
      if (de != 255) {  // D_EMPTY repeats the carried intensity
        if (coordless) {
          cur = ((uint64_t)de << 32) | (dt & 0xFFFFFFFFull);
        } else {
          double val;
          switch (view_mode) {
            case 0: {  // Intensity: 2^d / dt, renormalized
              double num = (de >= 128) ? 0.0 : std::ldexp(1.0, de);
              double den = (dt == 0) ? 1.0 : (double)dt;
              double intensity = num / den;
              val = (src_max == out_max) ? intensity * tpf_value
                                         : intensity / src_max * tpf_value * out_max;
              break;
            }
            case 1:  // D view (f32 division like the numpy path)
              val = (double)((float)de / (float)practical_d_max) * out_max;
              break;
            case 2:  // DeltaT view
              val = (double)((float)dt / (float)delta_t_max) * out_max;
              break;
            case 3: {  // SAE: running t since last fire
              uint64_t last_fired = absolute ? prev : 0;
              uint64_t diff = v >= last_fired ? v - last_fired : 0;
              val = (double)((float)diff / (float)delta_t_max) * 255.0;
              break;
            }
            default:
              return -4;
          }
          // np.clip(val, 0, out_max).astype(uintN): saturate then truncate
          if (val < 0.0) val = 0.0;
          if (val > out_max) val = out_max;
          if (out_elem == 8 && val >= 18446744073709549568.0)
            cur = UINT64_MAX;
          else
            cur = (uint64_t)val;
        }
      }
      int64_t lo = lf + 1;
      if (lo < frames_written) lo = frames_written;
      int64_t hi = fi;
      for (int64_t f = lo; f <= hi; ++f) {
        long slot = (long)(f - frames_written);
        if (slot < 0 || slot >= nf) return -5;
        uint8_t *fl = filled_ptrs[slot];
        if (!fl[p]) {
          fl[p] = 1;
          std::memcpy(values_ptrs[slot] + (size_t)p * out_elem, &cur,
                      (size_t)out_elem);
          fill_counts[slot]++;
        }
      }
      lf = fi;
    }
    running_ts[p] = rts;
    last_filled[p] = lf;
    std::memcpy(last_intensity + (size_t)p * out_elem, &cur, (size_t)out_elem);
    i = j;
  }
  return fires_total;
}

}  // extern "C"
