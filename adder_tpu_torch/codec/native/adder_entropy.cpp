// Copy of adder_tpu/codec/native/adder_entropy.cpp, built for the port by adder_tpu_torch/ops/native_build.py.
// Native entropy stage for the compressed ADDER codec.
//
// Implements the source-modeled compression pipeline bit-compatibly with the
// reference (semantics studied from adder-codec-core/src/codec/compressed/*
// and the vendored arithmetic-coding crate):
//   - 64-bit integer range coder, precision 33 (BitStore u64, max_denominator
//     2^30; ref: arithmetic-coding-adder-dep/src/{encoder,decoder}.rs)
//   - Fenwick-tree adaptive frequency contexts with EOF at index 0
//     (ref: adder-codec-core/src/codec/compressed/fenwick/)
//   - four CABAC contexts: d (513 symbols), t (256), eof (1), bitshift (16)
//     with the reference's peaked priors (ref: cabac_contexts.rs:26-46,138-225)
//   - 16x16x3 EventCube intra/inter residual coding with bitshift escapes and
//     the lossy intensity-tolerant t-quantization
//     (ref: event_cube.rs:309-685, cabac_contexts.rs:83-135)
//   - EventAdu framing: start_t bytes, all cubes intra, all cubes inter, EOF
//     (ref: event_adu.rs:83-166)
//
// This is a host-side sequential stage by nature (adaptive model = serial
// symbol dependency); the TPU pipeline hands each ADU's events to this
// library off the device and streams length-prefixed blobs.
//
// Build: g++ -O3 -shared -fPIC -o libadder_entropy.so adder_entropy.cpp

#include <atomic>
#include <chrono>
#include <cstdint>
#include <memory>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

constexpr int BLOCK_SIZE = 16;
constexpr int16_t D_RESIDUAL_OFFSET = 255;
constexpr int16_t DRESIDUAL_NO_EVENT = 256;
constexpr int16_t DRESIDUAL_SKIP_CUBE = 257;
constexpr uint8_t BITSHIFT_ENCODE_FULL = 15;
constexpr uint8_t D_EMPTY = 255;
constexpr uint64_t MAX_DENOMINATOR = 1ull << 30;
constexpr uint32_t PRECISION = 33;  // 64 - (ilog2(2^30)+1)

// ---------------------------------------------------------------- bit IO ---

struct BitWriter {
    std::vector<uint8_t> bytes;
    uint8_t cur = 0;
    int nbits = 0;

    void write_bit(bool b) {
        cur = (uint8_t)((cur << 1) | (b ? 1 : 0));
        if (++nbits == 8) {
            bytes.push_back(cur);
            cur = 0;
            nbits = 0;
        }
    }
    void byte_align() {
        while (nbits != 0) write_bit(false);
    }
};

struct BitReader {
    const uint8_t* data;
    size_t len;
    size_t pos = 0;  // bit position

    // Returns -1 on EOF (the reference treats EOF as "no bit": x unchanged)
    int next_bit() {
        if (pos >= len * 8) return -1;
        int bit = (data[pos >> 3] >> (7 - (pos & 7))) & 1;
        pos++;
        return bit;
    }
};

// ------------------------------------------------------------ Fenwick ------

struct Weights {
    // counts[0] is the EOF pseudo-symbol (ref: fenwick/mod.rs:17-48)
    std::vector<uint64_t> tree;  // fenwick tree over n+1 entries
    uint64_t total = 0;
    size_t n;  // number of real symbols

    explicit Weights(size_t n_symbols) : tree(n_symbols + 2, 0), n(n_symbols) {}

    void add(size_t index, uint64_t delta) {  // index includes EOF offset
        total += delta;
        for (size_t i = index + 1; i < tree.size(); i += i & (~i + 1))
            tree[i] += delta;
    }
    uint64_t prefix_inclusive(size_t index) const {  // sum counts[0..=index]
        uint64_t s = 0;
        for (size_t i = index + 1; i > 0; i -= i & (~i + 1)) s += tree[i];
        return s;
    }
    // probability range for symbol (SIZE_MAX = EOF)
    void range(size_t sym, uint64_t* lo, uint64_t* hi) const {
        size_t index = (sym == SIZE_MAX) ? 0 : sym + 1;
        *hi = prefix_inclusive(index);
        *lo = index == 0 ? 0 : prefix_inclusive(index - 1);
    }
    // smallest i with prefix(Some(i)) > v; SIZE_MAX if v in EOF range
    // (ref: fenwick/mod.rs:81-103). Single Fenwick descent — O(log n)
    // instead of the binary search over prefix queries (O(log^2 n)):
    // walk power-of-two strides accumulating sums <= v; the landing
    // position is the count of leading entries whose cumulative is <= v,
    // i.e. the tree index of the entry containing v.
    size_t symbol(uint64_t v) const {
        size_t pos = 0;
        uint64_t rem = v;
        size_t mask = 1;
        while ((mask << 1) < tree.size()) mask <<= 1;
        for (; mask; mask >>= 1) {
            const size_t nxt = pos + mask;
            if (nxt < tree.size() && tree[nxt] <= rem) {
                rem -= tree[nxt];
                pos = nxt;
            }
        }
        // pos entries (EOF at index 0 included) lie fully below v
        if (pos == 0) return SIZE_MAX;        // v inside the EOF range
        return pos >= n + 1 ? n - 1 : pos - 1;
    }

    static Weights with_counts(const uint64_t* counts, size_t n_symbols) {
        Weights w(n_symbols);
        for (size_t i = 0; i < n_symbols; i++) w.add(i + 1, counts[i]);
        w.add(0, 1);  // EOF
        return w;
    }
};

struct Model {
    std::vector<Weights> contexts;
    size_t current = 0;

    size_t push(Weights&& w) {
        contexts.push_back(std::move(w));
        return contexts.size() - 1;
    }
    Weights& ctx() { return contexts[current]; }
    const Weights& ctx() const { return contexts[current]; }
    void update(size_t sym) {  // +1 adaptive, capped (ref: context_switching.rs:82-99)
        if (ctx().total < MAX_DENOMINATOR)
            ctx().add(sym == SIZE_MAX ? 0 : sym + 1, 1);
    }
};

// reference context priors (ref: cabac_contexts.rs:138-225)
Weights d_residual_default_weights() {
    uint64_t counts[513];
    for (int i = 0; i < 513; i++) counts[i] = 1;
    for (int i = 0; i < 513; i++) {
        if (i >= 245 && i <= 265)
            counts[i] = 20;
        else if ((i >= 235 && i <= 275) || (i >= 490 && i <= 510) || i <= 20)
            counts[i] = 10;
        if (i == 511) counts[i] = 20;
        if (i == 512) counts[i] = 10;
    }
    return Weights::with_counts(counts, 513);
}

Weights t_residual_default_weights() {
    uint64_t counts[256];
    for (int i = 0; i < 256; i++) counts[i] = 1;
    counts[0] = 100;
    for (int i = 0; i < 10; i++) counts[i] = 10;
    return Weights::with_counts(counts, 256);
}

struct Contexts {
    size_t d_context, t_context, eof_context, bitshift_context;
    int64_t t_residual_max;

    explicit Contexts(Model& m) {
        // context 0: FenwickModel::with_symbols(u16::MAX, ...) default ctx
        m.push(Weights(65535));
        d_context = m.push(d_residual_default_weights());
        Weights tw = t_residual_default_weights();
        t_residual_max = ((int64_t)tw.n - 2) / 2;  // = 127
        t_context = m.push(std::move(tw));
        uint64_t one = 1;
        eof_context = m.push(Weights::with_counts(&one, 1));
        uint64_t ones16[16];
        for (int i = 0; i < 16; i++) ones16[i] = 1;
        bitshift_context = m.push(Weights::with_counts(ones16, 16));
    }
};

// --------------------------------------------------------- range coder -----

struct RangeEncoder {
    uint64_t low = 0, high = 1ull << PRECISION;
    uint32_t pending = 0;
    BitWriter* out;

    static constexpr uint64_t HALF = 1ull << (PRECISION - 1);
    static constexpr uint64_t QUARTER = 1ull << (PRECISION - 2);

    void emit(bool bit) {
        out->write_bit(bit);
        for (uint32_t i = 0; i < pending; i++) out->write_bit(!bit);
        pending = 0;
    }
    void scale(uint64_t plo, uint64_t phi, uint64_t denom) {
        uint64_t range = high - low + 1;
        high = low + (range * phi) / denom - 1;
        low += (range * plo) / denom;
        while (high < HALF || low >= HALF) {
            if (high < HALF) {
                emit(false);
                high <<= 1;
                low <<= 1;
            } else {
                emit(true);
                low = (low - HALF) << 1;
                high = (high - HALF) << 1;
            }
        }
        while (low >= QUARTER && high < HALF + QUARTER) {
            pending++;
            low = (low - QUARTER) << 1;
            high = (high - QUARTER) << 1;
        }
    }
    void encode(Model& m, size_t sym) {
        uint64_t lo, hi;
        m.ctx().range(sym, &lo, &hi);
        scale(lo, hi, m.ctx().total);
        m.update(sym);
    }
    void flush() {
        pending += 1;
        if (low <= QUARTER)
            emit(false);
        else
            emit(true);
    }
};

struct RangeDecoder {
    static constexpr bool ADDRN_WIRE = false;  // reference wire layout
    uint64_t low = 0, high = 1ull << PRECISION, x = 0;
    bool uninit = true;
    BitReader* in;

    static constexpr uint64_t HALF = 1ull << (PRECISION - 1);
    static constexpr uint64_t QUARTER = 1ull << (PRECISION - 2);

    void take_bit() {
        int b = in->next_bit();
        if (b == 1) x += 1;
    }
    void initialise() {
        if (!uninit) return;
        uninit = false;
        for (uint32_t i = 0; i < PRECISION; i++) {
            x <<= 1;
            take_bit();
        }
    }
    size_t decode(Model& m) {
        initialise();
        uint64_t denom = m.ctx().total;
        uint64_t range = high - low + 1;
        uint64_t value = ((x - low + 1) * denom - 1) / range;
        size_t sym = m.ctx().symbol(value);
        uint64_t lo, hi;
        m.ctx().range(sym, &lo, &hi);
        high = low + (range * hi) / denom - 1;
        low += (range * lo) / denom;
        while (high < HALF || low >= HALF) {
            if (high < HALF) {
                high <<= 1;
                low <<= 1;
                x <<= 1;
            } else {
                low = (low - HALF) << 1;
                high = (high - HALF) << 1;
                x = (x - HALF) << 1;
            }
            take_bit();
        }
        while (low >= QUARTER && high < HALF + QUARTER) {
            low = (low - QUARTER) << 1;
            high = (high - QUARTER) << 1;
            x = (x - QUARTER) << 1;
            take_bit();
        }
        m.update(sym);
        return sym;
    }
};

// ----------------------------------------------------------- event cube ----

struct Ev {
    uint8_t d;
    uint32_t t;
};


static double event_to_intensity_d(uint8_t d, uint32_t delta_t, uint32_t dt_ref) {
    // ref: cabac_contexts.rs:72-81 (D_SHIFT table is 129 entries; >=129 -> 0)
    double intensity;
    if (d >= 129)
        intensity = 0.0;
    else if (d == 128)
        intensity = 0.0;  // D_SHIFT[128] == 0
    else
        intensity = std::ldexp(1.0, d);
    if (delta_t != 0 && d < 129 && d != 128) intensity /= (double)delta_t;
    return intensity * (double)dt_ref;
}

// ref: cabac_contexts.rs:49-70
static void residual_to_bitshift(int64_t t_res, int64_t t_res_max, uint8_t* amt,
                                 int64_t* out_res) {
    if (std::llabs(t_res) < t_res_max) {
        *amt = 0;
        *out_res = t_res;
    } else {
        *amt = BITSHIFT_ENCODE_FULL;
        *out_res = t_res;
    }
}

// ref: cabac_contexts.rs:83-135
static void residual_to_bitshift2(int64_t t_prediction, int64_t t_res_i64,
                                  const Ev& event, const Ev& prev,
                                  uint32_t dt_ref, double c_thresh_max,
                                  int64_t t_res_max, uint8_t* out_amt,
                                  int64_t* out_res) {
    if (std::llabs(t_res_i64) < t_res_max) {
        *out_amt = 0;
        *out_res = t_res_i64;
        return;
    }
    uint32_t actual_dt = event.t >= prev.t ? event.t - prev.t : 0;
    double actual_intensity = event_to_intensity_d(event.d, actual_dt, dt_ref);
    double recon_intensity = actual_intensity;
    uint8_t bitshift = 0;
    int64_t t_residual = std::llabs(t_res_i64);
    for (;;) {
        if (t_residual > t_res_max &&
            actual_intensity - c_thresh_max < recon_intensity &&
            actual_intensity + c_thresh_max > recon_intensity) {
            t_residual >>= 1;
            bitshift += 1;
            int64_t recon_predicted_t64 = t_prediction + t_residual;
            uint32_t recon_predicted_t = (uint32_t)recon_predicted_t64;
            if (recon_predicted_t < prev.t) break;
            uint32_t recon_predicted_dt = recon_predicted_t - prev.t;
            recon_intensity =
                event_to_intensity_d(event.d, recon_predicted_dt, dt_ref);
        } else {
            break;
        }
    }
    bitshift = bitshift > 0 ? (uint8_t)(bitshift - 1) : 0;
    t_residual = std::llabs(t_res_i64) >> bitshift;
    if (t_residual < t_res_max) {
        *out_amt = bitshift;
        *out_res = t_res_i64 < 0 ? -t_residual : t_residual;
    } else {
        *out_amt = BITSHIFT_ENCODE_FULL;
        *out_res = t_res_i64;
    }
}

// ref: event_cube.rs:81-113
static uint32_t generate_t_prediction(size_t idx, int16_t d_residual,
                                      uint32_t last_delta_t, const Ev& prev,
                                      size_t num_intervals, uint32_t dt_ref,
                                      uint32_t start_t) {
    if (idx == 1) return start_t + last_delta_t;
    if (std::abs((int)d_residual) > 14) d_residual = 0;
    if (prev.d == D_EMPTY) d_residual = -1;
    uint32_t delta_t_prediction = d_residual < 0
                                      ? last_delta_t >> (-d_residual)
                                      : last_delta_t << d_residual;
    uint32_t cap = (uint32_t)((uint8_t)num_intervals) * dt_ref;
    uint32_t p = prev.t + std::min(delta_t_prediction, cap);
    return std::max(prev.t, p);
}

template <class Dec>
static void decode_bytes(Dec& dec, Model& m, size_t ctx,
                         uint8_t* bytes, size_t n) {
    m.current = ctx;
    for (size_t i = 0; i < n; i++) bytes[i] = (uint8_t)dec.decode(m);
}

// Decode one t residual after its bitshift amount. Two wire layouts (see
// FlatSink/RangeSink): reference-compatible addec (2-byte BE small, 8-byte
// BE FULL) and addrn v3 (1-byte small; FULL = coded top byte + 4 raw LE
// low bytes from the side channel).
template <class Dec>
static int64_t read_t_residual(Dec& dec, Model& m, const Contexts& ctxs,
                               uint8_t amt) {
    if (amt == BITSHIFT_ENCODE_FULL) {
        if constexpr (Dec::ADDRN_WIRE) {
            uint8_t b[4];
            decode_bytes(dec, m, ctxs.t_context, b, 4);
            uint64_t v = 0;
            for (int i = 0; i < 4; i++) v = (v << 8) | b[i];
            v = (v << 8) | dec.raw1();
            if (v >> 39) v |= ~0ull << 40;  // sign-extend i40
            return (int64_t)v;
        } else {
            uint8_t b[8];
            decode_bytes(dec, m, ctxs.t_context, b, 8);
            uint64_t v = 0;
            for (int i = 0; i < 8; i++) v = (v << 8) | b[i];
            return (int64_t)v;
        }
    }
    if constexpr (Dec::ADDRN_WIRE) {
        uint8_t b;
        decode_bytes(dec, m, ctxs.t_context, &b, 1);
        return ((int64_t)(int8_t)b) << amt;
    } else {
        uint8_t b[2];
        decode_bytes(dec, m, ctxs.t_context, b, 2);
        const int16_t tr = (int16_t)(((uint16_t)b[0] << 8) | b[1]);
        return ((int64_t)tr) << amt;
    }
}

// ------------------------------------------------------- CSR encode side ---
// Encode-side ADU layout: one counting sort by (cube, channel, raster
// position) replaces the per-pixel vector-of-vectors (184K heap vectors per
// 320x180 ADU). Events land in one contiguous (d, t) pair of arrays with a
// CSR offsets table in exactly the transform's walk order, so the residual
// transforms below are two linear passes. This is the explicit two-stage
// split of SURVEY §7 step 7: stage 1 (transform) turns events into three
// flat symbol streams, stage 2 (entropy tail) codes the streams.
struct CsrAdu {
    size_t n_cubes, channels, n_pix;     // n_pix = n_cubes*channels*256
    std::vector<uint32_t> off;           // n_pix + 1
    std::vector<uint8_t> d;              // accepted events, pixel-major
    std::vector<uint32_t> t;
    std::vector<uint8_t> cube_nonempty;  // per cube
};

// ref ingest semantics: event_adu.rs:179-193, event_cube.rs:121-155 — an
// event is dropped iff the pixel already holds >1 events and t does not
// advance past the last accepted one.
static void build_csr(CsrAdu& a, const uint16_t* xs, const uint16_t* ys,
                      const uint8_t* cs, const uint8_t* ds, const uint32_t* ts,
                      size_t n_events, uint16_t width, uint16_t height,
                      uint8_t channels) {
    const size_t blocks_y = (height + BLOCK_SIZE - 1) / BLOCK_SIZE;
    const size_t blocks_x = (width + BLOCK_SIZE - 1) / BLOCK_SIZE;
    a.n_cubes = blocks_y * blocks_x;
    a.channels = channels;
    a.n_pix = a.n_cubes * channels * (BLOCK_SIZE * BLOCK_SIZE);
    a.cube_nonempty.assign(a.n_cubes, 0);

    std::vector<uint32_t> cnt(a.n_pix, 0);
    // last_t / key need no init: last_t is only read once cnt[k] > 1 (so
    // written at least twice), key is written for every event
    std::unique_ptr<uint32_t[]> last_t(new uint32_t[a.n_pix]);
    std::unique_ptr<uint32_t[]> key(new uint32_t[n_events]);
    size_t accepted = 0;
    for (size_t i = 0; i < n_events; i++) {
        const size_t cube = (ys[i] / BLOCK_SIZE) * blocks_x + xs[i] / BLOCK_SIZE;
        const size_t cc = cs[i] == 255 ? 0 : cs[i];
        const size_t k = (cube * channels + cc) * (BLOCK_SIZE * BLOCK_SIZE) +
                         (ys[i] % BLOCK_SIZE) * BLOCK_SIZE + xs[i] % BLOCK_SIZE;
        if (cnt[k] > 1 && ts[i] <= last_t[k]) {
            key[i] = UINT32_MAX;
            continue;
        }
        key[i] = (uint32_t)k;
        cnt[k]++;
        last_t[k] = ts[i];
        a.cube_nonempty[cube] = 1;
        accepted++;
    }
    a.off.resize(a.n_pix + 1);
    uint32_t acc = 0;
    for (size_t p = 0; p < a.n_pix; p++) {
        a.off[p] = acc;
        acc += cnt[p];
        cnt[p] = a.off[p];  // reuse as running fill cursor
    }
    a.off[a.n_pix] = acc;
    a.d.resize(accepted);
    a.t.resize(accepted);
    for (size_t i = 0; i < n_events; i++) {
        if (key[i] == UINT32_MAX) continue;
        uint32_t& w = cnt[key[i]];
        a.d[w] = ds[i];
        a.t[w] = ts[i];
        w++;
    }
}

// Transform sinks: FlatSink materializes the three context streams (for the
// static-table rANS tail); RangeSink feeds the adaptive range coder directly
// (reference-compatible `addec`, where the model adapts per symbol so the
// streams cannot be materialized ahead of the coder).
struct FlatSink {
    // addrn carries the FULL t escape as 5 bytes: the residual is
    // (i64)t - (i64)prediction with both in u32, an i33 value — 8 bytes
    // (the addec wire layout, event_cube.rs:361-366) wastes 3. The escape
    // fires on ~half of real events (t_residual_max is only 127), so this
    // is ~30% of the whole t stream.
    // addrn t-residual wire (version 3):
    //  - small (amt != FULL): 1 byte — non-FULL residuals satisfy
    //    |res| < t_residual_max = 127, so the addec 2-byte layout
    //    (event_cube.rs:361-366) carries a constant sign byte
    //  - FULL escape: the residual is (i64)t - (i64)prediction with both in
    //    u32, an i33 value, carried as 5 bytes. The top 4 (sign + high
    //    magnitude) are peaky — Laplacian-ish residuals leave them mostly
    //    0x00/0xFF — and go through the entropy-coded t stream; the lowest
    //    byte is near-uniform (measured ~8 bits on the nyc fixture) and
    //    goes to a raw side-channel, skipping entropy work for 0 ratio
    //    cost. The escape fires on ~half of real events (t_residual_max is
    //    only 127).
    // raw buffers (no zero-init — every slot up to the n* cursor is written)
    std::unique_ptr<uint16_t[]> d;  // intra wide symbols AND inter bytes
    std::unique_ptr<uint8_t[]> t, bs, raw;
    size_t nd = 0, nt = 0, nbs = 0, nraw = 0;
    void reserve(size_t n_events, size_t n_pix, size_t n_cubes) {
        d.reset(new uint16_t[3 * n_pix + 2 * n_events + n_cubes + 16]);
        t.reset(new uint8_t[4 * (n_events + n_pix) + 16]);
        bs.reset(new uint8_t[n_events + n_pix + 16]);
        raw.reset(new uint8_t[n_events + n_pix + 16]);
    }
    inline void put_d(uint16_t s) { d[nd++] = s; }
    inline void put_bs(uint8_t b) { bs[nbs++] = b; }
    inline void put_t_small(int16_t tr) { t[nt++] = (uint8_t)(int8_t)tr; }
    inline void put_t_full(int64_t res) {
        const uint64_t v = (uint64_t)res;
        t[nt++] = (uint8_t)(v >> 32);  // sign/top byte
        t[nt++] = (uint8_t)(v >> 24);
        t[nt++] = (uint8_t)(v >> 16);
        t[nt++] = (uint8_t)(v >> 8);
        raw[nraw++] = (uint8_t)v;  // uniform low byte: raw side channel
    }
};

struct RangeSink {
    RangeEncoder* enc;
    Model* m;
    const Contexts* c;
    inline void put_d(uint16_t s) {
        m->current = c->d_context;
        enc->encode(*m, (size_t)s);
    }
    inline void put_t(uint8_t b) {
        m->current = c->t_context;
        enc->encode(*m, (size_t)b);
    }
    inline void put_bs(uint8_t b) {
        m->current = c->bitshift_context;
        enc->encode(*m, (size_t)b);
    }
    // reference wire layout: 2-byte BE small residual, 8-byte BE FULL
    // (event_cube.rs:361-366)
    inline void put_t_small(int16_t tr) {
        put_t((uint8_t)(((uint16_t)tr) >> 8));
        put_t((uint8_t)(((uint16_t)tr) & 0xFF));
    }
    inline void put_t_full(int64_t res) {
        for (int i = 0; i < 8; i++)
            put_t((uint8_t)(((uint64_t)res) >> (56 - 8 * i)));
    }
};

// ref: event_cube.rs:309-417 — first event of every pixel, d/t residuals
// chained across the cube raster; t rewritten to its reconstruction.
template <class Sink>
static void csr_intra(CsrAdu& a, Sink& sink, uint32_t start_t,
                      const Contexts& ctxs) {
    const size_t px_per_cube = a.channels * (BLOCK_SIZE * BLOCK_SIZE);
    for (size_t cube = 0; cube < a.n_cubes; cube++) {
        if (!a.cube_nonempty[cube]) {
            sink.put_d((uint16_t)(DRESIDUAL_SKIP_CUBE + D_RESIDUAL_OFFSET));
            continue;
        }
        bool have_init = false;
        Ev init{0, 0};
        const size_t p0 = cube * px_per_cube;
        for (size_t p = p0; p < p0 + px_per_cube; p++) {
            const uint32_t lo = a.off[p];
            if (lo == a.off[p + 1]) {
                sink.put_d((uint16_t)(DRESIDUAL_NO_EVENT + D_RESIDUAL_OFFSET));
                continue;
            }
            const uint8_t ed = a.d[lo];
            uint32_t et = a.t[lo];
            if (have_init) {
                sink.put_d((uint16_t)((int16_t)ed - (int16_t)init.d +
                                      D_RESIDUAL_OFFSET));
            } else {
                sink.put_d((uint16_t)((int16_t)ed + D_RESIDUAL_OFFSET));
                init = Ev{ed, start_t};
                have_init = true;
            }
            const int64_t t_residual_i64 = (int64_t)et - (int64_t)init.t;
            uint8_t amt;
            int64_t t_residual;
            residual_to_bitshift(t_residual_i64, ctxs.t_residual_max, &amt,
                                 &t_residual);
            sink.put_bs(amt);
            if (amt == BITSHIFT_ENCODE_FULL) {
                sink.put_t_full(t_residual);
                et = (uint32_t)((int64_t)init.t + t_residual);
            } else {
                const int16_t tr = (int16_t)t_residual;
                sink.put_t_small(tr);
                et = (uint32_t)((int64_t)init.t + ((int64_t)tr << amt));
            }
            a.t[lo] = et;  // reconstruction feedback for the inter pass
            init = Ev{ed, et};
        }
    }
}

// ref: event_cube.rs:419-517 — events 2.. of every pixel against the lossy
// t prediction; inter d residuals travel as 2 bytes in the d context.
template <class Sink>
static void csr_inter(CsrAdu& a, Sink& sink, uint32_t start_t, uint32_t dt_ref,
                      size_t num_intervals, double c_thresh_max,
                      const Contexts& ctxs) {
    const size_t px_per_cube = a.channels * (BLOCK_SIZE * BLOCK_SIZE);
    for (size_t cube = 0; cube < a.n_cubes; cube++) {
        if (!a.cube_nonempty[cube]) continue;
        const size_t p0 = cube * px_per_cube;
        for (size_t p = p0; p < p0 + px_per_cube; p++) {
            const uint32_t lo = a.off[p], hi = a.off[p + 1];
            if (lo == hi) continue;
            uint32_t last_delta_t = 0;
            for (size_t idx = 1;; idx++) {
                if (lo + idx >= hi) {
                    sink.put_d((uint16_t)(((uint16_t)DRESIDUAL_NO_EVENT) >> 8));
                    sink.put_d((uint16_t)(((uint16_t)DRESIDUAL_NO_EVENT) & 0xFF));
                    break;
                }
                const Ev prev{a.d[lo + idx - 1], a.t[lo + idx - 1]};
                const Ev cur{a.d[lo + idx], a.t[lo + idx]};
                const int16_t d_residual = (int16_t)cur.d - (int16_t)prev.d;
                sink.put_d((uint16_t)(((uint16_t)d_residual) >> 8));
                sink.put_d((uint16_t)(((uint16_t)d_residual) & 0xFF));

                const uint32_t t_prediction =
                    generate_t_prediction(idx, d_residual, last_delta_t, prev,
                                          num_intervals, dt_ref, start_t);
                const int64_t t_residual_i64 =
                    (int64_t)cur.t - (int64_t)t_prediction;
                uint8_t amt;
                int64_t t_residual;
                residual_to_bitshift2(t_prediction, t_residual_i64, cur, prev,
                                      dt_ref, c_thresh_max,
                                      ctxs.t_residual_max, &amt, &t_residual);
                sink.put_bs(amt);
                uint32_t et;
                if (amt == BITSHIFT_ENCODE_FULL) {
                    sink.put_t_full(t_residual);
                    et = (uint32_t)((int64_t)t_prediction + t_residual);
                } else {
                    const int16_t tr = (int16_t)t_residual;
                    sink.put_t_small(tr);
                    et = (uint32_t)((int64_t)t_prediction +
                                    ((int64_t)tr << amt));
                }
                if (et < prev.t) et = prev.t;
                a.t[lo + idx] = et;  // reconstruction feedback
                last_delta_t = et - prev.t;
            }
        }
    }
}

// stage-time accounting (ns), read by the bench via adder_entropy_stats for
// the transform-vs-entropy breakdown; atomic so the ADU worker pool can add.
static std::atomic<uint64_t> g_ns_ingest{0}, g_ns_transform{0},
    g_ns_entropy{0}, g_n_calls{0}, g_n_events{0}, g_n_syms{0};

struct StageClock {
    std::chrono::steady_clock::time_point t0 =
        std::chrono::steady_clock::now();
    uint64_t lap() {
        auto t1 = std::chrono::steady_clock::now();
        uint64_t ns = (uint64_t)std::chrono::duration_cast<
                          std::chrono::nanoseconds>(t1 - t0)
                          .count();
        t0 = t1;
        return ns;
    }
};

// ------------------------------------------------------ CSR decode side ---
// Decode-side mirror of the CSR encode: three linear passes (intra fills
// per-pixel first events, inter appends chain events to one flat buffer
// with per-pixel segment ends, drain walks pixels once writing the output
// in the reference order) — no per-pixel heap vectors. Shared by both
// entropy stages via the Dec template (RangeDecoder / SymReplayer).
struct CsrDec {
    size_t n_cubes, channels, n_pix;
    std::vector<uint8_t> cube_skip;   // 1 = no events in cube
    std::vector<uint8_t> has_first;   // per pixel
    std::vector<uint8_t> first_d;
    std::vector<uint32_t> first_t;
    std::vector<uint32_t> seg_end;    // inter-event flat end per pixel
    std::vector<uint8_t> ev_d;        // inter events, decode order
    std::vector<uint32_t> ev_t;

    void init(size_t cubes, size_t ch) {
        n_cubes = cubes;
        channels = ch;
        n_pix = cubes * ch * (BLOCK_SIZE * BLOCK_SIZE);
        cube_skip.assign(n_cubes, 1);
        has_first.assign(n_pix, 0);
        first_d.resize(n_pix);
        first_t.resize(n_pix);
        seg_end.assign(n_pix, 0);
        ev_d.clear();
        ev_t.clear();
    }
};

// ref: event_cube.rs:519-598
template <class Dec>
static void csr_decompress_intra(CsrDec& a, Dec& dec, Model& m,
                                 const Contexts& ctxs, uint32_t start_t) {
    const size_t ppc = a.channels * (BLOCK_SIZE * BLOCK_SIZE);
    for (size_t cube = 0; cube < a.n_cubes; cube++) {
        bool have_init = false;
        Ev init{0, 0};
        bool skip_rest = false;
        for (size_t p = cube * ppc; p < (cube + 1) * ppc; p++) {
            if (skip_rest) break;
            m.current = ctxs.d_context;
            const size_t sym = dec.decode(m);
            const int16_t d_residual = (int16_t)sym - D_RESIDUAL_OFFSET;
            if (d_residual == DRESIDUAL_SKIP_CUBE) {
                a.cube_skip[cube] = 1;
                skip_rest = true;  // whole cube absent; 1 symbol consumed
                break;
            }
            if (d_residual == DRESIDUAL_NO_EVENT) continue;
            uint8_t d;
            if (have_init) {
                d = (uint8_t)((int16_t)init.d + d_residual);
            } else {
                init = Ev{0, start_t};
                have_init = true;
                a.cube_skip[cube] = 0;
                d = (uint8_t)d_residual;
            }
            uint8_t amt;
            decode_bytes(dec, m, ctxs.bitshift_context, &amt, 1);
            const int64_t t_residual = read_t_residual(dec, m, ctxs, amt);
            init.d = (uint8_t)((int16_t)init.d + d_residual);
            init.t = (uint32_t)((int64_t)init.t + t_residual);
            a.first_d[p] = d;
            a.first_t[p] = init.t;
            a.has_first[p] = 1;
        }
    }
}

// ref: event_cube.rs:600-685. Returns false on a corrupt stream (per-pixel
// event cap exceeded — a corrupted symbol stream may never decode
// DRESIDUAL_NO_EVENT).
template <class Dec>
static bool csr_decompress_inter(CsrDec& a, Dec& dec, Model& m,
                                 const Contexts& ctxs, uint32_t start_t,
                                 uint32_t dt_ref, size_t num_intervals) {
    const size_t ppc = a.channels * (BLOCK_SIZE * BLOCK_SIZE);
    const size_t max_per_px = 32 * num_intervals + 1024;
    for (size_t cube = 0; cube < a.n_cubes; cube++) {
        if (a.cube_skip[cube]) {
            for (size_t p = cube * ppc; p < (cube + 1) * ppc; p++)
                a.seg_end[p] = (uint32_t)a.ev_d.size();
            continue;
        }
        for (size_t p = cube * ppc; p < (cube + 1) * ppc; p++) {
            if (a.has_first[p]) {
                Ev prev{a.first_d[p], a.first_t[p]};
                uint32_t last_delta_t = 0;
                for (size_t idx = 1;; idx++) {
                    if (idx > max_per_px) return false;
                    uint8_t db[2];
                    decode_bytes(dec, m, ctxs.d_context, db, 2);
                    const int16_t d_residual =
                        (int16_t)(((uint16_t)db[0] << 8) | db[1]);
                    if (d_residual == DRESIDUAL_NO_EVENT) break;
                    const uint8_t d =
                        (uint8_t)((int16_t)prev.d + d_residual);
                    const uint32_t t_prediction = generate_t_prediction(
                        idx, d_residual, last_delta_t, prev, num_intervals,
                        dt_ref, start_t);
                    uint8_t amt;
                    decode_bytes(dec, m, ctxs.bitshift_context, &amt, 1);
                    const int64_t t_residual =
                        read_t_residual(dec, m, ctxs, amt);
                    uint32_t t =
                        (uint32_t)((int64_t)t_prediction + t_residual);
                    if (t < prev.t) t = prev.t;
                    last_delta_t = t - prev.t;
                    a.ev_d.push_back(d);
                    a.ev_t.push_back(t);
                    prev = Ev{d, t};
                }
            }
            a.seg_end[p] = (uint32_t)a.ev_d.size();
        }
    }
    return true;
}

// Drain in the reference single-thread order (event_adu.rs:195-214):
// cube raster, then channel, then pixel raster, per-pixel chronological
// (= the first event, then that pixel's inter segment). Returns event
// count, or -1 if the caller's capacity is insufficient.
static long csr_drain(const CsrDec& a, size_t blocks_x, uint16_t* xs,
                      uint16_t* ys, uint8_t* cs, uint8_t* ds, uint32_t* ts,
                      size_t cap) {
    size_t k = 0;
    size_t p = 0;
    const size_t ppc = a.channels * (BLOCK_SIZE * BLOCK_SIZE);
    for (size_t cube = 0; cube < a.n_cubes; cube++) {
        if (a.cube_skip[cube]) {
            // matches the old cube-drain semantics: a skip flag drops the
            // whole cube even if a corrupt stream decoded partial pixels
            p += ppc;
            continue;
        }
        const size_t by = cube / blocks_x, bx = cube % blocks_x;
        for (size_t c = 0; c < a.channels; c++)
            for (int y = 0; y < BLOCK_SIZE; y++)
                for (int x = 0; x < BLOCK_SIZE; x++, p++) {
                    if (!a.has_first[p]) continue;
                    const uint32_t lo = p ? a.seg_end[p - 1] : 0;
                    const uint32_t hi = a.seg_end[p];
                    if (k + 1 + (hi - lo) > cap) return -1;
                    const uint16_t px = (uint16_t)(bx * BLOCK_SIZE + x);
                    const uint16_t py = (uint16_t)(by * BLOCK_SIZE + y);
                    const uint8_t pc =
                        a.channels == 1 ? 255 : (uint8_t)c;
                    xs[k] = px;
                    ys[k] = py;
                    cs[k] = pc;
                    ds[k] = a.first_d[p];
                    ts[k] = a.first_t[p];
                    k++;
                    for (uint32_t e = lo; e < hi; e++, k++) {
                        xs[k] = px;
                        ys[k] = py;
                        cs[k] = pc;
                        ds[k] = a.ev_d[e];
                        ts[k] = a.ev_t[e];
                    }
                }
    }
    return (long)k;
}

// --------------------------------------------------- interleaved rANS ------
// Own TPU-friendly entropy stage (`addrn` magic; NOT in the reference): the
// cube residual transforms above are reused verbatim, but the adaptive
// arithmetic coder is replaced by 8-lane interleaved rANS with static
// per-ADU frequency tables (two-pass). Decoding is branch-light and
// lane-parallel; encoding visits symbols once to count and once to code.

constexpr uint32_t RANS_SCALE_BITS = 12;
constexpr uint32_t RANS_SCALE = 1u << RANS_SCALE_BITS;
constexpr uint32_t RANS_LOW = 1u << 16;
constexpr int RANS_LANES = 8;

// The replayer presents the RangeDecoder interface to the templated cube
// decode functions, replaying the rANS-decoded per-context symbol streams.
struct SymReplayer {
    static constexpr bool ADDRN_WIRE = true;  // FlatSink layout (v3)
    std::vector<std::vector<uint16_t>> streams;
    std::vector<size_t> pos;
    const uint8_t* raw = nullptr;  // FULL-escape low-bytes side channel
    size_t raw_len = 0, raw_pos = 0;
    bool fail = false;
    explicit SymReplayer(size_t n_ctx) : streams(n_ctx), pos(n_ctx, 0) {}
    size_t decode(Model& m) {
        auto& s = streams[m.current];
        size_t& p = pos[m.current];
        if (p >= s.size()) {
            fail = true;  // corrupt/truncated stream; loop caps bound us
            return 0;
        }
        return s[p++];
    }
    uint8_t raw1() {
        if (raw_pos >= raw_len) {
            fail = true;
            return 0;
        }
        return raw[raw_pos++];
    }
};

struct FreqTable {
    std::vector<uint32_t> freq, cum;   // freq[sym], cum[sym]
    std::vector<uint16_t> slot2sym;    // RANS_SCALE entries
    size_t n_sym = 0;

    // quantize raw counts to sum exactly RANS_SCALE (largest-remainder-ish:
    // floor scaling with >=1 per present symbol, then adjust the largest)
    bool build(const std::vector<uint32_t>& counts) {
        n_sym = counts.size();
        freq.assign(n_sym, 0);
        cum.assign(n_sym + 1, 0);
        uint64_t total = 0;
        for (uint32_t c : counts) total += c;
        if (total == 0) return true;  // empty stream
        uint64_t assigned = 0;
        size_t largest = 0;
        for (size_t s = 0; s < n_sym; s++) {
            if (!counts[s]) continue;
            uint64_t f = ((uint64_t)counts[s] * RANS_SCALE) / total;
            if (f == 0) f = 1;
            freq[s] = (uint32_t)f;
            assigned += f;
            if (counts[s] > counts[largest] || freq[largest] == 0) largest = s;
        }
        // fix the sum on the most frequent symbol
        int64_t fix = (int64_t)RANS_SCALE - (int64_t)assigned;
        if ((int64_t)freq[largest] + fix < 1) {
            // pathological many-rare-symbols case: flatten instead
            size_t present = 0;
            for (size_t s = 0; s < n_sym; s++) present += counts[s] ? 1 : 0;
            if (present > RANS_SCALE) return false;
            uint32_t base = RANS_SCALE / (uint32_t)present;
            uint32_t rem = RANS_SCALE % (uint32_t)present;
            for (size_t s = 0; s < n_sym; s++)
                if (counts[s]) freq[s] = base + (rem ? (rem--, 1) : 0);
        } else {
            freq[largest] = (uint32_t)((int64_t)freq[largest] + fix);
        }
        finish();
        return true;
    }
    void finish() {
        uint32_t acc = 0;
        slot2sym.assign(RANS_SCALE, 0);
        for (size_t s = 0; s < n_sym; s++) {
            cum[s] = acc;
            for (uint32_t i = 0; i < freq[s]; i++) slot2sym[acc + i] = (uint16_t)s;
            acc += freq[s];
        }
        cum[n_sym] = acc;
    }
};

static void put_u16(std::vector<uint8_t>& out, uint16_t v) {
    out.push_back((uint8_t)v);
    out.push_back((uint8_t)(v >> 8));
}
static void put_u32(std::vector<uint8_t>& out, uint32_t v) {
    for (int i = 0; i < 4; i++) out.push_back((uint8_t)(v >> (8 * i)));
}

struct ByteCursor {
    const uint8_t* p;
    size_t len, pos = 0;
    bool fail = false;
    uint16_t u16() {
        if (pos + 2 > len) { fail = true; return 0; }
        uint16_t v = (uint16_t)(p[pos] | (p[pos + 1] << 8));
        pos += 2;
        return v;
    }
    uint32_t u32() {
        if (pos + 4 > len) { fail = true; return 0; }
        uint32_t v = 0;
        for (int i = 0; i < 4; i++) v |= (uint32_t)p[pos + i] << (8 * i);
        pos += 4;
        return v;
    }
};

// Giesen-style interleaved rANS: encode in reverse symbol order, each lane
// renormalizing 16-bit words into a shared stream that is reversed at the
// end; the decoder walks symbols forward, lanes round-robin.
//
// The encoder state update needs x/f and x%f per symbol; f is a per-ADU
// static frequency, so replace the hardware division with the exact
// Granlund–Montgomery round-up reciprocal (x < 2^32 here: after renorm
// x < x_max = 2^20*f <= 2^32, and the update keeps it there). For
// power-of-two f the plain floor reciprocal 2^(32+l)/f = 2^32 is already
// exact, so one multiply-shift covers every symbol — no pow2 branch.
struct EncSym {
    uint64_t rcp;     // Granlund–Montgomery reciprocal
    uint64_t x_max;   // renorm threshold: 2^20 * freq
    uint32_t shift;   // total right shift for the quotient
    uint32_t freq;
    uint32_t cum;
};

static void build_enc_syms(const FreqTable& ft, std::vector<EncSym>& es) {
    es.resize(ft.n_sym);
    for (size_t s = 0; s < ft.n_sym; s++) {
        const uint32_t f = ft.freq[s];
        EncSym& e = es[s];
        e.freq = f;
        e.cum = ft.cum[s];
        e.x_max = ((uint64_t)(RANS_LOW >> RANS_SCALE_BITS) << 16) * f;
        if (f == 0) continue;
        if ((f & (f - 1)) == 0) {
            const uint32_t l = (uint32_t)__builtin_ctz(f);
            e.rcp = 1ull << 32;  // exact: x*2^32 >> (32+l) == x >> l
            e.shift = 32 + l;
        } else {
            const uint32_t l = 32 - __builtin_clz(f);  // ceil(log2 f)
            e.rcp = ((1ull << (32 + l)) / f) + 1;      // round-up reciprocal
            e.shift = 32 + l;
        }
    }
}

template <class SymT>
static void rans_encode_stream(const SymT* syms, size_t n,
                               const std::vector<EncSym>& es,
                               std::vector<uint8_t>& out) {
    uint32_t states[RANS_LANES];
    for (int l = 0; l < RANS_LANES; l++) states[l] = RANS_LOW;
    // Each symbol renormalizes at most once (one >>16 brings x below 2^16
    // <= x_max). Branchless renorm: store the candidate word unconditionally
    // at wpos-1 (overwritten next iteration when not taken), advance wpos
    // only when taken — the mispredicted renorm branch costs more than the
    // dead store on high-entropy streams. Fill from the tail so the payload
    // needs no reversal pass (buffer is raw: no zero-init of n words).
    std::unique_ptr<uint16_t[]> words(new uint16_t[n + 1]);
    size_t wpos = n + 1;
    for (size_t ii = n; ii-- > 0;) {
        const EncSym& e = es[syms[ii]];
        uint32_t x = states[ii % RANS_LANES];
        const unsigned ren = x >= e.x_max;
        words[wpos - 1] = (uint16_t)x;
        wpos -= ren;
        x >>= (ren << 4);
        const uint32_t q =
            (uint32_t)(((unsigned __int128)x * e.rcp) >> e.shift);
        states[ii % RANS_LANES] =
            (q << RANS_SCALE_BITS) + (x - q * e.freq) + e.cum;
    }
    for (int l = 0; l < RANS_LANES; l++) put_u32(out, states[l]);
    const size_t n_words = n + 1 - wpos;
    const size_t base = out.size();
    out.resize(base + 2 * n_words);
    std::memcpy(out.data() + base, words.get() + wpos, 2 * n_words);
}

static bool rans_decode_stream(ByteCursor& in, size_t n, const FreqTable& ft,
                               std::vector<uint16_t>& out_syms) {
    out_syms.resize(n);
    if (n == 0) return true;
    uint32_t states[RANS_LANES];
    for (int l = 0; l < RANS_LANES; l++) states[l] = in.u32();
    if (in.fail) return false;
    for (size_t i = 0; i < n; i++) {
        int l = (int)(i % RANS_LANES);
        uint32_t x = states[l];
        uint32_t slot = x & (RANS_SCALE - 1);
        uint16_t s = ft.slot2sym[slot];
        x = ft.freq[s] * (x >> RANS_SCALE_BITS) + slot - ft.cum[s];
        while (x < RANS_LOW) {
            if (in.pos + 2 > in.len) return false;
            x = (x << 16) | in.u16();
        }
        states[l] = x;
        out_syms[i] = s;
    }
    return true;
}

}  // namespace

// ------------------------------------------------------------- C ABI -------

extern "C" {

// Compress one ADU's events. Events must be the raw transcoder output order
// (per-pixel chronological). Coordinates are absolute; channel 255 = mono.
// Returns a malloc'd blob in *out (caller frees via adder_free).
// Event t values are rewritten to their (possibly lossy) reconstructions.
int adder_compress_adu(const uint16_t* xs, const uint16_t* ys,
                       const uint8_t* cs, const uint8_t* ds,
                       const uint32_t* ts, size_t n_events, uint16_t width,
                       uint16_t height, uint8_t channels, uint32_t start_t,
                       uint32_t dt_ref, uint32_t num_intervals,
                       uint8_t c_thresh_max, uint8_t** out, size_t* out_len) {
    StageClock clock;
    CsrAdu adu;
    build_csr(adu, xs, ys, cs, ds, ts, n_events, width, height, channels);
    g_ns_ingest += clock.lap();

    // compress (ref: event_adu.rs:83-116); the adaptive range coder IS the
    // transform sink here — the model updates per symbol, so transform and
    // entropy time are one stage for the compat `addec` path
    BitWriter bw;
    RangeEncoder enc;
    enc.out = &bw;
    Model m;
    Contexts ctxs(m);
    RangeSink sink{&enc, &m, &ctxs};

    m.current = ctxs.t_context;
    uint8_t stb[4] = {(uint8_t)(start_t >> 24), (uint8_t)(start_t >> 16),
                      (uint8_t)(start_t >> 8), (uint8_t)start_t};
    for (int i = 0; i < 4; i++) enc.encode(m, stb[i]);

    csr_intra(adu, sink, start_t, ctxs);
    csr_inter(adu, sink, start_t, dt_ref, num_intervals,
              (double)c_thresh_max, ctxs);

    // EOF flush (ref: cabac_contexts.rs:227-239)
    m.current = ctxs.eof_context;
    enc.encode(m, SIZE_MAX);
    enc.flush();
    bw.byte_align();
    g_ns_entropy += clock.lap();
    g_n_calls += 1;
    g_n_events += n_events;

    *out_len = bw.bytes.size();
    *out = (uint8_t*)std::malloc(bw.bytes.size());
    std::memcpy(*out, bw.bytes.data(), bw.bytes.size());
    return 0;
}

// Decompress one ADU blob. Outputs events in cube-raster drain order
// (ref: event_adu.rs:195-214, event_cube.rs:157-199). Caller provides
// capacity; returns number of events, or -1 if capacity insufficient.
long adder_decompress_adu(const uint8_t* blob, size_t blob_len, uint16_t width,
                          uint16_t height, uint8_t channels, uint32_t start_t,
                          uint32_t dt_ref, uint32_t num_intervals,
                          uint16_t* xs, uint16_t* ys, uint8_t* cs, uint8_t* ds,
                          uint32_t* ts, size_t cap) {
    const size_t blocks_y = (height + BLOCK_SIZE - 1) / BLOCK_SIZE;
    const size_t blocks_x = (width + BLOCK_SIZE - 1) / BLOCK_SIZE;

    BitReader br{blob, blob_len};
    RangeDecoder dec;
    dec.in = &br;
    Model m;
    Contexts ctxs(m);

    m.current = ctxs.t_context;
    uint8_t stb[4];
    for (int i = 0; i < 4; i++) stb[i] = (uint8_t)dec.decode(m);
    (void)stb;  // the reference reads but ignores this, using its own start_t

    CsrDec a;
    a.init(blocks_y * blocks_x, channels);
    csr_decompress_intra(a, dec, m, ctxs, start_t);
    if (!csr_decompress_inter(a, dec, m, ctxs, start_t, dt_ref,
                              num_intervals))
        return -2;  // corrupt stream: per-pixel event cap exceeded
    return csr_drain(a, blocks_x, xs, ys, cs, ds, ts, cap);
}

void adder_free(uint8_t* p) { std::free(p); }

// Stage-time breakdown across all adder_compress_adu[_rans] calls since the
// last reset: {ingest_ns, transform_ns, entropy_ns, calls, events, symbols}.
// For the compat `addec` path transform and entropy are one fused stage
// (adaptive model), reported under entropy_ns.
void adder_entropy_stats(uint64_t out[6], int reset) {
    out[0] = g_ns_ingest.load();
    out[1] = g_ns_transform.load();
    out[2] = g_ns_entropy.load();
    out[3] = g_n_calls.load();
    out[4] = g_n_events.load();
    out[5] = g_n_syms.load();
    if (reset) {
        g_ns_ingest = 0;
        g_ns_transform = 0;
        g_ns_entropy = 0;
        g_n_calls = 0;
        g_n_events = 0;
        g_n_syms = 0;
    }
}

// Compress one ADU with the interleaved-rANS entropy stage (`addrn` format;
// own design, not reference-compatible at the bitstream level — the cube
// residual transforms and event semantics are identical to the `addec`
// path, only the entropy coding differs).
//
// Blob layout (all little-endian):
//   u32 start_t
//   u8 lanes, u8 scale_bits, u16 wire_version (2: 5-byte FULL t escapes)
//   3 x context stream [d, t, bitshift]:
//     u32 n_syms
//     u16 n_nonzero, then n_nonzero x (u16 sym, u16 freq)
//     u32 payload_len, payload (lane states + reversed renorm words)
int adder_compress_adu_rans(const uint16_t* xs, const uint16_t* ys,
                            const uint8_t* cs, const uint8_t* ds,
                            const uint32_t* ts, size_t n_events,
                            uint16_t width, uint16_t height, uint8_t channels,
                            uint32_t start_t, uint32_t dt_ref,
                            uint32_t num_intervals, uint8_t c_thresh_max,
                            uint8_t** out, size_t* out_len) {
    StageClock clock;
    CsrAdu adu;
    build_csr(adu, xs, ys, cs, ds, ts, n_events, width, height, channels);
    g_ns_ingest += clock.lap();

    // stage 1: residual/prediction transforms -> three flat symbol streams
    Model m;
    Contexts ctxs(m);
    FlatSink col;
    col.reserve(adu.t.size(), adu.n_pix, adu.n_cubes);
    csr_intra(adu, col, start_t, ctxs);
    csr_inter(adu, col, start_t, dt_ref, num_intervals, (double)c_thresh_max,
              ctxs);
    g_ns_transform += clock.lap();

    // stage 2: static-table interleaved rANS over each stream.
    // Intra wide symbols and inter bytes share the d stream (same context in
    // the compat path), so the d alphabet is 513+5; t and bitshift are bytes.
    const size_t alphabet[3] = {513 + 5, 256, 16};

    std::vector<uint8_t> blob;
    blob.reserve(64 + adu.t.size() + col.nraw);
    put_u32(blob, start_t);
    blob.push_back((uint8_t)RANS_LANES);
    blob.push_back((uint8_t)RANS_SCALE_BITS);
    put_u16(blob, 3);  // addrn wire v3: 1-byte smalls, raw FULL side channel

    const uint16_t* d_syms = col.d.get();
    const uint8_t* byte_syms[3] = {nullptr, col.t.get(), col.bs.get()};
    const size_t stream_n[3] = {col.nd, col.nt, col.nbs};
    for (int k = 0; k < 3; k++) {
        const size_t n = stream_n[k];
        std::vector<uint32_t> counts(alphabet[k], 0);
        if (k == 0) {
            for (size_t i = 0; i < n; i++) {
                if (d_syms[i] >= alphabet[0]) return -3;
                counts[d_syms[i]]++;
            }
        } else {
            // 4-way split histogram: byte streams are dominated by a few
            // symbols, and a single counter array serializes on the
            // store-to-load dependency of the hot counter
            const uint8_t* s = byte_syms[k];
            uint32_t h[4][256] = {};
            size_t i = 0;
            for (; i + 4 <= n; i += 4) {
                h[0][s[i]]++;
                h[1][s[i + 1]]++;
                h[2][s[i + 2]]++;
                h[3][s[i + 3]]++;
            }
            for (; i < n; i++) h[0][s[i]]++;
            for (size_t sym = 0; sym < alphabet[k]; sym++)
                counts[sym] = h[0][sym] + h[1][sym] + h[2][sym] + h[3][sym];
        }
        FreqTable ft;
        if (!ft.build(counts)) return -4;
        put_u32(blob, (uint32_t)n);
        uint16_t nz = 0;
        for (uint32_t f : ft.freq) nz += f ? 1 : 0;
        put_u16(blob, nz);
        for (size_t s = 0; s < ft.freq.size(); s++)
            if (ft.freq[s]) {
                put_u16(blob, (uint16_t)s);
                put_u16(blob, (uint16_t)ft.freq[s]);
            }
        std::vector<uint8_t> payload;
        if (n) {
            std::vector<EncSym> es;
            build_enc_syms(ft, es);
            if (k == 0)
                rans_encode_stream(d_syms, n, es, payload);
            else
                rans_encode_stream(byte_syms[k], n, es, payload);
        }
        put_u32(blob, (uint32_t)payload.size());
        blob.insert(blob.end(), payload.begin(), payload.end());
        g_n_syms += n;
    }
    // FULL-escape low-bytes side channel (near-uniform; stored raw)
    put_u32(blob, (uint32_t)col.nraw);
    blob.insert(blob.end(), col.raw.get(), col.raw.get() + col.nraw);
    g_ns_entropy += clock.lap();
    g_n_calls += 1;
    g_n_events += n_events;

    *out_len = blob.size();
    *out = (uint8_t*)std::malloc(blob.size());
    std::memcpy(*out, blob.data(), blob.size());
    return 0;
}

long adder_decompress_adu_rans(const uint8_t* blob, size_t blob_len,
                               uint16_t width, uint16_t height,
                               uint8_t channels, uint32_t start_t,
                               uint32_t dt_ref, uint32_t num_intervals,
                               uint16_t* xs, uint16_t* ys, uint8_t* cs,
                               uint8_t* ds, uint32_t* ts, size_t cap) {
    const size_t blocks_y = (height + BLOCK_SIZE - 1) / BLOCK_SIZE;
    const size_t blocks_x = (width + BLOCK_SIZE - 1) / BLOCK_SIZE;

    Model m;
    Contexts ctxs(m);
    SymReplayer rep(m.contexts.size());
    const size_t ctx_ids[3] = {ctxs.d_context, ctxs.t_context,
                               ctxs.bitshift_context};
    const size_t alphabet[3] = {513 + 5, 256, 16};

    ByteCursor cur{blob, blob_len};
    (void)cur.u32();  // start_t (caller passes its own, like the reference)
    uint8_t lanes = cur.pos < cur.len ? blob[cur.pos] : 0;
    cur.pos += 1;
    uint8_t scale_bits = cur.pos < cur.len ? blob[cur.pos] : 0;
    cur.pos += 1;
    uint16_t wire_version = cur.u16();
    if (cur.fail || lanes != RANS_LANES || scale_bits != RANS_SCALE_BITS ||
        wire_version != 3)
        return -2;

    for (int k = 0; k < 3; k++) {
        uint32_t n_syms = cur.u32();
        uint16_t nz = cur.u16();
        if (cur.fail) return -2;
        std::vector<uint32_t> counts(alphabet[k], 0);
        FreqTable ft;
        ft.n_sym = alphabet[k];
        ft.freq.assign(alphabet[k], 0);
        ft.cum.assign(alphabet[k] + 1, 0);
        uint32_t fsum = 0;
        for (uint16_t i = 0; i < nz; i++) {
            uint16_t s = cur.u16();
            uint16_t f = cur.u16();
            if (cur.fail || s >= alphabet[k]) return -2;
            ft.freq[s] = f;
            fsum += f;
        }
        if (n_syms > 0 && fsum != RANS_SCALE) return -2;
        ft.finish();
        uint32_t payload_len = cur.u32();
        if (cur.fail || cur.pos + payload_len > cur.len) return -2;
        ByteCursor pc{blob + cur.pos, payload_len};
        if (!rans_decode_stream(pc, n_syms, ft, rep.streams[ctx_ids[k]]))
            return -2;
        cur.pos += payload_len;
    }
    // raw FULL-escape side channel (v3)
    uint32_t raw_len = cur.u32();
    if (cur.fail || cur.pos + raw_len > cur.len) return -2;
    rep.raw = blob + cur.pos;
    rep.raw_len = raw_len;
    cur.pos += raw_len;

    CsrDec a;
    a.init(blocks_y * blocks_x, channels);
    csr_decompress_intra(a, rep, m, ctxs, start_t);
    if (!csr_decompress_inter(a, rep, m, ctxs, start_t, dt_ref,
                              num_intervals))
        return -2;
    if (rep.fail) return -2;
    return csr_drain(a, blocks_x, xs, ys, cs, ds, ts, cap);
}

// LZ4 block decompression (standard LZ4 block format; used by the aedat4
// reader for DV-written files — lz4 has no Python binding in this
// environment). Returns decompressed size, or -1 on malformed input /
// insufficient capacity.
long adder_lz4_block_decompress(const uint8_t* src, size_t src_len,
                                uint8_t* dst, size_t dst_cap) {
    size_t ip = 0, op = 0;
    while (ip < src_len) {
        uint8_t token = src[ip++];
        size_t lit_len = token >> 4;
        if (lit_len == 15) {
            uint8_t b;
            do {
                if (ip >= src_len) return -1;
                b = src[ip++];
                lit_len += b;
            } while (b == 255);
        }
        if (ip + lit_len > src_len || op + lit_len > dst_cap) return -1;
        std::memcpy(dst + op, src + ip, lit_len);
        ip += lit_len;
        op += lit_len;
        if (ip >= src_len) break;  // last literals-only sequence
        if (ip + 2 > src_len) return -1;
        size_t offset = src[ip] | ((size_t)src[ip + 1] << 8);
        ip += 2;
        if (offset == 0 || offset > op) return -1;
        size_t match_len = (token & 0xF);
        if (match_len == 15) {
            uint8_t b;
            do {
                if (ip >= src_len) return -1;
                b = src[ip++];
                match_len += b;
            } while (b == 255);
        }
        match_len += 4;
        if (op + match_len > dst_cap) return -1;
        // overlapping copies are part of the format: byte-by-byte
        for (size_t i = 0; i < match_len; i++, op++)
            dst[op] = dst[op - offset];
    }
    return (long)op;
}

// Variant for LZ4-frame dependent blocks: dst[0..prefix_len) already holds
// the previous window; decoding starts at prefix_len and matches may reach
// back into the prefix. Returns end position (>= prefix_len) or -1.
long adder_lz4_block_decompress_prefixed(const uint8_t* src, size_t src_len,
                                         uint8_t* dst, size_t dst_cap,
                                         size_t prefix_len) {
    size_t ip = 0, op = prefix_len;
    while (ip < src_len) {
        uint8_t token = src[ip++];
        size_t lit_len = token >> 4;
        if (lit_len == 15) {
            uint8_t b;
            do {
                if (ip >= src_len) return -1;
                b = src[ip++];
                lit_len += b;
            } while (b == 255);
        }
        if (ip + lit_len > src_len || op + lit_len > dst_cap) return -1;
        std::memcpy(dst + op, src + ip, lit_len);
        ip += lit_len;
        op += lit_len;
        if (ip >= src_len) break;
        if (ip + 2 > src_len) return -1;
        size_t offset = src[ip] | ((size_t)src[ip + 1] << 8);
        ip += 2;
        if (offset == 0 || offset > op) return -1;
        size_t match_len = (token & 0xF);
        if (match_len == 15) {
            uint8_t b;
            do {
                if (ip >= src_len) return -1;
                b = src[ip++];
                match_len += b;
            } while (b == 255);
        }
        match_len += 4;
        if (op + match_len > dst_cap) return -1;
        for (size_t i = 0; i < match_len; i++, op++)
            dst[op] = dst[op - offset];
    }
    return (long)op;
}

// EventDrop EMA rate limiter over an event batch (ref: encoder.rs:234-253).
// IEEE double arithmetic matches the Python-scalar recurrence bit-for-bit,
// so the keep-set is identical; this just removes the per-event interpreter
// cost (million-event batches drop in ~ms).
double adder_event_drop_ema(size_t n, double rate, double alpha,
                            double instant_rate /* (1-alpha)/t_diff */,
                            double target, uint8_t* keep_out) {
    for (size_t i = 0; i < n; i++) {
        double new_rate = alpha * rate + instant_rate;
        if (new_rate > target) {
            rate *= alpha;
            keep_out[i] = 0;
        } else {
            rate = new_rate;
            keep_out[i] = 1;
        }
    }
    return rate;
}

}  // extern "C"
