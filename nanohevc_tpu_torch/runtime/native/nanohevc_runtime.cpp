// nanohevc-tpu native host runtime: adaptive binary arithmetic entropy
// codec, residual level coding, and NAL bitstream framing.
//
// Role: the sequential-by-nature entropy stage of the encoder.  The TPU
// produces scan-ordered quantized levels (nanohevc_tpu.ops.scan); this
// library turns them into a compressed bitstream on the host — and can
// decode them back bit-exactly (tests do lossless round-trips).
//
// The reference implementation declares cabac.py / nal.py but contains
// no entropy coding at all (reference/README.md:19-21, roadmap
// docs).  This codec is CABAC-class: context-adaptive binary
// arithmetic coding (byte-oriented range coder with carry propagation,
// 15-bit adaptive context probabilities, bypass bins) over an
// HEVC-flavored residual syntax (coded-block flag, significance map,
// greater-1/greater-2 flags, exp-Golomb remainders, bypass signs).
// The NAL layer applies the spec's start-code + emulation-prevention
// framing and exp-Golomb parameter-set fields.  The payload syntax is
// framework-defined, not HEVC-decoder conformant — the reference has
// no bitstream format to be compatible with.
//
// Build: g++ -O3 -shared -fPIC (see runtime/build.py).  C ABI only;
// Python binds via ctypes (runtime/entropy.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <utility>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Bit writer with exp-Golomb, for parameter-set RBSP payloads
// ---------------------------------------------------------------------------

class BitWriter {
 public:
  void put_bit(int b) {
    cur_ = static_cast<uint8_t>((cur_ << 1) | (b & 1));
    if (++nbits_ == 8) {
      buf_.push_back(cur_);
      cur_ = 0;
      nbits_ = 0;
    }
  }

  void put_bits(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) put_bit((v >> i) & 1);
  }

  void put_ue(uint32_t v) {  // Exp-Golomb ue(v)
    uint64_t x = static_cast<uint64_t>(v) + 1;
    int len = 0;
    for (uint64_t t = x; t > 1; t >>= 1) ++len;
    for (int i = 0; i < len; ++i) put_bit(0);
    for (int i = len; i >= 0; --i) put_bit((x >> i) & 1);
  }

  void rbsp_trailing() {  // stop bit + byte alignment
    put_bit(1);
    while (nbits_ != 0) put_bit(0);
  }

  const std::vector<uint8_t>& bytes() const { return buf_; }

 private:
  std::vector<uint8_t> buf_;
  uint8_t cur_ = 0;
  int nbits_ = 0;
};

// ---------------------------------------------------------------------------
// Adaptive binary range coder (byte-oriented, carry-propagating)
// ---------------------------------------------------------------------------

constexpr int kProbBits = 15;
constexpr uint32_t kProbMax = 1u << kProbBits;  // 32768
constexpr uint16_t kProbInit = kProbMax / 2;    // p(1) = 0.5
constexpr int kAdaptShift = 5;
constexpr uint32_t kTopValue = 1u << 24;

struct Context {
  uint16_t p1 = kProbInit;
  void update(int bin) {
    if (bin)
      p1 = static_cast<uint16_t>(p1 + ((kProbMax - p1) >> kAdaptShift));
    else
      p1 = static_cast<uint16_t>(p1 - (p1 >> kAdaptShift));
  }
};

class RangeEncoder {
 public:
  explicit RangeEncoder(std::vector<uint8_t>* out) : out_(out) {}

  void encode(Context* ctx, int bin) {
    uint32_t r1 = split(ctx->p1);
    if (bin) {
      range_ = r1;
    } else {
      low_ += r1;
      range_ -= r1;
    }
    ctx->update(bin);
    normalize();
  }

  void encode_bypass(int bin) {
    uint32_t half = range_ >> 1;
    if (bin) {
      range_ = half;
    } else {
      low_ += half;
      range_ -= half;
    }
    normalize();
  }

  void finish() {
    for (int i = 0; i < 5; ++i) shift_low();
  }

 private:
  uint32_t split(uint32_t p1) const {
    uint32_t r1 = static_cast<uint32_t>(
        (static_cast<uint64_t>(range_) * p1) >> kProbBits);
    if (r1 == 0) r1 = 1;
    if (r1 >= range_) r1 = range_ - 1;
    return r1;
  }

  void normalize() {
    while (range_ < kTopValue) {
      shift_low();
      range_ <<= 8;
    }
  }

  void shift_low() {
    if (static_cast<uint32_t>(low_) < 0xff000000u || (low_ >> 32) != 0) {
      uint8_t carry = static_cast<uint8_t>(low_ >> 32);
      if (!first_) out_->push_back(static_cast<uint8_t>(cache_ + carry));
      first_ = false;
      while (pending_ > 0) {
        out_->push_back(static_cast<uint8_t>(0xff + carry));
        --pending_;
      }
      cache_ = static_cast<uint8_t>(low_ >> 24);
    } else {
      ++pending_;
    }
    low_ = (low_ << 8) & 0xffffffffull;
  }

  std::vector<uint8_t>* out_;
  uint64_t low_ = 0;
  uint32_t range_ = 0xffffffffu;
  uint8_t cache_ = 0;
  int pending_ = 0;
  bool first_ = true;
};

class RangeDecoder {
 public:
  RangeDecoder(const uint8_t* data, size_t n) : data_(data), n_(n) {
    for (int i = 0; i < 4; ++i) code_ = (code_ << 8) | next_byte();
  }

  // True once the stream has read materially past its end (a valid
  // stream's decoder never consumes more than the encoder's 5-byte
  // flush slack) or a syntax element overran its bound.
  bool failed() const { return failed_; }
  void set_failed() { failed_ = true; }

  int decode(Context* ctx) {
    uint32_t r1 = split(ctx->p1);
    int bin;
    if (code_ < r1) {
      bin = 1;
      range_ = r1;
    } else {
      bin = 0;
      code_ -= r1;
      range_ -= r1;
    }
    ctx->update(bin);
    normalize();
    return bin;
  }

  int decode_bypass() {
    uint32_t half = range_ >> 1;
    int bin;
    if (code_ < half) {
      bin = 1;
      range_ = half;
    } else {
      bin = 0;
      code_ -= half;
      range_ -= half;
    }
    normalize();
    return bin;
  }

 private:
  uint32_t split(uint32_t p1) const {
    uint32_t r1 = static_cast<uint32_t>(
        (static_cast<uint64_t>(range_) * p1) >> kProbBits);
    if (r1 == 0) r1 = 1;
    if (r1 >= range_) r1 = range_ - 1;
    return r1;
  }

  void normalize() {
    while (range_ < kTopValue) {
      code_ = (code_ << 8) | next_byte();
      range_ <<= 8;
    }
  }

  uint8_t next_byte() {
    if (pos_ < n_) return data_[pos_++];
    if (++overrun_ > 5) failed_ = true;
    return 0;
  }

  const uint8_t* data_;
  size_t n_;
  size_t pos_ = 0;
  size_t overrun_ = 0;
  bool failed_ = false;
  uint32_t code_ = 0;
  uint32_t range_ = 0xffffffffu;
};

// ---------------------------------------------------------------------------
// Residual level syntax (HEVC-flavored, framework-defined)
// ---------------------------------------------------------------------------
//
// Per block of `ncoef` scan-ordered levels:
//   coded_block_flag                      1 ctx bin
//   if coded, per position p:
//     sig_coeff_flag[p]    ctx keyed by min(p, 31)
//     if sig: abs_gt1 (ctx), abs_gt2 (ctx), remainder (EG0 bypass),
//             sign (bypass)
// Context state persists across blocks within one encode call and is
// re-initialized identically by the decoder.

struct ResidualContexts {
  Context cbf;
  Context sig[32];
  Context gt1;
  Context gt2;
  Context last_full;        // last == ncoef-1 escape (dense blocks)
  Context last_prefix[31];  // truncated-unary last-position prefix bins
                            // (bit_len_m1 of any int32 ncoef is < 31)
};

// Highest set bit index of x >= 1 (floor(log2(x))).
inline int bit_len_m1(uint32_t x) {
  int len = 0;
  while (x > 1) {
    x >>= 1;
    ++len;
  }
  return len;
}

void encode_eg0(RangeEncoder* enc, uint32_t v) {
  uint64_t x = static_cast<uint64_t>(v) + 1;
  int len = 0;
  for (uint64_t t = x; t > 1; t >>= 1) ++len;
  for (int i = 0; i < len; ++i) enc->encode_bypass(1);
  enc->encode_bypass(0);
  for (int i = len - 1; i >= 0; --i) enc->encode_bypass((x >> i) & 1);
}

uint32_t decode_eg0(RangeDecoder* dec) {
  int len = 0;
  // Cap the unary prefix: legal levels fit 32 bits, so len > 40 can
  // only come from a corrupt stream (zero-extended garbage decodes an
  // endless run of 1-bins — without the cap this loop never exits).
  while (dec->decode_bypass()) {
    if (++len > 40) {
      dec->set_failed();
      return 0;
    }
  }
  uint64_t x = 1;
  for (int i = 0; i < len; ++i) x = (x << 1) | dec->decode_bypass();
  return static_cast<uint32_t>(x - 1);
}

// Last significant position, HEVC-style: a context-coded truncated-
// unary prefix (the bit length of last+1) and a bypass suffix (its low
// bits).  This bounds the sig_coeff_flag loop at `last` instead of
// ncoef — for typical sparse blocks a 3-10x cut in coded bins, the
// dominant CPU cost of the stage — while trailing-zero positions cost
// ZERO bits instead of a near-free-but-nonzero adapted sig bin each.
void encode_last(RangeEncoder* enc, ResidualContexts* cx, int32_t last,
                 int32_t ncoef) {
  // Dense escape: a full block (last == ncoef-1) is one adapted bin
  // instead of max_len prefix ones + max_len incompressible suffix
  // zeros — the worst-case payload (dense noise) is where every bit
  // counts twice.
  enc->encode(&cx->last_full, last == ncoef - 1);
  if (last == ncoef - 1) return;
  uint32_t x = static_cast<uint32_t>(last) + 1;  // in [1, ncoef-1]
  int len = bit_len_m1(x);
  int max_len = bit_len_m1(static_cast<uint32_t>(ncoef) - 1);
  for (int i = 0; i < len; ++i) enc->encode(&cx->last_prefix[i], 1);
  if (len < max_len) enc->encode(&cx->last_prefix[len], 0);
  for (int i = len - 1; i >= 0; --i) enc->encode_bypass((x >> i) & 1);
}

int32_t decode_last(RangeDecoder* dec, ResidualContexts* cx, int32_t ncoef) {
  if (dec->decode(&cx->last_full)) return ncoef - 1;
  int max_len = bit_len_m1(static_cast<uint32_t>(ncoef) - 1);
  int len = 0;
  while (len < max_len && dec->decode(&cx->last_prefix[len])) ++len;
  uint32_t x = 1;
  for (int i = 0; i < len; ++i) x = (x << 1) | dec->decode_bypass();
  int32_t last = static_cast<int32_t>(x) - 1;
  if (last >= ncoef) {  // only reachable from a corrupt stream
    dec->set_failed();
    last = ncoef - 1;
  }
  return last;
}

void encode_block(RangeEncoder* enc, ResidualContexts* cx,
                  const int32_t* levels, int32_t ncoef) {
  int32_t last = ncoef - 1;
  while (last >= 0 && levels[last] == 0) --last;
  enc->encode(&cx->cbf, last >= 0);
  if (last < 0) return;
  encode_last(enc, cx, last, ncoef);
  for (int32_t p = 0; p <= last; ++p) {
    int32_t l = levels[p];
    int sig = l != 0;
    if (p < last) enc->encode(&cx->sig[p < 31 ? p : 31], sig);
    if (!sig) continue;
    uint32_t a = l < 0 ? static_cast<uint32_t>(-(int64_t)l)
                       : static_cast<uint32_t>(l);
    int gt1 = a > 1;
    enc->encode(&cx->gt1, gt1);
    if (gt1) {
      int gt2 = a > 2;
      enc->encode(&cx->gt2, gt2);
      if (gt2) encode_eg0(enc, a - 3);
    }
    enc->encode_bypass(l < 0);
  }
}

void decode_block(RangeDecoder* dec, ResidualContexts* cx, int32_t* levels,
                  int32_t ncoef) {
  std::memset(levels, 0, sizeof(int32_t) * ncoef);
  int has = dec->decode(&cx->cbf);
  if (!has || dec->failed()) return;
  int32_t last = decode_last(dec, cx, ncoef);
  for (int32_t p = 0; p <= last; ++p) {
    if (dec->failed()) return;
    int sig = p == last ? 1 : dec->decode(&cx->sig[p < 31 ? p : 31]);
    if (!sig) continue;
    uint32_t a = 1;
    if (dec->decode(&cx->gt1)) {
      a = 2;
      if (dec->decode(&cx->gt2)) a = 3 + decode_eg0(dec);
    }
    levels[p] = dec->decode_bypass() ? -static_cast<int32_t>(a)
                                     : static_cast<int32_t>(a);
  }
}

// ---------------------------------------------------------------------------
// Intra-mode syntax: spec 8.4.2.2 most-probable-mode prediction
// ---------------------------------------------------------------------------
//
// Per block, raster order over the (nby, nbx) grid: derive the 3-entry
// MPM candidate list from the left/above neighbor modes (unavailable
// neighbors read as INTRA_DC=1, the spec rule), then code
//   prev_intra_pred_flag          1 ctx bin
//   if set:  mpm_idx              truncated-unary, 2 ctx bins
//   else:    rem_intra_pred_mode  5 bins, one adaptive ctx per position
//            (the spec bypasses these; adaptive contexts are the
//             framework's liberty and strictly help on skewed content)
// The decoder re-derives the identical list from its already-decoded
// neighbor modes, so no side information is needed.  Mode numbering is
// the spec's: 0 planar, 1 DC, 2-34 angular (reference intra.py:24).

struct ModeContexts {
  Context mpm_flag;
  Context idx0, idx1;
  Context rem[5];
};

// candModeList per spec 8.4.2.2 given left/above candidate modes.
inline void mpm_list(int32_t a, int32_t b, int32_t* m) {
  if (a == b) {
    if (a < 2) {           // both planar/DC: planar, DC, vertical
      m[0] = 0; m[1] = 1; m[2] = 26;
    } else {               // angular: a and its two angular neighbors
      m[0] = a;
      m[1] = 2 + ((a + 29) % 32);
      m[2] = 2 + ((a - 2 + 1) % 32);
    }
  } else {
    m[0] = a; m[1] = b;
    if (a != 0 && b != 0) m[2] = 0;          // planar absent -> planar
    else m[2] = (a + b) < 2 ? 26 : 1;        // else DC, else vertical
  }
}

inline void sort3(int32_t* s) {
  if (s[0] > s[1]) std::swap(s[0], s[1]);
  if (s[1] > s[2]) std::swap(s[1], s[2]);
  if (s[0] > s[1]) std::swap(s[0], s[1]);
}

// Returns -2 on out-of-range input modes, else 0.
int encode_modes_impl(const int32_t* modes, int64_t nby, int64_t nbx,
                      RangeEncoder* enc, ModeContexts* cx) {
  for (int64_t y = 0; y < nby; ++y) {
    for (int64_t x = 0; x < nbx; ++x) {
      int64_t i = y * nbx + x;
      int32_t mode = modes[i];
      if (mode < 0 || mode > 34) return -2;
      int32_t a = x > 0 ? modes[i - 1] : 1;
      int32_t b = y > 0 ? modes[i - nbx] : 1;
      int32_t m[3];
      mpm_list(a, b, m);
      int idx = mode == m[0] ? 0 : mode == m[1] ? 1 : mode == m[2] ? 2 : -1;
      enc->encode(&cx->mpm_flag, idx >= 0);
      if (idx >= 0) {
        enc->encode(&cx->idx0, idx > 0);
        if (idx > 0) enc->encode(&cx->idx1, idx - 1);
      } else {
        int32_t s[3] = {m[0], m[1], m[2]};
        sort3(s);
        int32_t rem = mode;
        for (int k = 2; k >= 0; --k)
          if (mode > s[k]) --rem;
        for (int k = 4; k >= 0; --k)
          enc->encode(&cx->rem[k], (rem >> k) & 1);
      }
    }
  }
  return 0;
}

void decode_modes_impl(RangeDecoder* dec, ModeContexts* cx, int64_t nby,
                       int64_t nbx, int32_t* out) {
  for (int64_t y = 0; y < nby; ++y) {
    for (int64_t x = 0; x < nbx; ++x) {
      int64_t i = y * nbx + x;
      int32_t a = x > 0 ? out[i - 1] : 1;
      int32_t b = y > 0 ? out[i - nbx] : 1;
      int32_t m[3];
      mpm_list(a, b, m);
      int32_t mode;
      if (dec->decode(&cx->mpm_flag)) {
        int idx = 0;
        if (dec->decode(&cx->idx0)) idx = 1 + dec->decode(&cx->idx1);
        mode = m[idx];
      } else {
        int32_t rem = 0;
        for (int k = 4; k >= 0; --k)
          rem |= dec->decode(&cx->rem[k]) << k;
        int32_t s[3] = {m[0], m[1], m[2]};
        sort3(s);
        mode = rem;
        for (int k = 0; k < 3; ++k)
          if (mode >= s[k]) ++mode;
      }
      out[i] = mode;
      if (dec->failed()) return;
    }
  }
}

// ---------------------------------------------------------------------------
// Payload integrity: a 4-lane multiply-xor hash over the level array,
// appended LE after the range-coded bytes.  The range coder itself
// cannot detect corruption (any byte string decodes to SOME level
// sequence); the checksum turns silent mis-decodes into hard failures.
//
// Four independent 64-bit lanes break the serial multiply dependency
// chain a classic byte-wise FNV-1a imposes — measured, the one-lane
// byte hash alone cost ~13 ms per 1080p frame (2 M coefficients x 4
// bytes x a 4-cycle-latency chain), capping the whole entropy stage at
// ~150 Mpix/s even for all-zero payloads.  The lanes pipeline in one
// multiplier port; the final mix folds them order-sensitively.
// ---------------------------------------------------------------------------

constexpr uint64_t kHashMul = 0x9e3779b97f4a7c15ull;  // 2^64 / phi

uint32_t level_hash(const int32_t* levels, int64_t count) {
  uint64_t h[4] = {0x243f6a8885a308d3ull, 0x13198a2e03707344ull,
                   0xa4093822299f31d0ull, 0x082efa98ec4e6c89ull};
  int64_t i = 0;
  for (; i + 4 <= count; i += 4) {
    h[0] = (h[0] ^ static_cast<uint32_t>(levels[i + 0])) * kHashMul;
    h[1] = (h[1] ^ static_cast<uint32_t>(levels[i + 1])) * kHashMul;
    h[2] = (h[2] ^ static_cast<uint32_t>(levels[i + 2])) * kHashMul;
    h[3] = (h[3] ^ static_cast<uint32_t>(levels[i + 3])) * kHashMul;
  }
  for (int l = 0; i < count; ++i, ++l)
    h[l] = (h[l] ^ static_cast<uint32_t>(levels[i])) * kHashMul;
  uint64_t x = h[0];
  for (int l = 1; l < 4; ++l) x = (x ^ h[l] ^ (h[l] >> 29)) * kHashMul;
  x ^= x >> 32;
  x *= kHashMul;
  return static_cast<uint32_t>(x ^ (x >> 29));
}

// ---------------------------------------------------------------------------
// Rate accounting: exact expected code length of the adaptive coder
// ---------------------------------------------------------------------------
//
// Replays the residual syntax through the SAME context machinery as the
// encoder, accumulating -log2(p) per context bin (bypass bins cost
// exactly 1).  This is the arithmetic coder's code length up to carry/
// renormalization rounding (< 0.1% on realistic payloads — asserted in
// tests/test_rate_model.py), and feeds RD decisions with real rates
// instead of heuristics.

class RateCounter {
 public:
  void count(Context* ctx, int bin) {
    double p1 = static_cast<double>(ctx->p1) / kProbMax;
    bits_ += -std::log2(bin ? p1 : 1.0 - p1);
    ctx->update(bin);
  }
  void count_bypass() { bits_ += 1.0; }
  double take() {
    double b = bits_;
    bits_ = 0.0;
    return b;
  }

 private:
  double bits_ = 0.0;
};

int eg0_bits(uint32_t v) {
  uint64_t x = static_cast<uint64_t>(v) + 1;
  int len = 0;
  for (uint64_t t = x; t > 1; t >>= 1) ++len;
  return 2 * len + 1;
}

void count_block(RateCounter* rc, ResidualContexts* cx, const int32_t* levels,
                 int32_t ncoef) {
  int32_t last = ncoef - 1;
  while (last >= 0 && levels[last] == 0) --last;
  rc->count(&cx->cbf, last >= 0);
  if (last < 0) return;
  rc->count(&cx->last_full, last == ncoef - 1);
  if (last != ncoef - 1) {
    // last-position: ctx-coded truncated-unary prefix + bypass suffix
    uint32_t x = static_cast<uint32_t>(last) + 1;
    int len = bit_len_m1(x);
    int max_len = bit_len_m1(static_cast<uint32_t>(ncoef) - 1);
    for (int i = 0; i < len; ++i) rc->count(&cx->last_prefix[i], 1);
    if (len < max_len) rc->count(&cx->last_prefix[len], 0);
    for (int i = 0; i < len; ++i) rc->count_bypass();
  }
  for (int32_t p = 0; p <= last; ++p) {
    int32_t l = levels[p];
    int sig = l != 0;
    if (p < last) rc->count(&cx->sig[p < 31 ? p : 31], sig);
    if (!sig) continue;
    uint32_t a = l < 0 ? static_cast<uint32_t>(-(int64_t)l)
                       : static_cast<uint32_t>(l);
    int gt1 = a > 1;
    rc->count(&cx->gt1, gt1);
    if (gt1) {
      int gt2 = a > 2;
      rc->count(&cx->gt2, gt2);
      if (gt2)
        for (int i = 0; i < eg0_bits(a - 3); ++i) rc->count_bypass();
    }
    rc->count_bypass();  // sign
  }
}


// ---------------------------------------------------------------------------
// Entropy tiles: parallel encode/decode over independent context chunks
// ---------------------------------------------------------------------------
//
// The block axis splits into n_tiles contiguous chunks; each chunk is a
// self-contained adaptive stream (fresh contexts, own range coder), so
// chunks encode and decode on parallel threads -- the HEVC analog is
// tiles / wavefront parallel processing, which exist precisely because
// CABAC is sequential within a context chain.  Layout of the tiled
// payload:
//
//   u16 n_tiles | u32 byte-length x n_tiles | tile streams | u32 FNV-1a
//
// The trailing checksum covers the whole level array (same policy as
// the single-stream format).  Fresh per-tile contexts cost a little
// adaptation warm-up (<1% at 4 tiles on frame-sized payloads); the
// payoff is near-linear host parallelism on both sides.

void encode_tile(const int32_t* levels, int64_t blocks, int32_t ncoef,
                 std::vector<uint8_t>* out) {
  RangeEncoder enc(out);
  ResidualContexts cx;
  for (int64_t b = 0; b < blocks; ++b)
    encode_block(&enc, &cx, levels + b * ncoef, ncoef);
  enc.finish();
}

int decode_tile(const uint8_t* data, size_t n, int64_t blocks, int32_t ncoef,
                int32_t* out) {
  RangeDecoder dec(data, n);
  ResidualContexts cx;
  for (int64_t b = 0; b < blocks; ++b)
    decode_block(&dec, &cx, out + b * ncoef, ncoef);
  return dec.failed() ? 3 : 0;
}

// ---------------------------------------------------------------------------
// NAL framing (start codes, header, emulation prevention)
// ---------------------------------------------------------------------------

size_t wrap_nal(uint8_t nal_type, const uint8_t* payload, size_t n,
                uint8_t* out, size_t cap) {
  std::vector<uint8_t> buf;
  buf.reserve(n + 16);
  // start_code_prefix_one_3bytes with leading zero (first NAL style)
  buf.push_back(0);
  buf.push_back(0);
  buf.push_back(0);
  buf.push_back(1);
  // nal_unit_header: forbidden_zero_bit, nal_unit_type(6),
  // nuh_layer_id(6)=0, nuh_temporal_id_plus1(3)=1
  buf.push_back(static_cast<uint8_t>((nal_type & 0x3f) << 1));
  buf.push_back(0x01);
  // payload with emulation_prevention_three_byte stuffing
  int zeros = 0;
  for (size_t i = 0; i < n; ++i) {
    uint8_t b = payload[i];
    if (zeros >= 2 && b <= 3) {
      buf.push_back(3);
      zeros = 0;
    }
    buf.push_back(b);
    zeros = (b == 0) ? zeros + 1 : 0;
  }
  if (buf.size() > cap) return 0;
  std::memcpy(out, buf.data(), buf.size());
  return buf.size();
}

// Run fn(t) for t in [0, n_tasks) on at most hardware_concurrency()
// threads.  The tile count can come from an untrusted stream header,
// so it must never translate into unbounded thread creation; and a
// std::thread that fails to start must not throw across the C ABI —
// on any spawn failure the spawned workers are joined and every task
// is (re-)run serially, which is safe because tasks are idempotent
// (each tile deterministically writes only its own output range).
template <typename Fn>
void run_tiled(int32_t n_tasks, const Fn& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int32_t n_workers = static_cast<int32_t>(hw ? hw : 4);
  if (n_workers > n_tasks) n_workers = n_tasks;
  if (n_workers > 1) {
    std::vector<std::thread> workers;
    workers.reserve(n_workers);
    try {
      for (int32_t w = 0; w < n_workers; ++w) {
        workers.emplace_back([w, n_workers, n_tasks, &fn]() {
          for (int32_t t = w; t < n_tasks; t += n_workers) fn(t);
        });
      }
    } catch (...) {
      for (auto& th : workers) th.join();
      for (int32_t t = 0; t < n_tasks; ++t) fn(t);
      return;
    }
    for (auto& th : workers) th.join();
    return;
  }
  for (int32_t t = 0; t < n_tasks; ++t) fn(t);
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Encode nb blocks of ncoef scan-ordered levels.  Returns byte count,
// or -1 if `cap` is too small.  The last 4 bytes are an FNV-1a
// checksum of the level array (LE), verified by nhr_decode_levels.
int64_t nhr_encode_levels(const int32_t* levels, int64_t nb, int32_t ncoef,
                          uint8_t* out, int64_t cap) {
  std::vector<uint8_t> buf;
  buf.reserve(static_cast<size_t>(nb) * ncoef / 4 + 64);
  RangeEncoder enc(&buf);
  ResidualContexts cx;
  for (int64_t b = 0; b < nb; ++b) {
    encode_block(&enc, &cx, levels + b * ncoef, ncoef);
  }
  enc.finish();
  uint32_t h = level_hash(levels, nb * ncoef);
  for (int b = 0; b < 4; ++b) buf.push_back((h >> (8 * b)) & 0xffu);
  if (static_cast<int64_t>(buf.size()) > cap) return -1;
  std::memcpy(out, buf.data(), buf.size());
  return static_cast<int64_t>(buf.size());
}

// Decode nb blocks back.  Returns 0 on success; nonzero on corruption:
//   1  stream shorter than its checksum trailer (truncated)
//   2  checksum mismatch (decoded levels differ from what was encoded)
//   3  decoder overran the coded bytes / syntax bound (truncated or
//      garbage input)
int64_t nhr_decode_levels(const uint8_t* data, int64_t nbytes, int64_t nb,
                          int32_t ncoef, int32_t* out) {
  if (nbytes < 4) return 1;
  RangeDecoder dec(data, static_cast<size_t>(nbytes) - 4);
  ResidualContexts cx;
  for (int64_t b = 0; b < nb; ++b) {
    decode_block(&dec, &cx, out + b * ncoef, ncoef);
  }
  if (dec.failed()) return 3;
  uint32_t want = 0;
  for (int b = 0; b < 4; ++b)
    want |= static_cast<uint32_t>(data[nbytes - 4 + b]) << (8 * b);
  if (level_hash(out, nb * ncoef) != want) return 2;
  return 0;
}


// Tiled variant of nhr_encode_levels: n_tiles independent context
// chunks encoded on parallel threads.  Returns byte count, -1 if cap
// too small.  n_tiles is clamped to [1, nb].
int64_t nhr_encode_levels_tiled(const int32_t* levels, int64_t nb,
                                int32_t ncoef, int32_t n_tiles, uint8_t* out,
                                int64_t cap) {
  if (n_tiles < 1) n_tiles = 1;
  if (nb > 0 && n_tiles > nb) n_tiles = static_cast<int32_t>(nb);
  if (nb == 0) n_tiles = 1;
  std::vector<std::vector<uint8_t>> bufs(n_tiles);
  int64_t per = n_tiles > 0 ? (nb + n_tiles - 1) / n_tiles : 0;
  run_tiled(n_tiles, [&](int32_t t) {
    bufs[t].clear();
    int64_t b0 = t * per;
    int64_t blocks = b0 < nb ? std::min<int64_t>(per, nb - b0) : 0;
    encode_tile(levels + b0 * ncoef, blocks, ncoef, &bufs[t]);
  });
  std::vector<uint8_t> buf;
  buf.push_back(static_cast<uint8_t>(n_tiles & 0xff));
  buf.push_back(static_cast<uint8_t>((n_tiles >> 8) & 0xff));
  for (int32_t t = 0; t < n_tiles; ++t) {
    uint32_t len = static_cast<uint32_t>(bufs[t].size());
    for (int b = 0; b < 4; ++b)
      buf.push_back(static_cast<uint8_t>((len >> (8 * b)) & 0xffu));
  }
  for (int32_t t = 0; t < n_tiles; ++t)
    buf.insert(buf.end(), bufs[t].begin(), bufs[t].end());
  uint32_t h = level_hash(levels, nb * ncoef);
  for (int b = 0; b < 4; ++b) buf.push_back((h >> (8 * b)) & 0xffu);
  if (static_cast<int64_t>(buf.size()) > cap) return -1;
  std::memcpy(out, buf.data(), buf.size());
  return static_cast<int64_t>(buf.size());
}

// Decode a tiled payload (parallel threads, one per tile).  Same
// return codes as nhr_decode_levels, plus 4 for a malformed tile
// table.
int64_t nhr_decode_levels_tiled(const uint8_t* data, int64_t nbytes,
                                int64_t nb, int32_t ncoef, int32_t* out) {
  if (nbytes < 6) return 1;
  int32_t n_tiles = static_cast<int32_t>(data[0]) |
                    (static_cast<int32_t>(data[1]) << 8);
  if (n_tiles < 1 || n_tiles > 65535 || (nb > 0 && n_tiles > nb)) return 4;
  int64_t table_end = 2 + 4ll * n_tiles;
  if (nbytes < table_end + 4) return 1;
  std::vector<int64_t> lens(n_tiles);
  int64_t total = 0;
  for (int32_t t = 0; t < n_tiles; ++t) {
    uint32_t len = 0;
    for (int b = 0; b < 4; ++b)
      len |= static_cast<uint32_t>(data[2 + 4 * t + b]) << (8 * b);
    lens[t] = len;
    total += len;
  }
  if (table_end + total + 4 > nbytes) return 1;
  int64_t per = (nb + n_tiles - 1) / n_tiles;
  std::vector<int> rcs(n_tiles, 0);
  std::vector<int64_t> offs(n_tiles);
  int64_t off = table_end;
  for (int32_t t = 0; t < n_tiles; ++t) {
    offs[t] = off;
    off += lens[t];
  }
  run_tiled(n_tiles, [&](int32_t t) {
    int64_t b0 = t * per;
    int64_t blocks = b0 < nb ? std::min<int64_t>(per, nb - b0) : 0;
    rcs[t] = decode_tile(data + offs[t], static_cast<size_t>(lens[t]),
                         blocks, ncoef, out + b0 * ncoef);
  });
  for (int rc : rcs)
    if (rc != 0) return rc;
  uint32_t want = 0;
  for (int b = 0; b < 4; ++b)
    want |= static_cast<uint32_t>(data[nbytes - 4 + b]) << (8 * b);
  if (level_hash(out, nb * ncoef) != want) return 2;
  return 0;
}

// Encode nby*nbx intra modes (0-34, raster order) with MPM prediction.
// Returns byte count, -1 if cap too small, -2 on out-of-range input.
// Trailing 4 bytes: the level-array hash over the modes (LE).
int64_t nhr_encode_modes(const int32_t* modes, int64_t nby, int64_t nbx,
                         uint8_t* out, int64_t cap) {
  std::vector<uint8_t> buf;
  buf.reserve(static_cast<size_t>(nby * nbx) / 2 + 64);
  RangeEncoder enc(&buf);
  ModeContexts cx;
  if (encode_modes_impl(modes, nby, nbx, &enc, &cx) != 0) return -2;
  enc.finish();
  uint32_t h = level_hash(modes, nby * nbx);
  for (int b = 0; b < 4; ++b) buf.push_back((h >> (8 * b)) & 0xffu);
  if (static_cast<int64_t>(buf.size()) > cap) return -1;
  std::memcpy(out, buf.data(), buf.size());
  return static_cast<int64_t>(buf.size());
}

// Decode nby*nbx modes back.  Return codes as nhr_decode_levels.
int64_t nhr_decode_modes(const uint8_t* data, int64_t nbytes, int64_t nby,
                         int64_t nbx, int32_t* out) {
  if (nbytes < 4) return 1;
  RangeDecoder dec(data, static_cast<size_t>(nbytes) - 4);
  ModeContexts cx;
  decode_modes_impl(&dec, &cx, nby, nbx, out);
  if (dec.failed()) return 3;
  uint32_t want = 0;
  for (int b = 0; b < 4; ++b)
    want |= static_cast<uint32_t>(data[nbytes - 4 + b]) << (8 * b);
  if (level_hash(out, nby * nbx) != want) return 2;
  return 0;
}

// Wrap a payload into a NAL unit (start code + header + emulation
// prevention).  Returns byte count, 0 if cap too small.
int64_t nhr_wrap_nal(uint8_t nal_type, const uint8_t* payload, int64_t n,
                     uint8_t* out, int64_t cap) {
  return static_cast<int64_t>(
      wrap_nal(nal_type, payload, static_cast<size_t>(n), out,
               static_cast<size_t>(cap)));
}

// Minimal parameter-set RBSP (framework-defined fields, spec-style
// exp-Golomb coding).  which: 0=VPS, 1=SPS, 2=PPS.  Returns byte count.
int64_t nhr_write_params(int32_t width, int32_t height, int32_t block_size,
                         int32_t qp, uint8_t which, int32_t bit_depth,
                         int32_t scan_idx, int32_t rescale_flag,
                         int32_t smoothing_flag, int32_t entropy_idx,
                         int32_t deblock_flag, int32_t mode_mpm_flag,
                         int32_t sao_flag, uint8_t* out, int64_t cap) {
  BitWriter bw;
  bw.put_bits(0x4e48u, 16);  // "NH" magic
  bw.put_bits(which, 8);
  if (which == 0) {          // VPS: version info
    bw.put_ue(2);            // vps_version: 2 = last-position residual
                             // syntax + 4-lane level hash (round 3)
    bw.put_ue(0);            // reserved
  } else if (which == 1) {   // SPS: geometry
    bw.put_ue(static_cast<uint32_t>(width));
    bw.put_ue(static_cast<uint32_t>(height));
    bw.put_ue(static_cast<uint32_t>(block_size));
    bw.put_ue(1);            // chroma_format_idc: 4:2:0
    bw.put_ue(static_cast<uint32_t>(bit_depth - 8));  // bit_depth_luma_minus8
  } else {                   // PPS: coding params
    bw.put_ue(static_cast<uint32_t>(qp));
    bw.put_ue(static_cast<uint32_t>(scan_idx));  // 0=diag 1=horiz 2=vert
    bw.put_ue(static_cast<uint32_t>(rescale_flag));  // spec-gain dequant
    bw.put_ue(static_cast<uint32_t>(smoothing_flag));  // [1 2 1] ref filter
    bw.put_ue(static_cast<uint32_t>(entropy_idx));  // 0=range 1=spec CABAC
    bw.put_ue(static_cast<uint32_t>(deblock_flag));  // spec 8.7.2 in-loop
    bw.put_ue(static_cast<uint32_t>(mode_mpm_flag));  // MPM mode syntax
    bw.put_ue(static_cast<uint32_t>(sao_flag));  // spec 8.7.3 SAO: when
                             // set, a decoder must find the frame's SAO
                             // NAL or reject the stream (a dropped SAO
                             // NAL must not silently decode unfiltered)
  }
  bw.rbsp_trailing();
  if (static_cast<int64_t>(bw.bytes().size()) > cap) return 0;
  std::memcpy(out, bw.bytes().data(), bw.bytes().size());
  return static_cast<int64_t>(bw.bytes().size());
}

// Per-block exact rate (fractional bits) of the adaptive coder over nb
// blocks of ncoef scan-ordered levels, context state carried across
// blocks exactly as nhr_encode_levels carries it.
void nhr_block_bits(const int32_t* levels, int64_t nb, int32_t ncoef,
                    double* out_bits) {
  RateCounter rc;
  ResidualContexts cx;
  for (int64_t b = 0; b < nb; ++b) {
    count_block(&rc, &cx, levels + b * ncoef, ncoef);
    out_bits[b] = rc.take();
  }
}

int32_t nhr_version() { return 20; }

}  // extern "C"
