// HEVC-conformant CABAC engine + residual_coding syntax (host entropy).
//
// This is the spec-true counterpart of the framework range coder in
// nanohevc_runtime.cpp: the ITU-T H.265 9.3 arithmetic engine
// (rangeTabLPS / transIdx state machine, 9.3.2.2 context
// initialization from 8-bit initValues) driving the 7.3.8.11
// residual_coding syntax (last-significant-coefficient prefix/suffix,
// 4x4 coefficient-group significance map, greater1/greater2 context
// sets, bypass sign bits, Golomb-Rice coeff_abs_level_remaining with
// Rice-parameter adaptation).  The reference project declares this as
// roadmap (reference README.md:97-100, "cabac.py") and never ships it.
//
// Two entry levels:
//   nhc_encode_plane/nhc_decode_plane — transform-block payloads: each
//   block is one cbf + residual_coding + terminate.  Streams are
//   engine- and syntax-conformant at the residual layer.
//   nhc_encode_slice/nhc_decode_slice — the FULL spec-syntax slice:
//   slice_segment_header (7.3.6.1), fixed-depth coding_quadtree
//   (7.3.8.4), coding_unit with the 8.4.2.2 MPM intra-mode syntax
//   (7.3.8.5), transform_unit cbf, residual_coding with the 7.4.9.11
//   mode-derived scanIdx, end_of_slice_segment_flag per CTU.  See the
//   slice-layer section below.  SPS/PPS framing stays
//   framework-defined in both cases.
// Decoding is a bit-exact mirror; round-trip and rate are asserted in
// tests/test_hevc_cabac.py and tests/test_hevc_slice.py (the latter
// against an independent pure-Python spec parser).
//
// Exposed C ABI (ctypes):
//   nhc_encode_plane(coeffs, nb, log2, c_idx, scan_idx[nb], qp, out, cap)
//   nhc_decode_plane(data, nbytes, nb, log2, c_idx, scan_idx[nb], qp, out)
//   nhc_encode_slice(coeffs, modes, nby, nbx, log2, qp, out, cap)
//   nhc_decode_slice(data, nbytes, nby, nbx, log2, coeffs, modes, qp_out)
//   nhc_version()

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Spec tables (9.3.4.3.2.2): LPS range and state transitions.
// ---------------------------------------------------------------------------

const uint8_t kRangeTabLps[64][4] = {
    {128, 176, 208, 240}, {128, 167, 197, 227}, {128, 158, 187, 216},
    {123, 150, 178, 205}, {116, 142, 169, 195}, {111, 135, 160, 185},
    {105, 128, 152, 175}, {100, 122, 144, 166}, {95, 116, 137, 158},
    {90, 110, 130, 150},  {85, 104, 123, 142},  {81, 99, 117, 135},
    {77, 94, 111, 128},   {73, 89, 105, 122},   {69, 85, 100, 116},
    {66, 80, 95, 110},    {62, 76, 90, 104},    {59, 72, 86, 99},
    {56, 69, 81, 94},     {53, 65, 77, 89},     {51, 62, 73, 85},
    {48, 59, 69, 80},     {46, 56, 66, 76},     {43, 53, 63, 72},
    {41, 50, 59, 69},     {39, 48, 56, 65},     {37, 45, 54, 62},
    {35, 43, 51, 59},     {33, 41, 48, 56},     {32, 39, 46, 53},
    {30, 37, 43, 50},     {28, 35, 41, 48},     {27, 33, 39, 45},
    {26, 31, 37, 43},     {24, 30, 35, 41},     {23, 28, 33, 39},
    {22, 27, 32, 37},     {21, 26, 30, 35},     {20, 24, 29, 33},
    {19, 23, 27, 31},     {18, 22, 26, 30},     {17, 21, 25, 28},
    {16, 20, 23, 27},     {15, 19, 22, 25},     {14, 18, 21, 24},
    {14, 17, 20, 23},     {13, 16, 19, 22},     {12, 15, 18, 21},
    {12, 14, 17, 20},     {11, 14, 16, 19},     {11, 13, 15, 18},
    {10, 12, 15, 17},     {10, 12, 14, 16},     {9, 11, 13, 15},
    {9, 11, 12, 14},      {8, 10, 12, 14},      {8, 9, 11, 13},
    {7, 9, 11, 12},       {7, 9, 10, 12},       {7, 8, 10, 11},
    {6, 8, 9, 11},        {6, 7, 9, 10},        {6, 7, 8, 9},
    {2, 2, 2, 2},
};

const uint8_t kTransIdxLps[64] = {
    0,  0,  1,  2,  2,  4,  4,  5,  6,  7,  8,  9,  9,  11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 23, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
};

inline uint8_t trans_idx_mps(uint8_t s) { return s < 62 ? s + 1 : s; }

// ---------------------------------------------------------------------------
// Context model: 6-bit state + MPS, spec 9.3.2.2 initialization.
// ---------------------------------------------------------------------------

struct Ctx {
  uint8_t state = 0;
  uint8_t mps = 0;

  void init(int init_value, int qp) {
    int slope = (init_value >> 4) * 5 - 45;
    int offset = ((init_value & 15) << 3) - 16;
    int qp_c = qp < 0 ? 0 : (qp > 51 ? 51 : qp);
    int pre = ((slope * qp_c) >> 4) + offset;
    pre = pre < 1 ? 1 : (pre > 126 ? 126 : pre);
    mps = pre > 63;
    state = static_cast<uint8_t>(mps ? pre - 64 : 63 - pre);
  }
};

// initValues for initType 0 (I slices), from the spec's context tables
// (Tables 9-13..9-25 grouping of residual-coding syntax elements).
const uint8_t kInitCbfLuma = 111;
const uint8_t kInitCbfChroma = 94;
const uint8_t kInitLastX[18] = {110, 110, 124, 125, 140, 153, 125, 127, 140,
                                109, 111, 143, 127, 111, 79,  108, 123, 63};
const uint8_t kInitLastY[18] = {110, 110, 124, 125, 140, 153, 125, 127, 140,
                                109, 111, 143, 127, 111, 79,  108, 123, 63};
const uint8_t kInitCsbf[4] = {91, 171, 134, 141};
const uint8_t kInitSig[42] = {
    111, 111, 125, 110, 110, 94,  124, 108, 124, 107, 125, 141, 179, 153,
    125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 140,
    139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139, 111,
};
const uint8_t kInitGt1[24] = {140, 92,  137, 138, 140, 152, 138, 139,
                              153, 74,  149, 92,  139, 107, 122, 152,
                              140, 179, 166, 182, 140, 227, 122, 197};
const uint8_t kInitGt2[6] = {138, 153, 136, 167, 152, 152};

struct ResidualCtxs {
  Ctx cbf_luma, cbf_chroma;
  Ctx last_x[18], last_y[18];
  Ctx csbf[4];
  Ctx sig[42];
  Ctx gt1[24];
  Ctx gt2[6];

  void init(int qp) {
    cbf_luma.init(kInitCbfLuma, qp);
    cbf_chroma.init(kInitCbfChroma, qp);
    for (int i = 0; i < 18; ++i) last_x[i].init(kInitLastX[i], qp);
    for (int i = 0; i < 18; ++i) last_y[i].init(kInitLastY[i], qp);
    for (int i = 0; i < 4; ++i) csbf[i].init(kInitCsbf[i], qp);
    for (int i = 0; i < 42; ++i) sig[i].init(kInitSig[i], qp);
    for (int i = 0; i < 24; ++i) gt1[i].init(kInitGt1[i], qp);
    for (int i = 0; i < 6; ++i) gt2[i].init(kInitGt2[i], qp);
  }
};

// ---------------------------------------------------------------------------
// Arithmetic encoder: the spec's EncodeDecision / RenormE / PutBit /
// EncodeBypass / EncodeTerminate / EncodeFlush flowcharts, bit-wise
// with outstanding-bit carry resolution, packed MSB-first.
// ---------------------------------------------------------------------------

class CabacEncoder {
 public:
  explicit CabacEncoder(std::vector<uint8_t>* out) : out_(out) {}

  void encode(Ctx& c, int bin) {
    uint32_t lps = kRangeTabLps[c.state][(range_ >> 6) & 3];
    range_ -= lps;
    if (bin != c.mps) {
      low_ += range_;
      range_ = lps;
      if (c.state == 0) c.mps ^= 1;
      c.state = kTransIdxLps[c.state];
    } else {
      c.state = trans_idx_mps(c.state);
    }
    renorm();
  }

  void bypass(int bin) {
    low_ <<= 1;
    if (bin) low_ += range_;
    if (low_ >= 1024) {
      put_bit(1);
      low_ -= 1024;
    } else if (low_ < 512) {
      put_bit(0);
    } else {
      low_ -= 512;
      ++outstanding_;
    }
  }

  void bypass_bits(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) bypass((v >> i) & 1);
  }

  void terminate(int bin) {
    range_ -= 2;
    if (bin) {
      low_ += range_;
      flush();
    } else {
      renorm();
    }
  }

  size_t finish() {
    // flush() was called by terminate(1); pad the bit buffer to a
    // byte boundary (rbsp alignment zeros).
    while (nbits_ & 7) push(0);
    return out_->size();
  }

 private:
  void renorm() {
    while (range_ < 256) {
      if (low_ < 256) {
        put_bit(0);
      } else if (low_ >= 512) {
        low_ -= 512;
        put_bit(1);
      } else {
        low_ -= 256;
        ++outstanding_;
      }
      range_ <<= 1;
      low_ <<= 1;
    }
  }

  void flush() {
    range_ = 2;
    renorm();
    put_bit((low_ >> 9) & 1);
    // two final bits: (low >> 7) & 3 with the stop bit forced to 1
    uint32_t tail = ((low_ >> 7) & 3) | 1;
    push((tail >> 1) & 1);
    push(tail & 1);
  }

  void put_bit(int b) {
    if (first_) {
      first_ = false;
    } else {
      push(b);
    }
    while (outstanding_ > 0) {
      push(1 - b);
      --outstanding_;
    }
  }

  void push(int b) {
    if ((nbits_ & 7) == 0) out_->push_back(0);
    out_->back() |= static_cast<uint8_t>(b << (7 - (nbits_ & 7)));
    ++nbits_;
  }

  std::vector<uint8_t>* out_;
  uint32_t low_ = 0;
  uint32_t range_ = 510;
  int outstanding_ = 0;
  bool first_ = true;
  uint64_t nbits_ = 0;
};

// ---------------------------------------------------------------------------
// Arithmetic decoder (spec 9.3.4.3): 9-bit offset window.
// ---------------------------------------------------------------------------

class CabacDecoder {
 public:
  CabacDecoder(const uint8_t* data, size_t n) : data_(data), nbytes_(n) {
    for (int i = 0; i < 9; ++i) offset_ = (offset_ << 1) | read_bit();
  }

  int decode(Ctx& c) {
    uint32_t lps = kRangeTabLps[c.state][(range_ >> 6) & 3];
    range_ -= lps;
    int bin;
    if (offset_ >= range_) {
      bin = 1 - c.mps;
      offset_ -= range_;
      range_ = lps;
      if (c.state == 0) c.mps ^= 1;
      c.state = kTransIdxLps[c.state];
    } else {
      bin = c.mps;
      c.state = trans_idx_mps(c.state);
    }
    while (range_ < 256) {
      range_ <<= 1;
      offset_ = (offset_ << 1) | read_bit();
    }
    return bin;
  }

  int bypass() {
    offset_ = (offset_ << 1) | read_bit();
    if (offset_ >= range_) {
      offset_ -= range_;
      return 1;
    }
    return 0;
  }

  uint32_t bypass_bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | bypass();
    return v;
  }

  int terminate() {
    range_ -= 2;
    if (offset_ >= range_) return 1;
    while (range_ < 256) {
      range_ <<= 1;
      offset_ = (offset_ << 1) | read_bit();
    }
    return 0;
  }

  bool overrun() const { return overrun_; }

 private:
  uint32_t read_bit() {
    if ((bitpos_ >> 3) >= nbytes_) {
      overrun_ = true;
      return 0;
    }
    uint32_t b = (data_[bitpos_ >> 3] >> (7 - (bitpos_ & 7))) & 1;
    ++bitpos_;
    return b;
  }

  const uint8_t* data_;
  size_t nbytes_;
  uint64_t bitpos_ = 0;
  uint32_t range_ = 510;
  uint32_t offset_ = 0;
  bool overrun_ = false;
};

// ---------------------------------------------------------------------------
// Scan tables (spec 6.5.3): up-right diagonal / horizontal / vertical
// position arrays, generated once per (blkSize, scanIdx).
// ---------------------------------------------------------------------------

struct ScanTables {
  // pos[scanIdx][size_log2][k] = (x, y) pairs; sizes 1, 2, 4, 8.
  std::vector<uint8_t> pos[3][4];

  ScanTables() {
    for (int lg = 0; lg < 4; ++lg) {
      int s = 1 << lg;
      auto& d = pos[0][lg];
      for (int t = 0; t <= 2 * (s - 1); ++t)       // up-right diagonal
        for (int y = s - 1 >= t ? t : s - 1; y >= 0 && t - y < s; --y) {
          d.push_back(static_cast<uint8_t>(t - y));
          d.push_back(static_cast<uint8_t>(y));
        }
      auto& h = pos[1][lg];
      for (int y = 0; y < s; ++y)                  // horizontal raster
        for (int x = 0; x < s; ++x) {
          h.push_back(static_cast<uint8_t>(x));
          h.push_back(static_cast<uint8_t>(y));
        }
      auto& v = pos[2][lg];
      for (int x = 0; x < s; ++x)                  // vertical raster
        for (int y = 0; y < s; ++y) {
          v.push_back(static_cast<uint8_t>(x));
          v.push_back(static_cast<uint8_t>(y));
        }
    }
  }
};

const ScanTables kScan;

inline void scan_xy(int scan_idx, int lg, int k, int* x, int* y) {
  const uint8_t* p = kScan.pos[scan_idx][lg].data() + 2 * k;
  *x = p[0];
  *y = p[1];
}

// sig_coeff_flag ctxIdxMap for 4x4 blocks (spec 9.3.4.2.5).
const uint8_t kSigCtx4x4[16] = {0, 1, 4, 5, 2, 3, 4, 5,
                                6, 6, 8, 8, 7, 7, 8, 8};

// sig_coeff_flag context (9.3.4.2.5) for one coefficient.
//   xc, yc: coefficient coords; lg2: log2TrafoSize; prev_csbf:
//   right|below<<1 coded_sub_block_flags; scan_idx for 8x8 luma.
int sig_ctx_inc(int xc, int yc, int lg2, int c_idx, int prev_csbf,
                int scan_idx) {
  if (lg2 == 2) {
    int sig = kSigCtx4x4[(yc << 2) + xc];
    return c_idx == 0 ? sig : 27 + sig;
  }
  if (xc == 0 && yc == 0) return c_idx == 0 ? 0 : 27;
  int xs = xc >> 2, ys = yc >> 2;
  int xp = xc & 3, yp = yc & 3;
  int sig;
  switch (prev_csbf) {
    case 0:
      sig = (xp + yp == 0) ? 2 : (xp + yp < 3) ? 1 : 0;
      break;
    case 1:
      sig = (yp == 0) ? 2 : (yp == 1) ? 1 : 0;
      break;
    case 2:
      sig = (xp == 0) ? 2 : (xp == 1) ? 1 : 0;
      break;
    default:
      sig = 2;
  }
  if (c_idx == 0) {
    if (xs + ys > 0) sig += 3;
    if (lg2 == 3)
      sig += scan_idx == 0 ? 9 : 15;
    else
      sig += 21;
    return sig;
  }
  sig += lg2 == 3 ? 9 : 12;
  return 27 + sig;
}

// last_sig_coeff prefix context parameters (9.3.4.2.3).
inline void last_ctx_params(int lg2, int c_idx, int* offset, int* shift) {
  if (c_idx == 0) {
    *offset = 3 * (lg2 - 2) + ((lg2 - 1) >> 2);
    *shift = (lg2 + 1) >> 2;
  } else {
    *offset = 15;
    *shift = lg2 - 2;
  }
}

// ---------------------------------------------------------------------------
// residual_coding (7.3.8.11) — encoder.
// ---------------------------------------------------------------------------

struct SubsetFlags {
  // csbf per sub-block (raster by sub-block coords), up to 8x8 groups.
  uint8_t f[64] = {0};
  int ng;
  explicit SubsetFlags(int ng_) : ng(ng_) {}
  int get(int xs, int ys) const {
    if (xs >= ng || ys >= ng) return 0;
    return f[ys * ng + xs];
  }
  void set(int xs, int ys) { f[ys * ng + xs] = 1; }
};

int group_of(int pos) {
  // group index g such that minPos(g) <= pos < minPos(g+1);
  // minPos: 0,1,2,3,4,6,8,12,16,24,...
  if (pos < 4) return pos;
  int g = 4;
  while (true) {
    int nbits = (g >> 1) - 1;
    int base = (2 + (g & 1)) << nbits;
    int next = (2 + ((g + 1) & 1)) << (((g + 1) >> 1) - 1);
    if (pos >= base && pos < next) return g;
    ++g;
  }
}

void encode_last(CabacEncoder& enc, ResidualCtxs& rc, int last_x, int last_y,
                 int lg2, int c_idx, int scan_idx) {
  if (scan_idx == 2) {
    int t = last_x;
    last_x = last_y;
    last_y = t;
  }
  int g_max = (lg2 << 1) - 1;
  int gx = group_of(last_x), gy = group_of(last_y);
  int offset, shift;
  last_ctx_params(lg2, c_idx, &offset, &shift);
  for (int b = 0; b < g_max; ++b) {
    enc.encode(rc.last_x[offset + (b >> shift)], b < gx);
    if (b >= gx) break;
  }
  for (int b = 0; b < g_max; ++b) {
    enc.encode(rc.last_y[offset + (b >> shift)], b < gy);
    if (b >= gy) break;
  }
  if (gx > 3) {
    int nbits = (gx >> 1) - 1;
    enc.bypass_bits(
        static_cast<uint32_t>(last_x - ((2 + (gx & 1)) << nbits)), nbits);
  }
  if (gy > 3) {
    int nbits = (gy >> 1) - 1;
    enc.bypass_bits(
        static_cast<uint32_t>(last_y - ((2 + (gy & 1)) << nbits)), nbits);
  }
}

void decode_last(CabacDecoder& dec, ResidualCtxs& rc, int lg2, int c_idx,
                 int scan_idx, int* last_x, int* last_y) {
  int g_max = (lg2 << 1) - 1;
  int offset, shift;
  last_ctx_params(lg2, c_idx, &offset, &shift);
  int gx = 0, gy = 0;
  while (gx < g_max && dec.decode(rc.last_x[offset + (gx >> shift)])) ++gx;
  while (gy < g_max && dec.decode(rc.last_y[offset + (gy >> shift)])) ++gy;
  int x = gx, y = gy;
  if (gx > 3) {
    int nbits = (gx >> 1) - 1;
    x = ((2 + (gx & 1)) << nbits) + static_cast<int>(dec.bypass_bits(nbits));
  }
  if (gy > 3) {
    int nbits = (gy >> 1) - 1;
    y = ((2 + (gy & 1)) << nbits) + static_cast<int>(dec.bypass_bits(nbits));
  }
  if (scan_idx == 2) {
    int t = x;
    x = y;
    y = t;
  }
  *last_x = x;
  *last_y = y;
}

// Golomb-Rice + exp-Golomb coeff_abs_level_remaining (9.3.3.2).
void encode_remaining(CabacEncoder& enc, int value, int rice) {
  if (value < (3 << rice)) {
    int q = value >> rice;
    for (int i = 0; i < q; ++i) enc.bypass(1);
    enc.bypass(0);
    if (rice) enc.bypass_bits(static_cast<uint32_t>(value & ((1 << rice) - 1)),
                              rice);
  } else {
    // escape to exp-Golomb: suffix length k grows from rice while the
    // residual consumes whole 2^k buckets (HM xWriteCoefRemainExGolomb)
    int v = value - (3 << rice);
    int k = rice;
    while (v >= (1 << k)) {
      v -= 1 << k;
      ++k;
    }
    for (int i = 0; i < 3 + k - rice; ++i) enc.bypass(1);
    enc.bypass(0);
    enc.bypass_bits(static_cast<uint32_t>(v), k);
  }
}

int decode_remaining(CabacDecoder& dec, int rice) {
  int prefix = 0;
  while (prefix < 32 && dec.bypass()) ++prefix;
  if (prefix < 3) {
    int v = prefix << rice;
    if (rice) v += static_cast<int>(dec.bypass_bits(rice));
    return v;
  }
  // escape: (3 + k - rice) ones then 0, then a k-bit suffix;
  // value = (3 << rice) + sum_{j=rice..k-1} 2^j + suffix
  int k = rice + prefix - 3;
  int base = 3 << rice;
  for (int j = rice; j < k; ++j) base += 1 << j;
  return base + static_cast<int>(dec.bypass_bits(k));
}

// kScanOrder: the block's words are in its combined scan order (word k
// is the coefficient at scan position k, word (sb << 4) + in the one at
// position in of sub-block sb), as the frame encoder packs them; else
// in raster order (word y * size + x).
template <bool kScanOrder = false>
void residual_encode(CabacEncoder& enc, ResidualCtxs& rc,
                     const int32_t* coeffs, int lg2, int c_idx,
                     int scan_idx) {
  int size = 1 << lg2;
  int ng = size >> 2;            // sub-blocks per side (1 for 4x4)
  int sub_lg = lg2 > 2 ? lg2 - 2 : 0;
  int n_sub = ng * ng;

  // locate last significant coefficient in scan order
  int last_scan = -1;
  int total = size * size;
  // combined scan position k -> (x, y)
  auto coef_xy = [&](int k, int* x, int* y) {
    if (lg2 == 2) {
      scan_xy(scan_idx, 2, k, x, y);
      return;
    }
    int sb = k >> 4, in = k & 15;
    int xs, ys, xp, yp;
    scan_xy(scan_idx, sub_lg, sb, &xs, &ys);
    scan_xy(scan_idx, 2, in, &xp, &yp);
    *x = (xs << 2) + xp;
    *y = (ys << 2) + yp;
  };
  // the word of coefficient (x, y) at scan position k
  auto at = [&](int k, int x, int y) {
    return kScanOrder ? coeffs[k] : coeffs[y * size + x];
  };
  for (int k = total - 1; k >= 0; --k) {
    int x, y;
    coef_xy(k, &x, &y);
    if (at(k, x, y)) {
      last_scan = k;
      break;
    }
  }
  // caller guarantees at least one nonzero (cbf gate)
  int lx, ly;
  coef_xy(last_scan, &lx, &ly);
  encode_last(enc, rc, lx, ly, lg2, c_idx, scan_idx);

  SubsetFlags csbf(ng > 0 ? ng : 1);
  // precompute csbf values
  for (int sb = 0; sb < n_sub; ++sb) {
    int xs, ys;
    scan_xy(scan_idx, sub_lg, sb, &xs, &ys);
    for (int in = 0; in < 16; ++in) {
      int xp, yp;
      scan_xy(scan_idx, 2, in, &xp, &yp);
      int x = lg2 == 2 ? xp : (xs << 2) + xp;
      int y = lg2 == 2 ? yp : (ys << 2) + yp;
      if (at((sb << 4) + in, x, y)) {
        csbf.set(xs, ys);
        break;
      }
    }
  }

  int last_sub = last_scan >> 4;
  if (lg2 == 2) last_sub = 0;
  int gt1_ctx_prev_set = 1;  // tracks c1 at end of previous subset

  for (int sb = last_sub; sb >= 0; --sb) {
    int xs = 0, ys = 0;
    if (lg2 > 2) scan_xy(scan_idx, sub_lg, sb, &xs, &ys);
    int right = csbf.get(xs + 1, ys);
    int below = csbf.get(xs, ys + 1);
    int sb_coded = csbf.get(xs, ys);
    int infer_dc_sig = 0;
    if (sb < last_sub && sb > 0) {
      int ctx = (right || below) ? 1 : 0;
      enc.encode(rc.csbf[ctx + (c_idx ? 2 : 0)], sb_coded);
      infer_dc_sig = 1;
    } else {
      sb_coded = 1;  // first and last sub-blocks are always coded
    }
    if (!sb_coded) continue;

    int prev_csbf = right | (below << 1);
    int first_in_sb = lg2 == 2 ? 0 : sb << 4;
    int start = sb == last_sub ? last_scan : first_in_sb + 15;

    // significance map (last coefficient's sig is implied)
    int sig_pos[16];
    int n_sig = 0;
    int n_coded_sig = 0;
    for (int k = start; k >= first_in_sb; --k) {
      int x, y;
      coef_xy(k, &x, &y);
      int sig = at(k, x, y) != 0;
      int in_sb = k & 15;
      if (lg2 == 2) in_sb = k;
      if (k == last_scan) {
        // implied significant
      } else if (in_sb == 0 && infer_dc_sig && n_coded_sig == 0 && sb > 0) {
        // inferred significant (no coded sig in sub-block yet)
      } else {
        enc.encode(rc.sig[sig_ctx_inc(x, y, lg2, c_idx, prev_csbf, scan_idx)],
                   sig);
        if (sig) ++n_coded_sig;
      }
      if (sig) sig_pos[n_sig++] = k;
    }

    // level coding for this sub-block's significant coefficients
    // (sig_pos is in reverse scan order already)
    int ctx_set = (sb > 0 && c_idx == 0) ? 2 : 0;
    if (gt1_ctx_prev_set == 0) ++ctx_set;
    int c1 = 1;
    int n_gt1 = n_sig < 8 ? n_sig : 8;
    int first_gt1_idx = -1;
    int abs_lv[16];
    for (int i = 0; i < n_sig; ++i) {
      int x, y;
      coef_xy(sig_pos[i], &x, &y);
      int v = at(sig_pos[i], x, y);
      abs_lv[i] = v < 0 ? -v : v;
    }
    for (int i = 0; i < n_gt1; ++i) {
      int gt1 = abs_lv[i] > 1;
      int ctx = (c_idx ? 16 : 0) + ctx_set * 4 + c1;
      enc.encode(rc.gt1[ctx], gt1);
      if (gt1) {
        c1 = 0;
        if (first_gt1_idx < 0) first_gt1_idx = i;
      } else if (c1 < 3 && c1 > 0) {
        ++c1;
      }
    }
    gt1_ctx_prev_set = c1;
    if (first_gt1_idx >= 0) {
      int gt2 = abs_lv[first_gt1_idx] > 2;
      enc.encode(rc.gt2[(c_idx ? 4 : 0) + ctx_set], gt2);
    }
    // signs, bypass (no sign-data hiding: PPS flag 0)
    for (int i = 0; i < n_sig; ++i) {
      int x, y;
      coef_xy(sig_pos[i], &x, &y);
      enc.bypass(at(sig_pos[i], x, y) < 0);
    }
    // remaining levels
    int rice = 0;
    for (int i = 0; i < n_sig; ++i) {
      int base = 1;
      if (i < n_gt1) {
        base = 2;
        if (i == first_gt1_idx) base = 3;
      }
      if (abs_lv[i] >= base) {
        encode_remaining(enc, abs_lv[i] - base, rice);
        if (abs_lv[i] > (3 << rice) && rice < 4) ++rice;
      }
    }
  }
}

int residual_decode(CabacDecoder& dec, ResidualCtxs& rc, int32_t* coeffs,
                    int lg2, int c_idx, int scan_idx) {
  int size = 1 << lg2;
  int ng = size >> 2;
  int sub_lg = lg2 > 2 ? lg2 - 2 : 0;
  std::memset(coeffs, 0, sizeof(int32_t) * size * size);

  auto coef_xy = [&](int k, int* x, int* y) {
    if (lg2 == 2) {
      scan_xy(scan_idx, 2, k, x, y);
      return;
    }
    int sb = k >> 4, in = k & 15;
    int xs, ys, xp, yp;
    scan_xy(scan_idx, sub_lg, sb, &xs, &ys);
    scan_xy(scan_idx, 2, in, &xp, &yp);
    *x = (xs << 2) + xp;
    *y = (ys << 2) + yp;
  };

  int lx, ly;
  decode_last(dec, rc, lg2, c_idx, scan_idx, &lx, &ly);
  if (lx >= size || ly >= size) return 2;
  // find last_scan from (lx, ly)
  int total = size * size;
  int last_scan = -1;
  for (int k = 0; k < total; ++k) {
    int x, y;
    coef_xy(k, &x, &y);
    if (x == lx && y == ly) {
      last_scan = k;
      break;
    }
  }
  if (last_scan < 0) return 2;

  SubsetFlags csbf(ng > 0 ? ng : 1);
  int last_sub = lg2 == 2 ? 0 : last_scan >> 4;
  {
    int xs = 0, ys = 0;
    if (lg2 > 2) scan_xy(scan_idx, sub_lg, last_sub, &xs, &ys);
    csbf.set(xs, ys);
    csbf.set(0, 0);
  }
  int gt1_ctx_prev_set = 1;

  for (int sb = last_sub; sb >= 0; --sb) {
    int xs = 0, ys = 0;
    if (lg2 > 2) scan_xy(scan_idx, sub_lg, sb, &xs, &ys);
    int right = csbf.get(xs + 1, ys);
    int below = csbf.get(xs, ys + 1);
    int sb_coded = 1;
    int infer_dc_sig = 0;
    if (sb < last_sub && sb > 0) {
      int ctx = (right || below) ? 1 : 0;
      sb_coded = dec.decode(rc.csbf[ctx + (c_idx ? 2 : 0)]);
      if (sb_coded) csbf.set(xs, ys);
      infer_dc_sig = 1;
    }
    if (!sb_coded) continue;

    int prev_csbf = right | (below << 1);
    int first_in_sb = lg2 == 2 ? 0 : sb << 4;
    int start = sb == last_sub ? last_scan : first_in_sb + 15;

    int sig_pos[16];
    int n_sig = 0;
    int n_coded_sig = 0;
    for (int k = start; k >= first_in_sb; --k) {
      int x, y;
      coef_xy(k, &x, &y);
      int in_sb = lg2 == 2 ? k : k & 15;
      int sig;
      if (k == last_scan) {
        sig = 1;
      } else if (in_sb == 0 && infer_dc_sig && n_coded_sig == 0 && sb > 0) {
        sig = 1;
      } else {
        sig = dec.decode(
            rc.sig[sig_ctx_inc(x, y, lg2, c_idx, prev_csbf, scan_idx)]);
        if (sig) ++n_coded_sig;
      }
      if (sig) sig_pos[n_sig++] = k;
    }

    int ctx_set = (sb > 0 && c_idx == 0) ? 2 : 0;
    if (gt1_ctx_prev_set == 0) ++ctx_set;
    int c1 = 1;
    int n_gt1 = n_sig < 8 ? n_sig : 8;
    int first_gt1_idx = -1;
    int abs_lv[16];
    for (int i = 0; i < n_sig; ++i) abs_lv[i] = 1;
    for (int i = 0; i < n_gt1; ++i) {
      int ctx = (c_idx ? 16 : 0) + ctx_set * 4 + c1;
      int gt1 = dec.decode(rc.gt1[ctx]);
      if (gt1) {
        abs_lv[i] = 2;
        c1 = 0;
        if (first_gt1_idx < 0) first_gt1_idx = i;
      } else if (c1 < 3 && c1 > 0) {
        ++c1;
      }
    }
    gt1_ctx_prev_set = c1;
    if (first_gt1_idx >= 0) {
      if (dec.decode(rc.gt2[(c_idx ? 4 : 0) + ctx_set]))
        abs_lv[first_gt1_idx] = 3;
    }
    int neg[16];
    for (int i = 0; i < n_sig; ++i) neg[i] = dec.bypass();
    int rice = 0;
    for (int i = 0; i < n_sig; ++i) {
      int base = 1;
      if (i < n_gt1) {
        base = 2;
        if (i == first_gt1_idx) base = 3;
      }
      if (abs_lv[i] >= base) {
        int rem = decode_remaining(dec, rice);
        abs_lv[i] = base + rem;
        if (abs_lv[i] > (3 << rice) && rice < 4) ++rice;
      }
      if (dec.overrun()) return 3;
      int x, y;
      coef_xy(sig_pos[i], &x, &y);
      coeffs[y * size + x] = neg[i] ? -abs_lv[i] : abs_lv[i];
    }
  }
  return dec.overrun() ? 3 : 0;
}

// ---------------------------------------------------------------------------
// Spec-syntax slice layer (7.3.6.1 slice_segment_header + 7.3.8.4
// coding_quadtree + 7.3.8.5 coding_unit + 7.3.8.8/7.3.8.10 transform
// tree/unit around the residual_coding above).
//
// Model: one monochrome (chroma_format_idc = 0, spec 4:0:0) IDR_W_RADL
// slice per plane.  The virtual SPS/PPS the header references has
// every optional tool off (no SAO syntax, no cu_qp_delta, no sign
// hiding, no transform split below the CU) and
//   CtbLog2SizeY  = lg2 + 1      (CTB = 2N x 2N)
//   MinCbLog2SizeY = MaxTbLog2 = lg2
// so the coding_quadtree has exactly one level: every in-picture CTB
// codes split_cu_flag = 1 (its spec 9.3.4.2.2 neighbor-depth context),
// partial CTBs split implicitly (the flag is absent when the CU
// overflows the picture, the spec rule), and each quadrant is one
// coding_unit of the framework's block size.  Every CU then codes
//   part_mode              (1 ctx bin, PART_2Nx2N; coded because
//                           log2CbSize == MinCbLog2SizeY)
//   prev_intra_luma_pred_flag + mpm_idx / rem_intra_luma_pred_mode
//                          (spec 8.4.2.2 candModeList from the left/
//                           above CUs, above forced DC across CTB rows;
//                           mpm_idx and rem are BYPASS bins per spec)
//   cbf_luma               (ctxInc 1: trafoDepth == 0)
//   residual_coding        (7.3.8.11 above) with scanIdx derived from
//                          the coded intra mode per 7.4.9.11
// and terminates with end_of_slice_segment_flag per CTU.  This closes
// the "full CTU quadtree is not emitted" scope note at the top of this
// file; SPS/PPS framing stays framework-defined.
// ---------------------------------------------------------------------------

// initValues, initType 0 (I slices): split_cu_flag Table 9-19,
// part_mode / prev_intra_luma_pred_flag Tables 9-20/9-21, cbf_luma
// pair (ctxInc 0/1) Table 9-23.
const uint8_t kInitSplitCu[3] = {139, 141, 157};
const uint8_t kInitPartMode = 184;
const uint8_t kInitPrevIntra = 184;
const uint8_t kInitCbfLumaPair[2] = {111, 141};
// intra_chroma_pred_mode first (context-coded) bin, initType 0.
const uint8_t kInitChromaPred = 63;

struct SliceCtxs {
  Ctx split_cu[3];
  Ctx part_mode;
  Ctx prev_intra;
  Ctx chroma_pred;
  Ctx cbf_luma[2];
  ResidualCtxs res;

  void init(int qp) {
    for (int i = 0; i < 3; ++i) split_cu[i].init(kInitSplitCu[i], qp);
    part_mode.init(kInitPartMode, qp);
    prev_intra.init(kInitPrevIntra, qp);
    chroma_pred.init(kInitChromaPred, qp);
    for (int i = 0; i < 2; ++i) cbf_luma[i].init(kInitCbfLumaPair[i], qp);
    res.init(qp);
  }
};

// candModeList per spec 8.4.2.2 (same algebra as the framework mode
// coder in nanohevc_runtime.cpp, kept local to this translation unit).
inline void slice_mpm_list(int32_t a, int32_t b, int32_t* m) {
  if (a == b) {
    if (a < 2) {
      m[0] = 0; m[1] = 1; m[2] = 26;
    } else {
      m[0] = a;
      m[1] = 2 + ((a + 29) % 32);
      m[2] = 2 + ((a - 2 + 1) % 32);
    }
  } else {
    m[0] = a; m[1] = b;
    if (a != 0 && b != 0) m[2] = 0;
    else m[2] = (a + b) < 2 ? 26 : 1;
  }
}

inline void sort3i(int32_t* s) {
  if (s[0] > s[1]) std::swap(s[0], s[1]);
  if (s[1] > s[2]) std::swap(s[1], s[2]);
  if (s[0] > s[1]) std::swap(s[0], s[1]);
}

// scanIdx per spec 7.4.9.11: mode-dependent at 4x4/8x8 intra.
inline int spec_scan_idx(int lg2, int mode) {
  if (lg2 != 2 && lg2 != 3) return 0;
  if (mode >= 6 && mode <= 14) return 2;    // near-horizontal -> vertical
  if (mode >= 22 && mode <= 30) return 1;   // near-vertical -> horizontal
  return 0;
}

// Plain MSB-first bit IO for the slice_segment_header (the CABAC
// payload starts byte-aligned right after byte_alignment()).
struct HdrWriter {
  std::vector<uint8_t>* out;
  int nbits = 0;
  void put(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) {
      if ((nbits & 7) == 0) out->push_back(0);
      out->back() |= static_cast<uint8_t>(((v >> i) & 1) << (7 - (nbits & 7)));
      ++nbits;
    }
  }
  void ue(uint32_t v) {
    uint32_t vp1 = v + 1;
    int len = 0;
    for (uint32_t t = vp1; t > 1; t >>= 1) ++len;
    put(0, len);
    put(vp1, len + 1);
  }
  void se(int32_t v) {
    ue(v <= 0 ? static_cast<uint32_t>(-2 * v) : static_cast<uint32_t>(2 * v - 1));
  }
  void byte_align() {           // byte_alignment(): 1 then zeros
    put(1, 1);
    while (nbits & 7) put(0, 1);
  }
};

struct HdrReader {
  const uint8_t* data;
  size_t nbytes;
  size_t pos = 0;               // bit position
  bool fail = false;
  uint32_t bit() {
    if ((pos >> 3) >= nbytes) { fail = true; return 0; }
    uint32_t b = (data[pos >> 3] >> (7 - (pos & 7))) & 1;
    ++pos;
    return b;
  }
  uint32_t bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | bit();
    return v;
  }
  uint32_t ue() {
    int zeros = 0;
    while (!fail && bit() == 0) {
      if (++zeros > 32) { fail = true; return 0; }
    }
    uint32_t v = 1;
    for (int i = 0; i < zeros; ++i) v = (v << 1) | bit();
    return v - 1;
  }
  int32_t se() {
    uint32_t u = ue();
    return (u & 1) ? static_cast<int32_t>((u + 1) >> 1)
                   : -static_cast<int32_t>(u >> 1);
  }
  bool byte_align() {
    if (bit() != 1) return false;
    while (pos & 7)
      if (bit() != 0) return false;
    return !fail;
  }
};

// One coding_unit: intra mode syntax + transform_unit.  modes/coeffs
// indexed on the (nby, nbx) CU grid in raster order.
void encode_cu(CabacEncoder& enc, SliceCtxs& cx, const int32_t* coeffs,
               const int32_t* modes, int64_t nbx, int64_t cy, int64_t cx_,
               int lg2, int ncoef) {
  int64_t i = cy * nbx + cx_;
  int32_t mode = modes[i];
  // part_mode: log2CbSize == MinCbLog2SizeY -> coded; PART_2Nx2N = 1
  enc.encode(cx.part_mode, 1);
  // prev_intra_luma_pred_flag + mpm_idx / rem (8.4.2.2): left CU in
  // the same picture; above CU additionally forced DC across CTB rows
  // (yNbB must be inside the current CTB, spec 8.4.2.2 availability).
  int32_t a = cx_ > 0 ? modes[i - 1] : 1;
  int32_t b = (cy > 0 && (cy & 1)) ? modes[i - nbx] : 1;  // CTB = 2 CU rows
  int32_t m[3];
  slice_mpm_list(a, b, m);
  int idx = mode == m[0] ? 0 : mode == m[1] ? 1 : mode == m[2] ? 2 : -1;
  enc.encode(cx.prev_intra, idx >= 0);
  if (idx >= 0) {
    enc.bypass(idx > 0);                         // mpm_idx: TU, bypass
    if (idx > 0) enc.bypass(idx - 1);
  } else {
    int32_t s[3] = {m[0], m[1], m[2]};
    sort3i(s);
    int32_t rem = mode;
    for (int k = 2; k >= 0; --k)
      if (mode > s[k]) --rem;
    enc.bypass_bits(static_cast<uint32_t>(rem), 5);
  }
  // transform_tree at depth 0 (no split: MaxTbLog2 == log2CbSize):
  // cbf_luma ctxInc 1, then residual_coding with the spec scanIdx.
  const int32_t* blk = coeffs + i * ncoef;
  int any = 0;
  for (int k = 0; k < ncoef; ++k)
    if (blk[k]) { any = 1; break; }
  enc.encode(cx.cbf_luma[1], any);
  if (any)
    residual_encode(enc, cx.res, blk, lg2, 0, spec_scan_idx(lg2, mode));
}

int decode_cu(CabacDecoder& dec, SliceCtxs& cx, int32_t* coeffs,
              int32_t* modes, int64_t nbx, int64_t cy, int64_t cx_,
              int lg2, int ncoef) {
  int64_t i = cy * nbx + cx_;
  if (!dec.decode(cx.part_mode)) return 5;      // only PART_2Nx2N valid
  int32_t a = cx_ > 0 ? modes[i - 1] : 1;
  int32_t b = (cy > 0 && (cy & 1)) ? modes[i - nbx] : 1;
  int32_t m[3];
  slice_mpm_list(a, b, m);
  int32_t mode;
  if (dec.decode(cx.prev_intra)) {
    int idx = 0;
    if (dec.bypass()) idx = 1 + dec.bypass();
    mode = m[idx];
  } else {
    int32_t rem = static_cast<int32_t>(dec.bypass_bits(5));
    int32_t s[3] = {m[0], m[1], m[2]};
    sort3i(s);
    mode = rem;
    for (int k = 0; k < 3; ++k)
      if (mode >= s[k]) ++mode;
    if (mode > 34) return 5;
  }
  modes[i] = mode;
  int32_t* blk = coeffs + i * ncoef;
  if (dec.decode(cx.cbf_luma[1])) {
    int rcio = residual_decode(dec, cx.res, blk, lg2, 0,
                               spec_scan_idx(lg2, mode));
    if (rcio) return rcio;
  } else {
    std::memset(blk, 0, sizeof(int32_t) * ncoef);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// 4:2:0 coding_unit (chroma_format_idc = 1): the luma syntax above plus
// intra_chroma_pred_mode (9.3.3.8 binarization, Table 8-3 candidate
// substitution) and the Cb/Cr transform units (7.3.8.8: cbf_cb/cbf_cr
// at trafoDepth 0 before cbf_luma; 7.3.8.10: chroma residual_coding
// after luma, log2TrafoSizeC = lg2 - 1).  One chroma mode covers both
// chroma components — the spec's own constraint — so the caller must
// provide Cb/Cr planes coded with a SHARED per-CU mode.
// ---------------------------------------------------------------------------

// 8.4.3: candModeListC = {planar, ver, hor, dc}, entries equal to the
// luma mode replaced by angular-34.
inline void chroma_cand_list(int32_t luma_mode, int32_t* c) {
  c[0] = 0; c[1] = 26; c[2] = 10; c[3] = 1;
  for (int i = 0; i < 4; ++i)
    if (c[i] == luma_mode) c[i] = 34;
}

// intra_chroma_pred_mode value for (luma, chroma) or -1 if the pair is
// not representable in the spec syntax.
inline int chroma_pred_value(int32_t luma_mode, int32_t chroma_mode) {
  if (chroma_mode == luma_mode) return 4;       // DM_CHROMA
  int32_t c[4];
  chroma_cand_list(luma_mode, c);
  for (int i = 0; i < 4; ++i)
    if (c[i] == chroma_mode) return i;
  return -1;
}

// chroma scanIdx (7.4.9.11): mode-dependent only at log2TrafoSizeC == 2
// when ChromaArrayType != 3 (4:2:0 here).
inline int chroma_scan_idx(int lg2c, int mode_c) {
  return lg2c == 2 ? spec_scan_idx(2, mode_c) : 0;
}

int encode_cu420(CabacEncoder& enc, SliceCtxs& cx, const int32_t* coeffs_y,
                 const int32_t* modes_y, const int32_t* coeffs_cb,
                 const int32_t* coeffs_cr, const int32_t* modes_c,
                 int64_t nbx, int64_t cy, int64_t cx_, int lg2) {
  int64_t i = cy * nbx + cx_;
  int ncoef = (1 << lg2) * (1 << lg2);
  int lg2c = lg2 - 1;
  int ncoef_c = (1 << lg2c) * (1 << lg2c);
  int32_t mode = modes_y[i];
  enc.encode(cx.part_mode, 1);                   // PART_2Nx2N
  int32_t a = cx_ > 0 ? modes_y[i - 1] : 1;
  int32_t b = (cy > 0 && (cy & 1)) ? modes_y[i - nbx] : 1;
  int32_t m[3];
  slice_mpm_list(a, b, m);
  int idx = mode == m[0] ? 0 : mode == m[1] ? 1 : mode == m[2] ? 2 : -1;
  enc.encode(cx.prev_intra, idx >= 0);
  if (idx >= 0) {
    enc.bypass(idx > 0);
    if (idx > 0) enc.bypass(idx - 1);
  } else {
    int32_t s[3] = {m[0], m[1], m[2]};
    sort3i(s);
    int32_t rem = mode;
    for (int k = 2; k >= 0; --k)
      if (mode > s[k]) --rem;
    enc.bypass_bits(static_cast<uint32_t>(rem), 5);
  }
  // intra_chroma_pred_mode (9.3.3.8): ctx bin 0 -> DM; else 2 FL bins.
  int cpv = chroma_pred_value(mode, modes_c[i]);
  if (cpv < 0) return -3;
  enc.encode(cx.chroma_pred, cpv != 4);
  if (cpv != 4) enc.bypass_bits(static_cast<uint32_t>(cpv), 2);
  // transform_tree depth 0: cbf_cb, cbf_cr (ctxInc = trafoDepth = 0,
  // shared chroma models), then cbf_luma (ctxInc 1).
  const int32_t* blk_y = coeffs_y + i * ncoef;
  const int32_t* blk_cb = coeffs_cb + i * ncoef_c;
  const int32_t* blk_cr = coeffs_cr + i * ncoef_c;
  int any_y = 0, any_cb = 0, any_cr = 0;
  for (int k = 0; k < ncoef; ++k)
    if (blk_y[k]) { any_y = 1; break; }
  for (int k = 0; k < ncoef_c; ++k)
    if (blk_cb[k]) { any_cb = 1; break; }
  for (int k = 0; k < ncoef_c; ++k)
    if (blk_cr[k]) { any_cr = 1; break; }
  enc.encode(cx.res.cbf_chroma, any_cb);
  enc.encode(cx.res.cbf_chroma, any_cr);
  enc.encode(cx.cbf_luma[1], any_y);
  // transform_unit: luma residual, then Cb, then Cr (7.3.8.10)
  if (any_y)
    residual_encode(enc, cx.res, blk_y, lg2, 0, spec_scan_idx(lg2, mode));
  int cscan = chroma_scan_idx(lg2c, modes_c[i]);
  if (any_cb) residual_encode(enc, cx.res, blk_cb, lg2c, 1, cscan);
  if (any_cr) residual_encode(enc, cx.res, blk_cr, lg2c, 2, cscan);
  return 0;
}

int decode_cu420(CabacDecoder& dec, SliceCtxs& cx, int32_t* coeffs_y,
                 int32_t* modes_y, int32_t* coeffs_cb, int32_t* coeffs_cr,
                 int32_t* modes_c, int64_t nbx, int64_t cy, int64_t cx_,
                 int lg2) {
  int64_t i = cy * nbx + cx_;
  int ncoef = (1 << lg2) * (1 << lg2);
  int lg2c = lg2 - 1;
  int ncoef_c = (1 << lg2c) * (1 << lg2c);
  if (!dec.decode(cx.part_mode)) return 5;
  int32_t a = cx_ > 0 ? modes_y[i - 1] : 1;
  int32_t b = (cy > 0 && (cy & 1)) ? modes_y[i - nbx] : 1;
  int32_t m[3];
  slice_mpm_list(a, b, m);
  int32_t mode;
  if (dec.decode(cx.prev_intra)) {
    int idx = 0;
    if (dec.bypass()) idx = 1 + dec.bypass();
    mode = m[idx];
  } else {
    int32_t rem = static_cast<int32_t>(dec.bypass_bits(5));
    int32_t s[3] = {m[0], m[1], m[2]};
    sort3i(s);
    mode = rem;
    for (int k = 0; k < 3; ++k)
      if (mode >= s[k]) ++mode;
    if (mode > 34) return 5;
  }
  modes_y[i] = mode;
  int32_t mode_c;
  if (dec.decode(cx.chroma_pred)) {
    int32_t c[4];
    chroma_cand_list(mode, c);
    mode_c = c[dec.bypass_bits(2)];
  } else {
    mode_c = mode;                               // DM_CHROMA
  }
  modes_c[i] = mode_c;
  int any_cb = dec.decode(cx.res.cbf_chroma);
  int any_cr = dec.decode(cx.res.cbf_chroma);
  int any_y = dec.decode(cx.cbf_luma[1]);
  int32_t* blk_y = coeffs_y + i * ncoef;
  int32_t* blk_cb = coeffs_cb + i * ncoef_c;
  int32_t* blk_cr = coeffs_cr + i * ncoef_c;
  if (any_y) {
    int rcio = residual_decode(dec, cx.res, blk_y, lg2, 0,
                               spec_scan_idx(lg2, mode));
    if (rcio) return rcio;
  } else {
    std::memset(blk_y, 0, sizeof(int32_t) * ncoef);
  }
  int cscan = chroma_scan_idx(lg2c, mode_c);
  if (any_cb) {
    int rcio = residual_decode(dec, cx.res, blk_cb, lg2c, 1, cscan);
    if (rcio) return rcio;
  } else {
    std::memset(blk_cb, 0, sizeof(int32_t) * ncoef_c);
  }
  if (any_cr) {
    int rcio = residual_decode(dec, cx.res, blk_cr, lg2c, 2, cscan);
    if (rcio) return rcio;
  } else {
    std::memset(blk_cr, 0, sizeof(int32_t) * ncoef_c);
  }
  return 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Spec-syntax slice: slice_segment_header + fixed-depth quadtree
// slice_segment_data over an (nby, nbx) grid of N x N CUs (N = 1<<lg2,
// CTB = 2N).  coeffs: raster-in-block, block raster order; modes: one
// intra mode per CU.  qp seeds contexts and is written as
// slice_qp_delta against a PPS init QP of 26.  Returns payload bytes
// or -1 (cap) / -2 (bad args).
int64_t nhc_encode_slice(const int32_t* coeffs, const int32_t* modes,
                         int64_t nby, int64_t nbx, int32_t lg2, int32_t qp,
                         uint8_t* out, int64_t cap) {
  if (lg2 < 2 || lg2 > 5 || nby <= 0 || nbx <= 0) return -2;
  for (int64_t i = 0; i < nby * nbx; ++i)
    if (modes[i] < 0 || modes[i] > 34) return -2;
  int ncoef = (1 << lg2) * (1 << lg2);
  std::vector<uint8_t> buf;
  buf.reserve(static_cast<size_t>(nby) * nbx * 8 + 64);

  // slice_segment_header (7.3.6.1, IDR_W_RADL, everything optional off)
  HdrWriter hw{&buf};
  hw.put(1, 1);                 // first_slice_segment_in_pic_flag
  hw.put(0, 1);                 // no_output_of_prior_pics_flag
  hw.ue(0);                     // slice_pic_parameter_set_id
  hw.ue(2);                     // slice_type = I
  hw.se(qp - 26);               // slice_qp_delta (PPS init_qp = 26)
  hw.byte_align();              // byte_alignment() -> CABAC starts

  SliceCtxs cx;
  cx.init(qp);
  CabacEncoder enc(&buf);
  int64_t ctb_rows = (nby + 1) >> 1, ctb_cols = (nbx + 1) >> 1;
  int64_t n_ctu = ctb_rows * ctb_cols;
  for (int64_t t = 0; t < n_ctu; ++t) {
    int64_t ty = t / ctb_cols, tx = t % ctb_cols;
    // coding_quadtree at depth 0: split_cu_flag coded only when the
    // full CTB lies inside the picture; partial CTBs split implicitly.
    bool inside = (2 * ty + 2 <= nby) && (2 * tx + 2 <= nbx);
    if (inside) {
      // 9.3.4.2.2 ctxInc: +1 per available neighbor CU with greater
      // cqtDepth — every coded CU here has depth 1 > 0, so ctxInc is
      // simply the neighbor-availability count.
      int ctx = (tx > 0 ? 1 : 0) + (ty > 0 ? 1 : 0);
      enc.encode(cx.split_cu[ctx], 1);
    }
    // z-order quadrants, skipping out-of-picture CUs (implicit rule)
    const int64_t qy[4] = {0, 0, 1, 1}, qx[4] = {0, 1, 0, 1};
    for (int q = 0; q < 4; ++q) {
      int64_t cy = 2 * ty + qy[q], cxx = 2 * tx + qx[q];
      if (cy >= nby || cxx >= nbx) continue;
      encode_cu(enc, cx, coeffs, modes, nbx, cy, cxx, lg2, ncoef);
    }
    enc.terminate(t + 1 == n_ctu ? 1 : 0);  // end_of_slice_segment_flag
  }
  enc.finish();
  if (static_cast<int64_t>(buf.size()) > cap) return -1;
  std::memcpy(out, buf.data(), buf.size());
  return static_cast<int64_t>(buf.size());
}

// Decode a spec-syntax slice.  Returns 0 ok, >0 corrupt; *qp_out gets
// 26 + slice_qp_delta (the caller cross-checks its PPS QP).
int32_t nhc_decode_slice(const uint8_t* data, int64_t nbytes, int64_t nby,
                         int64_t nbx, int32_t lg2, int32_t* coeffs_out,
                         int32_t* modes_out, int32_t* qp_out) {
  if (lg2 < 2 || lg2 > 5 || nby <= 0 || nbx <= 0) return 2;
  int ncoef = (1 << lg2) * (1 << lg2);

  HdrReader hr{data, static_cast<size_t>(nbytes)};
  if (hr.bit() != 1) return 6;                  // first_slice flag
  hr.bit();                                     // no_output_of_prior_pics
  if (hr.ue() != 0) return 6;                   // pps id
  if (hr.ue() != 2) return 6;                   // slice_type must be I
  int32_t qp = 26 + hr.se();
  if (hr.fail || qp < 0 || qp > 51) return 6;
  if (!hr.byte_align()) return 6;
  *qp_out = qp;

  SliceCtxs cx;
  cx.init(qp);
  size_t off = hr.pos >> 3;
  CabacDecoder dec(data + off, static_cast<size_t>(nbytes) - off);
  int64_t ctb_rows = (nby + 1) >> 1, ctb_cols = (nbx + 1) >> 1;
  int64_t n_ctu = ctb_rows * ctb_cols;
  for (int64_t t = 0; t < n_ctu; ++t) {
    int64_t ty = t / ctb_cols, tx = t % ctb_cols;
    bool inside = (2 * ty + 2 <= nby) && (2 * tx + 2 <= nbx);
    if (inside) {
      int ctx = (tx > 0 ? 1 : 0) + (ty > 0 ? 1 : 0);
      if (!dec.decode(cx.split_cu[ctx])) return 5;   // depth-1 grid only
    }
    const int64_t qy[4] = {0, 0, 1, 1}, qx[4] = {0, 1, 0, 1};
    for (int q = 0; q < 4; ++q) {
      int64_t cy = 2 * ty + qy[q], cxx = 2 * tx + qx[q];
      if (cy >= nby || cxx >= nbx) continue;
      int rcio = decode_cu(dec, cx, coeffs_out, modes_out, nbx, cy, cxx,
                           lg2, ncoef);
      if (rcio) return rcio;
      if (dec.overrun()) return 3;
    }
    int term = dec.terminate();
    if (term != (t + 1 == n_ctu ? 1 : 0)) return 4;
  }
  return dec.overrun() ? 3 : 0;
}

// 4:2:0 spec-syntax slice: like nhc_encode_slice plus the Cb/Cr
// transform units and intra_chroma_pred_mode per CU.  coeffs_cb/cr:
// (nby*nbx, N/2, N/2) raster blocks on the SAME CU grid; modes_c: the
// shared per-CU chroma mode (the spec codes one mode for both chroma
// components).  Returns payload bytes, -1 (cap), -2 (bad args), or
// -3 (a chroma mode is not representable: it is neither the CU's luma
// mode (DM) nor in the substituted {planar, ver, hor, dc} list).
int64_t nhc_encode_slice420(const int32_t* coeffs_y, const int32_t* modes_y,
                            const int32_t* coeffs_cb,
                            const int32_t* coeffs_cr, const int32_t* modes_c,
                            int64_t nby, int64_t nbx, int32_t lg2,
                            int32_t qp, uint8_t* out, int64_t cap) {
  // lg2 >= 3: chroma TB = N/2 >= 4 (log2TrafoSizeC >= 2, spec floor)
  if (lg2 < 3 || lg2 > 5 || nby <= 0 || nbx <= 0) return -2;
  for (int64_t i = 0; i < nby * nbx; ++i) {
    if (modes_y[i] < 0 || modes_y[i] > 34) return -2;
    if (modes_c[i] < 0 || modes_c[i] > 34) return -2;
    if (chroma_pred_value(modes_y[i], modes_c[i]) < 0) return -3;
  }
  std::vector<uint8_t> buf;
  buf.reserve(static_cast<size_t>(nby) * nbx * 12 + 64);

  HdrWriter hw{&buf};
  hw.put(1, 1);                 // first_slice_segment_in_pic_flag
  hw.put(0, 1);                 // no_output_of_prior_pics_flag
  hw.ue(0);                     // slice_pic_parameter_set_id
  hw.ue(2);                     // slice_type = I
  hw.se(qp - 26);               // slice_qp_delta
  hw.byte_align();

  SliceCtxs cx;
  cx.init(qp);
  CabacEncoder enc(&buf);
  int64_t ctb_rows = (nby + 1) >> 1, ctb_cols = (nbx + 1) >> 1;
  int64_t n_ctu = ctb_rows * ctb_cols;
  for (int64_t t = 0; t < n_ctu; ++t) {
    int64_t ty = t / ctb_cols, tx = t % ctb_cols;
    bool inside = (2 * ty + 2 <= nby) && (2 * tx + 2 <= nbx);
    if (inside) {
      int ctx = (tx > 0 ? 1 : 0) + (ty > 0 ? 1 : 0);
      enc.encode(cx.split_cu[ctx], 1);
    }
    const int64_t qy[4] = {0, 0, 1, 1}, qx[4] = {0, 1, 0, 1};
    for (int q = 0; q < 4; ++q) {
      int64_t cy = 2 * ty + qy[q], cxx = 2 * tx + qx[q];
      if (cy >= nby || cxx >= nbx) continue;
      int rc = encode_cu420(enc, cx, coeffs_y, modes_y, coeffs_cb,
                            coeffs_cr, modes_c, nbx, cy, cxx, lg2);
      if (rc) return rc;
    }
    enc.terminate(t + 1 == n_ctu ? 1 : 0);
  }
  enc.finish();
  if (static_cast<int64_t>(buf.size()) > cap) return -1;
  std::memcpy(out, buf.data(), buf.size());
  return static_cast<int64_t>(buf.size());
}

// Decode a 4:2:0 spec-syntax slice.  Returns 0 ok, >0 corrupt.
int32_t nhc_decode_slice420(const uint8_t* data, int64_t nbytes, int64_t nby,
                            int64_t nbx, int32_t lg2, int32_t* coeffs_y,
                            int32_t* modes_y, int32_t* coeffs_cb,
                            int32_t* coeffs_cr, int32_t* modes_c,
                            int32_t* qp_out) {
  if (lg2 < 3 || lg2 > 5 || nby <= 0 || nbx <= 0) return 2;

  HdrReader hr{data, static_cast<size_t>(nbytes)};
  if (hr.bit() != 1) return 6;
  hr.bit();
  if (hr.ue() != 0) return 6;
  if (hr.ue() != 2) return 6;
  int32_t qp = 26 + hr.se();
  if (hr.fail || qp < 0 || qp > 51) return 6;
  if (!hr.byte_align()) return 6;
  *qp_out = qp;

  SliceCtxs cx;
  cx.init(qp);
  size_t off = hr.pos >> 3;
  CabacDecoder dec(data + off, static_cast<size_t>(nbytes) - off);
  int64_t ctb_rows = (nby + 1) >> 1, ctb_cols = (nbx + 1) >> 1;
  int64_t n_ctu = ctb_rows * ctb_cols;
  for (int64_t t = 0; t < n_ctu; ++t) {
    int64_t ty = t / ctb_cols, tx = t % ctb_cols;
    bool inside = (2 * ty + 2 <= nby) && (2 * tx + 2 <= nbx);
    if (inside) {
      int ctx = (tx > 0 ? 1 : 0) + (ty > 0 ? 1 : 0);
      if (!dec.decode(cx.split_cu[ctx])) return 5;
    }
    const int64_t qy[4] = {0, 0, 1, 1}, qx[4] = {0, 1, 0, 1};
    for (int q = 0; q < 4; ++q) {
      int64_t cy = 2 * ty + qy[q], cxx = 2 * tx + qx[q];
      if (cy >= nby || cxx >= nbx) continue;
      int rcio = decode_cu420(dec, cx, coeffs_y, modes_y, coeffs_cb,
                              coeffs_cr, modes_c, nbx, cy, cxx, lg2);
      if (rcio) return rcio;
      if (dec.overrun()) return 3;
    }
    int term = dec.terminate();
    if (term != (t + 1 == n_ctu ? 1 : 0)) return 4;
  }
  return dec.overrun() ? 3 : 0;
}

// Encode nb transform blocks (raster layout inside each block) with
// the spec engine.  scan_idx: per-block 0/1/2.  Returns payload size,
// or -1 if cap is too small.  qp seeds the context initialization.
int64_t nhc_encode_plane(const int32_t* coeffs, int64_t nb, int32_t lg2,
                         int32_t c_idx, const uint8_t* scan_idx, int32_t qp,
                         uint8_t* out, int64_t cap) {
  if (lg2 < 2 || lg2 > 5 || nb < 0) return -2;
  int size = 1 << lg2;
  int ncoef = size * size;
  std::vector<uint8_t> buf;
  buf.reserve(static_cast<size_t>(nb) * 8 + 64);
  ResidualCtxs rc;
  rc.init(qp);
  CabacEncoder enc(&buf);
  for (int64_t b = 0; b < nb; ++b) {
    const int32_t* blk = coeffs + b * ncoef;
    int any = 0;
    for (int i = 0; i < ncoef; ++i)
      if (blk[i]) {
        any = 1;
        break;
      }
    Ctx& cbf = c_idx == 0 ? rc.cbf_luma : rc.cbf_chroma;
    enc.encode(cbf, any);
    if (any) residual_encode(enc, rc, blk, lg2, c_idx, scan_idx[b]);
    enc.terminate(b + 1 == nb ? 1 : 0);
  }
  if (nb == 0) {
    // empty plane: a single terminate so the stream is self-delimiting
    enc.terminate(1);
  }
  enc.finish();
  if (static_cast<int64_t>(buf.size()) > cap) return -1;
  std::memcpy(out, buf.data(), buf.size());
  return static_cast<int64_t>(buf.size());
}

// nhc_encode_plane on blocks in their combined scan order (scan_idx[b]'s
// spec 6.5.3 scan, by 4x4 sub-blocks above 4x4), the layout the frame
// encoder packs its levels in: the same payload as nhc_encode_plane of
// the blocks unpacked to raster, without the unpacking.
int64_t nhc_encode_plane_scan(const int32_t* coeffs, int64_t nb, int32_t lg2,
                              int32_t c_idx, const uint8_t* scan_idx,
                              int32_t qp, uint8_t* out, int64_t cap) {
  if (lg2 < 2 || lg2 > 5 || nb < 0) return -2;
  int ncoef = 1 << (2 * lg2);
  std::vector<uint8_t> buf;
  buf.reserve(static_cast<size_t>(nb) * 8 + 64);
  ResidualCtxs rc;
  rc.init(qp);
  CabacEncoder enc(&buf);
  Ctx& cbf = c_idx == 0 ? rc.cbf_luma : rc.cbf_chroma;
  for (int64_t b = 0; b < nb; ++b) {
    const int32_t* blk = coeffs + b * ncoef;
    int any = 0;
    for (int i = 0; i < ncoef; ++i)
      if (blk[i]) {
        any = 1;
        break;
      }
    enc.encode(cbf, any);
    if (any) residual_encode<true>(enc, rc, blk, lg2, c_idx, scan_idx[b]);
    enc.terminate(b + 1 == nb ? 1 : 0);
  }
  if (nb == 0) enc.terminate(1);
  enc.finish();
  if (static_cast<int64_t>(buf.size()) > cap) return -1;
  std::memcpy(out, buf.data(), buf.size());
  return static_cast<int64_t>(buf.size());
}

// Decode nb blocks; returns 0 ok, >0 corrupt.
int32_t nhc_decode_plane(const uint8_t* data, int64_t nbytes, int64_t nb,
                         int32_t lg2, int32_t c_idx, const uint8_t* scan_idx,
                         int32_t qp, int32_t* out) {
  if (lg2 < 2 || lg2 > 5 || nb < 0) return 2;
  int size = 1 << lg2;
  int ncoef = size * size;
  ResidualCtxs rc;
  rc.init(qp);
  CabacDecoder dec(data, static_cast<size_t>(nbytes));
  for (int64_t b = 0; b < nb; ++b) {
    int32_t* blk = out + b * ncoef;
    Ctx& cbf = c_idx == 0 ? rc.cbf_luma : rc.cbf_chroma;
    int any = dec.decode(cbf);
    if (any) {
      int rcio = residual_decode(dec, rc, blk, lg2, c_idx, scan_idx[b]);
      if (rcio) return rcio;
    } else {
      std::memset(blk, 0, sizeof(int32_t) * ncoef);
    }
    int term = dec.terminate();
    if (term != (b + 1 == nb ? 1 : 0)) return 4;
    if (dec.overrun()) return 3;
  }
  return 0;
}

int32_t nhc_version() { return 3; }

}  // extern "C"
