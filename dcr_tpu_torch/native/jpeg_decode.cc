// A JPEG decoder of the port's own: host C++, no libjpeg, no nvJPEG.
//
// Decodes what the paper's datasets hold (Imagenette, the LAION subsets):
// SOF0 baseline, SOF1 extended Huffman and SOF2 progressive (spectral
// selection and successive approximation), 8-bit samples, 1 or 3
// components, sampling factors up to 2x2 (4:4:4, 4:2:2, 4:2:0, 4:4:0),
// restart intervals, JFIF and Adobe APP14 (transform 0 = RGB, 1 = YCbCr).
// Everything else is refused: arithmetic coding (SOF9-11), lossless (SOF3),
// hierarchical (SOF5-7), 12-bit samples and 4-component CMYK/YCCK return
// status 1 (not supported); truncated or corrupt data returns status 2.
//
// The arithmetic follows libjpeg-turbo's defaults (what PIL and the JAX
// package's libjpeg helper compute), so the pixels can be equal:
// - dequantisation, then the islow integer IDCT (jidctint.c); at reduced
//   scales the scaled IDCTs of jidctred.c (1x1, 2x2, 4x4) and jidctint.c
//   (3x3, 5x5, 6x6, 7x7, and 10x10, 12x12, 14x14 for chroma scaled up);
// - the scale choices of jpeg_core_output_dimensions and
//   jpeg_calc_output_dimensions (jdmaster.c): output size ceil(W*M/8),
//   chroma scaled up in the IDCT where the factors allow it;
// - "fancy" triangle upsampling (jdsample.c h2v1, h2v2, h1v2) at scales
//   above 1/8, replication otherwise;
// - the fixed-point YCbCr->RGB tables of jdcolor.c.
//
// C ABI (bound with ctypes, which releases the GIL during the call):
//   jpeg_decode_scaled(data, size, min_side, out, out_capacity, &w, &h,
//                      err, err_len) -> 0 ok, 1 not supported, 2 corrupt,
//                                       3 out_capacity too small
// min_side <= 0 decodes at full scale; otherwise the scale M/8 is the
// smallest whose shorter side (rounded down) still covers min_side. The
// output size is set before status 3 is returned, so a caller can retry
// with a buffer of w * h * 3 bytes.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum Status { kOk = 0, kUnsupported = 1, kCorrupt = 2, kTooSmall = 3 };

// a frame larger than this is refused before its coefficients are allocated
const long kMaxPixels = 1L << 28;

struct DecodeError {
  int status;
  std::string message;
};

[[noreturn]] void unsupported(const std::string& what) {
  throw DecodeError{kUnsupported, what};
}
[[noreturn]] void corrupt(const std::string& what) {
  throw DecodeError{kCorrupt, what};
}

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ---------------------------------------------------------------------------
// range limiting and colour conversion (jdmaster.c, jdcolor.c)
// ---------------------------------------------------------------------------

struct Tables {
  uint8_t idct_limit[1024];  // post-IDCT: index (x & 1023), x before +128
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  Tables() {
    for (int t = 0; t < 1024; ++t) {
      int x = t < 512 ? t : t - 1024;  // the signed value the mask wrapped
      int v = x + 128;
      // libjpeg's table: x in [-512, 512) clamps; beyond it wraps the same way
      idct_limit[t] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
    const int kScale = 16;
    const int64_t half = int64_t(1) << (kScale - 1);
    auto fix = [&](double v) { return static_cast<int64_t>(v * (1 << kScale) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = static_cast<int>(-fix(0.71414) * x);
      cb_g[i] = static_cast<int>(-fix(0.34414) * x + half);
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---------------------------------------------------------------------------
// inverse DCTs (jidctint.c, jidctred.c). coef: 64 natural-order
// coefficients; q: the component's quantisation table, natural order.
// ---------------------------------------------------------------------------

typedef int64_t JLONG;
const int CONST_BITS = 13;
const int PASS1_BITS = 2;
#define ONE ((JLONG)1)
#define FIX(x) ((JLONG)((x) * (ONE << CONST_BITS) + 0.5))
#define MULTIPLY(v, c) ((v) * (c))
#define DEQ(i) ((JLONG)coef[i] * (JLONG)q[i])
#define RSHIFT(x, n) ((x) >> (n))
#define DESCALE(x, n) RSHIFT((x) + (ONE << ((n)-1)), n)
#define LSHIFT(x, n) ((JLONG)((uint64_t)(x) << (n)))

#define FIX_0_211164243 ((JLONG)1730)
#define FIX_0_298631336 ((JLONG)2446)
#define FIX_0_390180644 ((JLONG)3196)
#define FIX_0_509795579 ((JLONG)4176)
#define FIX_0_541196100 ((JLONG)4433)
#define FIX_0_601344887 ((JLONG)4926)
#define FIX_0_720959822 ((JLONG)5906)
#define FIX_0_765366865 ((JLONG)6270)
#define FIX_0_850430095 ((JLONG)6967)
#define FIX_0_899976223 ((JLONG)7373)
#define FIX_1_061594337 ((JLONG)8697)
#define FIX_1_175875602 ((JLONG)9633)
#define FIX_1_272758580 ((JLONG)10426)
#define FIX_1_451774981 ((JLONG)11893)
#define FIX_1_501321110 ((JLONG)12299)
#define FIX_1_847759065 ((JLONG)15137)
#define FIX_1_961570560 ((JLONG)16069)
#define FIX_2_053119869 ((JLONG)16819)
#define FIX_2_172734803 ((JLONG)17799)
#define FIX_2_562915447 ((JLONG)20995)
#define FIX_3_072711026 ((JLONG)25172)
#define FIX_3_624509785 ((JLONG)29692)

typedef void (*IdctFn)(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride);

#define OUT(v, shift) lim[(int)RSHIFT((v), (shift)) & 1023]
#define OUTD(v, shift) lim[(int)DESCALE((v), (shift)) & 1023]

// jpeg_idct_islow: the 8x8 LL&M integer IDCT of libjpeg 6b.
void idct_8x8(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  const uint8_t* lim = tables().idct_limit;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    if (coef[8 + c] == 0 && coef[16 + c] == 0 && coef[24 + c] == 0 && coef[32 + c] == 0 &&
        coef[40 + c] == 0 && coef[48 + c] == 0 && coef[56 + c] == 0) {
      int dc = (int)LSHIFT(DEQ(c), PASS1_BITS);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    JLONG z2 = DEQ(16 + c), z3 = DEQ(48 + c);
    JLONG z1 = MULTIPLY(z2 + z3, FIX_0_541196100);
    JLONG tmp2 = z1 + MULTIPLY(z3, -FIX_1_847759065);
    JLONG tmp3 = z1 + MULTIPLY(z2, FIX_0_765366865);
    z2 = DEQ(c);
    z3 = DEQ(32 + c);
    JLONG tmp0 = LSHIFT(z2 + z3, CONST_BITS);
    JLONG tmp1 = LSHIFT(z2 - z3, CONST_BITS);
    JLONG tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    JLONG tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = DEQ(56 + c);
    tmp1 = DEQ(40 + c);
    tmp2 = DEQ(24 + c);
    tmp3 = DEQ(8 + c);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    JLONG z4 = tmp1 + tmp3;
    JLONG z5 = MULTIPLY(z3 + z4, FIX_1_175875602);
    tmp0 = MULTIPLY(tmp0, FIX_0_298631336);
    tmp1 = MULTIPLY(tmp1, FIX_2_053119869);
    tmp2 = MULTIPLY(tmp2, FIX_3_072711026);
    tmp3 = MULTIPLY(tmp3, FIX_1_501321110);
    z1 = MULTIPLY(z1, -FIX_0_899976223);
    z2 = MULTIPLY(z2, -FIX_2_562915447);
    z3 = MULTIPLY(z3, -FIX_1_961570560);
    z4 = MULTIPLY(z4, -FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = CONST_BITS - PASS1_BITS;
    ws[0 * 8 + c] = (int)DESCALE(tmp10 + tmp3, s);
    ws[7 * 8 + c] = (int)DESCALE(tmp10 - tmp3, s);
    ws[1 * 8 + c] = (int)DESCALE(tmp11 + tmp2, s);
    ws[6 * 8 + c] = (int)DESCALE(tmp11 - tmp2, s);
    ws[2 * 8 + c] = (int)DESCALE(tmp12 + tmp1, s);
    ws[5 * 8 + c] = (int)DESCALE(tmp12 - tmp1, s);
    ws[3 * 8 + c] = (int)DESCALE(tmp13 + tmp0, s);
    ws[4 * 8 + c] = (int)DESCALE(tmp13 - tmp0, s);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      uint8_t v = OUTD((JLONG)w[0], PASS1_BITS + 3);
      for (int i = 0; i < 8; ++i) o[i] = v;
      continue;
    }
    JLONG z2 = w[2], z3 = w[6];
    JLONG z1 = MULTIPLY(z2 + z3, FIX_0_541196100);
    JLONG tmp2 = z1 + MULTIPLY(z3, -FIX_1_847759065);
    JLONG tmp3 = z1 + MULTIPLY(z2, FIX_0_765366865);
    JLONG tmp0 = LSHIFT((JLONG)w[0] + (JLONG)w[4], CONST_BITS);
    JLONG tmp1 = LSHIFT((JLONG)w[0] - (JLONG)w[4], CONST_BITS);
    JLONG tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    JLONG tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    JLONG z4 = tmp1 + tmp3;
    JLONG z5 = MULTIPLY(z3 + z4, FIX_1_175875602);
    tmp0 = MULTIPLY(tmp0, FIX_0_298631336);
    tmp1 = MULTIPLY(tmp1, FIX_2_053119869);
    tmp2 = MULTIPLY(tmp2, FIX_3_072711026);
    tmp3 = MULTIPLY(tmp3, FIX_1_501321110);
    z1 = MULTIPLY(z1, -FIX_0_899976223);
    z2 = MULTIPLY(z2, -FIX_2_562915447);
    z3 = MULTIPLY(z3, -FIX_1_961570560);
    z4 = MULTIPLY(z4, -FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = CONST_BITS + PASS1_BITS + 3;
    o[0] = OUTD(tmp10 + tmp3, s);
    o[7] = OUTD(tmp10 - tmp3, s);
    o[1] = OUTD(tmp11 + tmp2, s);
    o[6] = OUTD(tmp11 - tmp2, s);
    o[2] = OUTD(tmp12 + tmp1, s);
    o[5] = OUTD(tmp12 - tmp1, s);
    o[3] = OUTD(tmp13 + tmp0, s);
    o[4] = OUTD(tmp13 - tmp0, s);
  }
}

// jidctred.c jpeg_idct_4x4: averages of adjacent pairs of the 8-point IDCT.
void idct_4x4(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  const uint8_t* lim = tables().idct_limit;
  int ws[8 * 4];
  for (int c = 0; c < 8; ++c) {
    if (c == 4) continue;
    if (coef[8 + c] == 0 && coef[16 + c] == 0 && coef[24 + c] == 0 && coef[40 + c] == 0 &&
        coef[48 + c] == 0 && coef[56 + c] == 0) {
      int dc = (int)LSHIFT(DEQ(c), PASS1_BITS);
      for (int r = 0; r < 4; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    JLONG tmp0 = LSHIFT(DEQ(c), CONST_BITS + 1);
    JLONG z2 = DEQ(16 + c), z3 = DEQ(48 + c);
    JLONG tmp2 = MULTIPLY(z2, FIX_1_847759065) + MULTIPLY(z3, -FIX_0_765366865);
    JLONG tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    JLONG z1 = DEQ(56 + c);
    z2 = DEQ(40 + c);
    z3 = DEQ(24 + c);
    JLONG z4 = DEQ(8 + c);
    tmp0 = MULTIPLY(z1, -FIX_0_211164243) + MULTIPLY(z2, FIX_1_451774981) +
           MULTIPLY(z3, -FIX_2_172734803) + MULTIPLY(z4, FIX_1_061594337);
    tmp2 = MULTIPLY(z1, -FIX_0_509795579) + MULTIPLY(z2, -FIX_0_601344887) +
           MULTIPLY(z3, FIX_0_899976223) + MULTIPLY(z4, FIX_2_562915447);
    const int s = CONST_BITS - PASS1_BITS + 1;
    ws[0 * 8 + c] = (int)DESCALE(tmp10 + tmp2, s);
    ws[3 * 8 + c] = (int)DESCALE(tmp10 - tmp2, s);
    ws[1 * 8 + c] = (int)DESCALE(tmp12 + tmp0, s);
    ws[2 * 8 + c] = (int)DESCALE(tmp12 - tmp0, s);
  }
  for (int r = 0; r < 4; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[5] == 0 && w[6] == 0 && w[7] == 0) {
      uint8_t v = OUTD((JLONG)w[0], PASS1_BITS + 3);
      o[0] = o[1] = o[2] = o[3] = v;
      continue;
    }
    JLONG tmp0 = LSHIFT((JLONG)w[0], CONST_BITS + 1);
    JLONG tmp2 = MULTIPLY((JLONG)w[2], FIX_1_847759065) + MULTIPLY((JLONG)w[6], -FIX_0_765366865);
    JLONG tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    JLONG z1 = w[7], z2 = w[5], z3 = w[3], z4 = w[1];
    tmp0 = MULTIPLY(z1, -FIX_0_211164243) + MULTIPLY(z2, FIX_1_451774981) +
           MULTIPLY(z3, -FIX_2_172734803) + MULTIPLY(z4, FIX_1_061594337);
    tmp2 = MULTIPLY(z1, -FIX_0_509795579) + MULTIPLY(z2, -FIX_0_601344887) +
           MULTIPLY(z3, FIX_0_899976223) + MULTIPLY(z4, FIX_2_562915447);
    const int s = CONST_BITS + PASS1_BITS + 3 + 1;
    o[0] = OUTD(tmp10 + tmp2, s);
    o[3] = OUTD(tmp10 - tmp2, s);
    o[1] = OUTD(tmp12 + tmp0, s);
    o[2] = OUTD(tmp12 - tmp0, s);
  }
}

// jidctred.c jpeg_idct_2x2: averages of four outputs of the 8-point IDCT.
void idct_2x2(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  const uint8_t* lim = tables().idct_limit;
  int ws[8 * 2];
  for (int c = 0; c < 8; ++c) {
    if (c == 2 || c == 4 || c == 6) continue;
    if (coef[8 + c] == 0 && coef[24 + c] == 0 && coef[40 + c] == 0 && coef[56 + c] == 0) {
      int dc = (int)LSHIFT(DEQ(c), PASS1_BITS);
      ws[c] = ws[8 + c] = dc;
      continue;
    }
    JLONG tmp10 = LSHIFT(DEQ(c), CONST_BITS + 2);
    JLONG tmp0 = MULTIPLY(DEQ(56 + c), -FIX_0_720959822);
    tmp0 += MULTIPLY(DEQ(40 + c), FIX_0_850430095);
    tmp0 += MULTIPLY(DEQ(24 + c), -FIX_1_272758580);
    tmp0 += MULTIPLY(DEQ(8 + c), FIX_3_624509785);
    const int s = CONST_BITS - PASS1_BITS + 2;
    ws[c] = (int)DESCALE(tmp10 + tmp0, s);
    ws[8 + c] = (int)DESCALE(tmp10 - tmp0, s);
  }
  for (int r = 0; r < 2; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[3] == 0 && w[5] == 0 && w[7] == 0) {
      uint8_t v = OUTD((JLONG)w[0], PASS1_BITS + 3);
      o[0] = o[1] = v;
      continue;
    }
    JLONG tmp10 = LSHIFT((JLONG)w[0], CONST_BITS + 2);
    JLONG tmp0 = MULTIPLY((JLONG)w[7], -FIX_0_720959822) + MULTIPLY((JLONG)w[5], FIX_0_850430095) +
                 MULTIPLY((JLONG)w[3], -FIX_1_272758580) + MULTIPLY((JLONG)w[1], FIX_3_624509785);
    const int s = CONST_BITS + PASS1_BITS + 3 + 2;
    o[0] = OUTD(tmp10 + tmp0, s);
    o[1] = OUTD(tmp10 - tmp0, s);
  }
}

// jidctred.c jpeg_idct_1x1: the DC term alone.
void idct_1x1(const int16_t* coef, const uint16_t* q, uint8_t* out, int) {
  const uint8_t* lim = tables().idct_limit;
  out[0] = OUTD(DEQ(0), 3);
}

// jidctint.c jpeg_idct_3x3: 3-point kernel, cK = sqrt(2) * cos(K*pi/6).
void idct_3x3(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  const uint8_t* lim = tables().idct_limit;
  int ws[3 * 3];
  for (int c = 0; c < 3; ++c) {
    JLONG tmp0 = LSHIFT(DEQ(c), CONST_BITS) + (ONE << (CONST_BITS - PASS1_BITS - 1));
    JLONG tmp12 = MULTIPLY(DEQ(16 + c), FIX(0.707106781));
    JLONG tmp10 = tmp0 + tmp12;
    JLONG tmp2 = tmp0 - tmp12 - tmp12;
    tmp0 = MULTIPLY(DEQ(8 + c), FIX(1.224744871));
    const int s = CONST_BITS - PASS1_BITS;
    ws[3 * 0 + c] = (int)RSHIFT(tmp10 + tmp0, s);
    ws[3 * 2 + c] = (int)RSHIFT(tmp10 - tmp0, s);
    ws[3 * 1 + c] = (int)RSHIFT(tmp2, s);
  }
  for (int r = 0; r < 3; ++r) {
    const int* w = ws + r * 3;
    uint8_t* o = out + r * stride;
    JLONG tmp0 = LSHIFT((JLONG)w[0] + (ONE << (PASS1_BITS + 2)), CONST_BITS);
    JLONG tmp12 = MULTIPLY((JLONG)w[2], FIX(0.707106781));
    JLONG tmp10 = tmp0 + tmp12;
    JLONG tmp2 = tmp0 - tmp12 - tmp12;
    tmp0 = MULTIPLY((JLONG)w[1], FIX(1.224744871));
    const int s = CONST_BITS + PASS1_BITS + 3;
    o[0] = OUT(tmp10 + tmp0, s);
    o[2] = OUT(tmp10 - tmp0, s);
    o[1] = OUT(tmp2, s);
  }
}

// jidctint.c jpeg_idct_5x5: 5-point kernel, cK = sqrt(2) * cos(K*pi/10).
void idct_5x5(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  const uint8_t* lim = tables().idct_limit;
  int ws[5 * 5];
  for (int c = 0; c < 5; ++c) {
    JLONG tmp12 = LSHIFT(DEQ(c), CONST_BITS) + (ONE << (CONST_BITS - PASS1_BITS - 1));
    JLONG tmp0 = DEQ(16 + c), tmp1 = DEQ(32 + c);
    JLONG z1 = MULTIPLY(tmp0 + tmp1, FIX(0.790569415));
    JLONG z2 = MULTIPLY(tmp0 - tmp1, FIX(0.353553391));
    JLONG z3 = tmp12 + z2;
    JLONG tmp10 = z3 + z1, tmp11 = z3 - z1;
    tmp12 -= LSHIFT(z2, 2);
    z2 = DEQ(8 + c);
    z3 = DEQ(24 + c);
    z1 = MULTIPLY(z2 + z3, FIX(0.831253876));
    tmp0 = z1 + MULTIPLY(z2, FIX(0.513743148));
    tmp1 = z1 - MULTIPLY(z3, FIX(2.176250899));
    const int s = CONST_BITS - PASS1_BITS;
    ws[5 * 0 + c] = (int)RSHIFT(tmp10 + tmp0, s);
    ws[5 * 4 + c] = (int)RSHIFT(tmp10 - tmp0, s);
    ws[5 * 1 + c] = (int)RSHIFT(tmp11 + tmp1, s);
    ws[5 * 3 + c] = (int)RSHIFT(tmp11 - tmp1, s);
    ws[5 * 2 + c] = (int)RSHIFT(tmp12, s);
  }
  for (int r = 0; r < 5; ++r) {
    const int* w = ws + r * 5;
    uint8_t* o = out + r * stride;
    JLONG tmp12 = LSHIFT((JLONG)w[0] + (ONE << (PASS1_BITS + 2)), CONST_BITS);
    JLONG tmp0 = w[2], tmp1 = w[4];
    JLONG z1 = MULTIPLY(tmp0 + tmp1, FIX(0.790569415));
    JLONG z2 = MULTIPLY(tmp0 - tmp1, FIX(0.353553391));
    JLONG z3 = tmp12 + z2;
    JLONG tmp10 = z3 + z1, tmp11 = z3 - z1;
    tmp12 -= LSHIFT(z2, 2);
    z2 = w[1];
    z3 = w[3];
    z1 = MULTIPLY(z2 + z3, FIX(0.831253876));
    tmp0 = z1 + MULTIPLY(z2, FIX(0.513743148));
    tmp1 = z1 - MULTIPLY(z3, FIX(2.176250899));
    const int s = CONST_BITS + PASS1_BITS + 3;
    o[0] = OUT(tmp10 + tmp0, s);
    o[4] = OUT(tmp10 - tmp0, s);
    o[1] = OUT(tmp11 + tmp1, s);
    o[3] = OUT(tmp11 - tmp1, s);
    o[2] = OUT(tmp12, s);
  }
}

// jidctint.c jpeg_idct_6x6: 6-point kernel, cK = sqrt(2) * cos(K*pi/12).
void idct_6x6(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  const uint8_t* lim = tables().idct_limit;
  int ws[6 * 6];
  for (int c = 0; c < 6; ++c) {
    JLONG tmp0 = LSHIFT(DEQ(c), CONST_BITS) + (ONE << (CONST_BITS - PASS1_BITS - 1));
    JLONG tmp10 = MULTIPLY(DEQ(32 + c), FIX(0.707106781));
    JLONG tmp1 = tmp0 + tmp10;
    JLONG tmp11 = RSHIFT(tmp0 - tmp10 - tmp10, CONST_BITS - PASS1_BITS);
    tmp10 = DEQ(16 + c);
    tmp0 = MULTIPLY(tmp10, FIX(1.224744871));
    tmp10 = tmp1 + tmp0;
    JLONG tmp12 = tmp1 - tmp0;
    JLONG z1 = DEQ(8 + c), z2 = DEQ(24 + c), z3 = DEQ(40 + c);
    tmp1 = MULTIPLY(z1 + z3, FIX(0.366025404));
    tmp0 = tmp1 + LSHIFT(z1 + z2, CONST_BITS);
    JLONG tmp2 = tmp1 + LSHIFT(z3 - z2, CONST_BITS);
    tmp1 = LSHIFT(z1 - z2 - z3, PASS1_BITS);
    const int s = CONST_BITS - PASS1_BITS;
    ws[6 * 0 + c] = (int)RSHIFT(tmp10 + tmp0, s);
    ws[6 * 5 + c] = (int)RSHIFT(tmp10 - tmp0, s);
    ws[6 * 1 + c] = (int)(tmp11 + tmp1);
    ws[6 * 4 + c] = (int)(tmp11 - tmp1);
    ws[6 * 2 + c] = (int)RSHIFT(tmp12 + tmp2, s);
    ws[6 * 3 + c] = (int)RSHIFT(tmp12 - tmp2, s);
  }
  for (int r = 0; r < 6; ++r) {
    const int* w = ws + r * 6;
    uint8_t* o = out + r * stride;
    JLONG tmp0 = LSHIFT((JLONG)w[0] + (ONE << (PASS1_BITS + 2)), CONST_BITS);
    JLONG tmp10 = MULTIPLY((JLONG)w[4], FIX(0.707106781));
    JLONG tmp1 = tmp0 + tmp10;
    JLONG tmp11 = tmp0 - tmp10 - tmp10;
    tmp0 = MULTIPLY((JLONG)w[2], FIX(1.224744871));
    tmp10 = tmp1 + tmp0;
    JLONG tmp12 = tmp1 - tmp0;
    JLONG z1 = w[1], z2 = w[3], z3 = w[5];
    tmp1 = MULTIPLY(z1 + z3, FIX(0.366025404));
    tmp0 = tmp1 + LSHIFT(z1 + z2, CONST_BITS);
    JLONG tmp2 = tmp1 + LSHIFT(z3 - z2, CONST_BITS);
    tmp1 = LSHIFT(z1 - z2 - z3, CONST_BITS);
    const int s = CONST_BITS + PASS1_BITS + 3;
    o[0] = OUT(tmp10 + tmp0, s);
    o[5] = OUT(tmp10 - tmp0, s);
    o[1] = OUT(tmp11 + tmp1, s);
    o[4] = OUT(tmp11 - tmp1, s);
    o[2] = OUT(tmp12 + tmp2, s);
    o[3] = OUT(tmp12 - tmp2, s);
  }
}

// jidctint.c jpeg_idct_7x7: 7-point kernel, cK = sqrt(2) * cos(K*pi/14).
void idct_7x7(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  const uint8_t* lim = tables().idct_limit;
  int ws[7 * 7];
  for (int c = 0; c < 7; ++c) {
    JLONG tmp13 = LSHIFT(DEQ(c), CONST_BITS) + (ONE << (CONST_BITS - PASS1_BITS - 1));
    JLONG z1 = DEQ(16 + c), z2 = DEQ(32 + c), z3 = DEQ(48 + c);
    JLONG tmp10 = MULTIPLY(z2 - z3, FIX(0.881747734));
    JLONG tmp12 = MULTIPLY(z1 - z2, FIX(0.314692123));
    JLONG tmp11 = tmp10 + tmp12 + tmp13 - MULTIPLY(z2, FIX(1.841218003));
    JLONG tmp0 = z1 + z3;
    z2 -= tmp0;
    tmp0 = MULTIPLY(tmp0, FIX(1.274162392)) + tmp13;
    tmp10 += tmp0 - MULTIPLY(z3, FIX(0.077722536));
    tmp12 += tmp0 - MULTIPLY(z1, FIX(2.470602249));
    tmp13 += MULTIPLY(z2, FIX(1.414213562));
    z1 = DEQ(8 + c);
    z2 = DEQ(24 + c);
    z3 = DEQ(40 + c);
    JLONG tmp1 = MULTIPLY(z1 + z2, FIX(0.935414347));
    JLONG tmp2 = MULTIPLY(z1 - z2, FIX(0.170262339));
    tmp0 = tmp1 - tmp2;
    tmp1 += tmp2;
    tmp2 = MULTIPLY(z2 + z3, -FIX(1.378756276));
    tmp1 += tmp2;
    z2 = MULTIPLY(z1 + z3, FIX(0.613604268));
    tmp0 += z2;
    tmp2 += z2 + MULTIPLY(z3, FIX(1.870828693));
    const int s = CONST_BITS - PASS1_BITS;
    ws[7 * 0 + c] = (int)RSHIFT(tmp10 + tmp0, s);
    ws[7 * 6 + c] = (int)RSHIFT(tmp10 - tmp0, s);
    ws[7 * 1 + c] = (int)RSHIFT(tmp11 + tmp1, s);
    ws[7 * 5 + c] = (int)RSHIFT(tmp11 - tmp1, s);
    ws[7 * 2 + c] = (int)RSHIFT(tmp12 + tmp2, s);
    ws[7 * 4 + c] = (int)RSHIFT(tmp12 - tmp2, s);
    ws[7 * 3 + c] = (int)RSHIFT(tmp13, s);
  }
  for (int r = 0; r < 7; ++r) {
    const int* w = ws + r * 7;
    uint8_t* o = out + r * stride;
    JLONG tmp13 = LSHIFT((JLONG)w[0] + (ONE << (PASS1_BITS + 2)), CONST_BITS);
    JLONG z1 = w[2], z2 = w[4], z3 = w[6];
    JLONG tmp10 = MULTIPLY(z2 - z3, FIX(0.881747734));
    JLONG tmp12 = MULTIPLY(z1 - z2, FIX(0.314692123));
    JLONG tmp11 = tmp10 + tmp12 + tmp13 - MULTIPLY(z2, FIX(1.841218003));
    JLONG tmp0 = z1 + z3;
    z2 -= tmp0;
    tmp0 = MULTIPLY(tmp0, FIX(1.274162392)) + tmp13;
    tmp10 += tmp0 - MULTIPLY(z3, FIX(0.077722536));
    tmp12 += tmp0 - MULTIPLY(z1, FIX(2.470602249));
    tmp13 += MULTIPLY(z2, FIX(1.414213562));
    z1 = w[1];
    z2 = w[3];
    z3 = w[5];
    JLONG tmp1 = MULTIPLY(z1 + z2, FIX(0.935414347));
    JLONG tmp2 = MULTIPLY(z1 - z2, FIX(0.170262339));
    tmp0 = tmp1 - tmp2;
    tmp1 += tmp2;
    tmp2 = MULTIPLY(z2 + z3, -FIX(1.378756276));
    tmp1 += tmp2;
    z2 = MULTIPLY(z1 + z3, FIX(0.613604268));
    tmp0 += z2;
    tmp2 += z2 + MULTIPLY(z3, FIX(1.870828693));
    const int s = CONST_BITS + PASS1_BITS + 3;
    o[0] = OUT(tmp10 + tmp0, s);
    o[6] = OUT(tmp10 - tmp0, s);
    o[1] = OUT(tmp11 + tmp1, s);
    o[5] = OUT(tmp11 - tmp1, s);
    o[2] = OUT(tmp12 + tmp2, s);
    o[4] = OUT(tmp12 - tmp2, s);
    o[3] = OUT(tmp13, s);
  }
}

// jidctint.c jpeg_idct_10x10: 10-point kernel, cK = sqrt(2) * cos(K*pi/20).
void idct_10x10(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  const uint8_t* lim = tables().idct_limit;
  int ws[8 * 10];
  for (int c = 0; c < 8; ++c) {
    JLONG z3 = LSHIFT(DEQ(c), CONST_BITS) + (ONE << (CONST_BITS - PASS1_BITS - 1));
    JLONG z4 = DEQ(32 + c);
    JLONG z1 = MULTIPLY(z4, FIX(1.144122806));
    JLONG z2 = MULTIPLY(z4, FIX(0.437016024));
    JLONG tmp10 = z3 + z1, tmp11 = z3 - z2;
    JLONG tmp22 = RSHIFT(z3 - LSHIFT(z1 - z2, 1), CONST_BITS - PASS1_BITS);
    z2 = DEQ(16 + c);
    z3 = DEQ(48 + c);
    z1 = MULTIPLY(z2 + z3, FIX(0.831253876));
    JLONG tmp12 = z1 + MULTIPLY(z2, FIX(0.513743148));
    JLONG tmp13 = z1 - MULTIPLY(z3, FIX(2.176250899));
    JLONG tmp20 = tmp10 + tmp12, tmp24 = tmp10 - tmp12;
    JLONG tmp21 = tmp11 + tmp13, tmp23 = tmp11 - tmp13;
    z1 = DEQ(8 + c);
    z2 = DEQ(24 + c);
    z3 = DEQ(40 + c);
    z4 = DEQ(56 + c);
    tmp11 = z2 + z4;
    tmp13 = z2 - z4;
    tmp12 = MULTIPLY(tmp13, FIX(0.309016994));
    JLONG z5 = LSHIFT(z3, CONST_BITS);
    z2 = MULTIPLY(tmp11, FIX(0.951056516));
    z4 = z5 + tmp12;
    tmp10 = MULTIPLY(z1, FIX(1.396802247)) + z2 + z4;
    JLONG tmp14 = MULTIPLY(z1, FIX(0.221231742)) - z2 + z4;
    z2 = MULTIPLY(tmp11, FIX(0.587785252));
    z4 = z5 - tmp12 - LSHIFT(tmp13, CONST_BITS - 1);
    tmp12 = LSHIFT(z1 - tmp13 - z3, PASS1_BITS);
    tmp11 = MULTIPLY(z1, FIX(1.260073511)) - z2 - z4;
    tmp13 = MULTIPLY(z1, FIX(0.642039522)) - z2 + z4;
    const int s = CONST_BITS - PASS1_BITS;
    ws[8 * 0 + c] = (int)RSHIFT(tmp20 + tmp10, s);
    ws[8 * 9 + c] = (int)RSHIFT(tmp20 - tmp10, s);
    ws[8 * 1 + c] = (int)RSHIFT(tmp21 + tmp11, s);
    ws[8 * 8 + c] = (int)RSHIFT(tmp21 - tmp11, s);
    ws[8 * 2 + c] = (int)(tmp22 + tmp12);
    ws[8 * 7 + c] = (int)(tmp22 - tmp12);
    ws[8 * 3 + c] = (int)RSHIFT(tmp23 + tmp13, s);
    ws[8 * 6 + c] = (int)RSHIFT(tmp23 - tmp13, s);
    ws[8 * 4 + c] = (int)RSHIFT(tmp24 + tmp14, s);
    ws[8 * 5 + c] = (int)RSHIFT(tmp24 - tmp14, s);
  }
  for (int r = 0; r < 10; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    JLONG z3 = LSHIFT((JLONG)w[0] + (ONE << (PASS1_BITS + 2)), CONST_BITS);
    JLONG z4 = w[4];
    JLONG z1 = MULTIPLY(z4, FIX(1.144122806));
    JLONG z2 = MULTIPLY(z4, FIX(0.437016024));
    JLONG tmp10 = z3 + z1, tmp11 = z3 - z2;
    JLONG tmp22 = z3 - LSHIFT(z1 - z2, 1);
    z2 = w[2];
    z3 = w[6];
    z1 = MULTIPLY(z2 + z3, FIX(0.831253876));
    JLONG tmp12 = z1 + MULTIPLY(z2, FIX(0.513743148));
    JLONG tmp13 = z1 - MULTIPLY(z3, FIX(2.176250899));
    JLONG tmp20 = tmp10 + tmp12, tmp24 = tmp10 - tmp12;
    JLONG tmp21 = tmp11 + tmp13, tmp23 = tmp11 - tmp13;
    z1 = w[1];
    z2 = w[3];
    z3 = LSHIFT((JLONG)w[5], CONST_BITS);
    z4 = w[7];
    tmp11 = z2 + z4;
    tmp13 = z2 - z4;
    tmp12 = MULTIPLY(tmp13, FIX(0.309016994));
    z2 = MULTIPLY(tmp11, FIX(0.951056516));
    z4 = z3 + tmp12;
    tmp10 = MULTIPLY(z1, FIX(1.396802247)) + z2 + z4;
    JLONG tmp14 = MULTIPLY(z1, FIX(0.221231742)) - z2 + z4;
    z2 = MULTIPLY(tmp11, FIX(0.587785252));
    z4 = z3 - tmp12 - LSHIFT(tmp13, CONST_BITS - 1);
    tmp12 = LSHIFT(z1 - tmp13, CONST_BITS) - z3;
    tmp11 = MULTIPLY(z1, FIX(1.260073511)) - z2 - z4;
    tmp13 = MULTIPLY(z1, FIX(0.642039522)) - z2 + z4;
    const int s = CONST_BITS + PASS1_BITS + 3;
    o[0] = OUT(tmp20 + tmp10, s);
    o[9] = OUT(tmp20 - tmp10, s);
    o[1] = OUT(tmp21 + tmp11, s);
    o[8] = OUT(tmp21 - tmp11, s);
    o[2] = OUT(tmp22 + tmp12, s);
    o[7] = OUT(tmp22 - tmp12, s);
    o[3] = OUT(tmp23 + tmp13, s);
    o[6] = OUT(tmp23 - tmp13, s);
    o[4] = OUT(tmp24 + tmp14, s);
    o[5] = OUT(tmp24 - tmp14, s);
  }
}

// jidctint.c jpeg_idct_12x12: 12-point kernel, cK = sqrt(2) * cos(K*pi/24).
void idct_12x12(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  const uint8_t* lim = tables().idct_limit;
  int ws[8 * 12];
  for (int c = 0; c < 8; ++c) {
    JLONG z3 = LSHIFT(DEQ(c), CONST_BITS) + (ONE << (CONST_BITS - PASS1_BITS - 1));
    JLONG z4 = MULTIPLY(DEQ(32 + c), FIX(1.224744871));
    JLONG tmp10 = z3 + z4, tmp11 = z3 - z4;
    JLONG z1 = DEQ(16 + c);
    z4 = MULTIPLY(z1, FIX(1.366025404));
    z1 = LSHIFT(z1, CONST_BITS);
    JLONG z2 = LSHIFT(DEQ(48 + c), CONST_BITS);
    JLONG tmp12 = z1 - z2;
    JLONG tmp21 = z3 + tmp12, tmp24 = z3 - tmp12;
    tmp12 = z4 + z2;
    JLONG tmp20 = tmp10 + tmp12, tmp25 = tmp10 - tmp12;
    tmp12 = z4 - z1 - z2;
    JLONG tmp22 = tmp11 + tmp12, tmp23 = tmp11 - tmp12;
    z1 = DEQ(8 + c);
    z2 = DEQ(24 + c);
    z3 = DEQ(40 + c);
    z4 = DEQ(56 + c);
    tmp11 = MULTIPLY(z2, FIX(1.306562965));
    JLONG tmp14 = MULTIPLY(z2, -FIX_0_541196100);
    tmp10 = z1 + z3;
    JLONG tmp15 = MULTIPLY(tmp10 + z4, FIX(0.860918669));
    tmp12 = tmp15 + MULTIPLY(tmp10, FIX(0.261052384));
    tmp10 = tmp12 + tmp11 + MULTIPLY(z1, FIX(0.280143716));
    JLONG tmp13 = MULTIPLY(z3 + z4, -FIX(1.045510580));
    tmp12 += tmp13 + tmp14 - MULTIPLY(z3, FIX(1.478575242));
    tmp13 += tmp15 - tmp11 + MULTIPLY(z4, FIX(1.586706681));
    tmp15 += tmp14 - MULTIPLY(z1, FIX(0.676326758)) - MULTIPLY(z4, FIX(1.982889723));
    z1 -= z4;
    z2 -= z3;
    z3 = MULTIPLY(z1 + z2, FIX_0_541196100);
    tmp11 = z3 + MULTIPLY(z1, FIX_0_765366865);
    tmp14 = z3 - MULTIPLY(z2, FIX_1_847759065);
    const int s = CONST_BITS - PASS1_BITS;
    ws[8 * 0 + c] = (int)RSHIFT(tmp20 + tmp10, s);
    ws[8 * 11 + c] = (int)RSHIFT(tmp20 - tmp10, s);
    ws[8 * 1 + c] = (int)RSHIFT(tmp21 + tmp11, s);
    ws[8 * 10 + c] = (int)RSHIFT(tmp21 - tmp11, s);
    ws[8 * 2 + c] = (int)RSHIFT(tmp22 + tmp12, s);
    ws[8 * 9 + c] = (int)RSHIFT(tmp22 - tmp12, s);
    ws[8 * 3 + c] = (int)RSHIFT(tmp23 + tmp13, s);
    ws[8 * 8 + c] = (int)RSHIFT(tmp23 - tmp13, s);
    ws[8 * 4 + c] = (int)RSHIFT(tmp24 + tmp14, s);
    ws[8 * 7 + c] = (int)RSHIFT(tmp24 - tmp14, s);
    ws[8 * 5 + c] = (int)RSHIFT(tmp25 + tmp15, s);
    ws[8 * 6 + c] = (int)RSHIFT(tmp25 - tmp15, s);
  }
  for (int r = 0; r < 12; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    JLONG z3 = LSHIFT((JLONG)w[0] + (ONE << (PASS1_BITS + 2)), CONST_BITS);
    JLONG z4 = MULTIPLY((JLONG)w[4], FIX(1.224744871));
    JLONG tmp10 = z3 + z4, tmp11 = z3 - z4;
    JLONG z1 = w[2];
    z4 = MULTIPLY(z1, FIX(1.366025404));
    z1 = LSHIFT(z1, CONST_BITS);
    JLONG z2 = LSHIFT((JLONG)w[6], CONST_BITS);
    JLONG tmp12 = z1 - z2;
    JLONG tmp21 = z3 + tmp12, tmp24 = z3 - tmp12;
    tmp12 = z4 + z2;
    JLONG tmp20 = tmp10 + tmp12, tmp25 = tmp10 - tmp12;
    tmp12 = z4 - z1 - z2;
    JLONG tmp22 = tmp11 + tmp12, tmp23 = tmp11 - tmp12;
    z1 = w[1];
    z2 = w[3];
    z3 = w[5];
    z4 = w[7];
    tmp11 = MULTIPLY(z2, FIX(1.306562965));
    JLONG tmp14 = MULTIPLY(z2, -FIX_0_541196100);
    tmp10 = z1 + z3;
    JLONG tmp15 = MULTIPLY(tmp10 + z4, FIX(0.860918669));
    tmp12 = tmp15 + MULTIPLY(tmp10, FIX(0.261052384));
    tmp10 = tmp12 + tmp11 + MULTIPLY(z1, FIX(0.280143716));
    JLONG tmp13 = MULTIPLY(z3 + z4, -FIX(1.045510580));
    tmp12 += tmp13 + tmp14 - MULTIPLY(z3, FIX(1.478575242));
    tmp13 += tmp15 - tmp11 + MULTIPLY(z4, FIX(1.586706681));
    tmp15 += tmp14 - MULTIPLY(z1, FIX(0.676326758)) - MULTIPLY(z4, FIX(1.982889723));
    z1 -= z4;
    z2 -= z3;
    z3 = MULTIPLY(z1 + z2, FIX_0_541196100);
    tmp11 = z3 + MULTIPLY(z1, FIX_0_765366865);
    tmp14 = z3 - MULTIPLY(z2, FIX_1_847759065);
    const int s = CONST_BITS + PASS1_BITS + 3;
    o[0] = OUT(tmp20 + tmp10, s);
    o[11] = OUT(tmp20 - tmp10, s);
    o[1] = OUT(tmp21 + tmp11, s);
    o[10] = OUT(tmp21 - tmp11, s);
    o[2] = OUT(tmp22 + tmp12, s);
    o[9] = OUT(tmp22 - tmp12, s);
    o[3] = OUT(tmp23 + tmp13, s);
    o[8] = OUT(tmp23 - tmp13, s);
    o[4] = OUT(tmp24 + tmp14, s);
    o[7] = OUT(tmp24 - tmp14, s);
    o[5] = OUT(tmp25 + tmp15, s);
    o[6] = OUT(tmp25 - tmp15, s);
  }
}

// jidctint.c jpeg_idct_14x14: 14-point kernel, cK = sqrt(2) * cos(K*pi/28).
void idct_14x14(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  const uint8_t* lim = tables().idct_limit;
  int ws[8 * 14];
  for (int c = 0; c < 8; ++c) {
    JLONG z1 = LSHIFT(DEQ(c), CONST_BITS) + (ONE << (CONST_BITS - PASS1_BITS - 1));
    JLONG z4 = DEQ(32 + c);
    JLONG z2 = MULTIPLY(z4, FIX(1.274162392));
    JLONG z3 = MULTIPLY(z4, FIX(0.314692123));
    z4 = MULTIPLY(z4, FIX(0.881747734));
    JLONG tmp10 = z1 + z2, tmp11 = z1 + z3, tmp12 = z1 - z4;
    JLONG tmp23 = RSHIFT(z1 - LSHIFT(z2 + z3 - z4, 1), CONST_BITS - PASS1_BITS);
    z1 = DEQ(16 + c);
    z2 = DEQ(48 + c);
    z3 = MULTIPLY(z1 + z2, FIX(1.105676686));
    JLONG tmp13 = z3 + MULTIPLY(z1, FIX(0.273079590));
    JLONG tmp14 = z3 - MULTIPLY(z2, FIX(1.719280954));
    JLONG tmp15 = MULTIPLY(z1, FIX(0.613604268)) - MULTIPLY(z2, FIX(1.378756276));
    JLONG tmp20 = tmp10 + tmp13, tmp26 = tmp10 - tmp13;
    JLONG tmp21 = tmp11 + tmp14, tmp25 = tmp11 - tmp14;
    JLONG tmp22 = tmp12 + tmp15, tmp24 = tmp12 - tmp15;
    z1 = DEQ(8 + c);
    z2 = DEQ(24 + c);
    z3 = DEQ(40 + c);
    z4 = DEQ(56 + c);
    tmp13 = LSHIFT(z4, CONST_BITS);
    tmp14 = z1 + z3;
    tmp11 = MULTIPLY(z1 + z2, FIX(1.334852607));
    tmp12 = MULTIPLY(tmp14, FIX(1.197448846));
    tmp10 = tmp11 + tmp12 + tmp13 - MULTIPLY(z1, FIX(1.126980169));
    tmp14 = MULTIPLY(tmp14, FIX(0.752406978));
    JLONG tmp16 = tmp14 - MULTIPLY(z1, FIX(1.061150426));
    z1 -= z2;
    tmp15 = MULTIPLY(z1, FIX(0.467085129)) - tmp13;
    tmp16 += tmp15;
    z1 += z4;
    z4 = MULTIPLY(z2 + z3, -FIX(0.158341681)) - tmp13;
    tmp11 += z4 - MULTIPLY(z2, FIX(0.424103948));
    tmp12 += z4 - MULTIPLY(z3, FIX(2.373959773));
    z4 = MULTIPLY(z3 - z2, FIX(1.405321284));
    tmp14 += z4 + tmp13 - MULTIPLY(z3, FIX(1.6906431334));
    tmp15 += z4 + MULTIPLY(z2, FIX(0.674957567));
    tmp13 = LSHIFT(z1 - z3, PASS1_BITS);
    const int s = CONST_BITS - PASS1_BITS;
    ws[8 * 0 + c] = (int)RSHIFT(tmp20 + tmp10, s);
    ws[8 * 13 + c] = (int)RSHIFT(tmp20 - tmp10, s);
    ws[8 * 1 + c] = (int)RSHIFT(tmp21 + tmp11, s);
    ws[8 * 12 + c] = (int)RSHIFT(tmp21 - tmp11, s);
    ws[8 * 2 + c] = (int)RSHIFT(tmp22 + tmp12, s);
    ws[8 * 11 + c] = (int)RSHIFT(tmp22 - tmp12, s);
    ws[8 * 3 + c] = (int)(tmp23 + tmp13);
    ws[8 * 10 + c] = (int)(tmp23 - tmp13);
    ws[8 * 4 + c] = (int)RSHIFT(tmp24 + tmp14, s);
    ws[8 * 9 + c] = (int)RSHIFT(tmp24 - tmp14, s);
    ws[8 * 5 + c] = (int)RSHIFT(tmp25 + tmp15, s);
    ws[8 * 8 + c] = (int)RSHIFT(tmp25 - tmp15, s);
    ws[8 * 6 + c] = (int)RSHIFT(tmp26 + tmp16, s);
    ws[8 * 7 + c] = (int)RSHIFT(tmp26 - tmp16, s);
  }
  for (int r = 0; r < 14; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    JLONG z1 = LSHIFT((JLONG)w[0] + (ONE << (PASS1_BITS + 2)), CONST_BITS);
    JLONG z4 = w[4];
    JLONG z2 = MULTIPLY(z4, FIX(1.274162392));
    JLONG z3 = MULTIPLY(z4, FIX(0.314692123));
    z4 = MULTIPLY(z4, FIX(0.881747734));
    JLONG tmp10 = z1 + z2, tmp11 = z1 + z3, tmp12 = z1 - z4;
    JLONG tmp23 = z1 - LSHIFT(z2 + z3 - z4, 1);
    z1 = w[2];
    z2 = w[6];
    z3 = MULTIPLY(z1 + z2, FIX(1.105676686));
    JLONG tmp13 = z3 + MULTIPLY(z1, FIX(0.273079590));
    JLONG tmp14 = z3 - MULTIPLY(z2, FIX(1.719280954));
    JLONG tmp15 = MULTIPLY(z1, FIX(0.613604268)) - MULTIPLY(z2, FIX(1.378756276));
    JLONG tmp20 = tmp10 + tmp13, tmp26 = tmp10 - tmp13;
    JLONG tmp21 = tmp11 + tmp14, tmp25 = tmp11 - tmp14;
    JLONG tmp22 = tmp12 + tmp15, tmp24 = tmp12 - tmp15;
    z1 = w[1];
    z2 = w[3];
    z3 = w[5];
    z4 = LSHIFT((JLONG)w[7], CONST_BITS);
    tmp14 = z1 + z3;
    tmp11 = MULTIPLY(z1 + z2, FIX(1.334852607));
    tmp12 = MULTIPLY(tmp14, FIX(1.197448846));
    tmp10 = tmp11 + tmp12 + z4 - MULTIPLY(z1, FIX(1.126980169));
    tmp14 = MULTIPLY(tmp14, FIX(0.752406978));
    JLONG tmp16 = tmp14 - MULTIPLY(z1, FIX(1.061150426));
    z1 -= z2;
    tmp15 = MULTIPLY(z1, FIX(0.467085129)) - z4;
    tmp16 += tmp15;
    tmp13 = MULTIPLY(z2 + z3, -FIX(0.158341681)) - z4;
    tmp11 += tmp13 - MULTIPLY(z2, FIX(0.424103948));
    tmp12 += tmp13 - MULTIPLY(z3, FIX(2.373959773));
    tmp13 = MULTIPLY(z3 - z2, FIX(1.405321284));
    tmp14 += tmp13 + z4 - MULTIPLY(z3, FIX(1.6906431334));
    tmp15 += tmp13 + MULTIPLY(z2, FIX(0.674957567));
    tmp13 = LSHIFT(z1 - z3, CONST_BITS) + z4;
    const int s = CONST_BITS + PASS1_BITS + 3;
    o[0] = OUT(tmp20 + tmp10, s);
    o[13] = OUT(tmp20 - tmp10, s);
    o[1] = OUT(tmp21 + tmp11, s);
    o[12] = OUT(tmp21 - tmp11, s);
    o[2] = OUT(tmp22 + tmp12, s);
    o[11] = OUT(tmp22 - tmp12, s);
    o[3] = OUT(tmp23 + tmp13, s);
    o[10] = OUT(tmp23 - tmp13, s);
    o[4] = OUT(tmp24 + tmp14, s);
    o[9] = OUT(tmp24 - tmp14, s);
    o[5] = OUT(tmp25 + tmp15, s);
    o[8] = OUT(tmp25 - tmp15, s);
    o[6] = OUT(tmp26 + tmp16, s);
    o[7] = OUT(tmp26 - tmp16, s);
  }
}

IdctFn idct_for(int size) {
  switch (size) {
    case 1: return idct_1x1;
    case 2: return idct_2x2;
    case 3: return idct_3x3;
    case 4: return idct_4x4;
    case 5: return idct_5x5;
    case 6: return idct_6x6;
    case 7: return idct_7x7;
    case 8: return idct_8x8;
    case 10: return idct_10x10;
    case 12: return idct_12x12;
    case 14: return idct_14x14;
    default: unsupported("an IDCT of size " + std::to_string(size));
  }
}

// ---------------------------------------------------------------------------
// entropy decoding
// ---------------------------------------------------------------------------

struct Huffman {
  bool defined = false;
  uint8_t fast_len[512];   // 9-bit lookahead: code length, 0 = longer code
  uint8_t fast_sym[512];
  int32_t maxcode[18];     // largest code of each length, -1 if none
  int32_t valoffset[17];   // index into vals of the first code of a length
  uint8_t vals[256];
};

void build_huffman(Huffman& h, const uint8_t* counts, const uint8_t* vals, int nvals) {
  std::memset(h.fast_len, 0, sizeof(h.fast_len));
  std::memcpy(h.vals, vals, nvals);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    h.valoffset[len] = k - code;
    for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
      if (code >= (1 << len)) corrupt("a Huffman table whose code lengths overflow");
      if (len <= 9) {
        int shift = 9 - len;
        for (int j = 0; j < (1 << shift); ++j) {
          h.fast_len[(code << shift) | j] = static_cast<uint8_t>(len);
          h.fast_sym[(code << shift) | j] = vals[k];
        }
      }
    }
    h.maxcode[len] = counts[len - 1] ? code - 1 : -1;
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
  h.defined = true;
}

// Reads entropy-coded data: undoes 0xFF00 stuffing, stops at a marker and
// then feeds zero bits, as libjpeg does; bits fed past the real data are
// counted so that a scan that needed them is reported as truncated.
struct BitReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t buf = 0;
  int cnt = 0;
  int fake = 0;          // zero bits at the bottom of buf that are not data
  bool at_marker = false;

  void reset(const uint8_t* start) {
    p = start;
    buf = 0;
    cnt = 0;
    fake = 0;
    at_marker = false;
  }
  void fill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (!at_marker) {
        if (p >= end) {
          at_marker = true;
        } else if (*p != 0xFF) {
          b = *p++;
        } else if (p + 1 < end && p[1] == 0x00) {
          b = 0xFF;
          p += 2;
        } else {
          at_marker = true;   // p stays on the marker's 0xFF
        }
      }
      if (at_marker) fake += 8;
      buf |= b << (56 - cnt);
      cnt += 8;
    }
  }
  inline void ensure(int n) {
    if (cnt < n) fill();
  }
  inline uint32_t peek(int n) {
    return static_cast<uint32_t>(buf >> (64 - n));
  }
  inline void skip(int n) {
    buf <<= n;
    cnt -= n;
  }
  inline int bits(int n) {
    if (n == 0) return 0;
    ensure(n);
    int v = static_cast<int>(peek(n));
    skip(n);
    return v;
  }
  inline int bit() { return bits(1); }
  bool overran() const { return cnt < fake; }
  int decode(const Huffman& h) {
    ensure(16);
    uint32_t look = peek(9);
    int len = h.fast_len[look];
    if (len) {
      skip(len);
      return h.fast_sym[look];
    }
    uint32_t code16 = peek(16);
    for (int l = 10; l <= 16; ++l) {
      int32_t code = static_cast<int32_t>(code16 >> (16 - l));
      if (code <= h.maxcode[l]) {
        skip(l);
        return h.vals[h.valoffset[l] + code];
      }
    }
    corrupt("an invalid Huffman code in the entropy-coded data");
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ---------------------------------------------------------------------------
// the decoder
// ---------------------------------------------------------------------------

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;        // blocks per row / column, padded to whole MCUs
  int wib = 0, hib = 0;      // blocks that hold image data
  std::vector<int16_t> coef;
  uint16_t qt[64];
  bool qt_latched = false;
  int dc_tbl = 0, ac_tbl = 0, pred = 0;
};

struct Decoder {
  const uint8_t* data;
  const uint8_t* end;
  const uint8_t* pos;
  uint16_t qtables[4][64];
  bool qdefined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  std::vector<Component> comps;
  int width = 0, height = 0, max_h = 1, max_v = 1, mcus_x = 0, mcus_y = 0;
  bool progressive = false, have_frame = false, saw_eoi = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  int eobrun = 0;
  BitReader br;

  Decoder(const uint8_t* d, long n) : data(d), end(d + n), pos(d) {}

  int u8() {
    if (pos >= end) corrupt("truncated inside a marker segment");
    return *pos++;
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  int next_marker() {
    // skips anything up to the next 0xFF xx with xx not 0 and not 0xFF
    while (true) {
      if (pos >= end) corrupt("truncated: no EOI marker");
      if (*pos != 0xFF) {
        ++pos;
        continue;
      }
      while (pos < end && *pos == 0xFF) ++pos;
      if (pos >= end) corrupt("truncated: no EOI marker");
      int m = *pos++;
      if (m != 0) return m;
    }
  }

  void run() {
    if (end - data < 2 || data[0] != 0xFF || data[1] != 0xD8)
      corrupt("not a JPEG file (no SOI marker)");
    pos = data + 2;
    bool scanned = false;
    while (!saw_eoi) {
      int m = next_marker();
      if (m == 0xDA) {
        if (!have_frame) corrupt("a scan before the frame header");
        scan();
        scanned = true;
      } else if (m == 0xD9) {
        saw_eoi = true;
      } else {
        segment(m);
      }
    }
    if (!scanned) corrupt("no scan data");
    for (const auto& c : comps)
      if (!c.qt_latched) corrupt("a component that no scan codes");
  }

  void segment(int m) {
    if (m >= 0xD0 && m <= 0xD7) return;  // a stray RSTn outside a scan
    if (m == 0xD8 || m == 0x01) return;
    if (m == 0xC4) return dht();
    if (m == 0xDB) return dqt();
    if (m == 0xDD) {
      if (u16() != 4) corrupt("a DRI segment of the wrong length");
      restart_interval = u16();
      return;
    }
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) return sof(m);
    if (m == 0xC3) unsupported("lossless JPEG (SOF3)");
    if (m == 0xC5 || m == 0xC6 || m == 0xC7)
      unsupported("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ")");
    if (m == 0xC9 || m == 0xCA || m == 0xCB || m == 0xCD || m == 0xCE || m == 0xCF)
      unsupported("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) + ")");
    if (m == 0xCC) unsupported("arithmetic coding conditioning (DAC)");
    if (m == 0xDC) unsupported("a DNL marker (height defined after the scan)");
    if (m == 0xD9) corrupt("EOI before any scan");
    // APPn, COM and anything else with a length: skip, reading JFIF/Adobe
    int len = u16();
    if (len < 2 || pos + len - 2 > end) corrupt("truncated: a marker segment runs past the end of the data");
    const uint8_t* seg = pos;
    if (m == 0xE0 && len >= 7 && std::memcmp(seg, "JFIF\0", 5) == 0) jfif = true;
    if (m == 0xEE && len >= 14 && std::memcmp(seg, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = seg[11];
    }
    pos += len - 2;
  }

  void dqt() {
    int len = u16() - 2;
    const uint8_t* stop = pos + len;
    if (len < 0 || stop > end) corrupt("truncated: a DQT segment runs past the end of the data");
    while (pos < stop) {
      int pq = u8();
      int prec = pq >> 4, t = pq & 15;
      if (t > 3 || prec > 1) corrupt("a bad quantisation table header");
      for (int i = 0; i < 64; ++i) {
        int v = prec ? u16() : u8();
        qtables[t][kZigzag[i]] = static_cast<uint16_t>(v);
      }
      qdefined[t] = true;
    }
    if (pos != stop) corrupt("a DQT segment of the wrong length");
  }

  void dht() {
    int len = u16() - 2;
    const uint8_t* stop = pos + len;
    if (len < 0 || stop > end) corrupt("truncated: a DHT segment runs past the end of the data");
    while (pos < stop) {
      int tc = u8();
      int cls = tc >> 4, t = tc & 15;
      if (cls > 1 || t > 3) corrupt("a bad Huffman table header");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) {
        counts[i] = static_cast<uint8_t>(u8());
        total += counts[i];
      }
      if (total > 256) corrupt("a Huffman table with more than 256 codes");
      uint8_t vals[256];
      for (int i = 0; i < total; ++i) vals[i] = static_cast<uint8_t>(u8());
      build_huffman(cls ? ac[t] : dc[t], counts, vals, total);
    }
    if (pos != stop) corrupt("a DHT segment of the wrong length");
  }

  void sof(int m) {
    if (have_frame) corrupt("a second frame header");
    int len = u16();
    int precision = u8();
    height = u16();
    width = u16();
    int n = u8();
    if (precision != 8)
      unsupported(std::to_string(precision) + "-bit samples (only 8-bit are read)");
    if (height == 0) unsupported("a DNL marker (height defined after the scan)");
    if (width == 0) corrupt("a frame of zero width");
    if (static_cast<long>(width) * height > kMaxPixels)
      unsupported("a frame of " + std::to_string(width) + " x " + std::to_string(height) +
                  " pixels (more than 2^28)");
    if (n == 4) unsupported("4-component (CMYK/YCCK) JPEG");
    if (n != 1 && n != 3) unsupported(std::to_string(n) + "-component JPEG");
    if (len != 8 + 3 * n) corrupt("a frame header of the wrong length");
    comps.resize(n);
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.v < 1 || c.h > 4 || c.v > 4 || c.tq > 3)
        corrupt("bad sampling factors or table index in the frame header");
      if (c.h > 2 || c.v > 2)
        unsupported("sampling factors above 2x2 (" + std::to_string(c.h) + "x" +
                    std::to_string(c.v) + ")");
    }
    if (n == 1) comps[0].h = comps[0].v = 1;  // one component: MCU is one block
    for (auto& c : comps) {
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    mcus_x = (width + 8 * max_h - 1) / (8 * max_h);
    mcus_y = (height + 8 * max_v - 1) / (8 * max_v);
    for (auto& c : comps) {
      c.bw = mcus_x * c.h;
      c.bh = mcus_y * c.v;
      int cw = (width * c.h + max_h - 1) / max_h;
      int ch = (height * c.v + max_v - 1) / max_v;
      c.wib = (cw + 7) / 8;
      c.hib = (ch + 7) / 8;
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    }
    progressive = (m == 0xC2);
    have_frame = true;
  }

  // -- one scan --------------------------------------------------------------

  void scan() {
    int len = u16();
    int ns = u8();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) corrupt("a bad scan header");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = u8(), tbl = u8();
      Component* c = nullptr;
      for (auto& cc : comps)
        if (cc.id == id) c = &cc;
      if (!c) corrupt("a scan names a component the frame does not have");
      c->dc_tbl = tbl >> 4;
      c->ac_tbl = tbl & 15;
      if (c->dc_tbl > 3 || c->ac_tbl > 3) corrupt("a bad Huffman table index in a scan");
      sc.push_back(c);
    }
    int ss = u8(), se = u8(), a = u8();
    int ah = a >> 4, al = a & 15;
    if (progressive) {
      if (ss > 63 || se > 63 || ss > se || (ss == 0 && se != 0) || (ss > 0 && ns != 1) ||
          al > 13 || ah > 13)
        corrupt("bad progressive scan parameters");
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
      corrupt("bad sequential scan parameters");
    }
    for (Component* c : sc) {
      if (!c->qt_latched) {
        if (!qdefined[c->tq]) corrupt("a component's quantisation table is not defined");
        std::memcpy(c->qt, qtables[c->tq], sizeof(c->qt));
        c->qt_latched = true;
      }
      bool need_dc = !progressive || (ss == 0 && ah == 0);
      bool need_ac = !progressive || ss > 0;
      if (need_dc && !dc[c->dc_tbl].defined) corrupt("a scan uses an undefined DC table");
      if (need_ac && !ac[c->ac_tbl].defined) corrupt("a scan uses an undefined AC table");
      c->pred = 0;
    }
    eobrun = 0;
    br.end = end;
    br.reset(pos);

    int kind;  // 0 sequential, 1 DC first, 2 DC refine, 3 AC first, 4 AC refine
    if (!progressive) kind = 0;
    else if (ss == 0) kind = ah == 0 ? 1 : 2;
    else kind = ah == 0 ? 3 : 4;

    auto block = [&](Component& c, int by, int bx) {
      int16_t* blk = &c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64];
      switch (kind) {
        case 0: decode_sequential(c, blk); break;
        case 1: decode_dc_first(c, blk, al); break;
        case 2: if (br.bit()) blk[0] = static_cast<int16_t>(blk[0] | (1 << al)); break;
        case 3: decode_ac_first(c, blk, ss, se, al); break;
        default: decode_ac_refine(c, blk, ss, se, al); break;
      }
    };

    long total, mcus_per_row;
    if (ns == 1) {
      mcus_per_row = sc[0]->wib;
      total = static_cast<long>(sc[0]->wib) * sc[0]->hib;
    } else {
      mcus_per_row = mcus_x;
      total = static_cast<long>(mcus_x) * mcus_y;
    }
    int next_rst = 0;
    for (long mcu = 0; mcu < total; ++mcu) {
      if (restart_interval && mcu > 0 && mcu % restart_interval == 0) {
        restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        for (Component* c : sc) c->pred = 0;
        eobrun = 0;
      }
      long my = mcu / mcus_per_row, mx = mcu % mcus_per_row;
      if (ns == 1) {
        block(*sc[0], static_cast<int>(my), static_cast<int>(mx));
      } else {
        for (Component* c : sc)
          for (int v = 0; v < c->v; ++v)
            for (int h = 0; h < c->h; ++h)
              block(*c, static_cast<int>(my) * c->v + v, static_cast<int>(mx) * c->h + h);
      }
    }
    if (br.overran()) corrupt("truncated or corrupt entropy-coded data");
    pos = br.p;  // the outer loop finds the next marker from here
  }

  void restart(int expected) {
    if (br.overran()) corrupt("truncated or corrupt entropy-coded data");
    const uint8_t* p = br.p;
    while (p < end && !(p[0] == 0xFF && p + 1 < end && p[1] != 0x00 && p[1] != 0xFF)) ++p;
    if (p + 1 >= end) corrupt("truncated: a restart marker is missing");
    if (p[1] != 0xD0 + expected) corrupt("a restart marker out of sequence");
    br.reset(p + 2);
  }

  void decode_sequential(Component& c, int16_t* blk) {
    int s = br.decode(dc[c.dc_tbl]);
    if (s > 11) corrupt("a DC difference of more than 11 bits");
    if (s) c.pred += extend(br.bits(s), s);
    blk[0] = static_cast<int16_t>(c.pred);
    const Huffman& h = ac[c.ac_tbl];
    for (int k = 1; k < 64;) {
      int rs = br.decode(h);
      int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        if (k > 63) corrupt("an AC run past the end of a block");
        blk[kZigzag[k]] = static_cast<int16_t>(extend(br.bits(sz), sz));
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  void decode_dc_first(Component& c, int16_t* blk, int al) {
    int s = br.decode(dc[c.dc_tbl]);
    if (s > 11) corrupt("a DC difference of more than 11 bits");
    if (s) c.pred += extend(br.bits(s), s);
    blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.pred) << al);
  }

  void decode_ac_first(Component& c, int16_t* blk, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const Huffman& h = ac[c.ac_tbl];
    for (int k = ss; k <= se;) {
      int rs = br.decode(h);
      int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        if (k > se) corrupt("an AC run past the end of the spectral band");
        blk[kZigzag[k]] = static_cast<int16_t>(static_cast<unsigned>(extend(br.bits(sz), sz)) << al);
        ++k;
      } else if (r < 15) {
        eobrun = (1 << r) - 1;
        if (r) eobrun += br.bits(r);
        break;
      } else {
        k += 16;
      }
    }
  }

  void decode_ac_refine(Component& c, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    auto refine = [&](int16_t* coef) {
      if (br.bit() && (*coef & p1) == 0)
        *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
    };
    int k = ss;
    if (eobrun == 0) {
      const Huffman& h = ac[c.ac_tbl];
      for (; k <= se; ++k) {
        int rs = br.decode(h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) corrupt("a refinement coefficient of more than one bit");
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t* coef = blk + kZigzag[k];
          if (*coef != 0) {
            refine(coef);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se);
        if (s) {
          if (k > se) corrupt("a refinement run past the end of the spectral band");
          blk[kZigzag[k]] = static_cast<int16_t>(s);
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kZigzag[k];
        if (*coef != 0) refine(coef);
      }
      --eobrun;
    }
  }

  // -- output ----------------------------------------------------------------

  static int ceil_div(long a, long b) { return static_cast<int>((a + b - 1) / b); }

  // Decodes to RGB at scale m/8 into out (out_w * out_h * 3 bytes).
  void output(int m, uint8_t* out, int out_w, int out_h) {
    const int n = static_cast<int>(comps.size());
    const bool fancy = m > 1;
    std::vector<std::vector<uint8_t>> full(n);
    for (int ci = 0; ci < n; ++ci) {
      Component& c = comps[ci];
      // jpeg_calc_output_dimensions: scale chroma up in the IDCT if it can
      int ss = m;
      while (ss < 8 && (max_h * m) % (c.h * ss * 2) == 0 && (max_v * m) % (c.v * ss * 2) == 0)
        ss *= 2;
      IdctFn idct = idct_for(ss);
      int dw = ceil_div(static_cast<long>(width) * c.h * ss, static_cast<long>(max_h) * 8);
      int dh = ceil_div(static_cast<long>(height) * c.v * ss, static_cast<long>(max_v) * 8);
      int pw = c.wib * ss, ph = c.hib * ss;
      std::vector<uint8_t> plane(static_cast<size_t>(pw) * ph);
      for (int by = 0; by < c.hib; ++by)
        for (int bx = 0; bx < c.wib; ++bx)
          idct(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], c.qt,
               &plane[(static_cast<size_t>(by) * ss) * pw + bx * ss], pw);
      int h_in = c.h * ss / m, v_in = c.v * ss / m;
      full[ci] = upsample(plane, pw, dw, dh, h_in, v_in, fancy, out_w, out_h);
    }
    const Tables& t = tables();
    const size_t npix = static_cast<size_t>(out_w) * out_h;
    if (n == 1) {
      const uint8_t* y = full[0].data();
      for (size_t i = 0; i < npix; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
      return;
    }
    const uint8_t *y = full[0].data(), *cb = full[1].data(), *cr = full[2].data();
    if (rgb_colorspace()) {
      for (size_t i = 0; i < npix; ++i) {
        out[3 * i] = y[i];
        out[3 * i + 1] = cb[i];
        out[3 * i + 2] = cr[i];
      }
      return;
    }
    for (size_t i = 0; i < npix; ++i) {
      int yy = y[i], b = cb[i], r = cr[i];
      out[3 * i] = clamp255(yy + t.cr_r[r]);
      out[3 * i + 1] = clamp255(yy + ((t.cb_g[b] + t.cr_g[r]) >> 16));
      out[3 * i + 2] = clamp255(yy + t.cb_b[b]);
    }
  }

  // jdapimin.c default_decompress_parms for three components
  bool rgb_colorspace() const {
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
  }

  // jdsample.c: one component plane (pw wide, dw x dh of it valid) to the
  // output grid, by the method libjpeg picks for its input/output groups.
  std::vector<uint8_t> upsample(const std::vector<uint8_t>& in, int pw, int dw, int dh,
                                int h_in, int v_in, bool fancy, int out_w, int out_h) {
    const int h_out = max_h, v_out = max_v;
    std::vector<uint8_t> o(static_cast<size_t>(out_w) * out_h);
    auto row = [&](int y) { return &in[static_cast<size_t>(std::min(std::max(y, 0), dh - 1)) * pw]; };
    if (h_in == h_out && v_in == v_out) {
      for (int y = 0; y < out_h; ++y) std::memcpy(&o[static_cast<size_t>(y) * out_w], row(y), out_w);
    } else if (h_in * 2 == h_out && v_in == v_out && fancy && dw > 2) {
      std::vector<uint8_t> tmp(2 * static_cast<size_t>(dw));
      for (int y = 0; y < out_h; ++y) {
        const uint8_t* r = row(y);
        uint8_t* t = tmp.data();
        t[0] = r[0];
        t[1] = static_cast<uint8_t>((r[0] * 3 + r[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          int v = r[x] * 3;
          t[2 * x] = static_cast<uint8_t>((v + r[x - 1] + 1) >> 2);
          t[2 * x + 1] = static_cast<uint8_t>((v + r[x + 1] + 2) >> 2);
        }
        t[2 * dw - 2] = static_cast<uint8_t>((r[dw - 1] * 3 + r[dw - 2] + 1) >> 2);
        t[2 * dw - 1] = r[dw - 1];
        std::memcpy(&o[static_cast<size_t>(y) * out_w], t, out_w);
      }
    } else if (h_in == h_out && v_in * 2 == v_out && fancy) {
      for (int y = 0; y < out_h; ++y) {
        int iy = y >> 1;
        const uint8_t* near = row(iy);
        const uint8_t* far = row((y & 1) ? iy + 1 : iy - 1);
        int bias = (y & 1) ? 2 : 1;
        uint8_t* t = &o[static_cast<size_t>(y) * out_w];
        for (int x = 0; x < out_w; ++x) t[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
      }
    } else if (h_in * 2 == h_out && v_in * 2 == v_out && fancy && dw > 2) {
      std::vector<int> sum(dw);
      std::vector<uint8_t> tmp(2 * static_cast<size_t>(dw));
      for (int y = 0; y < out_h; ++y) {
        int iy = y >> 1;
        const uint8_t* near = row(iy);
        const uint8_t* far = row((y & 1) ? iy + 1 : iy - 1);
        for (int x = 0; x < dw; ++x) sum[x] = near[x] * 3 + far[x];
        uint8_t* t = tmp.data();
        t[0] = static_cast<uint8_t>((sum[0] * 4 + 8) >> 4);
        t[1] = static_cast<uint8_t>((sum[0] * 3 + sum[1] + 7) >> 4);
        for (int x = 1; x < dw - 1; ++x) {
          t[2 * x] = static_cast<uint8_t>((sum[x] * 3 + sum[x - 1] + 8) >> 4);
          t[2 * x + 1] = static_cast<uint8_t>((sum[x] * 3 + sum[x + 1] + 7) >> 4);
        }
        t[2 * dw - 2] = static_cast<uint8_t>((sum[dw - 1] * 3 + sum[dw - 2] + 8) >> 4);
        t[2 * dw - 1] = static_cast<uint8_t>((sum[dw - 1] * 4 + 7) >> 4);
        std::memcpy(&o[static_cast<size_t>(y) * out_w], t, out_w);
      }
    } else if (h_out % h_in == 0 && v_out % v_in == 0) {
      // h2v1_upsample, h2v2_upsample, int_upsample: replication
      int hx = h_out / h_in, vx = v_out / v_in;
      for (int y = 0; y < out_h; ++y) {
        const uint8_t* r = row(y / vx);
        uint8_t* t = &o[static_cast<size_t>(y) * out_w];
        for (int x = 0; x < out_w; ++x) t[x] = r[x / hx];
      }
    } else {
      unsupported("non-integral sampling ratios");
    }
    return o;
  }
};

int pick_scale(int width, int height, int min_side) {
  // the JAX helper's rule (dcr_tpu/native/jpeg_decode.cc): the smallest
  // M/8 whose shorter side, rounded down, still covers min_side
  const int full_short = std::min(width, height);
  if (min_side > 0)
    for (int m = 1; m <= 8; ++m)
      if (full_short * m / 8 >= min_side) return m;
  return 8;
}

void write_error(char* err, long err_len, const std::string& msg) {
  if (!err || err_len <= 0) return;
  std::snprintf(err, static_cast<size_t>(err_len), "%s", msg.c_str());
}

}  // namespace

extern "C" {

int jpeg_decode_scaled(const unsigned char* data, long size, int min_side,
                       unsigned char* out, long out_capacity, int* out_width,
                       int* out_height, char* err, long err_len) {
  try {
    Decoder d(data, size);
    d.run();
    int m = pick_scale(d.width, d.height, min_side);
    int ow = (d.width * m + 7) / 8, oh = (d.height * m + 7) / 8;
    *out_width = ow;
    *out_height = oh;
    if (static_cast<long>(ow) * oh * 3 > out_capacity) {
      write_error(err, err_len, "output buffer too small");
      return kTooSmall;
    }
    d.output(m, out, ow, oh);
    return kOk;
  } catch (const DecodeError& e) {
    write_error(err, err_len, e.message);
    return e.status;
  } catch (const std::bad_alloc&) {
    write_error(err, err_len, "out of memory");
    return kCorrupt;
  }
}

}  // extern "C"
