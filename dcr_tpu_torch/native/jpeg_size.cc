// A baseline JPEG encoder of the port's own: host C++, no libjpeg.
//
// The eval's complexity stage measures each matched training image by its
// JPEG byte size at quality 95 (the reference's cv2.imencode,
// diff_retrieval.py:512-515). The JAX package asks libjpeg for it under
// jpeg_set_defaults + jpeg_set_quality(q, TRUE); this file computes what
// libjpeg-turbo writes there, so the sizes can be equal:
// - RGB -> YCbCr with jccolor.c's fixed-point tables;
// - 4:2:0: luma copied, chroma by h2v2_downsample (jcsample.c) with its
//   alternating 1, 2 rounding bias; edges replicated to whole blocks and
//   iMCU rows (jcprepct.c), dummy blocks past them carry the last DC
//   (jccoefct.c);
// - the islow integer FDCT (jfdctint.c), quantised by libjpeg-turbo's
//   reciprocal multiply (jcdctmgr.c), which rounds half away from zero;
// - the Annex K tables scaled by jpeg_quality_scaling, clamped to 255;
// - the standard Huffman tables (no optimisation), a JFIF 1.01 APP0
//   header, one DQT and one DHT segment per table, no restart markers.
//
// C ABI (bound with ctypes):
//   jpeg_encode(rgb, height, width, quality, out, out_capacity) -> size
// rgb: height*width*3 bytes, rows top-down. Returns the encoded size in
// bytes (writing the first out_capacity of them; out may be null to only
// count), or -1 on bad arguments.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K.1, natural order
const int kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3 (jstdhuff.c)
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChromaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffCodes {
  uint16_t code[256];
  uint8_t size[256];
};

HuffCodes make_codes(const uint8_t* bits, const uint8_t* vals) {
  HuffCodes h;
  std::memset(&h, 0, sizeof(h));
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len - 1]; ++i, ++k, ++code) {
      h.code[vals[k]] = static_cast<uint16_t>(code);
      h.size[vals[k]] = static_cast<uint8_t>(len);
    }
    code <<= 1;
  }
  return h;
}

// The byte sink: writes into out while there is room, counts everything.
struct Sink {
  uint8_t* out;
  long cap;
  long n = 0;
  uint64_t acc = 0;  // pending entropy bits, left-aligned count in nbits
  int nbits = 0;
  void byte(int b) {
    if (out && n < cap) out[n] = static_cast<uint8_t>(b);
    ++n;
  }
  void word(int w) {
    byte(w >> 8);
    byte(w & 0xFF);
  }
  void bits(uint32_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      int b = static_cast<int>((acc >> (nbits - 8)) & 0xFF);
      byte(b);
      if (b == 0xFF) byte(0);
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits > 0) bits(0x7F, 7);  // pad with ones to a byte boundary
    nbits = 0;
    acc = 0;
  }
};

// jfdctint.c jpeg_fdct_islow, on level-shifted samples; output scaled by 8
typedef int64_t JLONG;
const int CONST_BITS = 13;
const int PASS1_BITS = 2;
#define DESCALE(x, n) (((x) + ((JLONG)1 << ((n)-1))) >> (n))

void fdct_islow(int* data) {
  for (int r = 0; r < 8; ++r) {
    int* d = data + 8 * r;
    JLONG tmp0 = d[0] + d[7], tmp7 = d[0] - d[7];
    JLONG tmp1 = d[1] + d[6], tmp6 = d[1] - d[6];
    JLONG tmp2 = d[2] + d[5], tmp5 = d[2] - d[5];
    JLONG tmp3 = d[3] + d[4], tmp4 = d[3] - d[4];
    JLONG tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    JLONG tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    d[0] = static_cast<int>((tmp10 + tmp11) * (1 << PASS1_BITS));
    d[4] = static_cast<int>((tmp10 - tmp11) * (1 << PASS1_BITS));
    JLONG z1 = (tmp12 + tmp13) * 4433;
    d[2] = static_cast<int>(DESCALE(z1 + tmp13 * 6270, CONST_BITS - PASS1_BITS));
    d[6] = static_cast<int>(DESCALE(z1 + tmp12 * -15137, CONST_BITS - PASS1_BITS));
    z1 = tmp4 + tmp7;
    JLONG z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    JLONG z5 = (z3 + z4) * 9633;
    tmp4 *= 2446;
    tmp5 *= 16819;
    tmp6 *= 25172;
    tmp7 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    d[7] = static_cast<int>(DESCALE(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS));
    d[5] = static_cast<int>(DESCALE(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS));
    d[3] = static_cast<int>(DESCALE(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS));
    d[1] = static_cast<int>(DESCALE(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS));
  }
  for (int c = 0; c < 8; ++c) {
    int* d = data + c;
    JLONG tmp0 = d[0] + d[56], tmp7 = d[0] - d[56];
    JLONG tmp1 = d[8] + d[48], tmp6 = d[8] - d[48];
    JLONG tmp2 = d[16] + d[40], tmp5 = d[16] - d[40];
    JLONG tmp3 = d[24] + d[32], tmp4 = d[24] - d[32];
    JLONG tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    JLONG tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    d[0] = static_cast<int>(DESCALE(tmp10 + tmp11, PASS1_BITS));
    d[32] = static_cast<int>(DESCALE(tmp10 - tmp11, PASS1_BITS));
    JLONG z1 = (tmp12 + tmp13) * 4433;
    d[16] = static_cast<int>(DESCALE(z1 + tmp13 * 6270, CONST_BITS + PASS1_BITS));
    d[48] = static_cast<int>(DESCALE(z1 + tmp12 * -15137, CONST_BITS + PASS1_BITS));
    z1 = tmp4 + tmp7;
    JLONG z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    JLONG z5 = (z3 + z4) * 9633;
    tmp4 *= 2446;
    tmp5 *= 16819;
    tmp6 *= 25172;
    tmp7 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    d[56] = static_cast<int>(DESCALE(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS));
    d[40] = static_cast<int>(DESCALE(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS));
    d[24] = static_cast<int>(DESCALE(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS));
    d[8] = static_cast<int>(DESCALE(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS));
  }
}

// jcdctmgr.c compute_reciprocal / quantize with 16-bit DCTELEMs (the SIMD
// build): (|x| + correction) * reciprocal >> shift, sign restored.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  Divisor d;
  if (divisor == 1) return {1, 0, 0};
  int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor;
  uint32_t fr = (1u << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  d.recip = fq;
  d.corr = c;
  d.shift = r;
  return d;
}

inline int quantize(int x, const Divisor& d) {
  uint32_t a = static_cast<uint32_t>(x < 0 ? -x : x);
  uint32_t v = static_cast<uint32_t>((static_cast<uint64_t>(static_cast<uint16_t>(a + d.corr)) * d.recip) >> d.shift);
  int q = static_cast<int>(static_cast<uint16_t>(v));
  return x < 0 ? -q : q;
}

struct Plane {
  int w = 0, h = 0;  // padded to whole blocks (and iMCU rows)
  std::vector<uint8_t> px;
  uint8_t at(int x, int y) const { return px[static_cast<size_t>(y) * w + x]; }
};

int nbits_of(int v) {
  int a = v < 0 ? -v : v;
  int n = 0;
  while (a) {
    ++n;
    a >>= 1;
  }
  return n;
}

void encode_block(Sink& s, const int* q, int& last_dc, const HuffCodes& dc,
                  const HuffCodes& ac) {
  int diff = q[0] - last_dc;
  last_dc = q[0];
  int nb = nbits_of(diff);
  s.bits(dc.code[nb], dc.size[nb]);
  if (nb) s.bits(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), nb);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = q[kZigzag[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      s.bits(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    nb = nbits_of(v);
    int sym = (run << 4) | nb;
    s.bits(ac.code[sym], ac.size[sym]);
    s.bits(static_cast<uint32_t>(v < 0 ? v - 1 : v), nb);
    run = 0;
  }
  if (run > 0) s.bits(ac.code[0x00], ac.size[0x00]);
}

void write_dqt(Sink& s, int index, const int* table) {
  s.word(0xFFDB);
  s.word(67);
  s.byte(index);
  for (int k = 0; k < 64; ++k) s.byte(table[kZigzag[k]]);
}

void write_dht(Sink& s, int cls_index, const uint8_t* bits, const uint8_t* vals) {
  int n = 0;
  for (int i = 0; i < 16; ++i) n += bits[i];
  s.word(0xFFC4);
  s.word(2 + 1 + 16 + n);
  s.byte(cls_index);
  for (int i = 0; i < 16; ++i) s.byte(bits[i]);
  for (int i = 0; i < n; ++i) s.byte(vals[i]);
}

}  // namespace

extern "C" {

long jpeg_encode(const unsigned char* rgb, int height, int width, int quality,
                 unsigned char* out, long out_capacity) {
  if (!rgb || height <= 0 || width <= 0 || height > 65535 || width > 65535) return -1;
  // jpeg_quality_scaling + jpeg_add_quant_table(force_baseline=TRUE)
  quality = std::min(std::max(quality, 1), 100);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  int qt[2][64];
  for (int i = 0; i < 64; ++i) {
    long l = (static_cast<long>(kLumaQuant[i]) * scale + 50) / 100;
    long c = (static_cast<long>(kChromaQuant[i]) * scale + 50) / 100;
    qt[0][i] = static_cast<int>(std::min(std::max(l, 1L), 255L));
    qt[1][i] = static_cast<int>(std::min(std::max(c, 1L), 255L));
  }
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = reciprocal(static_cast<uint32_t>(qt[t][i]) << 3);

  // geometry (jcmaster.c initial_setup, 4:2:0)
  const int mcus_x = (width + 15) / 16, mcus_y = (height + 15) / 16;
  const int luma_wib = (width + 7) / 8, luma_hib = (height + 7) / 8;
  const int cw = (width + 1) / 2, ch = (height + 1) / 2;
  const int chroma_wib = (cw + 7) / 8, chroma_hib = (ch + 7) / 8;

  // colour conversion (jccolor.c rgb_ycc_convert), SCALEBITS 16
  const int kScale = 16;
  auto fix = [&](double v) { return static_cast<int32_t>(v * (1 << kScale) + 0.5); };
  const int32_t half = 1 << (kScale - 1), cbcr_offset = 128 << kScale;
  int32_t tab[8][256];
  for (int i = 0; i < 256; ++i) {
    tab[0][i] = fix(0.29900) * i;
    tab[1][i] = fix(0.58700) * i;
    tab[2][i] = fix(0.11400) * i + half;
    tab[3][i] = -fix(0.16874) * i;
    tab[4][i] = -fix(0.33126) * i;
    tab[5][i] = fix(0.50000) * i + cbcr_offset + half - 1;  // B->Cb and R->Cr
    tab[6][i] = -fix(0.41869) * i;
    tab[7][i] = -fix(0.08131) * i;
  }
  // full-resolution planes padded: columns to the downsampler's reach
  // (chroma_wib * 16), rows to the image height rounded up to even
  // (jcprepct.c pads the conversion buffer to max_v_samp_factor rows)
  const int fw = std::max(chroma_wib * 16, luma_wib * 8);
  const int fh = height + (height & 1);
  Plane Y, Cb, Cr;
  for (Plane* p : {&Y, &Cb, &Cr}) {
    p->w = fw;
    p->h = fh;
    p->px.resize(static_cast<size_t>(fw) * fh);
  }
  for (int y = 0; y < fh; ++y) {
    const unsigned char* src = rgb + static_cast<size_t>(std::min(y, height - 1)) * width * 3;
    uint8_t* py = &Y.px[static_cast<size_t>(y) * fw];
    uint8_t* pb = &Cb.px[static_cast<size_t>(y) * fw];
    uint8_t* pr = &Cr.px[static_cast<size_t>(y) * fw];
    for (int x = 0; x < width; ++x) {
      int r = src[3 * x], g = src[3 * x + 1], b = src[3 * x + 2];
      py[x] = static_cast<uint8_t>((tab[0][r] + tab[1][g] + tab[2][b]) >> kScale);
      pb[x] = static_cast<uint8_t>((tab[3][r] + tab[4][g] + tab[5][b]) >> kScale);
      pr[x] = static_cast<uint8_t>((tab[5][r] + tab[6][g] + tab[7][b]) >> kScale);
    }
    for (int x = width; x < fw; ++x) {  // expand_right_edge
      py[x] = py[width - 1];
      pb[x] = pb[width - 1];
      pr[x] = pr[width - 1];
    }
  }
  // luma blocks read rows up to luma_hib*8 (rows past fh repeat the last);
  // chroma by h2v2_downsample, then rows past ch repeat the last
  auto luma = [&](int x, int y) { return Y.at(x, std::min(y, fh - 1)); };
  const int cpw = chroma_wib * 8, cph = std::max(chroma_hib * 8, ch);
  Plane C[2];
  for (int k = 0; k < 2; ++k) {
    const Plane& src = k ? Cr : Cb;
    C[k].w = cpw;
    C[k].h = cph;
    C[k].px.resize(static_cast<size_t>(cpw) * cph);
    for (int y = 0; y < cph; ++y) {
      int sy = std::min(y, ch - 1) * 2;
      uint8_t* o = &C[k].px[static_cast<size_t>(y) * cpw];
      int bias = 1;
      for (int x = 0; x < cpw; ++x) {
        int v = src.at(2 * x, sy) + src.at(2 * x + 1, sy) + src.at(2 * x, sy + 1) +
                src.at(2 * x + 1, sy + 1);
        o[x] = static_cast<uint8_t>((v + bias) >> 2);
        bias ^= 3;
      }
    }
  }

  Sink s{out, out_capacity};
  s.word(0xFFD8);
  // JFIF APP0: version 1.01, aspect 1:1, no thumbnail
  s.word(0xFFE0);
  s.word(16);
  const char jfif[5] = {'J', 'F', 'I', 'F', 0};
  for (char ch5 : jfif) s.byte(ch5);
  s.byte(1);
  s.byte(1);
  s.byte(0);
  s.word(1);
  s.word(1);
  s.byte(0);
  s.byte(0);
  write_dqt(s, 0, qt[0]);
  write_dqt(s, 1, qt[1]);
  // SOF0
  s.word(0xFFC0);
  s.word(17);
  s.byte(8);
  s.word(height);
  s.word(width);
  s.byte(3);
  s.byte(1); s.byte(0x22); s.byte(0);
  s.byte(2); s.byte(0x11); s.byte(1);
  s.byte(3); s.byte(0x11); s.byte(1);
  write_dht(s, 0x00, kDcLumaBits, kDcLumaVals);
  write_dht(s, 0x10, kAcLumaBits, kAcLumaVals);
  write_dht(s, 0x01, kDcChromaBits, kDcChromaVals);
  write_dht(s, 0x11, kAcChromaBits, kAcChromaVals);
  // SOS
  s.word(0xFFDA);
  s.word(12);
  s.byte(3);
  s.byte(1); s.byte(0x00);
  s.byte(2); s.byte(0x11);
  s.byte(3); s.byte(0x11);
  s.byte(0);
  s.byte(63);
  s.byte(0);

  static const HuffCodes dc_l = make_codes(kDcLumaBits, kDcLumaVals);
  static const HuffCodes ac_l = make_codes(kAcLumaBits, kAcLumaVals);
  static const HuffCodes dc_c = make_codes(kDcChromaBits, kDcChromaVals);
  static const HuffCodes ac_c = make_codes(kAcChromaBits, kAcChromaVals);
  int last_dc[3] = {0, 0, 0};
  int work[64], q[64];

  auto forward = [&](auto sample, int t) {
    for (int i = 0; i < 64; ++i) work[i] = sample(i & 7, i >> 3) - 128;
    fdct_islow(work);
    for (int i = 0; i < 64; ++i) q[i] = quantize(work[i], div[t][i]);
  };
  auto dummy = [&](int dc_value) {
    std::fill(q, q + 64, 0);
    q[0] = dc_value;
  };
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      // luma: 2x2 blocks; a block past the image's blocks is a dummy that
      // carries the DC of the block before it in the MCU: the one to its
      // left, or for a bottom row the last of the row above
      // (jccoefct.c compress_data)
      int prev_dc = 0;
      for (int v = 0; v < 2; ++v) {
        for (int h = 0; h < 2; ++h) {
          int bx = mx * 2 + h, by = my * 2 + v;
          if (by < luma_hib && bx < luma_wib)
            forward([&](int x, int y) { return luma(bx * 8 + x, by * 8 + y); }, 0);
          else
            dummy(prev_dc);
          prev_dc = q[0];
          encode_block(s, q, last_dc[0], dc_l, ac_l);
        }
      }
      // chroma: one block per MCU, always inside its chroma_wib x chroma_hib
      for (int k = 0; k < 2; ++k) {
        const Plane& p = C[k];
        forward([&](int x, int y) { return p.at(mx * 8 + x, my * 8 + y); }, 1);
        encode_block(s, q, last_dc[1 + k], dc_c, ac_c);
      }
    }
  }
  s.flush();
  s.word(0xFFD9);
  return s.n;
}

}  // extern "C"
