// Native host-runtime components of asr_study_torch: a copy of the JAX
// package's native/asr_native.cc (the same five entry points, the same
// code but the WAV reader's, see below), so that the port loads a library
// of its own and never the JAX package's native/libasrnative.so.
//
// The host hot loops: WAV decode, padded-batch assembly, the dpack wire's
// encode and host-side Levenshtein for corpus-scale WER.  Exposed as a plain
// C ABI for ctypes.
//
// Build: asr_study_torch/utils/native.py compiles it with g++ at its first
// use into build/native-<hash>/libasrnative.so (the hash covers this source
// and the flags).

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <climits>
#include <memory>
#include <vector>

// ---------------------------------------------------------------------------
// WAV (RIFF/WAVE) decode
// ---------------------------------------------------------------------------

// The port's reader differs from the original's: it takes every encoding
// that features/wav.py read_wav_plain takes (PCM 8/16/24/32, IEEE float
// 32/64, the extensible format tag, the fmt and data chunks in either
// order), so read_wav has no other route; it reads the file by pread into
// one block buffer, and converts the data chunk a block at a time in loops
// the compiler vectorises.  A mono file decodes to read_wav_plain's
// samples bit for bit (each is one exact power-of-two scaling of the int,
// or a float32 rounding); channels are averaged in double.

namespace {

inline uint32_t rd_u32(const unsigned char* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}

// sample c of frame i of a block, as read_wav_plain's float32
struct PCM8 {
  static constexpr int kBytes = 1;
  static float at(const unsigned char* p) {
    return ((float)p[0] - 128.0f) * (1.0f / 128.0f);
  }
};
struct PCM16 {
  static constexpr int kBytes = 2;
  static float at(const unsigned char* p) {
    int16_t v;
    std::memcpy(&v, p, 2);
    return (float)v * (1.0f / 32768.0f);
  }
};
struct PCM24 {
  static constexpr int kBytes = 3;
  static float at(const unsigned char* p) {
    int32_t v = (int32_t)((uint32_t)p[0] << 8 | (uint32_t)p[1] << 16 |
                          (uint32_t)p[2] << 24) >> 8;
    return (float)v * (1.0f / 8388608.0f);
  }
};
struct PCM32 {
  static constexpr int kBytes = 4;
  static float at(const unsigned char* p) {
    int32_t v;
    std::memcpy(&v, p, 4);
    return (float)v * (1.0f / 2147483648.0f);
  }
};
struct F32 {
  static constexpr int kBytes = 4;
  static float at(const unsigned char* p) {
    float v;
    std::memcpy(&v, p, 4);
    return v;
  }
};
struct F64 {
  static constexpr int kBytes = 8;
  static float at(const unsigned char* p) {
    double v;
    std::memcpy(&v, p, 8);
    return (float)v;
  }
};

template <class S>
void convert(const unsigned char* src, long frames, long channels,
             float* out) {
  if (channels == 1) {
    for (long i = 0; i < frames; ++i) out[i] = S::at(src + i * S::kBytes);
    return;
  }
  for (long i = 0; i < frames; ++i) {
    double acc = 0.0;
    for (long c = 0; c < channels; ++c)
      acc += S::at(src + (i * channels + c) * S::kBytes);
    out[i] = (float)(acc / channels);
  }
}

// The file through one block buffer filled by pread, no stdio: a file
// that fits the block costs three system calls (open, pread, close).  The
// buffer is the calling thread's, kept from call to call, so a read
// neither allocates nor faults in fresh pages.
thread_local long tl_cap = 0;
thread_local std::unique_ptr<unsigned char[]> tl_buf;

struct Blocks {
  int fd;
  unsigned char* buf = grow(120 << 10);
  long off = 0, len = 0;  // buf holds the file's bytes [off, off + len)
  static unsigned char* grow(long n) {
    if (n > tl_cap) tl_buf.reset(new unsigned char[tl_cap = n]);
    return tl_buf.get();
  }
  // bytes [pos, pos + n) of the file, or nullptr past its end
  const unsigned char* at(long pos, long n) {
    if (pos < off || pos + n > off + len) {
      buf = grow(n);
      long got = pread(fd, buf, tl_cap, pos);
      off = pos;
      len = got > 0 ? got : 0;
      if (n > len) return nullptr;
    }
    return buf + (pos - off);
  }
};

}  // namespace

extern "C" {

// Reads the data chunk of `path` into out[0..max_samples), converted to
// float32 in [-1, 1] and averaged over channels.  Returns the number of
// samples written, or a negative error code:
//   -1 cannot open, -2 not RIFF/WAVE, -3 no fmt or no data chunk,
//   -4 another format tag (*sr_out receives the tag),
//   -5 out too small (*sr_out receives the samples it needs),
//   -6 a PCM bit depth other than 8/16/24/32 (*sr_out receives it).
// *sr_out otherwise receives the sample rate.  A data chunk declared past
// the file's end decodes to the whole frames that are there.
long asr_read_wav(const char* path, float* out, long max_samples,
                  int* sr_out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  Blocks f{fd};
  const unsigned char* hdr = f.at(0, 12);
  if (!hdr || std::memcmp(hdr, "RIFF", 4) || std::memcmp(hdr + 8, "WAVE", 4)) {
    close(fd);
    return -2;
  }
  uint32_t tag = 0, channels = 0, bits = 0, sample_rate = 0;
  bool have_fmt = false, have_data = false;
  long pos = 12, data_pos = 0;
  uint32_t data_size = 0;
  // the chunk walk of read_wav_plain: each chunk padded to even, the last
  // fmt before the stop wins, stop once both chunks were seen
  while (!(have_fmt && have_data)) {
    const unsigned char* ch = f.at(pos, 8);
    if (!ch) break;
    uint32_t size = rd_u32(ch + 4);
    if (!std::memcmp(ch, "fmt ", 4)) {
      const unsigned char* fmt = f.at(pos + 8, std::min<uint32_t>(size, 26));
      if (size < 16 || !fmt) break;
      tag = fmt[0] | (fmt[1] << 8);
      channels = fmt[2] | (fmt[3] << 8);
      sample_rate = rd_u32(fmt + 4);
      bits = fmt[14] | (fmt[15] << 8);
      if (tag == 0xFFFE && size >= 26) tag = fmt[24] | (fmt[25] << 8);
      have_fmt = true;
    } else if (!std::memcmp(ch, "data", 4)) {
      data_pos = pos + 8;
      data_size = size;
      have_data = true;
    }
    pos += 8 + (long)size + (size & 1);
  }
  long code = 0;
  void (*conv)(const unsigned char*, long, long, float*) = nullptr;
  int bytes = 0;
  if (!have_fmt || !have_data) {
    code = -3;
  } else if (tag == 3) {
    if (bits == 32) { conv = convert<F32>; bytes = 4; }
    else { conv = convert<F64>; bytes = 8; }
  } else if (tag == 1) {
    switch (bits) {
      case 8: conv = convert<PCM8>; bytes = 1; break;
      case 16: conv = convert<PCM16>; bytes = 2; break;
      case 24: conv = convert<PCM24>; bytes = 3; break;
      case 32: conv = convert<PCM32>; bytes = 4; break;
      default: code = -6; sample_rate = bits;
    }
  } else {
    code = -4;
    sample_rate = tag;
  }
  if (sr_out) *sr_out = (int)sample_rate;
  if (code) {
    close(fd);
    return code;
  }
  // a channel count of 0 reads as mono, as in read_wav_plain
  long n_ch = channels ? channels : 1;
  long frame = bytes * n_ch;
  long left = data_size / frame, n_out = 0;
  if (left > max_samples) {
    // out too small for the declared chunk: the file's size says whether
    // the frames are there
    struct stat st;
    if (fstat(fd, &st) == 0)
      left = std::min(left, std::max<long>(0, (st.st_size - data_pos) / frame));
    if (left > max_samples) {
      if (sr_out) *sr_out = (int)std::min<long>(left, INT_MAX);
      close(fd);
      return -5;
    }
  }
  pos = data_pos;
  while (left > 0) {
    // the whole frames the buffer holds from pos, else a read from pos
    long have = f.off + f.len - pos;
    if (pos < f.off || have < frame) {
      if (!f.at(pos, frame)) break;
      have = f.len;
    }
    long frames = std::min(left, have / frame);
    conv(f.buf + (pos - f.off), frames, n_ch, out + n_out);
    n_out += frames;
    left -= frames;
    pos += frames * frame;
  }
  close(fd);
  return n_out;
}

// ---------------------------------------------------------------------------
// Padded batch assembly
// ---------------------------------------------------------------------------

// Packs `n_rows` variable-length [len_i, feat_dim] rows (concatenated in
// `src`, row i starting at element offsets[i]*feat_dim) into the
// zero-initialized dense [n_rows, t_pad, feat_dim] buffer `out`.
void asr_pack_batch(const float* src, const int64_t* offsets,
                    const int64_t* lens, int64_t n_rows, int64_t t_pad,
                    int64_t feat_dim, float* out) {
  for (int64_t i = 0; i < n_rows; ++i) {
    int64_t t = std::min(lens[i], t_pad);
    std::memcpy(out + i * t_pad * feat_dim,
                src + offsets[i] * feat_dim,
                (size_t)(t * feat_dim) * sizeof(float));
  }
}

// Like asr_pack_batch, but fully defines `out` [out_rows, t_pad, feat_dim]:
// each row's padded tail and every row beyond n_rows are zeroed, so the
// caller can pass an uninitialized buffer (saves a full-buffer zero + copy
// per batch on the streaming path).
void asr_pack_batch_full(const float* src, const int64_t* offsets,
                         const int64_t* lens, int64_t n_rows,
                         int64_t out_rows, int64_t t_pad, int64_t feat_dim,
                         float* out) {
  for (int64_t i = 0; i < n_rows; ++i) {
    int64_t t = std::min(lens[i], t_pad);
    float* row = out + i * t_pad * feat_dim;
    std::memcpy(row, src + offsets[i] * feat_dim,
                (size_t)(t * feat_dim) * sizeof(float));
    std::memset(row + t * feat_dim, 0,
                (size_t)((t_pad - t) * feat_dim) * sizeof(float));
  }
  if (out_rows > n_rows) {
    std::memset(out + n_rows * t_pad * feat_dim, 0,
                (size_t)((out_rows - n_rows) * t_pad * feat_dim) *
                    sizeof(float));
  }
}

// ---------------------------------------------------------------------------
// dpack wire codec: lossless delta + per-block bit-packing (encode side)
// ---------------------------------------------------------------------------

// Transposes a 16x16 bit matrix in place (Hacker's Delight transpose32
// specialized to 16 lanes): out word p bit i = in word i bit p.
static inline void transpose16x16(uint16_t x[16]) {
  uint32_t m = 0x00FF;
  for (int j = 8; j != 0; j >>= 1, m ^= (m << j)) {
    for (int k = 0; k < 16; k = (k + j + 1) & ~j) {
      uint32_t t = (x[k] ^ (x[k + j] >> j)) & m;
      x[k] = (uint16_t)(x[k] ^ t);
      x[k + j] = (uint16_t)(x[k + j] ^ (t << j));
    }
  }
}

// Encodes a concatenated int16 sample stream for the dpack wire codec
// (data/wire.py): per 4096-sample block, int16-wraparound deltas are
// zigzagged and stored as w BIT PLANES of 256 words each (v2 layout:
// plane p, word m, bit i = bit p of sample 256*i + m), w = the block
// max's bit-length.  The v2 orientation makes the decoded [16, 256]
// block land in flat sample order row-major — the order the decode
// kernel (csrc/dpack_onepass.cu) writes — where v1's 16m+i order needed
// a transpose.  The symbol carries the layout version (the original's
// name, kept).
// `widths` receives ceil(n/4096) entries; `payload` must hold
// ceil(n/4096)*4096 uint16 words (worst case w=16, partial final block
// included).  Returns the payload word count.  Byte-identical to the
// NumPy encoder (data/wire.py, use_native=False).  The plane transpose
// of each 16-sample group is one 16x16 bit-matrix transpose (log-depth
// swap network), not a per-bit loop.
long asr_dpack_encode_v2(const int16_t* s, long n, uint8_t* widths,
                         uint16_t* payload) {
  const long kBlock = 4096;
  const long kWords = kBlock / 16;   // 256 words per plane
  long nb = (n + kBlock - 1) / kBlock;
  long out = 0;
  int16_t prev = 0;
  for (long b = 0; b < nb; ++b) {
    long lo = b * kBlock;
    long hi = std::min(n, lo + kBlock);
    uint16_t u[4096];
    uint32_t mx = 0;
    for (long i = lo; i < hi; ++i) {
      int32_t d = (int16_t)(uint16_t)((uint16_t)s[i] - (uint16_t)prev);
      prev = s[i];
      uint32_t z = (uint32_t)((d << 1) ^ (d >> 31));
      u[i - lo] = (uint16_t)z;
      mx |= z;  // same highest set bit as the max
    }
    for (long i = hi - lo; i < kBlock; ++i) u[i] = 0;
    int w = 0;
    while (mx >> w) ++w;
    widths[b] = (uint8_t)w;
    if (w == 0) continue;
    uint16_t* dst = payload + out;
    for (long m = 0; m < kWords; ++m) {
      // out word p bit i must be bit p of group sample i (= block
      // sample 256*i + m).  The swap network above computes the
      // MSB-oriented (anti-)transpose — out[k] bit j = in[15-j] bit
      // [15-k] — so loading samples reversed and reading planes
      // reversed yields the straight LSB transpose.
      uint16_t g[16];
      for (int i = 0; i < 16; ++i) g[i] = u[kWords * (15 - i) + m];
      transpose16x16(g);
      for (int p = 0; p < w; ++p) dst[(long)p * kWords + m] = g[15 - p];
    }
    out += (long)w * kWords;
  }
  return out;
}

// ---------------------------------------------------------------------------
// Levenshtein distance (host WER/CER at corpus scale)
// ---------------------------------------------------------------------------

long asr_levenshtein(const int32_t* a, long la, const int32_t* b, long lb) {
  if (la == 0) return lb;
  if (lb == 0) return la;
  std::vector<long> row(lb + 1);
  for (long j = 0; j <= lb; ++j) row[j] = j;
  for (long i = 0; i < la; ++i) {
    long prev = row[0];
    row[0] = i + 1;
    for (long j = 0; j < lb; ++j) {
      long cur = row[j + 1];
      row[j + 1] = std::min({cur + 1, row[j] + 1,
                             prev + (a[i] != b[j] ? 1 : 0)});
      prev = cur;
    }
  }
  return row[lb];
}

}  // extern "C"
