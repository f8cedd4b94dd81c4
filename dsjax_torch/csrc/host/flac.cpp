// Copy of dsjax/cpp/src/flac.cpp, built into the port's own host library
// so that dsjax_torch imports nothing of dsjax.
//
// Minimal native FLAC decoder.
//
// Replaces the sox/torchaudio dependency the reference uses to convert
// LibriSpeech flac -> wav (reference: data/librispeech.py:40-56,
// Dockerfile sox install). Supports the full FLAC subset LibriSpeech-style
// encoders emit: CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32) subframes,
// RICE and RICE2 residual partitions, all stereo decorrelation modes,
// 8/16/24-bit samples. CRC checks are skipped (input is trusted local data).
//
// C ABI: ds_flac_decode(path, out_samples**, out_n, out_channels, out_rate)
// returning interleaved int32 samples scaled to the declared bit depth.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte_pos = 0;
  int bit_pos = 0;  // 0..7, MSB first
  bool error = false;

  uint32_t read_bit() {
    if (byte_pos >= size) {
      error = true;
      return 0;
    }
    uint32_t b = (data[byte_pos] >> (7 - bit_pos)) & 1u;
    if (++bit_pos == 8) {
      bit_pos = 0;
      ++byte_pos;
    }
    return b;
  }

  uint64_t read_bits(int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | read_bit();
    return v;
  }

  int64_t read_signed(int n) {
    uint64_t v = read_bits(n);
    if (n > 0 && (v >> (n - 1)) & 1u) v |= ~((1ull << n) - 1);  // sign-extend
    return (int64_t)v;
  }

  uint32_t read_unary() {
    uint32_t q = 0;
    while (!error && read_bit() == 0) ++q;
    return q;
  }

  void align() {
    if (bit_pos) {
      bit_pos = 0;
      ++byte_pos;
    }
  }
};

// UTF-8-style coded number in frame header
uint64_t read_coded_number(BitReader& br) {
  uint64_t b0 = br.read_bits(8);
  int n_extra = 0;
  uint64_t v = 0;
  if ((b0 & 0x80) == 0) return b0;
  for (int mask = 0x40; b0 & mask; mask >>= 1) ++n_extra;
  v = b0 & ((1u << (7 - n_extra)) - 1);
  // n_extra CONTINUATION bytes follow the leader (frame numbers >= 128
  // use the 2-byte form; reading one byte short desynced every later
  // field of long fixed-blocksize streams)
  for (int i = 0; i < n_extra; ++i) v = (v << 6) | (br.read_bits(8) & 0x3F);
  return v;
}

const int kFixedOrders[5] = {0, 1, 2, 3, 4};

bool decode_residual(BitReader& br, int blocksize, int pred_order,
                     std::vector<int64_t>& out) {
  int method = (int)br.read_bits(2);
  if (method > 1) return false;
  int param_bits = method == 0 ? 4 : 5;
  int escape = method == 0 ? 0xF : 0x1F;
  int part_order = (int)br.read_bits(4);
  int n_parts = 1 << part_order;
  if (blocksize % n_parts != 0) return false;
  int samples_per_part = blocksize >> part_order;
  int idx = pred_order;
  for (int p = 0; p < n_parts; ++p) {
    int count = samples_per_part - (p == 0 ? pred_order : 0);
    if (count < 0) return false;
    int param = (int)br.read_bits(param_bits);
    if (param == escape) {
      int raw_bits = (int)br.read_bits(5);
      for (int i = 0; i < count; ++i) out[idx++] = br.read_signed(raw_bits);
    } else {
      for (int i = 0; i < count; ++i) {
        uint32_t q = br.read_unary();
        uint64_t r = br.read_bits(param);
        uint64_t u = ((uint64_t)q << param) | r;
        out[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);  // unzigzag
      }
    }
    if (br.error) return false;
  }
  return true;
}

bool decode_subframe(BitReader& br, int blocksize, int bps,
                     std::vector<int64_t>& out) {
  if (br.read_bit() != 0) return false;  // padding bit
  int type = (int)br.read_bits(6);
  int wasted = 0;
  if (br.read_bit()) wasted = 1 + (int)br.read_unary();
  bps -= wasted;
  out.assign(blocksize, 0);

  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < blocksize; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; ++i) out[i] = br.read_signed(bps);
  } else if (type >= 8 && type <= 12) {  // FIXED
    int order = type - 8;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    if (!decode_residual(br, blocksize, order, out)) return false;
    // apply fixed predictor
    for (int i = order; i < blocksize; ++i) {
      switch (order) {
        case 0: break;
        case 1: out[i] += out[i - 1]; break;
        case 2: out[i] += 2 * out[i - 1] - out[i - 2]; break;
        case 3: out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3]; break;
        case 4: out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] -
                          out[i - 4]; break;
      }
    }
  } else if (type >= 32) {  // LPC
    int order = type - 31;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    int precision = (int)br.read_bits(4) + 1;
    if (precision == 16) return false;  // 0b1111 invalid
    int shift = (int)br.read_signed(5);
    if (shift < 0) shift = 0;
    std::vector<int64_t> coefs(order);
    for (int i = 0; i < order; ++i) coefs[i] = br.read_signed(precision);
    if (!decode_residual(br, blocksize, order, out)) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t acc = 0;
      for (int j = 0; j < order; ++j) acc += coefs[j] * out[i - 1 - j];
      out[i] += acc >> shift;
    }
  } else {
    return false;
  }
  if (wasted) {
    for (int i = 0; i < blocksize; ++i) out[i] <<= wasted;
  }
  return !br.error;
}

}  // namespace

static int flac_decode_impl(const char* path, int32_t** out_samples,
                            int64_t* out_n, int* out_channels, int* out_rate,
                            int* out_bps) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(fsize);
  if (fread(buf.data(), 1, fsize, f) != (size_t)fsize) {
    fclose(f);
    return 1;
  }
  fclose(f);
  if (fsize < 42 || memcmp(buf.data(), "fLaC", 4) != 0) return 2;

  size_t pos = 4;
  int sample_rate = 0, channels = 0, bps = 0;
  uint64_t total_samples = 0;
  bool last = false;
  bool have_streaminfo = false;
  while (!last && pos + 4 <= (size_t)fsize) {
    uint8_t hdr = buf[pos];
    last = hdr & 0x80;
    int type = hdr & 0x7F;
    uint32_t len = (buf[pos + 1] << 16) | (buf[pos + 2] << 8) | buf[pos + 3];
    pos += 4;
    if (pos + len > (size_t)fsize) return 3;  // truncated metadata block
    if (type == 0 && len >= 34) {  // STREAMINFO
      const uint8_t* s = buf.data() + pos;
      sample_rate = (s[10] << 12) | (s[11] << 4) | (s[12] >> 4);
      channels = ((s[12] >> 1) & 0x7) + 1;
      bps = (((s[12] & 1) << 4) | (s[13] >> 4)) + 1;
      total_samples = ((uint64_t)(s[13] & 0xF) << 32) | ((uint64_t)s[14] << 24) |
                      (s[15] << 16) | (s[16] << 8) | s[17];
      have_streaminfo = true;
    }
    pos += len;
  }
  if (!have_streaminfo || sample_rate == 0) return 3;

  std::vector<int32_t> pcm;
  // reserve is only a hint: clamp it by the compressed size (FLAC can't
  // expand much beyond ~4 samples/byte even for constant frames), so a
  // crafted 36-bit total_samples can't request terabytes up front
  if (total_samples) {
    uint64_t want = total_samples * (uint64_t)channels;
    uint64_t cap = (uint64_t)fsize * 4 + 65536;
    pcm.reserve((size_t)(want < cap ? want : cap));
  }

  BitReader br{buf.data(), (size_t)fsize};
  br.byte_pos = pos;

  static const int kBlockSizes[16] = {0, 192, 576, 1152, 2304, 4608, -1, -2,
                                      256, 512, 1024, 2048, 4096, 8192, 16384,
                                      32768};
  static const int kRates[16] = {0, 88200, 176400, 192000, 8000, 16000, 22050,
                                 24000, 32000, 44100, 48000, 96000, -1, -2, -3,
                                 0};

  std::vector<std::vector<int64_t>> chans(channels);
  while (br.byte_pos + 2 < (size_t)fsize && !br.error) {
    // frame sync
    if (br.read_bits(14) != 0x3FFE) break;
    br.read_bit();                        // reserved
    br.read_bit();                        // blocking strategy
    int bs_code = (int)br.read_bits(4);
    int sr_code = (int)br.read_bits(4);
    int ch_asgn = (int)br.read_bits(4);
    int ss_code = (int)br.read_bits(3);
    br.read_bit();  // reserved
    read_coded_number(br);
    int blocksize;
    if (bs_code == 6) blocksize = (int)br.read_bits(8) + 1;
    else if (bs_code == 7) blocksize = (int)br.read_bits(16) + 1;
    else blocksize = kBlockSizes[bs_code];
    if (sr_code == 12) br.read_bits(8);
    else if (sr_code == 13 || sr_code == 14) br.read_bits(16);
    (void)kRates;
    int frame_bps = bps;
    static const int kBps[8] = {0, 8, 12, 0, 16, 20, 24, 32};
    if (ss_code != 0 && kBps[ss_code]) frame_bps = kBps[ss_code];
    br.read_bits(8);  // CRC-8
    if (blocksize <= 0 || br.error) return 4;

    int n_ch = channels;
    bool left_side = false, right_side = false, mid_side = false;
    if (ch_asgn >= 8) {
      n_ch = 2;
      left_side = ch_asgn == 8;
      right_side = ch_asgn == 9;
      mid_side = ch_asgn == 10;
      if (ch_asgn > 10) return 4;
      if (channels != 2) return 4;  // decorrelated frames are stereo-only
    } else {
      n_ch = ch_asgn + 1;
      if (n_ch != channels) return 4;
    }
    for (int c = 0; c < n_ch; ++c) {
      int sub_bps = frame_bps;
      // side channel carries one extra bit
      if ((left_side && c == 1) || (right_side && c == 0) ||
          (mid_side && c == 1))
        sub_bps += 1;
      if ((int)chans.size() < n_ch) chans.resize(n_ch);
      if (!decode_subframe(br, blocksize, sub_bps, chans[c])) return 5;
    }
    br.align();
    br.read_bits(16);  // CRC-16

    // stereo decorrelation
    if (left_side) {
      for (int i = 0; i < blocksize; ++i) chans[1][i] = chans[0][i] - chans[1][i];
    } else if (right_side) {
      for (int i = 0; i < blocksize; ++i) chans[0][i] = chans[0][i] + chans[1][i];
    } else if (mid_side) {
      for (int i = 0; i < blocksize; ++i) {
        int64_t mid = chans[0][i], side = chans[1][i];
        mid = (mid << 1) | (side & 1);
        chans[0][i] = (mid + side) >> 1;
        chans[1][i] = (mid - side) >> 1;
      }
    }
    for (int i = 0; i < blocksize; ++i)
      for (int c = 0; c < n_ch; ++c) pcm.push_back((int32_t)chans[c][i]);
    if (total_samples && pcm.size() >= total_samples * channels) break;
  }

  if (total_samples && pcm.size() > total_samples * channels)
    pcm.resize(total_samples * channels);
  auto* out = (int32_t*)malloc(pcm.size() * sizeof(int32_t));
  memcpy(out, pcm.data(), pcm.size() * sizeof(int32_t));
  *out_samples = out;
  *out_n = (int64_t)(pcm.size() / channels);
  *out_channels = channels;
  *out_rate = sample_rate;
  *out_bps = bps;
  return 0;
}

extern "C" {

// Returns 0 on success. Caller frees *out_samples with ds_flac_free.
int ds_flac_decode(const char* path, int32_t** out_samples, int64_t* out_n,
                   int* out_channels, int* out_rate, int* out_bps) {
  // exception firewall: a std::bad_alloc (decompression bomb) or any other
  // C++ exception must not cross the ctypes FFI boundary (std::terminate)
  try {
    return flac_decode_impl(path, out_samples, out_n, out_channels, out_rate,
                            out_bps);
  } catch (...) {
    return 6;
  }
}

void ds_flac_free(int32_t* p) { free(p); }

}  // extern "C"
