// Copy of dsjax/cpp/src/audio_decode.cpp, built into the port's own host
// library so that dsjax_torch imports nothing of dsjax.
//
// Native compressed-audio decode: MP3, Ogg/Vorbis, Ogg/Opus, WebM(Opus/Vorbis).
//
// The reference accepts .mp3/.ogg/.webm at the server (reference
// server.py:22-30) and converts CommonVoice mp3 via sox (reference
// data/common_voice.py:22-60) — both through external binaries. Here the
// codec work is done in-process against the system codec libraries
// (libmpg123 / libvorbis(file) / libopus), which are loaded with dlopen at
// first use — no headers, no link-time dependency, graceful absence — while
// the CONTAINER layer (Ogg paging for Opus, WebM/Matroska EBML) is parsed by
// this file directly.
//
// C API (ctypes-bound in dsjax_torch/audio/native.py):
//   ds_audio_decode(data, len, &pcm, &n_frames, &channels, &rate) -> 0 ok
//     pcm: malloc'd interleaved float32, freed with ds_audio_free.
//   ds_audio_formats() -> bitmask of available decoders (1 mp3, 2 vorbis,
//     4 opus) for capability gating.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <dlfcn.h>
#include <vector>
#include <string>

namespace {

// ---------------------------------------------------------------------------
// dlopen helpers
// ---------------------------------------------------------------------------

void *dl_try(const char *const *names) {
    for (const char *const *n = names; *n; ++n) {
        void *h = dlopen(*n, RTLD_NOW | RTLD_GLOBAL);
        if (h) return h;
    }
    return nullptr;
}

template <typename T>
bool sym(void *lib, const char *name, T *out) {
    *out = reinterpret_cast<T>(dlsym(lib, name));
    return *out != nullptr;
}

struct Pcm {
    std::vector<float> data;  // interleaved
    int channels = 0;
    int rate = 0;
};

// ---------------------------------------------------------------------------
// MP3 via libmpg123 (feed API)
// ---------------------------------------------------------------------------

struct Mpg123 {
    void *lib = nullptr;
    int (*init_)();
    void *(*new_)(const char *, int *);
    void (*delete_)(void *);
    int (*open_feed)(void *);
    int (*feed)(void *, const unsigned char *, size_t);
    int (*read)(void *, void *, size_t, size_t *);
    int (*getformat)(void *, long *, int *, int *);
    int (*format_none)(void *);
    int (*format)(void *, long, int, int);
    int (*rates)(const long **, size_t *) = nullptr;  // void in API; optional
    bool ok = false;

    Mpg123() {
        static const char *names[] = {"libmpg123.so.0", "libmpg123.so", nullptr};
        lib = dl_try(names);
        if (!lib) return;
        ok = sym(lib, "mpg123_init", &init_) && sym(lib, "mpg123_new", &new_)
             && sym(lib, "mpg123_delete", &delete_)
             && sym(lib, "mpg123_open_feed", &open_feed)
             && sym(lib, "mpg123_feed", &feed) && sym(lib, "mpg123_read", &read)
             && sym(lib, "mpg123_getformat", &getformat)
             && sym(lib, "mpg123_format_none", &format_none)
             && sym(lib, "mpg123_format", &format);
        if (ok) init_();
    }
};

Mpg123 &mpg123() { static Mpg123 m; return m; }

constexpr int MPG123_OK = 0, MPG123_DONE = -12, MPG123_NEW_FORMAT = -11,
              MPG123_NEED_MORE = -10;
constexpr int MPG123_ENC_SIGNED_16 = 0xD0;  // ENC_16|ENC_SIGNED|0x10

bool decode_mp3(const uint8_t *data, int64_t len, Pcm *out) {
    Mpg123 &m = mpg123();
    if (!m.ok) return false;
    int err = 0;
    void *h = m.new_(nullptr, &err);
    if (!h) return false;
    // constrain output to signed 16-bit at any rate/channel count
    m.format_none(h);
    static const long all_rates[] = {8000, 11025, 12000, 16000, 22050, 24000,
                                     32000, 44100, 48000};
    for (long r : all_rates) m.format(h, r, 3 /*mono|stereo*/, MPG123_ENC_SIGNED_16);
    if (m.open_feed(h) != MPG123_OK) { m.delete_(h); return false; }
    m.feed(h, data, (size_t)len);

    long rate = 0; int channels = 0, enc = 0;
    std::vector<int16_t> buf(16384);
    bool got_format = false;
    for (;;) {
        size_t done = 0;
        int rc = m.read(h, buf.data(), buf.size() * 2, &done);
        if (done) {
            size_t n = done / 2;
            size_t base = out->data.size();
            out->data.resize(base + n);
            for (size_t i = 0; i < n; ++i)
                out->data[base + i] = buf[i] / 32768.0f;
        }
        if (rc == MPG123_NEW_FORMAT) {
            m.getformat(h, &rate, &channels, &enc);
            got_format = true;
        } else if (rc == MPG123_DONE || rc == MPG123_NEED_MORE) {
            break;  // all input was fed up front: NEED_MORE == end of stream
        } else if (rc != MPG123_OK) {
            break;
        }
    }
    m.delete_(h);
    if (!got_format || out->data.empty()) return false;
    out->channels = channels > 0 ? channels : 1;
    out->rate = (int)rate;
    return true;
}

// ---------------------------------------------------------------------------
// Ogg/Vorbis via libvorbisfile (memory callbacks)
// ---------------------------------------------------------------------------

struct MemStream {
    const uint8_t *data;
    int64_t len;
    int64_t pos;
};

extern "C" {
static size_t mem_read(void *ptr, size_t size, size_t nmemb, void *src) {
    MemStream *s = (MemStream *)src;
    int64_t want = (int64_t)(size * nmemb);
    int64_t avail = s->len - s->pos;
    if (want > avail) want = avail;
    if (want <= 0) return 0;
    memcpy(ptr, s->data + s->pos, (size_t)want);
    s->pos += want;
    return (size_t)(want / (int64_t)size);
}
static int mem_seek(void *src, int64_t offset, int whence) {
    MemStream *s = (MemStream *)src;
    int64_t target = whence == SEEK_SET ? offset
                     : whence == SEEK_CUR ? s->pos + offset
                                          : s->len + offset;
    if (target < 0 || target > s->len) return -1;
    s->pos = target;
    return 0;
}
static int mem_close(void *) { return 0; }
static long mem_tell(void *src) { return (long)((MemStream *)src)->pos; }
}  // extern "C"

struct OvCallbacks {
    size_t (*read)(void *, size_t, size_t, void *);
    int (*seek)(void *, int64_t, int);
    int (*close)(void *);
    long (*tell)(void *);
};

struct VorbisInfoHead {  // leading fields of vorbis_info (stable ABI)
    int version;
    int channels;
    long rate;
};

struct VorbisFileLib {
    void *lib = nullptr;
    int (*open_callbacks)(void *, void *, const char *, long, OvCallbacks);
    void *(*info)(void *, int);
    long (*read)(void *, char *, int, int, int, int, int *);
    int (*clear)(void *);
    bool ok = false;

    VorbisFileLib() {
        static const char *names[] = {"libvorbisfile.so.3", "libvorbisfile.so", nullptr};
        lib = dl_try(names);
        if (!lib) return;
        ok = sym(lib, "ov_open_callbacks", &open_callbacks)
             && sym(lib, "ov_info", &info) && sym(lib, "ov_read", &read)
             && sym(lib, "ov_clear", &clear);
    }
};

VorbisFileLib &vorbisfile() { static VorbisFileLib v; return v; }

bool decode_ogg_vorbis(const uint8_t *data, int64_t len, Pcm *out) {
    VorbisFileLib &v = vorbisfile();
    if (!v.ok) return false;
    MemStream ms{data, len, 0};
    // OggVorbis_File is caller-allocated; real size is ~720B — allocate big
    std::vector<uint8_t> vf(8192, 0);
    OvCallbacks cb{mem_read, mem_seek, mem_close, mem_tell};
    if (v.open_callbacks(&ms, vf.data(), nullptr, 0, cb) != 0) return false;
    VorbisInfoHead *vi = (VorbisInfoHead *)v.info(vf.data(), -1);
    if (!vi || vi->channels <= 0) { v.clear(vf.data()); return false; }
    out->channels = vi->channels;
    out->rate = (int)vi->rate;
    std::vector<char> buf(16384);
    int bitstream = 0;
    for (;;) {
        long n = v.read(vf.data(), buf.data(), (int)buf.size(),
                        0 /*LE*/, 2 /*16-bit*/, 1 /*signed*/, &bitstream);
        if (n <= 0) break;
        const int16_t *pcm = (const int16_t *)buf.data();
        size_t cnt = (size_t)n / 2;
        size_t base = out->data.size();
        out->data.resize(base + cnt);
        for (size_t i = 0; i < cnt; ++i) out->data[base + i] = pcm[i] / 32768.0f;
    }
    v.clear(vf.data());
    return !out->data.empty();
}

// ---------------------------------------------------------------------------
// Opus via libopus (container-agnostic packet decoder)
// ---------------------------------------------------------------------------

struct OpusLib {
    void *lib = nullptr;
    void *(*create)(int32_t, int, int *);
    int (*decode_float)(void *, const unsigned char *, int32_t, float *, int, int);
    void (*destroy)(void *);
    bool ok = false;

    OpusLib() {
        static const char *names[] = {"libopus.so.0", "libopus.so", nullptr};
        lib = dl_try(names);
        if (!lib) return;
        ok = sym(lib, "opus_decoder_create", &create)
             && sym(lib, "opus_decode_float", &decode_float)
             && sym(lib, "opus_decoder_destroy", &destroy);
    }
};

OpusLib &opuslib() { static OpusLib o; return o; }

struct OpusHead {
    int channels = 0;
    int preskip = 0;
    bool valid = false;
};

OpusHead parse_opus_head(const uint8_t *p, size_t n) {
    OpusHead h;
    if (n >= 19 && memcmp(p, "OpusHead", 8) == 0) {
        h.channels = p[9];
        h.preskip = p[10] | (p[11] << 8);
        h.valid = h.channels > 0;
    }
    return h;
}

bool decode_opus_packets(const std::vector<std::pair<const uint8_t *, size_t>> &pkts,
                         const OpusHead &head, Pcm *out) {
    OpusLib &o = opuslib();
    if (!o.ok || !head.valid) return false;
    int err = 0;
    void *dec = o.create(48000, head.channels, &err);
    if (!dec) return false;
    std::vector<float> frame(5760 * head.channels);  // 120 ms @ 48 kHz
    for (auto &pk : pkts) {
        int n = o.decode_float(dec, pk.first, (int32_t)pk.second, frame.data(),
                               5760, 0);
        if (n > 0)
            out->data.insert(out->data.end(), frame.begin(),
                             frame.begin() + (size_t)n * head.channels);
    }
    o.destroy(dec);
    // drop the encoder pre-skip samples (a clip shorter than the pre-skip
    // is ALL priming garbage and must come back empty, not as warm-up PCM)
    size_t skip = (size_t)head.preskip * head.channels;
    if (skip)
        out->data.erase(out->data.begin(),
                        out->data.begin() + std::min(skip, out->data.size()));
    out->channels = head.channels;
    out->rate = 48000;
    return !out->data.empty();
}

// ---------------------------------------------------------------------------
// Vorbis packets via libvorbis synthesis API (for WebM/Vorbis)
// ---------------------------------------------------------------------------

struct OggPacket {  // exact libogg ogg_packet layout
    unsigned char *packet;
    long bytes;
    long b_o_s;
    long e_o_s;
    int64_t granulepos;
    int64_t packetno;
};

struct VorbisLib {
    void *lib = nullptr;
    void (*info_init)(void *);
    void (*comment_init)(void *);
    int (*headerin)(void *, void *, OggPacket *);
    int (*synth_init)(void *, void *);
    int (*block_init)(void *, void *);
    int (*synthesis)(void *, OggPacket *);
    int (*blockin)(void *, void *);
    int (*pcmout)(void *, float ***);
    int (*read_)(void *, int);
    void (*info_clear)(void *);
    void (*dsp_clear)(void *);
    void (*block_clear)(void *);
    void (*comment_clear)(void *);
    bool ok = false;

    VorbisLib() {
        static const char *names[] = {"libvorbis.so.0", "libvorbis.so", nullptr};
        lib = dl_try(names);
        if (!lib) return;
        ok = sym(lib, "vorbis_info_init", &info_init)
             && sym(lib, "vorbis_comment_init", &comment_init)
             && sym(lib, "vorbis_synthesis_headerin", &headerin)
             && sym(lib, "vorbis_synthesis_init", &synth_init)
             && sym(lib, "vorbis_block_init", &block_init)
             && sym(lib, "vorbis_synthesis", &synthesis)
             && sym(lib, "vorbis_synthesis_blockin", &blockin)
             && sym(lib, "vorbis_synthesis_pcmout", &pcmout)
             && sym(lib, "vorbis_synthesis_read", &read_)
             && sym(lib, "vorbis_info_clear", &info_clear)
             && sym(lib, "vorbis_dsp_clear", &dsp_clear)
             && sym(lib, "vorbis_block_clear", &block_clear)
             && sym(lib, "vorbis_comment_clear", &comment_clear);
    }
};

VorbisLib &vorbislib() { static VorbisLib v; return v; }

bool decode_vorbis_packets(const std::vector<std::pair<const uint8_t *, size_t>> &headers,
                           const std::vector<std::pair<const uint8_t *, size_t>> &pkts,
                           Pcm *out) {
    VorbisLib &v = vorbislib();
    if (!v.ok || headers.size() < 3) return false;
    // caller-allocated opaque structs: overallocate zeroed storage
    std::vector<uint8_t> vi(1024, 0), vc(1024, 0), vd(8192, 0), vb(8192, 0);
    v.info_init(vi.data());
    v.comment_init(vc.data());
    int64_t pno = 0;
    bool ok = true;
    for (auto &h : headers) {
        OggPacket op{};
        op.packet = const_cast<unsigned char *>(h.first);
        op.bytes = (long)h.second;
        op.b_o_s = pno == 0;
        op.packetno = pno++;
        if (v.headerin(vi.data(), vc.data(), &op) < 0) { ok = false; break; }
    }
    VorbisInfoHead *vih = (VorbisInfoHead *)vi.data();
    bool dsp_live = false, blk_live = false;
    if (ok) {
        dsp_live = v.synth_init(vd.data(), vi.data()) == 0;
        if (!dsp_live || vih->channels <= 0) ok = false;
    }
    if (ok) {
        blk_live = v.block_init(vd.data(), vb.data()) == 0;
        int ch = vih->channels;
        out->channels = ch;
        out->rate = (int)vih->rate;
        for (auto &pk : pkts) {
            OggPacket op{};
            op.packet = const_cast<unsigned char *>(pk.first);
            op.bytes = (long)pk.second;
            op.packetno = pno++;
            if (v.synthesis(vb.data(), &op) == 0)
                v.blockin(vd.data(), vb.data());
            float **pcm = nullptr;
            int n;
            while ((n = v.pcmout(vd.data(), &pcm)) > 0) {
                size_t base = out->data.size();
                out->data.resize(base + (size_t)n * ch);
                for (int c = 0; c < ch; ++c)
                    for (int i = 0; i < n; ++i)
                        out->data[base + (size_t)i * ch + c] = pcm[c][i];
                v.read_(vd.data(), n);
            }
        }
    }
    // full teardown: dsp/block states own window + PCM work buffers that
    // otherwise leak per request in the long-running server
    if (blk_live) v.block_clear(vb.data());
    if (dsp_live) v.dsp_clear(vd.data());
    v.comment_clear(vc.data());
    v.info_clear(vi.data());
    return ok && !out->data.empty();
}

// ---------------------------------------------------------------------------
// Ogg paging (for Ogg/Opus — vorbisfile covers Ogg/Vorbis)
// ---------------------------------------------------------------------------

bool ogg_collect_packets(const uint8_t *data, int64_t len,
                         std::vector<std::vector<uint8_t>> *packets) {
    int64_t pos = 0;
    uint32_t serial = 0;
    bool have_serial = false;
    std::vector<uint8_t> cur;
    while (pos + 27 <= len) {
        if (memcmp(data + pos, "OggS", 4) != 0) { ++pos; continue; }
        const uint8_t *ph = data + pos;
        uint8_t nsegs = ph[26];
        if (pos + 27 + nsegs > len) break;
        uint32_t ser = ph[14] | (ph[15] << 8) | (ph[16] << 16)
                       | ((uint32_t)ph[17] << 24);
        const uint8_t *lacing = ph + 27;
        const uint8_t *body = lacing + nsegs;
        int64_t body_len = 0;
        for (int i = 0; i < nsegs; ++i) body_len += lacing[i];
        if (body - data + body_len > len) break;
        if (!have_serial) { serial = ser; have_serial = true; }
        if (ser == serial) {
            const uint8_t *p = body;
            for (int i = 0; i < nsegs; ++i) {
                cur.insert(cur.end(), p, p + lacing[i]);
                p += lacing[i];
                if (lacing[i] < 255) {
                    packets->push_back(std::move(cur));
                    cur.clear();
                }
            }
        }
        pos = (body - data) + body_len;
    }
    if (!cur.empty()) packets->push_back(std::move(cur));
    return !packets->empty();
}

bool decode_ogg_opus(const uint8_t *data, int64_t len, Pcm *out) {
    std::vector<std::vector<uint8_t>> raw;
    if (!ogg_collect_packets(data, len, &raw) || raw.size() < 2) return false;
    OpusHead head = parse_opus_head(raw[0].data(), raw[0].size());
    if (!head.valid) return false;
    std::vector<std::pair<const uint8_t *, size_t>> pkts;
    for (size_t i = 1; i < raw.size(); ++i) {
        if (i == 1 && raw[i].size() >= 8 && memcmp(raw[i].data(), "OpusTags", 8) == 0)
            continue;
        pkts.emplace_back(raw[i].data(), raw[i].size());
    }
    return decode_opus_packets(pkts, head, out);
}

// ---------------------------------------------------------------------------
// WebM / Matroska (EBML) container
// ---------------------------------------------------------------------------

struct Ebml {
    const uint8_t *data;
    int64_t len;

    // read an EBML vint at pos; id=true keeps the marker bit
    bool vint(int64_t &pos, uint64_t *out, bool id) const {
        if (pos >= len) return false;
        uint8_t b = data[pos];
        int n = 0;
        for (int i = 7; i >= 0; --i) {
            if (b & (1u << i)) { n = 8 - i; break; }
        }
        if (n == 0 || pos + n > len) return false;
        uint64_t v = id ? b : (b & ((1u << (8 - n)) - 1));
        for (int i = 1; i < n; ++i) v = (v << 8) | data[pos + i];
        pos += n;
        if (!id) {
            // all-ones payload = unknown size
            uint64_t unknown = (~0ULL) >> (64 - (7 * n));
            if (v == unknown) v = ~0ULL;
        }
        *out = v;
        return true;
    }
};

uint64_t read_uint(const uint8_t *p, uint64_t n) {
    uint64_t v = 0;
    for (uint64_t i = 0; i < n; ++i) v = (v << 8) | p[i];
    return v;
}

struct WebmTrack {
    uint64_t number = 0;
    std::string codec;
    std::vector<uint8_t> codec_private;
    int channels = 0;
    double rate = 0;
};

struct WebmAudio {
    WebmTrack track;
    std::vector<std::vector<uint8_t>> frames;
    // a Block arrived before the audio track was known (clusters before
    // tracks): the walk must run again to collect the skipped frames
    bool skipped_blocks = false;
};

// parse a Block/SimpleBlock payload; append frames of `track`
void webm_block(const uint8_t *p, int64_t n, WebmAudio *out) {
    Ebml e{p, n};
    int64_t pos = 0;
    uint64_t tracknum;
    if (!e.vint(pos, &tracknum, false)) return;
    if (tracknum != out->track.number) return;
    if (pos + 3 > n) return;
    pos += 2;                       // relative timecode (int16)
    uint8_t flags = p[pos++];
    int lacing = (flags >> 1) & 0x3;  // 0 none, 1 xiph, 2 fixed, 3 ebml
    if (lacing == 0) {
        out->frames.emplace_back(p + pos, p + n);
        return;
    }
    if (pos >= n) return;
    int nframes = p[pos++] + 1;
    std::vector<int64_t> sizes;
    if (lacing == 2) {  // fixed
        int64_t each = (n - pos) / nframes;
        sizes.assign(nframes, each);
    } else if (lacing == 1) {  // xiph
        int64_t total = 0;
        for (int i = 0; i < nframes - 1; ++i) {
            int64_t sz = 0;
            while (pos < n && p[pos] == 255) { sz += 255; ++pos; }
            if (pos >= n) return;
            sz += p[pos++];
            sizes.push_back(sz);
            total += sz;
        }
        sizes.push_back(n - pos - total);
    } else {  // ebml lacing
        uint64_t first;
        if (!e.vint(pos, &first, false)) return;
        sizes.push_back((int64_t)first);
        int64_t prev = (int64_t)first, total = prev;
        for (int i = 1; i < nframes - 1; ++i) {
            int64_t p0 = pos;
            uint64_t raw;
            if (!e.vint(pos, &raw, false)) return;
            int nb = (int)(pos - p0);
            int64_t bias = (1LL << (7 * nb - 1)) - 1;
            prev += (int64_t)raw - bias;
            sizes.push_back(prev);
            total += prev;
        }
        sizes.push_back(n - pos - total);
    }
    for (int64_t sz : sizes) {
        if (sz < 0 || pos + sz > n) return;
        out->frames.emplace_back(p + pos, p + pos + sz);
        pos += sz;
    }
}

void webm_walk(const Ebml &e, int64_t pos, int64_t end, WebmAudio *out,
               WebmTrack *cur_entry) {
    while (pos < end) {
        uint64_t id, size;
        if (!e.vint(pos, &id, true) || !e.vint(pos, &size, false)) return;
        int64_t payload_end =
            size == ~0ULL ? end : pos + (int64_t)size;
        if (payload_end > end) payload_end = end;
        // every LEAF read below must use the CLAMPED extent, never the
        // declared size: a malformed/truncated upload can declare sizes
        // past the buffer (the recursive cases already clamp)
        int64_t leaf = payload_end - pos;
        switch (id) {
            case 0x18538067:  // Segment
            case 0x1654AE6B:  // Tracks
            case 0x1F43B675:  // Cluster
            case 0xA0:        // BlockGroup
                webm_walk(e, pos, payload_end, out, cur_entry);
                break;
            case 0xAE: {      // TrackEntry
                WebmTrack entry;
                webm_walk(e, pos, payload_end, out, &entry);
                // first Opus/Vorbis audio track wins
                if (out->track.number == 0
                    && (entry.codec == "A_OPUS" || entry.codec == "A_VORBIS"))
                    out->track = entry;
                break;
            }
            case 0xE1:        // Audio
                if (cur_entry) webm_walk(e, pos, payload_end, out, cur_entry);
                break;
            case 0xD7:        // TrackNumber
                if (cur_entry && leaf <= 8)
                    cur_entry->number = read_uint(e.data + pos, leaf);
                break;
            case 0x86:        // CodecID
                if (cur_entry)
                    cur_entry->codec.assign((const char *)e.data + pos, (size_t)leaf);
                break;
            case 0x63A2:      // CodecPrivate
                if (cur_entry)
                    cur_entry->codec_private.assign(e.data + pos, e.data + pos + leaf);
                break;
            case 0x9F:        // Channels
                if (cur_entry && leaf <= 8)
                    cur_entry->channels = (int)read_uint(e.data + pos, leaf);
                break;
            case 0xB5: {      // SamplingFrequency (BE float 4 or 8)
                if (cur_entry && size == 4 && leaf >= 4) {
                    uint32_t v = (uint32_t)read_uint(e.data + pos, 4);
                    float f;
                    memcpy(&f, &v, 4);
                    cur_entry->rate = f;
                } else if (cur_entry && size == 8 && leaf >= 8) {
                    uint64_t v = read_uint(e.data + pos, 8);
                    double d;
                    memcpy(&d, &v, 8);
                    cur_entry->rate = d;
                }
                break;
            }
            case 0xA3:        // SimpleBlock
            case 0xA1:        // Block
                if (out->track.number != 0)
                    webm_block(e.data + pos, leaf, out);
                else
                    out->skipped_blocks = true;
                break;
            default:
                break;
        }
        if (size == ~0ULL) return;  // unknown-size element consumed the rest
        pos = payload_end;
    }
}

bool decode_webm(const uint8_t *data, int64_t len, Pcm *out) {
    WebmAudio wa;
    Ebml e{data, len};
    // one pass suffices for the common tracks-before-clusters layout;
    // only re-walk when blocks preceded the track entry
    webm_walk(e, 0, len, &wa, nullptr);
    if (wa.track.number == 0) return false;
    if (wa.skipped_blocks) {
        wa.frames.clear();
        webm_walk(e, 0, len, &wa, nullptr);
    }
    if (wa.track.codec == "A_OPUS") {
        OpusHead head = parse_opus_head(wa.track.codec_private.data(),
                                        wa.track.codec_private.size());
        if (!head.valid) {  // some muxers omit CodecPrivate: use track info
            head.channels = wa.track.channels > 0 ? wa.track.channels : 1;
            head.preskip = 0;
            head.valid = true;
        }
        std::vector<std::pair<const uint8_t *, size_t>> pkts;
        for (auto &f : wa.frames) pkts.emplace_back(f.data(), f.size());
        return decode_opus_packets(pkts, head, out);
    }
    if (wa.track.codec == "A_VORBIS") {
        // CodecPrivate: Xiph-laced 3 headers (count-1, lacing sizes, data)
        const auto &cp = wa.track.codec_private;
        if (cp.size() < 3 || cp[0] != 2) return false;
        size_t pos = 1;
        int64_t sz[2];
        for (int i = 0; i < 2; ++i) {
            int64_t s = 0;
            while (pos < cp.size() && cp[pos] == 255) { s += 255; ++pos; }
            if (pos >= cp.size()) return false;
            s += cp[pos++];
            sz[i] = s;
        }
        if (pos + sz[0] + sz[1] > cp.size()) return false;
        std::vector<std::pair<const uint8_t *, size_t>> headers = {
            {cp.data() + pos, (size_t)sz[0]},
            {cp.data() + pos + sz[0], (size_t)sz[1]},
            {cp.data() + pos + sz[0] + sz[1], cp.size() - pos - sz[0] - sz[1]},
        };
        std::vector<std::pair<const uint8_t *, size_t>> pkts;
        for (auto &f : wa.frames) pkts.emplace_back(f.data(), f.size());
        return decode_vorbis_packets(headers, pkts, out);
    }
    return false;
}

// ---------------------------------------------------------------------------
// format sniffing
// ---------------------------------------------------------------------------

enum Fmt { FMT_UNKNOWN, FMT_MP3, FMT_OGG, FMT_WEBM };

Fmt sniff(const uint8_t *data, int64_t len) {
    if (len >= 4 && memcmp(data, "OggS", 4) == 0) return FMT_OGG;
    if (len >= 4 && data[0] == 0x1A && data[1] == 0x45 && data[2] == 0xDF
        && data[3] == 0xA3)
        return FMT_WEBM;
    if (len >= 3 && memcmp(data, "ID3", 3) == 0) return FMT_MP3;
    if (len >= 2 && data[0] == 0xFF && (data[1] & 0xE0) == 0xE0) return FMT_MP3;
    return FMT_UNKNOWN;
}

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

int ds_audio_formats() {
    int m = 0;
    if (mpg123().ok) m |= 1;
    if (vorbisfile().ok && vorbislib().ok) m |= 2;
    if (opuslib().ok) m |= 4;
    return m;
}

// Decode a compressed audio buffer. Returns 0 on success.
int ds_audio_decode(const uint8_t *data, int64_t len, float **out_pcm,
                    int64_t *out_frames, int *out_channels, int *out_rate) {
    if (!data || len <= 0) return 1;
    Pcm pcm;
    Fmt f = sniff(data, len);
    bool ok = false;
    switch (f) {
        case FMT_MP3:
            ok = decode_mp3(data, len, &pcm);
            break;
        case FMT_OGG:
            ok = decode_ogg_vorbis(data, len, &pcm)
                 || decode_ogg_opus(data, len, &pcm);
            break;
        case FMT_WEBM:
            ok = decode_webm(data, len, &pcm);
            break;
        default:
            // last resort: mpg123 skips leading junk in mp3-ish streams
            ok = decode_mp3(data, len, &pcm);
            break;
    }
    if (!ok || pcm.channels <= 0 || pcm.rate <= 0) return 2;
    int64_t frames = (int64_t)(pcm.data.size() / pcm.channels);
    float *buf = (float *)malloc(sizeof(float) * pcm.data.size());
    if (!buf) return 3;
    memcpy(buf, pcm.data.data(), sizeof(float) * pcm.data.size());
    *out_pcm = buf;
    *out_frames = frames;
    *out_channels = pcm.channels;
    *out_rate = pcm.rate;
    return 0;
}

void ds_audio_free(float *p) { free(p); }

}  // extern "C"
