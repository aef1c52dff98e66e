// fmtpu native runtime: the non-compute half of the framework.
//
// Equivalents of the reference's C++ runtime layers:
//   * streaming IQ source with background prefetch + re-blocking
//     (ReconstructionBuffer, src/utility/reconstruction_buffer.h, and the
//     reader loops of fm_demod_no_tuner.cpp:179-189)
//   * u8 -> f32 recentering (app.cpp:57-63) off the Python thread
//   * incremental WAV sink (fm_scraper.cpp:92-171 header management)
//   * differential-Manchester bit slicer + packer
//     (differential_manchester_decoder.h:32-60)
//   * CRC-10 + 26-bit group synchroniser (rds_group_sync.cpp) — the
//     bit-serial hot path for 1000-channel RDS decode
//   * SPSC ring buffer for pipelined host I/O (ring_buffer.h analogue)
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).
// Compute stays in XLA/Pallas; this library never touches samples after
// they are handed to the device.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// u8 IQ -> centered f32 pairs (app.cpp:57-63)
// ---------------------------------------------------------------------------

void rt_u8_to_f32_center(const uint8_t* src, float* dst, int64_t n_pairs) {
    for (int64_t i = 0; i < 2 * n_pairs; i++) {
        dst[i] = (float)src[i] - 127.0f;
    }
}

// ---------------------------------------------------------------------------
// Streaming pcm reader with prefetch thread + re-blocking
// ---------------------------------------------------------------------------

struct PcmReader {
    FILE* fp = nullptr;
    int64_t block_pairs = 0;        // IQ pairs per emitted block
    std::thread worker;
    std::mutex mu;
    std::condition_variable cv_filled, cv_space;
    std::vector<std::vector<uint8_t>> slots;  // ring of raw blocks
    std::vector<int64_t> slot_len;            // valid bytes per slot
    size_t head = 0, tail = 0, count = 0;
    bool eof = false, stop = false;

    static void run(PcmReader* r) {
        const int64_t want = 2 * r->block_pairs;
        std::vector<uint8_t> partial;
        partial.reserve(want);
        while (true) {
            {
                std::unique_lock<std::mutex> lk(r->mu);
                r->cv_space.wait(lk, [r] { return r->count < r->slots.size() || r->stop; });
                if (r->stop) return;
            }
            // fill one block (re-blocking: accumulate until exactly `want`)
            partial.clear();
            partial.resize(want);
            int64_t got = 0;
            while (got < want) {
                size_t n = fread(partial.data() + got, 1, (size_t)(want - got), r->fp);
                if (n == 0) break;
                got += (int64_t)n;
            }
            std::unique_lock<std::mutex> lk(r->mu);
            if (got < want) {
                // drop the final partial block like the reference benchmark
                // loop (fm_demod_benchmark.cpp:96-99)
                r->eof = true;
                r->cv_filled.notify_all();
                return;
            }
            r->slots[r->head].swap(partial);
            r->slot_len[r->head] = got;
            r->head = (r->head + 1) % r->slots.size();
            r->count++;
            r->cv_filled.notify_all();
        }
    }
};

void* rt_pcm_open(const char* path, int64_t block_pairs, int n_prefetch) {
    FILE* fp = (path && path[0]) ? fopen(path, "rb") : stdin;
    if (!fp) return nullptr;
    auto* r = new PcmReader();
    r->fp = fp;
    r->block_pairs = block_pairs;
    if (n_prefetch < 1) n_prefetch = 4;
    r->slots.resize((size_t)n_prefetch);
    r->slot_len.resize((size_t)n_prefetch, 0);
    r->worker = std::thread(PcmReader::run, r);
    return r;
}

// Returns 1 and fills dst (centered f32 interleaved, 2*block_pairs floats)
// on success; 0 on end of stream.
int rt_pcm_next_block_f32(void* handle, float* dst) {
    auto* r = (PcmReader*)handle;
    std::vector<uint8_t> blk;
    {
        std::unique_lock<std::mutex> lk(r->mu);
        r->cv_filled.wait(lk, [r] { return r->count > 0 || r->eof; });
        if (r->count == 0) return 0;
        blk.swap(r->slots[r->tail]);
        r->tail = (r->tail + 1) % r->slots.size();
        r->count--;
        r->cv_space.notify_all();
    }
    rt_u8_to_f32_center(blk.data(), dst, r->block_pairs);
    return 1;
}

int rt_pcm_next_block_packed_f32(void* handle, float* dst) {
    // packed u8 ingest (utils/transfer.pack_iq_u8): one f32 word per
    // complex sample, w = I*256 + Q — exact integers < 2^16, half the
    // host->device bytes of (re, im) f32; the jitted demod unpacks and
    // recenters on the device.
    auto* r = (PcmReader*)handle;
    std::vector<uint8_t> blk;
    {
        std::unique_lock<std::mutex> lk(r->mu);
        r->cv_filled.wait(lk, [r] { return r->count > 0 || r->eof; });
        if (r->count == 0) return 0;
        blk.swap(r->slots[r->tail]);
        r->tail = (r->tail + 1) % r->slots.size();
        r->count--;
        r->cv_space.notify_all();
    }
    const uint8_t* p = blk.data();
    for (int64_t i = 0; i < r->block_pairs; i++) {
        dst[i] = (float)((int32_t)p[2 * i] * 256 + (int32_t)p[2 * i + 1]);
    }
    return 1;
}

int rt_pcm_next_block_i8(void* handle, int8_t* dst) {
    // raw int8 plane ingest (utils/transfer.split_iq_i8): dst holds
    // [2, block_pairs] planes of (I-128, Q-128) — 2 bytes per complex
    // sample, HALF the packed-f32-word bytes (the default ingest).
    auto* r = (PcmReader*)handle;
    std::vector<uint8_t> blk;
    {
        std::unique_lock<std::mutex> lk(r->mu);
        r->cv_filled.wait(lk, [r] { return r->count > 0 || r->eof; });
        if (r->count == 0) return 0;
        blk.swap(r->slots[r->tail]);
        r->tail = (r->tail + 1) % r->slots.size();
        r->count--;
        r->cv_space.notify_all();
    }
    const uint8_t* p = blk.data();
    int8_t* di = dst;
    int8_t* dq = dst + r->block_pairs;
    for (int64_t i = 0; i < r->block_pairs; i++) {
        di[i] = (int8_t)((int32_t)p[2 * i] - 128);
        dq[i] = (int8_t)((int32_t)p[2 * i + 1] - 128);
    }
    return 1;
}

void rt_pcm_close(void* handle) {
    auto* r = (PcmReader*)handle;
    {
        std::unique_lock<std::mutex> lk(r->mu);
        r->stop = true;
        r->cv_space.notify_all();
    }
    if (r->worker.joinable()) r->worker.join();
    if (r->fp && r->fp != stdin) fclose(r->fp);
    delete r;
}

// ---------------------------------------------------------------------------
// Incremental WAV sink (fm_scraper.cpp:92-171)
// ---------------------------------------------------------------------------

struct WavWriter {
    FILE* fp = nullptr;
    int32_t data_bytes = 0;
    int16_t channels = 2;
    int32_t sample_rate = 32000;
};

#pragma pack(push, 1)
struct WavHeader {
    char chunk_id[4];
    int32_t chunk_size;
    char format[4];
    char sub1_id[4];
    int32_t sub1_size;
    int16_t audio_format;
    int16_t num_channels;
    int32_t sample_rate;
    int32_t byte_rate;
    int16_t block_align;
    int16_t bits_per_sample;
    char sub2_id[4];
    int32_t sub2_size;
};
#pragma pack(pop)

void* rt_wav_open(const char* path, int32_t sample_rate, int16_t channels) {
    FILE* fp = fopen(path, "wb+");
    if (!fp) return nullptr;
    auto* w = new WavWriter{fp, 0, channels, sample_rate};
    WavHeader h;
    memcpy(h.chunk_id, "RIFF", 4);
    memcpy(h.format, "WAVE", 4);
    memcpy(h.sub1_id, "fmt ", 4);
    memcpy(h.sub2_id, "data", 4);
    h.sub1_size = 16;
    h.audio_format = 1;
    h.num_channels = channels;
    h.sample_rate = sample_rate;
    h.bits_per_sample = 16;
    h.byte_rate = sample_rate * channels * 2;
    h.block_align = (int16_t)(channels * 2);
    h.sub2_size = 0;
    h.chunk_size = 36;
    fwrite(&h, sizeof(h), 1, fp);
    return w;
}

// frames: float in [-1,1], interleaved; rescale x0.95 like the scraper
void rt_wav_write_f32(void* handle, const float* frames, int64_t n_frames) {
    auto* w = (WavWriter*)handle;
    const float scale = 32767.0f * 0.95f;
    std::vector<int16_t> buf((size_t)(n_frames * w->channels));
    for (int64_t i = 0; i < n_frames * w->channels; i++) {
        float v = frames[i] * scale;
        if (v > 32767.0f) v = 32767.0f;
        if (v < -32768.0f) v = -32768.0f;
        buf[(size_t)i] = (int16_t)v;  // trunc toward zero, like the C cast
    }
    fwrite(buf.data(), sizeof(int16_t), buf.size(), w->fp);
    w->data_bytes += (int32_t)(buf.size() * sizeof(int16_t));
    // update header in place (fm_scraper.cpp:155-167)
    int32_t chunk = 36 + w->data_bytes;
    fseek(w->fp, 4, SEEK_SET);
    fwrite(&chunk, 4, 1, w->fp);
    fseek(w->fp, 40, SEEK_SET);
    fwrite(&w->data_bytes, 4, 1, w->fp);
    fseek(w->fp, 0, SEEK_END);
}

void rt_wav_close(void* handle) {
    auto* w = (WavWriter*)handle;
    fclose(w->fp);
    delete w;
}

// ---------------------------------------------------------------------------
// Differential Manchester decoder (differential_manchester_decoder.h:32-60)
// ---------------------------------------------------------------------------

struct ManchesterState {
    int is_read_bit = 0;   // toggled before each symbol; read when it becomes 1
    int prev_bit = 0;
    int bit_index = 0;     // bits accumulated into out buffer
};

void* rt_manchester_new() { return new ManchesterState(); }
void rt_manchester_free(void* h) { delete (ManchesterState*)h; }

// Consumes n soft symbols; appends decoded bits MSB-first into out_bytes
// (caller-sized >= (existing_bits + n/2 + 8)/8).  Returns new total bit count.
int64_t rt_manchester_process(void* handle, const float* symbols, int64_t n,
                              uint8_t* out_bytes, int64_t bit_offset) {
    auto* s = (ManchesterState*)handle;
    int64_t bits = bit_offset;
    for (int64_t i = 0; i < n; i++) {
        s->is_read_bit = !s->is_read_bit;
        if (!s->is_read_bit) continue;
        const int curr = symbols[i] > 0.0f ? 1 : 0;
        const int bit = curr ^ s->prev_bit;
        s->prev_bit = curr;
        const int64_t byte_i = bits / 8;
        const int shift = 7 - (int)(bits % 8);
        if (shift == 7) out_bytes[byte_i] = 0;
        out_bytes[byte_i] |= (uint8_t)(bit << shift);
        bits++;
    }
    return bits;
}

// ---------------------------------------------------------------------------
// CRC-10 + group sync (rds_group_sync.cpp, crc10.cpp)
// ---------------------------------------------------------------------------

static const uint16_t kCrcPoly = 0b0110111001;
static const uint16_t kOffsets[5] = {
    0b0011111100,  // A
    0b0110011000,  // B
    0b0101101000,  // C
    0b1101010000,  // C1
    0b0110110100,  // D
};

uint16_t rt_crc10(uint32_t x) {
    uint16_t reg = 0;
    for (int i = 0; i < 26; i++) {
        const uint16_t bit = (uint16_t)((x >> (25 - i)) & 1u);
        reg = (uint16_t)((reg << 1) | bit);
        if (reg & (1u << 10)) reg ^= kCrcPoly;
    }
    return (uint16_t)(reg & 0x3FF);
}

struct GroupSync {
    uint32_t buf = 0;
    int buf_bits = 0;
    int curr_block = 0;
    int block_errors = 0;
    int groups_desync = 0;
    int finding_sync = 1;
    // decoded group staging: data[4], type[4], valid[4]
    uint16_t data[4] = {0, 0, 0, 0};
    uint8_t type[4] = {0, 0, 0, 0};
    uint8_t valid[4] = {0, 0, 0, 0};
    // error-pattern table: syndrome -> 26-bit pattern (0 if none)
    uint32_t err_table[1024];
};

void* rt_group_sync_new() {
    auto* g = new GroupSync();
    memset(g->err_table, 0, sizeof(g->err_table));
    for (int i = 0; i < 26; i++) {
        const uint32_t pattern = 1u << i;
        g->err_table[rt_crc10(pattern)] = pattern;
    }
    return g;
}
void rt_group_sync_free(void* h) { delete (GroupSync*)h; }

static int attempt_decode(GroupSync* g, uint32_t x, int offset_id, int slot) {
    uint32_t cw = x ^ kOffsets[offset_id];
    uint16_t syn = rt_crc10(cw);
    int valid = 0;
    if (syn == 0) {
        valid = 1;
    } else {
        const uint32_t pat = g->err_table[syn];
        if (pat && rt_crc10(cw ^ pat) == 0) {
            cw ^= pat;
            valid = 1;
        }
    }
    g->data[slot] = (uint16_t)((cw >> 10) & 0xFFFF);
    g->type[slot] = (uint8_t)offset_id;
    g->valid[slot] = (uint8_t)valid;
    return valid;
}

static void push_block(GroupSync* g, uint32_t x) {
    const int slot = g->curr_block;
    if (slot >= 4) return;
    int ok = 0;
    switch (slot) {
        case 0: ok = attempt_decode(g, x, 0, slot); break;
        case 1: ok = attempt_decode(g, x, 1, slot); break;
        case 2:
            ok = attempt_decode(g, x, 2, slot);
            if (!ok) ok = attempt_decode(g, x, 3, slot);
            break;
        case 3: ok = attempt_decode(g, x, 4, slot); break;
    }
    g->curr_block++;
    if (!ok) g->block_errors++;
}

// Processes n_bytes of packed bits; writes completed groups into out as
// 12 uint16 per group: [data0..3, type0..3, valid0..3].
// Returns the number of completed groups.
int64_t rt_group_sync_process(void* handle, const uint8_t* bytes, int64_t n_bytes,
                              uint16_t* out, int64_t max_groups) {
    auto* g = (GroupSync*)handle;
    int64_t n_groups = 0;
    const int64_t n_bits = n_bytes * 8;
    for (int64_t bi = 0; bi < n_bits; bi++) {
        const int bit = (bytes[bi / 8] >> (7 - (bi % 8))) & 1;
        g->buf = ((g->buf << 1) | (uint32_t)bit) & 0x3FFFFFF;
        if (g->finding_sync) {
            if (rt_crc10(g->buf ^ kOffsets[0]) != 0) continue;
            g->finding_sync = 0;
            g->buf_bits = 0;
            g->curr_block = 0;
            g->block_errors = 0;
            push_block(g, g->buf);
            continue;
        }
        g->buf_bits++;
        if (g->buf_bits != 26) continue;
        g->buf_bits = 0;
        push_block(g, g->buf);
        if (g->curr_block < 4) continue;
        // group complete
        if (n_groups < max_groups) {
            uint16_t* o = out + 12 * n_groups;
            for (int k = 0; k < 4; k++) {
                o[k] = g->data[k];
                o[4 + k] = g->type[k];
                o[8 + k] = g->valid[k];
            }
            n_groups++;
        }
        const int errors = g->block_errors;
        g->curr_block = 0;
        g->block_errors = 0;
        if (errors == 0) {
            g->groups_desync = 0;
        } else {
            g->groups_desync++;
            if (g->groups_desync >= 3) {
                g->finding_sync = 1;
                g->groups_desync = 0;
            }
        }
    }
    return n_groups;
}

}  // extern "C"
