// Golden-output harness: links the UNMODIFIED reference sources (read-only at
// /root/reference) into a headless demodulator that writes raw f32 stereo
// audio frames + RDS bytes, used by tests/test_golden.py to validate the JAX
// framework against the reference implementation on synthetic recordings.
//
// Usage: golden_demod <in.pcm> <audio.f32> <rds.bin> <block_size>
//                     [deemph_us] [mode] [stereo_gain] [lpr_hz] [lmr_hz]
//   deemph_us > 0 enables the reference's de-emphasis IIR with that cutoff
//   (mirrors the GUI checkbox + slider, render_fm_demod.cpp:358-366);
//   mode in {stereo,lpr,lmr} selects the audio mixer output, stereo_gain
//   sets the L-R mix factor, lpr_hz/lmr_hz (> 0) set the audio cutoffs —
//   together the full control set of the GUI demod panel
//   (render_fm_demod.cpp:305-374), so the framework's runtime controls can
//   be golden-tested at the signal level against the reference.
#include <cstdio>
#include <cstdlib>
#include <complex>
#include <vector>

#include "app.h"
#include "audio/frame.h"
#include "fm_demod/broadcast_fm_demod.h"

int main(int argc, char** argv) {
    if (argc < 5) {
        fprintf(stderr, "usage: %s in.pcm audio.f32 rds.bin block_size\n", argv[0]);
        return 1;
    }
    FILE* fin = fopen(argv[1], "rb");
    FILE* faudio = fopen(argv[2], "wb");
    FILE* frds = fopen(argv[3], "wb");
    const int block_size = atoi(argv[4]);
    if (!fin || !faudio || !frds || block_size <= 0) {
        fprintf(stderr, "bad arguments\n");
        return 1;
    }

    App app(block_size);
    auto& controls = app.GetFMDemod().GetControls();
    if (argc > 5) {
        const int deemph_us = atoi(argv[5]);
        if (deemph_us > 0) {
            controls.is_use_deemphasis_filter = true;
            controls.filt_deemphasis_cutoff.SetValue(deemph_us);
        }
    }
    if (argc > 6) {
        const char* mode = argv[6];
        using C = Broadcast_FM_Demod_Controls;
        if (mode[0] == 'l' && mode[1] == 'p') controls.audio_out = C::AudioOut::LPR;
        else if (mode[0] == 'l' && mode[1] == 'm') controls.audio_out = C::AudioOut::LMR;
        else controls.audio_out = C::AudioOut::STEREO;
    }
    if (argc > 7) controls.audio_stereo_mix_factor = (float)atof(argv[7]);
    if (argc > 8 && atoi(argv[8]) > 0) controls.filt_audio_lpr_cutoff.SetValue(atoi(argv[8]));
    if (argc > 9 && atoi(argv[9]) > 0) controls.filt_audio_lmr_cutoff.SetValue(atoi(argv[9]));
    app.OnAudioBlock().Attach(
        [&](tcb::span<const Frame<float>> x, const int Fs) {
            (void)Fs;
            fwrite(x.data(), sizeof(Frame<float>), x.size(), faudio);
        });
    app.On_RDS_Bytes().Attach([&](tcb::span<const uint8_t> x) {
        fwrite(x.data(), 1, x.size(), frds);
    });

    std::vector<std::complex<uint8_t>> buf((size_t)block_size);
    while (fread(buf.data(), sizeof(std::complex<uint8_t>), (size_t)block_size,
                 fin) == (size_t)block_size) {
        app.Process({buf.data(), (size_t)block_size});
    }
    fclose(fin);
    fclose(faudio);
    fclose(frds);
    return 0;
}
