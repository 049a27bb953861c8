// Native host-side ingest for the raw composite decoder (and general
// high-rate host DSP that is inherently sequential and therefore belongs on
// the CPU, off the TPU critical path).
//
// Implements the hsync DC normalization of ffmpeg_raw28ntsc.cpp:556-598 as a
// streaming chunk processor: 3-pass one-pole lowpass, asymmetric dual-rate
// DC tracker (fast attack toward sync tips, slow decay), and the raw-sample
// delay line that compensates the filter group delay. State persists across
// chunks so arbitrarily long captures stream at ingest speed.
//
// Build: g++ -O2 -shared -fPIC -o libhostio.so hostio.cpp
// Python binding: ctypes (cvsim_tpu/native/__init__.py).

#include <cstdint>
#include <cstring>

extern "C" {

struct HsyncDcState {
    double filt_prev[3];   // lowpass registers
    double alpha;          // filter coefficient
    double dc_level;       // tracked sync-tip DC level
    double a_fast;         // attack rate  (1 / (scanline*0.07*0.75))
    double a_slow;         // decay rate   (1 / (frame*0.6))
    int    delay_len;      // raw delay-line length
    int    delay_pos;
    uint8_t delay[4096];
};

void hsync_dc_init(HsyncDcState* st, double sample_rate, double cutoff_hz,
                   double a_fast, double a_slow, int delay_len,
                   double precharge, long precharge_n) {
    const double dt = 1.0 / sample_rate;
    const double pi = 3.14159265358979323846;
    const double tau = 1.0 / (cutoff_hz * 2.0 * pi);
    st->alpha = dt / (tau + dt);
    for (int i = 0; i < 3; i++) st->filt_prev[i] = 0.0;
    st->dc_level = 128.0;
    st->a_fast = a_fast;
    st->a_slow = a_slow;
    st->delay_len = delay_len > 4096 ? 4096 : delay_len;
    st->delay_pos = 0;
    std::memset(st->delay, 0, sizeof(st->delay));
    // reference precharges the filters with one frame of mid-level samples
    // (ffmpeg_raw28ntsc.cpp:892)
    for (long j = 0; j < precharge_n; j++) {
        double lv = precharge;
        for (int i = 0; i < 3; i++) {
            st->filt_prev[i] = lv * st->alpha
                + (st->filt_prev[i] - st->filt_prev[i] * st->alpha);
            lv = st->filt_prev[i];
        }
    }
}

// Process n raw u8 samples: writes the delayed raw samples to out_raw and the
// DC-normalized detector signal to out_dc.
void hsync_dc_process(HsyncDcState* st, const uint8_t* in, long n,
                      uint8_t* out_raw, uint8_t* out_dc) {
    const double alpha = st->alpha;
    for (long k = 0; k < n; k++) {
        double lv = (double)in[k];
        for (int i = 0; i < 3; i++) {
            st->filt_prev[i] = lv * alpha
                + (st->filt_prev[i] - st->filt_prev[i] * alpha);
            lv = st->filt_prev[i];
        }
        if (st->dc_level > lv)
            st->dc_level = st->dc_level * (1.0 - st->a_fast) + lv * st->a_fast;
        else
            st->dc_level = st->dc_level * (1.0 - st->a_slow) + lv * st->a_slow;

        uint8_t delayed;
        if (st->delay_len > 0) {
            delayed = st->delay[st->delay_pos];
            st->delay[st->delay_pos] = in[k];
            if (++st->delay_pos >= st->delay_len) st->delay_pos = 0;
        } else {
            delayed = in[k];
        }
        out_raw[k] = delayed;

        int x = (int)(lv - st->dc_level);
        if (x < 0) x = 0;
        if (x > 255) x = 255;
        out_dc[k] = (uint8_t)x;
    }
}

}  // extern "C"
