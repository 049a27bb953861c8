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

// Sync-pulse scan of the raw decoder (ffmpeg_raw28ntsc.cpp:625-699 and
// :793-833) over the DC-normalized detector signal dc: a pulse is a run
// of dc < threshold, classified by its length as vsync (>= vsync_len,
// 0.3H), hsync (>= hsync_len, 0.06H) or equalization (>= equal_len,
// 0.02H). A vsync or equalization pulse counts, and the pulses that
// start within vsync_len of it are skipped. Both walks scan forward and
// stop at the pulse they need; a run still open at the buffer's end
// closes there. The Python twins (models/raw28.py: hunt_vsync_numpy,
// relock_hsync) classify the same runs from a numpy run-length encoding.

#include <cmath>

namespace {

struct SyncScan {
    const uint8_t* dc;
    long n;
    int threshold;
    long vsync_len, hsync_len, equal_len;
    long read;             // samples examined, over all scans
};

// The next run of dc < threshold at or after *i: sets s and e (e == n for
// a run open at the buffer's end) and leaves *i at e; false if none.
inline bool next_run(const SyncScan& sc, long* i, long* s, long* e) {
    long k = *i;
    while (k < sc.n && sc.dc[k] >= sc.threshold) k++;
    if (k >= sc.n) { *i = k; return false; }
    *s = k;
    while (k < sc.n && sc.dc[k] < sc.threshold) k++;
    *e = k;
    *i = k;
    return true;
}

// samples examined by a scan from `from` that stopped at the run ending
// at e: up to and including dc[e], the first sample not below the
// threshold
inline long examined(const SyncScan& sc, long from, long e) {
    return (e < sc.n ? e + 1 : sc.n) - from;
}

// relock_hsync: the re-locked position and whether 9 counted pulses came
// first (then pos comes back unchanged)
long relock(SyncScan* sc, long pos, long window_back, int* hit_vsync) {
    const long from = pos > window_back ? pos - window_back : 0;
    long i = from, s = 0, e = 0, vsb = 0, skip_until = -1;
    *hit_vsync = 0;
    while (next_run(*sc, &i, &s, &e)) {
        if (s < skip_until) continue;
        const long len = e - s;
        if (len >= sc->vsync_len) {
            vsb++;
            skip_until = s + sc->vsync_len;
        } else if (len >= sc->hsync_len) {
            sc->read += examined(*sc, from, e);
            return s + len / 2;
        } else if (len >= sc->equal_len) {
            vsb++;
            skip_until = s + sc->vsync_len;
        }
        if (vsb >= 9) {
            sc->read += examined(*sc, from, e);
            *hit_vsync = 1;
            return pos;
        }
    }
    sc->read += sc->n - from;
    return pos;
}

}  // namespace

extern "C" {

// The vsync hunt from sample 0: the lock (the centre of the first hsync
// pulse after 9 counted pulses) or -1. Writes the starts of the counted
// equalization pulses before it, in order, to equal_starts (the AGC
// calibrates on each; at most cap are written, *n_equal counts them all)
// and the samples examined to *read.
long sync_hunt(const uint8_t* dc, long n, int threshold, long vsync_len,
               long hsync_len, long equal_len, long* equal_starts, long cap,
               long* n_equal, long* read) {
    SyncScan sc = {dc, n, threshold, vsync_len, hsync_len, equal_len, 0};
    long i = 0, s = 0, e = 0, vsb = 0, skip_until = -1, k = 0;
    while (next_run(sc, &i, &s, &e)) {
        if (s < skip_until) continue;
        const long len = e - s;
        if (len >= vsync_len) {
            vsb++;
            skip_until = e > s + vsync_len ? e : s + vsync_len;
        } else if (len >= hsync_len) {
            if (vsb >= 9) {
                *n_equal = k;
                *read = examined(sc, 0, e);
                return s + len / 2;
            }
        } else if (len >= equal_len) {
            vsb++;
            if (k < cap) equal_starts[k] = s;
            k++;
            skip_until = e > s + vsync_len ? e : s + vsync_len;
        }
    }
    *n_equal = k;
    *read = n;
    return -1;
}

// The line walk of one field from pos: up to `height` line starts, each
// line paced by raw_len (fractional pacing in double) and, with sync,
// re-locked on the next hsync pulse from window_back samples before the
// paced position; 9 counted pulses end the field. A line starts only
// where 2 * raw_len samples follow it. Writes the starts to line_starts
// and out = {final position, hit_vsync, re-locks, samples examined};
// returns the number of lines.
long sync_walk_lines(const uint8_t* dc, long n, long pos, long raw_len,
                     long height, int sync, int threshold, long vsync_len,
                     long hsync_len, long equal_len, long window_back,
                     long* line_starts, long* out) {
    SyncScan sc = {dc, n, threshold, vsync_len, hsync_len, equal_len, 0};
    const double width_f = (double)raw_len;
    double err = 0.0;
    long p = pos, lines = 0, relocks = 0;
    int hit_vsync = 0;
    for (long y = 0; y < height; y++) {
        if (p + raw_len * 2 >= n) break;
        line_starts[lines++] = p;
        long adj = (long)std::floor(width_f);
        err += width_f - (double)adj;
        if (err >= 1.0) {
            err -= 1.0;
            adj += 1;
        }
        p += adj;
        if (sync) {
            relocks++;
            p = relock(&sc, p, window_back, &hit_vsync);
            if (hit_vsync) break;
        }
    }
    out[0] = p;
    out[1] = hit_vsync;
    out[2] = relocks;
    out[3] = sc.read;
    return lines;
}

}  // extern "C"
