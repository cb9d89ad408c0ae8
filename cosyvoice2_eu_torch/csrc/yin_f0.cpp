// YIN pitch estimation on the host, for the GAN trainer's F0 targets.
//
// The port's copy of ``yin_f0`` in native/cosy_dsp.cpp (which replaces the
// reference's pyworld dependency, cosy_repo/cosyvoice/dataset/processor.py:
// 188-210), with the same arithmetic and the same flags, so both libraries
// give the same frames.  A plain C interface, loaded with ctypes by
// ``cosyvoice2_eu_torch/utils/native.py``.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// wav: n float32 samples, mono; f0_out: n / hop entries (caller-allocated),
// 0 where unvoiced.  Returns the number of frames written.
int yin_f0(const float* wav, int64_t n, int sample_rate, int hop,
           float fmin, float fmax, int frame_len, float threshold,
           float* f0_out) {
    const int tau_min = std::max(1, (int)(sample_rate / fmax));
    const int tau_max = (int)(sample_rate / fmin);
    const int64_t n_frames = n / hop;
    std::vector<float> d(tau_max + 1), cmnd(tau_max + 1);
    std::vector<float> frame(frame_len + tau_max + 1, 0.0f);

    for (int64_t fi = 0; fi < n_frames; ++fi) {
        const int64_t start = fi * hop;
        const int64_t avail = std::min<int64_t>(frame_len + tau_max, n - start);
        std::fill(frame.begin(), frame.end(), 0.0f);
        if (avail > 0) std::memcpy(frame.data(), wav + start, sizeof(float) * avail);

        // silence gate
        float peak = 0.0f;
        for (int i = 0; i < frame_len; ++i) peak = std::max(peak, std::fabs(frame[i]));
        if (peak < 1e-4f) { f0_out[fi] = 0.0f; continue; }

        // difference function d(tau) = sum_t (x[t] - x[t+tau])^2
        d[0] = 0.0f;
        for (int tau = 1; tau <= tau_max; ++tau) {
            double acc = 0.0;
            const float* a = frame.data();
            const float* b = frame.data() + tau;
            for (int t = 0; t < frame_len; ++t) {
                const float diff = a[t] - b[t];
                acc += (double)diff * diff;
            }
            d[tau] = (float)acc;
        }

        // cumulative mean normalized difference
        cmnd[0] = 1.0f;
        double cum = 0.0;
        for (int tau = 1; tau <= tau_max; ++tau) {
            cum += d[tau];
            cmnd[tau] = cum > 1e-12 ? (float)(d[tau] * tau / cum) : 1.0f;
        }

        // absolute threshold, then walk down to the local minimum
        int tau = -1;
        for (int t = tau_min; t < tau_max; ++t) {
            if (cmnd[t] < threshold) {
                tau = t;
                while (tau + 1 < tau_max && cmnd[tau + 1] < cmnd[tau]) ++tau;
                break;
            }
        }
        if (tau < 0) {
            // global minimum, gated for voicing
            float best = 1e9f; int best_t = tau_min;
            for (int t = tau_min; t < tau_max; ++t)
                if (cmnd[t] < best) { best = cmnd[t]; best_t = t; }
            if (best > 0.5f) { f0_out[fi] = 0.0f; continue; }
            tau = best_t;
        }

        // parabolic interpolation
        float tau_f = (float)tau;
        if (tau >= 1 && tau + 1 < tau_max) {
            const float a = cmnd[tau - 1], b = cmnd[tau], c = cmnd[tau + 1];
            const float denom = a - 2.0f * b + c;
            if (std::fabs(denom) > 1e-12f) {
                float shift = 0.5f * (a - c) / denom;
                shift = std::max(-1.0f, std::min(1.0f, shift));
                tau_f += shift;
            }
        }
        f0_out[fi] = (float)sample_rate / tau_f;
    }
    return (int)n_frames;
}

}  // extern "C"
