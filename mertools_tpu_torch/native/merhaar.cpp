// Haar-cascade window evaluator (the detect-faces hot loop).
//
// The port's copy of native/merhaar.cpp. The Python engine
// (mertools_tpu_torch/ops/viola_jones.py) evaluates every stage
// feature for every candidate window with vectorized NumPy; real cascades
// win by EARLY REJECTION — most windows die within the first stages after a
// handful of stumps. This native evaluator walks windows with per-stage
// short-circuiting, mirroring the reference's OpenFace/OpenCV C++ frontends
// (SURVEY.md §2.9). Math matches the NumPy path: double integral images,
// OpenCV variance normalization over the (1,1,W-2,W-2) rect, stump
// comparisons at float32 thresholds.
//
// Rows evaluate in parallel on std::threads, one a core (independent
// windows, per-window alive flag into a bitmap), and survivors emit in a
// serial deterministic pass, so the output is byte-identical with any
// thread count. (native/merhaar.cpp uses OpenMP for the rows; a toolchain
// without libgomp cannot build that, so this copy needs only the C++
// standard library.)
//
// Built at first use by mertools_tpu_torch/ops/viola_jones.py:build_native
// (g++ -O3 -fPIC -std=c++17 -pthread -shared) into build/native/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <system_error>
#include <thread>
#include <vector>

namespace {

inline bool window_alive(const double* ii, const double* sq, long W1,
                         long window, long y, long x, double area,
                         const long* stage_off, const double* stage_thr,
                         long n_stages, const long* feat_idx,
                         const float* stump_thr, const float* leaves,
                         const long* rects, const float* weights) {
    const long W = window;
#define II(yy, xx) ii[(yy) * W1 + (xx)]
#define SQ(yy, xx) sq[(yy) * W1 + (xx)]
    const long y0 = y + 1, x0 = x + 1;
    const double s = II(y0 + W - 2, x0 + W - 2) - II(y0, x0 + W - 2)
                   - II(y0 + W - 2, x0) + II(y0, x0);
    const double s2 = SQ(y0 + W - 2, x0 + W - 2) - SQ(y0, x0 + W - 2)
                    - SQ(y0 + W - 2, x0) + SQ(y0, x0);
    const double nf = area * s2 - s * s;
    const double vnf =
        nf > 0.0 ? 1.0 / std::sqrt(nf < 1e-12 ? 1e-12 : nf) : 1.0;

    long k = 0;
    for (long st = 0; st < n_stages; ++st) {
        double stage_sum = 0.0;
        const long k_end = stage_off[st + 1];
        for (; k < k_end; ++k) {
            const long f = feat_idx[k];
            const long* r = rects + f * 12;           // 3 rects x (x,y,w,h)
            const float* wt = weights + f * 3;
            double fv = 0.0;
            for (int j = 0; j < 3; ++j) {
                const double wj = (double)wt[j];
                if (wj == 0.0) continue;              // zero-padded rect
                const long rx = x + r[j * 4 + 0];
                const long ry = y + r[j * 4 + 1];
                const long rw = r[j * 4 + 2];
                const long rh = r[j * 4 + 3];
                const double rsum = II(ry + rh, rx + rw) - II(ry, rx + rw)
                                  - II(ry + rh, rx) + II(ry, rx);
                fv += wj * rsum;
            }
            fv *= vnf;
            stage_sum += (fv < (double)stump_thr[k]) ? (double)leaves[k * 2]
                                                     : (double)leaves[k * 2 + 1];
        }
        if (stage_sum < stage_thr[st]) return false;
    }
    return true;
#undef II
#undef SQ
}

}  // namespace

extern "C" {

// Returns the number of surviving windows (<= max_out written to out_yx as
// y,x pairs in row-major order). Geometry arrays use int64.
long mer_haar_detect(const double* ii, const double* sq, long H1, long W1,
                     long window, long stride,
                     const long* stage_off, const double* stage_thr,
                     long n_stages,
                     const long* feat_idx, const float* stump_thr,
                     const float* leaves,
                     const long* rects, const float* weights,
                     long* out_yx, long max_out) {
    const long W = window;
    const long Hi = H1 - 1, Wi = W1 - 1;
    if (Hi < W || Wi < W) return 0;
    const double area = (double)(W - 2) * (double)(W - 2);

    const long ny = (Hi - W) / stride + 1;
    const long nx = (Wi - W) / stride + 1;
    std::vector<unsigned char> alive((size_t)ny * nx, 0);

    // rows t, t + n, t + 2n, ... on thread t of n: interleaved, so the
    // rows near a face (slow: they pass more stages) spread over all
    // threads. A thread takes at least kMinWindows windows: starting one
    // costs ~80 us, the time of ~100 windows that die early (measured on
    // noise frames, 8 cores)
    constexpr long kMinWindows = 256;
    const long n_threads = std::max(1L, std::min(
        {ny, ny * nx / kMinWindows, (long)std::thread::hardware_concurrency()}));
    auto rows = [&](long t) {
        for (long iy = t; iy < ny; iy += n_threads) {
            const long y = iy * stride;
            unsigned char* row = alive.data() + (size_t)iy * nx;
            for (long ix = 0; ix < nx; ++ix) {
                row[ix] = window_alive(ii, sq, W1, W, y, ix * stride, area,
                                       stage_off, stage_thr, n_stages,
                                       feat_idx, stump_thr, leaves, rects,
                                       weights);
            }
        }
    };
    std::vector<std::thread> pool;
    long started = 1;
    try {
        for (long t = 1; t < n_threads; ++t, ++started) pool.emplace_back(rows, t);
    } catch (const std::system_error&) {
        // no more threads: this thread takes the rows of those not started
    }
    for (long t = started; t < n_threads; ++t) rows(t);
    rows(0);
    for (std::thread& th : pool) th.join();

    long count = 0;
    for (long iy = 0; iy < ny && count < max_out; ++iy) {
        const unsigned char* row = alive.data() + (size_t)iy * nx;
        for (long ix = 0; ix < nx && count < max_out; ++ix) {
            if (row[ix]) {
                out_yx[count * 2] = iy * stride;
                out_yx[count * 2 + 1] = ix * stride;
                ++count;
            }
        }
    }
    return count;
}

}  // extern "C"
