// Native sensor-ingest runtime: ring buffers, interval draining, frame sync.
//
// C++ equivalent of the reference's driver-loop hot path
// (rosNodeTest.cpp:290-565 sync_process color/depth pairing at +-3 ms;
// estimator.cpp:406-510 getIMUInterval/getWheelInterval) — the only
// per-sample host work in the pipeline, pulled out of Python so the 200 Hz
// IMU path and the per-frame padded-buffer construction are allocation-free
// and lock-cheap. Exposed through a plain C ABI consumed via ctypes
// (ground_fusion_tpu_torch/native/__init__.py, which builds this file with
// g++ at first use and raises when it cannot).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

struct Sample {
    double t;
    double a[3];
    double b[3];
};

struct Ring {
    std::vector<Sample> buf;
    size_t head = 0;   // next write
    size_t count = 0;
    std::mutex mu;

    explicit Ring(size_t cap) : buf(cap) {}

    void push(double t, const double* a, const double* b) {
        std::lock_guard<std::mutex> lk(mu);
        Sample& s = buf[head];
        s.t = t;
        std::memcpy(s.a, a, sizeof s.a);
        std::memcpy(s.b, b, sizeof s.b);
        head = (head + 1) % buf.size();
        if (count < buf.size()) ++count;
    }

    // Copy samples with t in (t0, t1] into out (time-ordered); returns n.
    // last_before receives the newest sample with t <= t0 (interval start).
    int drain(double t0, double t1, Sample* out, int cap, Sample* last_before) {
        std::lock_guard<std::mutex> lk(mu);
        std::vector<const Sample*> hits;
        const Sample* lb = nullptr;
        for (size_t k = 0; k < count; ++k) {
            size_t idx = (head + buf.size() - count + k) % buf.size();
            const Sample& s = buf[idx];
            if (s.t > t0 + 1e-9 && s.t <= t1 + 1e-9) hits.push_back(&s);
            if (s.t <= t0 + 1e-9 && (!lb || s.t > lb->t)) lb = &s;
        }
        std::sort(hits.begin(), hits.end(),
                  [](const Sample* x, const Sample* y) { return x->t < y->t; });
        int n = std::min<int>(hits.size(), cap);
        for (int k = 0; k < n; ++k) out[k] = *hits[k];
        if (lb && last_before) *last_before = *lb;
        else if (last_before) last_before->t = -1.0;
        return n;
    }
};

struct Ingest {
    Ring imu{1 << 16};
    Ring wheel{1 << 15};
};

}  // namespace

extern "C" {

void* gf_ingest_create() { return new Ingest(); }
void gf_ingest_destroy(void* h) { delete static_cast<Ingest*>(h); }

void gf_push_imu(void* h, double t, const double* acc, const double* gyr) {
    static_cast<Ingest*>(h)->imu.push(t, acc, gyr);
}

void gf_push_wheel(void* h, double t, const double* vel, const double* gyr) {
    static_cast<Ingest*>(h)->wheel.push(t, vel, gyr);
}

// Fills padded interval arrays exactly like pipeline._drain_interval's pad():
// dts[cap], a[cap*3], b[cap*3], valid[cap] (uint8), a0[3], b0[3].
// Returns the number of valid samples.
static int drain_padded(Ring& ring, double t0, double t1, int cap,
                        double* dts, double* a, double* b, uint8_t* valid,
                        double* a0, double* b0) {
    std::vector<Sample> tmp(cap);
    Sample lb;
    int n = ring.drain(t0, t1, tmp.data(), cap, &lb);
    std::memset(dts, 0, sizeof(double) * cap);
    std::memset(a, 0, sizeof(double) * cap * 3);
    std::memset(b, 0, sizeof(double) * cap * 3);
    std::memset(valid, 0, cap);
    double tp = t0;
    for (int k = 0; k < n; ++k) {
        dts[k] = tmp[k].t - tp;
        tp = tmp[k].t;
        std::memcpy(a + 3 * k, tmp[k].a, sizeof tmp[k].a);
        std::memcpy(b + 3 * k, tmp[k].b, sizeof tmp[k].b);
        valid[k] = 1;
    }
    const Sample* seed = (lb.t >= 0) ? &lb : (n > 0 ? &tmp[0] : nullptr);
    if (seed) {
        std::memcpy(a0, seed->a, sizeof seed->a);
        std::memcpy(b0, seed->b, sizeof seed->b);
    } else {
        std::memset(a0, 0, sizeof(double) * 3);
        std::memset(b0, 0, sizeof(double) * 3);
    }
    return n;
}

int gf_drain_imu(void* h, double t0, double t1, int cap, double* dts,
                 double* acc, double* gyr, uint8_t* valid, double* acc0,
                 double* gyr0) {
    return drain_padded(static_cast<Ingest*>(h)->imu, t0, t1, cap, dts, acc,
                        gyr, valid, acc0, gyr0);
}

int gf_drain_wheel(void* h, double t0, double t1, int cap, double* dts,
                   double* vel, double* gyr, uint8_t* valid, double* vel0,
                   double* gyr0) {
    return drain_padded(static_cast<Ingest*>(h)->wheel, t0, t1, cap, dts, vel,
                        gyr, valid, vel0, gyr0);
}

// Timestamp pairing of two streams within tolerance (sync_process ±3 ms,
// rosNodeTest.cpp:290-379): greedy in-order matching. Returns n pairs;
// out_i/out_j receive indices into ts_a / ts_b.
int gf_sync_pairs(const double* ts_a, int na, const double* ts_b, int nb,
                  double tol, int* out_i, int* out_j, int cap) {
    int n = 0, j = 0;
    for (int i = 0; i < na && n < cap; ++i) {
        while (j + 1 < nb &&
               std::fabs(ts_b[j + 1] - ts_a[i]) <= std::fabs(ts_b[j] - ts_a[i]))
            ++j;
        if (j < nb && std::fabs(ts_b[j] - ts_a[i]) <= tol) {
            out_i[n] = i;
            out_j[n] = j;
            ++n;
        }
    }
    return n;
}

}  // extern "C"
