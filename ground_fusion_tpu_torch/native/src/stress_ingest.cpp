// Concurrency stress driver for the ingest runtime, built and run under
// ThreadSanitizer by tests/test_torch_native.py: two producer threads push
// IMU/wheel samples at full speed while a consumer drains padded intervals
// and a syncer pairs timestamps — the exact contention pattern of the live
// pipeline (callbacks vs processMeasurements, rosNodeTest.cpp:290-565).
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <thread>
#include <vector>

extern "C" {
void* gf_ingest_create();
void gf_ingest_destroy(void*);
void gf_push_imu(void*, double, const double*, const double*);
void gf_push_wheel(void*, double, const double*, const double*);
int gf_drain_imu(void*, double, double, int, double*, double*, double*,
                 uint8_t*, double*, double*);
int gf_drain_wheel(void*, double, double, int, double*, double*, double*,
                   uint8_t*, double*, double*);
int gf_sync_pairs(const double*, int, const double*, int, double, int*, int*,
                  int);
}

int main() {
    void* h = gf_ingest_create();
    std::atomic<bool> stop{false};

    std::thread imu([&] {
        double a[3] = {0.1, 0.2, 9.8}, g[3] = {0.01, 0.02, 0.03};
        for (int k = 0; !stop.load(std::memory_order_relaxed); ++k)
            gf_push_imu(h, k * 0.005, a, g);
    });
    std::thread wheel([&] {
        double v[3] = {0.5, 0.0, 0.0}, g[3] = {0.0, 0.0, 0.1};
        for (int k = 0; !stop.load(std::memory_order_relaxed); ++k)
            gf_push_wheel(h, k * 0.01, v, g);
    });
    std::thread consumer([&] {
        const int cap = 64;
        std::vector<double> dts(cap), a(cap * 3), b(cap * 3), a0(3), b0(3);
        std::vector<uint8_t> valid(cap);
        for (int k = 0; k < 2000; ++k) {
            double t1 = k * 0.1;
            gf_drain_imu(h, t1 - 0.1, t1, cap, dts.data(), a.data(), b.data(),
                         valid.data(), a0.data(), b0.data());
            gf_drain_wheel(h, t1 - 0.1, t1, cap, dts.data(), a.data(),
                           b.data(), valid.data(), a0.data(), b0.data());
        }
        stop.store(true, std::memory_order_relaxed);
    });

    imu.join();
    wheel.join();
    consumer.join();
    gf_ingest_destroy(h);
    std::puts("stress OK");
    return 0;
}
