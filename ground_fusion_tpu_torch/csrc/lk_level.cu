// One pyramid level of Lucas-Kanade tracking for a batch of features.
//
// Replaces the TPU kernel `lk_level_pallas` (ground_fusion_tpu/ops/pallas/klt.py,
// kernel body `_make_kernel`, sampler `_bilinear_from_window`) and computes what
// `frontend/klt.py::_lk_level` computes, image borders included: every tap clamps
// its own integer corner to [0, w-2] x [0, h-2] while its fraction stays unclamped.
//
// What bounds it on an H100: nothing the card is short of. One launch at N = 150
// touches two images of at most 1.2 MB (resident in the 50 MB L2 after the first
// tap) and does about 13 MFLOP, so both the byte time and the operation time are
// around a microsecond; the floor is the launch itself plus ten dependent
// iterations, each a gather, a block-wide reduction and a broadcast of the point.
//
// Design: one block per feature, so the 150 solves run side by side on the SMs and
// the latency of one solve is all that is left. The (2*half+3)^2 template and its
// central-difference gradients live in shared memory; the 2x2 structure tensor and
// each iteration's right-hand side are reduced with warp shuffles plus a
// shared-memory combine that every thread reads back in the same order, so all
// threads hold the identical new point and no separate broadcast is needed. The
// taps of the current image are read straight from global memory (no window
// gather, no selection matmuls: those existed for a machine that cannot read from
// arbitrary offsets). A feature that is invalid or fails the eigenvalue gate
// leaves the block at once and keeps its seed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float bilinear_tap(const float* __restrict__ img, int h, int w,
                                              float gx, float gy) {
    const float x0 = floorf(gx);
    const float y0 = floorf(gy);
    const float fx = gx - x0;
    const float fy = gy - y0;
    // float clamp first so that the conversion never sees a value out of int range
    int xi = (int)fminf(fmaxf(x0, -1.0f), (float)w);
    int yi = (int)fminf(fmaxf(y0, -1.0f), (float)h);
    xi = min(max(xi, 0), w - 2);
    yi = min(max(yi, 0), h - 2);
    const float* row0 = img + (size_t)yi * w + xi;
    const float* row1 = row0 + w;
    const float i00 = __ldg(row0), i01 = __ldg(row0 + 1);
    const float i10 = __ldg(row1), i11 = __ldg(row1 + 1);
    return i00 * (1.0f - fx) * (1.0f - fy) + i01 * fx * (1.0f - fy)
         + i10 * (1.0f - fx) * fy + i11 * fx * fy;
}

// Sum K per-thread values over the block. Every thread returns the same totals,
// added in the same order. `red` holds K * kWarps floats.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
        if (lane == 0) red[k * kWarps + warp] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < kWarps; ++i) s += red[k * kWarps + i];
        v[k] = s;
    }
    __syncthreads();  // red is free again
}

__global__ void __launch_bounds__(kThreads)
lk_level_kernel(const float* __restrict__ prev_img, const float* __restrict__ cur_img,
                const float* __restrict__ pts_prev, const float* __restrict__ pts_cur,
                const uint8_t* __restrict__ valid, float* __restrict__ out_pts,
                uint8_t* __restrict__ out_ok, int h, int w, int half, int iters,
                float min_eig) {
    extern __shared__ float smem[];
    const int p = 2 * half + 1;   // patch side
    const int pb = p + 2;         // template side (1 px border for the gradients)
    float* tpl = smem;            // pb * pb
    float* gxs = tpl + pb * pb;   // p * p
    float* gys = gxs + p * p;     // p * p
    float* red = gys + p * p;     // 3 * kWarps

    const int f = blockIdx.x;
    const int tid = threadIdx.x;
    const float seed_x = pts_cur[2 * f], seed_y = pts_cur[2 * f + 1];

    if (!valid[f]) {              // uniform over the block
        if (tid == 0) { out_pts[2 * f] = seed_x; out_pts[2 * f + 1] = seed_y; out_ok[f] = 0; }
        return;
    }

    // template (+1 px border) at the previous point
    const float ppx = pts_prev[2 * f], ppy = pts_prev[2 * f + 1];
    for (int i = tid; i < pb * pb; i += kThreads) {
        const int r = i / pb, c = i - r * pb;
        tpl[i] = bilinear_tap(prev_img, h, w, ppx + (float)(c - (half + 1)),
                              ppy + (float)(r - (half + 1)));
    }
    __syncthreads();

    // central-difference gradients and the 2x2 structure tensor
    float a[3] = {0.0f, 0.0f, 0.0f};
    for (int i = tid; i < p * p; i += kThreads) {
        const int r = i / p, c = i - r * p;
        const float gx = 0.5f * (tpl[(r + 1) * pb + c + 2] - tpl[(r + 1) * pb + c]);
        const float gy = 0.5f * (tpl[(r + 2) * pb + c + 1] - tpl[r * pb + c + 1]);
        gxs[i] = gx;
        gys[i] = gy;
        a[0] += gx * gx;
        a[1] += gx * gy;
        a[2] += gy * gy;
    }
    block_sum<3>(a, red);
    const float a11 = a[0], a12 = a[1], a22 = a[2];
    const float det = a11 * a22 - a12 * a12;
    const float tr = a11 + a22;
    const float eig_min = 0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.0f * det, 0.0f)));
    const bool good = (eig_min / (float)(p * p)) > min_eig;
    if (!good) {                  // uniform over the block
        if (tid == 0) { out_pts[2 * f] = seed_x; out_pts[2 * f + 1] = seed_y; out_ok[f] = 0; }
        return;
    }
    const float inv = det > 1e-12f ? 1.0f / det : 0.0f;

    // Gauss-Newton updates of the point against the current image
    float px = seed_x, py = seed_y;
    for (int it = 0; it < iters; ++it) {
        float b[2] = {0.0f, 0.0f};
        for (int i = tid; i < p * p; i += kThreads) {
            const int r = i / p, c = i - r * p;
            const float e = bilinear_tap(cur_img, h, w, px + (float)(c - half),
                                         py + (float)(r - half))
                          - tpl[(r + 1) * pb + c + 1];
            b[0] += e * gxs[i];
            b[1] += e * gys[i];
        }
        block_sum<2>(b, red);
        px -= inv * (a22 * b[0] - a12 * b[1]);
        py -= inv * (-a12 * b[0] + a11 * b[1]);
    }
    if (tid == 0) { out_pts[2 * f] = px; out_pts[2 * f + 1] = py; out_ok[f] = 1; }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = launched).
// Shared memory needed: ((2*half+3)^2 + 2*(2*half+1)^2 + 3*8) floats.
extern "C" int lk_level_launch(const float* prev_img, const float* cur_img,
                               const float* pts_prev, const float* pts_cur,
                               const uint8_t* valid, float* out_pts, uint8_t* out_ok,
                               int n, int h, int w, int half, int iters, float min_eig,
                               void* stream) {
    if (n <= 0) return 0;
    const int p = 2 * half + 1, pb = p + 2;
    const size_t shmem = (size_t)(pb * pb + 2 * p * p + 3 * kWarps) * sizeof(float);
    if (shmem > 48 * 1024) return (int)cudaErrorInvalidValue;
    lk_level_kernel<<<n, kThreads, shmem, (cudaStream_t)stream>>>(
        prev_img, cur_img, pts_prev, pts_cur, valid, out_pts, out_ok, h, w, half, iters,
        min_eig);
    return (int)cudaGetLastError();
}
