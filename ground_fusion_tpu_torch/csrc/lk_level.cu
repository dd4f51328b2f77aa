// Lucas-Kanade tracking of a feature batch on Hopper: the whole bidirectional pyramidal
// track of `frontend/klt.py::track_bidirectional` in one launch (`lk_track`), and, with
// `levels = 1`, forward only and no final masks, one pyramid level (`lk_level`).
//
// Replaces the TPU kernel `lk_level_pallas` (ground_fusion_tpu/ops/pallas/klt.py:177, kernel
// body `_make_kernel`, sampler `_bilinear_from_window`) and computes what the chain of
// `ops/cuda/klt.py::lk_level_reference` computes, image borders included: every tap clamps
// its own integer corner to [0, w-2] x [0, h-2] while its fraction stays unclamped.
//
// What bounded the previous design (one 256-thread block per feature, one launch per level
// and direction) on an H100 was neither bytes nor operations, which are about a microsecond
// a track each:
//   (1) six launches a tracked frame, with about 60 small tensor operations of host work
//       between them (rescale, masks, the round-trip gate);
//   (2) latency inside each launch: ten dependent iterations, each gathering 441 bilinear
//       taps straight from global memory at L2 latency and reducing them with two block
//       barriers; 12.7 us of device time a launch at every level size alike.
//
// This design:
//   - One launch a frame, one block of kWarps = 4 warps a feature for the whole track:
//     forward coarse to fine, backward, the round-trip gate. The chains are independent of
//     each other, so every thread holds the feature's point, mask and 2x2 system in
//     registers. A reduction is five xor-shuffle steps in each warp, then one barrier to add
//     the four warps' sums in shared memory in warp order, so every thread holds the same
//     point. (Two and eight warps measured slower.)
//   - The patch size is a template parameter (half-sizes 1..14), so each thread's share of
//     the patch (four taps at half 10) is unrolled, with its template value and gradients in
//     registers.
//   - Taps read shared memory. At each level the block stages the window of the template
//     image that the (2*half+3)^2 bordered template reads and a window of the search image
//     around the seed with a margin of kMargin px. A thread issues all its loads of both
//     windows before its first store, so a stage costs one round trip to L2 (staged with
//     4-byte cp.async instead, the windows took several). An iterate whose taps would leave
//     the window re-stages it around itself; the kernel counts that per feature. Windows
//     are placed by clamped coordinates, so each tap reads the very pixels the plain
//     version reads.
//   - The sampling grid is separable: all taps of a patch column share their x, all taps
//     of a row their y. In each warp, lane j computes column j's and row j's corner and
//     fraction once an iteration (four float/int conversions a lane instead of four a tap)
//     and each tap gathers its two by warp shuffle; the values are the plain version's, bit
//     for bit.
//   - Exactly `iters` iterations, as the plain version runs them. A feature that is invalid
//     or fails the eigenvalue gate keeps its point bit for bit at that level and stays
//     invalid below it.
//
// What still bounds it (PERF.md): latency, not bytes or operations. An iteration is a
// dependent chain (grid, shuffles, shared loads, multiply-adds, the block reduction with
// its barrier, the update) of about half a microsecond; a level adds a round trip to L2
// and the template.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxHalf = 14;              // half-sizes 1..14: a bordered template row fits a warp
constexpr int kMargin = 4;                // px an iterate may move before its window is re-staged
constexpr int kWarps = 4;                 // warps a feature (a block)
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

struct Pyramid {
    const float* img[kMaxLevels];
    int h[kMaxLevels];
    int w[kMaxLevels];
};

// Where a staged window lies in its level image: origin and extent; its rows lie `pitch`
// floats apart in shared memory (the window's full side, known at compile time).
struct Window {
    int ox, oy, ww, wh, pitch;
};

// Shared floats one block (feature) needs: the bordered template, the template image's
// window, the search image's window, and two rounds of the warps' partial sums.
__host__ __device__ constexpr int block_floats(int half) {
    return (2 * half + 3) * (2 * half + 3) + (2 * half + 5) * (2 * half + 5)
         + (2 * (half + kMargin) + 3) * (2 * (half + kMargin) + 3) + 2 * kWarps * 3;
}

// Sum K values over the block: five xor-shuffle steps in each warp (every lane ends with
// the same sum, added in the same order), then the warps' sums through shared memory, added
// in warp order by every thread. `xb` holds two rounds of 3 * kWarps floats; `round`, the
// same in every thread, picks the one this call writes, so one barrier a call suffices (a
// warp cannot write a round's slot again before every warp has passed the next barrier).
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* xb, int& round, int warp,
                                          int lane) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(kFull, v[k], off);
    }
    float* slot = xb + (round & 1) * 3 * kWarps;
    ++round;
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) slot[warp * 3 + k] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
        float sum = slot[k];
#pragma unroll
        for (int q = 1; q < kWarps; ++q) sum += slot[q * 3 + k];
        v[k] = sum;
    }
}

// floorf(v) as an int, clamped to [lo, hi] in float first (NaN goes to lo)
__device__ __forceinline__ int floor_to(float v, int lo, int hi) {
    return static_cast<int>(fminf(fmaxf(floorf(v), static_cast<float>(lo)), static_cast<float>(hi)));
}

// The window holding the pixels that taps of radius r around (cx, cy) read, with `margin` px
// to spare: rows and columns [f - r - margin, f + r + margin + 2] of the level image (f the
// floor of the centre), shifted inside the image. Every tap clamps its corner into
// [0, w-2], so a centre far outside still reads pixels of the window.
__device__ __forceinline__ Window place(int h, int w, float cx, float cy, int r, int margin) {
    Window s;
    const int side = 2 * (r + margin) + 3;
    s.ww = min(side, w);
    s.wh = min(side, h);
    s.pitch = side;
    s.ox = min(max(floor_to(cx, -(r + 2), w + r + 2) - r - margin, 0), w - s.ww);
    s.oy = min(max(floor_to(cy, -(r + 2), h + r + 2) - r - margin, 0), h - s.wh);
    return s;
}

// A thread's loads of a SIDE x SIDE window (the part inside the image): slot k holds window
// element t + kThreads * k. All loads of a stage are issued before the first store, so a
// stage costs one round trip to L2 instead of one per batch of loads.
template <int SIDE>
struct Staged {
    static constexpr int kN = (SIDE * SIDE + kThreads - 1) / kThreads;
    float v[kN];

    __device__ __forceinline__ void load(const float* img, int w, const Window& s, int t) {
#pragma unroll
        for (int k = 0; k < kN; ++k) {
            const int i = t + kThreads * k, row = i / SIDE, col = i - row * SIDE;
            v[k] = row < s.wh && col < s.ww
                 ? __ldg(img + static_cast<size_t>(s.oy + row) * w + s.ox + col) : 0.0f;
        }
    }

    __device__ __forceinline__ void store(float* win, int t) const {
#pragma unroll
        for (int k = 0; k < kN; ++k) {
            if (t + kThreads * k < SIDE * SIDE) win[t + kThreads * k] = v[k];
        }
    }
};

// Whether every tap of radius r around (cx, cy) reads inside the window: before clamping,
// the corners of the taps lie in [f - r, f + r + 1], f the floor of the centre.
__device__ __forceinline__ bool covers(const Window& s, int h, int w, float cx, float cy, int r) {
    const int fx = floor_to(cx, -(r + 2), w + r + 2);
    const int fy = floor_to(cy, -(r + 2), h + r + 2);
    const int x_lo = min(max(fx - r, 0), w - 2), x_hi = min(max(fx + r + 1, 0), w - 2);
    const int y_lo = min(max(fy - r, 0), h - 2), y_hi = min(max(fy + r + 1, 0), h - 2);
    return x_lo >= s.ox && x_hi + 1 < s.ox + s.ww && y_lo >= s.oy && y_hi + 1 < s.oy + s.wh;
}

// The sampling grid of a (2r+1)^2 patch around (cx, cy) is separable: every tap of column j
// sits at x = cx + (j - r) and every tap of row j at y = cy + (j - r), so lane j < 2r+1
// computes column j's and row j's part once: the corner clamped into [0, w-2] x [0, h-2]
// (float clamp first, so the conversion never sees a value out of int range) as an offset
// into the window, and the unclamped fraction. A tap gathers its parts by shuffle.
struct Grid {
    int col, row;         // window offsets of column `lane` and row `lane` (row premultiplied)
    float fx, fy;         // their fractions
};

__device__ __forceinline__ Grid grid(const Window& s, int h, int w, float cx, float cy, int r,
                                     int lane) {
    const float gx = cx + static_cast<float>(lane - r), gy = cy + static_cast<float>(lane - r);
    const float x0 = floorf(gx), y0 = floorf(gy);
    const int xi = min(max(static_cast<int>(fminf(fmaxf(x0, -1.0f), static_cast<float>(w))), 0), w - 2);
    const int yi = min(max(static_cast<int>(fminf(fmaxf(y0, -1.0f), static_cast<float>(h))), 0), h - 2);
    Grid g;
    g.col = xi - s.ox;
    g.row = (yi - s.oy) * s.pitch;
    g.fx = gx - x0;
    g.fy = gy - y0;
    return g;
}

// The bilinear tap of column c and row r of the grid, read from the window (all lanes call
// it: it shuffles).
__device__ __forceinline__ float tap(const float* win, int pitch, const Grid& g, int c, int r) {
    const float* p0 = win + __shfl_sync(kFull, g.row, r) + __shfl_sync(kFull, g.col, c);
    const float fx = __shfl_sync(kFull, g.fx, c), fy = __shfl_sync(kFull, g.fy, r);
    return p0[0] * (1.0f - fx) * (1.0f - fy) + p0[1] * fx * (1.0f - fy)
         + p0[pitch] * (1.0f - fx) * fy + p0[pitch + 1] * fx * fy;
}

// A thread's share of the (2*HALF+1)^2 patch: slot k = 0..kN-1 holds patch index
// t + kThreads * k (the last slot only for the first kLast threads): its row and column, and
// the template value and gradients there, all in registers.
template <int HALF>
struct Patch {
    static constexpr int kP = 2 * HALF + 1;
    static constexpr int kPB = kP + 2;                 // bordered template side
    static constexpr int kN = (kP * kP + kThreads - 1) / kThreads;
    static constexpr int kLast = kP * kP - kThreads * (kN - 1);
    static constexpr int kNB = (kPB * kPB + kThreads - 1) / kThreads;
    int r[kN], c[kN];
    float t[kN], gx[kN], gy[kN];
};

// The threads of a feature's block: t in the block, its warp and lane, and the round of
// block_sum, the same in every thread.
struct Thread {
    int t, warp, lane, round;
};

// One LK level of one feature, run by its block: template in `tpl_img` at (tx, ty), search
// in `img` from (x, y), both at this level's scale. Returns whether the feature passed the
// eigenvalue gate; only then is (x, y) updated.
template <int HALF>
__device__ __forceinline__ bool solve_level(float* sw, Patch<HALF>& pt, const float* tpl_img,
                                            const float* img, int h, int w, float tx, float ty,
                                            float& x, float& y, int iters, float min_eig,
                                            Thread& th, int& restages) {
    constexpr int kP = Patch<HALF>::kP, kPB = Patch<HALF>::kPB;
    constexpr int kTplSide = 2 * HALF + 5, kWinSide = 2 * (HALF + kMargin) + 3;
    float* tb = sw;                                    // kPB^2: template with a 1 px border
    float* twin = tb + kPB * kPB;                      // the template image's window
    float* swin = twin + kTplSide * kTplSide;          // the search image's window
    float* xb = swin + kWinSide * kWinSide;            // block_sum's two rounds
    const int t = th.t, lane = th.lane;

    // both windows in one round trip
    const Window ts = place(h, w, tx, ty, HALF + 1, 0);
    Window ss = place(h, w, x, y, HALF, kMargin);
    {
        Staged<kTplSide> tv;
        Staged<kWinSide> sv;
        tv.load(tpl_img, w, ts, t);
        sv.load(img, w, ss, t);
        __syncthreads();                               // every thread is done with the old windows
        tv.store(twin, t);
        sv.store(swin, t);
        __syncthreads();
    }

    const Grid tg = grid(ts, h, w, tx, ty, HALF + 1, lane);
#pragma unroll
    for (int k = 0; k < Patch<HALF>::kNB; ++k) {
        const int i = t + kThreads * k;
        const int r = i < kPB * kPB ? i / kPB : 0, c = i < kPB * kPB ? i - r * kPB : 0;
        const float v = tap(twin, ts.pitch, tg, c, r);
        if (i < kPB * kPB) tb[i] = v;
    }
    __syncthreads();

    // central-difference gradients and the 2x2 structure tensor
    float a[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < Patch<HALF>::kN; ++k) {
        const int r = pt.r[k], c = pt.c[k];
        const float gx = 0.5f * (tb[(r + 1) * kPB + c + 2] - tb[(r + 1) * kPB + c]);
        const float gy = 0.5f * (tb[(r + 2) * kPB + c + 1] - tb[r * kPB + c + 1]);
        const bool mine = k < Patch<HALF>::kN - 1 || t < Patch<HALF>::kLast;
        pt.t[k] = tb[(r + 1) * kPB + c + 1];
        pt.gx[k] = mine ? gx : 0.0f;
        pt.gy[k] = mine ? gy : 0.0f;
        a[0] += pt.gx[k] * pt.gx[k];
        a[1] += pt.gx[k] * pt.gy[k];
        a[2] += pt.gy[k] * pt.gy[k];
    }
    block_sum<3>(a, xb, th.round, th.warp, lane);
    const float a11 = a[0], a12 = a[1], a22 = a[2];
    const float det = a11 * a22 - a12 * a12;
    const float tr = a11 + a22;
    const float eig_min = 0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.0f * det, 0.0f)));
    if (!(eig_min / static_cast<float>(kP * kP) > min_eig)) return false;   // uniform over the block
    const float inv = det > 1e-12f ? 1.0f / det : 0.0f;

    // Gauss-Newton updates of the point against the search image; every thread holds the
    // same point, so the window test is uniform over the block
    float px = x, py = y;
    for (int it = 0; it < iters; ++it) {
        if (!covers(ss, h, w, px, py, HALF)) {
            ss = place(h, w, px, py, HALF, kMargin);
            Staged<kWinSide> sv;
            sv.load(img, w, ss, t);
            __syncthreads();
            sv.store(swin, t);
            __syncthreads();
            ++restages;
        }
        const Grid g = grid(ss, h, w, px, py, HALF, lane);
        float b[2] = {0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < Patch<HALF>::kN; ++k) {
            const float e = tap(swin, ss.pitch, g, pt.c[k], pt.r[k]) - pt.t[k];
            b[0] += e * pt.gx[k];          // 0 in a slot past the patch
            b[1] += e * pt.gy[k];
        }
        block_sum<2>(b, xb, th.round, th.warp, lane);
        px -= inv * (a22 * b[0] - a12 * b[1]);
        py -= inv * (-a12 * b[0] + a11 * b[1]);
    }
    x = px;
    y = py;
    return true;
}

// Coarse to fine over `levels` levels: the template in `ta` at (tx, ty), the search in `sa`
// from (x, y), all at full resolution; (x, y) is updated in place. With `masks`, a point
// that ends outside [1, w-2) x [1, h-2) of the finest search level is not ok.
template <int HALF>
__device__ __forceinline__ bool pyramidal(float* sw, Patch<HALF>& pt, const Pyramid& ta,
                                          const Pyramid& sa, int levels, float tx, float ty,
                                          float& x, float& y, bool ok, int iters, float min_eig,
                                          bool masks, Thread& th, int& restages) {
    const float top = static_cast<float>(1 << (levels - 1));
    float px = x / top, py = y / top;
    for (int lvl = levels - 1; lvl >= 0; --lvl) {
        const float scale = static_cast<float>(1 << lvl);
        if (ok) {
            ok = solve_level<HALF>(sw, pt, ta.img[lvl], sa.img[lvl], sa.h[lvl], sa.w[lvl],
                                   tx / scale, ty / scale, px, py, iters, min_eig, th, restages);
        }
        if (lvl > 0) {
            px *= 2.0f;
            py *= 2.0f;
        }
    }
    if (masks) {
        const float w = static_cast<float>(sa.w[0]), h = static_cast<float>(sa.h[0]);
        ok = ok && px >= 1.0f && px < w - 2.0f && py >= 1.0f && py < h - 2.0f;
    }
    x = px;
    y = py;
    return ok;
}

template <int HALF>
__global__ void __launch_bounds__(kThreads)
lk_track_kernel(Pyramid prev, Pyramid cur, const float* __restrict__ pts_prev, int prev_stride,
                const float* __restrict__ pts_seed, int seed_stride,
                const uint8_t* __restrict__ valid, float* __restrict__ out_pts,
                uint8_t* __restrict__ out_ok, int32_t* __restrict__ out_restages, int n,
                int levels, int iters, float min_eig, int track, float fb_thresh) {
    extern __shared__ float sw[];          // block_floats(HALF)
    Thread th = {static_cast<int>(threadIdx.x), static_cast<int>(threadIdx.x) >> 5,
                 static_cast<int>(threadIdx.x) & 31, 0};
    const int f = blockIdx.x;

    Patch<HALF> pt;
#pragma unroll
    for (int k = 0; k < Patch<HALF>::kN; ++k) {
        const int i = th.t + kThreads * k;   // a slot past the patch samples (0, 0) with weight 0
        const bool mine = i < Patch<HALF>::kP * Patch<HALF>::kP;
        pt.r[k] = mine ? i / Patch<HALF>::kP : 0;
        pt.c[k] = mine ? i % Patch<HALF>::kP : 0;
    }

    const float prev_x = pts_prev[static_cast<size_t>(f) * prev_stride];
    const float prev_y = pts_prev[static_cast<size_t>(f) * prev_stride + 1];
    float x = pts_seed[static_cast<size_t>(f) * seed_stride];
    float y = pts_seed[static_cast<size_t>(f) * seed_stride + 1];
    int restages = 0;
    bool ok = pyramidal<HALF>(sw, pt, prev, cur, levels, prev_x, prev_y, x, y, valid[f] != 0,
                              iters, min_eig, track != 0, th, restages);
    if (track) {
        // backward: template in the current pyramid at the forward result, search in the
        // previous one from the previous point; keep if the round trip lands within fb_thresh
        float bx = prev_x, by = prev_y;
        const bool ok_b = pyramidal<HALF>(sw, pt, cur, prev, levels, x, y, bx, by, ok, iters,
                                          min_eig, true, th, restages);
        const float dx = bx - prev_x, dy = by - prev_y;
        ok = ok && ok_b && sqrtf(dx * dx + dy * dy) <= fb_thresh;
    }
    if (th.t == 0) {
        out_pts[2 * f] = x;
        out_pts[2 * f + 1] = y;
        out_ok[f] = ok ? 1 : 0;
        out_restages[f] = restages;
    }
}

struct Launch {
    Pyramid prev, cur;
    const float* pts_prev;
    int prev_stride;
    const float* pts_seed;
    int seed_stride;
    const uint8_t* valid;
    float* out_pts;
    uint8_t* out_ok;
    int32_t* out_restages;
    int n, levels, iters;
    float min_eig;
    int track;
    float fb_thresh;
    cudaStream_t stream;
};

template <int HALF>
void launch(const Launch& l) {
    const size_t shmem = block_floats(HALF) * sizeof(float);
    lk_track_kernel<HALF><<<l.n, kThreads, shmem, l.stream>>>(
        l.prev, l.cur, l.pts_prev, l.prev_stride, l.pts_seed, l.seed_stride, l.valid, l.out_pts,
        l.out_ok, l.out_restages, l.n, l.levels, l.iters, l.min_eig, l.track, l.fb_thresh);
}

// launch<half> for a half-size known only at run time; false if it is not instantiated
template <int HALF>
bool dispatch(int half, const Launch& l) {
    if (half == HALF) {
        launch<HALF>(l);
        return true;
    }
    if constexpr (HALF < kMaxHalf) {
        return dispatch<HALF + 1>(half, l);
    } else {
        return false;
    }
}

static_assert(block_floats(kMaxHalf) * 4 <= 48 * 1024,
              "the largest patch must fit a block's default shared memory");

}  // namespace

// prev_imgs / cur_imgs: `levels` device pointers each (finest first), f32 [hs[l], ws[l]]
// contiguous, the two pyramids of one shape. Points are f32 (x, y) rows `*_stride` floats
// apart. Outputs: out_pts [n,2] f32, out_ok [n] bytes, out_restages [n] int32.
// track = 1: the bidirectional track with its masks and gate; track = 0: forward only, no
// final masks (with levels = 1, one LK level). half in [1, 14]. Launches on `stream` of
// `device` without synchronising and returns the CUDA error of the launch (0 = launched).
extern "C" int lk_track_launch(const float* const* prev_imgs, const float* const* cur_imgs,
                               const int* hs, const int* ws, int levels, const float* pts_prev,
                               int prev_stride, const float* pts_seed, int seed_stride,
                               const uint8_t* valid, float* out_pts, uint8_t* out_ok,
                               int32_t* out_restages, int n, int half, int iters, float min_eig,
                               int track, float fb_thresh, int device, void* stream) {
    if (levels < 1 || levels > kMaxLevels || half < 1 || half > kMaxHalf || iters < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (n <= 0) return 0;
    Launch l = {};
    for (int lv = 0; lv < levels; ++lv) {
        l.prev.img[lv] = prev_imgs[lv];
        l.cur.img[lv] = cur_imgs[lv];
        l.prev.h[lv] = l.cur.h[lv] = hs[lv];
        l.prev.w[lv] = l.cur.w[lv] = ws[lv];
    }
    l.pts_prev = pts_prev;
    l.prev_stride = prev_stride;
    l.pts_seed = pts_seed;
    l.seed_stride = seed_stride;
    l.valid = valid;
    l.out_pts = out_pts;
    l.out_ok = out_ok;
    l.out_restages = out_restages;
    l.n = n;
    l.levels = levels;
    l.iters = iters;
    l.min_eig = min_eig;
    l.track = track;
    l.fb_thresh = fb_thresh;
    l.stream = static_cast<cudaStream_t>(stream);
    int current = 0;
    cudaGetDevice(&current);
    if (current != device) cudaSetDevice(device);
    dispatch<1>(half, l);
    const int err = static_cast<int>(cudaGetLastError());
    if (current != device) cudaSetDevice(current);
    return err;
}
