// Hamming distance of packed 256-bit BRIEF descriptors on Hopper, two entry points:
//
//   hamming_match_launch   for each current descriptor, the first old descriptor at the
//                          least masked distance and whether it is a match: what
//                          `global_layers/brief.py::match_brief` computes, in one launch.
//   hamming_matrix_launch  [Ka, 8] x [Kb, 8] uint32 words -> [Ka, Kb] int32 distances.
//
// Both replace the TPU kernel `hamming_matrix_pallas` (ground_fusion_tpu/ops/pallas/
// hamming.py:66, kernel body `_hamming_kernel`, popcount `_popcount32`): popcount(a XOR b)
// summed over the eight words. The matrix kernel is its one-to-one counterpart; the match
// kernel is what loop closure launches.
//
// What bounds them on an H100: at loop closure's shapes (Kc ~ 100 window descriptors of the
// current keyframe, Kb ~ 600 of the old one) a call reads ~22 KB and does 480 000
// popcounts, both a fraction of a microsecond; the launch and the host work around it are
// the floor. What held the previous design back was exactly that: the matrix kernel took
// 1.6 us on the device, but each call spent 20-27 us of host work in its wrapper, and
// `match_brief` then made four more device passes over the [Kc, Kb] matrix (mask, argmin,
// gather, gate), which went through device memory only to be reduced to one index a row.
//
// The match kernel's design: one launch, no [Kc, Kb] matrix in device memory. A block of
// eight warps stages the old descriptors and their mask in shared memory with 16-byte
// cp.async, in chunks of kChunk (16 KB); each warp owns one current row, whose eight words
// every lane keeps in registers, and the lanes stride over the staged descriptors: eight
// __popc(a ^ b), 10 000 where the old descriptor is masked, a running minimum per lane that
// keeps the first index on ties (a lane visits its columns in increasing order). The lanes
// then reduce lexicographically on (distance, index), an associative and commutative
// operation, so ties go to the lowest index exactly, whatever the order: the first minimum,
// as `torch.argmin` and `jnp.argmin` give it. A row whose old set is all masked gets index
// 0 and no match, as in the plain version.
//
// The matrix kernel: a block of 32 x 8 threads owns one 32 x 32 output tile, stages its 32
// `a` and 32 `b` descriptors in shared memory with 16-byte loads, each thread keeps its
// column's `b` words in registers and computes four outputs; a warp's stores are 32
// consecutive int32 (coalesced); ragged edges are masked, not padded.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWords = 8;                  // 256-bit descriptors
constexpr int kVecPerDesc = kWords / 4;    // uint4 per descriptor
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- fused masked match

constexpr int kMatchWarps = 8;             // current rows per block, one warp each
constexpr int kChunk = 512;                // old descriptors staged per pass (16 KB)
constexpr int kMasked = 10000;             // the distance of a masked old descriptor

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int hamming_distance(const uint4& a0, const uint4& a1,
                                                const uint4& b0, const uint4& b1) {
    return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w)
         + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) + __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

__global__ void __launch_bounds__(32 * kMatchWarps)
hamming_match_kernel(const uint4* __restrict__ a, const uint8_t* __restrict__ ok_a,
                     const uint4* __restrict__ b, const uint8_t* __restrict__ ok_b,
                     int64_t* __restrict__ out_idx, uint8_t* __restrict__ out_matched, int ka,
                     int kb, int thresh) {
    __shared__ uint4 sb[kChunk * kVecPerDesc];
    __shared__ uint8_t sok[kChunk];

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row = blockIdx.x * kMatchWarps + warp;
    const bool live = row < ka;            // uniform over the warp
    uint4 a0 = make_uint4(0, 0, 0, 0), a1 = a0;
    if (live) {
        a0 = __ldg(a + static_cast<size_t>(row) * kVecPerDesc);
        a1 = __ldg(a + static_cast<size_t>(row) * kVecPerDesc + 1);
    }
    int best_d = INT_MAX, best_i = INT_MAX;
    for (int base = 0; base < kb; base += kChunk) {
        const int cnt = min(kChunk, kb - base);
        __syncthreads();                   // every warp is done with the previous chunk
        for (int v = threadIdx.x; v < cnt * kVecPerDesc; v += blockDim.x) {
            cp_async16(sb + v, b + static_cast<size_t>(base) * kVecPerDesc + v);
        }
        for (int j = threadIdx.x; j < cnt; j += blockDim.x) sok[j] = ok_b[base + j];
        cp_async_wait_all();
        __syncthreads();
        if (live) {
            for (int j = lane; j < cnt; j += 32) {
                const uint4* bj = sb + j * kVecPerDesc;
                const int d = sok[j] ? hamming_distance(a0, a1, bj[0], bj[1]) : kMasked;
                if (d < best_d) {          // strict: a lane's first minimum stays
                    best_d = d;
                    best_i = base + j;
                }
            }
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const int od = __shfl_xor_sync(kFull, best_d, off);
        const int oi = __shfl_xor_sync(kFull, best_i, off);
        if (od < best_d || (od == best_d && oi < best_i)) {
            best_d = od;
            best_i = oi;
        }
    }
    if (live && lane == 0) {
        out_idx[row] = best_i;
        out_matched[row] = (ok_a[row] != 0 && best_d < thresh) ? 1 : 0;
    }
}

// ---------------------------------------------------------------- distance matrix

constexpr int kTile = 32;                  // output tile is kTile x kTile
constexpr int kRowsPerPass = 8;            // blockDim.y

__global__ void __launch_bounds__(kTile * kRowsPerPass)
hamming_matrix_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                      int32_t* __restrict__ out, int ka, int kb) {
    __shared__ uint4 sa[kTile][kVecPerDesc];
    __shared__ uint4 sb[kTile][kVecPerDesc];

    const int row0 = blockIdx.y * kTile;
    const int col0 = blockIdx.x * kTile;
    const int tid = threadIdx.y * kTile + threadIdx.x;   // 0..255

    // threads 0..63 stage `a`, 64..127 stage `b`; rows past the edge are zeros
    // (they are never stored)
    if (tid < kTile * kVecPerDesc) {
        const int r = tid / kVecPerDesc, v = tid % kVecPerDesc;
        const int gr = row0 + r;
        sa[r][v] = gr < ka ? __ldg(a + (size_t)gr * kVecPerDesc + v) : make_uint4(0, 0, 0, 0);
    } else if (tid < 2 * kTile * kVecPerDesc) {
        const int t = tid - kTile * kVecPerDesc;
        const int r = t / kVecPerDesc, v = t % kVecPerDesc;
        const int gr = col0 + r;
        sb[r][v] = gr < kb ? __ldg(b + (size_t)gr * kVecPerDesc + v) : make_uint4(0, 0, 0, 0);
    }
    __syncthreads();

    const int col = col0 + threadIdx.x;
    const uint4 b0 = sb[threadIdx.x][0];
    const uint4 b1 = sb[threadIdx.x][1];
#pragma unroll
    for (int p = 0; p < kTile / kRowsPerPass; ++p) {
        const int r = threadIdx.y + p * kRowsPerPass;
        const int d = hamming_distance(sa[r][0], sa[r][1], b0, b1);
        const int row = row0 + r;
        if (row < ka && col < kb) {
            out[(size_t)row * kb + col] = d;
        }
    }
}

// Makes `device` current for the launch and puts the previous one back.
struct DeviceScope {
    int previous = 0;
    int wanted;
    explicit DeviceScope(int device) : wanted(device) {
        cudaGetDevice(&previous);
        if (previous != wanted) cudaSetDevice(wanted);
    }
    ~DeviceScope() {
        if (previous != wanted) cudaSetDevice(previous);
    }
};

}  // namespace

// a: [ka, 8] uint32 words, ok_a: [ka] bytes, b: [kb, 8], ok_b: [kb] bytes; out_idx [ka]
// int64, out_matched [ka] bytes; device pointers, descriptors 16-byte aligned and
// contiguous, kb >= 1. Launches on `stream` of `device` without synchronising and returns
// the CUDA error of the launch (0 on success).
extern "C" int hamming_match_launch(const void* a, const void* ok_a, const void* b,
                                    const void* ok_b, void* out_idx, void* out_matched, int ka,
                                    int kb, int thresh, int device, void* stream) {
    if (ka <= 0) return 0;
    if (kb <= 0) return static_cast<int>(cudaErrorInvalidValue);
    DeviceScope scope(device);
    hamming_match_kernel<<<(ka + kMatchWarps - 1) / kMatchWarps, 32 * kMatchWarps, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(a), static_cast<const uint8_t*>(ok_a),
        static_cast<const uint4*>(b), static_cast<const uint8_t*>(ok_b),
        static_cast<int64_t*>(out_idx), static_cast<uint8_t*>(out_matched), ka, kb, thresh);
    return static_cast<int>(cudaGetLastError());
}

// a: [ka, 8] uint32 words, b: [kb, 8], out: [ka, kb] int32, all device pointers,
// 16-byte aligned and contiguous. Launches on `stream` of `device` without synchronising
// and returns the CUDA error of the launch (0 on success).
extern "C" int hamming_matrix_launch(const void* a, const void* b, void* out, int ka, int kb,
                                     int device, void* stream) {
    if (ka <= 0 || kb <= 0) {
        return 0;
    }
    DeviceScope scope(device);
    const dim3 grid((kb + kTile - 1) / kTile, (ka + kTile - 1) / kTile);
    const dim3 block(kTile, kRowsPerPass);
    hamming_matrix_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(a), static_cast<const uint4*>(b),
        static_cast<int32_t*>(out), ka, kb);
    return static_cast<int>(cudaGetLastError());
}
