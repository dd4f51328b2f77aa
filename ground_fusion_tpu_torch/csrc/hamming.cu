// Pairwise Hamming distances between two sets of packed 256-bit BRIEF
// descriptors: [Ka, 8] x [Kb, 8] uint32 words -> [Ka, Kb] int32.
//
// Replaces the TPU kernel `hamming_matrix_pallas` (ground_fusion_tpu/ops/pallas/
// hamming.py, kernel body `_hamming_kernel`, popcount `_popcount32`) and computes
// what `global_layers/brief.py::hamming_matrix` computes: for every pair, the
// number of set bits of a XOR b over the eight words.
//
// What bounds it on an H100: at loop closure's shapes (Ka ~ 100 window
// descriptors of the current keyframe, Kb ~ 600 descriptors of the old one) a
// call reads 22 KB and writes 240 KB, and does 480 000 popcounts; the byte time
// (~0.08 us at 3.35 TB/s) and the popcount time (~0.1 us at 16 per clock per SM
// on 132 SMs) are both far below the launch itself, so launch latency is the
// floor. The design is the simple right one for that: no padding of the inputs
// to a tile multiple (the TPU version pads to 128), the ragged edges are masked.
//
// Design: a block of 32 x 8 threads owns one 32 x 32 tile of the output. It
// stages its 32 `a` descriptors and its 32 `b` descriptors in shared memory (1 KB
// each) with 16-byte loads, each thread keeps the eight words of its column's
// `b` descriptor in registers, and then computes four outputs, one for each of
// the rows ty, ty + 8, ty + 16, ty + 24: eight __popc(a ^ b) summed in a
// register. A warp holds one output row, so its `a` words are a shared-memory
// broadcast and its stores are 32 consecutive int32 along Kb (coalesced).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;            // output tile is kTile x kTile
constexpr int kRowsPerPass = 8;      // blockDim.y
constexpr int kWords = 8;            // 256-bit descriptors
constexpr int kVecPerDesc = kWords / 4;   // uint4 loads per descriptor

__global__ void __launch_bounds__(kTile * kRowsPerPass)
hamming_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
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
        const uint4 a0 = sa[r][0];
        const uint4 a1 = sa[r][1];
        const int d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z)
                    + __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y)
                    + __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
        const int row = row0 + r;
        if (row < ka && col < kb) {
            out[(size_t)row * kb + col] = d;
        }
    }
}

}  // namespace

// a: [ka, 8] uint32 words, b: [kb, 8], out: [ka, kb] int32, all device pointers,
// 16-byte aligned and contiguous. Launches on `stream` without synchronising and
// returns the CUDA error of the launch (0 on success).
extern "C" int hamming_matrix_launch(const void* a, const void* b, void* out, int ka, int kb,
                                     void* stream) {
    if (ka <= 0 || kb <= 0) {
        return 0;
    }
    const dim3 grid((kb + kTile - 1) / kTile, (ka + kTile - 1) / kTile);
    const dim3 block(kTile, kRowsPerPass);
    hamming_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(a), static_cast<const uint4*>(b),
        static_cast<int32_t*>(out), ka, kb);
    return static_cast<int>(cudaGetLastError());
}
