// Hamming distance table between packed 256-bit ORB descriptors, for sm_90a.
//
// Replaces the TPU kernel os1_tpu/ops/pallas_hamming.py::hamming_matrix_pallas
// (body _kernel): XOR + popcount over the 8 packed 32-bit words of every
// (row of A, row of B) pair, written as the full [N, M] int32 table.
//
// What bounds it on an H100: almost no arithmetic (8 XOR + 8 POPC + adds per
// output) against a 4-byte store per output. At the local-map shape
// [4096, 1024] it reads 160 KB of descriptors and writes a 16 MB table, so the
// table's write bandwidth to HBM is the bound. The design keeps every store
// coalesced (a warp writes 32 neighbouring columns of one row) and reads each
// descriptor from HBM once per block. A later fused form (gate + per-row top-2
// inside the tile loop) keeps the table out of HBM altogether.
//
// Layout: a block owns a tile of kTileN rows of A by kTileM rows of B. Both
// descriptor tiles are staged in shared memory with coalesced loads; the B
// tile is padded to 9 words a row so that a warp reading 32 consecutive B rows
// hits 32 different banks. Thread (tx, ty) holds B row (column of the output)
// tx in registers and walks rows ty, ty + 2, ... of the A tile, whose words are
// broadcast reads. Any N and M are accepted; the ragged edges are masked.
//
// Entry point: a plain C function, launched on the caller's stream, with no
// synchronisation and no allocation. It returns cudaGetLastError() after the
// launch (0 = success).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;
constexpr int kTileN = 32;            // rows of A per block
constexpr int kTileM = 128;           // rows of B (output columns) per block
constexpr int kThreadsY = 2;
constexpr int kThreads = kTileM * kThreadsY;
constexpr int kRowsPerThread = kTileN / kThreadsY;

__global__ void __launch_bounds__(kThreads)
hamming_table_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b,
                     int32_t* __restrict__ out, int n, int m) {
  __shared__ uint32_t a_tile[kTileN][kWords];
  __shared__ uint32_t b_tile[kTileM][kWords + 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTileM + tx;
  const int row0 = blockIdx.y * kTileN;
  const int col0 = blockIdx.x * kTileM;

  // A tile: kTileN * kWords = 256 words, one per thread.
  {
    const int r = tid / kWords;
    const int w = tid % kWords;
    const int gr = row0 + r;
    a_tile[r][w] = gr < n ? a[static_cast<int64_t>(gr) * kWords + w] : 0u;
  }
  // B tile: kTileM * kWords = 1024 words, four per thread, consecutive
  // threads on consecutive words.
#pragma unroll
  for (int k = 0; k < (kTileM * kWords) / kThreads; ++k) {
    const int e = tid + k * kThreads;
    const int r = e / kWords;
    const int w = e % kWords;
    const int gc = col0 + r;
    b_tile[r][w] = gc < m ? b[static_cast<int64_t>(gc) * kWords + w] : 0u;
  }
  __syncthreads();

  const int col = col0 + tx;
  if (col >= m) return;
  uint32_t bw[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) bw[w] = b_tile[tx][w];

#pragma unroll 4
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ty + i * kThreadsY;
    const int gr = row0 + r;
    if (gr >= n) break;
    int d = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) d += __popc(a_tile[r][w] ^ bw[w]);
    out[static_cast<int64_t>(gr) * m + col] = d;
  }
}

}  // namespace

extern "C" int hamming_table_launch(const void* a, const void* b, void* out,
                                    int n, int m, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const dim3 block(kTileM, kThreadsY);
  const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN);
  hamming_table_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<int32_t*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}
