// Hamming distances between packed 256-bit ORB descriptors on the tensor
// cores, for sm_90a, with two epilogues:
//
//   hamming_table_launch  the [B, N, M] int32 distance table;
//   gated_match_launch    for every row of A, the best and second-best gated
//                         column of B (the matchers' top-2 and ratio test),
//                         without writing the table.
//
// Replaces the TPU kernel os1_tpu/ops/pallas_hamming.py::hamming_matrix_pallas
// (body _kernel): XOR + popcount over the 8 packed 32-bit words of every
// (row of A, row of B) pair. The JAX matchers then gate that table, take the
// row argmin, the second minimum and the ratio test (os1_tpu/matching/
// core.py::match_with_gate); the fused epilogue does all of that in registers.
//
// Distance core. The old loop of 8 POPC per output ran into the SM's popcount
// issue rate (16 a clock per SM at compute capability 9.0: about 8 us for the
// 33.5 M popcounts of [4096, 1024]). Here the tensor cores take the
// popcounts: mma.sync m16n8k256 .b1 .and.popc on the packed words as they
// are, d(a, b) = popc(a & ~b) + popc(~a & b), two MMAs a tile, accumulated
// in int32 and exact. (An int8 m16n8k32 core on +-1 vectors, the JAX
// package's hamming_matrix_mxu form, took eight MMAs a tile and was slower on
// an H100.) The dot product sums over k, so any order of the 256 bits serves
// as long as A and B share it: each thread of a quad takes the 8 bytes of
// descriptor its k slots cover, read straight from global memory.
//
// What bounds it on an H100. The table writes 4 bytes an output: 16.8 MB at
// [4096, 1024], 5.0 us at 3.35 TB/s. The fused form reads descriptors and
// gate inputs and writes 17 bytes a row (0.3 MB at [4096, 1024]), so its
// bound is the tensor-core work, 2 * N * M * 256 operations (1.1 us at the
// data sheet's dense int8 rate, 1,979 TOP/s; NVIDIA publishes no .b1 rate for
// the H100, so that rate stands in for it). What holds the fused kernel itself is the issue rate of its
// per-pair epilogue (addresses, gate, key, min/max, against two MMAs per
// 128 pairs) and, at N = 1024, filling 132 SMs:
// the gate terms are template flags, the loads carry no branches, and the
// column split over a cluster keeps small problems on many SMs.
//
// Layout. A block owns 16 rows of A (one MMA row tile, held in registers)
// of one batch entry. A thread owns rows g and g + 8 (g = lane / 4) and
// columns 2t, 2t + 1 (t = lane % 4) of every 8-column tile, the MMA's
// accumulator layout. A warp loads the B fragments (and gate inputs) of a
// few tiles before it runs their MMAs, so their load latencies overlap. The
// table block (8 warps) covers a chunk of 256 columns and stores int2 pairs.
// The match kernel splits a row tile's columns over a thread block cluster
// (Hopper) of up to 4 blocks on as many SMs, sized at launch so that even
// N = 1024 fills the card; each thread folds its distances into the row's
// two smallest (distance, column) keys, and the quad, the block and the
// cluster (through distributed shared memory) merge them. The merge is
// min/max on distinct keys, so the result is the lowest column among equal
// minima (torch.argmin's and jnp.argmin's tie rule) whatever the order.
//
// Entry points: plain C functions, launched on the caller's stream, with no
// synchronisation and no allocation. Each returns cudaGetLastError() after
// the launch (0 = success).
#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// The arguments of gated_match_launch (outside the anonymous namespace: the
// C entry point takes it). Field order and types match
// ops/pallas_hamming.py::_MatchArgs.
struct MatchArgs {
  const uint32_t* a;          // [B or 1, N, 8]
  const uint32_t* b;          // [B, M, 8]
  const uint8_t* gate;        // [B, N, M] bool (dense gate)
  const float* uv;            // [B, N, 2] (window on)
  const float* radius;        // [B, N]    (window on)
  const uint8_t* valid_a;     // [B, N]
  const int32_t* octave_a;    // [B, N]    (octave band on)
  const float* xy;            // [B, M, 2] (window on)
  const uint8_t* valid_b;     // [B, M]
  const int32_t* octave_b;    // [B, M]    (octave band on)
  int64_t* idx;               // [B, N] outputs
  int32_t* dist;
  uint8_t* ok;
  int32_t* second;
  long long a_bstride;        // words between A's batch entries (0: shared)
  int batch, n, m;
  int lo, hi;                 // octave band: lo <= octave_b - octave_a <= hi
  int dense;                  // 1: gate; 0: the factored gate
  int use_window, use_octave;
  int max_dist;
  float ratio;
};

namespace {

constexpr int kWords = 8;    // 32-bit words of a descriptor
constexpr int kRows = 16;    // rows of A per block: one MMA row tile
constexpr int kCols = 8;     // columns of one MMA tile
constexpr int kTableUnroll = 4;  // tiles a table warp loads before it computes any
constexpr int kMatchUnroll = 4;  // tiles a match warp loads before it computes any
constexpr int kTableWarps = 8;
constexpr int kTableThreads = 32 * kTableWarps;
constexpr int kTableCols = kTableWarps * kTableUnroll * kCols;  // columns per table block
constexpr int kMatchWarps = 8;
constexpr int kMatchThreads = 32 * kMatchWarps;
constexpr int kMaxCluster = 4;  // blocks of a cluster (8 measured slower on an H100)
constexpr int kBig = 1 << 20;       // distance of a gated-out pair
constexpr int kNone = INT_MAX;      // no candidate yet

// Loads of descriptor rows past the end (count >= 1) read the last row:
// in bounds and without a branch; their distances are masked later.
__device__ __forceinline__ uint2 load_words2(const uint32_t* rows, int r, int count, int t) {
  const int64_t k = min(r, count - 1);
  return __ldg(reinterpret_cast<const uint2*>(rows + k * kWords) + t);
}

// The distance core: A's words 2t and 2t + 1 of rows g and g + 8 fill the
// fragment slots of k-blocks t and 4 + t; B's words 2t and 2t + 1 of column g
// fill the same k-blocks.
struct Core {
  using Frag = uint2;  // B's part of one tile in this thread
  uint32_t a[4], na[4];

  __device__ __forceinline__ void load_a(const uint32_t* rows, int row0, int n, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const uint2 lo = load_words2(rows, row0 + g, n, t);
    const uint2 hi = load_words2(rows, row0 + g + 8, n, t);
    a[0] = lo.x; a[1] = hi.x; a[2] = lo.y; a[3] = hi.y;
#pragma unroll
    for (int i = 0; i < 4; ++i) na[i] = ~a[i];
  }

  static __device__ __forceinline__ Frag load_b(const uint32_t* rows, int col0, int m,
                                                int lane) {
    return load_words2(rows, col0 + (lane >> 2), m, lane & 3);
  }

  static __device__ __forceinline__ void mma(int c[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }

  // Distances (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) of the tile.
  __device__ __forceinline__ void dist(const Frag& w, int d[4]) const {
    d[0] = d[1] = d[2] = d[3] = 0;
    mma(d, a, ~w.x, ~w.y);
    mma(d, na, w.x, w.y);
  }
};

// ---------------------------------------------------------------- table --

// Grid: (row tiles, chunks of kTableCols columns, batch). Each warp loads its
// kTableUnroll tiles' B fragments first, then runs their MMAs and stores.
__global__ void __launch_bounds__(kTableThreads)
hamming_table_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                     int32_t* __restrict__ out, int n, int m, long long a_bstride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int z = blockIdx.z;
  const int row0 = blockIdx.x * kRows;
  Core core;
  core.load_a(a + z * a_bstride, row0, n, lane);
  const uint32_t* bz = b + static_cast<int64_t>(z) * m * kWords;
  const bool pairs = (m & 1) == 0;  // int2 stores stay 8-byte aligned
  const int cb0 = blockIdx.y * (kTableCols / kCols) + warp;
  Core::Frag f[kTableUnroll];
#pragma unroll
  for (int u = 0; u < kTableUnroll; ++u) {
    f[u] = Core::load_b(bz, (cb0 + u * kTableWarps) * kCols, m, lane);
  }
#pragma unroll
  for (int u = 0; u < kTableUnroll; ++u) {
    // Tiles past the end run too (on clamped loads; nothing is stored): no
    // branch between the loads above and their use.
    const int col0 = (cb0 + u * kTableWarps) * kCols;
    int d[4];
    core.dist(f[u], d);
    const int c = col0 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + g + 8 * i;
      if (r >= n || c >= m) continue;
      int32_t* o = out + (static_cast<int64_t>(z) * n + r) * m + c;
      if (pairs) {
        *reinterpret_cast<int2*>(o) = make_int2(d[2 * i], d[2 * i + 1]);
      } else {
        o[0] = d[2 * i];
        if (c + 1 < m) o[1] = d[2 * i + 1];
      }
    }
  }
}

// ---------------------------------------------------------- gated match --

// The fused epilogue keeps, per row, the two smallest keys
// distance << kColBits | column over the pairs that pass the gate. Keys are
// distinct (one per column), so the smaller is the best match with the
// lowest column among equal distances, and the larger carries the second
// distance, a tie with the best included. Folding and merging are min/max
// only: associative and commutative, so any order gives the same bits.
// A gated-out pair would count as BIG, above every real distance: it can
// only be the best when no pair passes (then column 0 and BIG, as argmin
// gives it) or the second when fewer than two pass (then BIG), so the keys
// leave it out and the decode puts it back.
constexpr int kColBits = 22;
constexpr int kColMask = (1 << kColBits) - 1;

__device__ __forceinline__ void push(int2& s, int key) {
  const int hi = max(s.x, key);
  s.x = min(s.x, key);
  s.y = min(s.y, hi);
}

__device__ __forceinline__ int2 merge(int2 a, int2 b) {
  return make_int2(min(a.x, b.x), min(max(a.x, b.x), min(a.y, b.y)));
}

// Gate forms, as template flags: each kernel evaluates only its own terms.
constexpr int kGateDense = 1;   // gate[b, i, j]
constexpr int kGateWindow = 2;  // |uv_i - xy_j| <= radius_i (L_inf), with valid_a x valid_b
constexpr int kGateOctave = 4;  // lo <= octave_j - octave_i <= hi (with the window only)

struct RowGate {
  float u, v, r;
  int octave;
  bool live;  // a row of A (and valid, for the factored gate)
};

struct ColGate {
  float2 xy;
  int octave;
  uint8_t valid;
  uint8_t gate[2];  // dense: the gate of rows g and g + 8
  bool in;          // a column of B
};

// One row tile (16 rows) of one batch entry is split over the `cluster`
// blocks of a thread block cluster (1, 2 or 4 blocks on as many SMs),
// chosen at launch so that small problems still fill the card. Grid:
// (row tiles x cluster, batch). The cluster's warps split the columns: warp
// w of block rank c walks the tiles 8c + w, 8c + w + 8 * cluster, ... in
// steps of kMatchUnroll tiles, loading their B fragments and gate inputs
// first (clamped in bounds, no branches), then running their MMAs, the gate
// and the fold. The quad merges by shuffles, the block through
// shared memory, and rank 0 merges the cluster's blocks through distributed
// shared memory and writes the rows. The window compare is |uv - xy| <= r
// in float32: one rounded subtraction, fabsf and a compare, as the plain
// version computes it.
template <int kGate>
__global__ void __launch_bounds__(kMatchThreads) gated_match_kernel(const MatchArgs p,
                                                                   int cluster_size) {
  constexpr bool kDense = kGate & kGateDense;
  constexpr bool kWindow = kGate & kGateWindow;
  constexpr bool kOctave = kGate & kGateOctave;
  constexpr int kU = kMatchUnroll;
  __shared__ int2 part[kMatchWarps][kRows];
  __shared__ int2 block_best[kRows];
  const int rank = blockIdx.x % cluster_size;
  const int stride = cluster_size * kMatchWarps;  // tiles between a warp's tiles
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int z = blockIdx.y;
  const int row0 = (blockIdx.x / cluster_size) * kRows;
  const int n = p.n, m = p.m;
  const unsigned band = static_cast<unsigned>(p.hi - p.lo);
  Core core;
  core.load_a(p.a + z * p.a_bstride, row0, n, lane);
  const uint32_t* bz = p.b + static_cast<int64_t>(z) * m * kWords;
  const int64_t zr = static_cast<int64_t>(z) * n;  // first row of entry z
  const int64_t zc = static_cast<int64_t>(z) * m;  // first column of entry z
  const uint8_t* valid_b = p.valid_b + zc;
  const float2* xy = reinterpret_cast<const float2*>(p.xy) + zc;
  const int32_t* octave_b = p.octave_b + zc;

  RowGate rg[2];
  const uint8_t* gate_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    const int64_t k = zr + min(r, n - 1);
    rg[i] = RowGate{0.f, 0.f, 0.f, 0, r < n};
    gate_row[i] = kDense ? p.gate + k * m : nullptr;
    if (!kDense) {
      rg[i].live = rg[i].live && p.valid_a[k] != 0;
      if (kWindow) {
        rg[i].u = p.uv[2 * k];
        rg[i].v = p.uv[2 * k + 1];
        rg[i].r = p.radius[k];
      }
      if (kOctave) rg[i].octave = p.octave_a[k] + p.lo;
    }
  }

  int2 s[2] = {make_int2(kNone, kNone), make_int2(kNone, kNone)};
  for (int cb0 = rank * kMatchWarps + warp; cb0 * kCols < m; cb0 += stride * kU) {
    // Load phase: B fragments and the raw gate inputs of kU tiles.
    Core::Frag f[kU];
    ColGate cgate[kU][2];  // [tile][column 2t + j]
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int col0 = (cb0 + u * stride) * kCols;
      f[u] = Core::load_b(bz, col0, m, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = col0 + 2 * t + j;
        const int c = min(col, m - 1);  // every load in bounds; `in` masks the rest
        cgate[u][j].in = col < m;
        if (kDense) {
#pragma unroll
          for (int i = 0; i < 2; ++i) cgate[u][j].gate[i] = gate_row[i][c];
        } else {
          cgate[u][j].valid = valid_b[c];
          if (kWindow) cgate[u][j].xy = xy[c];
          if (kOctave) cgate[u][j].octave = octave_b[c];
        }
      }
    }
    // Compute phase: MMAs, gate, keys, top-2.
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      // Tiles past the end run too (on clamped loads, every pair gated out):
      // no branch between the load phase and its use.
      const int col0 = (cb0 + u * stride) * kCols;
      int d[4];
      core.dist(f[u], d);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const ColGate& q = cgate[u][j];
        const int col = col0 + 2 * t + j;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          bool ok = q.in & rg[i].live;
          if (kDense) {
            ok &= q.gate[i] != 0;
          } else {
            ok &= q.valid != 0;
            if (kWindow) {
              ok &= (fabsf(__fsub_rn(rg[i].u, q.xy.x)) <= rg[i].r) &
                    (fabsf(__fsub_rn(rg[i].v, q.xy.y)) <= rg[i].r);
            }
            // lo <= ob - oa <= hi as one unsigned compare.
            if (kOctave) ok &= static_cast<unsigned>(q.octave - rg[i].octave) <= band;
          }
          push(s[i], ok ? (d[2 * i + j] << kColBits) | col : kNone);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int mask = 1; mask <= 2; mask <<= 1) {
      s[i] = merge(s[i], make_int2(__shfl_xor_sync(0xFFFFFFFFu, s[i].x, mask),
                                   __shfl_xor_sync(0xFFFFFFFFu, s[i].y, mask)));
    }
  }
  if (t == 0) {
    part[warp][g] = s[0];
    part[warp][g + 8] = s[1];
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    int2 acc = part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kMatchWarps; ++w) acc = merge(acc, part[w][threadIdx.x]);
    block_best[threadIdx.x] = acc;
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (cluster_size > 1) cluster.sync();
  const int r = row0 + threadIdx.x;
  if (rank == 0 && threadIdx.x < kRows && r < n) {
    int2 acc = block_best[threadIdx.x];
    for (int c = 1; c < cluster_size; ++c) {
      acc = merge(acc, cluster.map_shared_rank(block_best, c)[threadIdx.x]);
    }
    const bool any = acc.x != kNone;
    const int best = any ? acc.x >> kColBits : kBig;
    const int second = acc.y != kNone ? acc.y >> kColBits : kBig;
    const int64_t k = zr + r;
    p.idx[k] = any ? acc.x & kColMask : 0;
    p.dist[k] = best;
    p.second[k] = second;
    p.ok[k] = best <= p.max_dist &&
              static_cast<float>(best) <= __fmul_rn(p.ratio, static_cast<float>(second));
  }
  // The other blocks' shared memory lives until rank 0 has read it.
  if (cluster_size > 1) cluster.sync();
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

// The smallest cluster (1, 2 or 4 blocks) that puts two blocks on every SM,
// and no more blocks per row tile than there are warps' worth of tiles.
int cluster_size_for(const MatchArgs& p) {
  const long long blocks = static_cast<long long>((p.n + kRows - 1) / kRows) * p.batch;
  const int tiles = (p.m + kCols - 1) / kCols;
  int c = 1;
  while (c < kMaxCluster && blocks * c < 2LL * sm_count() && 2 * c * kMatchWarps <= tiles) {
    c *= 2;
  }
  return c;
}

template <int kGate>
cudaError_t launch_match_form(const MatchArgs& p, cudaStream_t stream) {
  const int cluster = cluster_size_for(p);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((p.n + kRows - 1) / kRows * cluster, p.batch);
  config.blockDim = dim3(kMatchThreads);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, gated_match_kernel<kGate>, p, cluster);
}

// The four forms the matchers use: the dense gate, valid_a x valid_b alone,
// the window, the window and the octave band.
cudaError_t launch_match(const MatchArgs& p, cudaStream_t stream) {
  if (p.dense) return launch_match_form<kGateDense>(p, stream);
  if (!p.use_window) return launch_match_form<0>(p, stream);
  if (!p.use_octave) return launch_match_form<kGateWindow>(p, stream);
  return launch_match_form<kGateWindow | kGateOctave>(p, stream);
}

}  // namespace

extern "C" int hamming_table_launch(const void* a, const void* b, void* out, int batch, int n,
                                    int m, long long a_bstride, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0) return 0;
  const dim3 grid((n + kRows - 1) / kRows, (m + kTableCols - 1) / kTableCols, batch);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const uint32_t*>(a);
  const auto* pb = static_cast<const uint32_t*>(b);
  auto* po = static_cast<int32_t*>(out);
  hamming_table_kernel<<<grid, kTableThreads, 0, s>>>(pa, pb, po, n, m, a_bstride);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gated_match_launch(const MatchArgs* args, void* stream) {
  const MatchArgs p = *args;
  // The octave band comes only with the window (no matcher gates by octave alone).
  if (!p.dense && p.use_octave && !p.use_window) return static_cast<int>(cudaErrorInvalidValue);
  if (p.batch <= 0 || p.n <= 0) return 0;
  const cudaError_t err = launch_match(p, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
