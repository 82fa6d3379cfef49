// Host BoW runtime: the DBoW2 binary vocabulary loader, the vocabulary-tree
// descent and the hierarchical k-medians trainer, for os1_tpu_torch/vocab.
//
// Keyframe-rate host work, as in the reference (KeyFrame::ComputeBoW runs on
// the CPU): ~1k descriptors walk a k-ary tree of up to ~10^6 nodes, about
// 0.5M popcounts, well under a millisecond. Built with g++ at first use and
// bound with ctypes (ops/cuda_build.py); every entry point returns 0 on
// success and a negative code on failure.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// Header of a DBoW2 binary vocabulary: k (branching) and L (depth) in its
// first two bytes, then 45-byte node records
//   parent int32 | isLeaf u8 | descriptor u8[32] | weight float64
// for every node but the root (node 0). Writes the node count (records + 1).
int vocab_count(const char* path, int32_t* k, int32_t* L, int64_t* n_nodes) {
  struct stat st;
  if (stat(path, &st) != 0) return -1;
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  unsigned char header[4];
  const size_t got = fread(header, 1, 4, f);
  fclose(f);
  if (got != 4) return -2;
  *k = header[0];
  *L = header[1];
  *n_nodes = (st.st_size - 4) / 45 + 1;
  return 0;
}

// Fills flat arrays sized for n_nodes (from vocab_count) and branching kb:
//   desc     [n_nodes * 8]  u32 (the record's 32 bytes, little-endian words)
//   children [n_nodes * kb] i32, -1 padded, in record order
//   weight   [n_nodes]      f32
//   word     [n_nodes]      i32 word id (leaves numbered in record order),
//                           -1 for internal nodes
// and the word count into *n_words.
int vocab_load(const char* path, uint32_t* desc, int32_t* children, float* weight,
               int32_t* word, int64_t n_nodes, int32_t kb, int64_t* n_words) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -1;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    close(fd);
    return -1;
  }
  const unsigned char* data = static_cast<const unsigned char*>(map);
  const int64_t n_rec = (st.st_size - 4) / 45;
  int rc = 0;
  if (n_rec + 1 != n_nodes) {
    rc = -2;
  } else {
    std::vector<int32_t> child_count(n_nodes, 0);
    memset(children, 0xFF, sizeof(int32_t) * n_nodes * kb);
    memset(word, 0xFF, sizeof(int32_t) * n_nodes);
    memset(desc, 0, sizeof(uint32_t) * 8);  // the root has no descriptor
    weight[0] = 0.0f;
    int64_t w = 0;
    const unsigned char* p = data + 4;
    for (int64_t i = 1; i < n_nodes; ++i, p += 45) {
      int32_t parent;
      memcpy(&parent, p, 4);
      if (parent < 0 || parent >= n_nodes || child_count[parent] >= kb) {
        rc = -3;  // not a k-ary tree in parent-first order
        break;
      }
      children[static_cast<int64_t>(parent) * kb + child_count[parent]++] =
          static_cast<int32_t>(i);
      memcpy(desc + i * 8, p + 5, 32);
      double wt;
      memcpy(&wt, p + 37, 8);
      weight[i] = static_cast<float>(wt);
      if (p[4]) word[i] = static_cast<int32_t>(w++);
    }
    *n_words = w;
  }
  munmap(map, st.st_size);
  close(fd);
  return rc;
}

static inline int hamming256(const uint32_t* a, const uint32_t* b) {
  int d = 0;
  for (int w = 0; w < 8; ++w) d += __builtin_popcount(a[w] ^ b[w]);
  return d;
}

// TemplatedVocabulary::transform for a whole frame: each valid descriptor
// descends `depth` levels, taking the nearest child by Hamming distance (the
// lowest child slot on ties) and stopping early at a node without children.
// Invalid descriptors get word -1 and weight 0.
int bow_transform(const uint32_t* desc, const uint8_t* valid, int64_t n,
                  const uint32_t* node_desc, const int32_t* children,
                  const float* node_weight, const int32_t* node_word, int32_t kb,
                  int32_t depth, int32_t* out_word, float* out_weight) {
  for (int64_t i = 0; i < n; ++i) {
    if (!valid[i]) {
      out_word[i] = -1;
      out_weight[i] = 0.0f;
      continue;
    }
    const uint32_t* d = desc + i * 8;
    int32_t cur = 0;
    for (int32_t lvl = 0; lvl < depth; ++lvl) {
      const int32_t* ch = children + static_cast<int64_t>(cur) * kb;
      if (ch[0] < 0) break;
      int32_t best = ch[0];
      int bestd = 1 << 30;
      for (int32_t c = 0; c < kb && ch[c] >= 0; ++c) {
        const int dist = hamming256(d, node_desc + static_cast<int64_t>(ch[c]) * 8);
        if (dist < bestd) {
          bestd = dist;
          best = ch[c];
        }
      }
      cur = best;
    }
    out_word[i] = node_word[cur];
    out_weight[i] = node_weight[cur];
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Hierarchical binary k-medians vocabulary training (DBoW2's construction:
// k-means with bitwise-majority centres, the mean under the Hamming metric).
// Deterministic under `seed`: the draws, their order and the two-thread
// split of the assignment are the JAX package's native trainer's
// (os1_tpu/native/os1native.cpp), so both build the same tree.
// ---------------------------------------------------------------------------

namespace {

struct SplitMix64 {
  uint64_t s;
  explicit SplitMix64(uint64_t seed) : s(seed) {}
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  uint64_t below(uint64_t n) { return next() % n; }  // uniform in [0, n)
};

// Nearest of k packed centres (the lowest index on ties).
inline int32_t nearest(const uint32_t* d, const uint32_t* centers, int32_t k) {
  int32_t best = 0;
  int bestd = 1 << 30;
  for (int32_t c = 0; c < k; ++c) {
    const int dist = hamming256(d, centers + c * 8);
    if (dist < bestd) {
      bestd = dist;
      best = c;
    }
  }
  return best;
}

// One k-medians run over descs[idx[0..m)]. Writes up to k packed centres and
// the final assignment; returns the surviving centre count (empty clusters
// are dropped). Above 65536 descriptors the assignment runs on two threads,
// each summing its own half.
int32_t kmedians(const uint32_t* descs, const int64_t* idx, int64_t m, int32_t k, int iters,
                 SplitMix64* rng, uint32_t* centers, int32_t* assign) {
  if (m <= 0) return 0;
  if (k > m) k = static_cast<int32_t>(m);
  // k distinct members drawn at random; a duplicate is redrawn, and on a
  // duplicate-heavy cluster one redraw in eight gives up with fewer centres.
  int32_t got = 0;
  while (got < k) {
    const int64_t pick = idx[rng->below(static_cast<uint64_t>(m))];
    bool dup = false;
    for (int32_t c = 0; c < got && !dup; ++c)
      dup = hamming256(centers + c * 8, descs + pick * 8) == 0;
    if (!dup) {
      memcpy(centers + got * 8, descs + pick * 8, 32);
      ++got;
    } else if (rng->below(8) == 0) {
      break;
    }
  }
  k = got;
  if (k <= 1) {
    for (int64_t i = 0; i < m; ++i) assign[i] = 0;
    return k;
  }

  std::vector<int64_t> counts(k);
  std::vector<int64_t> bitcnt(static_cast<size_t>(k) * 256);
  for (int it = 0; it < iters; ++it) {
    std::fill(counts.begin(), counts.end(), 0);
    std::fill(bitcnt.begin(), bitcnt.end(), 0);
    auto worker = [&](int64_t lo, int64_t hi, int64_t* cnts, int64_t* bits) {
      for (int64_t i = lo; i < hi; ++i) {
        const uint32_t* d = descs + idx[i] * 8;
        const int32_t best = nearest(d, centers, k);
        assign[i] = best;
        cnts[best]++;
        int64_t* bc = bits + static_cast<int64_t>(best) * 256;
        for (int w = 0; w < 8; ++w) {
          for (uint32_t v = d[w]; v; v &= v - 1) bc[w * 32 + __builtin_ctz(v)]++;
        }
      }
    };
    if (m > 65536) {
      std::vector<int64_t> counts2(k, 0);
      std::vector<int64_t> bitcnt2(static_cast<size_t>(k) * 256, 0);
      const int64_t mid = m / 2;
      std::thread t(worker, 0, mid, counts.data(), bitcnt.data());
      worker(mid, m, counts2.data(), bitcnt2.data());
      t.join();
      for (int32_t c = 0; c < k; ++c) counts[c] += counts2[c];
      for (size_t i = 0; i < bitcnt.size(); ++i) bitcnt[i] += bitcnt2[i];
    } else {
      worker(0, m, counts.data(), bitcnt.data());
    }
    // Majority-vote centres (bit set iff 2 * ones >= members); empty
    // clusters are dropped.
    int32_t k_new = 0;
    bool changed = false;
    for (int32_t c = 0; c < k; ++c) {
      if (counts[c] == 0) {
        changed = true;
        continue;
      }
      uint32_t nc[8] = {0};
      const int64_t* bc = bitcnt.data() + static_cast<int64_t>(c) * 256;
      for (int b = 0; b < 256; ++b)
        if (2 * bc[b] >= counts[c]) nc[b / 32] |= 1u << (b % 32);
      if (memcmp(nc, centers + c * 8, 32) != 0) changed = true;
      memcpy(centers + k_new * 8, nc, 32);
      ++k_new;
    }
    k = k_new;
    if (!changed || k <= 1) break;
  }
  for (int64_t i = 0; i < m; ++i) assign[i] = nearest(descs + idx[i] * 8, centers, k);
  return k;
}

struct TrainState {
  const uint32_t* descs;
  int32_t kb, depth;
  int iters;
  uint32_t* node_desc;
  int32_t* children;
  int32_t* node_word;
  int32_t* leaf_count;
  int64_t max_nodes;
  int64_t n_nodes;
  int64_t n_words;
  SplitMix64 rng;
  std::vector<uint32_t> cbuf;
  std::vector<int32_t> abuf;
};

// Splits a node's descriptors idx[0..m) into children, recursively, depth
// first. idx is reordered in place so that each child owns a contiguous
// range; the children's ids are taken before any of them is split, so a
// parent always precedes its children, as the binary format requires.
// Returns false when the node capacity overflows.
bool split_node(TrainState* ts, int32_t node, int64_t* idx, int64_t m, int32_t level) {
  if (level == ts->depth || m <= ts->kb) {
    ts->node_word[node] = static_cast<int32_t>(ts->n_words++);
    ts->leaf_count[node] = static_cast<int32_t>(m);
    return true;
  }
  uint32_t* centers = ts->cbuf.data();
  int32_t* assign = ts->abuf.data();
  const int32_t k = kmedians(ts->descs, idx, m, ts->kb, ts->iters, &ts->rng, centers, assign);
  if (k <= 1) {  // a degenerate cluster (identical descriptors)
    ts->node_word[node] = static_cast<int32_t>(ts->n_words++);
    ts->leaf_count[node] = static_cast<int32_t>(m);
    return true;
  }
  // Stable counting sort of idx by assignment.
  std::vector<int64_t> start(k + 1, 0);
  for (int64_t i = 0; i < m; ++i) start[assign[i] + 1]++;
  for (int32_t c = 0; c < k; ++c) start[c + 1] += start[c];
  std::vector<int64_t> tmp(m);
  {
    std::vector<int64_t> pos(start.begin(), start.end() - 1);
    for (int64_t i = 0; i < m; ++i) tmp[pos[assign[i]]++] = idx[i];
  }
  memcpy(idx, tmp.data(), sizeof(int64_t) * m);
  std::vector<int32_t> child_ids(k);
  for (int32_t c = 0; c < k; ++c) {
    if (ts->n_nodes >= ts->max_nodes) return false;
    const int32_t id = static_cast<int32_t>(ts->n_nodes++);
    child_ids[c] = id;
    memcpy(ts->node_desc + static_cast<int64_t>(id) * 8, centers + c * 8, 32);
    ts->children[static_cast<int64_t>(node) * ts->kb + c] = id;
  }
  for (int32_t c = 0; c < k; ++c) {
    if (!split_node(ts, child_ids[c], idx + start[c], start[c + 1] - start[c], level + 1))
      return false;
  }
  return true;
}

}  // namespace

extern "C" {

// Trains a vocabulary tree over m packed descriptors [m * 8]. Fills
// node_desc [max_nodes * 8], children [max_nodes * kb] (-1 padded),
// node_word [max_nodes] (-1 for internal nodes) and leaf_count [max_nodes]
// (training descriptors a leaf, for the idf), and the node count into
// *n_nodes. Returns -1 on empty input, -2 when max_nodes overflows.
int vocab_train(const uint32_t* descs, int64_t m, int32_t kb, int32_t depth, uint32_t seed,
                int32_t iters, uint32_t* node_desc, int32_t* children, int32_t* node_word,
                int32_t* leaf_count, int64_t max_nodes, int64_t* n_nodes) {
  if (m <= 0 || max_nodes < 1) return -1;
  memset(children, 0xFF, sizeof(int32_t) * max_nodes * kb);
  memset(node_word, 0xFF, sizeof(int32_t) * max_nodes);
  memset(leaf_count, 0, sizeof(int32_t) * max_nodes);
  memset(node_desc, 0, sizeof(uint32_t) * 8);
  TrainState ts{descs, kb, depth, iters, node_desc, children, node_word, leaf_count,
                max_nodes, 1, 0, SplitMix64(seed), {}, {}};
  ts.cbuf.resize(static_cast<size_t>(kb) * 8);
  ts.abuf.resize(m);
  std::vector<int64_t> idx(m);
  for (int64_t i = 0; i < m; ++i) idx[i] = i;
  if (!split_node(&ts, 0, idx.data(), m, 0)) return -2;
  *n_nodes = ts.n_nodes;
  return 0;
}

}  // extern "C"
