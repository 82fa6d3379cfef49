// Host BoW runtime: the DBoW2 binary vocabulary loader and the
// vocabulary-tree descent, for os1_tpu_torch/vocab.
//
// Keyframe-rate host work, as in the reference (KeyFrame::ComputeBoW runs on
// the CPU): ~1k descriptors walk a k-ary tree of up to ~10^6 nodes, about
// 0.5M popcounts, well under a millisecond. Built with g++ at first use and
// bound with ctypes (ops/cuda_build.py); every entry point returns 0 on
// success and a negative code on failure.
#include <cstdint>
#include <cstdio>
#include <cstring>
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
