// Host helpers of the runtime, for os1_tpu_torch/native.py: the distinctive
// descriptor of each map point, the RGB -> grey conversion at the ingest
// edge and a single-producer single-consumer frame ring buffer.
//
// Keyframe-rate and frame-rate host work, as in the reference (MapPoint::
// ComputeDistinctiveDescriptors and the video thread's frame mailbox run on
// the CPU). Built with g++ at first use and bound with ctypes
// (ops/cuda_build.py); every entry point returns 0 on success, a negative
// code on failure, and gives its results through pointers.
#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <new>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Frame ring buffer: lossless (the producer waits while it is full) or
// realtime (the oldest frame is dropped), frames of a fixed byte size.
// ---------------------------------------------------------------------------
struct RingBuffer {
  uint8_t* data;
  int64_t slot_bytes;
  int64_t capacity;
  int64_t head = 0;  // next write sequence number
  int64_t tail = 0;  // next read sequence number
  bool realtime;     // true: overwrite the oldest (the latest frame wins)
  std::mutex m;
  std::condition_variable cv;
  std::atomic<bool> closed{false};
};

int ring_create(int64_t capacity, int64_t slot_bytes, int realtime, void** out) {
  if (capacity <= 0 || slot_bytes <= 0) return -1;
  RingBuffer* rb = new (std::nothrow) RingBuffer();
  if (!rb) return -2;
  rb->data = new (std::nothrow) uint8_t[capacity * slot_bytes];
  if (!rb->data) {
    delete rb;
    return -2;
  }
  rb->slot_bytes = slot_bytes;
  rb->capacity = capacity;
  rb->realtime = realtime != 0;
  *out = rb;
  return 0;
}

int ring_destroy(void* h) {
  RingBuffer* rb = static_cast<RingBuffer*>(h);
  delete[] rb->data;
  delete rb;
  return 0;
}

// Wakes both sides: a waiting push fails, a pop drains what is left.
int ring_close(void* h) {
  RingBuffer* rb = static_cast<RingBuffer*>(h);
  {
    std::lock_guard<std::mutex> lk(rb->m);
    rb->closed = true;
  }
  rb->cv.notify_all();
  return 0;
}

// Push one frame. Lossless mode waits while full (up to timeout_ms);
// realtime mode drops the oldest. *pushed: 1 pushed, 0 timed out or closed.
int ring_push(void* h, const uint8_t* frame, int64_t timeout_ms, int32_t* pushed) {
  RingBuffer* rb = static_cast<RingBuffer*>(h);
  std::unique_lock<std::mutex> lk(rb->m);
  *pushed = 0;
  if (!rb->realtime) {
    if (!rb->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), [&] {
          return rb->closed || rb->head - rb->tail < rb->capacity;
        }))
      return 0;
    if (rb->closed) return 0;
  } else if (rb->head - rb->tail >= rb->capacity) {
    rb->tail++;  // drop the oldest
  }
  const int64_t slot = rb->head % rb->capacity;
  memcpy(rb->data + slot * rb->slot_bytes, frame, rb->slot_bytes);
  rb->head++;
  *pushed = 1;
  rb->cv.notify_all();
  return 0;
}

// Pop one frame into out. *popped: 1 popped, 0 timed out or closed and empty.
int ring_pop(void* h, uint8_t* out, int64_t timeout_ms, int32_t* popped) {
  RingBuffer* rb = static_cast<RingBuffer*>(h);
  std::unique_lock<std::mutex> lk(rb->m);
  *popped = 0;
  if (!rb->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                       [&] { return rb->closed || rb->head > rb->tail; }))
    return 0;
  if (rb->head == rb->tail) return 0;  // closed and drained
  const int64_t slot = rb->tail % rb->capacity;
  memcpy(out, rb->data + slot * rb->slot_bytes, rb->slot_bytes);
  rb->tail++;
  *popped = 1;
  rb->cv.notify_all();
  return 0;
}

int ring_size(void* h, int64_t* size) {
  RingBuffer* rb = static_cast<RingBuffer*>(h);
  std::lock_guard<std::mutex> lk(rb->m);
  *size = rb->head - rb->tail;
  return 0;
}

// ---------------------------------------------------------------------------
// Interleaved RGB u8 -> BT.601 luminance f32, 0.299 R + 0.587 G + 0.114 B
// in fused multiply-adds, in the order g++ contracts that sum for a host with
// FMA (the JAX package builds its library with -march=native), so the two
// agree bit for bit whatever this build's target.
// ---------------------------------------------------------------------------
int rgb_u8_to_gray_f32(const uint8_t* src, float* dst, int64_t n_pixels) {
  for (int64_t i = 0; i < n_pixels; ++i) {
    const float r = src[3 * i], g = src[3 * i + 1], b = src[3 * i + 2];
    dst[i] = std::fma(0.114f, b, std::fma(0.299f, r, 0.587f * g));
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Distinctive descriptor (MapPoint::ComputeDistinctiveDescriptors, reference
// MapPoint.cc:227-293): for each point, among its live observations'
// descriptors, the one with the least median Hamming distance to the others
// (the first such slot on a tie; numpy's median: the mean of the middle pair
// for an even count).
//   descs: [n, M, 8] uint32 (256-bit descriptors), live: [n, M] uint8,
//   best: [n] int32, the live slot chosen (the only live slot when there is
//   one, -1 when there is none).
// ---------------------------------------------------------------------------
int point_distinctive_desc(const uint32_t* descs, const uint8_t* live, int64_t n, int32_t M,
                           int32_t* best_out) {
  std::vector<int> dists;
  dists.reserve(M);
  for (int64_t p = 0; p < n; ++p) {
    const uint32_t* d0 = descs + p * M * 8;
    const uint8_t* lv = live + p * M;
    int32_t best = -1;
    float best_med = 1e30f;
    for (int32_t a = 0; a < M; ++a) {
      if (!lv[a]) continue;
      if (best < 0) best = a;  // the first live slot
      dists.clear();
      for (int32_t b = 0; b < M; ++b) {
        if (!lv[b]) continue;
        int dist = 0;
        if (a != b) {
          for (int w = 0; w < 8; ++w) dist += __builtin_popcount(d0[a * 8 + w] ^ d0[b * 8 + w]);
        }
        dists.push_back(dist);
      }
      const size_t k = dists.size();
      if (k < 2) break;  // a single live observation: keep it
      std::sort(dists.begin(), dists.end());
      const float m = (k & 1) ? float(dists[k / 2]) : 0.5f * (dists[k / 2 - 1] + dists[k / 2]);
      if (m < best_med) {
        best_med = m;
        best = a;
      }
    }
    best_out[p] = best;
  }
  return 0;
}

}  // extern "C"
