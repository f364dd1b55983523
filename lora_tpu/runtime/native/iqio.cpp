// Native IQ ingest: wire-format conversion + SPSC ring buffer.
//
// The reference's runtime layer is native C++ around the sample stream:
// Pothos zero-copy BufferChunks with custom buffer managers sized to the
// blocks' needs (/root/reference/LoRaMod.cpp:241-251,
// LoRaDemod.cpp:330-358) and SDR capture ingest at Msps rates
// (RN2483Capture.py:45-53 via SoapySDR).  This framework's equivalent hot
// host path is (a) converting SDR wire formats (interleaved cs8/cs16/cf32)
// into the planar float32 IQ layout the device wants, and (b) buffering a
// capture stream between the ingest thread and the dispatch thread.  Both
// live here, exposed as a C ABI consumed via ctypes (lora_tpu/runtime/iqio.py).
//
// Build: g++ -O3 -march=native -shared -fPIC iqio.cpp -o libiqio.so

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdlib>

extern "C" {

// ---- wire-format -> planar float32 conversions ---------------------------
// src holds n complex samples, interleaved; dst_re/dst_im hold n floats.

void iq_convert_cs8(const int8_t* src, float* dst_re, float* dst_im,
                    int64_t n, float scale) {
  for (int64_t i = 0; i < n; ++i) {
    dst_re[i] = scale * (float)src[2 * i];
    dst_im[i] = scale * (float)src[2 * i + 1];
  }
}

void iq_convert_cu8(const uint8_t* src, float* dst_re, float* dst_im,
                    int64_t n, float scale) {
  // RTL-SDR convention: unsigned bytes centered at 127.5
  for (int64_t i = 0; i < n; ++i) {
    dst_re[i] = scale * ((float)src[2 * i] - 127.5f);
    dst_im[i] = scale * ((float)src[2 * i + 1] - 127.5f);
  }
}

void iq_convert_cs16(const int16_t* src, float* dst_re, float* dst_im,
                     int64_t n, float scale) {
  for (int64_t i = 0; i < n; ++i) {
    dst_re[i] = scale * (float)src[2 * i];
    dst_im[i] = scale * (float)src[2 * i + 1];
  }
}

void iq_convert_cf32(const float* src, float* dst_re, float* dst_im,
                     int64_t n, float scale) {
  for (int64_t i = 0; i < n; ++i) {
    dst_re[i] = scale * src[2 * i];
    dst_im[i] = scale * src[2 * i + 1];
  }
}

// planar -> interleaved cf32 (TX emission path)
void iq_interleave_cf32(const float* src_re, const float* src_im, float* dst,
                        int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    dst[2 * i] = src_re[i];
    dst[2 * i + 1] = src_im[i];
  }
}

// ---- single-producer single-consumer planar ring buffer -------------------

struct IqRing {
  float* re;
  float* im;
  int64_t capacity;                 // samples
  std::atomic<int64_t> head;        // write position (total samples)
  std::atomic<int64_t> tail;        // read position (total samples)
  std::atomic<int64_t> dropped;     // overrun sample count
};

IqRing* iq_ring_create(int64_t capacity) {
  IqRing* r = new IqRing();
  r->re = (float*)std::malloc(sizeof(float) * capacity);
  r->im = (float*)std::malloc(sizeof(float) * capacity);
  r->capacity = capacity;
  r->head.store(0);
  r->tail.store(0);
  r->dropped.store(0);
  if (!r->re || !r->im) {
    std::free(r->re);
    std::free(r->im);
    delete r;
    return nullptr;
  }
  return r;
}

void iq_ring_destroy(IqRing* r) {
  if (!r) return;
  std::free(r->re);
  std::free(r->im);
  delete r;
}

int64_t iq_ring_available(const IqRing* r) {
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

int64_t iq_ring_dropped(const IqRing* r) {
  return r->dropped.load(std::memory_order_relaxed);
}

// Producer: append n planar samples; drops (counts) what does not fit.
int64_t iq_ring_write(IqRing* r, const float* re, const float* im, int64_t n) {
  int64_t head = r->head.load(std::memory_order_relaxed);
  int64_t tail = r->tail.load(std::memory_order_acquire);
  int64_t space = r->capacity - (head - tail);
  int64_t todo = n < space ? n : space;
  if (todo < n) r->dropped.fetch_add(n - todo, std::memory_order_relaxed);
  int64_t pos = head % r->capacity;
  int64_t first = todo < (r->capacity - pos) ? todo : (r->capacity - pos);
  std::memcpy(r->re + pos, re, sizeof(float) * first);
  std::memcpy(r->im + pos, im, sizeof(float) * first);
  if (todo > first) {
    std::memcpy(r->re, re + first, sizeof(float) * (todo - first));
    std::memcpy(r->im, im + first, sizeof(float) * (todo - first));
  }
  r->head.store(head + todo, std::memory_order_release);
  return todo;
}

// Consumer: copy up to n samples out; returns the count actually read.
int64_t iq_ring_read(IqRing* r, float* re, float* im, int64_t n) {
  int64_t head = r->head.load(std::memory_order_acquire);
  int64_t tail = r->tail.load(std::memory_order_relaxed);
  int64_t avail = head - tail;
  int64_t todo = n < avail ? n : avail;
  int64_t pos = tail % r->capacity;
  int64_t first = todo < (r->capacity - pos) ? todo : (r->capacity - pos);
  std::memcpy(re, r->re + pos, sizeof(float) * first);
  std::memcpy(im, r->im + pos, sizeof(float) * first);
  if (todo > first) {
    std::memcpy(re + first, r->re, sizeof(float) * (todo - first));
    std::memcpy(im + first, r->im, sizeof(float) * (todo - first));
  }
  r->tail.store(tail + todo, std::memory_order_release);
  return todo;
}

}  // extern "C"
