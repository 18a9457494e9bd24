// nanowakeword-tpu native runtime: the host-side audio plumbing around the
// accelerator compute path.
//
// The reference framework is pure Python (SURVEY.md §2: zero native code);
// its real-time path allocates per-chunk Python lists and deques
// (`AudioFeatures.py:106,404-431`). For production serving we provide the
// audio runtime as a small C++ library:
//
//   * nww_ring_*   — single-producer/single-consumer int16 ring buffer for
//                    real-time capture threads feeding the interpreter
//                    without the GIL or per-chunk allocation.
//   * nww_wav_*    — 16-bit PCM WAV decode (header parse + mono fold).
//   * nww_chunker_*— 1280-sample chunk framing with remainder carry,
//                    emitting float32 suitable for device transfer
//                    (the `_streaming_features` bookkeeping,
//                    AudioFeatures.py:410-453, as O(1) native code).
//
// Exposed with a plain C ABI for ctypes (no pybind11 dependency).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>

extern "C" {

// ---------------------------------------------------------------------------
// SPSC ring buffer
// ---------------------------------------------------------------------------

struct NwwRing {
  int16_t* data;
  size_t capacity;                 // power of two
  std::atomic<uint64_t> head;      // write cursor (producer)
  std::atomic<uint64_t> tail;      // read cursor (consumer)
};

static size_t round_pow2(size_t n) {
  size_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

NwwRing* nww_ring_create(size_t min_capacity) {
  auto* r = new (std::nothrow) NwwRing();
  if (!r) return nullptr;
  r->capacity = round_pow2(min_capacity < 2 ? 2 : min_capacity);
  r->data = new (std::nothrow) int16_t[r->capacity];
  if (!r->data) {
    delete r;
    return nullptr;
  }
  r->head.store(0, std::memory_order_relaxed);
  r->tail.store(0, std::memory_order_relaxed);
  return r;
}

void nww_ring_destroy(NwwRing* r) {
  if (!r) return;
  delete[] r->data;
  delete r;
}

size_t nww_ring_size(const NwwRing* r) {
  return static_cast<size_t>(r->head.load(std::memory_order_acquire) -
                             r->tail.load(std::memory_order_acquire));
}

size_t nww_ring_capacity(const NwwRing* r) { return r->capacity; }

// Producer: append n samples; drops the OLDEST data on overflow (real-time
// capture must never block). Returns samples written.
size_t nww_ring_push(NwwRing* r, const int16_t* samples, size_t n) {
  uint64_t head = r->head.load(std::memory_order_relaxed);
  if (n > r->capacity) {  // keep only the newest capacity samples
    samples += n - r->capacity;
    n = r->capacity;
  }
  const size_t mask = r->capacity - 1;
  for (size_t i = 0; i < n; ++i) {
    r->data[(head + i) & mask] = samples[i];
  }
  head += n;
  // advance tail if we overwrote unread data
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail > r->capacity) {
    r->tail.store(head - r->capacity, std::memory_order_release);
  }
  r->head.store(head, std::memory_order_release);
  return n;
}

// Consumer: pop up to n samples into out. Returns samples read.
size_t nww_ring_pop(NwwRing* r, int16_t* out, size_t n) {
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  size_t avail = static_cast<size_t>(head - tail);
  if (n > avail) n = avail;
  const size_t mask = r->capacity - 1;
  for (size_t i = 0; i < n; ++i) {
    out[i] = r->data[(tail + i) & mask];
  }
  r->tail.store(tail + n, std::memory_order_release);
  return n;
}

// ---------------------------------------------------------------------------
// WAV decode (16-bit PCM)
// ---------------------------------------------------------------------------

// Parses a RIFF/WAVE buffer. On success fills *n_samples (mono samples after
// channel folding) and *sample_rate, writes mono int16 into out (caller
// allocates >= data_bytes/2 samples; folding shrinks it). Returns 0 on
// success, negative error code otherwise.
int nww_wav_decode(const uint8_t* buf, size_t len, int16_t* out,
                   size_t out_capacity, size_t* n_samples,
                   int32_t* sample_rate) {
  if (len < 44 || memcmp(buf, "RIFF", 4) != 0 ||
      memcmp(buf + 8, "WAVE", 4) != 0)
    return -1;
  size_t pos = 12;
  int16_t channels = 0, bits = 0;
  int32_t rate = 0;
  const uint8_t* data = nullptr;
  size_t data_len = 0;
  while (pos + 8 <= len) {
    const uint8_t* chunk = buf + pos;
    uint32_t chunk_len;
    memcpy(&chunk_len, chunk + 4, 4);
    if (memcmp(chunk, "fmt ", 4) == 0 && chunk_len >= 16) {
      int16_t fmt;
      memcpy(&fmt, chunk + 8, 2);
      memcpy(&channels, chunk + 10, 2);
      memcpy(&rate, chunk + 12, 4);
      memcpy(&bits, chunk + 22, 2);
      if (fmt != 1 || bits != 16) return -2;  // PCM16 only
    } else if (memcmp(chunk, "data", 4) == 0) {
      data = chunk + 8;
      data_len = chunk_len;
      if (pos + 8 + data_len > len) data_len = len - pos - 8;
    }
    pos += 8 + chunk_len + (chunk_len & 1);
  }
  if (!data || channels <= 0) return -3;

  size_t frames = data_len / 2 / channels;
  if (frames > out_capacity) frames = out_capacity;
  const int16_t* src = reinterpret_cast<const int16_t*>(data);
  if (channels == 1) {
    memcpy(out, src, frames * 2);
  } else {
    for (size_t i = 0; i < frames; ++i) {
      int32_t acc = 0;
      for (int c = 0; c < channels; ++c) acc += src[i * channels + c];
      out[i] = static_cast<int16_t>(acc / channels);
    }
  }
  *n_samples = frames;
  *sample_rate = rate;
  return 0;
}

// ---------------------------------------------------------------------------
// Chunk framing with remainder carry
// ---------------------------------------------------------------------------

struct NwwChunker {
  float* pending;      // carried samples, already float32
  size_t pending_len;
  size_t pending_cap;
  size_t chunk;        // 1280
};

NwwChunker* nww_chunker_create(size_t chunk_samples) {
  auto* c = new (std::nothrow) NwwChunker();
  if (!c) return nullptr;
  c->chunk = chunk_samples ? chunk_samples : 1280;
  c->pending_cap = c->chunk * 16;
  c->pending = new (std::nothrow) float[c->pending_cap];
  c->pending_len = 0;
  if (!c->pending) {
    delete c;
    return nullptr;
  }
  return c;
}

void nww_chunker_destroy(NwwChunker* c) {
  if (!c) return;
  delete[] c->pending;
  delete c;
}

void nww_chunker_reset(NwwChunker* c) { c->pending_len = 0; }

size_t nww_chunker_pending(const NwwChunker* c) { return c->pending_len; }

}  // extern "C" — template helpers need C++ linkage

template <typename T>
static size_t chunker_feed_impl(NwwChunker* c, const T* samples, size_t n,
                                float* out, size_t out_capacity_chunks) {
  // grow pending if needed
  size_t need = c->pending_len + n;
  if (need > c->pending_cap) {
    size_t cap = c->pending_cap;
    while (cap < need) cap *= 2;
    float* bigger = new (std::nothrow) float[cap];
    if (!bigger) return 0;
    memcpy(bigger, c->pending, c->pending_len * sizeof(float));
    delete[] c->pending;
    c->pending = bigger;
    c->pending_cap = cap;
  }
  for (size_t i = 0; i < n; ++i) {
    c->pending[c->pending_len + i] = static_cast<float>(samples[i]);
  }
  c->pending_len += n;

  size_t chunks = c->pending_len / c->chunk;
  if (chunks > out_capacity_chunks) chunks = out_capacity_chunks;
  size_t take = chunks * c->chunk;
  memcpy(out, c->pending, take * sizeof(float));
  memmove(c->pending, c->pending + take,
          (c->pending_len - take) * sizeof(float));
  c->pending_len -= take;
  return chunks;
}

extern "C" {

// Feed n int16 samples; writes as many whole chunks as fit into out
// (float32, capacity out_capacity_chunks * chunk). Returns chunks emitted;
// the remainder is carried for the next call.
size_t nww_chunker_feed(NwwChunker* c, const int16_t* samples, size_t n,
                        float* out, size_t out_capacity_chunks) {
  return chunker_feed_impl(c, samples, n, out, out_capacity_chunks);
}

// float32 variant: AudioFeatures streams float32 (possibly fractional)
// samples; routing them through the int16 feed would quantise.
size_t nww_chunker_feed_f32(NwwChunker* c, const float* samples, size_t n,
                            float* out, size_t out_capacity_chunks) {
  return chunker_feed_impl(c, samples, n, out, out_capacity_chunks);
}

}  // extern "C"
