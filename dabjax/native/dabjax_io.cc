// Native IO plane: lock-free SPSC ring buffer + async IQ producers.
//
// Counterpart of the reference's device layer: every input in
// sdr-j-dab fills a lock-free ring buffer from a callback thread
// (includes/various/ringbuffer.h; src/input/dabstick-osmo/dabstick.cpp:65-83)
// and the OFDM thread drains it.  Here the producer thread reads u8/f32 IQ
// from a file descriptor or socket, converts to interleaved complex64
// floats, and the Python runtime drains frame-sized blocks with zero GIL
// contention (ctypes release the GIL during the blocking read).
//
// Build: cc -O3 -shared -fPIC -o libdabjax_io.so dabjax_io.cc -lpthread
// (see Makefile; loaded via ctypes from dabjax/io/native.py).

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>

#include <fcntl.h>
#include <unistd.h>

namespace {

// Power-of-two lock-free single-producer/single-consumer ring of float
// pairs (I, Q).  Memory-order discipline mirrors the PortAudio-derived
// ring buffer the reference uses (acquire on the opposite index, release
// on our own).
class RingBuffer {
 public:
  explicit RingBuffer(size_t capacity_samples) {
    size_t cap = 1;
    while (cap < capacity_samples) cap <<= 1;
    cap_ = cap;
    mask_ = cap - 1;
    data_ = static_cast<float*>(aligned_alloc(64, cap * 2 * sizeof(float)));
    head_.store(0, std::memory_order_relaxed);
    tail_.store(0, std::memory_order_relaxed);
  }
  ~RingBuffer() { free(data_); }

  size_t available() const {
    return head_.load(std::memory_order_acquire) -
           tail_.load(std::memory_order_acquire);
  }
  size_t space() const { return cap_ - available(); }

  // producer: write n complex samples (2n floats); returns samples written
  size_t write(const float* iq, size_t n) {
    size_t head = head_.load(std::memory_order_relaxed);
    size_t tail = tail_.load(std::memory_order_acquire);
    size_t free_slots = cap_ - (head - tail);
    if (n > free_slots) n = free_slots;
    for (size_t k = 0; k < n; ++k) {
      size_t idx = (head + k) & mask_;
      data_[2 * idx] = iq[2 * k];
      data_[2 * idx + 1] = iq[2 * k + 1];
    }
    head_.store(head + n, std::memory_order_release);
    return n;
  }

  // consumer: read up to n complex samples; returns samples read
  size_t read(float* out, size_t n) {
    size_t tail = tail_.load(std::memory_order_relaxed);
    size_t head = head_.load(std::memory_order_acquire);
    size_t avail = head - tail;
    if (n > avail) n = avail;
    for (size_t k = 0; k < n; ++k) {
      size_t idx = (tail + k) & mask_;
      out[2 * k] = data_[2 * idx];
      out[2 * k + 1] = data_[2 * idx + 1];
    }
    tail_.store(tail + n, std::memory_order_release);
    return n;
  }

 private:
  size_t cap_ = 0, mask_ = 0;
  float* data_ = nullptr;
  alignas(64) std::atomic<size_t> head_;
  alignas(64) std::atomic<size_t> tail_;
};

// Async producer pulling IQ from an fd on its own thread (the device
// callback thread analog).
class Feeder {
 public:
  enum Format { U8 = 0, S16 = 1, F32 = 2 };

  Feeder(int fd, int format, size_t ring_samples, int loop)
      : ring_(ring_samples), fd_(fd), format_(static_cast<Format>(format)),
        loop_(loop != 0) {
    running_.store(true, std::memory_order_release);
    thread_ = std::thread(&Feeder::run, this);
  }

  ~Feeder() {
    running_.store(false, std::memory_order_release);
    if (thread_.joinable()) thread_.join();
    if (fd_ >= 0) close(fd_);
  }

  size_t read(float* out, size_t n) { return ring_.read(out, n); }
  size_t available() const { return ring_.available(); }
  bool eof() const { return eof_.load(std::memory_order_acquire); }

 private:
  void run() {
    const size_t CHUNK = 65536;  // complex samples per read
    size_t elem = format_ == U8 ? 1 : (format_ == S16 ? 2 : 4);
    uint8_t* raw = static_cast<uint8_t*>(malloc(CHUNK * 2 * elem));
    float* conv = static_cast<float*>(malloc(CHUNK * 2 * sizeof(float)));
    while (running_.load(std::memory_order_acquire)) {
      ssize_t got = ::read(fd_, raw, CHUNK * 2 * elem);
      if (got <= 0) {
        if (loop_ && lseek(fd_, 0, SEEK_SET) == 0) continue;
        eof_.store(true, std::memory_order_release);
        break;
      }
      size_t pairs = static_cast<size_t>(got) / (2 * elem);
      convert(raw, conv, pairs);
      size_t done = 0;
      while (done < pairs && running_.load(std::memory_order_acquire)) {
        done += ring_.write(conv + 2 * done, pairs - done);
        if (done < pairs)
          std::this_thread::sleep_for(std::chrono::microseconds(200));
      }
    }
    free(raw);
    free(conv);
  }

  void convert(const uint8_t* raw, float* out, size_t pairs) {
    switch (format_) {
      case U8: {
        // 8-bit offset-binary IQ -> [-1, 1) (dabstick.cpp conversion)
        for (size_t i = 0; i < 2 * pairs; ++i)
          out[i] = (static_cast<float>(raw[i]) - 128.0f) / 128.0f;
        break;
      }
      case S16: {
        const int16_t* s = reinterpret_cast<const int16_t*>(raw);
        for (size_t i = 0; i < 2 * pairs; ++i)
          out[i] = static_cast<float>(s[i]) / 32768.0f;
        break;
      }
      case F32: {
        memcpy(out, raw, 2 * pairs * sizeof(float));
        break;
      }
    }
  }

  RingBuffer ring_;
  int fd_;
  Format format_;
  bool loop_;
  std::atomic<bool> running_{false};
  std::atomic<bool> eof_{false};
  std::thread thread_;
};

}  // namespace

extern "C" {

void* dabjax_feeder_open(const char* path, int format, size_t ring_samples,
                         int loop) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  return new Feeder(fd, format, ring_samples, loop);
}

void* dabjax_feeder_from_fd(int fd, int format, size_t ring_samples) {
  return new Feeder(fd, format, ring_samples, 0);
}

// Reads up to n complex samples into out (2n floats); returns count read.
size_t dabjax_feeder_read(void* h, float* out, size_t n) {
  return static_cast<Feeder*>(h)->read(out, n);
}

size_t dabjax_feeder_available(void* h) {
  return static_cast<Feeder*>(h)->available();
}

int dabjax_feeder_eof(void* h) {
  return static_cast<Feeder*>(h)->eof() ? 1 : 0;
}

void dabjax_feeder_close(void* h) { delete static_cast<Feeder*>(h); }

}  // extern "C"
