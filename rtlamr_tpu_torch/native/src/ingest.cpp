// Native sample-transport runtime for rtlamr_tpu_torch (the PyTorch/CUDA
// port); the JAX package's rtlamr_tpu/native/src/ingest.cpp, copied with
// only its comments changed.
//
// The reference's L1 layer (SURVEY.md §1, §2 C18) is the rtl_tcp client
// embedded in its Receiver (main.go:49-57): a blocking TCP reader of raw u8
// interleaved IQ plus a 5-byte command channel. In the reference that
// blocking read shares the process with the decoder via goroutines
// (main.go:156-205). Here the decode path is a program on the card, so the
// host-side transport becomes this native library: a dedicated reader
// thread (no GIL) drains the socket into a ring buffer, the Python side
// pulls whole decode windows out of it, and byte counters feed the rate
// watchdog (main.go:189-196). A memory-mapped capture reader covers the
// offline path at memory bandwidth.
//
// C ABI only — consumed via ctypes (no pybind11 in the image).

#include <arpa/inet.h>
#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <memory>
#include <mutex>
#include <netdb.h>
#include <string>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Ring buffer: single producer (reader thread), single consumer (Python).

class Ring {
 public:
  explicit Ring(size_t capacity) : buf_(capacity), cap_(capacity) {}

  // Producer: append n bytes; returns bytes dropped (oldest-first overwrite
  // is NOT used — we drop the new bytes and count them, so the consumer
  // always sees a contiguous prefix of the stream; a drop means the decoder
  // fell behind real time, which the watchdog reports).
  size_t push(const uint8_t* data, size_t n) {
    std::unique_lock<std::mutex> lk(mu_);
    size_t space = cap_ - size_;
    size_t take = n < space ? n : space;
    // Drop only whole I/Q byte pairs: a partial drop must leave an even
    // number of bytes dropped, or the rest of the session pairs I of one
    // sample with Q of the next.
    if (take < n && ((n - take) & 1)) take -= 1;
    for (size_t i = 0; i < take; ++i) {
      buf_[(head_ + size_ + i) % cap_] = data[i];
    }
    size_ += take;
    lk.unlock();
    cv_.notify_all();
    return n - take;
  }

  // Consumer: blocking read of exactly n bytes unless timeout/eof. Returns
  // bytes copied (== n normally; < n only at eof or timeout).
  size_t pop(uint8_t* out, size_t n, int timeout_ms, bool* timed_out) {
    std::unique_lock<std::mutex> lk(mu_);
    size_t got = 0;
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms);
    *timed_out = false;
    while (got < n) {
      if (size_ == 0) {
        if (eof_) break;
        if (timeout_ms >= 0) {
          if (cv_.wait_until(lk, deadline) == std::cv_status::timeout &&
              size_ == 0) {
            *timed_out = true;
            break;
          }
        } else {
          cv_.wait(lk);
        }
        continue;
      }
      size_t take = n - got < size_ ? n - got : size_;
      for (size_t i = 0; i < take; ++i) {
        out[got + i] = buf_[(head_ + i) % cap_];
      }
      head_ = (head_ + take) % cap_;
      size_ -= take;
      got += take;
    }
    return got;
  }

  void set_eof() {
    std::lock_guard<std::mutex> lk(mu_);
    eof_ = true;
    cv_.notify_all();
  }

  size_t size() {
    std::lock_guard<std::mutex> lk(mu_);
    return size_;
  }

 private:
  std::mutex mu_;
  std::condition_variable cv_;
  std::vector<uint8_t> buf_;
  size_t cap_;
  size_t head_ = 0;
  size_t size_ = 0;
  bool eof_ = false;
};

// ---------------------------------------------------------------------------
// rtl_tcp connection state.

struct Conn {
  int fd = -1;
  uint32_t tuner_type = 0;
  uint32_t gain_count = 0;
  std::unique_ptr<Ring> ring;
  std::thread reader;
  std::mutex cmd_mu;
  // Stats (watchdog feed, main.go:189-196).
  std::atomic<uint64_t> bytes_total{0};
  std::atomic<uint64_t> bytes_dropped{0};
  std::atomic<bool> stop{false};

  // A handle abandoned without ingest_close (e.g. an exception between
  // connect and source wiring) must still stop and join its reader thread:
  // destroying a joinable std::thread calls std::terminate, which would
  // abort the process during static destruction of g_conns.
  ~Conn() {
    stop.store(true);
    if (fd >= 0) {
      ::shutdown(fd, SHUT_RDWR);
    }
    if (reader.joinable()) reader.join();
    if (fd >= 0) {
      ::close(fd);
      fd = -1;
    }
  }
};

struct FileMap {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t size = 0;
  size_t pos = 0;
};

std::mutex g_mu;
std::map<int64_t, std::unique_ptr<Conn>> g_conns;
std::map<int64_t, std::unique_ptr<FileMap>> g_files;
int64_t g_next = 1;

bool read_exact(int fd, uint8_t* buf, size_t n) {
  size_t got = 0;
  while (got < n) {
    ssize_t r = ::recv(fd, buf + got, n - got, 0);
    if (r <= 0) return false;
    got += static_cast<size_t>(r);
  }
  return true;
}

void reader_loop(Conn* c) {
  std::vector<uint8_t> chunk(1 << 18);
  while (!c->stop.load()) {
    ssize_t r = ::recv(c->fd, chunk.data(), chunk.size(), 0);
    if (r <= 0) {
      if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR))
        continue;
      break;
    }
    c->bytes_total.fetch_add(static_cast<uint64_t>(r));
    size_t dropped = c->ring->push(chunk.data(), static_cast<size_t>(r));
    if (dropped) c->bytes_dropped.fetch_add(dropped);
  }
  c->ring->set_eof();
}

Conn* find_conn(int64_t h) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_conns.find(h);
  return it == g_conns.end() ? nullptr : it->second.get();
}

FileMap* find_file(int64_t h) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_files.find(h);
  return it == g_files.end() ? nullptr : it->second.get();
}

}  // namespace

extern "C" {

// Connect to an rtl_tcp server, parse the 12-byte "RTL0" greeting
// (tuner type u32be, gain count u32be — main.go:127 reads GainCount), and
// start the reader thread with a ring of ring_capacity bytes.
// Returns a handle > 0, or a negative errno-style error:
//   -1 resolve/connect failure, -2 bad greeting, -3 bad args.
int64_t rtlamr_ingest_connect(const char* host, int port, int timeout_ms,
                              int64_t ring_capacity, uint32_t* tuner_type,
                              uint32_t* gain_count) {
  if (!host || port <= 0 || ring_capacity < (1 << 12)) return -3;

  struct addrinfo hints = {};
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  struct addrinfo* res = nullptr;
  char portstr[16];
  snprintf(portstr, sizeof portstr, "%d", port);
  if (getaddrinfo(host, portstr, &hints, &res) != 0 || !res) return -1;

  int fd = -1;
  for (struct addrinfo* ai = res; ai; ai = ai->ai_next) {
    fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    struct timeval tv = {timeout_ms / 1000, (timeout_ms % 1000) * 1000};
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
    setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
    if (::connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
    ::close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  if (fd < 0) return -1;

  uint8_t hdr[12];
  if (!read_exact(fd, hdr, 12) || memcmp(hdr, "RTL0", 4) != 0) {
    ::close(fd);
    return -2;
  }
  uint32_t tt, gc;
  memcpy(&tt, hdr + 4, 4);
  memcpy(&gc, hdr + 8, 4);
  tt = ntohl(tt);
  gc = ntohl(gc);
  if (tuner_type) *tuner_type = tt;
  if (gain_count) *gain_count = gc;

  // Reader thread uses a short poll timeout so stop() is responsive.
  struct timeval tv = {0, 200 * 1000};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);

  auto conn = std::make_unique<Conn>();
  conn->fd = fd;
  conn->tuner_type = tt;
  conn->gain_count = gc;
  conn->ring = std::make_unique<Ring>(static_cast<size_t>(ring_capacity));
  Conn* cp = conn.get();
  conn->reader = std::thread(reader_loop, cp);

  std::lock_guard<std::mutex> lk(g_mu);
  int64_t h = g_next++;
  g_conns[h] = std::move(conn);
  return h;
}

// 5-byte rtl_tcp command packet: u8 opcode + u32be argument (the wire
// format the reference's rtltcp dependency sends, SURVEY.md §1 L1).
int rtlamr_ingest_command(int64_t h, uint8_t cmd, uint32_t arg) {
  Conn* c = find_conn(h);
  if (!c) return -1;
  uint8_t pkt[5];
  pkt[0] = cmd;
  uint32_t be = htonl(arg);
  memcpy(pkt + 1, &be, 4);
  std::lock_guard<std::mutex> lk(c->cmd_mu);
  return ::send(c->fd, pkt, 5, MSG_NOSIGNAL) == 5 ? 0 : -1;
}

// Blocking read of exactly n bytes (like the reference's per-block read
// loop, main.go:174-186). Returns bytes copied; < n means eof (stream
// closed) or deadline expiry (timeout_ms, matching the 5 s SetDeadline at
// main.go:168). Negative timeout blocks forever.
int64_t rtlamr_ingest_read(int64_t h, uint8_t* out, int64_t n,
                           int timeout_ms, int* timed_out) {
  Conn* c = find_conn(h);
  if (!c || n < 0) return -1;
  bool to = false;
  size_t got = c->ring->pop(out, static_cast<size_t>(n), timeout_ms, &to);
  if (timed_out) *timed_out = to ? 1 : 0;
  return static_cast<int64_t>(got);
}

// Fill one StagedGeometry window buffer in place (ops/spec.py): carry
// samples land at [0, halo_staged), fresh window samples at
// [halo_staged, halo_staged + window), and on a full read the carry is
// updated from the filled buffer (carry' = staged[window : window +
// halo_staged]) — exactly the layout the device program consumes, so the
// live path's per-window NumPy staging copy disappears (the transport
// writes decode-ready buffers directly, into pinned host memory when the
// caller passes a pinned tensor's pointer). The tail past
// halo_staged + window is untouched: callers keep it zeroed.
//
// Returns fresh SAMPLES read (== window normally). On eof/timeout the
// remainder of the window region is zeroed, carry is NOT updated, and the
// partial bytes remain at staged[halo_staged ...] for the caller's
// fallback byte path.
static int64_t finish_staged(uint16_t* staged, uint16_t* carry,
                             int64_t halo_staged, int64_t window,
                             size_t got_bytes) {
  size_t want = static_cast<size_t>(window) * 2;
  uint8_t* win = reinterpret_cast<uint8_t*>(staged + halo_staged);
  if (got_bytes < want) {
    memset(win + got_bytes, 0, want - got_bytes);
    return static_cast<int64_t>(got_bytes / 2);
  }
  // window >= halo in every valid FrontendSpec, but memmove tolerates
  // overlap regardless.
  memmove(carry, staged + window, static_cast<size_t>(halo_staged) * 2);
  return window;
}

int64_t rtlamr_ingest_read_staged(int64_t h, uint16_t* staged,
                                  uint16_t* carry, int64_t halo_staged,
                                  int64_t window, int timeout_ms,
                                  int* timed_out) {
  Conn* c = find_conn(h);
  if (!c || !staged || !carry || halo_staged < 0 || window <= 0) return -1;
  memcpy(staged, carry, static_cast<size_t>(halo_staged) * 2);
  bool to = false;
  size_t got = c->ring->pop(reinterpret_cast<uint8_t*>(staged + halo_staged),
                            static_cast<size_t>(window) * 2, timeout_ms, &to);
  if (timed_out) *timed_out = to ? 1 : 0;
  return finish_staged(staged, carry, halo_staged, window, got);
}

int64_t rtlamr_file_read_staged(int64_t h, uint16_t* staged, uint16_t* carry,
                                int64_t halo_staged, int64_t window) {
  FileMap* fm = find_file(h);
  if (!fm || !staged || !carry || halo_staged < 0 || window <= 0) return -1;
  memcpy(staged, carry, static_cast<size_t>(halo_staged) * 2);
  size_t want = static_cast<size_t>(window) * 2;
  size_t avail = fm->size - fm->pos;
  size_t take = want < avail ? want : avail;
  memcpy(reinterpret_cast<uint8_t*>(staged + halo_staged),
         fm->data + fm->pos, take);
  fm->pos += take;
  return finish_staged(staged, carry, halo_staged, window, take);
}

// Bytes received / dropped since connect and bytes currently buffered.
int rtlamr_ingest_stats(int64_t h, uint64_t* total, uint64_t* dropped,
                        uint64_t* buffered) {
  Conn* c = find_conn(h);
  if (!c) return -1;
  if (total) *total = c->bytes_total.load();
  if (dropped) *dropped = c->bytes_dropped.load();
  if (buffered) *buffered = c->ring->size();
  return 0;
}

int rtlamr_ingest_close(int64_t h) {
  std::unique_ptr<Conn> conn;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_conns.find(h);
    if (it == g_conns.end()) return -1;
    conn = std::move(it->second);
    g_conns.erase(it);
  }
  conn.reset();  // ~Conn stops the reader, joins it, and closes the fd
  return 0;
}

// ---------------------------------------------------------------------------
// Memory-mapped capture reader (the -fromfile offline path; the format of
// -samplefile dumps, main.go:279-289).

int64_t rtlamr_file_open(const char* path, int64_t* size_out) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return -1;
  }
  auto fm = std::make_unique<FileMap>();
  fm->fd = fd;
  fm->size = static_cast<size_t>(st.st_size);
  if (fm->size > 0) {
    void* p = mmap(nullptr, fm->size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) {
      ::close(fd);
      return -1;
    }
    madvise(p, fm->size, MADV_SEQUENTIAL);
    fm->data = static_cast<const uint8_t*>(p);
  }
  if (size_out) *size_out = static_cast<int64_t>(fm->size);
  std::lock_guard<std::mutex> lk(g_mu);
  int64_t h = g_next++;
  g_files[h] = std::move(fm);
  return h;
}

int64_t rtlamr_file_read(int64_t h, uint8_t* out, int64_t n) {
  FileMap* fm = find_file(h);
  if (!fm || n < 0) return -1;
  size_t avail = fm->size - fm->pos;
  size_t take = static_cast<size_t>(n) < avail ? static_cast<size_t>(n) : avail;
  memcpy(out, fm->data + fm->pos, take);
  fm->pos += take;
  return static_cast<int64_t>(take);
}

int rtlamr_file_seek(int64_t h, int64_t pos) {
  FileMap* fm = find_file(h);
  if (!fm || pos < 0 || static_cast<size_t>(pos) > fm->size) return -1;
  fm->pos = static_cast<size_t>(pos);
  return 0;
}

int rtlamr_file_close(int64_t h) {
  std::unique_ptr<FileMap> fm;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_files.find(h);
    if (it == g_files.end()) return -1;
    fm = std::move(it->second);
    g_files.erase(it);
  }
  if (fm->data) munmap(const_cast<uint8_t*>(fm->data), fm->size);
  ::close(fm->fd);
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// TSAN/stress harness (SURVEY.md §5.2 posture; not part of the library).
//
// Build & run:
//   g++ -std=c++17 -O1 -g -fsanitize=thread -DRTLAMR_RING_STRESS \
//       rtlamr_tpu_torch/native/src/ingest.cpp -o ring_stress -lpthread
//   ./ring_stress [seconds]
//
// A producer thread pushes a self-describing byte pattern flat-out into a
// deliberately tiny ring (forcing the drop path constantly) while the
// consumer pops random-sized chunks and validates two invariants:
//   1. pair alignment: drops only ever remove whole 2-byte I/Q pairs —
//      every even-offset byte carries marker LSB 0, every odd-offset LSB 1;
//   2. order: reconstructed pair counters carry a CONTIGUOUS 14-bit
//      sequence number (7 bits per byte beside the marker LSBs); deltas
//      must be nonzero (no duplication) and the forward gaps within each
//      pop must fit inside the pairs actually dropped since the previous
//      pop (an upper bound read from the drop counter, so drops are fine
//      but reordering's huge mod-2^14 "gap" blows the budget).
// A third thread hammers size() to give TSAN a reader-vs-writer cross.

#ifdef RTLAMR_RING_STRESS
#include <cstdio>
#include <cstdlib>

int main(int argc, char** argv) {
  double seconds = argc > 1 ? atof(argv[1]) : 2.0;
  Ring ring(4096 + 1);  // odd capacity: exercises the pair-rounding drop
  std::atomic<bool> stop{false};
  std::atomic<size_t> dropped{0};
  std::atomic<size_t> produced_pairs{0};

  std::thread producer([&] {
    uint32_t k = 0;
    uint8_t chunk[1536];  // not a multiple of ring capacity
    while (!stop.load(std::memory_order_relaxed)) {
      for (size_t i = 0; i < sizeof(chunk); i += 2, ++k) {
        // Contiguous 14-bit counter: bits 0-6 in the even byte, 7-13 in
        // the odd byte (beside the pair-alignment marker LSBs).
        chunk[i] = static_cast<uint8_t>((k << 1) & 0xFE);             // LSB 0
        chunk[i + 1] = static_cast<uint8_t>(((k >> 6) & 0xFE) | 1);   // LSB 1
      }
      dropped += ring.push(chunk, sizeof(chunk));
      produced_pairs += sizeof(chunk) / 2;
    }
    ring.set_eof();
  });

  std::thread spy([&] {
    size_t acc = 0;
    while (!stop.load(std::memory_order_relaxed)) acc += ring.size();
    if (acc == static_cast<size_t>(-1)) printf("%zu", acc);  // keep acc live
  });

  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::duration<double>(seconds);
  uint8_t out[4096];
  size_t consumed = 0;
  long last_k = -1;
  size_t total_gap_pairs = 0;  // cumulative forward gaps observed
  unsigned rng = 12345;
  bool timed_out = false;
  while (std::chrono::steady_clock::now() < deadline) {
    rng = rng * 1103515245 + 12345;
    size_t want = 2 + (rng >> 16) % (sizeof(out) - 2);
    want &= ~size_t(1);  // consumer reads whole pairs (like the CLI)
    size_t got = ring.pop(out, want, 50, &timed_out);
    for (size_t i = 0; i + 1 < got; i += 2) {
      if ((out[i] & 1) != 0 || (out[i + 1] & 1) != 1) {
        fprintf(stderr, "FAIL: pair alignment broken at byte %zu\n",
                consumed + i);
        return 1;
      }
      long k = ((out[i] >> 1) & 0x7F) | (((long)(out[i + 1] >> 1) & 0x7F) << 7);
      if (last_k >= 0) {
        long delta = (k - last_k) & 0x3FFF;  // mod 2^14 counter distance
        if (delta == 0) {
          fprintf(stderr, "FAIL: duplicated/reordered pair at byte %zu\n",
                  consumed + i);
          return 1;
        }
        total_gap_pairs += static_cast<size_t>(delta - 1);
      }
      last_k = k;
    }
    consumed += got;
    // Order check: every forward gap corresponds to pairs dropped at PUSH
    // time, which the drop counter already includes by the time the
    // consumer pops past them (FIFO + whole-pair drops) — so cumulative
    // gaps can never exceed cumulative drops. A reordered pair's
    // (2^14 - d) pseudo-gap adds ~16K pairs instantly and blows the
    // budget; true gaps >= 2^14 alias under the counter wrap, weakening
    // detection but never soundness (no false fail).
    size_t drop_now = dropped.load(std::memory_order_relaxed);
    if (2 * total_gap_pairs > drop_now) {
      fprintf(stderr,
              "FAIL: cumulative gap %zu pairs exceeds dropped %zu bytes\n",
              total_gap_pairs, drop_now);
      return 1;
    }
  }
  stop.store(true);
  producer.join();
  spy.join();
  // Drain to EOF (exercises the eof path under contention).
  size_t got;
  do {
    got = ring.pop(out, sizeof(out), 100, &timed_out);
    consumed += got;
  } while (got > 0);
  if (consumed + dropped.load() != 2 * produced_pairs.load()) {
    fprintf(stderr, "FAIL: conservation: consumed %zu + dropped %zu != %zu\n",
            consumed, dropped.load(), 2 * produced_pairs.load());
    return 1;
  }
  printf("OK consumed=%zu dropped=%zu produced_pairs=%zu\n", consumed,
         dropped.load(), produced_pairs.load());
  return 0;
}
#endif  // RTLAMR_RING_STRESS
