// streamc — native producer-side client for the serving daemon (streamd.cpp).
//
// The reference has no serving client at all (audio enters in-process,
// micloc/record.py:54-60); the framework's daemon speaks a byte protocol
// (streamd.cpp header comment), and production producers are C-class edge
// devices.  This library completes the native loop: TCP framing, the
// /dev/shm ring producer (same layout streamd consumes), and the stateful
// wire encoder (anti-aliased 4x decimation + mu-law u8/u4 companding,
// mirroring runtime/server.py:WireEncoder — filter taps are passed in from
// Python so the design stays single-sourced in ops/resample.py).
//
// C ABI for ctypes (runtime/native_client.py); no third-party deps.
//
// Build: g++ -O2 -shared -fPIC -o libstreamc.so streamc.cpp
#include <arpa/inet.h>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x484D3234u;     // "HM24" (streamd.cpp:58)
constexpr uint32_t kShmMagic = 0x484D5348u;  // "HMSH" (streamd.cpp:84)
constexpr size_t kShmHdr = 64;

bool write_exact(int fd, const void* buf, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t w = ::write(fd, p, n);
    if (w < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        struct timespec ts{0, 1000000};
        ::nanosleep(&ts, nullptr);
        continue;
      }
      return false;
    }
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool read_exact(int fd, void* buf, size_t n, int timeout_ms) {
  uint8_t* p = static_cast<uint8_t*>(buf);
  struct timeval tv{timeout_ms / 1000, (timeout_ms % 1000) * 1000};
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r == 0) return false;  // server closed
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;  // timeout or error
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

}  // namespace

// ---------------------------------------------------------------- TCP client
extern "C" int sc_connect(const char* host, uint16_t port, uint32_t stream_id) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1 ||
      ::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(fd);
    return -1;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  uint32_t hello[2] = {kMagic, stream_id};
  if (!write_exact(fd, hello, sizeof(hello))) {
    ::close(fd);
    return -1;
  }
  return fd;
}

// One protocol frame: u32 element count, then the payload bytes.  n_elems
// counts SAMPLES of the server's configured element type (streamd.cpp:260).
extern "C" int sc_send_frame(int fd, const void* data, uint32_t n_elems,
                             uint32_t elem_size) {
  uint32_t hdr = n_elems;
  if (!write_exact(fd, &hdr, 4)) return -1;
  if (!write_exact(fd, data, static_cast<size_t>(n_elems) * elem_size))
    return -1;
  return 0;
}

// Result frame: u32 stream_id, f32 doa[k] (streamd.cpp sd_post_results; k
// is the server's sd_set_sources config, NaN-padded — the client must pass
// the matching k or its framing desyncs).
extern "C" int sc_recv_doas(int fd, uint32_t* sid, float* doas, uint32_t k,
                            int timeout_ms) {
  if (k < 1 || k > 8) return -1;
  uint8_t buf[4 + 4 * 8];
  const size_t len = 4 + 4 * static_cast<size_t>(k);
  if (!read_exact(fd, buf, len, timeout_ms)) return -1;
  std::memcpy(sid, buf, 4);
  std::memcpy(doas, buf + 4, 4 * k);
  return 0;
}

extern "C" int sc_recv_doa(int fd, uint32_t* sid, float* doa, int timeout_ms) {
  return sc_recv_doas(fd, sid, doa, 1, timeout_ms);
}

extern "C" void sc_close(int fd) { ::close(fd); }

// ------------------------------------------------------------- shm producer
// Single-producer/single-consumer byte ring under /dev/shm, the exact layout
// streamd.cpp:73-84 consumes: u32 magic @0 (set LAST), u32 cap @4,
// u64 write_pos @8, u64 read_pos @16, u32 result_seq @24, f32 doa @28.
struct ScShm {
  uint8_t* base = nullptr;
  size_t map_len = 0;
  uint32_t cap = 0;
  uint32_t last_seq = 0;
  std::string path;
};

extern "C" void* sc_shm_create(const char* name, uint32_t capacity) {
  std::string path = std::string("/dev/shm/") + name;
  int fd = ::open(path.c_str(), O_RDWR | O_CREAT | O_TRUNC, 0600);
  if (fd < 0) return nullptr;
  size_t len = kShmHdr + capacity;
  if (::ftruncate(fd, static_cast<off_t>(len)) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* b = ::mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  ::close(fd);
  if (b == MAP_FAILED) return nullptr;
  auto* s = new ScShm;
  s->base = static_cast<uint8_t*>(b);
  s->map_len = len;
  s->cap = capacity;
  s->path = path;
  std::memset(s->base, 0, kShmHdr);
  std::memcpy(s->base + 4, &capacity, 4);
  // magic last: the ring is valid only once fully initialized
  __atomic_store_n(reinterpret_cast<uint32_t*>(s->base), kShmMagic,
                   __ATOMIC_RELEASE);
  return s;
}

extern "C" int sc_shm_send(void* h, const void* data, uint32_t n,
                           int timeout_ms) {
  auto* s = static_cast<ScShm*>(h);
  const uint8_t* p = static_cast<const uint8_t*>(data);
  uint32_t off = 0;
  const double deadline = now_s() + timeout_ms * 1e-3;
  while (off < n) {
    uint64_t wp = __atomic_load_n(reinterpret_cast<uint64_t*>(s->base + 8),
                                  __ATOMIC_ACQUIRE);
    uint64_t rp = __atomic_load_n(reinterpret_cast<uint64_t*>(s->base + 16),
                                  __ATOMIC_ACQUIRE);
    uint32_t free_b = s->cap - static_cast<uint32_t>(wp - rp);
    if (free_b == 0) {  // full: natural backpressure, sleep-poll
      if (now_s() > deadline) return -1;
      struct timespec ts{0, 200000};
      ::nanosleep(&ts, nullptr);
      continue;
    }
    uint32_t take = std::min(free_b, n - off);
    size_t idx = static_cast<size_t>(wp % s->cap);
    size_t first = std::min<size_t>(take, s->cap - idx);
    std::memcpy(s->base + kShmHdr + idx, p + off, first);
    if (first < take)
      std::memcpy(s->base + kShmHdr, p + off + first, take - first);
    // data before position, release order (streamd reads with acquire)
    __atomic_store_n(reinterpret_cast<uint64_t*>(s->base + 8), wp + take,
                     __ATOMIC_RELEASE);
    off += take;
  }
  return 0;
}

// Multi-source shm results: slot 0 at header offset 28, slots 1..k-1 at
// 36 + 4*(i-1) (streamd.cpp ShmRing::post_result).
extern "C" int sc_shm_recv_doas(void* h, float* doas, uint32_t k,
                                int timeout_ms) {
  auto* s = static_cast<ScShm*>(h);
  if (k < 1 || k > 8) return -1;
  const double deadline = now_s() + timeout_ms * 1e-3;
  for (;;) {
    uint32_t seq = __atomic_load_n(reinterpret_cast<uint32_t*>(s->base + 24),
                                   __ATOMIC_ACQUIRE);
    if (seq != s->last_seq) {
      s->last_seq = seq;
      std::memcpy(doas, s->base + 28, 4);
      for (uint32_t i = 1; i < k; ++i)
        std::memcpy(doas + i, s->base + 36 + 4 * (i - 1), 4);
      return 0;
    }
    if (now_s() > deadline) return -1;
    struct timespec ts{0, 200000};
    ::nanosleep(&ts, nullptr);
  }
}

extern "C" int sc_shm_recv_doa(void* h, float* doa, int timeout_ms) {
  return sc_shm_recv_doas(h, doa, 1, timeout_ms);
}

extern "C" void sc_shm_close(void* h, int unlink_file) {
  auto* s = static_cast<ScShm*>(h);
  ::munmap(s->base, s->map_len);
  if (unlink_file) ::unlink(s->path.c_str());
  delete s;
}

// ------------------------------------------------------------ wire encoder
// Stateful (T, C) float32 -> wire-bytes encoder, the C twin of
// runtime/server.py:WireEncoder.  dtype: 0=f32, 1=i16, 2=u8 (mu-law 255),
// 3=u4 (mu-law 15, two codes per byte along time).  upsample in {1, 4}:
// anti-aliased decimation with carried input history so chunked encoding
// equals encoding the concatenated stream (taps supplied by the caller —
// design lives in ops/resample.py).
struct ScEncoder {
  int dtype;
  int up;
  int nch;
  std::vector<float> taps;   // anti-alias FIR (already /factor normalized)
  std::vector<float> carry;  // (ntaps-1) * nch input history
  std::vector<float> work;
};

extern "C" void* sc_encoder_new(int dtype, int upsample, int nch,
                                const float* taps, int ntaps) {
  if (dtype < 0 || dtype > 3 || nch <= 0) return nullptr;
  if (upsample != 1 && upsample != 4) return nullptr;
  if (upsample > 1 && (!taps || ntaps <= 0)) return nullptr;
  auto* e = new ScEncoder;
  e->dtype = dtype;
  e->up = upsample;
  e->nch = nch;
  if (upsample > 1) {
    e->taps.assign(taps, taps + ntaps);
    e->carry.assign(static_cast<size_t>(ntaps - 1) * nch, 0.0f);
  }
  return e;
}

static inline uint8_t mulaw_code(float x, double mu, double levels) {
  if (x > 1.0f) x = 1.0f;
  if (x < -1.0f) x = -1.0f;
  // double-precision companding + round-half-to-even: bit-matches numpy's
  // mulaw_encode (ops/mulaw.py), which casts |x| to float64 explicitly
  // before log1p (NEP 50 no longer promotes via the python-float MU)
  double ax = std::fabs(static_cast<double>(x));
  double mag = std::log1p(mu * ax) / std::log1p(mu);
  double q = std::nearbyint(mag * levels);
  uint8_t code = static_cast<uint8_t>(q);
  if (x < 0.0f) code += static_cast<uint8_t>(levels + 1.0);
  return code;
}

// Returns bytes written to out (caller sizes out for the worst case:
// T*nch*4 bytes).  T must divide by the upsample factor; the wire-rate
// sample count must be even for u4.
extern "C" int sc_encoder_encode(void* h, const float* x, int T,
                                 uint8_t* out) {
  auto* e = static_cast<ScEncoder*>(h);
  const int C = e->nch;
  const float* src = x;
  int Tw = T;
  if (e->up > 1) {
    if (T % e->up) return -1;
    const int L = static_cast<int>(e->taps.size());
    const int K = L - 1;
    // ext = [carry; x], causal FIR, take every up-th output
    e->work.resize(static_cast<size_t>(K + T) * C);
    std::memcpy(e->work.data(), e->carry.data(), sizeof(float) * K * C);
    std::memcpy(e->work.data() + static_cast<size_t>(K) * C, x,
                sizeof(float) * static_cast<size_t>(T) * C);
    Tw = T / e->up;
    // decimated output overwrites the front of a second buffer
    static thread_local std::vector<float> dec;
    dec.resize(static_cast<size_t>(Tw) * C);
    for (int i = 0; i < Tw; ++i) {
      const int n = i * e->up;  // output index within the chunk
      for (int c = 0; c < C; ++c) {
        float acc = 0.0f;
        const float* w = e->work.data() + static_cast<size_t>(n) * C + c;
        // y[n] = sum_j taps[j] * ext[K + n - j]  ==  dot over the window
        for (int j = 0; j < L; ++j)
          acc += e->taps[j] * w[static_cast<size_t>(L - 1 - j) * C];
        dec[static_cast<size_t>(i) * C + c] = acc;
      }
    }
    std::memcpy(e->carry.data(),
                e->work.data() + static_cast<size_t>(T) * C,
                sizeof(float) * K * C);
    src = dec.data();
  }
  switch (e->dtype) {
    case 0: {  // f32
      std::memcpy(out, src, sizeof(float) * static_cast<size_t>(Tw) * C);
      return static_cast<int>(sizeof(float)) * Tw * C;
    }
    case 1: {  // i16
      int16_t* o = reinterpret_cast<int16_t*>(out);
      for (int i = 0; i < Tw * C; ++i) {
        float v = src[i] * 32767.0f;
        if (v > 32767.0f) v = 32767.0f;
        if (v < -32768.0f) v = -32768.0f;
        o[i] = static_cast<int16_t>(v);
      }
      return 2 * Tw * C;
    }
    case 2: {  // u8 mu-law(255): sign bit 7, magnitude bits 0-6
      for (int i = 0; i < Tw * C; ++i)
        out[i] = mulaw_code(src[i], 255.0f, 127.0f);
      return Tw * C;
    }
    case 3: {  // u4 mu-law(15) packed: even time sample in the high nibble
      if (Tw % 2) return -1;
      for (int t = 0; t < Tw; t += 2) {
        for (int c = 0; c < C; ++c) {
          uint8_t hi = mulaw_code(src[static_cast<size_t>(t) * C + c],
                                  15.0f, 7.0f);
          uint8_t lo = mulaw_code(src[static_cast<size_t>(t + 1) * C + c],
                                  15.0f, 7.0f);
          out[static_cast<size_t>(t / 2) * C + c] =
              static_cast<uint8_t>(hi << 4 | lo);
        }
      }
      return Tw / 2 * C;
    }
  }
  return -1;
}

extern "C" void sc_encoder_free(void* h) { delete static_cast<ScEncoder*>(h); }
