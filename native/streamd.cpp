// streamd — native multi-stream audio ingestion daemon for the serving
// runtime (runtime/server.py binds it via ctypes).
//
// The reference has no serving path at all: its live demo shells out to sox
// for one 0.25 s capture at a time and re-enters Python between frames
// (micloc/record.py:54-60, micloc/xylo_snn_localization.py:446-542).  This
// daemon is the production-shaped twin: N concurrent TCP audio streams
// land in per-stream ring buffers, the Python compute loop drains at most
// one chunk per stream per step (the carried-state batched device step
// advances every stream exactly one chunk), and DoA results are routed back
// to each stream's socket.
//
// IO model: ONE epoll event loop thread owns every socket (accept + reads).
// A thread-per-connection design measured 10x worse on a 2-vCPU host — 64
// reader threads thrashing a mutex starved the compute thread; the event
// loop keeps ingestion at one core regardless of stream count.
//
// Wire protocol (little-endian):
//   client → server on connect:  u32 magic 0x484D3234 ("HM24"), u32 stream_id
//   client → server frames:      u32 n_elems, then n_elems samples of the
//                                server's configured element type (f32 or
//                                PCM16 — time-major mic-interleaved, i.e.
//                                row t is n_mics consecutive samples,
//                                matching (Tc, M)).  PCM16 halves the wire
//                                AND host->device bytes; audio arrives as
//                                int16 in production anyway.
//   server → client per result:  u32 stream_id, f32 doa_radians[K] where K
//                                 is the server's configured sources-per-
//                                 stream (sd_set_sources; default 1 keeps
//                                 the legacy 8-byte frame).  Absent sources
//                                 are NaN-padded — the frame stays fixed-
//                                 size so client framing never desyncs.
//
// Stream ids are client-chosen slots in [0, max_streams); claiming a live
// slot is rejected.  A (re)claimed slot is reported once through
// sd_take_resets so the compute loop zeroes that stream's carried state.
#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x484D3234u;  // "HM24"

// Backpressure: past this many queued chunks the stream's fd is dropped from
// the epoll interest set (events=0 — HUP/ERR still delivered), so the
// client's TCP window fills and the sender blocks instead of growing server
// memory without bound.  Re-armed by the compute loop at half this depth.
constexpr size_t kReadyHighWater = 16;

// ---------------------------------------------------------------------------
// Shared-memory transport: a co-located producer maps the same ring and
// writes audio with plain memcpy — no socket syscalls, no kernel copies, no
// reader thread.  Single-producer/single-consumer ring with monotonically
// increasing byte positions (never wrapped values; index = pos % capacity):
//
//   offset  field                       owner
//   0       u32 magic 0x484D5348 "HMSH" producer (set last, after init)
//   4       u32 capacity (data bytes)   producer
//   8       u64 write_pos               producer (release-stored)
//   16      u64 read_pos                consumer (release-stored)
//   24      u32 result_seq              consumer (incremented after doa)
//   28      f32 result_doa              consumer (source 0)
//   32      u32 server_gen              consumer (attach generation)
//   36      f32 result_doa[1..7]        consumer (multi-source slots 1..K-1,
//                                       NaN-padded; sd_set_sources, K <= 8)
//   64      data[capacity]              shared
//
// Producer blocks (spins/sleeps) when the ring is full — natural
// backpressure, the TCP path's deque cap is not needed here.
constexpr uint32_t kShmMagic = 0x484D5348u;  // "HMSH"
constexpr size_t kShmHdr = 64;

struct ShmRing {
  uint8_t* base = nullptr;
  size_t map_len = 0;
  uint32_t cap = 0;

  uint64_t write_pos() const {
    return __atomic_load_n(reinterpret_cast<const uint64_t*>(base + 8),
                           __ATOMIC_ACQUIRE);
  }
  uint64_t read_pos() const {
    return __atomic_load_n(reinterpret_cast<const uint64_t*>(base + 16),
                           __ATOMIC_ACQUIRE);
  }
  void set_read_pos(uint64_t v) {
    __atomic_store_n(reinterpret_cast<uint64_t*>(base + 16), v,
                     __ATOMIC_RELEASE);
  }
  void post_result(const float* doa, uint32_t k) {
    std::memcpy(base + 28, doa, 4);
    for (uint32_t i = 1; i < k; ++i)
      std::memcpy(base + 36 + 4 * (i - 1), doa + i, 4);
    uint32_t seq;
    std::memcpy(&seq, base + 24, 4);
    seq += 1;
    __atomic_store_n(reinterpret_cast<uint32_t*>(base + 24), seq,
                     __ATOMIC_RELEASE);
  }
  // copy one chunk out (chunk fully available by caller's check)
  void take(uint8_t* dst, size_t n) {
    const uint64_t rp = read_pos();
    const size_t idx = static_cast<size_t>(rp % cap);
    const size_t first = std::min(n, static_cast<size_t>(cap) - idx);
    std::memcpy(dst, base + kShmHdr + idx, first);
    if (first < n) std::memcpy(dst + first, base + kShmHdr, n - first);
    set_read_pos(rp + n);
  }
};

struct Stream {
  std::deque<std::vector<uint8_t>> ready;  // full chunks awaiting the batch loop
  std::vector<uint8_t> partial;            // tail of the last frame, < chunk
  int fd = -1;                           // live socket (results route here)
  uint64_t gen = 0;                      // bumped on every claim/close: kills
                                         // the fd-number ABA (a recycled fd
                                         // re-claiming the same slot mid-frame
                                         // must not inherit partial sends)
  bool reset_pending = false;            // new claim: zero carried state first
  bool throttled = false;                // fd removed from epoll interest set
  ShmRing shm;                           // shm transport when base != nullptr
};

// per-connection read state machine (epoll loop only — no locking needed)
struct Conn {
  enum State { HELLO, HEADER, BODY } state = HELLO;
  uint32_t id = UINT32_MAX;   // stream slot after a valid hello
  uint8_t hdr[8];             // hello (8B) or frame header (4B) accumulator
  size_t hdr_got = 0;
  size_t body_left = 0;       // payload bytes still expected
};

struct Server {
  int listen_fd = -1;
  int epoll_fd = -1;
  uint16_t port = 0;
  uint32_t max_streams = 0;
  uint32_t chunk_bytes = 0;   // chunk_samples * n_mics * elem_size
  uint32_t elem_size = 4;     // bytes per sample (4 = f32, 2 = PCM16)
  std::atomic<bool> stopping{false};
  uint32_t batch_window_ms = 2;  // cohort-fill window (sd_set_window)
  uint32_t res_floats = 1;       // DoA slots per result frame (sd_set_sources)

  std::mutex mu;  // guards streams[] (ready/fd/reset) — epoll vs compute
  std::condition_variable ready_cv;
  std::vector<Stream> streams;
  uint32_t rr_cursor = 0;  // round-robin fairness across streams
  std::atomic<uint32_t> n_shm{0};  // attached shm rings (poll instead of cv)

  std::unordered_map<int, Conn> conns;  // epoll thread only
  std::thread io_thread;
};

void close_conn(Server* s, int fd) {
  auto it = s->conns.find(fd);
  if (it != s->conns.end()) {
    const uint32_t id = it->second.id;
    if (id < s->max_streams) {
      std::lock_guard<std::mutex> lk(s->mu);
      if (s->streams[id].fd == fd) {
        s->streams[id].fd = -1;
        s->streams[id].gen++;
        s->streams[id].throttled = false;
      }
    }
    s->conns.erase(it);
  }
  ::epoll_ctl(s->epoll_fd, EPOLL_CTL_DEL, fd, nullptr);
  ::close(fd);
}

// Append raw payload bytes to the stream's partial buffer, slicing off full
// chunks into the ready queue.  Called from the epoll thread.  Payload is an
// opaque byte stream (element framing is the header's job), so recv()
// fragmentation needs no special alignment handling.
void ingest(Server* s, Conn& c, const uint8_t* data, size_t n) {
  std::lock_guard<std::mutex> lk(s->mu);
  Stream& st = s->streams[c.id];
  st.partial.insert(st.partial.end(), data, data + n);
  bool notified = false;
  while (st.partial.size() >= s->chunk_bytes) {
    st.ready.emplace_back(st.partial.begin(),
                          st.partial.begin() + s->chunk_bytes);
    st.partial.erase(st.partial.begin(), st.partial.begin() + s->chunk_bytes);
    if (!notified) {
      s->ready_cv.notify_all();
      notified = true;
    }
  }
  // backpressure: a client outrunning the compute loop (one chunk per stream
  // per step) stops being read once its queue is deep enough; its TCP window
  // fills and the send side blocks instead of this deque growing unbounded
  if (st.ready.size() >= kReadyHighWater && !st.throttled && st.fd >= 0) {
    epoll_event ev{};
    ev.events = 0;  // HUP/ERR still delivered; EPOLLIN re-armed on drain
    ev.data.fd = st.fd;
    ::epoll_ctl(s->epoll_fd, EPOLL_CTL_MOD, st.fd, &ev);
    st.throttled = true;
  }
}

void handle_readable(Server* s, int fd) {
  auto it = s->conns.find(fd);
  if (it == s->conns.end()) return;
  Conn& c = it->second;
  uint8_t buf[64 * 1024];
  for (;;) {
    ssize_t r = ::recv(fd, buf, sizeof(buf), MSG_DONTWAIT);
    if (r == 0 || (r < 0 && errno != EAGAIN && errno != EWOULDBLOCK)) {
      close_conn(s, fd);
      return;
    }
    if (r < 0) return;  // drained
    size_t off = 0;
    while (off < static_cast<size_t>(r)) {
      if (c.state == Conn::HELLO) {
        const size_t want = 8 - c.hdr_got;
        const size_t take = std::min(want, static_cast<size_t>(r) - off);
        std::memcpy(c.hdr + c.hdr_got, buf + off, take);
        c.hdr_got += take;
        off += take;
        if (c.hdr_got < 8) continue;
        uint32_t magic, id;
        std::memcpy(&magic, c.hdr, 4);
        std::memcpy(&id, c.hdr + 4, 4);
        c.hdr_got = 0;
        bool ok = (magic == kMagic && id < s->max_streams);
        if (ok) {
          std::lock_guard<std::mutex> lk(s->mu);
          Stream& st = s->streams[id];
          if (st.fd >= 0 || st.shm.base) {
            ok = false;  // slot already live (TCP or shm): reject
          } else {
            st.fd = fd;
            st.gen++;
            st.reset_pending = true;
            st.throttled = false;
            st.partial.clear();
            st.ready.clear();
          }
        }
        if (!ok) {
          close_conn(s, fd);
          return;
        }
        c.id = id;
        c.state = Conn::HEADER;
      } else if (c.state == Conn::HEADER) {
        const size_t want = 4 - c.hdr_got;
        const size_t take = std::min(want, static_cast<size_t>(r) - off);
        std::memcpy(c.hdr + c.hdr_got, buf + off, take);
        c.hdr_got += take;
        off += take;
        if (c.hdr_got < 4) continue;
        uint32_t n_elems;
        std::memcpy(&n_elems, c.hdr, 4);
        c.hdr_got = 0;
        if (n_elems == 0 || n_elems > (64u << 20)) {
          close_conn(s, fd);
          return;
        }
        c.body_left = static_cast<size_t>(n_elems) * s->elem_size;
        c.state = Conn::BODY;
      } else {  // BODY
        const size_t take =
            std::min(c.body_left, static_cast<size_t>(r) - off);
        ingest(s, c, buf + off, take);
        c.body_left -= take;
        off += take;
        if (c.body_left == 0) c.state = Conn::HEADER;
      }
    }
  }
}

void io_loop(Server* s) {
  epoll_event evs[64];
  while (!s->stopping.load()) {
    int n = ::epoll_wait(s->epoll_fd, evs, 64, 100);
    for (int i = 0; i < n; ++i) {
      const int fd = evs[i].data.fd;
      if (fd == s->listen_fd) {
        for (;;) {
          int cfd = ::accept4(s->listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
          if (cfd < 0) break;
          int one = 1;
          ::setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.fd = cfd;
          ::epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, cfd, &ev);
          s->conns.emplace(cfd, Conn{});
        }
      } else if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
        close_conn(s, fd);
      } else {
        handle_readable(s, fd);
      }
    }
  }
  for (auto& [fd, c] : s->conns) ::close(fd);
  s->conns.clear();
}

}  // namespace

extern "C" {

void* sd_start(uint16_t port, uint32_t max_streams, uint32_t chunk_samples,
               uint32_t n_mics, uint32_t elem_size) {
  auto* s = new Server();
  s->max_streams = max_streams;
  s->elem_size = elem_size ? elem_size : 4;
  s->chunk_bytes = chunk_samples * n_mics * s->elem_size;
  s->streams.resize(max_streams);

  s->listen_fd = ::socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (s->listen_fd < 0) {
    delete s;
    return nullptr;
  }
  int one = 1;
  ::setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(port);
  if (::bind(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) <
          0 ||
      ::listen(s->listen_fd, 64) < 0) {
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  s->port = ntohs(addr.sin_port);

  s->epoll_fd = ::epoll_create1(0);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = s->listen_fd;
  ::epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, s->listen_fd, &ev);
  s->io_thread = std::thread(io_loop, s);
  return s;
}

int sd_port(void* h) { return static_cast<Server*>(h)->port; }

void sd_set_window(void* h, uint32_t window_ms) {
  static_cast<Server*>(h)->batch_window_ms = window_ms;
}

// Sources per stream: every result frame carries exactly K DoA floats
// (NaN-padded when fewer targets are confirmed).  K <= 8 so multi-source
// frames also fit the shm header's fixed result slots.  Call before any
// client connects — clients size their frame parser from the same config.
void sd_set_sources(void* h, uint32_t k) {
  auto* s = static_cast<Server*>(h);
  s->res_floats = k < 1 ? 1u : (k > 8 ? 8u : k);
}

// Pop at most one ready chunk per stream (round-robin start for fairness),
// up to max_batch streams.  Blocks up to timeout_ms when nothing is ready.
// After the first chunk arrives, keeps collecting for up to window_ms while
// more streams become ready (batching window: one device launch serves the
// whole cohort instead of firing on the first straggler).
// data_out is the caller's persistent (max_streams, chunk) buffer: each
// served chunk lands at row `stream_id` (slot-indexed, so the Python side
// re-packs nothing); rows of unserved streams are left untouched.
// Full-fat batch call: additionally drains the pending-reset set ATOMICALLY
// (same mutex hold as the chunk pops).  Because a (re)claim clears the
// slot's queued data under that same mutex, every chunk this call returns
// was ingested AFTER the most recent claim of its slot — so the caller can
// zero reset slots' carried state and then process all returned chunks,
// with no possibility of a dead predecessor's chunk feeding the successor
// (nor of a successor's first chunk being mistaken for the predecessor's).
int sd_next_batch_r(void* h, uint32_t max_batch, uint32_t timeout_ms,
                    uint32_t* ids_out, uint8_t* data_out,
                    uint32_t* reset_ids_out, int reset_cap,
                    int* n_resets_out) {
  auto* s = static_cast<Server*>(h);
  std::unique_lock<std::mutex> lk(s->mu);
  auto stream_has_chunk = [&](const Stream& st) -> bool {
    if (!st.ready.empty()) return true;
    if (st.shm.base)
      return st.shm.write_pos() - st.shm.read_pos() >= s->chunk_bytes;
    return false;
  };
  auto count_ready = [&]() -> uint32_t {
    uint32_t c = 0;
    for (const auto& st : s->streams)
      if (stream_has_chunk(st)) ++c;
    return c;
  };
  auto any_ready = [&] { return s->stopping.load() || count_ready() > 0; };
  // shm producers write with plain memcpy and never signal the cv, so with
  // any ring attached the waits become short poll-sleeps instead
  auto wait_any = [&](std::chrono::steady_clock::time_point deadline) {
    while (!any_ready() && std::chrono::steady_clock::now() < deadline) {
      if (s->n_shm.load() > 0) {
        lk.unlock();
        std::this_thread::sleep_for(std::chrono::microseconds(200));
        lk.lock();
      } else if (s->ready_cv.wait_until(lk, deadline) == std::cv_status::timeout) {
        break;
      }
    }
  };
  if (!any_ready())
    wait_any(std::chrono::steady_clock::now() +
             std::chrono::milliseconds(timeout_ms));
  if (s->stopping.load()) return -1;

  // batching window: wait for the cohort to fill, bounded by window_ms
  const uint32_t window_ms = s->batch_window_ms;
  if (window_ms > 0 && count_ready() > 0) {
    auto deadline =
        std::chrono::steady_clock::now() + std::chrono::milliseconds(window_ms);
    uint32_t have = count_ready();
    while (have < max_batch && have < s->max_streams && !s->stopping.load() &&
           std::chrono::steady_clock::now() < deadline) {
      if (s->n_shm.load() > 0) {
        lk.unlock();
        std::this_thread::sleep_for(std::chrono::microseconds(200));
        lk.lock();
      } else if (s->ready_cv.wait_until(lk, deadline) == std::cv_status::timeout) {
        break;
      }
      have = count_ready();
    }
  }

  // resets drained under the SAME mutex hold as the chunk pops (see above)
  if (n_resets_out) {
    int nr = 0;
    for (uint32_t id = 0; id < s->max_streams && nr < reset_cap; ++id) {
      if (s->streams[id].reset_pending) {
        s->streams[id].reset_pending = false;
        reset_ids_out[nr++] = id;
      }
    }
    *n_resets_out = nr;
  }

  int n = 0;
  const uint32_t S = s->max_streams;
  for (uint32_t k = 0; k < S && n < static_cast<int>(max_batch); ++k) {
    const uint32_t id = (s->rr_cursor + k) % S;
    Stream& st = s->streams[id];
    uint8_t* row = data_out + static_cast<size_t>(id) * s->chunk_bytes;
    if (st.shm.base) {
      if (st.shm.write_pos() - st.shm.read_pos() < s->chunk_bytes) continue;
      st.shm.take(row, s->chunk_bytes);
      ids_out[n] = id;
      ++n;
      continue;
    }
    if (st.ready.empty()) continue;
    ids_out[n] = id;
    std::memcpy(row, st.ready.front().data(), s->chunk_bytes);
    st.ready.pop_front();
    ++n;
    // low-water re-arm: resume reading a throttled stream once the compute
    // loop has drained half the queue (level-triggered epoll fires
    // immediately on the kernel-buffered bytes)
    if (st.throttled && st.ready.size() <= kReadyHighWater / 2 && st.fd >= 0) {
      epoll_event ev{};
      ev.events = EPOLLIN;
      ev.data.fd = st.fd;
      ::epoll_ctl(s->epoll_fd, EPOLL_CTL_MOD, st.fd, &ev);
      st.throttled = false;
    }
  }
  s->rr_cursor = (s->rr_cursor + 1) % (S ? S : 1);
  return n;
}

int sd_next_batch(void* h, uint32_t max_batch, uint32_t timeout_ms,
                  uint32_t* ids_out, uint8_t* data_out) {
  return sd_next_batch_r(h, max_batch, timeout_ms, ids_out, data_out, nullptr,
                         0, nullptr);
}

// Drain the set of slots whose carried state must be zeroed (new claims).
int sd_take_resets(void* h, uint32_t* ids_out, int cap) {
  auto* s = static_cast<Server*>(h);
  std::lock_guard<std::mutex> lk(s->mu);
  int n = 0;
  for (uint32_t id = 0; id < s->max_streams && n < cap; ++id) {
    if (s->streams[id].reset_pending) {
      s->streams[id].reset_pending = false;
      ids_out[n++] = id;
    }
  }
  return n;
}

// Post one DoA result per served stream.  Runs on the compute thread, so it
// must never head-of-line block the serving cohort: a full socket buffer
// drops the result immediately (every chunk's result supersedes the last —
// the client keeps its running estimate fresh from later chunks).  Each send
// happens while holding s->mu and after re-reading the slot's fd: close_conn
// publishes fd=-1 under the same mutex BEFORE ::close(fd), so a result can
// never land on a recycled fd number routed to a different connection.
void sd_post_results(void* h, uint32_t n, const uint32_t* ids,
                     const float* doas) {
  auto* s = static_cast<Server*>(h);
  const uint32_t K = s->res_floats;  // doas is (n, K) row-major
  const size_t msg_len = 4 + 4 * static_cast<size_t>(K);
  for (uint32_t i = 0; i < n; ++i) {
    if (ids[i] >= s->max_streams) continue;
    {
      std::lock_guard<std::mutex> lk(s->mu);
      Stream& st = s->streams[ids[i]];
      if (st.shm.base) {  // shm transport: one seq-tagged slot, never blocks
        st.shm.post_result(doas + static_cast<size_t>(i) * K, K);
        continue;
      }
    }
    uint8_t msg[4 + 4 * 8];  // K <= 8 (sd_set_sources clamps)
    std::memcpy(msg, &ids[i], 4);
    std::memcpy(msg + 4, doas + static_cast<size_t>(i) * K, 4 * K);
    size_t off = 0;
    int spins = 0;
    int fd0;
    uint64_t gen0;
    {
      std::lock_guard<std::mutex> lk(s->mu);
      fd0 = s->streams[ids[i]].fd;
      gen0 = s->streams[ids[i]].gen;
    }
    if (fd0 < 0) continue;  // stream not live; drop
    while (off < msg_len) {
      ssize_t r;
      {
        // send under the mutex: non-blocking, so the hold is one syscall,
        // and the epoll thread's close path (which takes the same mutex
        // before publishing fd=-1) can never close/recycle fd0 mid-send —
        // a result can never land on a reused fd number.  The fd is pinned
        // to (fd0, gen0) for the WHOLE frame: if the slot is reclaimed
        // mid-frame, the remaining bytes must not splice into the
        // successor's stream.  The generation check closes the ABA hole
        // where accept() recycles the same fd number to a new client that
        // HELLOs the same slot within the retry window.
        std::lock_guard<std::mutex> lk(s->mu);
        if (s->streams[ids[i]].fd != fd0 ||
            s->streams[ids[i]].gen != gen0) break;  // died/reclaimed: drop
        r = ::send(fd0, msg + off, msg_len - off,
                   MSG_NOSIGNAL | MSG_DONTWAIT);
      }
      if (r > 0) {
        off += static_cast<size_t>(r);
        continue;
      }
      if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        if (off == 0) break;  // nothing written: drop whole result, no wait
        // mid-message full buffer (rare: 8 B frames): try briefly to finish
        // the frame; a partial frame abandoned on the socket would desync
        // the client's framing FOREVER, so if the client still can't take
        // bytes after ~2 ms, kill the connection instead (publish fd=-1
        // first so no further result routes here; shutdown() — not close()
        // — so the fd number stays reserved until the epoll thread reaps
        // the HUP via close_conn).
        if (++spins > 40) {
          std::lock_guard<std::mutex> lk(s->mu);
          Stream& st = s->streams[ids[i]];
          if (st.fd == fd0 && st.gen == gen0) {  // only shoot our own conn —
            st.fd = -1;        // fd0 may be recycled once (fd, gen) moved on
            st.gen++;
            st.throttled = false;
            ::shutdown(fd0, SHUT_RDWR);
          }
          break;
        }
        std::this_thread::sleep_for(std::chrono::microseconds(50));
        continue;
      }
      break;  // hard error: epoll reaps the fd
    }
  }
}

// Attach a shared-memory ring (created + initialized by the producer under
// /dev/shm) to a stream slot.  The slot gets the same reclaim semantics as a
// TCP claim: carried state is zeroed before its first chunk.  Returns 0 on
// success, -1 on failure (bad ring, slot live on TCP, bad id).
int sd_shm_attach(void* h, uint32_t stream_id, const char* name) {
  auto* s = static_cast<Server*>(h);
  if (stream_id >= s->max_streams) return -1;
  std::string path = std::string("/dev/shm/") + name;
  int fd = ::open(path.c_str(), O_RDWR);
  if (fd < 0) return -1;
  struct stat sb{};
  if (::fstat(fd, &sb) != 0 || static_cast<size_t>(sb.st_size) < kShmHdr) {
    ::close(fd);
    return -1;
  }
  void* base = ::mmap(nullptr, sb.st_size, PROT_READ | PROT_WRITE, MAP_SHARED,
                      fd, 0);
  ::close(fd);  // mapping keeps the segment alive
  if (base == MAP_FAILED) return -1;
  auto* b = static_cast<uint8_t*>(base);
  uint32_t magic, cap;
  std::memcpy(&magic, b, 4);
  std::memcpy(&cap, b + 4, 4);
  if (magic != kShmMagic || cap == 0 ||
      kShmHdr + static_cast<size_t>(cap) > static_cast<size_t>(sb.st_size) ||
      cap < s->chunk_bytes) {
    ::munmap(base, sb.st_size);
    return -1;
  }
  std::lock_guard<std::mutex> lk(s->mu);
  Stream& st = s->streams[stream_id];
  if (st.fd >= 0) {  // slot live on TCP: reject
    ::munmap(base, sb.st_size);
    return -1;
  }
  if (st.shm.base) {  // re-attach: drop the old mapping
    ::munmap(st.shm.base, st.shm.map_len);
    s->n_shm.fetch_sub(1);
  }
  st.shm.base = b;
  st.shm.map_len = static_cast<size_t>(sb.st_size);
  st.shm.cap = cap;
  st.reset_pending = true;
  st.partial.clear();
  st.ready.clear();
  s->n_shm.fetch_add(1);
  return 0;
}

int sd_shm_detach(void* h, uint32_t stream_id) {
  auto* s = static_cast<Server*>(h);
  if (stream_id >= s->max_streams) return -1;
  std::lock_guard<std::mutex> lk(s->mu);
  Stream& st = s->streams[stream_id];
  if (!st.shm.base) return -1;
  ::munmap(st.shm.base, st.shm.map_len);
  st.shm = ShmRing{};
  s->n_shm.fetch_sub(1);
  return 0;
}

void sd_stop(void* h) {
  auto* s = static_cast<Server*>(h);
  s->stopping.store(true);
  s->ready_cv.notify_all();
  if (s->io_thread.joinable()) s->io_thread.join();
  {
    std::lock_guard<std::mutex> lk(s->mu);
    for (auto& st : s->streams)
      if (st.shm.base) ::munmap(st.shm.base, st.shm.map_len);
  }
  ::close(s->listen_fd);
  ::close(s->epoll_fd);
  delete s;
}

}  // extern "C"
