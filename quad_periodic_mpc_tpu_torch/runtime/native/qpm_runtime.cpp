/* qpm_runtime implementation — see qpm_runtime.h. */

#include "qpm_runtime.h"

#include <atomic>
#include <cerrno>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <thread>

#include <arpa/inet.h>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <unistd.h>

/* ================= seqlock shared-memory ring ================= */

namespace {

struct RingHeader {
  uint32_t magic;
  uint32_t frame_bytes;
  uint32_t slots;
  uint32_t pad;
  std::atomic<uint64_t> seq;   /* monotonically increasing publish count */
};

constexpr uint32_t kMagic = 0x51504d52; /* "QPMR" */

struct SlotHeader {
  std::atomic<uint64_t> seq;   /* odd while being written (seqlock) */
};

}  // namespace

struct qpm_ring {
  RingHeader* hdr;
  uint8_t* base;
  size_t map_bytes;
  char name[64];
  uint32_t slot_stride;
};

static size_t ring_bytes(uint32_t frame_bytes, uint32_t slots,
                         uint32_t* stride_out) {
  uint32_t stride =
      (uint32_t)((sizeof(SlotHeader) + frame_bytes + 63) / 64 * 64);
  *stride_out = stride;
  return sizeof(RingHeader) + (size_t)stride * slots;
}

qpm_ring* qpm_ring_open(const char* name, uint32_t frame_bytes,
                        uint32_t slots, int create) {
  if (!name || frame_bytes == 0 || slots == 0) return nullptr;
  uint32_t stride = 0;
  size_t bytes = ring_bytes(frame_bytes, slots, &stride);

  int flags = O_RDWR | (create ? O_CREAT : 0);
  int fd = shm_open(name, flags, 0600);
  if (fd < 0) return nullptr;
  if (create && ftruncate(fd, (off_t)bytes) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;

  auto* r = new qpm_ring();
  r->hdr = (RingHeader*)mem;
  r->base = (uint8_t*)mem + sizeof(RingHeader);
  r->map_bytes = bytes;
  r->slot_stride = stride;
  snprintf(r->name, sizeof(r->name), "%s", name);

  if (create) {
    r->hdr->magic = kMagic;
    r->hdr->frame_bytes = frame_bytes;
    r->hdr->slots = slots;
    r->hdr->seq.store(0, std::memory_order_release);
    for (uint32_t i = 0; i < slots; i++) {
      auto* sh = (SlotHeader*)(r->base + (size_t)i * stride);
      sh->seq.store(0, std::memory_order_release);
    }
  } else if (r->hdr->magic != kMagic || r->hdr->frame_bytes != frame_bytes ||
             r->hdr->slots != slots) {
    munmap(mem, bytes);
    delete r;
    return nullptr;
  }
  return r;
}

void qpm_ring_close(qpm_ring* r, int unlink_shm) {
  if (!r) return;
  munmap(r->hdr, r->map_bytes);
  if (unlink_shm) shm_unlink(r->name);
  delete r;
}

uint64_t qpm_ring_write(qpm_ring* r, const void* data, uint32_t len) {
  if (!r || len > r->hdr->frame_bytes) return 0;
  uint64_t seq = r->hdr->seq.load(std::memory_order_relaxed) + 1;
  uint32_t slot = (uint32_t)(seq % r->hdr->slots);
  auto* sh = (SlotHeader*)(r->base + (size_t)slot * r->slot_stride);
  uint8_t* payload = (uint8_t*)(sh + 1);

  sh->seq.store(2 * seq - 1, std::memory_order_release); /* odd: writing */
  std::atomic_thread_fence(std::memory_order_release);
  memcpy(payload, data, len);
  std::atomic_thread_fence(std::memory_order_release);
  sh->seq.store(2 * seq, std::memory_order_release);     /* even: done */
  r->hdr->seq.store(seq, std::memory_order_release);
  return seq;
}

int64_t qpm_ring_read_latest(qpm_ring* r, void* out, uint32_t len) {
  if (!r || len > r->hdr->frame_bytes) return -1;
  for (int attempt = 0; attempt < 64; attempt++) {
    uint64_t seq = r->hdr->seq.load(std::memory_order_acquire);
    if (seq == 0) return 0;
    uint32_t slot = (uint32_t)(seq % r->hdr->slots);
    auto* sh = (SlotHeader*)(r->base + (size_t)slot * r->slot_stride);
    uint64_t s1 = sh->seq.load(std::memory_order_acquire);
    if (s1 != 2 * seq) continue; /* writer moved on / in progress */
    memcpy(out, (const uint8_t*)(sh + 1), len);
    std::atomic_thread_fence(std::memory_order_acquire);
    uint64_t s2 = sh->seq.load(std::memory_order_acquire);
    if (s1 == s2) return (int64_t)seq;
  }
  return -1;
}

/* ================= periodic loop ================= */

struct qpm_loop {
  uint64_t period_ns;
  qpm_loop_cb cb;
  void* user;
  std::thread thread;
  std::atomic<bool> running{false};
  std::atomic<uint64_t> iterations{0};
  std::atomic<uint64_t> overruns{0};
  std::atomic<uint64_t> max_jitter_ns{0};
};

static inline uint64_t ts_to_ns(const timespec& ts) {
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

qpm_loop* qpm_loop_create(uint64_t period_ns, qpm_loop_cb cb, void* user) {
  auto* l = new qpm_loop();
  l->period_ns = period_ns;
  l->cb = cb;
  l->user = user;
  return l;
}

int qpm_loop_start(qpm_loop* l) {
  if (!l || l->running.load()) return -1;
  l->running.store(true);
  l->thread = std::thread([l]() {
    timespec next;
    clock_gettime(CLOCK_MONOTONIC, &next);
    while (l->running.load(std::memory_order_relaxed)) {
      /* absolute next deadline (LoopFunc-style fixed cadence) */
      next.tv_nsec += (long)(l->period_ns % 1000000000ull);
      next.tv_sec += (time_t)(l->period_ns / 1000000000ull);
      if (next.tv_nsec >= 1000000000L) {
        next.tv_nsec -= 1000000000L;
        next.tv_sec += 1;
      }
      clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &next, nullptr);

      timespec now;
      clock_gettime(CLOCK_MONOTONIC, &now);
      uint64_t lateness = ts_to_ns(now) - ts_to_ns(next);
      uint64_t prev = l->max_jitter_ns.load(std::memory_order_relaxed);
      while (lateness > prev && !l->max_jitter_ns.compare_exchange_weak(
                                    prev, lateness)) {
      }
      if (lateness > l->period_ns) {
        l->overruns.fetch_add(1, std::memory_order_relaxed);
        /* resync deadline after a gross overrun */
        next = now;
      }

      uint64_t it = l->iterations.fetch_add(1, std::memory_order_relaxed);
      if (l->cb) l->cb(l->user, it);
    }
  });
  return 0;
}

void qpm_loop_stop(qpm_loop* l) {
  if (!l) return;
  bool was = l->running.exchange(false);
  if (was && l->thread.joinable()) l->thread.join();
}

void qpm_loop_destroy(qpm_loop* l) {
  if (!l) return;
  qpm_loop_stop(l);
  delete l;
}

uint64_t qpm_loop_iterations(const qpm_loop* l) {
  return l ? l->iterations.load() : 0;
}
uint64_t qpm_loop_overruns(const qpm_loop* l) {
  return l ? l->overruns.load() : 0;
}
uint64_t qpm_loop_max_jitter_ns(const qpm_loop* l) {
  return l ? l->max_jitter_ns.load() : 0;
}

/* ================= UDP bridge ================= */

struct qpm_udp {
  int fd;
  sockaddr_in remote;
};

qpm_udp* qpm_udp_open(const char* local_ip, uint16_t local_port,
                      const char* remote_ip, uint16_t remote_port) {
  int fd = socket(AF_INET, SOCK_DGRAM | SOCK_NONBLOCK, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));

  sockaddr_in local{};
  local.sin_family = AF_INET;
  local.sin_port = htons(local_port);
  local.sin_addr.s_addr =
      local_ip ? inet_addr(local_ip) : htonl(INADDR_ANY);
  if (bind(fd, (sockaddr*)&local, sizeof(local)) != 0) {
    close(fd);
    return nullptr;
  }
  auto* u = new qpm_udp();
  u->fd = fd;
  u->remote = {};
  u->remote.sin_family = AF_INET;
  u->remote.sin_port = htons(remote_port);
  u->remote.sin_addr.s_addr = inet_addr(remote_ip ? remote_ip : "127.0.0.1");
  return u;
}

void qpm_udp_close(qpm_udp* u) {
  if (!u) return;
  close(u->fd);
  delete u;
}

int qpm_udp_send(qpm_udp* u, const void* buf, uint32_t len) {
  if (!u) return -EINVAL;
  ssize_t n = sendto(u->fd, buf, len, 0, (sockaddr*)&u->remote,
                     sizeof(u->remote));
  return n >= 0 ? (int)n : -errno;
}

int qpm_udp_recv_latest(qpm_udp* u, void* buf, uint32_t len) {
  if (!u) return -EINVAL;
  int got = 0;
  for (;;) {
    ssize_t n = recv(u->fd, buf, len, 0);
    if (n < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) return got;
      return got > 0 ? got : -errno;
    }
    got = (int)n;  /* keep draining; newest wins */
  }
}

/* ================= safety ================= */

int qpm_safety_clamp_torques(double* tau, const double* limits3) {
  int clamped = 0;
  for (int leg = 0; leg < 4; leg++) {
    for (int j = 0; j < 3; j++) {
      double lim = limits3[j];
      double* t = &tau[leg * 3 + j];
      if (*t > lim) {
        *t = lim;
        clamped++;
      } else if (*t < -lim) {
        *t = -lim;
        clamped++;
      }
    }
  }
  return clamped;
}

int qpm_safety_power_protect(double* tau, const double* qd,
                             double budget_watts) {
  double power = 0;
  for (int i = 0; i < 12; i++) {
    double p = tau[i] * qd[i];
    if (p > 0) power += p;
  }
  if (power <= budget_watts || power <= 0) return 0;
  double scale = budget_watts / power;
  for (int i = 0; i < 12; i++) tau[i] *= scale;
  return 1;
}

int qpm_safety_position_limit(double* q, const double* qmin3,
                              const double* qmax3) {
  int clamped = 0;
  for (int leg = 0; leg < 4; leg++) {
    for (int j = 0; j < 3; j++) {
      double* v = &q[leg * 3 + j];
      if (*v > qmax3[j]) {
        *v = qmax3[j];
        clamped++;
      } else if (*v < qmin3[j]) {
        *v = qmin3[j];
        clamped++;
      }
    }
  }
  return clamped;
}

int qpm_safety_position_protect(double* q_cmd, const double* q_now,
                                double limit_rad) {
  int clamped = 0;
  for (int i = 0; i < 12; i++) {
    double lo = q_now[i] - limit_rad;
    double hi = q_now[i] + limit_rad;
    if (q_cmd[i] > hi) {
      q_cmd[i] = hi;
      clamped++;
    } else if (q_cmd[i] < lo) {
      q_cmd[i] = lo;
      clamped++;
    }
  }
  return clamped;
}
