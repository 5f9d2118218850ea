/* qpm_runtime — native host runtime for the TPU convex-MPC engine.
 *
 * C ABI (consumed from Python via ctypes).  Rebuilds, TPU-host-style, the
 * reference's native runtime tier:
 *  - seqlock shared-memory state ring  (SharedMemory.h analog)
 *  - absolute-deadline periodic loop with jitter/overrun accounting
 *    (unitree_legged_sdk LoopFunc / PeriodicTask.h analog)
 *  - nonblocking UDP bridge for robot low-level command/state packets
 *    (unitree_legged_sdk udp.h analog)
 *  - torque clamp + power-protect safety filter
 *    (Safety::PowerProtect, be2r_cmpc_unitree.cpp:486-492 call site)
 */
#ifndef QPM_RUNTIME_H
#define QPM_RUNTIME_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---------- seqlock shared-memory ring ---------- */

typedef struct qpm_ring qpm_ring;

/* Create (or open, if create == 0) a POSIX shared-memory ring holding
 * `slots` frames of `frame_bytes` each.  Returns NULL on failure. */
qpm_ring* qpm_ring_open(const char* name, uint32_t frame_bytes,
                        uint32_t slots, int create);
void qpm_ring_close(qpm_ring* r, int unlink_shm);

/* Publish one frame; lock-free single-writer. Returns sequence number. */
uint64_t qpm_ring_write(qpm_ring* r, const void* data, uint32_t len);

/* Read the latest consistent frame (seqlock retry). Returns sequence
 * number, 0 if nothing published yet; -1 on torn-read failure. */
int64_t qpm_ring_read_latest(qpm_ring* r, void* out, uint32_t len);

/* ---------- periodic loop ---------- */

typedef struct qpm_loop qpm_loop;
typedef void (*qpm_loop_cb)(void* user, uint64_t iteration);

qpm_loop* qpm_loop_create(uint64_t period_ns, qpm_loop_cb cb, void* user);
int  qpm_loop_start(qpm_loop* l);
void qpm_loop_stop(qpm_loop* l);
void qpm_loop_destroy(qpm_loop* l);

uint64_t qpm_loop_iterations(const qpm_loop* l);
uint64_t qpm_loop_overruns(const qpm_loop* l);
/* worst observed wake-up lateness in ns (PeriodicTask::isSlow analog) */
uint64_t qpm_loop_max_jitter_ns(const qpm_loop* l);

/* ---------- UDP bridge ---------- */

typedef struct qpm_udp qpm_udp;

qpm_udp* qpm_udp_open(const char* local_ip, uint16_t local_port,
                      const char* remote_ip, uint16_t remote_port);
void qpm_udp_close(qpm_udp* u);
/* Returns bytes sent or -errno. */
int qpm_udp_send(qpm_udp* u, const void* buf, uint32_t len);
/* Nonblocking receive of the newest pending datagram (drains the queue).
 * Returns bytes received, 0 if none pending, or -errno. */
int qpm_udp_recv_latest(qpm_udp* u, void* buf, uint32_t len);

/* ---------- safety filter ---------- */

/* Clamp 12 joint torques in place to per-joint-type limits
 * (abad/hip/knee x 4 legs, layout [leg0 abad, hip, knee, leg1 ...]).
 * Returns the number of clamped entries. */
int qpm_safety_clamp_torques(double* tau, const double* limits3);

/* Power protect: scale all torques so that sum |tau_i * qd_i| stays
 * under budget_watts.  Returns 1 if scaling was applied. */
int qpm_safety_power_protect(double* tau, const double* qd,
                             double budget_watts);

/* Position limit: clamp 12 commanded joint positions in place to
 * per-joint-type [qmin3, qmax3] (Safety::PositionLimit analog,
 * unitree_legged_sdk safety.h:18).  Returns number clamped. */
int qpm_safety_position_limit(double* q, const double* qmin3,
                              const double* qmax3);

/* Position protect: clamp commanded positions to within limit_rad of
 * the measured positions (Safety::PositionProtect analog,
 * safety.h:22, default 0.087 rad = 5 deg).  Returns number clamped. */
int qpm_safety_position_protect(double* q_cmd, const double* q_now,
                                double limit_rad);

#ifdef __cplusplus
}
#endif
#endif /* QPM_RUNTIME_H */
