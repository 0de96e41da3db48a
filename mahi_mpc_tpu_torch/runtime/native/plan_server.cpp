// Native real-time plan server for the MPC runtime (the port's own copy of
// mahi_mpc_tpu/runtime/native/plan_server.cpp).
//
// The equivalent of the reference's shared-state threading core
// (src/Mahi/Mpc/ModelControl.cpp:75-112,174-197): where the reference hands
// plans between the solver thread and the 1 kHz control thread through three
// mutexes, this is a seqlock-protected double buffer — the control thread's
// read path is wait-free (never blocks on the publisher, retries on a torn
// read), which is what a hard-real-time consumer actually needs.  The Python
// solver thread publishes plans; any real-time thread (C, C++, or Python via
// ctypes) samples controls with zero-order hold (ModelControl.cpp:192-197).
//
// Also provides a monotonic deadline pacer (the reference's mahi::util Timer,
// thread_model_control_example.cpp:70-71,108) with jitter accounting.
//
// Built by mahi_mpc_tpu_torch/_build.py host_build (g++ -std=c++17 -O2
// -shared -fPIC -pthread) into mahi_mpc_tpu_torch/_build/.

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct PlanBuffer {
  int nx = 0, nu = 0, N = 0;
  std::atomic<uint64_t> seq{0};  // even: stable; odd: write in progress
  std::atomic<uint64_t> published{0};
  // times: N+1, X: (N+1)*nx, U: N*nu, packed contiguously per slot.
  std::vector<double> data;

  size_t slot_len() const {
    return static_cast<size_t>(N + 1) + static_cast<size_t>(N + 1) * nx +
           static_cast<size_t>(N) * nu;
  }
};

struct Pacer {
  std::chrono::steady_clock::time_point t0;
  double period_s = 0.001;
  uint64_t tick = 0;
  uint64_t misses = 0;
  double worst_late_s = 0.0;
};

double now_monotonic() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

}  // namespace

extern "C" {

void* plan_server_create(int nx, int nu, int N) {
  auto* pb = new PlanBuffer();
  pb->nx = nx;
  pb->nu = nu;
  pb->N = N;
  pb->data.assign(pb->slot_len(), 0.0);
  return pb;
}

void plan_server_destroy(void* h) { delete static_cast<PlanBuffer*>(h); }

// Publisher side (solver thread). times: N+1, X: (N+1)*nx row-major,
// U: N*nu row-major.
void plan_server_publish(void* h, const double* times, const double* X,
                         const double* U) {
  auto* pb = static_cast<PlanBuffer*>(h);
  const uint64_t s = pb->seq.load(std::memory_order_relaxed);
  pb->seq.store(s + 1, std::memory_order_release);  // mark write
  double* d = pb->data.data();
  const int N = pb->N;
  std::memcpy(d, times, sizeof(double) * (N + 1));
  std::memcpy(d + (N + 1), X, sizeof(double) * (N + 1) * pb->nx);
  std::memcpy(d + (N + 1) + (N + 1) * pb->nx, U, sizeof(double) * N * pb->nu);
  pb->seq.store(s + 2, std::memory_order_release);  // stable
  pb->published.fetch_add(1, std::memory_order_relaxed);
}

// Consumer side (control thread): wait-free seqlock read + ZOH lookup.
// Returns 0 on success, -1 if no plan has been published yet.
int plan_server_sample(void* h, double t, double* u_out) {
  auto* pb = static_cast<PlanBuffer*>(h);
  if (pb->published.load(std::memory_order_relaxed) == 0) return -1;
  const int N = pb->N, nu = pb->nu, nx = pb->nx;
  // No heap allocation on the RT path; nu beyond the stack buffer falls
  // back to sampling directly into u_out (still correct, one extra retry
  // copy risk only on torn reads).
  double stack_u[64];
  double* u = (nu <= 64) ? stack_u : u_out;
  for (;;) {
    const uint64_t s1 = pb->seq.load(std::memory_order_acquire);
    if (s1 & 1) continue;  // write in progress
    const double* times = pb->data.data();
    const double* U = pb->data.data() + (N + 1) + (N + 1) * nx;
    // ZOH: last node with time <= t, clamped (ModelControl.cpp:192-197).
    int k = 0;
    while (k + 1 < N && times[k + 1] <= t) ++k;
    for (int i = 0; i < nu; ++i) u[i] = U[k * nu + i];
    std::atomic_thread_fence(std::memory_order_acquire);
    const uint64_t s2 = pb->seq.load(std::memory_order_relaxed);
    if (s1 == s2) break;  // consistent snapshot
  }
  if (u != u_out) std::memcpy(u_out, u, sizeof(double) * nu);
  return 0;
}

uint64_t plan_server_published(void* h) {
  return static_cast<PlanBuffer*>(h)->published.load(std::memory_order_relaxed);
}

// ---- deadline pacer ------------------------------------------------------

void* pacer_create(double period_s) {
  auto* p = new Pacer();
  p->period_s = period_s;
  p->t0 = std::chrono::steady_clock::now();
  return p;
}

void pacer_destroy(void* h) { delete static_cast<Pacer*>(h); }

// Sleep until the next tick deadline; spin for the last slice for accuracy.
// Returns lateness in seconds (0 when on time).
double pacer_wait(void* h) {
  auto* p = static_cast<Pacer*>(h);
  p->tick += 1;
  const auto deadline =
      p->t0 + std::chrono::duration_cast<std::chrono::steady_clock::duration>(
                  std::chrono::duration<double>(p->tick * p->period_s));
  auto now = std::chrono::steady_clock::now();
  if (now < deadline) {
    const auto spin_slice = std::chrono::microseconds(150);
    if (deadline - now > spin_slice) {
      std::this_thread::sleep_for(deadline - now - spin_slice);
    }
    while (std::chrono::steady_clock::now() < deadline) {
    }
    return 0.0;
  }
  const double late = std::chrono::duration<double>(now - deadline).count();
  p->misses += 1;
  if (late > p->worst_late_s) p->worst_late_s = late;
  return late;
}

uint64_t pacer_misses(void* h) { return static_cast<Pacer*>(h)->misses; }
double pacer_worst_late(void* h) {
  return static_cast<Pacer*>(h)->worst_late_s;
}
double monotonic_now() { return now_monotonic(); }

}  // extern "C"
