// Phase totals, counts and spans of the native finalize, for the port's
// tracer (bwa_tpu_torch/tracing.py, which keeps this header's enums in
// the same order).  Per thread and off until the calling thread switches
// it on (bt_trace_begin in memfin.cpp); off, a site tests one flag and
// reads no clock.  Stamps are CLOCK_MONOTONIC (Python's perf_counter_ns)
// and the thread's CPU clock, in ns.
#pragma once

#include <cstdint>
#include <ctime>

namespace bt_trace {

enum Phase { CHAIN, EXTEND, RESCUE, PAIR, SAM, N_PHASES };
enum Count { EXTENSIONS, RESCUE_TRIES, RESCUE_HITS, CIGARS, N_COUNTS };
enum SpanId { FIN_REGIONS, FIN_PESTAT, FIN_PAIRS };
constexpr int MAX_SPANS = 16;

struct State {
  bool on = false;
  int64_t phase_ns[N_PHASES] = {};
  int64_t count[N_COUNTS] = {};
  int32_t n_spans = 0;
  int64_t spans[MAX_SPANS][5] = {};  // id, start, end, cpu start, cpu end
};

inline State &state() {
  static thread_local State s;
  return s;
}

inline int64_t clock_ns(clockid_t c) {
  timespec ts;
  clock_gettime(c, &ts);
  return (int64_t)ts.tv_sec * 1000000000 + ts.tv_nsec;
}

inline bool on() { return state().on; }

inline void count(Count c, int64_t n = 1) {
  State &s = state();
  if (s.on) s.count[c] += n;
}

// Splits one read's (or pair's) work into phases: to(p) adds the time
// since the last mark to phase p.  `on` is read once, by the caller.
class Lap {
 public:
  explicit Lap(bool on) : on_(on), t_(on ? clock_ns(CLOCK_MONOTONIC) : 0) {}
  void to(Phase p) {
    if (!on_) return;
    int64_t t = clock_ns(CLOCK_MONOTONIC);
    state().phase_ns[p] += t - t_;
    t_ = t;
  }

 private:
  bool on_;
  int64_t t_;
};

// A span from its construction to end() or the end of its scope.
class Span {
 public:
  explicit Span(SpanId id) {
    State &s = state();
    if (!s.on || s.n_spans >= MAX_SPANS) return;
    i_ = s.n_spans++;
    int64_t *r = s.spans[i_];
    r[0] = id;
    r[1] = clock_ns(CLOCK_MONOTONIC);
    r[3] = clock_ns(CLOCK_THREAD_CPUTIME_ID);
  }
  ~Span() { end(); }
  void end() {
    if (i_ < 0) return;
    int64_t *r = state().spans[i_];
    r[2] = clock_ns(CLOCK_MONOTONIC);
    r[4] = clock_ns(CLOCK_THREAD_CPUTIME_ID);
    i_ = -1;
  }
  Span(const Span &) = delete;
  Span &operator=(const Span &) = delete;

 private:
  int i_ = -1;
};

}  // namespace bt_trace
