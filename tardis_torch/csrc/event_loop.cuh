// The lane loop that K1's classic instantiations and K7 share: a persistent
// grid whose lanes take packets from a device counter and run one event a
// loop iteration, and the lanes' runs of the bulk j / nu-bar estimators.
//
// A packet's life is a few to a few hundred events; with one thread a
// packet, a warp holds its slots until its longest packet ends and a block
// until its longest warp ends.  Here a lane whose packet ends takes the
// next id at once (take_slot, queue.cuh), so every resident lane walks a
// packet while the queue has work.  Every draw is keyed by the packet's
// id and event index, so a packet's trajectory does not depend on the
// lane that runs it.
#pragma once
#include <cstdint>

#include "queue.cuh"

namespace tardis {

// A lane's run of the bulk estimators: the terms of consecutive events in
// one shell, summed in registers (f64) and added to the block's shared sums
// when the shell changes and when the lane leaves the loop.  The sums change
// only in their order.
struct ShellRun {
  int shell = -1;
  double j = 0.0, nubar = 0.0;
};

__device__ __forceinline__ void shell_run_flush(ShellRun& run, double* sh_j,
                                                double* sh_nubar) {
  if (run.shell >= 0) {
    atomicAdd(&sh_j[run.shell], run.j);
    atomicAdd(&sh_nubar[run.shell], run.nubar);
  }
  run.shell = -1;
  run.j = 0.0;
  run.nubar = 0.0;
}

__device__ __forceinline__ void shell_run_add(ShellRun& run, int shell, float w_j,
                                              float w_nubar, double* sh_j,
                                              double* sh_nubar) {
  if (shell != run.shell) {
    shell_run_flush(run, sh_j, sh_nubar);
    run.shell = shell;
  }
  run.j += (double)w_j;
  run.nubar += (double)w_nubar;
}

// The lane loop over n_packets packet ids taken from ``taken`` (zeroed by
// the caller).  Walker provides:
//   int64_t ev               the index of the packet's next event;
//   void birth(int64_t pid)  the packet's state before its first event;
//   bool event()             one event; false when the packet died, its
//                            output row written;
//   void finish(int64_t n_ev, bool stopped)  what a packet writes when it
//                            leaves the lane (stopped: by the event cap);
//   void flush()             the lane's runs into the block's sums.
template <class Walker>
__device__ __forceinline__ void lane_loop(Walker& w, unsigned long long* taken,
                                          int64_t n_packets, int64_t max_events) {
  bool have = false;
  for (;;) {
    if (!have) {
      const unsigned long long id = take_slot(taken);
      if (id >= (unsigned long long)n_packets) break;
      w.birth((int64_t)id);
      have = true;
    }
    if (w.ev >= max_events) {
      w.finish(max_events, true);
      have = false;
      continue;
    }
    const bool alive = w.event();
    w.ev += 1;
    if (!alive) {
      w.finish(w.ev, false);
      have = false;
    }
  }
  w.flush();
}

}  // namespace tardis
