/* prof_hook.h — the profile plane's per-event fast path, as true
 * inlines for in-tree callers (libvtpu.c's intercept wrappers, the
 * region primitives, the native benches).
 *
 * The v7 hot-path rebuild cut the shim charge pair to a few hundred ns,
 * so the <=1% profiling budget (tests/test_shim_profile.py) prices the
 * whole enter+note sequence at ~1 ns per event. Two out-of-line calls
 * per event — what the exported vtpu_prof_enter/vtpu_prof_note pair
 * costs — already spend most of that budget on call overhead alone, so
 * the hot-path callers inline the count-only path and fall out of line
 * only for the genuinely cold pieces (env init, the 1-in-N sampled
 * tick, the batch drain).
 *
 * This header is an INTERNAL contract between the lib/vtpu TUs: the
 * public ABI stays shared_region.h (the exported wrappers remain for
 * ctypes and out-of-tree callers; VTPU006 diffs only shared_region.h
 * against the Python mirror).
 */
#ifndef VTPU_PROF_HOOK_H
#define VTPU_PROF_HOOK_H

#include "shared_region.h"

#ifdef __cplusplus
extern "C" {
#endif

/* sampled ticks between batch drains: draining on EVERY sampled event
 * (~25 ns of shared-memory RMWs) priced the hook out of the v7 <=1%
 * budget. The counters' staleness bound becomes one heartbeat + 16
 * sample periods — the 5 s heartbeat flush dominates either way
 * (docs/shim-profiling.md). */
#define VTPU_PROF_FLUSH_EVERY 16

typedef struct {
  vtpu_shared_region_t *r; /* flush target of the pending batch */
  uint32_t tick;           /* events since the last sampled one */
  uint32_t since_flush;    /* sampled ticks since the last batch drain */
  /* sampled latencies park here too: one (callsite, bucket) byte pair
   * per sampled tick, drained with the counter rows so a sampled event
   * costs TLS stores, not shared-memory RMWs */
  uint8_t pend_cs[VTPU_PROF_FLUSH_EVERY];
  uint8_t pend_bucket[VTPU_PROF_FLUSH_EVERY];
  struct {
    uint64_t calls, errors, bytes, sampled, total_ns;
  } acc[VTPU_PROF_CALLSITES];
} vtpu_prof_tls_t;

/* enabled+sample folded into ONE word so the per-event fast path pays a
 * single relaxed load: -1 = env not read yet, 0 = disabled, N >= 1 =
 * sample period. Defined in shared_region.c. */
extern int vtpu_prof_state;

/* initial-exec TLS: in a dlopen'd .so the default (general-dynamic)
 * model pays a __tls_get_addr CALL per access, which alone would blow
 * the <=1% budget; IE is one fs-relative mov. The struct is ~370 B,
 * comfortably inside glibc's static-TLS surplus. */
extern __thread vtpu_prof_tls_t vtpu_prof_tls
    __attribute__((tls_model("initial-exec")));

/* cold paths (shared_region.c) */
void vtpu_prof_lazy_init(void);  /* reads VTPU_PROFILE{,_SAMPLE} once */
int64_t vtpu_prof_now_ns(void);  /* TSC on x86-64, clock_gettime else */
void vtpu_prof_note_sampled(vtpu_shared_region_t *r, int cs, int64_t t0,
                            int64_t exclude_ns);

/* Fast twins of vtpu_prof_enter/vtpu_prof_note. Identical contract
 * (shared_region.h "profiling hooks"); the exported symbols are thin
 * wrappers around these. */
static inline int64_t vtpu_prof_enter_fast(void) {
  int st = __atomic_load_n(&vtpu_prof_state, __ATOMIC_RELAXED);
  if (__builtin_expect(st <= 0, 0)) {
    if (st == 0) return -1;
    vtpu_prof_lazy_init();
    st = __atomic_load_n(&vtpu_prof_state, __ATOMIC_RELAXED);
    if (st <= 0) return -1;
  }
  vtpu_prof_tls_t *t = &vtpu_prof_tls;
  if (__builtin_expect(++t->tick < (uint32_t)st, 1)) return 0;
  t->tick = 0;
  return vtpu_prof_now_ns();
}

static inline void vtpu_prof_note_fast(vtpu_shared_region_t *r, int cs,
                                       int64_t t0, int64_t exclude_ns,
                                       uint64_t bytes, int err) {
  if (t0 < 0 || !r || (unsigned)cs >= VTPU_PROF_CALLSITES) return;
  vtpu_prof_tls_t *t = &vtpu_prof_tls;
  if (__builtin_expect(t->r != r, 0)) {
    vtpu_prof_flush(t->r); /* region switch (no-op on an empty batch) */
    t->r = r;
  }
  /* branchless accumulate: the unconditional adds cost less than the
   * branches they replace on this sub-ns-budget path */
  t->acc[cs].calls++;
  t->acc[cs].bytes += bytes;
  t->acc[cs].errors += (uint64_t)(err != 0);
  if (__builtin_expect(t0 > 0, 0))
    vtpu_prof_note_sampled(r, cs, t0, exclude_ns);
}

#ifdef __cplusplus
}
#endif

#endif /* VTPU_PROF_HOOK_H */
