/* Shared-region implementation. See shared_region.h for the ABI contract.
 *
 * Concurrency design: a single process-shared robust mutex guards the whole
 * region (the reference uses a semaphore in sharedRegionT, cudevshr.go:38-47,
 * and a /tmp/vgpulock file lock for creation). Robustness matters: a process
 * killed mid-critical-section must not deadlock every sibling — with
 * PTHREAD_MUTEX_ROBUST the next locker gets EOWNERDEAD and recovers (the
 * reference had exactly this bug class: CHANGELOG.md:81 "fix vGPUmonitor
 * deadlock").
 */

#define _GNU_SOURCE
#include "shared_region.h"

#include "prof_hook.h"

#include <errno.h>
#include <fcntl.h>
#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/file.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

static int64_t now_ns(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000000000ll + ts.tv_nsec;
}

/* ---- cheap sampled-event timestamps -------------------------------------
 * The v7 rebuild cut the shim charge-path pair to a few hundred ns, so
 * the <=1% profiling budget prices even the SAMPLED tick in tens of ns
 * — two vDSO clock_gettimes (~50 ns) alone would blow it. On x86-64
 * the sampled spans use the invariant TSC instead (~6 ns for a pair of
 * reads) with a lazy two-point calibration against CLOCK_MONOTONIC:
 * until ~20 ms of TSC have been observed the spans fall back to
 * clock_gettime, then the ns-per-tick factor is fixed once (<<20
 * fixed-point; invariant TSC is constant-rate, so one calibration
 * holds). Non-x86 keeps clock_gettime. Only the sampled LATENCY path
 * uses this — heartbeats, slot stamps, at-limit accounting stay on
 * CLOCK_MONOTONIC. */
#if defined(__x86_64__)
#include <x86intrin.h>
static uint64_t g_tsc0, g_tsc_ns0; /* calibration anchor (relaxed) */
static uint64_t g_tsc_mult;        /* ns per tick << 20; 0 = not yet */

int64_t vtpu_prof_now_ns(void) {
  uint64_t mult = __atomic_load_n(&g_tsc_mult, __ATOMIC_RELAXED);
  uint64_t tsc = __rdtsc();
  if (__builtin_expect(mult != 0, 1)) {
    uint64_t t0 = __atomic_load_n(&g_tsc0, __ATOMIC_RELAXED);
    uint64_t n0 = __atomic_load_n(&g_tsc_ns0, __ATOMIC_RELAXED);
    /* 128-bit product: (tsc - t0) * mult overflows u64 ~4.9 h after
     * the anchor (mult ~= ns/tick << 20), which would lap the clock
     * backwards mid-span in exactly the long-running jobs this
     * observatory targets */
    return (int64_t)(n0 +
                     (uint64_t)(((unsigned __int128)(tsc - t0) * mult) >>
                                20));
  }
  int64_t ns = now_ns();
  uint64_t t0 = __atomic_load_n(&g_tsc0, __ATOMIC_RELAXED);
  if (t0 == 0) {
    /* first sampled tick: drop the anchor (racing writers agree to
     * within the race window — harmless for a rate estimate) */
    __atomic_store_n(&g_tsc_ns0, (uint64_t)ns, __ATOMIC_RELAXED);
    __atomic_store_n(&g_tsc0, tsc ? tsc : 1, __ATOMIC_RELAXED);
  } else if (tsc - t0 > (1ull << 22)) { /* ~1 ms at ~3 GHz: rate error
                                         * over the window is well under
                                         * a bucket width, and waiting
                                         * longer just means more
                                         * sampled ticks on the ~50 ns
                                         * clock_gettime fallback */
    uint64_t n0 = __atomic_load_n(&g_tsc_ns0, __ATOMIC_RELAXED);
    /* 128-bit numerator: a calibration window longer than ~4.9 h (an
     * idle worker's second-ever sampled tick) would otherwise shift
     * the high bits out and store a garbage rate forever */
    uint64_t m = (uint64_t)(((unsigned __int128)((uint64_t)ns - n0)
                             << 20) /
                            (tsc - t0));
    if (m) __atomic_store_n(&g_tsc_mult, m, __ATOMIC_RELAXED);
  }
  return ns;
}
#else
int64_t vtpu_prof_now_ns(void) { return now_ns(); }
#endif

/* ---- v6 hot-path profile plane ------------------------------------------
 *
 * Design constraints (ISSUE 9): zero syscalls (clock_gettime is vDSO),
 * zero locks, and a per-event cost small enough that profiling stays
 * <=1% of the charge-path microbench (`region_test profbench` measures
 * it; tests/test_shim_profile.py gates it). Counters therefore
 * accumulate in a plain thread-local batch (no atomics at all on the
 * count-only path) and are flushed into the shared region with relaxed
 * atomic adds only on sampled events / heartbeat / detach / explicit
 * flush. Relaxed is sufficient: every field is an independent monotonic
 * u64 and readers already tolerate torn cross-field views (same
 * contract as the usage slots). */

/* The fast-path state and the enter/note inlines themselves live in
 * prof_hook.h (the v7 budget makes even the CALL into this TU real
 * money — libvtpu.c and the region primitives inline the count-only
 * path). This TU owns the definitions and every cold path. Mutated only
 * via configure/env-init and read with relaxed atomics (a relaxed load
 * compiles to a plain mov on x86-64 — free — while keeping the lazy
 * env-init race TSan-clean). */
int vtpu_prof_state = -1;

__thread vtpu_prof_tls_t vtpu_prof_tls
    __attribute__((tls_model("initial-exec")));

/* fork() duplicates the calling thread's TLS, batch included: without
 * this the child would eventually flush the parent's up-to-(sample-1)
 * pending events a second time, breaking the exact-counter invariant.
 * The atfork child handler runs in the (sole) surviving thread, so
 * clearing its own TLS discards exactly the inherited dirty copy. */
static void prof_atfork_child(void) {
  memset(&vtpu_prof_tls, 0, sizeof(vtpu_prof_tls));
}

static void prof_atfork_register(void) {
  static int registered; /* accessed only under the races below, which
                          * all lose harmlessly: double-register just
                          * clears twice */
  if (!__atomic_exchange_n(&registered, 1, __ATOMIC_RELAXED))
    pthread_atfork(NULL, NULL, prof_atfork_child);
}

static void prof_env_init(void) {
  const char *e = getenv("VTPU_PROFILE");
  int enabled = !e || atoi(e) != 0; /* default ON */
  const char *s = getenv("VTPU_PROFILE_SAMPLE");
  int sample = s ? atoi(s) : VTPU_PROF_SAMPLE_DEFAULT;
  if (sample < 1) sample = 1;
  if (enabled) prof_atfork_register();
  __atomic_store_n(&vtpu_prof_state, enabled ? sample : 0, __ATOMIC_RELAXED);
}

void vtpu_prof_configure(int enabled, int sample_every) {
  if (sample_every < 1) sample_every = 1;
  if (enabled) prof_atfork_register();
  __atomic_store_n(&vtpu_prof_state, enabled ? sample_every : 0,
                   __ATOMIC_RELAXED);
}

int vtpu_prof_enabled(void) {
  int st = __atomic_load_n(&vtpu_prof_state, __ATOMIC_RELAXED);
  if (st < 0) {
    prof_env_init();
    st = __atomic_load_n(&vtpu_prof_state, __ATOMIC_RELAXED);
  }
  return st > 0;
}

int vtpu_prof_bucket_index(uint64_t ns) {
  uint64_t v = ns >> VTPU_PROF_BUCKET_MIN_SHIFT;
  if (!v) return 0;
  int b = 64 - __builtin_clzll(v); /* ns in [2^(SHIFT+b-1), 2^(SHIFT+b)) */
  return b >= VTPU_PROF_BUCKETS ? VTPU_PROF_BUCKETS - 1 : b;
}

#define PROF_ADD(field, delta)                                          \
  __atomic_fetch_add(&(field), (uint64_t)(delta), __ATOMIC_RELAXED)

int vtpu_prof_flush(vtpu_shared_region_t *r) {
  vtpu_prof_tls_t *t = &vtpu_prof_tls;
  /* the batch always drains into the region it was accumulated against
   * (t->r); the argument is only a fallback for callers flushing a
   * batch noted before any region existed (not possible today). No
   * dirty flag: the note fast path must not pay a store for it, and
   * scanning 8 idle accumulator rows here is nothing on this cold
   * path (flush runs on sampled events / heartbeat / detach only). */
  if (t->r) r = t->r;
  if (!r) return 0;
  int flushed = 0;
  for (uint32_t i = 0; i < t->since_flush; i++)
    PROF_ADD(r->prof_cs[t->pend_cs[i]].hist[t->pend_bucket[i]], 1);
  t->since_flush = 0;
  for (int cs = 0; cs < VTPU_PROF_CALLSITES; cs++) {
    if (!t->acc[cs].calls && !t->acc[cs].errors && !t->acc[cs].bytes &&
        !t->acc[cs].sampled)
      continue;
    vtpu_prof_callsite_t *c = &r->prof_cs[cs];
    if (t->acc[cs].calls) PROF_ADD(c->calls, t->acc[cs].calls);
    if (t->acc[cs].errors) PROF_ADD(c->errors, t->acc[cs].errors);
    if (t->acc[cs].bytes) PROF_ADD(c->bytes, t->acc[cs].bytes);
    if (t->acc[cs].sampled) PROF_ADD(c->sampled, t->acc[cs].sampled);
    if (t->acc[cs].total_ns) PROF_ADD(c->total_ns, t->acc[cs].total_ns);
    t->acc[cs].calls = t->acc[cs].errors = t->acc[cs].bytes = 0;
    t->acc[cs].sampled = t->acc[cs].total_ns = 0;
    flushed++;
  }
  t->r = NULL;
  return flushed;
}

/* Cold half of the note fast path (prof_hook.h): the 1-in-N sampled
 * tick. Two TSC reads, TLS stores, and a batch drain every
 * VTPU_PROF_FLUSH_EVERY-th sampled tick. */
void vtpu_prof_note_sampled(vtpu_shared_region_t *r, int cs, int64_t t0,
                            int64_t exclude_ns) {
  vtpu_prof_tls_t *t = &vtpu_prof_tls;
  int64_t ns = vtpu_prof_now_ns() - t0 - exclude_ns;
  if (ns < 0) ns = 0;
  t->acc[cs].sampled++;
  t->acc[cs].total_ns += (uint64_t)ns;
  t->pend_cs[t->since_flush] = (uint8_t)cs;
  t->pend_bucket[t->since_flush] =
      (uint8_t)vtpu_prof_bucket_index((uint64_t)ns);
  if (__builtin_expect(++t->since_flush >= VTPU_PROF_FLUSH_EVERY, 0))
    vtpu_prof_flush(r); /* every 16th sampled tick drains the batch */
}

void vtpu_prof_lazy_init(void) { prof_env_init(); }

int64_t vtpu_prof_enter(void) { return vtpu_prof_enter_fast(); }

void vtpu_prof_note(vtpu_shared_region_t *r, int cs, int64_t t0,
                    int64_t exclude_ns, uint64_t bytes, int err) {
  vtpu_prof_note_fast(r, cs, t0, exclude_ns, bytes, err);
}

void vtpu_prof_pressure_add(vtpu_shared_region_t *r, int kind,
                            uint64_t delta) {
  if (!r || kind < 0 || kind >= VTPU_PROF_PRESSURE_KINDS || !delta) return;
  if (!vtpu_prof_enabled()) return;
  PROF_ADD(r->prof_pressure[kind], delta);
}

/* ---- v7 gate-plane maintenance (lock held) -------------------------------
 * The per-device aggregate and the usage epoch are written with relaxed
 * atomics because the launch gate reads them WITHOUT the lock; every
 * writer below is inside the region critical section, so the aggregate
 * equals the slot sum whenever the lock is quiescent. */

static inline void usage_agg_add(vtpu_shared_region_t *r, int dev,
                                 uint64_t bytes) {
  __atomic_fetch_add(&r->hbm_used_agg[dev], bytes, __ATOMIC_RELAXED);
}

static inline void usage_agg_sub(vtpu_shared_region_t *r, int dev,
                                 uint64_t bytes) {
  __atomic_fetch_sub(&r->hbm_used_agg[dev], bytes, __ATOMIC_RELAXED);
}

static inline void usage_epoch_bump(vtpu_shared_region_t *r) {
  __atomic_fetch_add(&r->usage_epoch, 1, __ATOMIC_RELAXED);
}

/* v8 host-ledger aggregate maintenance (lock held; same discipline as
 * the per-device aggregate above). */
static inline void host_agg_add(vtpu_shared_region_t *r, uint64_t bytes) {
  __atomic_fetch_add(&r->host_used_agg, bytes, __ATOMIC_RELAXED);
}

static inline void host_agg_sub(vtpu_shared_region_t *r, uint64_t bytes) {
  __atomic_fetch_sub(&r->host_used_agg, bytes, __ATOMIC_RELAXED);
}

/* Recompute the aggregates from the slot ground truth (robust-mutex
 * recovery: the dead owner may have updated a slot but not the
 * aggregate, or vice versa). Lock held. */
static void usage_agg_rebuild(vtpu_shared_region_t *r) {
  uint64_t agg[VTPU_MAX_DEVICES] = {0};
  uint64_t host = 0;
  for (int i = 0; i < VTPU_MAX_PROCS; i++) {
    if (!r->procs[i].status) continue;
    for (int d = 0; d < VTPU_MAX_DEVICES; d++)
      agg[d] += r->procs[i].hbm_used[d];
    host += r->procs[i].host_used;
  }
  for (int d = 0; d < VTPU_MAX_DEVICES; d++)
    __atomic_store_n(&r->hbm_used_agg[d], agg[d], __ATOMIC_RELAXED);
  __atomic_store_n(&r->host_used_agg, host, __ATOMIC_RELAXED);
  usage_epoch_bump(r);
}

/* Lock with robust-recovery. Returns 0 on success. */
static int region_lock(vtpu_shared_region_t *r) {
  int rc = pthread_mutex_lock(&r->lock);
  if (rc == EOWNERDEAD) {
    /* previous owner died holding the lock: state is per-slot counters,
     * consistent enough to mark recovered and continue — except the v7
     * aggregate, which may have missed the dead owner's half-finished
     * slot update; rebuild it from the slots */
    pthread_mutex_consistent(&r->lock);
    usage_agg_rebuild(r);
    rc = 0;
  }
  return rc;
}

static void region_unlock(vtpu_shared_region_t *r) {
  pthread_mutex_unlock(&r->lock);
}

/* FNV-1a over the static header fields (v5). Field-by-field (not one
 * offset range) so the digest is insensitive to padding bytes and the
 * Python mirror can reproduce it from its own ctypes field views. */
static uint64_t fnv1a(uint64_t h, const void *p, size_t n) {
  const unsigned char *b = (const unsigned char *)p;
  for (size_t i = 0; i < n; i++) {
    h ^= b[i];
    h *= (uint64_t)VTPU_HEADER_CSUM_PRIME;
  }
  return h;
}

uint64_t vtpu_region_header_checksum(const vtpu_shared_region_t *r) {
  uint64_t h = (uint64_t)VTPU_HEADER_CSUM_INIT;
  /* the magic in the digest is the CONSTANT, not the live field: init
   * stamps the checksum before the magic store becomes visible, and a
   * reader that can see the checksum (magic already set) must not fail
   * it on the publication ordering */
  uint32_t magic = VTPU_SHARED_MAGIC;
  h = fnv1a(h, &magic, sizeof(magic));
  h = fnv1a(h, &r->version, sizeof(r->version));
  h = fnv1a(h, &r->num_devices, sizeof(r->num_devices));
  h = fnv1a(h, &r->priority, sizeof(r->priority));
  h = fnv1a(h, r->hbm_limit, sizeof(r->hbm_limit));
  h = fnv1a(h, r->core_limit, sizeof(r->core_limit));
  h = fnv1a(h, &r->util_policy, sizeof(r->util_policy));
  h = fnv1a(h, r->dev_uuid, sizeof(r->dev_uuid));
  /* v8: the host limit is a static header field like hbm_limit —
   * appended LAST so the v5-v7 digest prefix order is unchanged */
  h = fnv1a(h, &r->host_limit, sizeof(r->host_limit));
  return h;
}

int vtpu_region_header_ok(const vtpu_shared_region_t *r) {
  if (!r) return 0;
  return r->header_checksum == vtpu_region_header_checksum(r);
}

void vtpu_region_header_restamp(vtpu_shared_region_t *r) {
  if (!r) return;
  if (region_lock(r)) return;
  r->header_checksum = vtpu_region_header_checksum(r);
  region_unlock(r);
}

static int init_region(vtpu_shared_region_t *r) {
  memset(r, 0, sizeof(*r));
  pthread_mutexattr_t at;
  if (pthread_mutexattr_init(&at)) return -1;
  pthread_mutexattr_setpshared(&at, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&at, PTHREAD_MUTEX_ROBUST);
  int rc = pthread_mutex_init(&r->lock, &at);
  pthread_mutexattr_destroy(&at);
  if (rc) return -1;
  r->owner_pid = (int32_t)getpid();
  r->version = VTPU_SHARED_VERSION;
  r->recent_kernel = VTPU_FEEDBACK_IDLE;
  r->header_heartbeat_ns = now_ns();
  /* checksum before magic: a reader gated on magic always sees a
   * stamped digest */
  r->header_checksum = vtpu_region_header_checksum(r);
  __atomic_store_n(&r->initialized, 1, __ATOMIC_RELEASE);
  /* magic last: readers (the monitor mmaps files it discovers mid-write,
   * pathmonitor.go:74-120 analog) treat magic as the validity gate */
  __atomic_store_n(&r->magic, VTPU_SHARED_MAGIC, __ATOMIC_RELEASE);
  return 0;
}

vtpu_shared_region_t *vtpu_region_open(const char *path) {
  int fd = open(path, O_RDWR | O_CREAT | O_CLOEXEC, 0666);
  if (fd < 0) return NULL;

  /* serialize first-time init among racing container processes */
  if (flock(fd, LOCK_EX) != 0) {
    close(fd);
    return NULL;
  }

  struct stat st;
  if (fstat(fd, &st) != 0) goto fail;
  int fresh = st.st_size < (off_t)sizeof(vtpu_shared_region_t);
  if (fresh && ftruncate(fd, sizeof(vtpu_shared_region_t)) != 0) goto fail;

  vtpu_shared_region_t *r =
      mmap(NULL, sizeof(vtpu_shared_region_t), PROT_READ | PROT_WRITE,
           MAP_SHARED, fd, 0);
  if (r == MAP_FAILED) goto fail;

  if (fresh || __atomic_load_n(&r->magic, __ATOMIC_ACQUIRE) !=
                   VTPU_SHARED_MAGIC) {
    if (init_region(r) != 0) {
      munmap(r, sizeof(*r));
      goto fail;
    }
  } else if (r->version != VTPU_SHARED_VERSION) {
    munmap(r, sizeof(*r));
    errno = EPROTO;
    goto fail;
  }

  flock(fd, LOCK_UN);
  close(fd); /* mapping survives the fd */
  return r;

fail:
  flock(fd, LOCK_UN);
  close(fd);
  return NULL;
}

void vtpu_region_close(vtpu_shared_region_t *r) {
  if (!r) return;
  /* the calling thread's pending profile batch must not outlive the
   * mapping: a dangling vtpu_prof_tls.r would be flushed into unmapped memory
   * by the next prof event against a DIFFERENT region (short-lived
   * open/close cycles — tests, vtpuprof, the monitor's C-digest path).
   * Other threads' batches are the embedder's problem; the shim closes
   * its region only at process exit. */
  if (vtpu_prof_tls.r == r) {
    vtpu_prof_flush(r);
    vtpu_prof_tls.r = NULL;
  }
  munmap(r, sizeof(*r));
}

int vtpu_region_configure(vtpu_shared_region_t *r, int num_devices,
                          const uint64_t *hbm_limit,
                          const uint32_t *core_limit, int priority,
                          int util_policy,
                          const char *const *dev_uuids) {
  if (!r || num_devices < 0 || num_devices > VTPU_MAX_DEVICES) {
    errno = EINVAL;
    return -1;
  }
  if (region_lock(r)) return -1;
  if (r->num_devices == 0 && num_devices > 0) { /* first writer wins */
    r->num_devices = num_devices;
    for (int i = 0; i < num_devices; i++) {
      r->hbm_limit[i] = hbm_limit ? hbm_limit[i] : 0;
      r->core_limit[i] = core_limit ? core_limit[i] : 0;
      if (dev_uuids && dev_uuids[i]) {
        strncpy(r->dev_uuid[i], dev_uuids[i], VTPU_UUID_LEN - 1);
        r->dev_uuid[i][VTPU_UUID_LEN - 1] = '\0';
      }
    }
    r->priority = priority;
    r->util_policy = util_policy;
    if (util_policy == VTPU_UTIL_POLICY_DISABLE)
      r->utilization_switch = 1;
    /* v6: record the configuring process's effective profile settings
     * so readers can label the data (dynamic fields, not checksummed) */
    {
      int st = vtpu_prof_enabled()
                   ? __atomic_load_n(&vtpu_prof_state, __ATOMIC_RELAXED)
                   : 0;
      r->prof_enabled = (uint32_t)(st > 0 ? 1 : 0);
      r->prof_sample = (uint32_t)(st > 0 ? st : 0);
    }
    /* static header fields just changed: restamp before unlocking so no
     * reader window sees new limits under the old digest */
    r->header_checksum = vtpu_region_header_checksum(r);
  }
  region_unlock(r);
  return 0;
}

static vtpu_proc_slot_t *find_slot(vtpu_shared_region_t *r, int32_t pid) {
  for (int i = 0; i < VTPU_MAX_PROCS; i++)
    if (r->procs[i].pid == pid && r->procs[i].status) return &r->procs[i];
  return NULL;
}

int vtpu_region_attach(vtpu_shared_region_t *r, int32_t pid) {
  if (!r) return -1;
  if (region_lock(r)) return -1;
  int idx = -1;
  vtpu_proc_slot_t *existing = find_slot(r, pid);
  if (existing) {
    idx = (int)(existing - r->procs);
  } else {
    for (int i = 0; i < VTPU_MAX_PROCS; i++) {
      if (!r->procs[i].status) {
        memset(&r->procs[i], 0, sizeof(r->procs[i]));
        r->procs[i].pid = pid;
        r->procs[i].status = 1;
        r->procs[i].last_seen_ns = now_ns();
        idx = i;
        break;
      }
    }
  }
  if (idx >= 0) r->header_heartbeat_ns = now_ns();
  region_unlock(r);
  return idx;
}

int vtpu_region_detach(vtpu_shared_region_t *r, int32_t pid) {
  if (!r) return -1;
  vtpu_prof_flush(r); /* don't lose the departing thread's batch */
  if (region_lock(r)) return -1;
  vtpu_proc_slot_t *s = find_slot(r, pid);
  if (s) {
    for (int d = 0; d < VTPU_MAX_DEVICES; d++)
      if (s->hbm_used[d]) usage_agg_sub(r, d, s->hbm_used[d]);
    if (s->host_used) host_agg_sub(r, s->host_used);
    memset(s, 0, sizeof(*s));
    usage_epoch_bump(r);
  }
  region_unlock(r);
  return s ? 0 : -1;
}

int vtpu_region_gc(vtpu_shared_region_t *r) {
  if (!r) return 0;
  int n = 0;
  if (region_lock(r)) return 0;
  for (int i = 0; i < VTPU_MAX_PROCS; i++) {
    vtpu_proc_slot_t *s = &r->procs[i];
    if (s->status && s->pid > 0 && kill(s->pid, 0) != 0 && errno == ESRCH) {
      for (int d = 0; d < VTPU_MAX_DEVICES; d++)
        if (s->hbm_used[d]) usage_agg_sub(r, d, s->hbm_used[d]);
      if (s->host_used) host_agg_sub(r, s->host_used);
      memset(s, 0, sizeof(*s));
      n++;
    }
  }
  if (n) usage_epoch_bump(r);
  region_unlock(r);
  return n;
}

int vtpu_try_alloc(vtpu_shared_region_t *r, int32_t pid, int dev,
                   uint64_t bytes) {
  if (!r || dev < 0 || dev >= VTPU_MAX_DEVICES) {
    errno = EINVAL;
    return -1;
  }
  int64_t pt = vtpu_prof_enter_fast();
  int rc = -1;
  int near_limit_fail = 0;
  if (region_lock(r)) return -1;
  uint64_t limit = r->hbm_limit[dev];
  /* v7: the aggregate IS the slot sum under the lock — O(1) instead of
   * the O(VTPU_MAX_PROCS) sweep that used to dominate this critical
   * section (shorter hold time = less charge-lock contention) */
  uint64_t used = __atomic_load_n(&r->hbm_used_agg[dev], __ATOMIC_RELAXED);
  if (limit == 0 || used + bytes <= limit) {
    vtpu_proc_slot_t *s = find_slot(r, pid);
    if (s) {
      s->hbm_used[dev] += bytes;
      usage_agg_add(r, dev, bytes);
      usage_epoch_bump(r);
      s->last_seen_ns = now_ns();
      rc = 0;
    } else {
      errno = ENOENT; /* caller must attach first */
    }
  } else {
    r->oom_events++;
    errno = ENOMEM;
    /* quota pressure: a rejection with usage already at >=7/8 of the
     * cap is the allocation-failure-near-limit signal */
    near_limit_fail = used >= limit - limit / 8;
  }
  region_unlock(r);
  int saved = errno;
  /* ENOENT (not attached yet) is a benign attach-and-retry, not a charge
   * error — only quota rejections count */
  vtpu_prof_note_fast(r, VTPU_PROF_CS_CHARGE, pt, 0, rc == 0 ? bytes : 0,
                 rc != 0 && saved != ENOENT);
  if (near_limit_fail)
    vtpu_prof_pressure_add(r, VTPU_PROF_PK_NEAR_LIMIT_FAILURES, 1);
  errno = saved; /* callers dispatch on ENOMEM/ENOENT */
  return rc;
}

void vtpu_force_alloc(vtpu_shared_region_t *r, int32_t pid, int dev,
                      uint64_t bytes) {
  if (!r || dev < 0 || dev >= VTPU_MAX_DEVICES) return;
  int64_t pt = vtpu_prof_enter_fast();
  if (region_lock(r)) return;
  vtpu_proc_slot_t *s = find_slot(r, pid);
  if (s) {
    s->hbm_used[dev] += bytes;
    usage_agg_add(r, dev, bytes);
    usage_epoch_bump(r);
    s->last_seen_ns = now_ns();
    if (r->hbm_limit[dev] &&
        __atomic_load_n(&r->hbm_used_agg[dev], __ATOMIC_RELAXED) >
            r->hbm_limit[dev])
      r->oom_events++;
  }
  region_unlock(r);
  vtpu_prof_note_fast(r, VTPU_PROF_CS_CHARGE, pt, 0, bytes, 0);
}

void vtpu_force_alloc_bulk(vtpu_shared_region_t *r, int32_t pid,
                           const uint64_t add[VTPU_MAX_DEVICES]) {
  if (!r) return;
  int64_t pt = vtpu_prof_enter_fast();
  uint64_t total = 0;
  if (region_lock(r)) return;
  vtpu_proc_slot_t *s = find_slot(r, pid);
  if (s) {
    for (int d = 0; d < VTPU_MAX_DEVICES; d++) {
      if (!add[d]) continue;
      s->hbm_used[d] += add[d];
      usage_agg_add(r, d, add[d]);
      total += add[d];
      if (r->hbm_limit[d] &&
          __atomic_load_n(&r->hbm_used_agg[d], __ATOMIC_RELAXED) >
              r->hbm_limit[d])
        r->oom_events++;
    }
    if (total) {
      usage_epoch_bump(r);
      s->last_seen_ns = now_ns();
    }
  }
  region_unlock(r);
  vtpu_prof_note_fast(r, VTPU_PROF_CS_CHARGE, pt, 0, total, 0);
}

void vtpu_free(vtpu_shared_region_t *r, int32_t pid, int dev,
               uint64_t bytes) {
  if (!r || dev < 0 || dev >= VTPU_MAX_DEVICES) return;
  int64_t pt = vtpu_prof_enter_fast();
  if (region_lock(r)) return;
  vtpu_proc_slot_t *s = find_slot(r, pid);
  if (s) {
    uint64_t delta = s->hbm_used[dev] >= bytes ? bytes : s->hbm_used[dev];
    s->hbm_used[dev] -= delta;
    if (delta) usage_agg_sub(r, dev, delta);
    usage_epoch_bump(r);
    s->last_seen_ns = now_ns();
  }
  region_unlock(r);
  vtpu_prof_note_fast(r, VTPU_PROF_CS_UNCHARGE, pt, 0, bytes, 0);
}

uint64_t vtpu_region_used(vtpu_shared_region_t *r, int dev) {
  if (!r || dev < 0 || dev >= VTPU_MAX_DEVICES) return 0;
  uint64_t used = 0;
  if (region_lock(r)) return 0;
  for (int i = 0; i < VTPU_MAX_PROCS; i++)
    if (r->procs[i].status) used += r->procs[i].hbm_used[dev];
  region_unlock(r);
  return used;
}

void vtpu_region_used_all(vtpu_shared_region_t *r,
                          uint64_t out[VTPU_MAX_DEVICES]) {
  memset(out, 0, VTPU_MAX_DEVICES * sizeof(uint64_t));
  if (!r) return;
  if (region_lock(r)) return;
  for (int i = 0; i < VTPU_MAX_PROCS; i++) {
    if (!r->procs[i].status) continue;
    for (int d = 0; d < VTPU_MAX_DEVICES; d++)
      out[d] += r->procs[i].hbm_used[d];
  }
  region_unlock(r);
}

int vtpu_region_set_limit_checked(vtpu_shared_region_t *r, int dev,
                                  uint64_t new_limit, uint64_t *applied) {
  if (!r || dev < 0 || dev >= VTPU_MAX_DEVICES) {
    errno = EINVAL;
    return -1;
  }
  if (region_lock(r)) return -1;
  /* exact under the lock: the aggregate is maintained inside every
   * usage critical section (v7) */
  uint64_t used = __atomic_load_n(&r->hbm_used_agg[dev], __ATOMIC_RELAXED);
  uint64_t eff = new_limit;
  int rc = 0;
  if (new_limit != 0 && used > new_limit) {
    /* shrink below live usage: clamp at the region layer — `used >
     * limit` must never be observable to the gate or the charge path */
    eff = used;
    rc = 1;
  }
  /* atomic store: the launch gate reads hbm_limit[] lock-free */
  __atomic_store_n(&r->hbm_limit[dev], eff, __ATOMIC_RELAXED);
  /* static header field changed: restamp inside the same critical
   * section so no reader window sees the new limit under the old digest */
  r->header_checksum = vtpu_region_header_checksum(r);
  /* invalidate every thread's epoch-cached gate snapshot: the new
   * limit is authoritative within one gate epoch (and a shrink lands
   * usage inside VTPU_GATE_MARGIN_PCT of it, forcing the locked exact
   * sweep on the next launch) */
  usage_epoch_bump(r);
  region_unlock(r);
  if (applied) *applied = eff;
  return rc;
}

/* ---- v8 host-memory ledger ----------------------------------------------
 * The cooperative-offload quota dimension (shared_region.h). These
 * functions are the ONLY writers of host_used / host_used_agg /
 * host_limit — vtpulint VTPU014 lexically gates every other TU. */

int vtpu_region_configure_host(vtpu_shared_region_t *r,
                               uint64_t host_limit) {
  if (!r) {
    errno = EINVAL;
    return -1;
  }
  if (region_lock(r)) return -1;
  if (r->host_limit == 0 && host_limit != 0) { /* first writer wins */
    r->host_limit = host_limit;
    /* static header field changed: restamp inside the critical section */
    r->header_checksum = vtpu_region_header_checksum(r);
  }
  region_unlock(r);
  return 0;
}

int vtpu_host_try_alloc(vtpu_shared_region_t *r, int32_t pid,
                        uint64_t bytes) {
  if (!r) {
    errno = EINVAL;
    return -1;
  }
  int64_t pt = vtpu_prof_enter_fast();
  int rc = -1;
  int near_limit_fail = 0;
  if (region_lock(r)) return -1;
  uint64_t limit = r->host_limit;
  uint64_t used = __atomic_load_n(&r->host_used_agg, __ATOMIC_RELAXED);
  if (limit == 0 || used + bytes <= limit) {
    vtpu_proc_slot_t *s = find_slot(r, pid);
    if (s) {
      s->host_used += bytes;
      host_agg_add(r, bytes);
      usage_epoch_bump(r);
      s->last_seen_ns = now_ns();
      rc = 0;
    } else {
      errno = ENOENT; /* caller must attach first */
    }
  } else {
    r->host_oom_events++;
    errno = ENOMEM;
    near_limit_fail = used >= limit - limit / 8;
  }
  region_unlock(r);
  int saved = errno;
  vtpu_prof_note_fast(r, VTPU_PROF_CS_CHARGE, pt, 0, rc == 0 ? bytes : 0,
                      rc != 0 && saved != ENOENT);
  if (near_limit_fail)
    vtpu_prof_pressure_add(r, VTPU_PROF_PK_HOST_NEAR_LIMIT_FAILURES, 1);
  errno = saved;
  return rc;
}

void vtpu_host_force_alloc(vtpu_shared_region_t *r, int32_t pid,
                           uint64_t bytes) {
  if (!r) return;
  int64_t pt = vtpu_prof_enter_fast();
  int over = 0;
  if (region_lock(r)) return;
  vtpu_proc_slot_t *s = find_slot(r, pid);
  if (s) {
    s->host_used += bytes;
    host_agg_add(r, bytes);
    usage_epoch_bump(r);
    s->last_seen_ns = now_ns();
    if (r->host_limit &&
        __atomic_load_n(&r->host_used_agg, __ATOMIC_RELAXED) >
            r->host_limit) {
      r->host_oom_events++;
      over = 1; /* the monitor's clamp/grace/block escalation signal */
    }
  }
  region_unlock(r);
  vtpu_prof_note_fast(r, VTPU_PROF_CS_CHARGE, pt, 0, bytes, 0);
  if (over) vtpu_prof_pressure_add(r, VTPU_PROF_PK_HOST_OVER_EVENTS, 1);
}

void vtpu_host_free(vtpu_shared_region_t *r, int32_t pid,
                    uint64_t bytes) {
  if (!r) return;
  int64_t pt = vtpu_prof_enter_fast();
  if (region_lock(r)) return;
  vtpu_proc_slot_t *s = find_slot(r, pid);
  if (s) {
    uint64_t delta = s->host_used >= bytes ? bytes : s->host_used;
    s->host_used -= delta;
    if (delta) host_agg_sub(r, delta);
    usage_epoch_bump(r);
    s->last_seen_ns = now_ns();
  }
  region_unlock(r);
  vtpu_prof_note_fast(r, VTPU_PROF_CS_UNCHARGE, pt, 0, bytes, 0);
}

uint64_t vtpu_region_host_used(vtpu_shared_region_t *r) {
  if (!r) return 0;
  uint64_t used = 0;
  if (region_lock(r)) return 0;
  for (int i = 0; i < VTPU_MAX_PROCS; i++)
    if (r->procs[i].status) used += r->procs[i].host_used;
  region_unlock(r);
  return used;
}

uint64_t vtpu_region_host_used_fast(vtpu_shared_region_t *r) {
  if (!r) return 0;
  return __atomic_load_n(&r->host_used_agg, __ATOMIC_RELAXED);
}

int vtpu_region_set_host_limit_checked(vtpu_shared_region_t *r,
                                       uint64_t new_limit,
                                       uint64_t *applied) {
  if (!r) {
    errno = EINVAL;
    return -1;
  }
  if (region_lock(r)) return -1;
  /* exact under the lock: the aggregate is maintained inside every
   * host-usage critical section */
  uint64_t used = __atomic_load_n(&r->host_used_agg, __ATOMIC_RELAXED);
  uint64_t eff = new_limit;
  int rc = 0;
  if (new_limit != 0 && used > new_limit) {
    /* shrink below live usage: clamp at the region layer — `used >
     * limit` must never be observable to the charge path */
    eff = used;
    rc = 1;
  }
  __atomic_store_n(&r->host_limit, eff, __ATOMIC_RELAXED);
  r->header_checksum = vtpu_region_header_checksum(r);
  usage_epoch_bump(r);
  region_unlock(r);
  if (applied) *applied = eff;
  return rc;
}

uint64_t vtpu_region_usage_epoch(vtpu_shared_region_t *r) {
  if (!r) return 0;
  return __atomic_load_n(&r->usage_epoch, __ATOMIC_RELAXED);
}

void vtpu_region_used_fast(vtpu_shared_region_t *r,
                           uint64_t out[VTPU_MAX_DEVICES]) {
  if (!r) {
    memset(out, 0, VTPU_MAX_DEVICES * sizeof(uint64_t));
    return;
  }
  for (int d = 0; d < VTPU_MAX_DEVICES; d++)
    out[d] = __atomic_load_n(&r->hbm_used_agg[d], __ATOMIC_RELAXED);
}

void vtpu_note_launch(vtpu_shared_region_t *r, int32_t pid, uint64_t est_ns) {
  if (!r) return;
  if (region_lock(r)) return;
  vtpu_proc_slot_t *s = find_slot(r, pid);
  if (s) {
    s->launches++;
    s->launch_ns += est_ns;
    s->inflight++;
    s->last_seen_ns = now_ns();
  }
  r->total_launches++;
  /* activity flag for the feedback loop: clamp at a small ceiling so a
   * long-lived workload can never wrap the counter through
   * VTPU_FEEDBACK_BLOCK (-1) and spuriously self-block (rates come from
   * total_launches, which nothing compares to the block sentinel).
   * Atomic store: the shim's launch throttle reads this field lock-free
   * (still serialized among writers by the region lock). */
  int32_t rk = __atomic_load_n(&r->recent_kernel, __ATOMIC_RELAXED);
  if (rk >= 0 && rk < 1024)
    __atomic_store_n(&r->recent_kernel, rk + 1, __ATOMIC_RELAXED);
  region_unlock(r);
}

/* Detect monitor flips of utilization_switch (must hold the lock). On the
 * 1->0 edge — the throttle re-engaging after a solo-tenant holiday — the
 * buckets are reset: credit banked while unthrottled must not grant a
 * free burst, and (the v3 bug's inverse) debt must not stall the tenant
 * for work it did while legitimately unthrottled. */
static void util_sync_switch(vtpu_shared_region_t *r, int64_t now) {
  int32_t sw = r->utilization_switch;
  if (r->util_prev_switch == sw) return;
  if (sw == 0) {
    for (int d = 0; d < VTPU_MAX_DEVICES; d++) {
      r->util_tokens_ns[d] = 0;
      r->util_refill_ns[d] = now;
    }
  }
  r->util_prev_switch = sw;
}

/* Debit the buckets of every masked device (lock held). The cap bounds
 * only what THIS completion may add: a bound of min(-cap, existing) can
 * deepen debt but never forgive it — a short completion arriving after a
 * long one must not reset the long program's debt to the floor (that
 * would re-open the v3 "programs over ~2s escape the limit" hole
 * through interleaved small dispatches). */
static void util_debit_locked(vtpu_shared_region_t *r, uint32_t dev_mask,
                              uint64_t ns) {
  if (r->utilization_switch != 0 || ns == 0) return;
  int64_t cap = (int64_t)ns * VTPU_UTIL_DEBT_MULT;
  if (cap < VTPU_UTIL_DEBT_FLOOR_NS) cap = VTPU_UTIL_DEBT_FLOOR_NS;
  if (dev_mask == 0) dev_mask = 1;
  for (int d = 0; d < VTPU_MAX_DEVICES; d++) {
    if (!((dev_mask >> d) & 1u)) continue;
    int64_t before = r->util_tokens_ns[d];
    int64_t bound = -cap < before ? -cap : before;
    int64_t after = before - (int64_t)ns;
    r->util_tokens_ns[d] = after < bound ? bound : after;
  }
}

void vtpu_note_complete(vtpu_shared_region_t *r, int32_t pid, uint64_t ns,
                        uint32_t dev_mask) {
  if (!r) return;
  if (region_lock(r)) return;
  vtpu_proc_slot_t *s = find_slot(r, pid);
  if (s) {
    s->launch_ns += ns;
    if (s->inflight > 0) s->inflight--;
    s->last_seen_ns = now_ns();
  }
  /* debt blocks the next acquire — but only while the throttle is
   * actually engaged (solo tenants run with utilization_switch=1 and
   * bank nothing; the 1->0 edge resets the buckets). Throttled tenants
   * carry their FULL measured duration as debt so long programs pay
   * back proportionally; the cap (a multiple of the duration, floored
   * for short programs) only bounds pathological debt pile-up from
   * deeply queued async completions. */
  util_sync_switch(r, now_ns());
  util_debit_locked(r, dev_mask, ns);
  region_unlock(r);
}

void vtpu_util_debit(vtpu_shared_region_t *r, uint32_t dev_mask,
                     uint64_t ns) {
  if (!r) return;
  if (region_lock(r)) return;
  util_sync_switch(r, now_ns());
  util_debit_locked(r, dev_mask, ns);
  region_unlock(r);
}

int32_t vtpu_inflight(vtpu_shared_region_t *r, int64_t max_age_ns) {
  if (!r) return 0;
  int32_t n = 0;
  if (region_lock(r)) return 0;
  int64_t now = now_ns();
  for (int i = 0; i < VTPU_MAX_PROCS; i++) {
    vtpu_proc_slot_t *s = &r->procs[i];
    if (!s->status || s->inflight <= 0) continue;
    if (max_age_ns > 0 && now - s->last_seen_ns > max_age_ns)
      continue; /* stale heartbeat: a dead process, not activity */
    n += s->inflight;
  }
  region_unlock(r);
  return n;
}

/* The port's batched launch ledger (not in lib/vtpu/shared_region.c):
 * libvgpu.so counts and measures launches in the process and publishes
 * them here once per batch, so the region lock is taken once per batch,
 * not once per kernel. Same effect as `launches` vtpu_note_launch calls
 * followed by the completions they stand for: the slot's launches and
 * total_launches grow by `launches` (recent_kernel bumped the same way),
 * its inflight by `inflight` (negative when completions outnumber the
 * launches measured), its launch_ns by the device time in debit_ns, and
 * device d's bucket is debited debit_ns[d] under vtpu_note_complete's
 * rule. */
void vtpu_note_batch(vtpu_shared_region_t *r, int32_t pid, uint64_t launches,
                     int32_t inflight,
                     const uint64_t debit_ns[VTPU_MAX_DEVICES]) {
  if (!r) return;
  if (region_lock(r)) return;
  uint64_t busy = 0;
  for (int d = 0; d < VTPU_MAX_DEVICES; d++) busy += debit_ns[d];
  vtpu_proc_slot_t *s = find_slot(r, pid);
  if (s) {
    s->launches += launches;
    s->launch_ns += busy;
    s->inflight += inflight;
    if (s->inflight < 0) s->inflight = 0;
    s->last_seen_ns = now_ns();
  }
  r->total_launches += launches;
  int32_t rk = __atomic_load_n(&r->recent_kernel, __ATOMIC_RELAXED);
  if (rk >= 0 && rk < 1024 && launches) {
    uint64_t next = (uint64_t)rk + launches;
    __atomic_store_n(&r->recent_kernel, next > 1024 ? 1024 : (int32_t)next,
                     __ATOMIC_RELAXED);
  }
  util_sync_switch(r, now_ns());
  for (int d = 0; d < VTPU_MAX_DEVICES; d++)
    if (debit_ns[d]) util_debit_locked(r, 1u << d, debit_ns[d]);
  region_unlock(r);
}

int vtpu_util_try_acquire(vtpu_shared_region_t *r, int dev,
                          uint32_t limit_pct, int64_t burst_ns) {
  if (!r || dev < 0 || dev >= VTPU_MAX_DEVICES) return 1;
  if (region_lock(r)) return 1;
  int64_t now = now_ns();
  util_sync_switch(r, now);
  if (r->utilization_switch) {
    region_unlock(r);
    return 1;
  }
  if (r->util_refill_ns[dev] == 0) {
    /* first acquire: start with a full burst so startup isn't throttled */
    r->util_tokens_ns[dev] = burst_ns;
  } else {
    int64_t dt = now - r->util_refill_ns[dev];
    if (dt > 0) r->util_tokens_ns[dev] += dt * (int64_t)limit_pct / 100;
    if (r->util_tokens_ns[dev] > burst_ns) r->util_tokens_ns[dev] = burst_ns;
  }
  r->util_refill_ns[dev] = now;
  int ok = r->util_tokens_ns[dev] > 0;
  region_unlock(r);
  return ok;
}

size_t vtpu_region_sizeof(void) { return sizeof(vtpu_shared_region_t); }

void vtpu_heartbeat(vtpu_shared_region_t *r, int32_t pid) {
  if (!r) return;
  /* v6: flush THIS thread's profile batch (a worker driving heartbeats
   * through SharedRegion drains its own counters; the shim's dedicated
   * heartbeat thread has none — its workload threads flush on their own
   * sampled events, bounding staleness at one sample period) */
  vtpu_prof_flush(r);
  if (region_lock(r)) return;
  int64_t now = now_ns();
  vtpu_proc_slot_t *s = find_slot(r, pid);
  if (s) s->last_seen_ns = now;
  /* v5: any live shim process keeps the whole-region heartbeat fresh */
  r->header_heartbeat_ns = now;
  region_unlock(r);
}
