/* region_test — the shared region (shared_region.c, ABI v8 plus
 * vtpu_note_batch) under concurrent writers, the port's counterpart of
 * lib/vtpu/test/region_test.c and built from the port's own copy of the
 * region. Concurrent charging from forked children must never exceed the
 * limit, dead slots must be GC-able, and a child killed mid-critical-section
 * must not deadlock the region (robust mutex recovery).
 *
 * Modes (argv[1]; each prints "... OK"): none (the full sequence, the
 * profile plane last), prof, gatestress, resizestress, hostledger,
 * notebatch, profbench (one JSON line). Temporary regions go under $TMPDIR
 * (else /tmp). Built plain, with ASan+UBSan and with TSan by
 * vtpu_torch/native.py; tests/test_torch_native_plane.py runs every mode.
 */

#define _GNU_SOURCE
#include <errno.h>
#include <pthread.h>
#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/wait.h>
#include <time.h>
#include <unistd.h>

#include "../shared_region.h"

#define CHECK(cond)                                                       \
  do {                                                                    \
    if (!(cond)) {                                                        \
      fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond);     \
      exit(1);                                                            \
    }                                                                     \
  } while (0)

/* a new empty file $TMPDIR/vgpu_<stem>_XXXXXX (else under /tmp) in out */
static void temp_path(char *out, size_t n, const char *stem) {
  const char *dir = getenv("TMPDIR");
  snprintf(out, n, "%s/vgpu_%s_XXXXXX", dir && *dir ? dir : "/tmp", stem);
  int fd = mkstemp(out);
  CHECK(fd >= 0);
  close(fd);
}

static int64_t bench_now_ns(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000000000ll + ts.tv_nsec;
}

static uint64_t hist_sum(const vtpu_prof_callsite_t *c) {
  uint64_t s = 0;
  for (int b = 0; b < VTPU_PROF_BUCKETS; b++) s += c->hist[b];
  return s;
}

/* profbench mode: tight-loop A/B of the charge path (try_alloc+free
 * pair) with profiling ON (env sample) vs OFF, printing one JSON line.
 * `python -m vtpu_torch.bench.prof --overhead` gates the overhead at
 * <=1%. min-of-attempts on both sides rejects scheduler noise. */
static int profbench_main(void) {
  char path[4096];
  temp_path(path, sizeof(path), "profbench");
  vtpu_shared_region_t *r = vtpu_region_open(path);
  CHECK(r != NULL);
  uint64_t limits[VTPU_MAX_DEVICES] = {1ull << 40};
  uint32_t cores[VTPU_MAX_DEVICES] = {0};
  CHECK(vtpu_region_configure(r, 1, limits, cores, 1,
                              VTPU_UTIL_POLICY_DEFAULT, NULL) == 0);
  int32_t me = (int32_t)getpid();
  CHECK(vtpu_region_attach(r, me) >= 0);

  const char *se = getenv("VTPU_PROFILE_SAMPLE");
  int sample = se ? atoi(se) : VTPU_PROF_SAMPLE_DEFAULT;
  const int iters = 200000, attempts = 5;
  double best[2] = {1e18, 1e18}; /* [0]=off, [1]=on */
  for (int a = 0; a < attempts; a++) {
    for (int mode = 0; mode < 2; mode++) {
      vtpu_prof_configure(mode, sample);
      /* warmup (page/TLS/branch state) */
      for (int i = 0; i < 2000; i++) {
        vtpu_try_alloc(r, me, 0, 1);
        vtpu_free(r, me, 0, 1);
      }
      int64_t t0 = bench_now_ns();
      for (int i = 0; i < iters; i++) {
        vtpu_try_alloc(r, me, 0, 1);
        vtpu_free(r, me, 0, 1);
      }
      double per = (double)(bench_now_ns() - t0) / iters;
      if (per < best[mode]) best[mode] = per;
    }
  }
  double pct = best[0] > 0 ? 100.0 * (best[1] - best[0]) / best[0] : 0.0;
  printf("{\"metric\": \"shim_prof_overhead\", \"off_ns_per_op\": %.1f, "
         "\"on_ns_per_op\": %.1f, \"overhead_pct\": %.3f, "
         "\"sample\": %d, \"iters\": %d}\n",
         best[0], best[1], pct, sample, iters);
  vtpu_region_close(r);
  unlink(path);
  return 0;
}

/* prof mode body: v6 profile-plane correctness — exact counter
 * conservation across concurrent forked writers, histogram-sum ==
 * sampled, pressure counters, and checksum/heartbeat interplay. */
static int prof_main(void) {
  char path[4096];
  temp_path(path, sizeof(path), "prof_test");
  vtpu_shared_region_t *r = vtpu_region_open(path);
  CHECK(r != NULL);
  uint64_t limits[VTPU_MAX_DEVICES] = {1 << 20};
  uint32_t cores[VTPU_MAX_DEVICES] = {0};
  CHECK(vtpu_region_configure(r, 1, limits, cores, 1,
                              VTPU_UTIL_POLICY_DEFAULT, NULL) == 0);
  int32_t me = (int32_t)getpid();
  CHECK(vtpu_region_attach(r, me) >= 0);
  vtpu_prof_configure(1, 1); /* sample every event: counters stay exact */

  /* single-writer exactness */
  for (int i = 0; i < 100; i++) {
    CHECK(vtpu_try_alloc(r, me, 0, 64) == 0);
    vtpu_free(r, me, 0, 64);
  }
  vtpu_prof_flush(r);
  vtpu_prof_callsite_t *ch = &r->prof_cs[VTPU_PROF_CS_CHARGE];
  vtpu_prof_callsite_t *un = &r->prof_cs[VTPU_PROF_CS_UNCHARGE];
  CHECK(ch->calls == 100 && un->calls == 100);
  CHECK(ch->bytes == 6400 && un->bytes == 6400);
  CHECK(ch->errors == 0);
  CHECK(ch->sampled == 100 && hist_sum(ch) == ch->sampled);
  CHECK(un->sampled == 100 && hist_sum(un) == un->sampled);
  CHECK(ch->total_ns > 0);

  /* near-limit rejection: pressure + error counters */
  CHECK(vtpu_try_alloc(r, me, 0, 1 << 20) == 0); /* fill to the cap */
  CHECK(vtpu_try_alloc(r, me, 0, 64) == -1);
  vtpu_prof_flush(r);
  CHECK(ch->errors == 1);
  CHECK(r->prof_pressure[VTPU_PROF_PK_NEAR_LIMIT_FAILURES] == 1);
  vtpu_free(r, me, 0, 1 << 20);
  /* v7: sampled events no longer drain the batch themselves (every
   * 16th sampled tick does) — drain explicitly so the baselines below
   * don't miss the uncharge above */
  vtpu_prof_flush(r);

  /* profile churn is dynamic state: the header checksum must not care */
  CHECK(vtpu_region_header_ok(r));

  /* sampled 1/N: counters stay exact, the histogram carries exactly
   * 1/N of the events. The per-thread tick strides across callsites:
   * with alternating charge/free events and N=8, every sampled event
   * lands on a free — charge keeps exact calls with no new timings. */
  uint64_t calls0 = ch->calls, sampled0 = ch->sampled;
  uint64_t un_sam0 = un->sampled;
  vtpu_prof_configure(1, 8);
  for (int i = 0; i < 64; i++) {
    CHECK(vtpu_try_alloc(r, me, 0, 8) == 0);
    vtpu_free(r, me, 0, 8);
  }
  vtpu_prof_flush(r);
  CHECK(ch->calls == calls0 + 64);
  CHECK(ch->sampled == sampled0);      /* even event positions only */
  CHECK(un->sampled == un_sam0 + 16);  /* 128 events / 8 */
  CHECK(hist_sum(ch) == ch->sampled);
  CHECK(hist_sum(un) == un->sampled);

  /* heartbeat drives both the v5 header heartbeat and this thread's
   * profile flush */
  vtpu_prof_configure(1, 1000000); /* batch never self-flushes */
  CHECK(vtpu_try_alloc(r, me, 0, 16) == 0);
  uint64_t before = ch->calls;
  int64_t hb0 = r->header_heartbeat_ns;
  usleep(2000);
  vtpu_heartbeat(r, me);
  CHECK(r->header_heartbeat_ns > hb0);
  CHECK(ch->calls == before + 1); /* heartbeat flushed the batch */
  vtpu_free(r, me, 0, 16);

  /* disabled: zero overhead path records nothing */
  vtpu_prof_configure(0, 1);
  uint64_t snap_calls = ch->calls, snap_un = un->calls;
  for (int i = 0; i < 50; i++) {
    CHECK(vtpu_try_alloc(r, me, 0, 4) == 0);
    vtpu_free(r, me, 0, 4);
  }
  vtpu_prof_flush(r);
  CHECK(ch->calls == snap_calls);
  CHECK(un->calls == snap_un + 1); /* the pre-disable free's batch rode
                                      along in the earlier flush */

  /* --- histogram-sum conservation across CONCURRENT writers: 8 forked
   * children x 500 charge/free pairs, sample=1, no drops allowed --- */
  vtpu_prof_configure(1, 1);
  uint64_t base_calls = ch->calls, base_un = un->calls;
  uint64_t base_sam = ch->sampled, base_bytes = ch->bytes;
  int kids = 8, per_kid = 500;
  for (int k = 0; k < kids; k++) {
    pid_t pid = fork();
    CHECK(pid >= 0);
    if (pid == 0) {
      vtpu_shared_region_t *cr = vtpu_region_open(path);
      if (!cr) _exit(2);
      vtpu_prof_configure(1, 1);
      int32_t kid = (int32_t)getpid();
      if (vtpu_region_attach(cr, kid) < 0) _exit(3);
      for (int i = 0; i < per_kid; i++) {
        if (vtpu_try_alloc(cr, kid, 0, 2) != 0) _exit(4);
        vtpu_free(cr, kid, 0, 2);
      }
      vtpu_region_detach(cr, kid); /* flushes the batch */
      _exit(0);
    }
  }
  int status;
  while (wait(&status) > 0)
    CHECK(WIFEXITED(status) && WEXITSTATUS(status) == 0);
  CHECK(ch->calls == base_calls + (uint64_t)(kids * per_kid));
  CHECK(un->calls == base_un + (uint64_t)(kids * per_kid));
  CHECK(ch->sampled == base_sam + (uint64_t)(kids * per_kid));
  CHECK(hist_sum(ch) == ch->sampled);
  CHECK(ch->bytes == base_bytes + (uint64_t)(kids * per_kid) * 2);
  CHECK(vtpu_region_header_ok(r)); /* still no checksum impact */

  /* --- fork must not duplicate a pending TLS batch: the atfork child
   * handler discards the inherited copy, so each event lands exactly
   * once no matter which side flushes --- */
  vtpu_prof_configure(1, 1000000); /* keep the batch pending */
  uint64_t fb_calls = ch->calls;
  for (int i = 0; i < 5; i++) {
    CHECK(vtpu_try_alloc(r, me, 0, 32) == 0);
    vtpu_free(r, me, 0, 32);
  }
  pid_t fp = fork();
  CHECK(fp >= 0);
  if (fp == 0) {
    vtpu_prof_flush(r); /* inherited batch must already be gone */
    _exit(r->prof_cs[VTPU_PROF_CS_CHARGE].calls == fb_calls ? 0 : 9);
  }
  CHECK(wait(&status) > 0 && WIFEXITED(status) && WEXITSTATUS(status) == 0);
  vtpu_prof_flush(r); /* the parent's copy still flushes, exactly once */
  CHECK(ch->calls == fb_calls + 5);

  vtpu_region_close(r);
  unlink(path);
  printf("region_test prof OK\n");
  return 0;
}

/* gatestress mode (v7): 8 threads churn try_alloc/free against one
 * region while concurrently reading the LOCK-FREE gate plane
 * (usage_epoch + used_fast). Asserts byte-exact conservation: the
 * aggregate never exceeds the limit mid-churn (try_alloc enforces under
 * the lock, and the aggregate is maintained in the same critical
 * section), and at quiesce the lock-free aggregate, the locked slot
 * sweep, and zero all agree. TSan runs this too. */
#define GS_THREADS 8
#define GS_ITERS 4000
#define GS_LIMIT (1ull << 20)

typedef struct {
  vtpu_shared_region_t *r;
  int32_t pid; /* all threads share the process slot */
  int failures;
} gs_ctx_t;

static void *gatestress_thread(void *arg) {
  gs_ctx_t *c = arg;
  uint64_t fast[VTPU_MAX_DEVICES];
  for (int i = 0; i < GS_ITERS; i++) {
    uint64_t sz = (uint64_t)(64 + (i % 7) * 512);
    if (vtpu_try_alloc(c->r, c->pid, 0, sz) == 0) {
      vtpu_region_used_fast(c->r, fast);
      /* the aggregate is maintained inside the charge critical section:
       * a lock-free reader may see at most the limit, never beyond it
       * (force_alloc never runs in this mode) */
      if (fast[0] > GS_LIMIT)
        __atomic_fetch_add(&c->failures, 1, __ATOMIC_RELAXED);
      vtpu_free(c->r, c->pid, 0, sz);
    }
    (void)vtpu_region_usage_epoch(c->r);
  }
  return NULL;
}

static int gatestress_main(void) {
  char path[4096];
  temp_path(path, sizeof(path), "gatestress");
  vtpu_shared_region_t *r = vtpu_region_open(path);
  CHECK(r != NULL);
  uint64_t limits[VTPU_MAX_DEVICES] = {GS_LIMIT};
  uint32_t cores[VTPU_MAX_DEVICES] = {0};
  CHECK(vtpu_region_configure(r, 1, limits, cores, 1,
                              VTPU_UTIL_POLICY_DEFAULT, NULL) == 0);
  gs_ctx_t ctx = {.r = r, .pid = (int32_t)getpid(), .failures = 0};
  CHECK(vtpu_region_attach(r, ctx.pid) >= 0);
  uint64_t epoch0 = vtpu_region_usage_epoch(r);

  pthread_t th[GS_THREADS];
  for (int t = 0; t < GS_THREADS; t++)
    CHECK(pthread_create(&th[t], NULL, gatestress_thread, &ctx) == 0);
  for (int t = 0; t < GS_THREADS; t++) CHECK(pthread_join(th[t], NULL) == 0);

  CHECK(ctx.failures == 0);
  CHECK(vtpu_region_usage_epoch(r) > epoch0);
  /* quiesced: lock-free aggregate == locked slot sweep == 0 (byte-exact
   * conservation; every alloc was freed) */
  uint64_t fast[VTPU_MAX_DEVICES], exact[VTPU_MAX_DEVICES];
  vtpu_region_used_fast(r, fast);
  vtpu_region_used_all(r, exact);
  for (int d = 0; d < VTPU_MAX_DEVICES; d++) {
    CHECK(fast[d] == exact[d]);
    CHECK(fast[d] == 0);
  }
  /* detach/GC keep the aggregate in sync too */
  vtpu_force_alloc(r, ctx.pid, 0, 12345);
  vtpu_region_used_fast(r, fast);
  CHECK(fast[0] == 12345);
  CHECK(vtpu_region_detach(r, ctx.pid) == 0);
  vtpu_region_used_fast(r, fast);
  CHECK(fast[0] == 0);
  /* bulk force-alloc: one lock pass charges several devices at once */
  CHECK(vtpu_region_attach(r, ctx.pid) >= 0);
  uint64_t add[VTPU_MAX_DEVICES] = {0};
  add[0] = 1000;
  add[3] = 500;
  vtpu_force_alloc_bulk(r, ctx.pid, add);
  vtpu_region_used_fast(r, fast);
  vtpu_region_used_all(r, exact);
  CHECK(fast[0] == 1000 && fast[3] == 500);
  CHECK(exact[0] == 1000 && exact[3] == 500);
  vtpu_free(r, ctx.pid, 0, 1000);
  vtpu_free(r, ctx.pid, 3, 500);
  vtpu_region_used_fast(r, fast);
  CHECK(fast[0] == 0 && fast[3] == 0);

  vtpu_region_close(r);
  unlink(path);
  printf("region_test gatestress OK (%d threads x %d iters)\n",
         GS_THREADS, GS_ITERS);
  return 0;
}

/* resizestress mode (elastic quotas): 8 threads
 * allocate/free through try_alloc — some allocations held in a small
 * per-thread ring so usage is never trivially zero — while the main
 * thread churns the limit through vtpu_region_set_limit_checked between
 * a low and a high bound. Invariants:
 *
 *   - the checked setter never stores a limit below live usage (a
 *     shrink below it clamps, rc 1), so `used <= limit` holds at every
 *     instant of the churn; the churner samples the LOCKED slot sweep
 *     against its own last-applied value to prove it (it is the only
 *     limit writer);
 *   - conservation is byte-exact at quiesce (lock-free aggregate ==
 *     locked sweep == 0 after every held allocation is freed);
 *   - the header checksum stays valid through every resize (the setter
 *     restamps inside its critical section) and the usage epoch
 *     advances per resize (gate-snapshot invalidation).
 *
 * TSan/ASan/UBSan run this too. */
#define RS_THREADS 8
#define RS_ITERS 40000
#define RS_HOLD 8
#define RS_LIMIT_HI (1ull << 20)
#define RS_LIMIT_LO (96 * 1024ull)

typedef struct {
  vtpu_shared_region_t *r;
  int32_t pid;
  int done;
} rs_ctx_t;

static void *resizestress_thread(void *arg) {
  rs_ctx_t *c = arg;
  uint64_t held[RS_HOLD] = {0};
  int slot = 0;
  for (int i = 0; i < RS_ITERS; i++) {
    uint64_t sz = (uint64_t)(128 + (i % 13) * 512);
    if (vtpu_try_alloc(c->r, c->pid, 0, sz) == 0) {
      if (held[slot]) vtpu_free(c->r, c->pid, 0, held[slot]);
      held[slot] = sz;
      slot = (slot + 1) % RS_HOLD;
    }
  }
  for (int s = 0; s < RS_HOLD; s++)
    if (held[s]) vtpu_free(c->r, c->pid, 0, held[s]);
  __atomic_store_n(&c->done, 1, __ATOMIC_RELEASE);
  return NULL;
}

static int resizestress_main(void) {
  char path[4096];
  temp_path(path, sizeof(path), "resizestress");
  vtpu_shared_region_t *r = vtpu_region_open(path);
  CHECK(r != NULL);
  uint64_t limits[VTPU_MAX_DEVICES] = {RS_LIMIT_HI};
  uint32_t cores[VTPU_MAX_DEVICES] = {0};
  CHECK(vtpu_region_configure(r, 1, limits, cores, 1,
                              VTPU_UTIL_POLICY_DEFAULT, NULL) == 0);
  int32_t me = (int32_t)getpid();
  CHECK(vtpu_region_attach(r, me) >= 0);

  /* single-thread clamp semantics first: a shrink below live usage is
   * clamped to the usage, never applied */
  uint64_t applied = 0;
  CHECK(vtpu_try_alloc(r, me, 0, 1000) == 0);
  CHECK(vtpu_region_set_limit_checked(r, 0, 500, &applied) == 1);
  CHECK(applied == 1000);
  CHECK(r->hbm_limit[0] == 1000);
  CHECK(vtpu_region_header_ok(r)); /* restamped inside the setter */
  /* a charge against the clamped limit is refused — used can never
   * pass the stored limit */
  CHECK(vtpu_try_alloc(r, me, 0, 1) == -1);
  vtpu_free(r, me, 0, 1000);
  CHECK(vtpu_region_set_limit_checked(r, 0, 500, &applied) == 0);
  CHECK(applied == 500 && r->hbm_limit[0] == 500);
  /* unlimited (0) always applies exactly */
  CHECK(vtpu_try_alloc(r, me, 0, 400) == 0);
  CHECK(vtpu_region_set_limit_checked(r, 0, 0, &applied) == 0);
  CHECK(applied == 0);
  vtpu_free(r, me, 0, 400);
  CHECK(vtpu_region_set_limit_checked(r, 0, RS_LIMIT_HI, NULL) == 0);
  CHECK(vtpu_region_set_limit_checked(r, -1, 1, NULL) == -1);

  /* 8 threads vs the churning boundary */
  rs_ctx_t ctx = {.r = r, .pid = me, .done = 0};
  pthread_t th[RS_THREADS];
  rs_ctx_t ctxs[RS_THREADS];
  for (int t = 0; t < RS_THREADS; t++) {
    ctxs[t] = ctx;
    CHECK(pthread_create(&th[t], NULL, resizestress_thread,
                         &ctxs[t]) == 0);
  }
  uint64_t epoch0 = vtpu_region_usage_epoch(r);
  uint64_t exact[VTPU_MAX_DEVICES];
  int resizes = 0, clamped = 0, alive = 1;
  while (alive) {
    alive = 0;
    for (int t = 0; t < RS_THREADS; t++)
      if (!__atomic_load_n(&ctxs[t].done, __ATOMIC_ACQUIRE)) alive = 1;
    uint64_t target = (resizes & 1) ? RS_LIMIT_LO : RS_LIMIT_HI;
    int rc = vtpu_region_set_limit_checked(r, 0, target, &applied);
    CHECK(rc == 0 || rc == 1);
    if (rc == 0) CHECK(applied == target);
    else { CHECK(applied > target); clamped++; }
    resizes++;
    /* this thread is the ONLY limit writer, so between its own sets
     * the limit is constant == applied; try_alloc enforces used <=
     * limit under the lock and frees only reduce — the locked ground
     * truth may never exceed the last applied value */
    vtpu_region_used_all(r, exact);
    CHECK(exact[0] <= applied);
    CHECK(vtpu_region_header_ok(r));
    usleep(50); /* let the workers actually churn between resizes */
  }
  for (int t = 0; t < RS_THREADS; t++) CHECK(pthread_join(th[t], NULL) == 0);
  while (resizes < 4) { /* a too-fast quiesce still proves the cycle */
    uint64_t target = (resizes & 1) ? RS_LIMIT_LO : RS_LIMIT_HI;
    CHECK(vtpu_region_set_limit_checked(r, 0, target, &applied) == 0);
    resizes++;
  }
  CHECK(vtpu_region_usage_epoch(r) >= epoch0 + (uint64_t)resizes);

  /* quiesce: byte-exact conservation — every alloc freed, lock-free
   * aggregate == locked sweep == 0 */
  uint64_t fast[VTPU_MAX_DEVICES];
  vtpu_region_used_fast(r, fast);
  vtpu_region_used_all(r, exact);
  for (int d = 0; d < VTPU_MAX_DEVICES; d++) {
    CHECK(fast[d] == exact[d]);
    CHECK(fast[d] == 0);
  }
  /* a final shrink on the idle region applies exactly */
  CHECK(vtpu_region_set_limit_checked(r, 0, RS_LIMIT_LO, &applied) == 0);
  CHECK(applied == RS_LIMIT_LO);
  CHECK(vtpu_region_header_ok(r));

  vtpu_region_close(r);
  unlink(path);
  printf("region_test resizestress OK (%d threads x %d iters, "
         "%d resizes, %d clamped)\n",
         RS_THREADS, RS_ITERS, resizes, clamped);
  return 0;
}

/* hostledger mode (v8): the host-memory quota dimension.
 * Unit semantics first (first-writer configure, try/force/free, the
 * checked setter's clamp, rolling-upgrade refusal of a v7 header),
 * then 8 threads churn host_try_alloc/free — a held ring keeps usage
 * nonzero — interleaved with DEVICE churn on the same slots, while the
 * main thread flips the host limit through
 * vtpu_region_set_host_limit_checked. Invariants:
 *
 *   - the try path never lets host usage pass the limit (the churner,
 *     sole limit writer, samples the LOCKED host sweep against its own
 *     last-applied value);
 *   - host-ledger conservation is byte-exact at quiesce (lock-free
 *     aggregate == locked sweep == 0) and the DEVICE axis is untouched
 *     by host traffic;
 *   - the header checksum (which now covers host_limit) stays valid
 *     through every resize;
 *   - detach/GC release a dead process's host bytes.
 *
 * ASan/UBSan/TSan run this too. */
#define HL_THREADS 8
#define HL_ITERS 30000
#define HL_HOLD 8
#define HL_LIMIT_HI (1ull << 20)
#define HL_LIMIT_LO (96 * 1024ull)

typedef struct {
  vtpu_shared_region_t *r;
  int32_t pid;
  int done;
} hl_ctx_t;

static void *hostledger_thread(void *arg) {
  hl_ctx_t *c = arg;
  uint64_t held[HL_HOLD] = {0};
  int slot = 0;
  for (int i = 0; i < HL_ITERS; i++) {
    uint64_t sz = (uint64_t)(128 + (i % 13) * 512);
    if (vtpu_host_try_alloc(c->r, c->pid, sz) == 0) {
      if (held[slot]) vtpu_host_free(c->r, c->pid, held[slot]);
      held[slot] = sz;
      slot = (slot + 1) % HL_HOLD;
    }
    if ((i & 7) == 0) { /* device churn on the same slot: the two axes
                         * share the lock + slot but never mix bytes */
      if (vtpu_try_alloc(c->r, c->pid, 0, 256) == 0)
        vtpu_free(c->r, c->pid, 0, 256);
    }
  }
  for (int s = 0; s < HL_HOLD; s++)
    if (held[s]) vtpu_host_free(c->r, c->pid, held[s]);
  __atomic_store_n(&c->done, 1, __ATOMIC_RELEASE);
  return NULL;
}

static int hostledger_main(void) {
  char path[4096];
  temp_path(path, sizeof(path), "hostledger");
  vtpu_shared_region_t *r = vtpu_region_open(path);
  CHECK(r != NULL);
  uint64_t limits[VTPU_MAX_DEVICES] = {1ull << 30};
  uint32_t cores[VTPU_MAX_DEVICES] = {0};
  CHECK(vtpu_region_configure(r, 1, limits, cores, 1,
                              VTPU_UTIL_POLICY_DEFAULT, NULL) == 0);
  int32_t me = (int32_t)getpid();
  CHECK(vtpu_region_attach(r, me) >= 0);

  /* first-writer-wins host configure; restamps the checksum */
  CHECK(vtpu_region_configure_host(r, HL_LIMIT_HI) == 0);
  CHECK(r->host_limit == HL_LIMIT_HI);
  CHECK(vtpu_region_configure_host(r, 5) == 0); /* no-op: already set */
  CHECK(r->host_limit == HL_LIMIT_HI);
  CHECK(vtpu_region_header_ok(r));

  /* try/force/free semantics + oom accounting */
  CHECK(vtpu_host_try_alloc(r, me, 1000) == 0);
  CHECK(vtpu_region_host_used(r) == 1000);
  CHECK(vtpu_region_host_used_fast(r) == 1000);
  uint64_t oom0 = r->host_oom_events;
  CHECK(vtpu_host_try_alloc(r, me, HL_LIMIT_HI) == -1); /* would breach */
  CHECK(errno == ENOMEM);
  CHECK(r->host_oom_events == oom0 + 1);
  CHECK(vtpu_region_host_used(r) == 1000); /* rejected = uncharged */
  /* near-limit pressure: fill to the brim, reject, counter moves */
  vtpu_prof_configure(1, 1);
  uint64_t nl0 = r->prof_pressure[VTPU_PROF_PK_HOST_NEAR_LIMIT_FAILURES];
  CHECK(vtpu_host_try_alloc(r, me, HL_LIMIT_HI - 1128) == 0);
  CHECK(vtpu_host_try_alloc(r, me, 4096) == -1);
  CHECK(r->prof_pressure[VTPU_PROF_PK_HOST_NEAR_LIMIT_FAILURES] ==
        nl0 + 1);
  vtpu_host_free(r, me, HL_LIMIT_HI - 1128);
  /* force over the cap: charged anyway, over-events pressure fires */
  uint64_t ov0 = r->prof_pressure[VTPU_PROF_PK_HOST_OVER_EVENTS];
  vtpu_host_force_alloc(r, me, HL_LIMIT_HI);
  CHECK(vtpu_region_host_used(r) == 1000 + HL_LIMIT_HI);
  CHECK(r->prof_pressure[VTPU_PROF_PK_HOST_OVER_EVENTS] == ov0 + 1);
  /* checked setter: shrink below live usage clamps, never applies */
  uint64_t applied = 0;
  CHECK(vtpu_region_set_host_limit_checked(r, 500, &applied) == 1);
  CHECK(applied == 1000 + HL_LIMIT_HI);
  CHECK(r->host_limit == applied);
  CHECK(vtpu_region_header_ok(r));
  CHECK(vtpu_host_try_alloc(r, me, 1) == -1); /* at the clamped cap */
  vtpu_host_free(r, me, HL_LIMIT_HI);
  CHECK(vtpu_region_set_host_limit_checked(r, 500, &applied) == 1);
  CHECK(applied == 1000); /* still above target: clamp follows usage */
  vtpu_host_free(r, me, 1000);
  CHECK(vtpu_region_set_host_limit_checked(r, HL_LIMIT_HI, &applied)
        == 0);
  CHECK(applied == HL_LIMIT_HI);
  /* detach releases the host bytes (SIGKILL-mid-charge recovery path:
   * attach-time GC of a dead pid runs the same subtraction) */
  CHECK(vtpu_host_try_alloc(r, me, 4096) == 0);
  CHECK(vtpu_region_detach(r, me) == 0);
  CHECK(vtpu_region_host_used(r) == 0);
  CHECK(vtpu_region_host_used_fast(r) == 0);
  CHECK(vtpu_region_attach(r, me) >= 0);

  /* 8 threads vs the churning host limit */
  pthread_t th[HL_THREADS];
  hl_ctx_t ctxs[HL_THREADS];
  for (int t = 0; t < HL_THREADS; t++) {
    ctxs[t] = (hl_ctx_t){.r = r, .pid = me, .done = 0};
    CHECK(pthread_create(&th[t], NULL, hostledger_thread,
                         &ctxs[t]) == 0);
  }
  int resizes = 0, clamped = 0, alive = 1;
  while (alive) {
    alive = 0;
    for (int t = 0; t < HL_THREADS; t++)
      if (!__atomic_load_n(&ctxs[t].done, __ATOMIC_ACQUIRE)) alive = 1;
    uint64_t target = (resizes & 1) ? HL_LIMIT_LO : HL_LIMIT_HI;
    int rc = vtpu_region_set_host_limit_checked(r, target, &applied);
    CHECK(rc == 0 || rc == 1);
    if (rc == 0) CHECK(applied == target);
    else { CHECK(applied > target); clamped++; }
    resizes++;
    /* sole limit writer: the locked host ground truth may never exceed
     * the last applied value (try enforces under the lock, frees only
     * reduce, and no force_alloc runs in the stress) */
    CHECK(vtpu_region_host_used(r) <= applied);
    CHECK(vtpu_region_header_ok(r));
    usleep(50);
  }
  for (int t = 0; t < HL_THREADS; t++)
    CHECK(pthread_join(th[t], NULL) == 0);

  /* quiesce: byte-exact host-ledger conservation, device axis clean */
  CHECK(vtpu_region_host_used_fast(r) == vtpu_region_host_used(r));
  CHECK(vtpu_region_host_used(r) == 0);
  uint64_t exact[VTPU_MAX_DEVICES];
  vtpu_region_used_all(r, exact);
  for (int d = 0; d < VTPU_MAX_DEVICES; d++) CHECK(exact[d] == 0);
  CHECK(vtpu_region_header_ok(r));
  vtpu_region_close(r);

  /* rolling-upgrade refusal: a v8 shim must refuse a previous-ABI
   * header cleanly (EPROTO), never reinitialize or misread it */
  vtpu_shared_region_t *old = vtpu_region_open(path);
  CHECK(old != NULL);
  old->version = VTPU_SHARED_VERSION - 1;
  vtpu_region_close(old);
  errno = 0;
  CHECK(vtpu_region_open(path) == NULL);
  CHECK(errno == EPROTO);

  unlink(path);
  printf("region_test hostledger OK (%d threads x %d iters, "
         "%d resizes, %d clamped)\n",
         HL_THREADS, HL_ITERS, resizes, clamped);
  return 0;
}

/* notebatch mode (the port's own primitive): libvgpu.so publishes launch
 * counts and measured device time in batches, one region lock per batch,
 * from the heartbeat thread and from every launching thread. 8 threads,
 * each a process slot of its own plus the one they share, publish batches
 * of launches, in-flight changes that net to zero and per-device debits.
 * Every count arrives exactly: each slot's launches and launch_ns, the
 * region's total_launches, in-flight back to 0, recent_kernel capped at
 * 1024, and the header checksum untouched (all dynamic fields). */
#define NB_THREADS 8
#define NB_ITERS 5000

typedef struct {
  vtpu_shared_region_t *r;
  int32_t pid, shared_pid;
} nb_ctx_t;

static void *notebatch_thread(void *arg) {
  nb_ctx_t *c = arg;
  int up[2] = {1, 1}; /* per slot: a launch in flight, then completed */
  for (int i = 0; i < NB_ITERS; i++) {
    uint64_t debit[VTPU_MAX_DEVICES] = {0};
    debit[i & 1] = 1000 + (uint64_t)(i % 7);
    int sh = (i & 3) == 3;
    vtpu_note_batch(c->r, sh ? c->shared_pid : c->pid, 1 + (uint64_t)(i % 3),
                    up[sh] ? 1 : -1, debit);
    up[sh] = !up[sh];
  }
  return NULL;
}

static int notebatch_main(void) {
  char path[4096];
  temp_path(path, sizeof(path), "notebatch");
  vtpu_shared_region_t *r = vtpu_region_open(path);
  CHECK(r != NULL);
  uint64_t limits[VTPU_MAX_DEVICES] = {1 << 20, 1 << 20};
  uint32_t cores[VTPU_MAX_DEVICES] = {50, 50};
  CHECK(vtpu_region_configure(r, 2, limits, cores, 1,
                              VTPU_UTIL_POLICY_DEFAULT, NULL) == 0);
  int32_t shared = (int32_t)getpid();
  CHECK(vtpu_region_attach(r, shared) >= 0);
  uint64_t total0 = r->total_launches;

  pthread_t th[NB_THREADS];
  nb_ctx_t ctx[NB_THREADS];
  for (int t = 0; t < NB_THREADS; t++) {
    ctx[t] = (nb_ctx_t){r, 200000 + t, shared}; /* fake distinct pids */
    CHECK(vtpu_region_attach(r, ctx[t].pid) >= 0);
  }
  for (int t = 0; t < NB_THREADS; t++)
    CHECK(pthread_create(&th[t], NULL, notebatch_thread, &ctx[t]) == 0);
  for (int t = 0; t < NB_THREADS; t++) CHECK(pthread_join(th[t], NULL) == 0);

  /* what one thread published to its own slot, and to the shared one */
  uint64_t own_l = 0, own_ns = 0, sh_l = 0, sh_ns = 0;
  for (int i = 0; i < NB_ITERS; i++) {
    uint64_t l = 1 + (uint64_t)(i % 3), ns = 1000 + (uint64_t)(i % 7);
    if ((i & 3) == 3) {
      sh_l += l;
      sh_ns += ns;
    } else {
      own_l += l;
      own_ns += ns;
    }
  }
  int seen = 0;
  for (int i = 0; i < VTPU_MAX_PROCS; i++) {
    vtpu_proc_slot_t *s = &r->procs[i];
    if (!s->status) continue;
    seen++;
    if (s->pid == shared) {
      CHECK(s->launches == NB_THREADS * sh_l);
      CHECK(s->launch_ns == NB_THREADS * sh_ns);
    } else {
      CHECK(s->launches == own_l);
      CHECK(s->launch_ns == own_ns);
    }
    CHECK(s->inflight == 0);
  }
  CHECK(seen == NB_THREADS + 1);
  CHECK(r->total_launches == total0 + NB_THREADS * (own_l + sh_l));
  CHECK(vtpu_inflight(r, 0) == 0);
  CHECK(r->recent_kernel == 1024);
  CHECK(vtpu_region_header_ok(r));
  /* the buckets were debited: device time taken, none left banked */
  CHECK(r->util_tokens_ns[0] <= 0 && r->util_tokens_ns[1] <= 0);
  for (int t = 0; t < NB_THREADS; t++)
    CHECK(vtpu_region_detach(r, ctx[t].pid) == 0);
  CHECK(vtpu_region_detach(r, shared) == 0);

  vtpu_region_close(r);
  unlink(path);
  printf("region_test notebatch OK (%d threads x %d batches)\n",
         NB_THREADS, NB_ITERS);
  return 0;
}

int main(int argc, char **argv) {
  if (argc >= 2 && strcmp(argv[1], "profbench") == 0)
    return profbench_main();
  if (argc >= 2 && strcmp(argv[1], "prof") == 0) return prof_main();
  if (argc >= 2 && strcmp(argv[1], "gatestress") == 0)
    return gatestress_main();
  if (argc >= 2 && strcmp(argv[1], "resizestress") == 0)
    return resizestress_main();
  if (argc >= 2 && strcmp(argv[1], "hostledger") == 0)
    return hostledger_main();
  if (argc >= 2 && strcmp(argv[1], "notebatch") == 0)
    return notebatch_main();
  /* default: run the full sequence, profile plane last */
  (void)argc;
  (void)argv;
  char path[4096];
  temp_path(path, sizeof(path), "region_test");

  vtpu_shared_region_t *r = vtpu_region_open(path);
  CHECK(r != NULL);
  CHECK(r->magic == VTPU_SHARED_MAGIC);

  uint64_t limits[VTPU_MAX_DEVICES] = {1000};
  uint32_t cores[VTPU_MAX_DEVICES] = {50};
  const char *uuids[1] = {"chip-aaaa"};
  CHECK(vtpu_region_configure(r, 1, limits, cores, 1,
                              VTPU_UTIL_POLICY_DEFAULT, uuids) == 0);
  /* second configure is a no-op (first writer wins) */
  uint64_t limits2[VTPU_MAX_DEVICES] = {5};
  CHECK(vtpu_region_configure(r, 1, limits2, cores, 0,
                              VTPU_UTIL_POLICY_DISABLE, NULL) == 0);
  CHECK(r->hbm_limit[0] == 1000);
  CHECK(r->util_policy == VTPU_UTIL_POLICY_DEFAULT);
  CHECK(r->utilization_switch == 0);
  CHECK(strcmp(r->dev_uuid[0], "chip-aaaa") == 0);

  /* --- concurrent children each try 40 x 1-byte charges; limit 1000 means
   * total granted must be exactly 1000 with 8 x 40 x 1... no: 8*40=320
   * under limit. Use charges of 5: 8*40*5 = 1600 > 1000, so grants must
   * stop at exactly <= 1000 and every rejection must be OOM. --- */
  int kids = 8;
  for (int k = 0; k < kids; k++) {
    pid_t pid = fork();
    CHECK(pid >= 0);
    if (pid == 0) {
      vtpu_shared_region_t *cr = vtpu_region_open(path);
      if (!cr) _exit(2);
      int32_t me = (int32_t)getpid();
      if (vtpu_region_attach(cr, me) < 0) _exit(3);
      int granted = 0;
      for (int i = 0; i < 40; i++)
        if (vtpu_try_alloc(cr, me, 0, 5) == 0) granted++;
      /* leave usage behind on purpose; parent GCs it */
      _exit(100 + granted); /* granted <= 40, fits an exit code */
    }
  }
  int status;
  while (wait(&status) > 0) {
    CHECK(WIFEXITED(status) && WEXITSTATUS(status) >= 100);
  }
  uint64_t used = vtpu_region_used(r, 0);
  CHECK(used <= 1000);
  CHECK(used >= 1000 - 4); /* fully packed modulo the 5-byte granule */

  /* --- children are dead: GC reclaims their slots and usage --- */
  int reclaimed = vtpu_region_gc(r);
  CHECK(reclaimed == kids);
  CHECK(vtpu_region_used(r, 0) == 0);

  /* --- robust lock: child dies holding the mutex; parent must recover ---
   */
  pid_t locker = fork();
  CHECK(locker >= 0);
  if (locker == 0) {
    vtpu_shared_region_t *cr = vtpu_region_open(path);
    if (!cr) _exit(2);
    pthread_mutex_lock(&cr->lock);
    raise(SIGKILL); /* die holding it */
    _exit(3);
  }
  waitpid(locker, &status, 0);
  CHECK(WIFSIGNALED(status));
  int32_t me = (int32_t)getpid();
  CHECK(vtpu_region_attach(r, me) >= 0); /* would deadlock w/o robustness */
  CHECK(vtpu_try_alloc(r, me, 0, 10) == 0);
  CHECK(vtpu_region_used(r, 0) == 10);

  /* --- force-alloc past limit bumps oom_events and blocks try_alloc --- */
  vtpu_force_alloc(r, me, 0, 2000);
  CHECK(vtpu_region_used(r, 0) == 2010);
  CHECK(r->oom_events >= 1);
  CHECK(vtpu_try_alloc(r, me, 0, 1) == -1);
  vtpu_free(r, me, 0, 2010);
  CHECK(vtpu_region_used(r, 0) == 0);

  /* --- reopen sees the same initialized region, not a re-init --- */
  vtpu_shared_region_t *r2 = vtpu_region_open(path);
  CHECK(r2 != NULL);
  CHECK(r2->hbm_limit[0] == 1000);
  vtpu_region_close(r2);

  /* --- v4: per-device token buckets are independent --- */
  r->core_limit[0] = 30;
  r->core_limit[1] = 80;
  vtpu_region_header_restamp(r); /* direct static-field write (v5) */
  CHECK(vtpu_util_try_acquire(r, 0, 30, 100000000ll) == 1); /* burst */
  CHECK(vtpu_util_try_acquire(r, 1, 80, 100000000ll) == 1);
  /* drive device 0 deep into debt; device 1 must stay unaffected */
  vtpu_note_complete(r, me, 500000000ull, 0x1); /* 500ms on dev 0 only */
  CHECK(r->util_tokens_ns[0] < 0);
  CHECK(r->util_tokens_ns[1] > 0);
  CHECK(vtpu_util_try_acquire(r, 0, 30, 100000000ll) == 0); /* in debt */
  CHECK(vtpu_util_try_acquire(r, 1, 80, 100000000ll) == 1);
  /* a multi-device program debits every addressed bucket */
  int64_t d1_before = r->util_tokens_ns[1];
  vtpu_note_complete(r, me, 50000000ull, 0x3); /* 50ms on devs 0+1 */
  CHECK(r->util_tokens_ns[1] == d1_before - 50000000ll);

  /* --- v4: debt carries the full measured duration (capped at
   * VTPU_UTIL_DEBT_MULT x duration), so long programs cannot escape the
   * limit through the old 2s clamp --- */
  vtpu_note_complete(r, me, 10000000000ull, 0x1); /* 10s program */
  CHECK(r->util_tokens_ns[0] < -VTPU_UTIL_DEBT_FLOOR_NS); /* > old clamp */
  CHECK(r->util_tokens_ns[0] >= -(int64_t)10000000000ll * VTPU_UTIL_DEBT_MULT
                                - 1000000000ll);

  /* --- v4: a short completion after a long one must NOT forgive the
   * long program's debt (the cap bounds the increment, not the total) */
  int64_t deep_debt = r->util_tokens_ns[0]; /* ~-10.4s from above */
  vtpu_note_complete(r, me, 1000000ull, 0x1); /* 1ms program */
  CHECK(r->util_tokens_ns[0] <= deep_debt); /* debt deepened, not reset */

  /* --- v4: the 1->0 utilization_switch edge resets the buckets (no debt
   * or credit banked while unthrottled leaks into the throttled regime) */
  r->utilization_switch = 1; /* monitor: solo tenant, throttle off */
  vtpu_note_complete(r, me, 5000000000ull, 0x1); /* runs unthrottled */
  CHECK(vtpu_util_try_acquire(r, 0, 30, 100000000ll) == 1); /* switch on */
  r->utilization_switch = 0; /* second tenant arrived: re-engage */
  CHECK(vtpu_util_try_acquire(r, 0, 30, 100000000ll) == 0); /* reset: 0
        tokens, not a burst, and not the old 10s debt either */
  CHECK(r->util_tokens_ns[0] <= 0);
  CHECK(r->util_tokens_ns[0] > -1000000000ll); /* old debt cleared */

  /* --- v4: inflight freshness — a stale heartbeat (dead process) must
   * not read as activity --- */
  vtpu_note_launch(r, me, 0);
  CHECK(vtpu_inflight(r, 0) == 1);
  CHECK(vtpu_inflight(r, 60000000000ll) == 1); /* fresh: just launched */
  /* backdate the heartbeat past the freshness window */
  for (int i = 0; i < VTPU_MAX_PROCS; i++)
    if (r->procs[i].pid == me) r->procs[i].last_seen_ns -= 120000000000ll;
  CHECK(vtpu_inflight(r, 60000000000ll) == 0); /* stale: ignored */
  CHECK(vtpu_inflight(r, 0) == 1);             /* unfiltered still sees it */
  vtpu_note_complete(r, me, 0, 0x1);

  /* --- v5: header checksum stamped at init+configure, verifiable, and
   * sensitive to exactly the static fields --- */
  CHECK(vtpu_region_header_ok(r));
  CHECK(r->header_checksum == vtpu_region_header_checksum(r));
  uint64_t stamped = r->header_checksum;
  r->hbm_limit[0] ^= 0x4; /* bit-flip a static header field */
  CHECK(!vtpu_region_header_ok(r));
  vtpu_region_header_restamp(r); /* legitimate rewrite path */
  CHECK(vtpu_region_header_ok(r));
  CHECK(r->header_checksum != stamped);
  r->hbm_limit[0] ^= 0x4;
  vtpu_region_header_restamp(r);
  CHECK(r->header_checksum == stamped); /* digest is deterministic */
  /* dynamic fields are excluded: usage/feedback churn must not unstamp */
  vtpu_note_launch(r, me, 0);
  vtpu_note_complete(r, me, 12345, 0x1);
  r->recent_kernel = VTPU_FEEDBACK_BLOCK;
  r->utilization_switch = 1;
  CHECK(vtpu_region_header_ok(r));

  /* --- v5: header heartbeat follows slot heartbeats and attach --- */
  int64_t hb0 = r->header_heartbeat_ns;
  CHECK(hb0 > 0); /* stamped at init */
  usleep(2000);
  vtpu_heartbeat(r, me);
  CHECK(r->header_heartbeat_ns > hb0);
  int64_t hb1 = r->header_heartbeat_ns;
  usleep(2000);
  CHECK(vtpu_region_attach(r, me + 1) >= 0);
  CHECK(r->header_heartbeat_ns > hb1);

  vtpu_region_close(r);
  unlink(path);
  CHECK(prof_main() == 0); /* v6 profile plane, on a fresh region */
  printf("region_test OK\n");
  return 0;
}
