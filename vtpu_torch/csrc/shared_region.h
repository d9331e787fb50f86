/* vTPU shared region — the cross-process quota/usage ABI.
 *
 * One mmap'd file per container (TPU_DEVICE_MEMORY_SHARED_CACHE) shared by
 * every process in the container plus the node monitor daemon. This is the
 * TPU-native analog of the reference's sharedRegionT (the CUDA intercept
 * library's control block, reverse-documented at
 * reference cmd/vGPUmonitor/cudevshr.go:42-58): versioned magic header,
 * process-shared lock, per-device limits, per-process usage slots, and the
 * monitor feedback fields (priority / recent_kernel / utilization_switch,
 * reference cmd/vGPUmonitor/feedback.go:197-255).
 *
 * Layout rules: fixed-size POD only, explicit sizes, no pointers — the
 * region is mapped at arbitrary addresses in unrelated processes. Fields
 * are 8-byte aligned by construction. Any layout change (append or
 * restructure) MUST bump VTPU_SHARED_VERSION: every consumer (the shim,
 * the C tests, the Python ctypes mirror in vtpu/enforce/region.py) gates
 * on magic+version and rejects foreign layouts, so a bump is a safe
 * flag-day, while a silent layout change is memory corruption.
 */

#ifndef VTPU_SHARED_REGION_H_
#define VTPU_SHARED_REGION_H_

#include <pthread.h>
#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

#define VTPU_SHARED_MAGIC 0x76545055u /* "vTPU" */
#define VTPU_SHARED_VERSION 8
/* Rolling-upgrade floor: leftover region files from ANY ABI in
 * [VTPU_SHARED_VERSION_MIN_COMPAT, VTPU_SHARED_VERSION) are legal
 * residue of a workload that started under the previous monitor/shim
 * pair (its mmap'd old libvtpu.so outlives the hostPath .so swap). A
 * newer monitor must SKIP them as transient — metrics dark until the
 * pod restarts — never durably quarantine them; anything older (or
 * newer, or garbage) is definitive corruption. The Python mirror
 * (vtpu/enforce/region.py) carries the same constant; vtpulint VTPU006
 * diffs them. */
#define VTPU_SHARED_VERSION_MIN_COMPAT 5
#define VTPU_MAX_DEVICES 16
#define VTPU_MAX_PROCS 64
#define VTPU_UUID_LEN 64

/* ---- v6 shim hot-path profile plane ------------------------------------
 *
 * Per-region, per-callsite-class latency histograms + monotonic counters
 * updated from the PJRT intercept hot path with RELAXED ATOMICS ONLY (no
 * lock, no syscall): the node monitor's existing sweep bulk-copies the
 * whole region, so the profile rides the same zero-LIST data plane as
 * the usage counters. Counter updates are batched in thread-local
 * accumulators and flushed on every sampled event / heartbeat / detach,
 * so the per-event cost on the charge path stays within the <=1%%
 * overhead budget (tests/test_shim_profile.py gates it).
 *
 * Latency buckets are log2: bucket b holds sampled events with
 * ns in [2^(MIN_SHIFT+b-1+1), 2^(MIN_SHIFT+b)) — concretely, bucket 0
 * is [0, 2^MIN_SHIFT) and the upper bound of bucket b is
 * 2^(MIN_SHIFT+b) ns; the last bucket is the overflow. The Python
 * renderer (vtpu/enforce/region.py prof_bucket_bounds) derives its
 * boundaries from the SAME constants; vtpulint VTPU006 diffs them and
 * tests/test_enforce.py cross-checks the C index function bit-for-bit. */
#define VTPU_PROF_BUCKETS 24
#define VTPU_PROF_BUCKET_MIN_SHIFT 7 /* bucket 0 < 128ns */
/* histogram timing is sampled 1-in-N per thread (VTPU_PROFILE_SAMPLE);
 * counters stay exact via the thread-local batch */
#define VTPU_PROF_SAMPLE_DEFAULT 64

/* intercepted callsite classes. EXECUTE measures the shim's dispatch-
 * side work around PJRT_LoadedExecutable_Execute excluding the real
 * plugin call; QUOTA_CHECK (the pre-launch quota gate + launch
 * throttle) is a component of it and is also measured on its own.
 * CHARGE/UNCHARGE are the shared-region accounting primitives nested
 * inside BUF_ALLOC/BUF_FREE/TRANSFER. */
#define VTPU_PROF_CS_BUF_ALLOC 0      /* BufferFromHostBuffer + friends */
#define VTPU_PROF_CS_BUF_FREE 1       /* Buffer_Destroy / _Delete */
#define VTPU_PROF_CS_CHARGE 2         /* vtpu_try_alloc / vtpu_force_alloc */
#define VTPU_PROF_CS_UNCHARGE 3       /* vtpu_free */
#define VTPU_PROF_CS_EXECUTE 4        /* Execute wrapper (shim side) */
#define VTPU_PROF_CS_TRANSFER 5       /* CopyToDevice/Memory + async H2D */
#define VTPU_PROF_CS_DONE_WITH_BUFFER 6 /* completion-event callback */
#define VTPU_PROF_CS_QUOTA_CHECK 7    /* pre-launch gate + throttle */
#define VTPU_PROF_CALLSITES 8

/* quota-pressure counters — the signals that explain why short-step
 * workloads tax (BENCH_MATRIX cases 1.1/2.2): how often the charge path
 * had to retry, how long launches spun at the quota/core limit, and how
 * many allocations failed with usage already near the cap. */
#define VTPU_PROF_PK_CHARGE_RETRIES 0     /* charge attach-retry round trips */
#define VTPU_PROF_PK_CONTENTION_SPINS 1   /* throttle/feedback wait iterations */
#define VTPU_PROF_PK_AT_LIMIT_NS 2        /* cumulative ns blocked at a limit */
#define VTPU_PROF_PK_NEAR_LIMIT_FAILURES 3 /* alloc failures at >=7/8 of limit */
/* v7: object-table inserts dropped on table-full (g_bufs stripes,
 * g_execs, g_temps, g_mgrs). Every drop means some bytes run
 * UNACCOUNTED for that object's lifetime (the charge is rolled back so
 * quota headroom is never stranded) — vtpuprof flags any nonzero count
 * instead of the loss hiding in a process-local counter. */
#define VTPU_PROF_PK_TABLE_DROPS 4
/* v8 host-memory pressure (the cooperative-offload ledger,
 * docs/adr-oversubscription.md): how often the host charge path
 * rejected an allocation already near the host cap, and how often a
 * post-hoc force charge pushed host usage OVER the cap (the signal the
 * monitor's clamp -> grace -> block escalation keys on). */
#define VTPU_PROF_PK_HOST_NEAR_LIMIT_FAILURES 5
#define VTPU_PROF_PK_HOST_OVER_EVENTS 6
#define VTPU_PROF_PRESSURE_KINDS 7

/* FNV-1a parameters of the header checksum (v5). Mirrored by the Python
 * monitor (vtpu/enforce/region.py) so both sides compute the identical
 * digest over the identical field bytes; vtpulint VTPU006 diffs them. */
#define VTPU_HEADER_CSUM_INIT 0xcbf29ce484222325
#define VTPU_HEADER_CSUM_PRIME 0x100000001b3

/* recent_kernel feedback states (reference feedback.go:227-252: the monitor
 * writes -1 to block low-priority tasks while a high-priority one runs). */
#define VTPU_FEEDBACK_BLOCK (-1)
#define VTPU_FEEDBACK_IDLE 0

/* utilization policy (reference GPU_CORE_UTILIZATION_POLICY,
 * docs/config.md:34-39: default = throttle only under contention,
 * force = always throttle, disable = never throttle). */
#define VTPU_UTIL_POLICY_DEFAULT 0
#define VTPU_UTIL_POLICY_FORCE 1
#define VTPU_UTIL_POLICY_DISABLE 2

/* minimum debt cap for the utilization buckets: short programs may bank
 * at most ~2s of payback; programs longer than that carry their full
 * measured duration (capped at VTPU_UTIL_DEBT_MULT x duration) so a 10s
 * training step under a 30% limit still pays back proportionally instead
 * of escaping the throttle (v4; v3 clamped every completion at 2s, which
 * let any program over ~2s defeat the limit) */
#define VTPU_UTIL_DEBT_FLOOR_NS 2000000000ll
#define VTPU_UTIL_DEBT_MULT 4

/* One callsite class's profile cell. All fields are u64 monotonic and
 * written with relaxed atomics only; readers (the monitor snapshot, a
 * concurrent scrape) tolerate torn cross-field views the same way they
 * do for the usage slots. `sampled`/`total_ns`/`hist` cover only the
 * 1-in-N latency-sampled events; `calls`/`errors`/`bytes` are exact.
 * Estimated total shim time for the class =
 * total_ns * calls / sampled. */
typedef struct vtpu_prof_callsite {
  uint64_t calls;
  uint64_t errors;
  uint64_t bytes;    /* bytes charged (alloc paths) / released (free) */
  uint64_t sampled;  /* events with a latency measurement */
  uint64_t total_ns; /* sum of sampled latencies */
  uint64_t hist[VTPU_PROF_BUCKETS];
} vtpu_prof_callsite_t;

typedef struct vtpu_proc_slot {
  int32_t pid;                 /* 0 = slot free */
  int32_t status;              /* 1 = attached */
  uint64_t hbm_used[VTPU_MAX_DEVICES];   /* bytes, by visible-device index */
  uint64_t launches;           /* programs dispatched since attach */
  uint64_t launch_ns;          /* cumulative measured device-busy ns */
  int64_t last_seen_ns;        /* CLOCK_MONOTONIC heartbeat */
  int32_t inflight;            /* programs dispatched, not yet complete —
                                * the feedback loop reads this so a single
                                * multi-second program still blocks
                                * lower-priority tenants (v3) */
  int32_t reserved1;
  /* v8 host-memory ledger: bytes of PJRT host-memory-space buffers
   * ("pinned_host"/"unpinned_host" placements — cooperative offload)
   * charged by this process. Node-level, not per-device: host RAM is
   * one pool per container. Mutated ONLY inside the region critical
   * section by the vtpu_host_* primitives (vtpulint VTPU014). */
  uint64_t host_used;
} vtpu_proc_slot_t;

typedef struct vtpu_shared_region {
  uint32_t magic;
  uint32_t version;
  int32_t initialized;         /* set once under init file-lock */
  int32_t owner_pid;           /* pid that initialized the region */

  pthread_mutex_t lock;        /* PTHREAD_PROCESS_SHARED + ROBUST */

  int32_t num_devices;
  int32_t priority;            /* container task priority (0 = high) */

  /* limits written once by the first process from its env
   * (TPU_DEVICE_MEMORY_LIMIT[_i] / TPU_DEVICE_TENSORCORE_LIMIT) */
  uint64_t hbm_limit[VTPU_MAX_DEVICES];     /* bytes; 0 = unlimited */
  uint32_t core_limit[VTPU_MAX_DEVICES];    /* tensorcore %%; 0 = unlimited */

  /* monitor feedback plane */
  int32_t recent_kernel;       /* VTPU_FEEDBACK_BLOCK blocks launches */
  int32_t utilization_switch;  /* 0 = throttler on, 1 = forced off */
  int32_t util_policy;         /* VTPU_UTIL_POLICY_*; written at configure */
  int32_t reserved0;

  uint64_t oom_events;         /* rejected allocations (observability) */

  /* monotonic container-lifetime launch count: never decremented, survives
   * process restarts (per-slot counters reset on detach; consumers needing
   * rates must use this one) */
  uint64_t total_launches;

  /* physical chip UUIDs by visible-device index (from TPU_VISIBLE_DEVICES
   * at configure time) so the monitor can group containers by the chip
   * they actually share — feedback blocking is per chip, not per node */
  char dev_uuid[VTPU_MAX_DEVICES][VTPU_UUID_LEN];

  vtpu_proc_slot_t procs[VTPU_MAX_PROCS];

  /* PER-DEVICE device-time token buckets (v4; v3 had one container-wide
   * bucket drawn against core_limit[0], so a multi-device container's
   * whole budget rode device 0's percentage). The core_limit[d]%% budget
   * is shared by every process in the container but throttles each
   * device independently. Refilled at core_limit[d]%% of wall time,
   * debited with each program's measured duration on completion for
   * every device the program addressed (may go negative = debt;
   * launches wait until the refill clears it). The reference's analog
   * is the per-container utilization watcher in libvgpu.so
   * (init_utilization_watcher / get_used_gpu_utilization) enforcing
   * per-device CUDA_DEVICE_SM_LIMIT. */
  int64_t util_tokens_ns[VTPU_MAX_DEVICES];
  int64_t util_refill_ns[VTPU_MAX_DEVICES]; /* CLOCK_MONOTONIC of refill */

  /* last utilization_switch value seen by the bucket code; a 1->0 edge
   * (monitor re-engages the throttle, e.g. a second tenant arrived)
   * resets the buckets so credit/debt banked while unthrottled cannot
   * leak into the throttled regime */
  int32_t util_prev_switch;
  /* libvgpu.so: devices of the container's processes whose footprint it
   * does not re-read (NVML unavailable, or unable to tell the process
   * apart), counted at each one's first context; the JAX shim leaves it 0.
   * The name stays, so the layout and field names match the JAX ABI. */
  int32_t reserved2;

  /* v5 header-integrity plane: the host monitor mmaps region files it
   * did not create and must tell a live region from a torn, truncated,
   * bit-flipped, or foreign file without ever crashing a sweep.
   *
   * header_checksum: FNV-1a (VTPU_HEADER_CSUM_INIT/PRIME) over the
   * STATIC header fields in declaration order — magic, version,
   * num_devices, priority, hbm_limit[], core_limit[], util_policy,
   * dev_uuid[] — stamped at init and re-stamped under the lock whenever
   * one of them is legitimately written (configure; the monitor-side
   * limit override restamps from Python). Dynamic fields (usage slots,
   * feedback plane, token buckets) are deliberately excluded: they
   * change on the hot path and the monitor tolerates torn reads there.
   *
   * header_heartbeat_ns: CLOCK_MONOTONIC, bumped by the shim's 5s
   * heartbeat thread alongside the per-slot heartbeats, so the monitor
   * can report a region whose whole shim went silent (not just one
   * process slot). */
  uint64_t header_checksum;
  int64_t header_heartbeat_ns;

  /* v6 profile plane (see the VTPU_PROF_* block above). Dynamic fields:
   * deliberately OUTSIDE the header checksum — a torn or even garbage
   * profile block must never quarantine an otherwise-valid region
   * (tests/test_monitor.py pins this). prof_enabled/prof_sample record
   * the first-configuring shim's effective settings so readers can
   * label the data; the authoritative knob is each process's own
   * VTPU_PROFILE / VTPU_PROFILE_SAMPLE env. */
  uint32_t prof_enabled;
  uint32_t prof_sample;
  vtpu_prof_callsite_t prof_cs[VTPU_PROF_CALLSITES];
  uint64_t prof_pressure[VTPU_PROF_PRESSURE_KINDS];

  /* v7 lock-free launch-gate plane. The Execute wrapper used to take
   * the region lock and sum all 64 proc slots on EVERY launch — ~60% of
   * shim time on the short-step bench cases (docs/shim-profile-report).
   * Instead the lock holders maintain, next to the per-slot ground
   * truth, a per-device aggregate and a monotonically increasing epoch:
   *
   *   hbm_used_agg[d]  == sum of hbm_used[d] over live slots, updated
   *                       inside the same critical section as every
   *                       slot mutation (try/force_alloc, free, detach,
   *                       gc), stored with relaxed atomics;
   *   usage_epoch      bumped once per usage mutation.
   *
   * Lock-free readers (the shim's launch gate) snapshot the aggregate
   * with relaxed loads and re-read only when the epoch moved; when
   * usage sits within a configurable margin of the limit they fall back
   * to the LOCKED slot sweep, so the gate is never stale at the quota
   * boundary (docs/shim-profiling.md "hot-path design"). EOWNERDEAD
   * recovery recomputes the aggregate from the slots. */
  uint64_t usage_epoch;
  uint64_t hbm_used_agg[VTPU_MAX_DEVICES];

  /* v8 host-memory ledger (docs/adr-oversubscription.md closing note:
   * the cooperative-offload dimension the ADR promised). One pool per
   * container, not per device:
   *
   *   host_limit     bytes; 0 = unlimited (the documented migration
   *                  default for legacy pods with no host-memory
   *                  annotation). STATIC header field: covered by the
   *                  v5 checksum, written at configure_host / the
   *                  checked setter only.
   *   host_used_agg  sum of host_used over live slots, maintained with
   *                  relaxed atomics inside every host-usage critical
   *                  section (the v7 gate-plane discipline; EOWNERDEAD
   *                  recovery rebuilds it from the slots).
   *   host_oom_events  host allocations rejected, plus force charges
   *                  that pushed usage over the cap (observability). */
  uint64_t host_limit;
  uint64_t host_used_agg;
  uint64_t host_oom_events;
} vtpu_shared_region_t;

/* ---- lifecycle ---------------------------------------------------------- */

/* Open (creating + initializing if needed) the region file at `path`.
 * Initialization is serialized with an flock on `path` so concurrent first
 * processes race safely. Returns NULL on error (errno set). */
vtpu_shared_region_t *vtpu_region_open(const char *path);

/* Unmap (does not delete the backing file; the file is the persistent
 * usage state for the container's lifetime — reference SURVEY §5.4). */
void vtpu_region_close(vtpu_shared_region_t *r);

/* ---- configuration ------------------------------------------------------ */

/* Set device count and per-device limits if not already configured.
 * First writer wins; later calls are no-ops (idempotent across procs). */
/* `dev_uuids` may be NULL or an array of num_devices NUL-terminated chip
 * UUIDs (truncated to VTPU_UUID_LEN-1). */
int vtpu_region_configure(vtpu_shared_region_t *r, int num_devices,
                          const uint64_t *hbm_limit,
                          const uint32_t *core_limit, int priority,
                          int util_policy,
                          const char *const *dev_uuids);

/* ---- per-process slots -------------------------------------------------- */

/* Claim a slot for `pid` (reuses a dead pid's slot after GC). Returns slot
 * index or -1 when the table is full. */
int vtpu_region_attach(vtpu_shared_region_t *r, int32_t pid);
int vtpu_region_detach(vtpu_shared_region_t *r, int32_t pid);

/* Reclaim slots whose pid no longer exists (kill(pid,0) probe). Returns
 * number of slots reclaimed. MUST be called from inside the container's
 * pid namespace, where kill(pid,0) probes the right processes: the shim
 * calls it on attach (so a SIGKILLed predecessor — e.g. the
 * ACTIVE_OOM_KILLER path — can't leave phantom usage that crash-loops
 * every successor) and the in-container heartbeat repeats it. The
 * host-side monitor must NOT call this (foreign pid namespace = wrong
 * liveness answer); it GCs whole pod dirs instead. */
int vtpu_region_gc(vtpu_shared_region_t *r);

/* ---- accounting (the per-allocation hot path) --------------------------- */

/* Try to charge `bytes` on device `dev` for `pid`. Returns 0 on success,
 * -1 when the charge would exceed hbm_limit[dev] (the OOM-before-real-OOM
 * check, reference libvgpu.so oom_check). */
int vtpu_try_alloc(vtpu_shared_region_t *r, int32_t pid, int dev,
                   uint64_t bytes);

/* Charge unconditionally (used for memory the runtime has already
 * materialized, e.g. program outputs discovered post-launch: usage must
 * reflect reality even when it breaches the limit, so the next pre-launch
 * gate trips). Increments oom_events when the result exceeds the limit. */
void vtpu_force_alloc(vtpu_shared_region_t *r, int32_t pid, int dev,
                      uint64_t bytes);

void vtpu_free(vtpu_shared_region_t *r, int32_t pid, int dev,
               uint64_t bytes);

/* Total bytes in use on `dev` summed over live slots. */
uint64_t vtpu_region_used(vtpu_shared_region_t *r, int dev);

/* All per-device totals in one lock acquisition — the exact slot sweep
 * (ground truth). The launch gate uses this only at the quota boundary;
 * its fast path reads the v7 aggregate below. */
void vtpu_region_used_all(vtpu_shared_region_t *r,
                          uint64_t out[VTPU_MAX_DEVICES]);

/* ---- v8 host-memory ledger ----------------------------------------------
 *
 * The cooperative-offload quota dimension: PJRT host-memory-space
 * placements ("pinned_host"/"unpinned_host") charge HERE instead of
 * charging zero bytes against nothing. Same shape as the HBM
 * primitives, minus the device axis (host RAM is one per-container
 * pool). These functions — plus vtpu_region_set_host_limit_checked —
 * are the ONLY legal writers of host_used / host_used_agg /
 * host_limit (vtpulint VTPU014). */

/* First-writer-wins host limit (bytes; 0 = unlimited). Restamps the v5
 * header checksum (host_limit is a static header field). */
int vtpu_region_configure_host(vtpu_shared_region_t *r,
                               uint64_t host_limit);

/* Try to charge `bytes` of host memory for `pid`. 0 on success, -1
 * with errno=ENOMEM when the charge would exceed host_limit (the
 * OOM-before-kernel-OOM check: the offender gets a PJRT error, the
 * node's other tenants never meet the kernel OOM killer), -1 with
 * errno=ENOENT when the pid has no slot (attach first). */
int vtpu_host_try_alloc(vtpu_shared_region_t *r, int32_t pid,
                        uint64_t bytes);

/* Charge unconditionally (memory the runtime already materialized).
 * Bumps host_oom_events + the host-over pressure counter when the
 * result exceeds the limit — the monitor's clamp/grace/block signal. */
void vtpu_host_force_alloc(vtpu_shared_region_t *r, int32_t pid,
                           uint64_t bytes);

void vtpu_host_free(vtpu_shared_region_t *r, int32_t pid,
                    uint64_t bytes);

/* Exact host bytes in use (locked slot sweep — ground truth). */
uint64_t vtpu_region_host_used(vtpu_shared_region_t *r);

/* Host usage from the v8 aggregate: one relaxed load, NO lock. */
uint64_t vtpu_region_host_used_fast(vtpu_shared_region_t *r);

/* Checked host-limit rewrite (the monitor's live-resize surface, twin
 * of vtpu_region_set_limit_checked): under the region lock a shrink
 * below live host usage CLAMPS to the usage (returns 1; `used > limit`
 * is never observable), an applicable target stores exactly (returns
 * 0); restamps the v5 checksum and bumps the usage epoch inside the
 * same critical section. */
int vtpu_region_set_host_limit_checked(vtpu_shared_region_t *r,
                                       uint64_t new_limit,
                                       uint64_t *applied);

/* ---- v7 lock-free gate plane -------------------------------------------- */

/* Monotonic usage epoch: bumped (under the lock, readable with a relaxed
 * load) on every charge/uncharge/detach/gc. A gate that cached usage at
 * epoch E may reuse its snapshot while the epoch still reads E. */
uint64_t vtpu_region_usage_epoch(vtpu_shared_region_t *r);

/* Per-device usage totals from the v7 aggregate: relaxed atomic loads,
 * NO lock. Exact whenever the lock is quiescent (the aggregate is
 * maintained inside every usage critical section); concurrent mutators
 * make it at most one in-flight mutation stale — callers needing
 * boundary-exact numbers take vtpu_region_used_all instead. */
void vtpu_region_used_fast(vtpu_shared_region_t *r,
                           uint64_t out[VTPU_MAX_DEVICES]);

/* Batched vtpu_force_alloc: charge add[d] bytes on every device in one
 * lock acquisition (the Execute wrapper's post-hoc output accounting
 * used to take the region lock once per output buffer). Zero entries
 * are skipped; oom_events bumps once per breached device. */
void vtpu_force_alloc_bulk(vtpu_shared_region_t *r, int32_t pid,
                           const uint64_t add[VTPU_MAX_DEVICES]);

/* Record one program launch of estimated duration `est_ns` for `pid`.
 * Also marks the program in-flight (slot.inflight++) until
 * vtpu_note_complete. */
void vtpu_note_launch(vtpu_shared_region_t *r, int32_t pid, uint64_t est_ns);

/* Record completion of a launch: adds the measured device-busy `ns` to the
 * slot's launch_ns, clears one in-flight mark, and debits the utilization
 * token bucket of every device in `dev_mask` (bit d = visible device d;
 * 0 means device 0). Debt is capped at
 * max(VTPU_UTIL_DEBT_FLOOR_NS, VTPU_UTIL_DEBT_MULT * ns). */
void vtpu_note_complete(vtpu_shared_region_t *r, int32_t pid, uint64_t ns,
                        uint32_t dev_mask);

/* Port only: publish a batch of launches and measured completions in one
 * lock acquisition (see shared_region.c). */
void vtpu_note_batch(vtpu_shared_region_t *r, int32_t pid, uint64_t launches,
                     int32_t inflight,
                     const uint64_t debit_ns[VTPU_MAX_DEVICES]);

/* Sum of in-flight programs over live slots whose heartbeat is fresher
 * than `max_age_ns` (0 = no freshness filter). A SIGKILLed process can
 * leave inflight > 0 forever; consumers treating inflight as activity
 * must pass a freshness window of a few heartbeat periods (the shim
 * heartbeats every 5s). */
int32_t vtpu_inflight(vtpu_shared_region_t *r, int64_t max_age_ns);

/* Utilization throttle: refill device `dev`'s token bucket at
 * `limit_pct`%% of wall time (capped at `burst_ns` of accumulated credit)
 * and report whether a launch may proceed (tokens > 0). Debt from
 * completed programs (vtpu_note_complete) makes this return 0 until the
 * refill clears it. Always 1 while utilization_switch is set. */
int vtpu_util_try_acquire(vtpu_shared_region_t *r, int dev,
                          uint32_t limit_pct, int64_t burst_ns);

/* Debit `ns` of device time from the buckets of every device in
 * `dev_mask` WITHOUT touching any process slot (no inflight/launch_ns
 * bookkeeping). Used by the shim's sampled synchronous cost probe on
 * backends whose completion events fire before the work actually runs
 * (relayed PJRT): the probe's measured span covers a whole batch of
 * queued programs and is charged in one call. Same debt cap rule as
 * vtpu_note_complete. */
void vtpu_util_debit(vtpu_shared_region_t *r, uint32_t dev_mask,
                     uint64_t ns);

/* Heartbeat `pid`'s slot (monitor staleness detection). Also bumps the
 * v5 header heartbeat, so a region with ANY live shim process carries a
 * fresh header_heartbeat_ns. */
void vtpu_heartbeat(vtpu_shared_region_t *r, int32_t pid);

/* ---- v7.1 checked live-resize (elastic quotas, docs/elastic-quotas.md) --
 *
 * The monitor may legally rewrite a live region's hbm_limit (the
 * reference's vGPUmonitor write-back channel); the raw field poke the
 * Python RegionView used to do made "never shrink below live usage" a
 * CONVENTION callers had to remember. This call makes it a property of
 * the region layer: under the region lock it reads the exact usage
 * aggregate and
 *
 *   - applies `new_limit` exactly when it is 0 (unlimited) or covers
 *     the live usage (returns 0);
 *   - CLAMPS a shrink below live usage to the usage itself (returns 1)
 *     — `used > limit` is never observable to the launch gate or the
 *     charge path, not even for one instruction;
 *
 * then restamps the v5 header checksum (hbm_limit is a static header
 * field) and bumps the v7 usage epoch, so every thread's cached gate
 * snapshot refreshes on its next launch: the new limit is
 * authoritative within ONE gate epoch. VTPU_GATE_MARGIN_PCT interplay:
 * a shrink lands usage inside the margin of the new limit by
 * construction, so the very next gate check takes the LOCKED exact
 * sweep — the epoch-cached fast path can never admit a launch against
 * the old, larger limit. `*applied` (may be NULL) receives the limit
 * actually stored. Returns -1/EINVAL on a bad region/device. */
int vtpu_region_set_limit_checked(vtpu_shared_region_t *r, int dev,
                                  uint64_t new_limit, uint64_t *applied);

/* ---- v5 header integrity ------------------------------------------------ */

/* FNV-1a digest over the static header fields (see header_checksum).
 * Pure read; callers comparing against header_checksum under concurrent
 * configure must tolerate one transient mismatch (the quarantine logic
 * requires consecutive failures). */
uint64_t vtpu_region_header_checksum(const vtpu_shared_region_t *r);

/* Recompute + store the checksum (lock taken inside). For tools that
 * legitimately rewrite a static header field after configure. */
void vtpu_region_header_restamp(vtpu_shared_region_t *r);

/* 1 when the stored checksum matches a recomputation, else 0. */
int vtpu_region_header_ok(const vtpu_shared_region_t *r);

/* ---- v6 hot-path profiling ---------------------------------------------
 *
 * Usage pattern (the PJRT wrappers and the accounting primitives):
 *
 *   int64_t t0 = vtpu_prof_enter();          // -1 off, 0 count-only,
 *                                            // >0 sampled (t0 = now)
 *   ... do the work ...
 *   vtpu_prof_note(r, VTPU_PROF_CS_X, t0, exclude_ns, bytes, err);
 *
 * enter/note are zero-syscall and lock-free: counters accumulate in a
 * thread-local batch, flushed into the region with relaxed atomic adds
 * on every sampled event (and from vtpu_heartbeat / vtpu_region_detach,
 * so the monitor's view is never staler than one heartbeat + N events).
 * `exclude_ns` subtracts a nested real-plugin span so a callsite
 * measures the SHIM's cost, not the backend's. */

/* Process-wide profiling config. Defaults from the env on first use:
 * VTPU_PROFILE (default 1; 0 disables everything) and
 * VTPU_PROFILE_SAMPLE (default VTPU_PROF_SAMPLE_DEFAULT; latency
 * sampling period, >=1). Tests and benches override explicitly. */
void vtpu_prof_configure(int enabled, int sample_every);
int vtpu_prof_enabled(void);

int64_t vtpu_prof_enter(void);
void vtpu_prof_note(vtpu_shared_region_t *r, int cs, int64_t t0,
                    int64_t exclude_ns, uint64_t bytes, int err);

/* Quota-pressure counters (VTPU_PROF_PK_*): rare events, added with one
 * relaxed atomic directly (no batching). */
void vtpu_prof_pressure_add(vtpu_shared_region_t *r, int kind,
                            uint64_t delta);

/* Drain this thread's batched counters into `r`; returns the number of
 * callsite cells flushed. Bounded loss without it: at most one batch
 * (sample period) per thread at exit. */
int vtpu_prof_flush(vtpu_shared_region_t *r);

/* log2 bucket index for a sampled latency (exposed so the Python
 * renderer can be cross-checked bit-for-bit against the C binning). */
int vtpu_prof_bucket_index(uint64_t ns);

/* ABI guard for out-of-process mirrors (the Python monitor's ctypes view
 * asserts its struct matches this). */
size_t vtpu_region_sizeof(void);

#ifdef __cplusplus
}
#endif

#endif /* VTPU_SHARED_REGION_H_ */
