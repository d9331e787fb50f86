/* interposer_test — libvgpu.so driven on the mock driver (mock_cuda.c,
 * mock_nvml.c), the port's counterpart of lib/vtpu/test/shim_test.c.
 *
 * The interposer is dlopen()ed with RTLD_LOCAL and its exported cu* hooks
 * are called directly (as shim_test.c loads libvtpu.so): never preloaded,
 * since libvgpu.so defines dlsym, and a sanitizer runtime resolves its own
 * interceptors through dlsym(RTLD_NEXT, ...). The mock libcuda.so.1 and
 * libnvidia-ml.so.1 are found on LD_LIBRARY_PATH. Each mode makes its own
 * directory under $TMPDIR (else /tmp) for the region file, the node's lock
 * directory (VGPU_LOCK_DIR, never /tmp/vgpulock) and the mock NVML's
 * fixture (one card, the mock's device 0) and process list, sets the env
 * the device plugin would before the interposer reads it, and removes the
 * directory at the end.
 *
 * Modes (argv[1]; each prints "interposer_test <mode> OK"):
 *   (none)     a quota-limited process's sequence: its context and
 *              footprint, allocations up to the quota, the quota view,
 *              launches, a copy, frees;
 *   churn [SM] 8 threads, each on its own stream, mixing allocations and
 *              frees, stream-ordered ones on the device pool with trims,
 *              physical handles, pinned host memory under a host limit,
 *              copies and launches timed by events, at CUDA_DEVICE_SM_LIMIT
 *              SM (brackets) or with no limit (spans); every thread
 *              resolves its entry points through cuGetProcAddress_v2 and
 *              makes its first calls at once. At quiesce the region holds
 *              the footprint charge exactly, its lock-free and locked sums
 *              agree, the host ledger is 0, nothing was dropped from a
 *              table, nothing is in flight, every charge of the spans
 *              reached the region, the profile counted every call;
 *   tabledrop  an allocation table filled to its capacity: the next
 *              allocation is freed and refused with
 *              CUDA_ERROR_OUT_OF_MEMORY, its charge rolled back, the drop
 *              counted, and the quota view and the driver recover;
 *   hostquota  the host ledger through cuMemHostAlloc, cuMemAllocHost_v2,
 *              cuMemHostRegister_v2 and host-located cuMemCreate under
 *              CUDA_HOST_MEMORY_LIMIT;
 *   codeload   8 threads, each loading a module, looking its function up,
 *              launching it and unloading the module 400 times, where NVML
 *              lists every process as one (CONTEXT mode) and the mock
 *              driver hands a freed module's handle to the next load: every
 *              load, look-up and first launch is measured, every unload
 *              gives back what its module was charged, and at quiesce the
 *              region holds the context's charge exactly;
 *   profbench  the deployed charge path (cuMemAlloc_v2 + cuMemFree_v2
 *              through the interposer), a launch and a copy, profile off
 *              against on, the minimum over attempts, and the profile
 *              hooks' own unit cost: one JSON line with shim_test's keys.
 *
 * Built plain, with ASan+UBSan and with TSan by vtpu_torch/native.py
 * (each set's libvgpu.so beside it: LIBVGPU_SO names it); run by
 * tests/test_torch_native_plane.py.
 */

#define _GNU_SOURCE
#include <dlfcn.h>
#include <errno.h>
#include <ftw.h>
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

#include "../cuda_min.h"
#include "../prof_hook.h"
#include "../shared_region.h"

#define CHECK(cond)                                                       \
  do {                                                                    \
    if (!(cond)) {                                                        \
      fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond);     \
      exit(1);                                                            \
    }                                                                     \
  } while (0)

#define MiB (1ull << 20)

/* libvgpu.so's own exports */
void vgpu_footprint(int dev, uint64_t out[8]);
void vgpu_footprint_launches(uint64_t out[6]);
void vgpu_code_memory(uint64_t out[8]);
void vgpu_flush_launches(void);
int vgpu_span_stream(CUstream s, uint64_t out[3]);
/* the mock driver's counters */
unsigned long mock_cuda_copy_calls(const char *symbol);
unsigned long mock_cuda_launches(void);
unsigned long mock_cuda_host_calls(void);
unsigned long mock_cuda_code_live(void);

static void *g_vg; /* libvgpu.so */
static void *g_cu; /* the mock libcuda.so.1 */
static char g_dir[4096], g_cache[4200];

static void *sym(void *h, const char *name) {
  void *p = dlsym(h, name);
  if (!p) {
    fprintf(stderr, "FAIL: no symbol %s\n", name);
    exit(1);
  }
  return p;
}

/* an export of libvgpu.so, or of the mock driver, at its declared type */
#define VG(fn) ((__typeof__(&fn))sym(g_vg, #fn))
#define CU(fn) ((__typeof__(&fn))sym(g_cu, #fn))

static int64_t now_ns(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000000000ll + ts.tv_nsec;
}

static void write_file(const char *path, const char *text) {
  FILE *f = fopen(path, "w");
  CHECK(f != NULL);
  fputs(text, f);
  CHECK(fclose(f) == 0);
}

/* The mode's directory and env, before the interposer reads it: the
 * region, the lock directory, and with `nvml` the mock NVML's fixture and
 * process list and a context of ctx_mib on the mock driver. */
static void setup(const char *mode, int nvml, int ctx_mib) {
  const char *tmp = getenv("TMPDIR");
  snprintf(g_dir, sizeof(g_dir), "%s/vgpu_interposer_%s_XXXXXX",
           tmp && *tmp ? tmp : "/tmp", mode);
  CHECK(mkdtemp(g_dir) != NULL);
  char path[4300];
  snprintf(g_cache, sizeof(g_cache), "%s/vgpu.cache", g_dir);
  setenv("CUDA_DEVICE_MEMORY_SHARED_CACHE", g_cache, 1);
  snprintf(path, sizeof(path), "%s/locks", g_dir);
  CHECK(mkdir(path, 0700) == 0);
  setenv("VGPU_LOCK_DIR", path, 1);
  if (!getenv("LIBCUDA_LOG_LEVEL")) setenv("LIBCUDA_LOG_LEVEL", "0", 1);
  unsetenv("MOCK_GPU_PROCS_SHARED");
  unsetenv("MOCK_GPU_PID_OFFSET");
  if (nvml) {
    snprintf(path, sizeof(path), "%s/cards.json", g_dir);
    write_file(path,
               "{\"gpus\": [{\"uuid\": "
               "\"GPU-00000000-0000-0000-0000-000000000000\", "
               "\"name\": \"NVIDIA H100 80GB HBM3\", \"memory_mb\": 81559, "
               "\"minor\": 0}]}\n");
    setenv("MOCK_NVML_FIXTURE", path, 1);
    snprintf(path, sizeof(path), "%s/procs", g_dir);
    CHECK(mkdir(path, 0700) == 0);
    setenv("MOCK_GPU_PROCS", path, 1);
    char bytes[32];
    snprintf(bytes, sizeof(bytes), "%dm", ctx_mib);
    setenv("MOCK_CUDA_CTX_BYTES", bytes, 1);
  } else {
    unsetenv("MOCK_NVML_FIXTURE");
    unsetenv("MOCK_GPU_PROCS");
    unsetenv("MOCK_CUDA_CTX_BYTES");
  }
}

static void load(void) {
  g_cu = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
  if (!g_cu) {
    fprintf(stderr, "dlopen libcuda.so.1: %s\n", dlerror());
    exit(1);
  }
  const char *so = getenv("LIBVGPU_SO");
  g_vg = dlopen(so && *so ? so : "./libvgpu.so", RTLD_NOW | RTLD_LOCAL);
  if (!g_vg) {
    fprintf(stderr, "dlopen libvgpu.so: %s\n", dlerror());
    exit(1);
  }
}

static int rm_entry(const char *path, const struct stat *st, int flag,
                    struct FTW *ftw) {
  (void)st, (void)flag, (void)ftw;
  remove(path);
  return 0;
}

static void cleanup(void) {
  nftw(g_dir, rm_entry, 16, FTW_DEPTH | FTW_PHYS);
}

/* the monitor's view of the mode's region (this harness's own copy of
 * shared_region.c, as the node monitor reads it) */
static vtpu_shared_region_t *region(void) {
  vtpu_shared_region_t *r = vtpu_region_open(g_cache);
  CHECK(r != NULL);
  return r;
}

static uint64_t footprint_charge(uint64_t *mode) {
  uint64_t fp[8];
  VG(vgpu_footprint)(0, fp);
  if (mode) *mode = fp[0];
  return fp[2];
}

/* the footprint's next re-read (every 100 ms, on the heartbeat thread) */
static void await_refresh(void) {
  uint64_t fp[8], reads;
  VG(vgpu_footprint)(0, fp);
  reads = fp[3];
  for (int i = 0; i < 300 && fp[3] < reads + 2; i++) {
    usleep(10000);
    VG(vgpu_footprint)(0, fp);
  }
  CHECK(fp[3] >= reads + 2);
}

/* ------------------------------------------------------------- default */

static int smoke_main(void) {
  setup("smoke", 1, 32);
  setenv("CUDA_DEVICE_MEMORY_LIMIT", "256m", 1);
  load();
  CUcontext ctx = NULL;
  CHECK(VG(cuDevicePrimaryCtxRetain)(&ctx, 0) == CUDA_SUCCESS);
  uint64_t mode = 0;
  CHECK(footprint_charge(&mode) == 32 * MiB);
  CHECK(mode == 2); /* NVML lists this process: its pid's memory */

  /* the quota view: the limit, less the context, is what the pod sees */
  size_t fr = 0, tot = 0;
  CHECK(VG(cuMemGetInfo_v2)(&fr, &tot) == CUDA_SUCCESS);
  CHECK(tot == 256 * MiB && fr == 224 * MiB);

  /* 16 MiB allocations until the interposer refuses one */
  CUdeviceptr held[32];
  int n = 0;
  CUresult rc;
  while ((rc = VG(cuMemAlloc_v2)(&held[n], 16 * MiB)) == CUDA_SUCCESS)
    CHECK(++n < 32);
  CHECK(rc == CUDA_ERROR_OUT_OF_MEMORY && n == 14);
  vtpu_shared_region_t *r = region();
  CHECK(vtpu_region_used(r, 0) == 32 * MiB + 14 * 16 * MiB);
  CHECK(VG(cuMemGetInfo_v2)(&fr, &tot) == CUDA_SUCCESS && fr == 0);

  /* a launch at the limit is refused by the gate; after a free it runs */
  CHECK(VG(cuLaunchKernel)(NULL, 1, 1, 1, 1, 1, 1, 0, NULL, NULL, NULL) ==
        CUDA_ERROR_OUT_OF_MEMORY);
  CHECK(VG(cuMemFree_v2)(held[--n]) == CUDA_SUCCESS);
  unsigned long launched = CU(mock_cuda_launches)();
  for (int i = 0; i < 10; i++)
    CHECK(VG(cuLaunchKernel)(NULL, 1, 1, 1, 1, 1, 1, 0, NULL, NULL, NULL) ==
          CUDA_SUCCESS);
  CHECK(VG(cuStreamSynchronize)(NULL) == CUDA_SUCCESS);
  CHECK(CU(mock_cuda_launches)() == launched + 10);

  /* a copy moves bytes, never charges them */
  static char host[4096];
  uint64_t before = vtpu_region_used(r, 0);
  CHECK(VG(cuMemcpyHtoD_v2)(held[0], host, sizeof(host)) == CUDA_SUCCESS);
  CHECK(VG(cuMemcpyDtoH_v2)(host, held[0], sizeof(host)) == CUDA_SUCCESS);
  CHECK(vtpu_region_used(r, 0) == before);
  CHECK(CU(mock_cuda_copy_calls)("cuMemcpyHtoD_v2") == 1);

  while (n) CHECK(VG(cuMemFree_v2)(held[--n]) == CUDA_SUCCESS);
  CHECK(vtpu_region_used(r, 0) == 32 * MiB);
  CHECK(VG(cuMemGetInfo_v2)(&fr, &tot) == CUDA_SUCCESS && fr == 224 * MiB);
  VG(vgpu_flush_launches)();
  CHECK(r->total_launches == 10);
  CHECK(vtpu_region_header_ok(r));
  vtpu_region_close(r);
  cleanup();
  printf("interposer_test OK\n");
  return 0;
}

/* --------------------------------------------------------------- churn */

#define CHURN_THREADS 8
#define CHURN_ITERS 400
#define CHURN_KERNEL_NS "20000" /* a launch of 1 block runs 20 us */

typedef CUresult (*gpa2_fn)(const char *, void **, int, cuuint64_t,
                            CUdriverProcAddressQueryResult *);

/* the entry points a thread resolves for itself */
typedef struct {
  __typeof__(&cuDevicePrimaryCtxRetain) retain;
  __typeof__(&cuMemAlloc_v2) alloc;
  __typeof__(&cuMemFree_v2) free;
  __typeof__(&cuMemAllocAsync) alloc_async;
  __typeof__(&cuMemFreeAsync) free_async;
  __typeof__(&cuMemPoolTrimTo) trim;
  __typeof__(&cuMemCreate) create;
  __typeof__(&cuMemRelease) release;
  __typeof__(&cuMemHostAlloc) host_alloc;
  __typeof__(&cuMemFreeHost) free_host;
  __typeof__(&cuLaunchKernel) launch;
  __typeof__(&cuMemcpyHtoDAsync_v2) copy;
  __typeof__(&cuStreamSynchronize) sync;
} churn_api_t;

static int g_churning = CHURN_THREADS; /* threads still running */

typedef struct {
  pthread_barrier_t *go;
  CUstream stream;
  CUmemoryPool pool;
  unsigned long allocs, frees, launches, copies, copy_errors;
  uint64_t alloc_bytes, copy_bytes;
  int failures;
} churn_ctx_t;

static void *resolve(gpa2_fn gpa, const char *base) {
  void *p = NULL;
  CUdriverProcAddressQueryResult st = CU_GET_PROC_ADDRESS_SYMBOL_NOT_FOUND;
  CHECK(gpa(base, &p, 12080, 0, &st) == CUDA_SUCCESS);
  CHECK(st == CU_GET_PROC_ADDRESS_SUCCESS && p != NULL);
  return p;
}

#define FAIL_IF(c, cond)                                         \
  do {                                                           \
    if (cond) __atomic_fetch_add(&(c)->failures, 1, __ATOMIC_RELAXED); \
  } while (0)

static void *churn_thread(void *arg) {
  churn_ctx_t *c = arg;
  gpa2_fn gpa = (gpa2_fn)VG(cuGetProcAddress_v2);
  pthread_barrier_wait(c->go);
  /* every thread resolves and makes its first calls at once: the
   * interposer's config, its driver table and the first context race */
  churn_api_t a = {
      .retain = resolve(gpa, "cuDevicePrimaryCtxRetain"),
      .alloc = resolve(gpa, "cuMemAlloc"),
      .free = resolve(gpa, "cuMemFree"),
      .alloc_async = resolve(gpa, "cuMemAllocAsync"),
      .free_async = resolve(gpa, "cuMemFreeAsync"),
      .trim = resolve(gpa, "cuMemPoolTrimTo"),
      .create = resolve(gpa, "cuMemCreate"),
      .release = resolve(gpa, "cuMemRelease"),
      .host_alloc = resolve(gpa, "cuMemHostAlloc"),
      .free_host = resolve(gpa, "cuMemFreeHost"),
      .launch = resolve(gpa, "cuLaunchKernel"),
      .copy = resolve(gpa, "cuMemcpyHtoDAsync"),
      .sync = resolve(gpa, "cuStreamSynchronize"),
  };
  CUcontext ctx = NULL;
  FAIL_IF(c, a.retain(&ctx, 0) != CUDA_SUCCESS);
  CUmemAllocationProp prop;
  memset(&prop, 0, sizeof(prop));
  prop.type = CU_MEM_ALLOCATION_TYPE_PINNED;
  prop.location.type = CU_MEM_LOCATION_TYPE_DEVICE;
  prop.location.id = 0;
  static char host_src[1 << 16];
  for (int i = 0; i < CHURN_ITERS; i++) {
    uint64_t sz = 64 * 1024 + (uint64_t)(i % 5) * 4096;
    CUdeviceptr d = 0, q = 0;
    if (a.alloc(&d, sz) == CUDA_SUCCESS) {
      c->allocs++;
      c->alloc_bytes += sz;
      /* a copy into it, and one with no source: counted as an error */
      CUresult rc = a.copy(d, host_src, sz, c->stream);
      FAIL_IF(c, rc != CUDA_SUCCESS);
      c->copies++;
      c->copy_bytes += sz;
      if (i % 50 == 0) {
        FAIL_IF(c, a.copy(d, NULL, sz, c->stream) == CUDA_SUCCESS);
        c->copies++;
        c->copy_errors++;
      }
      FAIL_IF(c, a.free(d) != CUDA_SUCCESS);
      c->frees++;
    } else {
      c->failures++;
    }
    /* stream-ordered, on the device's pool */
    if (a.alloc_async(&q, sz, c->stream) == CUDA_SUCCESS) {
      c->allocs++;
      c->alloc_bytes += sz;
      FAIL_IF(c, a.free_async(q, c->stream) != CUDA_SUCCESS);
      c->frees++;
    } else {
      c->failures++;
    }
    if (i % 16 == 15) {
      FAIL_IF(c, a.sync(c->stream) != CUDA_SUCCESS);
      FAIL_IF(c, a.trim(c->pool, 0) != CUDA_SUCCESS);
    }
    /* a physical handle (expandable segments' path) */
    CUmemGenericAllocationHandle h = 0;
    if (a.create(&h, 2 * MiB, &prop, 0) == CUDA_SUCCESS) {
      c->allocs++;
      c->alloc_bytes += 2 * MiB;
      FAIL_IF(c, a.release(h) != CUDA_SUCCESS);
      c->frees++;
    } else {
      c->failures++;
    }
    /* pinned host memory, under the host limit */
    void *p = NULL;
    if (a.host_alloc(&p, 4096 * (1 + i % 4), 0) == CUDA_SUCCESS)
      FAIL_IF(c, a.free_host(p) != CUDA_SUCCESS);
    else
      c->failures++;
    /* launches, timed by events on this thread's stream */
    for (int k = 0; k < 3; k++) {
      FAIL_IF(c, a.launch(NULL, 1, 1, 1, 1, 1, 1, 0, c->stream, NULL,
                          NULL) != CUDA_SUCCESS);
      c->launches++;
    }
    if (i % 64 == 63) FAIL_IF(c, a.sync(c->stream) != CUDA_SUCCESS);
  }
  FAIL_IF(c, a.sync(c->stream) != CUDA_SUCCESS);
  /* this thread's last profile notes, into the region */
  VG(vtpu_prof_flush)(NULL);
  __atomic_sub_fetch(&g_churning, 1, __ATOMIC_RELEASE);
  return NULL;
}

static int churn_main(const char *sm) {
  setup("churn", 1, 64);
  setenv("CUDA_DEVICE_MEMORY_LIMIT", "1g", 1);
  setenv("CUDA_HOST_MEMORY_LIMIT", "256m", 1);
  if (sm && *sm && strcmp(sm, "0") != 0)
    setenv("CUDA_DEVICE_SM_LIMIT", sm, 1);
  else
    unsetenv("CUDA_DEVICE_SM_LIMIT");
  setenv("MOCK_CUDA_KERNEL_NS", CHURN_KERNEL_NS, 1);
  setenv("VTPU_PROFILE", "1", 1);
  setenv("VTPU_PROFILE_SAMPLE", "4", 1); /* the sampled path too */
  load();
  /* streams and the pool from the driver itself: no hook sees these */
  CUmemoryPool pool = NULL;
  CHECK(CU(cuDeviceGetMemPool)(&pool, 0) == CUDA_SUCCESS);
  pthread_barrier_t go;
  CHECK(pthread_barrier_init(&go, NULL, CHURN_THREADS) == 0);
  churn_ctx_t ctx[CHURN_THREADS];
  pthread_t th[CHURN_THREADS];
  for (int t = 0; t < CHURN_THREADS; t++) {
    ctx[t] = (churn_ctx_t){.go = &go, .pool = pool};
    CHECK(CU(cuStreamCreate)(&ctx[t].stream, 0) == CUDA_SUCCESS);
  }
  for (int t = 0; t < CHURN_THREADS; t++)
    CHECK(pthread_create(&th[t], NULL, churn_thread, &ctx[t]) == 0);
  /* while they run, the footprint charge is the context's, whatever is in
   * flight when it is re-read */
  uint64_t fp_min = UINT64_MAX, fp_max = 0, fp_reads = 0;
  for (int alive = 1; alive;) {
    usleep(1000);
    uint64_t fpv[8];
    VG(vgpu_footprint)(0, fpv);
    if (fpv[0] == 2) { /* measured: the context is made */
      fp_min = fpv[2] < fp_min ? fpv[2] : fp_min;
      fp_max = fpv[2] > fp_max ? fpv[2] : fp_max;
      fp_reads = fpv[3];
    }
    alive = __atomic_load_n(&g_churning, __ATOMIC_ACQUIRE) > 0;
  }
  for (int t = 0; t < CHURN_THREADS; t++)
    CHECK(pthread_join(th[t], NULL) == 0);
  unsigned long allocs = 0, frees = 0, launches = 0, copies = 0, errs = 0;
  uint64_t alloc_bytes = 0, copy_bytes = 0;
  for (int t = 0; t < CHURN_THREADS; t++) {
    CHECK(ctx[t].failures == 0);
    allocs += ctx[t].allocs;
    frees += ctx[t].frees;
    launches += ctx[t].launches;
    copies += ctx[t].copies;
    errs += ctx[t].copy_errors;
    alloc_bytes += ctx[t].alloc_bytes;
    copy_bytes += ctx[t].copy_bytes;
  }
  pthread_barrier_destroy(&go);

  /* quiesce: the pool gives back what it holds, the spans and brackets
   * whose work is done are charged and published, the footprint re-read */
  CHECK(VG(cuStreamSynchronize)(NULL) == CUDA_SUCCESS);
  CHECK(VG(cuMemPoolTrimTo)(pool, 0) == CUDA_SUCCESS);
  VG(vgpu_flush_launches)();
  VG(vtpu_prof_flush)(NULL);
  await_refresh();

  vtpu_shared_region_t *r = region();
  uint64_t mode = 0, fp = footprint_charge(&mode);
  CHECK(mode == 2 && fp == 64 * MiB);
  if (fp_min != fp || fp_max != fp)
    fprintf(stderr, "footprint charge %llu..%llu B during the churn (%llu "
            "re-reads), the context's %llu B\n", (unsigned long long)fp_min,
            (unsigned long long)fp_max, (unsigned long long)fp_reads,
            (unsigned long long)fp);
  CHECK(fp_min == fp && fp_max == fp);
  /* what the region holds is the footprint charge, exactly */
  CHECK(vtpu_region_used(r, 0) == fp);
  uint64_t fast[VTPU_MAX_DEVICES], exact[VTPU_MAX_DEVICES];
  vtpu_region_used_fast(r, fast);
  vtpu_region_used_all(r, exact);
  for (int d = 0; d < VTPU_MAX_DEVICES; d++) CHECK(fast[d] == exact[d]);
  CHECK(vtpu_region_host_used(r) == 0 && vtpu_region_host_used_fast(r) == 0);
  CHECK(r->prof_pressure[VTPU_PROF_PK_TABLE_DROPS] == 0);
  CHECK(vtpu_inflight(r, 0) == 0);
  CHECK(r->total_launches == launches);
  CHECK(CU(mock_cuda_launches)() == launches);
  /* every span closed was charged, and its charge reached the region (with
   * an SM limit the brackets' charges are not kept per stream) */
  uint64_t charged = 0, out[3];
  for (int t = 0; t < CHURN_THREADS; t++)
    if (VG(vgpu_span_stream)(ctx[t].stream, out)) charged += out[2];
  uint64_t launch_ns = 0;
  for (int i = 0; i < VTPU_MAX_PROCS; i++)
    if (r->procs[i].status) launch_ns += r->procs[i].launch_ns;
  CHECK(launch_ns > 0);
  if (!getenv("CUDA_DEVICE_SM_LIMIT")) CHECK(charged == launch_ns);
  /* the profile counted every call: copies with their bytes and errors,
   * launches, and the completion work of every charge */
  const vtpu_prof_callsite_t *cs = r->prof_cs;
  CHECK(cs[VTPU_PROF_CS_TRANSFER].calls == copies);
  CHECK(cs[VTPU_PROF_CS_TRANSFER].errors == errs);
  CHECK(cs[VTPU_PROF_CS_TRANSFER].bytes == copy_bytes);
  CHECK(cs[VTPU_PROF_CS_EXECUTE].calls == launches);
  CHECK(cs[VTPU_PROF_CS_BUF_ALLOC].calls == allocs);
  CHECK(cs[VTPU_PROF_CS_BUF_ALLOC].bytes == alloc_bytes);
  CHECK(cs[VTPU_PROF_CS_BUF_FREE].calls == frees);
  CHECK(cs[VTPU_PROF_CS_DONE_WITH_BUFFER].calls > 0);
  CHECK(cs[VTPU_PROF_CS_DONE_WITH_BUFFER].errors == 0);
  CHECK(vtpu_region_header_ok(r));
  vtpu_region_close(r);
  cleanup();
  printf("interposer_test churn OK (%d threads x %d iters, %s; %lu "
         "launches, %lu copies, %llu B charged by spans and brackets)\n",
         CHURN_THREADS, CHURN_ITERS,
         getenv("CUDA_DEVICE_SM_LIMIT") ? "SM limit" : "no SM limit",
         launches, copies, (unsigned long long)launch_ns);
  return 0;
}

/* ----------------------------------------------------------- tabledrop */

#define TABLE_MAX (1 << 16) /* libvgpu.c's TABLE_MAX */

static int tabledrop_main(void) {
  setup("tabledrop", 0, 0);
  setenv("CUDA_DEVICE_MEMORY_LIMIT", "1g", 1);
  load();
  __typeof__(&cuMemAlloc_v2) alloc = VG(cuMemAlloc_v2);
  __typeof__(&cuMemFree_v2) release = VG(cuMemFree_v2);
  __typeof__(&cuMemGetInfo_v2) info = VG(cuMemGetInfo_v2);
  static CUdeviceptr held[TABLE_MAX];
  for (int i = 0; i < TABLE_MAX; i++)
    CHECK(alloc(&held[i], 4096) == CUDA_SUCCESS);
  vtpu_shared_region_t *r = region();
  const uint64_t full = (uint64_t)TABLE_MAX * 4096;
  CHECK(vtpu_region_used(r, 0) == full);
  CHECK(r->prof_pressure[VTPU_PROF_PK_TABLE_DROPS] == 0);
  size_t fr = 0, tot = 0, fr_full = 0, drv_full = 0, drv = 0;
  CHECK(info(&fr_full, &tot) == CUDA_SUCCESS);
  CHECK(tot == 1024 * MiB && fr_full == 1024 * MiB - full);
  CHECK(CU(cuMemGetInfo_v2)(&drv_full, &tot) == CUDA_SUCCESS);

  /* the table is full: the allocation is refused, never run uncharged; the
   * driver's memory is given back, the charge rolled back and the drop
   * counted, and the quota view is as before the call */
  CUdeviceptr extra = 1;
  CHECK(alloc(&extra, MiB) == CUDA_ERROR_OUT_OF_MEMORY);
  CHECK(extra == 0);
  CHECK(r->prof_pressure[VTPU_PROF_PK_TABLE_DROPS] == 1);
  CHECK(vtpu_region_used(r, 0) == full);
  CHECK(info(&fr, &tot) == CUDA_SUCCESS && fr == fr_full);
  CHECK(CU(cuMemGetInfo_v2)(&drv, &tot) == CUDA_SUCCESS && drv == drv_full);

  /* a slot freed: the next allocation is tracked, charged and released */
  CHECK(release(held[TABLE_MAX - 1]) == CUDA_SUCCESS);
  CHECK(alloc(&extra, MiB) == CUDA_SUCCESS);
  CHECK(vtpu_region_used(r, 0) == full - 4096 + MiB);
  CHECK(release(extra) == CUDA_SUCCESS);
  for (int i = TABLE_MAX - 2; i >= 0; i--)
    CHECK(release(held[i]) == CUDA_SUCCESS);
  CHECK(vtpu_region_used(r, 0) == 0);
  CHECK(info(&fr, &tot) == CUDA_SUCCESS && fr == 1024 * MiB);
  CHECK(r->prof_pressure[VTPU_PROF_PK_TABLE_DROPS] == 1);
  CHECK(vtpu_region_header_ok(r));
  vtpu_region_close(r);
  cleanup();
  printf("interposer_test tabledrop OK (%d entries)\n", TABLE_MAX);
  return 0;
}

/* ----------------------------------------------------------- hostquota */

static int hostquota_main(void) {
  setup("hostquota", 0, 0);
  setenv("CUDA_DEVICE_MEMORY_LIMIT", "1m", 1);
  setenv("CUDA_HOST_MEMORY_LIMIT", "56k", 1);
  load();
  const uint64_t K = 1024;
  unsigned long calls = CU(mock_cuda_host_calls)();
  void *a = NULL, *b = NULL, *c = NULL, *d = NULL, *e = NULL;
  CHECK(VG(cuMemHostAlloc)(&a, 16 * K, 0) == CUDA_SUCCESS);
  CHECK(VG(cuMemHostAlloc)(&b, 16 * K, 0) == CUDA_SUCCESS);
  CHECK(VG(cuMemHostAlloc)(&c, 16 * K, 0) == CUDA_SUCCESS);
  vtpu_shared_region_t *r = region();
  CHECK(r->host_limit == 56 * K); /* configured by the interposer */
  CHECK(vtpu_region_host_used(r) == 48 * K);
  uint64_t oom0 = r->host_oom_events;
  /* refused by the interposer: the driver never sees it */
  CHECK(VG(cuMemHostAlloc)(&d, 16 * K, 0) == CUDA_ERROR_OUT_OF_MEMORY);
  CHECK(CU(mock_cuda_host_calls)() == calls + 3);
  CHECK(r->host_oom_events == oom0 + 1);
  CHECK(VG(cuMemAllocHost_v2)(&d, 8 * K) == CUDA_SUCCESS);
  CHECK(vtpu_region_host_used(r) == 56 * K);
  CHECK(VG(cuMemAllocHost_v2)(&e, 1) == CUDA_ERROR_OUT_OF_MEMORY);
  /* a registration is charged as an allocation is */
  static char page[16 * 1024];
  CHECK(VG(cuMemHostRegister_v2)(page, sizeof(page), 0) ==
        CUDA_ERROR_OUT_OF_MEMORY);
  CHECK(VG(cuMemFreeHost)(a) == CUDA_SUCCESS);
  CHECK(VG(cuMemHostRegister_v2)(page, sizeof(page), 0) == CUDA_SUCCESS);
  CHECK(vtpu_region_host_used(r) == 56 * K);
  CHECK(VG(cuMemHostUnregister)(page) == CUDA_SUCCESS);
  /* a host-located physical handle goes to the host ledger, not the
   * device's */
  CUmemAllocationProp prop;
  memset(&prop, 0, sizeof(prop));
  prop.type = CU_MEM_ALLOCATION_TYPE_PINNED;
  prop.location.type = CU_MEM_LOCATION_TYPE_HOST;
  CUmemGenericAllocationHandle h = 0, h2 = 0;
  CHECK(VG(cuMemCreate)(&h, 16 * K, &prop, 0) == CUDA_SUCCESS);
  CHECK(vtpu_region_host_used(r) == 56 * K);
  CHECK(vtpu_region_used(r, 0) == 0);
  CHECK(VG(cuMemCreate)(&h2, 16 * K, &prop, 0) == CUDA_ERROR_OUT_OF_MEMORY);
  CHECK(VG(cuMemRelease)(h) == CUDA_SUCCESS);
  CHECK(vtpu_region_host_used(r) == 40 * K);
  CHECK(VG(cuMemFreeHost)(b) == CUDA_SUCCESS);
  CHECK(VG(cuMemFreeHost)(c) == CUDA_SUCCESS);
  CHECK(VG(cuMemFreeHost)(d) == CUDA_SUCCESS);
  /* byte-exact release, the device axis untouched throughout */
  CHECK(vtpu_region_host_used(r) == 0 && vtpu_region_host_used_fast(r) == 0);
  CHECK(vtpu_region_used(r, 0) == 0);
  CHECK(vtpu_region_header_ok(r));
  vtpu_region_close(r);
  cleanup();
  printf("interposer_test hostquota OK\n");
  return 0;
}

/* ------------------------------------------------------------ codeload */

#define CODE_THREADS 8
#define CODE_ITERS 400
#define CODE_LOAD_MIB 16 /* a module's load */
#define CODE_FUNC_MIB 4  /* its function's, at its first launch */

typedef struct {
  pthread_barrier_t *go;
  int failures;
} code_ctx_t;

static void *codeload_thread(void *arg) {
  code_ctx_t *c = arg;
  gpa2_fn gpa = (gpa2_fn)VG(cuGetProcAddress_v2);
  pthread_barrier_wait(c->go);
  __typeof__(&cuModuleLoadData) load = resolve(gpa, "cuModuleLoadData");
  __typeof__(&cuModuleGetFunction) get = resolve(gpa, "cuModuleGetFunction");
  __typeof__(&cuLaunchKernel) launch = resolve(gpa, "cuLaunchKernel");
  __typeof__(&cuModuleUnload) unload = resolve(gpa, "cuModuleUnload");
  static const char image[] = "a module's image";
  for (int i = 0; i < CODE_ITERS; i++) {
    CUmodule mod = NULL;
    CUfunction f = NULL;
    if (load(&mod, image) != CUDA_SUCCESS) {
      c->failures++;
      continue;
    }
    FAIL_IF(c, get(&f, mod, "codemem_touch") != CUDA_SUCCESS);
    FAIL_IF(c, launch(f, 1, 1, 1, 1, 1, 1, 0, NULL, NULL, NULL) !=
                   CUDA_SUCCESS);
    FAIL_IF(c, unload(mod) != CUDA_SUCCESS);
  }
  return NULL;
}

static int codeload_main(void) {
  setup("codeload", 1, 64);
  setenv("MOCK_GPU_PROCS_SHARED", "1", 1);
  setenv("MOCK_CUDA_REUSE_HANDLES", "1", 1);
  char bytes[32];
  snprintf(bytes, sizeof(bytes), "%dm", CODE_LOAD_MIB);
  setenv("MOCK_CUDA_LOAD_BYTES", bytes, 1);
  snprintf(bytes, sizeof(bytes), "%dm", CODE_FUNC_MIB);
  setenv("MOCK_CUDA_FUNC_BYTES", bytes, 1);
  setenv("CUDA_DEVICE_MEMORY_LIMIT", "1g", 1);
  /* a neighbour on the card already (this harness's parent), listed as
   * the same pid */
  char path[4400], line[64];
  snprintf(path, sizeof(path), "%s/procs/%d", g_dir, (int)getppid());
  snprintf(line, sizeof(line), "%d 0\n", (int)getppid());
  write_file(path, line);
  load();
  CUcontext ctx = NULL;
  CHECK(VG(cuDevicePrimaryCtxRetain)(&ctx, 0) == CUDA_SUCCESS);
  uint64_t mode = 0;
  CHECK(footprint_charge(&mode) == 64 * MiB);
  CHECK(mode == 3); /* NVML cannot tell the process apart */
  pthread_barrier_t go;
  CHECK(pthread_barrier_init(&go, NULL, CODE_THREADS) == 0);
  code_ctx_t ctxs[CODE_THREADS];
  pthread_t th[CODE_THREADS];
  for (int t = 0; t < CODE_THREADS; t++) {
    ctxs[t] = (code_ctx_t){.go = &go};
    CHECK(pthread_create(&th[t], NULL, codeload_thread, &ctxs[t]) == 0);
  }
  for (int t = 0; t < CODE_THREADS; t++) {
    CHECK(pthread_join(th[t], NULL) == 0);
    CHECK(ctxs[t].failures == 0);
  }
  pthread_barrier_destroy(&go);
  CHECK(VG(cuCtxSynchronize)() == CUDA_SUCCESS);

  /* every load, look-up and first launch was measured, each cycle anew:
   * an unload forgot its module's keys, whose handle the next load took */
  const uint64_t cycles = (uint64_t)CODE_THREADS * CODE_ITERS;
  uint64_t first[6], code[8];
  VG(vgpu_footprint_launches)(first);
  VG(vgpu_code_memory)(code);
  CHECK(first[0] == 3 * cycles);
  CHECK(first[3] == 0); /* no reading shrank */
  CHECK(first[2] == cycles * CODE_LOAD_MIB * MiB);
  CHECK(first[1] == cycles * CODE_FUNC_MIB * MiB);
  CHECK(code[0] == cycles && code[1] == 0 && code[2] == cycles);
  CHECK(code[3] == cycles * (CODE_LOAD_MIB + CODE_FUNC_MIB) * MiB);
  CHECK(code[4] == 0 && code[5] == 0 && code[6] == 0 && code[7] == 0);
  CHECK(CU(mock_cuda_code_live)() == 0);
  /* the region holds the context's charge, exactly */
  vtpu_shared_region_t *r = region();
  CHECK(footprint_charge(NULL) == 64 * MiB);
  CHECK(vtpu_region_used(r, 0) == 64 * MiB);
  uint64_t fast[VTPU_MAX_DEVICES], exact[VTPU_MAX_DEVICES];
  vtpu_region_used_fast(r, fast);
  vtpu_region_used_all(r, exact);
  for (int d = 0; d < VTPU_MAX_DEVICES; d++) CHECK(fast[d] == exact[d]);
  CHECK(r->reserved2 == 1); /* context mode, said once: nothing else */
  CHECK(r->prof_pressure[VTPU_PROF_PK_TABLE_DROPS] == 0);
  CHECK(vtpu_region_header_ok(r));
  vtpu_region_close(r);
  cleanup();
  printf("interposer_test codeload OK (%d threads x %d loads, %llu calls "
         "measured)\n",
         CODE_THREADS, CODE_ITERS, (unsigned long long)first[0]);
  return 0;
}

/* ----------------------------------------------------------- profbench */

/* best ns per iteration of `body` over `iters`, the minimum of `attempts`,
 * with the interposer's profile configured `on` or off between them */
typedef struct {
  __typeof__(&cuMemAlloc_v2) alloc;
  __typeof__(&cuMemFree_v2) free;
  __typeof__(&cuLaunchKernel) launch;
  __typeof__(&cuMemcpyHtoD_v2) copy;
  __typeof__(&cuMemcpyHtoD_v2) copy_direct;
  __typeof__(&cuStreamSynchronize) sync;
} bench_api_t;

enum { B_PAIR, B_LAUNCH, B_COPY, B_COPY_DIRECT };

static double bench_once(const bench_api_t *a, int what, int iters) {
  static char host[256];
  CUdeviceptr d = 0;
  if (what == B_COPY || what == B_COPY_DIRECT)
    CHECK(a->alloc(&d, sizeof(host)) == CUDA_SUCCESS);
  int64_t t0 = now_ns();
  for (int i = 0; i < iters; i++) {
    if (what == B_PAIR) {
      CHECK(a->alloc(&d, 4096) == CUDA_SUCCESS);
      CHECK(a->free(d) == CUDA_SUCCESS);
    } else if (what == B_LAUNCH) {
      CHECK(a->launch(NULL, 1, 1, 1, 1, 1, 1, 0, NULL, NULL, NULL) ==
            CUDA_SUCCESS);
    } else {
      CHECK((what == B_COPY ? a->copy : a->copy_direct)(d, host,
                                                        sizeof(host)) ==
            CUDA_SUCCESS);
    }
  }
  double per = (double)(now_ns() - t0) / iters;
  if (what == B_LAUNCH) CHECK(a->sync(NULL) == CUDA_SUCCESS);
  if (d && what != B_PAIR) CHECK(a->free(d) == CUDA_SUCCESS);
  return per;
}

static int profbench_main(void) {
  setup("profbench", 0, 0);
  setenv("CUDA_DEVICE_MEMORY_LIMIT", "1g", 1);
  load();
  /* the interposer's own copy of the profile switch (libvgpu.so links its
   * own shared_region.c) */
  void (*configure)(int, int) = (void (*)(int, int))sym(g_vg,
                                                        "vtpu_prof_configure");
  bench_api_t a = {VG(cuMemAlloc_v2),  VG(cuMemFree_v2),
                   VG(cuLaunchKernel), VG(cuMemcpyHtoD_v2),
                   CU(cuMemcpyHtoD_v2), VG(cuStreamSynchronize)};
  const char *se = getenv("VTPU_PROFILE_SAMPLE");
  int sample = se ? atoi(se) : VTPU_PROF_SAMPLE_DEFAULT;
  const int iters = 20000, attempts = 3;
  double pair[2] = {1e18, 1e18}, launch[2] = {1e18, 1e18};
  double copy[2] = {1e18, 1e18}, direct = 1e18;
  for (int at = 0; at < attempts; at++) {
    for (int on = 0; on < 2; on++) {
      configure(on, sample);
      bench_once(&a, B_PAIR, 500); /* warm-up */
      double v = bench_once(&a, B_PAIR, iters);
      if (v < pair[on]) pair[on] = v;
      v = bench_once(&a, B_LAUNCH, iters);
      if (v < launch[on]) launch[on] = v;
      v = bench_once(&a, B_COPY, iters);
      if (v < copy[on]) copy[on] = v;
    }
    double v = bench_once(&a, B_COPY_DIRECT, iters);
    if (v < direct) direct = v;
  }
  configure(1, sample);

  /* The decomposed unit cost: the hook sequence a charge-path event runs
   * (prof_hook.h's inlines, compiled into libvgpu.c as here), on against
   * off, against a private region, the minimum over attempts. A spacer of
   * ~10 dependent multiplies separates events in both modes, as in
   * shim_test.c: back to back, the hook's TLS read-modify-writes form a
   * store-forwarding chain that deployed events, >= 100 ns apart, never
   * do. */
  char upath[4300];
  snprintf(upath, sizeof(upath), "%s/unit.cache", g_dir);
  vtpu_shared_region_t *ur = vtpu_region_open(upath);
  CHECK(ur != NULL);
  const int uiters = 2000000;
  double unit[2] = {1e18, 1e18};
  uint64_t sink = 0;
  for (int at = 0; at < attempts; at++) {
    for (int on = 0; on < 2; on++) {
      vtpu_prof_configure(on, sample);
      int64_t t0 = now_ns();
      for (int i = 0; i < uiters; i++) {
        for (int k = 0; k < 10; k++) sink = sink * 0x9e3779b97f4a7c15ull + 1;
        int64_t pt = vtpu_prof_enter_fast();
        vtpu_prof_note_fast(ur, VTPU_PROF_CS_CHARGE, pt, 0, 64, 0);
      }
      double per = (double)(now_ns() - t0) / uiters;
      if (per < unit[on]) unit[on] = per;
    }
  }
  if (sink == 0xdead) fprintf(stderr, "~\n"); /* keep the spacer live */
  vtpu_region_close(ur);
  double event_ns = unit[1] - unit[0] > 0 ? unit[1] - unit[0] : 0;
  /* four profile events ride one allocation and free: BUF_ALLOC with its
   * CHARGE, BUF_FREE with its UNCHARGE */
  double events = 4.0;
  double wall_pct = 100.0 * (pair[1] - pair[0]) / pair[0];
  double decomposed_pct = 100.0 * events * event_ns / pair[0];
  printf("{\"metric\": \"interposer_charge_profile_overhead\", "
         "\"charge_pair_off_ns\": %.1f, \"charge_pair_on_ns\": %.1f, "
         "\"wall_overhead_pct\": %.3f, \"prof_event_ns\": %.3f, "
         "\"events_per_pair\": %.0f, \"decomposed_overhead_pct\": %.3f, "
         "\"launch_off_ns\": %.1f, \"launch_on_ns\": %.1f, "
         "\"copy_off_ns\": %.1f, \"copy_on_ns\": %.1f, "
         "\"copy_direct_ns\": %.1f, \"sample\": %d, \"iters\": %d}\n",
         pair[0], pair[1], wall_pct, event_ns, events, decomposed_pct,
         launch[0], launch[1], copy[0], copy[1], direct, sample, iters);
  cleanup();
  return 0;
}

int main(int argc, char **argv) {
  const char *mode = argc >= 2 ? argv[1] : "";
  if (strcmp(mode, "churn") == 0) return churn_main(argc >= 3 ? argv[2] : "");
  if (strcmp(mode, "tabledrop") == 0) return tabledrop_main();
  if (strcmp(mode, "hostquota") == 0) return hostquota_main();
  if (strcmp(mode, "codeload") == 0) return codeload_main();
  if (strcmp(mode, "profbench") == 0) return profbench_main();
  if (*mode) {
    fprintf(stderr, "interposer_test: unknown mode %s\n", mode);
    return 2;
  }
  return smoke_main();
}
