/* region_stress — threaded stress of the shared region's hot paths (the
 * port's counterpart of lib/vtpu/test/region_stress.c, built from the
 * port's own copy of the region, plain and under ASan+UBSan and TSan by
 * vtpu_torch/native.py): 8 threads x 5,000 iterations of
 * alloc/free/launch/complete/acquire/debit on one region, and the balance
 * must come back to zero. Races here would corrupt quota accounting
 * silently. The region file goes under $TMPDIR (else /tmp). */

#define _GNU_SOURCE
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <unistd.h>

#include "../shared_region.h"

#define CHECK(cond)                                                       \
  do {                                                                    \
    if (!(cond)) {                                                        \
      fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__, #cond);     \
      exit(1);                                                            \
    }                                                                     \
  } while (0)

#define THREADS 8
#define ITERS 5000

static vtpu_shared_region_t *g_r;

static void *worker(void *arg) {
  int32_t pid = (int32_t)(intptr_t)arg + 100000; /* fake distinct pids */
  CHECK(vtpu_region_attach(g_r, pid) >= 0);
  for (int i = 0; i < ITERS; i++) {
    int dev = i & 1;
    if (vtpu_try_alloc(g_r, pid, dev, 64) == 0)
      vtpu_free(g_r, pid, dev, 64);
    vtpu_note_launch(g_r, pid, 0);
    vtpu_note_complete(g_r, pid, 1000, 1u << dev);
    vtpu_util_try_acquire(g_r, dev, 50, 100000000ll);
    vtpu_util_debit(g_r, 1u << dev, 500);
    if ((i & 255) == 0) vtpu_heartbeat(g_r, pid);
    (void)vtpu_region_used(g_r, dev);
    (void)vtpu_inflight(g_r, 0);
  }
  CHECK(vtpu_region_detach(g_r, pid) == 0);
  return NULL;
}

int main(void) {
  const char *dir = getenv("TMPDIR");
  char path[4096];
  snprintf(path, sizeof(path), "%s/vgpu_region_stress_XXXXXX",
           dir && *dir ? dir : "/tmp");
  int fd = mkstemp(path);
  CHECK(fd >= 0);
  close(fd);
  g_r = vtpu_region_open(path);
  CHECK(g_r != NULL);
  uint64_t limits[VTPU_MAX_DEVICES] = {1 << 20, 1 << 20};
  uint32_t cores[VTPU_MAX_DEVICES] = {50, 50};
  CHECK(vtpu_region_configure(g_r, 2, limits, cores, 1,
                              VTPU_UTIL_POLICY_DEFAULT, NULL) == 0);

  pthread_t ts[THREADS];
  for (int t = 0; t < THREADS; t++)
    CHECK(pthread_create(&ts[t], NULL, worker,
                         (void *)(intptr_t)t) == 0);
  for (int t = 0; t < THREADS; t++) pthread_join(ts[t], NULL);

  /* every alloc was freed and every slot detached: balance must be 0 */
  CHECK(vtpu_region_used(g_r, 0) == 0);
  CHECK(vtpu_region_used(g_r, 1) == 0);
  CHECK(vtpu_inflight(g_r, 0) == 0);

  vtpu_region_close(g_r);
  unlink(path);
  printf("region_stress OK (%d threads x %d iters)\n", THREADS, ITERS);
  return 0;
}
