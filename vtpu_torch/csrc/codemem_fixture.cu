// codemem_fixture.cu — the code-memory probe's module
// (vtpu_torch/bench/codemem.py): __device__ globals of CODEMEM_PARTS x
// CODEMEM_PART_MIB MiB, which the driver places on the card with the
// module, and one kernel that writes every byte of them.
//
// vtpu_torch/native.py builds it with nvcc for sm_90a as a cubin, a fatbin
// and PTX (256 MiB), and as a cubin of 3 GiB, past the probe's quota:
//   nvcc -cubin -arch=sm_90a -DCODEMEM_PARTS=1 -DCODEMEM_PART_MIB=256 ...
// Each part is an array of its own: a variable stays under 2 GiB.
#include <cstdint>

#ifndef CODEMEM_PARTS
#define CODEMEM_PARTS 1
#endif
#ifndef CODEMEM_PART_MIB
#define CODEMEM_PART_MIB 256
#endif
#if CODEMEM_PARTS < 1 || CODEMEM_PARTS > 3
#error "CODEMEM_PARTS is 1, 2 or 3"
#endif

#define CODEMEM_PART_WORDS ((size_t)CODEMEM_PART_MIB * 65536)  // uint4 words

extern "C" {
__device__ uint4 codemem_data0[CODEMEM_PART_WORDS];
#if CODEMEM_PARTS > 1
__device__ uint4 codemem_data1[CODEMEM_PART_WORDS];
#endif
#if CODEMEM_PARTS > 2
__device__ uint4 codemem_data2[CODEMEM_PART_WORDS];
#endif

// every word of every part set to its own index, a grid-stride loop
__global__ void codemem_touch() {
  size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < CODEMEM_PART_WORDS; i += stride) {
    uint4 v = make_uint4((unsigned)i, (unsigned)(i >> 32), 0u, 0u);
    codemem_data0[i] = v;
#if CODEMEM_PARTS > 1
    codemem_data1[i] = v;
#endif
#if CODEMEM_PARTS > 2
    codemem_data2[i] = v;
#endif
  }
}
}
