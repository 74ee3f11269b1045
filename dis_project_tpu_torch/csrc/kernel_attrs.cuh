// cudaFuncGetAttributes of one kernel for the kernel_attrs entry point that
// every source exports (chip_smoke.py prints them): registers a thread,
// local memory a thread (spills) and static shared memory a CTA.
#pragma once

#include <cuda_runtime.h>

template <typename Kernel>
int func_attrs(Kernel kernel, int* attrs) {
  cudaFuncAttributes a;
  if (int err = (int)cudaFuncGetAttributes(&a, kernel)) return err;
  attrs[0] = a.numRegs;
  attrs[1] = (int)a.localSizeBytes;
  attrs[2] = (int)a.sharedSizeBytes;
  return 0;
}
