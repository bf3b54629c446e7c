// What the host-side planners of ops/ need to know about the card: the
// shared memory a block may opt in to (227 KB on an H100).  No kernel.

#include <cuda_runtime.h>

// The opt-in shared memory limit of one block on device `dev`, in bytes;
// -1 if the runtime cannot say.
extern "C" int device_smem_optin(int dev) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess) {
    return -1;
  }
  return bytes;
}
