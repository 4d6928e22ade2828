// Shared by every kernel source: each C entry asks first whether an error
// is already pending on its stream, so that a fault left by an earlier
// asynchronous launch (a sticky error such as an illegal address) is
// reported as pending before this entry, not as the failure of this entry's
// own launch. cudaGetLastError() after a launch would return it either way.

#pragma once

#include <cuda_runtime.h>

namespace tpu3d {

// Added to the code of an error found pending before a launch; the Python
// wrapper (ops/_build.py) tells the two kinds apart by it.
constexpr int kPending = 1 << 16;

// 0, or kPending + the error already pending on `stream`: cudaStreamQuery
// returns the error of an earlier asynchronous launch without waiting for
// the stream, and cudaGetLastError an earlier launch's configuration error.
inline int pending_error(cudaStream_t stream) {
  cudaError_t err = cudaStreamQuery(stream);
  if (err == cudaErrorNotReady) err = cudaSuccess;
  if (err == cudaSuccess) err = cudaGetLastError();
  return err == cudaSuccess ? 0 : kPending + (int)err;
}

}  // namespace tpu3d

// The CUDA name of an error code, for the wrapper's messages.
extern "C" const char* tpu3d_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}
