// Error reporting for the ctypes binding: every entry point of this library
// returns cudaGetLastError() as an int, and the Python wrapper turns a
// non-zero code into a message with this function.
#include <cuda_runtime.h>

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
