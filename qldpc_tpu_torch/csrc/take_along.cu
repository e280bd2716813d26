// take_along_axis on a 2-D tile of 4-byte elements:
//   axis 0: out[r, c] = x[idx[r, c], c];  axis 1: out[r, c] = x[r, idx[r, c]].
//
// Replaces: scripts/pallas_gather_probe.py::probe.kernel (the pallas_call
// that mapped which dynamic-gather forms the TPU compiler accepts). On
// Hopper every form is an ordinary indexed load, so the counterpart is one
// thread per output element: reads of idx and writes of out are coalesced,
// the gathered read of x is coalesced along axis 0 (neighbouring threads,
// neighbouring columns) and scattered along axis 1.
//
// Bound on the H100: the bytes of x, idx and out once over 3.35 TB/s; at
// the probe's shapes (at most 1024 x 128 elements, 1.5 MB in all) that is
// under half a microsecond, below the launch latency, so the launch bounds
// the time. float32 and int32 move as the same 32-bit words.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void take_along_kernel(const uint32_t* __restrict__ x,
                                  const int* __restrict__ idx,
                                  uint32_t* __restrict__ out, int rows,
                                  int cols, int axis) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)rows * cols) return;
  const int r = (int)(i / cols);
  const int c = (int)(i - (size_t)r * cols);
  const int k = idx[i];
  out[i] = axis == 0 ? x[(size_t)k * cols + c] : x[(size_t)r * cols + k];
}

// The caller guarantees every idx lies in [0, rows) for axis 0 and in
// [0, cols) for axis 1.
extern "C" int take_along_launch(const void* x, const int* idx, void* out,
                                 int rows, int cols, int axis, void* stream) {
  const size_t n = (size_t)rows * cols;
  const int threads = 256;
  if (n > 0) {
    take_along_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                        (cudaStream_t)stream>>>(
        (const uint32_t*)x, idx, (uint32_t*)out, rows, cols, axis);
  }
  return (int)cudaGetLastError();
}
