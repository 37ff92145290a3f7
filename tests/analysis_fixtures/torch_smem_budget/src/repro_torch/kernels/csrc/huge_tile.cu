// Seeded violations for smem_budget: a static tile over the 227 KiB a
// block may hold, and a kernel with dynamic shared memory whose launcher
// bytes have no formula.
constexpr int kRows = 256, kCols = 256;

__global__ void __launch_bounds__(256, 2) huge_tile_kernel(float* out) {
  __shared__ float tile[kRows][kCols];
  tile[threadIdx.x][0] = 0.f;
  out[threadIdx.x] = tile[threadIdx.x][0];
}

__global__ void __launch_bounds__(256) dynamic_kernel(float* out) {
  extern __shared__ float buf[];
  buf[threadIdx.x] = 1.f;
  out[threadIdx.x] = buf[threadIdx.x];
}
