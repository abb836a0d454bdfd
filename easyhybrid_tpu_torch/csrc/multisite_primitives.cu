// The building blocks of the multi-site training kernel (fused_multisite.cu)
// as kernels of their own, for Hopper, sm_90a.
//
// Replaces the Pallas probe kernels of tools/probe_multisite_primitives.py
// (:32) and tools/probe_multisite_primitives2.py (:29), which checked on a
// TPU the primitives its multi-site kernel was built from (reshape between
// sample and (time, site) layouts, exact row select from packed tiles,
// masked row update, the select -> broadcast -> multiply -> reduce over time
// -> accumulate chain). The packed tiles and their reshapes have no
// counterpart here: per-site state is a plain (S,) array read through a site
// index. What this card's kernel does rely on is checked here instead:
//   * eh_prim_site_gather: a per-site value read through the site index and
//     broadcast over the site's time steps (-1 is a padding slot: 0);
//   * eh_prim_site_reduce: a per-site sum over time, in time order;
//   * eh_prim_site_update: a masked update that writes the indexed sites and
//     leaves every other site's bits as they were;
//   * eh_prim_site_chain: gather -> multiply -> reduce over time ->
//     accumulate into the site's slot;
//   * eh_prim_block_sum: the sum of per-block partial rows in block order,
//     the same bits on every run.
// The gather and the update must be exact; the sums differ from another
// summation order by rounding only. eh_prim_site_reduce also serves the
// training path: the per-site counts of valid targets come from it.
//
// All are bound by bytes: each reads its input once and does one add or
// multiply per element.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void eh_prim_site_gather_kernel(const float* vals, const int* idx, float* out,
                                           int n_slots, int n_obs) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)n_slots * n_obs) return;
  const int s = idx[i / n_obs];
  out[i] = s >= 0 ? vals[s] : 0.0f;
}

__global__ void eh_prim_site_reduce_kernel(const float* in, float* out, int n_slots, int n_obs) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_slots) return;
  const float* row = in + (int64_t)j * n_obs;
  float acc = 0.0f;
  for (int t = 0; t < n_obs; ++t) acc += row[t];
  out[j] = acc;
}

__global__ void eh_prim_site_update_kernel(float* vals, const int* idx, const float* fresh,
                                           int n_slots) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_slots) return;
  const int s = idx[j];
  if (s >= 0) vals[s] = fresh[j];
}

__global__ void eh_prim_site_chain_kernel(const float* vals, const int* idx, const float* x,
                                          float* acc, int n_slots, int n_obs) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_slots) return;
  const int s = idx[j];
  if (s < 0) return;
  const float v = vals[s];
  const float* row = x + (int64_t)j * n_obs;
  float sum = 0.0f;
  for (int t = 0; t < n_obs; ++t) sum += v * row[t];
  acc[s] += sum;
}

__global__ void eh_prim_block_sum_kernel(const float* partials, float* out, int n_blocks,
                                         int width) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= width) return;
  float acc = 0.0f;
  for (int b = 0; b < n_blocks; ++b) acc += partials[(int64_t)b * width + p];
  out[p] = acc;
}

static int blocks_for(int64_t n) { return (int)((n + 255) / 256); }

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int eh_prim_site_gather(const float* vals, const int* idx, float* out, int n_slots,
                                   int n_obs, void* stream) {
  if (n_slots <= 0 || n_obs <= 0) return 0;
  eh_prim_site_gather_kernel<<<blocks_for((int64_t)n_slots * n_obs), 256, 0,
                               (cudaStream_t)stream>>>(vals, idx, out, n_slots, n_obs);
  return (int)cudaGetLastError();
}

extern "C" int eh_prim_site_reduce(const float* in, float* out, int n_slots, int n_obs,
                                   void* stream) {
  if (n_slots <= 0) return 0;
  eh_prim_site_reduce_kernel<<<blocks_for(n_slots), 256, 0, (cudaStream_t)stream>>>(
      in, out, n_slots, n_obs);
  return (int)cudaGetLastError();
}

extern "C" int eh_prim_site_update(float* vals, const int* idx, const float* fresh, int n_slots,
                                   void* stream) {
  if (n_slots <= 0) return 0;
  eh_prim_site_update_kernel<<<blocks_for(n_slots), 256, 0, (cudaStream_t)stream>>>(
      vals, idx, fresh, n_slots);
  return (int)cudaGetLastError();
}

extern "C" int eh_prim_site_chain(const float* vals, const int* idx, const float* x, float* acc,
                                  int n_slots, int n_obs, void* stream) {
  if (n_slots <= 0) return 0;
  eh_prim_site_chain_kernel<<<blocks_for(n_slots), 256, 0, (cudaStream_t)stream>>>(
      vals, idx, x, acc, n_slots, n_obs);
  return (int)cudaGetLastError();
}

extern "C" int eh_prim_block_sum(const float* partials, float* out, int n_blocks, int width,
                                 void* stream) {
  if (width <= 0) return 0;
  eh_prim_block_sum_kernel<<<blocks_for(width), 256, 0, (cudaStream_t)stream>>>(
      partials, out, n_blocks, width);
  return (int)cudaGetLastError();
}
