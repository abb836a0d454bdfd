// Fused training epochs of a wide MLP hybrid for Hopper, sm_90a.
//
// Replaces the batch-chunked variant of the Pallas TPU kernel built by
// make_fused_epoch in easyhybrid_tpu/ops/fused_epoch.py: kernel_body_elem
// (:1541), chosen at :2374 when _pick_batch_chunks (:409) gives more than one
// chunk (the tower [1024, 512, 256, 128, 64] at batch 1,024); pallas_call at
// :2662. There each batch rides several grid steps at chunk width, the chunks'
// gradients are summed in carried tiles and the update is applied at the last
// chunk. The function, without the TPU's chunking: per optimizer step, the
// whole-batch gradient of the masked elementwise loss (mse or mae) of a
// static-norm MLP hybrid, summed in a fixed order, then one gated update of
// every parameter. One call of the launcher enqueues every step of
// n_epochs x n_batches batches on one stream; the host never waits between
// steps. Each step:
//   1. eh_wide_gather_kernel: the batch's rows through the row index
//      perm[e][b * batch + r], the static input norm and its scale and bias;
//   2. eh_wide_forward_kernel per layer: A = act(H W^T + b), with act'(z)
//      kept beside it;
//   3. eh_wide_head_kernel, one thread per row: sigmoid bound scaling, the
//      mechanistic model in its kernel form with its partials, the masked loss
//      and its cotangent with the batch-wide scale computed by the caller, the
//      last layer's pre-activation cotangent, and per-block sums of the loss
//      and of every global's gradient;
//   4. per layer backwards, eh_wide_bwd_weight_kernel (dW = dZ^T H and
//      db = sum dZ, the batch split among blocks where the output tiles alone
//      would not fill the card, each split leaving its own partial tile) and
//      eh_wide_bwd_data_kernel (dZ_prev = (dZ W) * act'_prev, in place);
//      eh_wide_norm_grad_kernel for the norm's scale and bias;
//   5. eh_wide_update_kernel, one thread per parameter: sums the parameter's
//      partials in split order (no float atomicAdd anywhere: the same inputs
//      give the same bits) and applies the optax adam or sgd update, unless
//      the batch holds no valid target: then nothing changes.
//
// The layer products are this file's own: an output tile of 64 x 64 per block
// of 256 threads, the inner dimension walked through shared-memory tiles of 16
// (the next tile fetched into registers while the current one is multiplied),
// a 4 x 4 register tile per thread, float32 FMA. Parameters, moments and the
// activations (batch x sum of widths x 2 floats, 16 MB at the main shape) live
// in device memory; between steps they stay in the 50 MB L2.
//
// What bounds it on an H100: a step of the tower is three passes of
// 2 x 1,024 x 698,432 = 4.29 GFLOP against 16.8 MB of parameters and moments
// read and written: operations (0.064 ms at the float32 peak), not bytes
// (0.005 ms). Tensor-core tiles (wgmma), TMA and a persistent grid are for a
// later change.
//
// Built without --use_fast_math, as fused_forward.cu.

#include "eh_device.cuh"

#define EH_WIDE_MAX_WIDTH 4096
#define EHW_TILE 64
#define EHW_BK 16
#define EHW_LD (EHW_TILE + 4)  // row stride of a shared tile: keeps float4 reads aligned
#define EHW_THREADS 256
#define EHW_HEAD_THREADS 256

// Mirrored field by field by _Args in easyhybrid_tpu_torch/ops/fused_wide.py;
// eh_fused_wide_args_size() lets the wrapper check the two agree.
struct EhFusedWideArgs {
  const float* x;                        // (n_rows, dims[0]) row-major
  const float* forcing[EH_MAX_FORCING];  // (n_rows) each
  const float* y[EH_MAX_TARGETS];        // (n_rows) each, 0 where masked
  const float* mask[EH_MAX_TARGETS];     // (n_rows) each, 0 or 1
  const int* perm;                       // (n_epochs, n_batches * batch) row of every slot
  const float* scale;                    // (n_epochs, n_batches, n_targets) loss scales
  const float* valid;                    // (n_epochs, n_batches) 1 if any target is valid
  const float* tcount;                   // (n_epochs, n_batches) step count after the step
  float* params;                         // packed parameters, in place
  float* m;                              // first moments, like params, in place
  float* v;                              // second moments, like params, in place
  const float* bn;                       // static norm mean, var (2 dims[0])
  const float* consts;                   // neural lo, span; global lo, span; fixed
  float* ws;                             // one step's activations (ws_off_*)
  float* partials;                       // weight-gradient partial tiles (part_off*)
  float* head_partials;                  // (head_blocks, 1 + n_globals): loss, globals
  float* epoch_loss;                     // (n_epochs) sum of valid batch losses, zero on entry
  int64_t n_rows;
  int64_t ws_off_h0;                     // (batch, dims[0]) the first layer's input
  int64_t ws_off_xhat;                   // (batch, dims[0]) normed input, with a norm
  int64_t ws_off_d0;                     // (batch, dims[0]) its cotangent, with a norm
  int64_t ws_off_a[EH_MAX_LAYERS];       // (batch, dims[l + 1]) layer l's output
  int64_t ws_off_d[EH_MAX_LAYERS];       // (batch, dims[l + 1]) act'(z), then dZ
  int64_t part_off[EH_MAX_LAYERS];       // layer l: splits[l] tiles of [dW (dout x din), db]
  int64_t part_off_norm;                 // norm_splits rows of [dscale, dbias]
  int n_epochs;
  int n_batches;
  int batch;
  int n_layers;
  int dims[EH_MAX_LAYERS + 1];
  int acts[EH_MAX_LAYERS];
  int norm_mode;                         // 0 none, 1 static
  float norm_eps;
  int n_params;
  int p_off_w[EH_MAX_LAYERS];
  int p_off_b[EH_MAX_LAYERS];
  int p_off_g;
  int n_globals;
  int n_fixed;
  int scale_nn_outputs;
  int form;
  int n_args;
  int arg_src[EH_MAX_ARGS];
  int arg_idx[EH_MAX_ARGS];
  float arg_const[EH_MAX_ARGS];
  int n_targets;
  int target_out[EH_MAX_TARGETS];
  int loss_kind;                         // 0 squared (mse), 1 absolute (mae)
  int opt;                               // 0 sgd, 1 adam
  float lr;
  float b1;
  float b2;
  float one_minus_b1;
  float one_minus_b2;
  float eps;
  int splits[EH_MAX_LAYERS];             // batch splits of layer l's weight gradient
  int split_rows[EH_MAX_LAYERS];         // rows of one split, a multiple of EHW_BK
  int norm_splits;
  int norm_split_rows;
  int head_blocks;
};
// Packed parameters: [norm scale, norm bias] (dims[0] each, with a norm); per
// layer W (dout x din, row-major) at p_off_w[l], then b (dout) at p_off_b[l];
// the raw globals at p_off_g.

enum { LOSS_SQUARED = 0, LOSS_ABSOLUTE };

// ---------------------------------------------------------------------------
// the tiled product
// ---------------------------------------------------------------------------

// A thread's share of the EHW_TILE x EHW_BK tile at (i0, k0) of a matrix:
// elements e = threadIdx.x + q * EHW_THREADS of the tile, with (i, k) =
// (e / EHW_BK, e % EHW_BK) where k is contiguous in memory (KC: element (i, k)
// is src[i * ld + k]) and (e % EHW_TILE, e / EHW_TILE) where i is (src[k * ld +
// i]), so that neighbouring threads read neighbouring addresses either way.
#define EHW_SHARE (EHW_TILE * EHW_BK / EHW_THREADS)

template <bool KC>
__device__ __forceinline__ void ehw_tile_index(int q, int* i, int* k) {
  const int e = threadIdx.x + q * EHW_THREADS;
  if (KC) {
    *i = e / EHW_BK;
    *k = e % EHW_BK;
  } else {
    *k = e / EHW_TILE;
    *i = e % EHW_TILE;
  }
}

// Device memory to registers; zero where i >= ni or k >= nk.
template <bool KC>
__device__ __forceinline__ void ehw_fetch(float (&reg)[EHW_SHARE], const float* __restrict__ src,
                                          int ld, int i0, int ni, int k0, int nk) {
#pragma unroll
  for (int q = 0; q < EHW_SHARE; ++q) {
    int i, k;
    ehw_tile_index<KC>(q, &i, &k);
    const int gi = i0 + i;
    const int gk = k0 + k;
    float val = 0.0f;
    if (gi < ni && gk < nk)
      val = KC ? src[(int64_t)gi * ld + gk] : src[(int64_t)gk * ld + gi];
    reg[q] = val;
  }
}

// Registers to the shared tile dst[k][i].
template <bool KC>
__device__ __forceinline__ void ehw_stage(float (*dst)[EHW_LD], const float (&reg)[EHW_SHARE]) {
#pragma unroll
  for (int q = 0; q < EHW_SHARE; ++q) {
    int i, k;
    ehw_tile_index<KC>(q, &i, &k);
    dst[k][i] = reg[q];
  }
}

// acc[i][j] = sum over k in [k0, k1) of A(m0 + 4 ty + i, k) B(k, n0 + 4 tx + j),
// k ascending, with ty = threadIdx.x / 16 and tx = threadIdx.x % 16. A(m, k) is
// A[m * lda + k] (AKC) or A[k * lda + m]; B(k, n) is B[n * ldb + k] (BKC) or
// B[k * ldb + n]. With want_rowsum, thread t < EHW_TILE also returns the sum
// over k of A(m0 + t, k), k ascending. The next tiles are fetched into
// registers while the current ones are multiplied, so a block that has its
// multiprocessor to itself (the forward products of the widest layers are
// 128 blocks) still overlaps the loads with the arithmetic.
template <bool AKC, bool BKC>
__device__ __forceinline__ float ehw_product(const float* __restrict__ A, int lda,
                                             const float* __restrict__ B, int ldb, int m0, int M,
                                             int n0, int N, int k0, int k1, bool want_rowsum,
                                             float (&acc)[4][4]) {
  __shared__ __align__(16) float As[EHW_BK][EHW_LD];
  __shared__ __align__(16) float Bs[EHW_BK][EHW_LD];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  float rowsum = 0.0f;
  float ra[EHW_SHARE], rb[EHW_SHARE];
  ehw_fetch<AKC>(ra, A, lda, m0, M, k0, k1);
  ehw_fetch<BKC>(rb, B, ldb, n0, N, k0, k1);
  for (int kt = k0; kt < k1; kt += EHW_BK) {
    ehw_stage<AKC>(As, ra);
    ehw_stage<BKC>(Bs, rb);
    __syncthreads();
    if (kt + EHW_BK < k1) {
      ehw_fetch<AKC>(ra, A, lda, m0, M, kt + EHW_BK, k1);
      ehw_fetch<BKC>(rb, B, ldb, n0, N, kt + EHW_BK, k1);
    }
    if (want_rowsum && tid < EHW_TILE) {
#pragma unroll
      for (int kk = 0; kk < EHW_BK; ++kk) rowsum += As[kk][tid];
    }
#pragma unroll
    for (int kk = 0; kk < EHW_BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  return rowsum;
}

// A[r][j] = act(sum_k H[r][k] W[j][k] + b[j]) and DA[r][j] = act'(z): M rows,
// N = dout outputs, K = din inputs. Grid (ceil(N / 64), ceil(M / 64)).
__global__ void __launch_bounds__(EHW_THREADS)
eh_wide_forward_kernel(const float* __restrict__ H, const float* __restrict__ W,
                       const float* __restrict__ b, float* __restrict__ A_out,
                       float* __restrict__ DA, int M, int N, int K, int act) {
  const int m0 = blockIdx.y * EHW_TILE;
  const int n0 = blockIdx.x * EHW_TILE;
  float acc[4][4];
  ehw_product<true, true>(H, K, W, K, m0, M, n0, N, 0, K, false, acc);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c >= N) continue;
      float d;
      const float y = ehe_act(act, acc[i][j] + b[c], &d);
      A_out[(int64_t)r * N + c] = y;
      DA[(int64_t)r * N + c] = d;
    }
  }
}

// out[r][k] = sum_j dZ[r][j] W[j][k], times out[r][k] itself where
// scale_in_place (out then holds act'(z) of the layer below on entry and its
// pre-activation cotangent on return): M rows, N = din, K = dout.
__global__ void __launch_bounds__(EHW_THREADS)
eh_wide_bwd_data_kernel(const float* __restrict__ dZ, const float* __restrict__ W, float* out,
                        int M, int N, int K, int scale_in_place) {
  const int m0 = blockIdx.y * EHW_TILE;
  const int n0 = blockIdx.x * EHW_TILE;
  float acc[4][4];
  ehw_product<true, false>(dZ, K, W, N, m0, M, n0, N, 0, K, false, acc);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c >= N) continue;
      const int64_t o = (int64_t)r * N + c;
      out[o] = scale_in_place ? acc[i][j] * out[o] : acc[i][j];
    }
  }
}

// Split blockIdx.z of the batch: dW[j][k] = sum_r dZ[r][j] H[r][k] over the
// split's rows, written to part[split][j * din + k], and db[j] = sum_r dZ[r][j]
// to part[split][dout * din + j]: M = dout, N = din.
__global__ void __launch_bounds__(EHW_THREADS)
eh_wide_bwd_weight_kernel(const float* __restrict__ dZ, const float* __restrict__ H,
                          float* __restrict__ part, int M, int N, int batch, int split_rows) {
  const int m0 = blockIdx.y * EHW_TILE;
  const int n0 = blockIdx.x * EHW_TILE;
  const int r0 = blockIdx.z * split_rows;
  const int r1 = min(batch, r0 + split_rows);
  const bool bias = blockIdx.x == 0;
  float acc[4][4];
  const float rowsum = ehw_product<false, false>(dZ, M, H, N, m0, M, n0, N, r0, r1, bias, acc);
  float* out = part + (int64_t)blockIdx.z * M * (N + 1);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = m0 + ty * 4 + i;
    if (j >= M) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = n0 + tx * 4 + jj;
      if (c < N) out[(int64_t)j * N + c] = acc[i][jj];
    }
  }
  if (bias && threadIdx.x < EHW_TILE && m0 + threadIdx.x < M)
    out[(int64_t)M * N + m0 + threadIdx.x] = rowsum;
}

// ---------------------------------------------------------------------------
// the step's other kernels
// ---------------------------------------------------------------------------

// The batch's rows through the row index, normed: one thread per (row, feature).
__global__ void __launch_bounds__(256)
eh_wide_gather_kernel(const __grid_constant__ EhFusedWideArgs a, int step) {
  const int F = a.dims[0];
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)a.batch * F) return;
  const int r = (int)(e / F);
  const int k = (int)(e % F);
  const int64_t row = a.perm[(int64_t)step * a.batch + r];
  float h = a.x[row * F + k];
  if (a.norm_mode != NORM_NONE) {
    const float xh = (h - a.bn[k]) * rsqrtf(a.bn[F + k] + a.norm_eps);
    a.ws[a.ws_off_xhat + e] = xh;
    h = xh * a.params[k] + a.params[F + k];
  }
  a.ws[a.ws_off_h0 + e] = h;
}

// One thread per row: from the raw network outputs to the last layer's
// pre-activation cotangent, and the block's sums of the loss and of the
// globals' gradients.
__global__ void __launch_bounds__(EHW_HEAD_THREADS)
eh_wide_head_kernel(const __grid_constant__ EhFusedWideArgs a, int step) {
  __shared__ float red[EHW_HEAD_THREADS];
  const int tid = threadIdx.x;
  const int r = blockIdx.x * EHW_HEAD_THREADS + tid;
  const int L = a.n_layers;
  const int P = a.dims[L];
  const int G = a.n_globals;
  const int T = a.n_targets;
  const float* nlo = a.consts;
  const float* nspan = a.consts + P;
  const float* glo = a.consts + 2 * P;
  const float* gspan = a.consts + 2 * P + G;
  const float* fixed = a.consts + 2 * P + 2 * G;

  float term = 0.0f;
  float gg[EH_MAX_SCALARS];
#pragma unroll
  for (int j = 0; j < EH_MAX_SCALARS; ++j) gg[j] = 0.0f;

  if (r < a.batch) {
    const int64_t row = a.perm[(int64_t)step * a.batch + r];
    const float* raw = a.ws + a.ws_off_a[L - 1] + (int64_t)r * P;
    float* dl = a.ws + a.ws_off_d[L - 1] + (int64_t)r * P;

    float av[EH_MAX_ARGS];
#pragma unroll
    for (int i = 0; i < EH_MAX_ARGS; ++i) {
      float val = 0.0f;
      if (i < a.n_args) {
        const int id = a.arg_idx[i];
        switch (a.arg_src[i]) {
          case SRC_FORCING: {
            const float* col = a.forcing[0];
#pragma unroll
            for (int f = 1; f < EH_MAX_FORCING; ++f) col = (f == id) ? a.forcing[f] : col;
            val = col[row];
            break;
          }
          case SRC_NEURAL:
            val = raw[id];
            if (a.scale_nn_outputs) val = nlo[id] + nspan[id] * ehe_sigmoid(val);
            break;
          case SRC_SCALAR:
            val = id < G ? glo[id] + gspan[id] * ehe_sigmoid(a.params[a.p_off_g + id])
                         : fixed[id - G];
            break;
          default: val = a.arg_const[i]; break;
        }
      }
      av[i] = val;
    }
    float out[EH_MAX_OUT];
    float pd[EH_MAX_OUT][EH_MAX_ARGS];
    ehe_form(a.form, av, out, pd);

    // masked loss and its cotangent; the mask selects, so a NaN target that
    // the caller did not zero cannot reach the sums
    float cot[EH_MAX_TARGETS];
#pragma unroll
    for (int j = 0; j < EH_MAX_TARGETS; ++j) {
      cot[j] = 0.0f;
      if (j < T) {
        const bool on = a.mask[j][row] > 0.0f;
        const float pred = ehe_pick<EH_MAX_OUT>(out, a.target_out[j]);
        const float diff = on ? pred - a.y[j][row] : 0.0f;
        const float sc = a.scale[(int64_t)step * T + j];
        if (a.loss_kind == LOSS_ABSOLUTE) {
          term += sc * fabsf(diff);
          cot[j] = sc * (diff > 0.0f ? 1.0f : (diff < 0.0f ? -1.0f : 0.0f));
        } else {
          term += sc * diff * diff;
          cot[j] = (2.0f * sc) * diff;
        }
      }
    }

    // each argument's cotangent, through the form's partials
    float c[EH_MAX_ARGS];
#pragma unroll
    for (int i = 0; i < EH_MAX_ARGS; ++i) {
      c[i] = 0.0f;
      if (i < a.n_args) {
        const int src = a.arg_src[i];
        const int id = a.arg_idx[i];
        if (src == SRC_NEURAL || (src == SRC_SCALAR && id < G)) {
          float ci = 0.0f;
#pragma unroll
          for (int j = 0; j < EH_MAX_TARGETS; ++j) {
            if (j < T) {
              float part = 0.0f;
#pragma unroll
              for (int o = 0; o < EH_MAX_OUT; ++o)
                part = (o == a.target_out[j]) ? pd[o][i] : part;
              ci += cot[j] * part;
            }
          }
          c[i] = ci;
          if (src == SRC_SCALAR) {
#pragma unroll
            for (int j = 0; j < EH_MAX_SCALARS; ++j) gg[j] += (j == id) ? ci : 0.0f;
          }
        }
      }
    }

    // the raw outputs' cotangent through the bound scaling and the last
    // layer's activation
    for (int j = 0; j < P; ++j) {
      float dn = 0.0f;
#pragma unroll
      for (int i = 0; i < EH_MAX_ARGS; ++i)
        if (i < a.n_args && a.arg_src[i] == SRC_NEURAL && a.arg_idx[i] == j) dn += c[i];
      float dsc = 1.0f;
      if (a.scale_nn_outputs) {
        const float sg = ehe_sigmoid(raw[j]);
        dsc = nspan[j] * (sg * (1.0f - sg));
      }
      dl[j] = (dn * dsc) * dl[j];
    }
  }

  // the block's sums, pairwise in a fixed order
  for (int q = 0; q <= G; ++q) {
    red[tid] = q == 0 ? term : ehe_pick<EH_MAX_SCALARS>(gg, q - 1);
    __syncthreads();
    for (int s = EHW_HEAD_THREADS / 2; s > 0; s >>= 1) {
      if (tid < s) red[tid] += red[tid + s];
      __syncthreads();
    }
    if (tid == 0) a.head_partials[(int64_t)blockIdx.x * (1 + G) + q] = red[0];
    __syncthreads();
  }
}

// Block s sums its rows of the norm's gradients: dscale[k] = sum_r d0 xhat,
// dbias[k] = sum_r d0, in row order.
__global__ void __launch_bounds__(128)
eh_wide_norm_grad_kernel(const __grid_constant__ EhFusedWideArgs a) {
  const int F = a.dims[0];
  const int r0 = blockIdx.x * a.norm_split_rows;
  const int r1 = min(a.batch, r0 + a.norm_split_rows);
  const float* d0 = a.ws + a.ws_off_d0;
  const float* xh = a.ws + a.ws_off_xhat;
  float* out = a.partials + a.part_off_norm + (int64_t)blockIdx.x * 2 * F;
  for (int q = threadIdx.x; q < 2 * F; q += blockDim.x) {
    const int k = q < F ? q : q - F;
    float s = 0.0f;
    if (q < F) {
      for (int r = r0; r < r1; ++r) s = fmaf(d0[(int64_t)r * F + k], xh[(int64_t)r * F + k], s);
    } else {
      for (int r = r0; r < r1; ++r) s += d0[(int64_t)r * F + k];
    }
    out[q] = s;
  }
}

// One thread per parameter: the gradient from its partials, in split order,
// then the update; thread n_params adds the batch loss to its epoch's sum.
__global__ void __launch_bounds__(256)
eh_wide_update_kernel(const __grid_constant__ EhFusedWideArgs a, int step) {
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int NP = a.n_params;
  if (gid > NP) return;
  const int F = a.dims[0];
  const int L = a.n_layers;
  const int G = a.n_globals;
  const bool valid = a.valid[step] > 0.0f;

  if (gid == NP) {
    float loss = 0.0f;
    for (int b = 0; b < a.head_blocks; ++b) loss += a.head_partials[(int64_t)b * (1 + G)];
    if (valid) a.epoch_loss[step / a.n_batches] += loss;
    return;
  }
  float g = 0.0f;
  if (gid >= a.p_off_g) {
    const int gi = (int)(gid - a.p_off_g);
    for (int b = 0; b < a.head_blocks; ++b) g += a.head_partials[(int64_t)b * (1 + G) + 1 + gi];
    const int P = a.dims[L];
    const float span = a.consts[2 * P + G + gi];
    const float sg = ehe_sigmoid(a.params[gid]);
    g = g * (span * (sg * (1.0f - sg)));
  } else if (a.norm_mode != NORM_NONE && gid < 2 * F) {
    const float* part = a.partials + a.part_off_norm + gid;
    for (int s = 0; s < a.norm_splits; ++s) g += part[(int64_t)s * 2 * F];
  } else {
    int l = 0;
    while (l + 1 < L && gid >= a.p_off_w[l + 1]) ++l;
    const int64_t size = (int64_t)a.dims[l + 1] * (a.dims[l] + 1);
    const float* part = a.partials + a.part_off[l] + (gid - a.p_off_w[l]);
    for (int s = 0; s < a.splits[l]; ++s) g += part[s * size];
  }
  if (valid) {
    const float tc = fmaxf(a.tcount[step], 1.0f);
    const float bc1 = 1.0f - powf(a.b1, tc);
    const float bc2 = 1.0f - powf(a.b2, tc);
    ehe_update(a, &a.params[gid], &a.m[gid], &a.v[gid], g, bc1, bc2);
  }
}

extern "C" int eh_fused_wide_args_size(void) { return (int)sizeof(EhFusedWideArgs); }

static inline int ehw_ceil_div(int a, int b) { return (a + b - 1) / b; }

// Enqueue every step of the call on `stream`; returns cudaGetLastError() (0
// on success). The caller checks shapes, devices and the envelope first.
extern "C" int eh_fused_wide(const EhFusedWideArgs* args, void* stream) {
  const EhFusedWideArgs& a = *args;
  if (a.n_epochs <= 0 || a.n_batches <= 0) return 0;
  const int L = a.n_layers;
  if (L < 1 || L > EH_MAX_LAYERS || a.batch < 1 || a.n_args > EH_MAX_ARGS || a.n_targets < 1 ||
      a.n_targets > EH_MAX_TARGETS || a.n_globals + a.n_fixed > EH_MAX_SCALARS ||
      a.head_blocks * EHW_HEAD_THREADS < a.batch || (a.norm_mode != NORM_NONE && a.norm_splits < 1))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l <= L; ++l)
    if (a.dims[l] < 1 || a.dims[l] > EH_WIDE_MAX_WIDTH) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l)
    if (a.splits[l] < 1 || a.split_rows[l] % EHW_BK != 0 ||
        (int64_t)a.splits[l] * a.split_rows[l] < a.batch)
      return (int)cudaErrorInvalidValue;

  cudaStream_t s = (cudaStream_t)stream;
  const int B = a.batch;
  const int F = a.dims[0];
  const bool norm = a.norm_mode != NORM_NONE;
  const int row_tiles = ehw_ceil_div(B, EHW_TILE);
  const int gather_blocks = (int)(((int64_t)B * F + 255) / 256);
  const int update_blocks = ehw_ceil_div(a.n_params + 1, 256);
  const int steps = a.n_epochs * a.n_batches;
  for (int step = 0; step < steps; ++step) {
    eh_wide_gather_kernel<<<gather_blocks, 256, 0, s>>>(a, step);
    for (int l = 0; l < L; ++l) {
      const float* h = a.ws + (l == 0 ? a.ws_off_h0 : a.ws_off_a[l - 1]);
      const dim3 grid(ehw_ceil_div(a.dims[l + 1], EHW_TILE), row_tiles);
      eh_wide_forward_kernel<<<grid, EHW_THREADS, 0, s>>>(
          h, a.params + a.p_off_w[l], a.params + a.p_off_b[l], a.ws + a.ws_off_a[l],
          a.ws + a.ws_off_d[l], B, a.dims[l + 1], a.dims[l], a.acts[l]);
    }
    eh_wide_head_kernel<<<a.head_blocks, EHW_HEAD_THREADS, 0, s>>>(a, step);
    for (int l = L - 1; l >= 0; --l) {
      const int din = a.dims[l];
      const int dout = a.dims[l + 1];
      const float* h = a.ws + (l == 0 ? a.ws_off_h0 : a.ws_off_a[l - 1]);
      const float* dz = a.ws + a.ws_off_d[l];
      const dim3 wgrid(ehw_ceil_div(din, EHW_TILE), ehw_ceil_div(dout, EHW_TILE), a.splits[l]);
      eh_wide_bwd_weight_kernel<<<wgrid, EHW_THREADS, 0, s>>>(
          dz, h, a.partials + a.part_off[l], dout, din, B, a.split_rows[l]);
      if (l > 0 || norm) {
        float* out = a.ws + (l > 0 ? a.ws_off_d[l - 1] : a.ws_off_d0);
        const dim3 dgrid(ehw_ceil_div(din, EHW_TILE), row_tiles);
        eh_wide_bwd_data_kernel<<<dgrid, EHW_THREADS, 0, s>>>(
            dz, a.params + a.p_off_w[l], out, B, din, dout, l > 0 ? 1 : 0);
      }
    }
    if (norm) eh_wide_norm_grad_kernel<<<a.norm_splits, 128, 0, s>>>(a);
    eh_wide_update_kernel<<<update_blocks, 256, 0, s>>>(a, step);
  }
  return (int)cudaGetLastError();
}
