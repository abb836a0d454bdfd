// Fused hybrid forward (inference) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel built by make_fused_forward in
// easyhybrid_tpu/ops/fused_forward.py (kernel body at :89, pallas_call at
// :140). For every row it computes, in one pass and without writing any
// intermediate to device memory:
//   1. the optional static input norm (x - mean) * rsqrt(var + eps) * scale + bias;
//   2. the MLP layers with their activations;
//   3. the sigmoid bound scaling of each neural output;
//   4. the scaled globals and the fixed parameters (once per block);
//   5. the mechanistic model, in one of the fixed kernel forms;
//   6. a write of every mechanistic output and every scaled neural parameter.
//
// What bounds it on an H100: at the quick-start widths (2 predictors, MLP
// [16, 16], one neural parameter, one forcing) a row moves about 20 bytes of
// device memory (x, forcing, two outputs) against roughly 600 FMA-flops and
// ~35 transcendentals (expf/powf/rsqrtf), so it leans on the FMA pipes and
// the special-function unit, not on bandwidth. What the design does:
//   * The layers run the training kernels' row code (eh_device.cuh,
//     ehe_row_forward, without the residuals the backward keeps) with
//     EH_ROWS rows a thread, so one 16-byte broadcast load of four weights
//     from shared memory feeds four FMAs of every row: a layer's outputs four
//     at a time by a loop of the layer's own length, weights in the padded
//     layout (rows padded to 4 floats), the rows' inputs in registers,
//     branch-free sigmoids; a layer's outputs go through the thread's own
//     column of shared memory to the next layer.
//   * Blocks of one warp: 64 rows a block, so that a 1,024-row table still
//     spreads over 16 multiprocessors, and a table of many chunks (predict
//     launches once over all of them) gives the scheduler many small blocks.
//   * The parameters come as one padded blob, copied to shared memory 16
//     bytes at a time.
// Rows are independent: one launch over many chunks gives the same bits as
// one launch per chunk.
//
// Built without --use_fast_math: NaN predictor rows propagate to NaN
// outputs (relu is written so that it keeps NaN, as JAX's does).

#include "eh_device.cuh"

#define EH_MAX_OUTPUTS 8  // output pointers of the struct; a form writes at most EH_MAX_OUT
#define EH_BLOCK 32       // threads a block
#define EH_ROWS 2         // rows a thread

// Mirrored field by field by _Args in easyhybrid_tpu_torch/ops/fused_forward.py;
// eh_fused_forward_args_size() lets the wrapper check the two agree.
struct EhFusedForwardArgs {
  const float* x;                          // (n, dims[0]) row-major
  const float* forcing[EH_MAX_FORCING];    // (n,) each
  const float* blob;                       // packed parameters, padded layout below
  float* out[EH_MAX_OUTPUTS];              // mechanistic outputs, (n,) each
  float* neural_out[EH_MAX_WIDTH];         // scaled neural parameters, (n,) each
  int64_t n;
  int n_layers;
  int dims[EH_MAX_LAYERS + 1];
  int acts[EH_MAX_LAYERS];
  int has_norm;
  float norm_eps;
  int blob_floats;                         // a multiple of 4
  int pp_off_w[EH_MAX_LAYERS];             // layer l's weights, rows padded to 4 floats
  int pp_off_b[EH_MAX_LAYERS];             // layer l's bias
  int tail_off;                            // neural bounds, then globals and fixed values
  int n_globals;
  int n_fixed;
  int scale_nn_outputs;
  int form;
  int n_args;
  int arg_src[EH_MAX_ARGS];
  int arg_idx[EH_MAX_ARGS];
  float arg_const[EH_MAX_ARGS];
  int n_out;
};
// Blob layout (float32): [mean, var, scale, bias] (F each, when has_norm);
// per layer, from a multiple of 4, W (dout rows of din floats, each padded
// with zeros to a multiple of 4) at pp_off_w[l], then b (dout) at pp_off_b[l];
// at tail_off neural lower and span (P each), globals raw, lower, span (G
// each), fixed values (K); zeros to a multiple of 4.

template <int W>
__global__ void __launch_bounds__(EH_BLOCK)
eh_fused_forward_kernel(const __grid_constant__ EhFusedForwardArgs a) {
  constexpr int R = EH_ROWS;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int F = a.dims[0];
  const int L = a.n_layers;
  const int P = a.dims[L];
  const int G = a.n_globals;
  const int K = a.n_fixed;
  float* Pm = sm;                 // the blob
  float* RS = Pm + a.blob_floats; // rsqrt(var + eps) per feature
  float* SC = RS + F;             // scaled globals, then fixed values
  float* SCR = SC + G + K;        // each thread's column: a layer's outputs, R rows

  for (int i = tid; i < a.blob_floats / 4; i += nth)
    reinterpret_cast<float4*>(Pm)[i] = reinterpret_cast<const float4*>(a.blob)[i];
  __syncthreads();
  const float* nlo = Pm + a.tail_off;
  const float* nspan = nlo + P;
  const float* graw = nspan + P;
  const float* glo = graw + G;
  const float* gspan = glo + G;
  const float* fixed = gspan + G;
  if (a.has_norm)
    for (int k = tid; k < F; k += nth) RS[k] = rsqrtf(Pm[F + k] + a.norm_eps);
  for (int t = tid; t < G + K; t += nth)
    SC[t] = t < G ? glo[t] + gspan[t] * ehe_sigmoid(graw[t]) : fixed[t - G];
  __syncthreads();

  const int64_t base = (int64_t)blockIdx.x * nth * R + tid;  // row r of the thread: base + r nth
  float h[R][W];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t row = base + (int64_t)r * nth;
    const float* xr = a.x + (row < a.n ? row : 0) * F;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      float v = 0.0f;
      if (k < F && row < a.n) {
        v = xr[k];
        if (a.has_norm) v = (v - Pm[k]) * RS[k] * Pm[2 * F + k] + Pm[3 * F + k];
      }
      h[r][k] = v;
    }
  }

  // this thread's column: output j of row r at (j R + r) nth
  float* col = SCR + tid;
  ehe_row_forward<W, R, false>(a, Pm, h, col, R * nth, nth);

  // the network's outputs are in the column: bound scaling, the form, writes
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t row = base + (int64_t)r * nth;
    if (row >= a.n) break;
    for (int j = 0; j < P; ++j) {
      float v = col[(j * R + r) * nth];
      if (a.scale_nn_outputs) v = nlo[j] + nspan[j] * ehe_sigmoid_nb(v);
      col[(j * R + r) * nth] = v;
      a.neural_out[j][row] = v;
    }
    float av[EH_MAX_ARGS];
#pragma unroll
    for (int i = 0; i < EH_MAX_ARGS; ++i) {
      float v = 0.0f;
      if (i < a.n_args) {
        const int id = a.arg_idx[i];
        switch (a.arg_src[i]) {
          case SRC_FORCING: v = a.forcing[id][row]; break;
          case SRC_NEURAL: v = col[(id * R + r) * nth]; break;
          case SRC_SCALAR: v = SC[id]; break;
          default: v = a.arg_const[i]; break;
        }
      }
      av[i] = v;
    }
    float outs[EH_MAX_OUT];
    ehe_form_out(a.form, av, outs);
#pragma unroll
    for (int o = 0; o < EH_MAX_OUT; ++o)
      if (o < a.n_out) a.out[o][row] = outs[o];
  }
}

extern "C" int eh_fused_forward_args_size(void) {
  return (int)sizeof(EhFusedForwardArgs);
}

extern "C" const char* eh_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

template <int W>
static int eh_ff_launch(const EhFusedForwardArgs* args, size_t smem, cudaStream_t s) {
  // allow the full 227 KB once per width, not per launch
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        eh_fused_forward_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        EH_MAX_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const int64_t rows = (int64_t)EH_BLOCK * EH_ROWS;
  const unsigned grid = (unsigned)((args->n + rows - 1) / rows);
  eh_fused_forward_kernel<W><<<grid, EH_BLOCK, smem, s>>>(*args);
  return (int)cudaGetLastError();
}

// Launch once over the n rows on `stream`; returns cudaGetLastError() (0 on
// success). The caller checks every shape against the caps above first.
extern "C" int eh_fused_forward(const EhFusedForwardArgs* args, int width, void* stream) {
  if (args->n <= 0) return 0;
  const size_t smem = ((size_t)args->blob_floats + args->dims[0] + args->n_globals +
                       args->n_fixed + (size_t)width * EH_ROWS * EH_BLOCK) * sizeof(float);
  if (smem > EH_MAX_SMEM_BYTES || args->n_layers < 1 || args->n_layers > EH_MAX_LAYERS ||
      args->n_args > EH_MAX_ARGS || args->n_out > EH_MAX_OUT ||
      args->n_globals + args->n_fixed > EH_MAX_SCALARS || args->blob_floats % 4 != 0 ||
      ((uintptr_t)args->blob & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 16: return eh_ff_launch<16>(args, smem, s);
    case 32: return eh_ff_launch<32>(args, smem, s);
    case 64: return eh_ff_launch<64>(args, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
