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
// the special-function unit, not on bandwidth. The design is the simple one:
// one thread per row, activations in per-thread arrays of a compile-time
// width (16, 32 or 64, the smallest that holds the widest layer; unrolled so
// they stay in registers), and all weights staged in shared memory once per
// block, where every thread of a warp reads the same word (a broadcast).
// The ragged tail is masked. No tensor cores: a tiled layer product, fewer
// launches and CUDA graphs are later work. At batch_size=1024, end-to-end
// predict() is expected to be bound by host chunking and the per-chunk
// host<->device copies, not by this kernel.
//
// Built without --use_fast_math: NaN predictor rows propagate to NaN
// outputs (relu is written so that it keeps NaN, as JAX's does).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define EH_MAX_WIDTH 64
#define EH_MAX_LAYERS 8
#define EH_MAX_FORCING 8
#define EH_MAX_OUTPUTS 8
#define EH_MAX_ARGS 8
#define EH_MAX_SCALARS 16
#define EH_MAX_SMEM_BYTES (48 * 1024)
#define EH_BLOCK 128

// Mirrored field by field by _Args in easyhybrid_tpu_torch/ops/fused_forward.py;
// eh_fused_forward_args_size() lets the wrapper check the two agree.
struct EhFusedForwardArgs {
  const float* x;                          // (n, dims[0]) row-major
  const float* forcing[EH_MAX_FORCING];    // (n,) each
  const float* blob;                       // packed parameters, layout below
  float* out[EH_MAX_OUTPUTS];              // mechanistic outputs, (n,) each
  float* neural_out[EH_MAX_WIDTH];         // scaled neural parameters, (n,) each
  int64_t n;
  int n_layers;
  int dims[EH_MAX_LAYERS + 1];
  int acts[EH_MAX_LAYERS];
  int has_norm;
  float norm_eps;
  int blob_floats;
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
// per layer W (dout x din, row-major) then b (dout); neural lower and span
// (P each); globals raw, lower, span (G each); fixed values (K).

enum { ACT_IDENTITY = 0, ACT_TANH, ACT_RELU, ACT_SIGMOID, ACT_SILU, ACT_GELU,
       ACT_SOFTPLUS, ACT_SELU, ACT_ELU, ACT_LEAKYRELU };
enum { SRC_FORCING = 0, SRC_NEURAL, SRC_SCALAR, SRC_CONST };
enum { FORM_RBQ10 = 0 };

__device__ __forceinline__ float eh_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float eh_act(int act, float x) {
  switch (act) {
    case ACT_TANH: return tanhf(x);
    case ACT_RELU: return x < 0.0f ? 0.0f : x;  // fmaxf would turn NaN into 0
    case ACT_SIGMOID: return eh_sigmoid(x);
    case ACT_SILU: return x * eh_sigmoid(x);
    case ACT_GELU: {  // tanh approximation, as jax.nn.gelu's default
      const float k = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
    }
    case ACT_SOFTPLUS: return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
    case ACT_SELU:
      return 1.0507009873554805f * (x > 0.0f ? x : 1.6732632423543772f * expm1f(x));
    case ACT_ELU: return x > 0.0f ? x : expm1f(x);
    case ACT_LEAKYRELU: return x >= 0.0f ? x : 0.01f * x;
    default: return x;
  }
}

// h[idx] without a dynamic index, which would move h to local memory
template <int W>
__device__ __forceinline__ float eh_pick(const float (&h)[W], int idx) {
  float v = 0.0f;
#pragma unroll
  for (int j = 0; j < W; ++j) v = (j == idx) ? h[j] : v;
  return v;
}

template <int W>
__global__ void __launch_bounds__(EH_BLOCK)
eh_fused_forward_kernel(const __grid_constant__ EhFusedForwardArgs a) {
  extern __shared__ float smem[];
  for (int i = threadIdx.x; i < a.blob_floats; i += blockDim.x) smem[i] = a.blob[i];
  __syncthreads();

  const int F = a.dims[0];
  const int P = a.dims[a.n_layers];
  const int G = a.n_globals;
  const int K = a.n_fixed;
  int off = a.has_norm ? 4 * F : 0;
  for (int l = 0; l < a.n_layers; ++l) off += a.dims[l + 1] * (a.dims[l] + 1);
  const float* nlo = smem + off;
  const float* nspan = nlo + P;
  const float* graw = nspan + P;
  const float* glo = graw + G;
  const float* gspan = glo + G;
  const float* fixed = gspan + G;
  float* scal = smem + a.blob_floats;  // scaled globals, then fixed values
  const int t = threadIdx.x;
  if (t < G) {
    scal[t] = glo[t] + gspan[t] * eh_sigmoid(graw[t]);
  } else if (t < G + K) {
    scal[t] = fixed[t - G];
  }
  __syncthreads();

  const int64_t row = (int64_t)blockIdx.x * blockDim.x + t;
  if (row >= a.n) return;

  float h[W];
  const float* xr = a.x + row * F;
#pragma unroll
  for (int k = 0; k < W; ++k) h[k] = (k < F) ? xr[k] : 0.0f;

  const float* p = smem;
  if (a.has_norm) {
    const float* mean = p;
    const float* var = p + F;
    const float* scale = p + 2 * F;
    const float* bias = p + 3 * F;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (k < F) h[k] = (h[k] - mean[k]) * rsqrtf(var[k] + a.norm_eps) * scale[k] + bias[k];
    }
    p += 4 * F;
  }

  for (int l = 0; l < a.n_layers; ++l) {
    const int din = a.dims[l];
    const int dout = a.dims[l + 1];
    const int act = a.acts[l];
    const float* w = p;
    const float* b = p + dout * din;
    p = b + dout;
    float g[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      float acc = 0.0f;
      if (j < dout) {
#pragma unroll
        for (int k = 0; k < W; ++k) {
          if (k < din) acc = fmaf(h[k], w[j * din + k], acc);
        }
        acc = eh_act(act, acc + b[j]);
      }
      g[j] = acc;
    }
#pragma unroll
    for (int j = 0; j < W; ++j) h[j] = g[j];
  }

#pragma unroll
  for (int j = 0; j < W; ++j) {
    if (j < P) {
      const float v = a.scale_nn_outputs ? nlo[j] + nspan[j] * eh_sigmoid(h[j]) : h[j];
      h[j] = v;
      a.neural_out[j][row] = v;
    }
  }

  float av[EH_MAX_ARGS];
#pragma unroll
  for (int i = 0; i < EH_MAX_ARGS; ++i) {
    float v = 0.0f;
    if (i < a.n_args) {
      const int idx = a.arg_idx[i];
      switch (a.arg_src[i]) {
        case SRC_FORCING: {
          const float* col = a.forcing[0];
#pragma unroll
          for (int f = 1; f < EH_MAX_FORCING; ++f) col = (f == idx) ? a.forcing[f] : col;
          v = col[row];
          break;
        }
        case SRC_NEURAL: v = eh_pick<W>(h, idx); break;
        case SRC_SCALAR: v = scal[idx]; break;
        default: v = a.arg_const[i]; break;
      }
    }
    av[i] = v;
  }

  float outs[EH_MAX_OUTPUTS];
#pragma unroll
  for (int o = 0; o < EH_MAX_OUTPUTS; ++o) outs[o] = nanf("");
  switch (a.form) {
    case FORM_RBQ10:  // args (rb, Q10, ta, tref): rb * Q10^(0.1 (ta - tref))
      outs[0] = av[0] * powf(av[1], 0.1f * (av[2] - av[3]));
      break;
    default: break;
  }
#pragma unroll
  for (int o = 0; o < EH_MAX_OUTPUTS; ++o) {
    if (o < a.n_out) a.out[o][row] = outs[o];
  }
}

extern "C" int eh_fused_forward_args_size(void) {
  return (int)sizeof(EhFusedForwardArgs);
}

extern "C" const char* eh_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// checks every shape against the caps above before it gets here.
extern "C" int eh_fused_forward(const EhFusedForwardArgs* args, int width, void* stream) {
  if (args->n <= 0) return 0;
  const size_t smem =
      (size_t)(args->blob_floats + args->n_globals + args->n_fixed) * sizeof(float);
  if (smem > EH_MAX_SMEM_BYTES || args->n_layers < 1 || args->n_layers > EH_MAX_LAYERS ||
      args->n_args > EH_MAX_ARGS || args->n_out > EH_MAX_OUTPUTS ||
      args->n_globals + args->n_fixed > EH_MAX_SCALARS) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned grid = (unsigned)((args->n + EH_BLOCK - 1) / EH_BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 16: eh_fused_forward_kernel<16><<<grid, EH_BLOCK, smem, s>>>(*args); break;
    case 32: eh_fused_forward_kernel<32><<<grid, EH_BLOCK, smem, s>>>(*args); break;
    case 64: eh_fused_forward_kernel<64><<<grid, EH_BLOCK, smem, s>>>(*args); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
