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
//   2. per layer forward, A = act(H W^T + b), with act'(z) kept beside it;
//   3. eh_wide_head_kernel, one thread per row: sigmoid bound scaling, the
//      mechanistic model in its kernel form with its partials, the masked loss
//      and its cotangent with the batch-wide scale computed by the caller, the
//      last layer's pre-activation cotangent, and per-block sums of the loss
//      and of every global's gradient;
//   4. per layer backwards, the weight gradient (dW = dZ^T H and db = sum dZ,
//      the batch split among blocks, each split leaving its own partial tile)
//      and the data gradient (dZ_prev = (dZ W) * act'_prev, in place);
//      eh_wide_norm_grad_kernel for the norm's scale and bias;
//   5. eh_wide_update_kernel: sums each parameter's partials in split order
//      and applies the update by any of the optax rules of the JAX kernel
//      (eh_device.cuh, ehe_update), unless the batch holds no valid target:
//      then nothing changes. Under lamb it runs twice: first each block writes
//      its part of every leaf's norms, then every block adds those parts in
//      block order and updates.
// No atomics anywhere: every sum runs in a fixed order, so the same inputs
// give the same bits.
//
// The layer products. A layer whose inputs and outputs both number at least
// EHW_TC_MIN runs its three products on the tensor cores
// (eh_wide_tc_kernel): wgmma.mma_async m64n64k8 with TF32 operands from shared
// memory, in 3xTF32. Each float32 operand x is split into big = tf32(x) and
// small = tf32(x - big) (cvt.rna), and the block accumulates big*big +
// big*small + small*big in float32: about 21 bits of each operand, so the
// products keep float32 accuracy at a third of the TF32 rate. A TF32 wgmma
// takes only K-major tiles, so every operand is written where its product
// reads it with k contiguous: the gather and each forward write the layer
// input H^T (feature-major) beside H for the weight gradient, the head and
// each data gradient write dZ^T beside dZ, and the update writes W^T (a
// scratch copy in the workspace, made from the parameters at the start of
// every call) for the data gradient. A block of 2 BM threads (BM / 64
// warpgroups) owns a BM x 64 output tile and one piece of the inner
// dimension; it fetches each 32-deep slice of both operands into registers
// two slices ahead, splits it and stores big and small in shared memory as
// 8 x 16-byte core matrices (no swizzle), two stages deep, so the next slice
// is split and stored while the tensor cores work on the current one. The
// tensor cores' float32 sums truncate, so they are moved to float32
// registers after every slice. The forward and the data gradient cut their
// inner dimension into pieces so that small products fill the card: a
// tile's pieces are one thread-block cluster, each block keeps its partial
// tile in shared memory, and after a cluster barrier each sums a band of the
// tile's rows over the pieces in piece order and finishes it (ehw_finish).
// The weight gradient splits the batch and leaves the sum to the update.
// Tile shapes and pieces come from the plan (wide_geometry in
// ops/fused_wide.py); the launcher checks them. The edge layers (the input
// layer's K = dims[0], the output layer's N = 1) keep the float32 FMA tile
// of 64 x 64 (eh_wide_forward_kernel, eh_wide_bwd_weight_kernel,
// eh_wide_bwd_data_kernel), cut and finished the same way.
//
// What bounds it on an H100: a step of the tower is three passes of
// 2 x 1,024 x 698,432 = 4.29 GFLOP against 16.8 MB of parameters and moments
// read and written: operations, not bytes (0.005 ms). In float32 FMA that is
// 0.064 ms a step; in 3xTF32 on the tensor cores (495 TFLOP/s, three products
// each) 0.026 ms a step, 0.416 ms an epoch of 16 steps.
//
// Built without --use_fast_math, as fused_forward.cu.

#include "eh_device.cuh"

#include <stdint.h>

#include <utility>

#define EH_WIDE_MAX_WIDTH 4096
#define EHW_TILE 64
#define EHW_BK 16
#define EHW_LD (EHW_TILE + 4)  // row stride of a shared tile: keeps float4 reads aligned
#define EHW_THREADS 256
#define EHW_HEAD_THREADS 256
#define EHW_TC_BK 32           // depth of a staged tensor-core slice: four wgmma k-steps of 8
#define EHW_TC_MIN 16          // the narrowest layer side whose products take the tensor cores
#define EHW_UTILE 32           // the update's square tile of a tensor-core layer's W
#define EHW_GROUP 8            // rows a thread sums over a tile's pieces at a time

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
  float* u;                              // amsgrad's third slot, like params (else unused)
  const float* bn;                       // static norm mean, var (2 dims[0])
  const float* consts;                   // neural lo, span; global lo, span; fixed
  float* ws;                             // one step's activations (ws_off_*)
  float* partials;                       // weight-gradient partial tiles (part_off*)
  float* head_partials;                  // (head_blocks, 1 + n_globals): loss, globals
  float* epoch_loss;                     // (n_epochs) sum of valid batch losses, zero on entry
  float* lamb_parts;                     // lamb: (update blocks, 2 n_leaves) scratch, else unused
  int64_t n_rows;
  int64_t ws_off_h0;                     // (batch, dims[0]) the first layer's input
  int64_t ws_off_xhat;                   // (batch, dims[0]) normed input, with a norm
  int64_t ws_off_d0;                     // (batch, dims[0]) its cotangent, with a norm
  int64_t ws_off_a[EH_MAX_LAYERS];       // (batch, dims[l + 1]) layer l's output
  int64_t ws_off_d[EH_MAX_LAYERS];       // (batch, dims[l + 1]) act'(z), then dZ
  int64_t part_off[EH_MAX_LAYERS];       // layer l: splits[l] tiles of [dW (dout x din), db]
  int64_t part_off_norm;                 // norm_splits rows of [dscale, dbias]
  int64_t ws_off_ht[EH_MAX_LAYERS];      // (dims[l], batch) layer l's input, feature-major (tc[l])
  int64_t ws_off_dt[EH_MAX_LAYERS];      // (dims[l + 1], batch) layer l's dZ, feature-major (tc[l])
  int64_t ws_off_wt[EH_MAX_LAYERS];      // (dims[l], dims[l + 1]) layer l's W transposed (tc[l])
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
  EhOptimizer optimizer;                 // the rule and its hyperparameters
  int splits[EH_MAX_LAYERS];             // batch splits of layer l's weight gradient
  int split_rows[EH_MAX_LAYERS];         // rows of one split, a multiple of its product's depth
  int norm_splits;
  int norm_split_rows;
  int head_blocks;
  int tc[EH_MAX_LAYERS];                 // 1: layer l's three products on the tensor cores
  int fwd_bm[EH_MAX_LAYERS];             // layer l's forward: output tile rows (of the batch)
  int fwd_bn[EH_MAX_LAYERS];             //   output tile columns (of dout)
  int fwd_splits[EH_MAX_LAYERS];         //   pieces of its inner dimension (din), a cluster
  int fwd_split_k[EH_MAX_LAYERS];        //   inner extent of one piece
  int dat_bm[EH_MAX_LAYERS];             // layer l's data gradient: tile rows (of the batch)
  int dat_bn[EH_MAX_LAYERS];             //   tile columns (of din)
  int dat_splits[EH_MAX_LAYERS];         //   pieces of its inner dimension (dout), a cluster
  int dat_split_k[EH_MAX_LAYERS];        //   inner extent of one piece
  int wgt_bm[EH_MAX_LAYERS];             // layer l's weight gradient: tile rows (of dout)
  int wgt_bn[EH_MAX_LAYERS];             //   tile columns (of din); its batch splits above
};
// Packed parameters: [norm scale, norm bias] (dims[0] each, with a norm); per
// layer W (dout x din, row-major) at p_off_w[l], then b (dout) at p_off_b[l];
// the raw globals at p_off_g.

enum { LOSS_SQUARED = 0, LOSS_ABSOLUTE };

// ---------------------------------------------------------------------------
// what becomes of a product's output tile
// ---------------------------------------------------------------------------

enum { EHW_RAW = 0, EHW_FORWARD, EHW_DATA, EHW_WEIGHT };

// One layer product C = A B (M x N over K, the inner dimension in pieces of
// split_k over blockIdx.z) and what becomes of C, on either route.
struct EhwProduct {
  const float* A;
  const float* B;
  int lda;
  int ldb;
  int M;
  int N;
  int K;
  int split_k;
  int mode;
  int act;             // forward: the activation
  int scale_in_place;  // data: C times out's entry (act'(z) of the layer below)
  const float* bias;   // forward: b (N)
  float* out;          // raw: C (M x N); forward: act(C + b); data: C, or C * out in place;
                       // weight: piece z's partial tile [dW (M x N), db (M)] at z M (N + 1)
  float* da;           // forward: act'(C + b)
  float* out_t;        // forward, data: out again, feature-major (N x M), or null
};

// Finishes the BM x BN output tile at (m0, n0) whose block has left its sums
// over its piece of the inner dimension in `tile` (row stride BN + 1). With
// more than one piece (forward, data, raw) the pieces' blocks form a
// thread-block cluster: after a cluster barrier each takes a band of
// BM / pieces rows, adds the pieces' sums of it from every block's shared
// memory in piece order, and finishes those rows; no partial goes to device
// memory and no atomic is needed. Each thread finishes column tid % BN of its
// rows; the feature-major copy is written after, neighbouring threads on
// neighbouring rows.
template <int BM, int BN, int THREADS>
__device__ __forceinline__ void ehw_finish(const EhwProduct& p, float* tile, int m0, int n0) {
  constexpr int LDT = BN + 1;
  constexpr int RSTEP = THREADS / BN;
  const int tid = threadIdx.x;
  const int pieces = p.mode == EHW_WEIGHT ? 1 : (int)gridDim.z;
  cg::cluster_group cluster = cg::this_cluster();
  if (pieces > 1)
    cluster.sync();
  else
    __syncthreads();
  const int band = BM / pieces;
  const int rb0 = pieces > 1 ? (int)blockIdx.z * band : 0;
  const int rows = min(band, p.M - m0 - rb0);  // this band's rows inside the product
  const int cl = tid % BN;
  const int c = n0 + cl;
  const bool col = c < p.N;
  if (pieces > 1 && col) {
    for (int q0 = tid / BN; q0 < rows; q0 += EHW_GROUP * RSTEP) {
      float v[EHW_GROUP];
#pragma unroll
      for (int j = 0; j < EHW_GROUP; ++j) v[j] = 0.0f;
      for (int z = 0; z < pieces; ++z) {  // every piece's loads of these rows in flight together
        const float* src = cluster.map_shared_rank(tile, z);
#pragma unroll
        for (int j = 0; j < EHW_GROUP; ++j) {
          const int rl = q0 + j * RSTEP;
          if (rl < rows) v[j] += src[(rb0 + rl) * LDT + cl];
        }
      }
#pragma unroll
      for (int j = 0; j < EHW_GROUP; ++j) {
        const int rl = q0 + j * RSTEP;
        if (rl < rows) tile[(rb0 + rl) * LDT + cl] = v[j];
      }
    }
  }
  float* t = tile + rb0 * LDT + cl;
  float* out = p.out + (int64_t)(m0 + rb0) * p.N + c;
  if (col && p.mode == EHW_FORWARD) {
    const float bias = p.bias[c];
    float* da = p.da + (int64_t)(m0 + rb0) * p.N + c;
    for (int rl = tid / BN; rl < rows; rl += RSTEP) {
      float d;
      const float y = ehe_act(p.act, t[rl * LDT] + bias, &d);
      out[(int64_t)rl * p.N] = y;
      da[(int64_t)rl * p.N] = d;
      t[rl * LDT] = y;
    }
  } else if (col && p.mode == EHW_DATA) {
#pragma unroll 4
    for (int rl = tid / BN; rl < rows; rl += RSTEP) {
      const float y = p.scale_in_place ? t[rl * LDT] * out[(int64_t)rl * p.N] : t[rl * LDT];
      out[(int64_t)rl * p.N] = y;
      t[rl * LDT] = y;
    }
  } else if (col) {  // weight: this piece's partial tile; raw: the product
    float* dst = p.mode == EHW_WEIGHT
                     ? p.out + (int64_t)blockIdx.z * p.M * (p.N + 1) + (int64_t)m0 * p.N + c
                     : out;
#pragma unroll 4
    for (int rl = tid / BN; rl < rows; rl += RSTEP) dst[(int64_t)rl * p.N] = t[rl * LDT];
  }
  if (p.out_t && rows > 0) {
    __syncthreads();
    const int cols = min(BN, p.N - n0);
    for (int e = tid; e < band * BN; e += THREADS) {
      const int rl = e % band;
      const int cc = e / band;
      if (rl < rows && cc < cols)
        p.out_t[(int64_t)(n0 + cc) * p.M + m0 + rb0 + rl] = tile[(rb0 + rl) * LDT + cc];
    }
  }
  if (pieces > 1) {  // no block leaves while another may read its tile (the reads are done:
                     // their values were added above, so the arrival needs no release)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// the float32 FMA tile (the edge layers)
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
// registers while the current ones are multiplied.
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

// A forward or data product on the FMA tile: this block's 64 x 64 tile over
// its piece of the inner dimension, then ehw_finish. A is K-major (A[m * lda +
// k]); B(k, n) is B[n * ldb + k] (BKC, the forward's W) or B[k * ldb + n] (the
// data gradient's W).
template <bool BKC>
__device__ __forceinline__ void ehw_fma_product(const EhwProduct& p) {
  __shared__ float tile[EHW_TILE * (EHW_TILE + 1)];
  const int m0 = blockIdx.y * EHW_TILE;
  const int n0 = blockIdx.x * EHW_TILE;
  const int k0 = blockIdx.z * p.split_k;
  float acc[4][4];
  ehw_product<true, BKC>(p.A, p.lda, p.B, p.ldb, m0, p.M, n0, p.N, k0, min(p.K, k0 + p.split_k),
                         false, acc);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) tile[(ty * 4 + i) * (EHW_TILE + 1) + tx * 4 + j] = acc[i][j];
  ehw_finish<EHW_TILE, EHW_TILE, EHW_THREADS>(p, tile, m0, n0);
}

// A = act(H W^T + b), DA = act'(H W^T + b): M rows, N = dout outputs, K = din
// inputs. Grid (ceil(N / 64), ceil(M / 64), pieces).
__global__ void __launch_bounds__(EHW_THREADS)
eh_wide_forward_kernel(const __grid_constant__ EhwProduct p) {
  ehw_fma_product<true>(p);
}

// dZ_prev = (dZ W) times act'(z) of the layer below, in place: M rows, N =
// din, K = dout.
__global__ void __launch_bounds__(EHW_THREADS)
eh_wide_bwd_data_kernel(const __grid_constant__ EhwProduct p) {
  ehw_fma_product<false>(p);
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
// the tensor-core product (3xTF32 wgmma)
// ---------------------------------------------------------------------------

// tf32(x), rounded to nearest with ties away from zero, as a float
__device__ __forceinline__ float eht_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// The matrix descriptor of a K-major operand in shared memory stored as core
// matrices of 8 rows x 16 bytes without swizzle: `lbo` bytes from a core
// matrix to the next along k, 128 bytes from a group of 8 rows to the next.
__device__ __forceinline__ uint64_t eht_desc(const float* smem, uint32_t lbo) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// d = A B^T + (add ? d : 0) over one k-step of 8: a 64-row slice of A and 64
// rows of B, TF32 from shared memory, float32 accumulators (d[i] holds row
// 16 warp + lane / 4 + 8 ((i / 2) % 2) and column 8 (i / 4) + 2 (lane % 4) +
// i % 2 of the slice).
__device__ __forceinline__ void eht_wgmma(float (&d)[32], uint64_t da, uint64_t db, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(add));
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products' issue and wait.
template <int N>
__device__ __forceinline__ void eht_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A thread's share of a 32-deep slice of rows [row0, row0 + R) of an operand
// (R = I THREADS / 4): items e = threadIdx.x + q THREADS of 8 floats, row
// row0 + 8 (e / 32) + e % 8 from k0 + 8 ((e / 8) % 4) on, so that a warp reads
// 8 whole 128-byte rows and 8 neighbouring threads fill one core matrix. Zero
// past `rows` or past k1; 16-byte loads where the rows are aligned (vec).
template <int I, int THREADS>
__device__ __forceinline__ void eht_fetch(float (&r)[I][8], const float* __restrict__ src, int ld,
                                          int row0, int rows, int k0, int k1, bool vec) {
#pragma unroll
  for (int q = 0; q < I; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int row = row0 + (e / 32) * 8 + e % 8;
    const int k = k0 + ((e / 8) % 4) * 8;
    const float* p = src + (int64_t)row * ld + k;
    if (vec && row < rows && k + 8 <= k1) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p));
      const float4 y = __ldg(reinterpret_cast<const float4*>(p) + 1);
      r[q][0] = x.x;
      r[q][1] = x.y;
      r[q][2] = x.z;
      r[q][3] = x.w;
      r[q][4] = y.x;
      r[q][5] = y.y;
      r[q][6] = y.z;
      r[q][7] = y.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) r[q][j] = (row < rows && k + j < k1) ? __ldg(p + j) : 0.0f;
    }
  }
}

// The fetched share, split into big = tf32(x) and small = tf32(x - big), into
// a stage's two copies of the slice. Core matrix (g, c) (rows 8 g on, k 4 c
// on) sits at floats (c G + g) 32, its row i at + 4 i.
template <int I, int THREADS, int G>
__device__ __forceinline__ void eht_stage(float* big, float* small, const float (&r)[I][8]) {
#pragma unroll
  for (int q = 0; q < I; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int o = (2 * ((e / 8) % 4) * G + e / 32) * 32 + (e % 8) * 4;
    float b[8], s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      b[j] = eht_tf32(r[q][j]);
      s[j] = eht_tf32(r[q][j] - b[j]);
    }
    *reinterpret_cast<float4*>(big + o) = make_float4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<float4*>(big + o + G * 32) = make_float4(b[4], b[5], b[6], b[7]);
    *reinterpret_cast<float4*>(small + o) = make_float4(s[0], s[1], s[2], s[3]);
    *reinterpret_cast<float4*>(small + o + G * 32) = make_float4(s[4], s[5], s[6], s[7]);
  }
}

// Adds each fetched item's 8 values, in k order, to its row's running sum.
template <int I>
__device__ __forceinline__ void eht_row_sums(float (&rs)[I], const float (&r)[I][8]) {
#pragma unroll
  for (int q = 0; q < I; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j) rs[q] += r[q][j];
}

template <int BM, int BN>
constexpr size_t eht_smem_bytes() {
  return (size_t)2 * 2 * (BM + BN) * EHW_TC_BK * sizeof(float);  // two stages of big and small
}

// The output tile (blockIdx.y, blockIdx.x) of BM x BN over piece blockIdx.z of
// the inner dimension, by BM / 64 warpgroups: 3xTF32 products of the staged
// slices, k ascending, then the mode's epilogue through shared memory.
// Registers are capped so that three blocks of 64 x 64, or two of 128 x 64,
// fit a multiprocessor beside their shared memory.
template <int BM, int BN>
__global__ void __launch_bounds__(2 * BM, BM == 64 ? 3 : 2) eh_wide_tc_kernel(const __grid_constant__ EhwProduct p) {
  constexpr int THREADS = 2 * BM;
  constexpr int GA = BM / 8;
  constexpr int GB = BN / 8;
  constexpr int IA = BM * 4 / THREADS;
  constexpr int IB = BN * 4 / THREADS;
  constexpr int SA = BM * EHW_TC_BK;  // floats of one copy of an operand's slice
  constexpr int SB = BN * EHW_TC_BK;
  constexpr int STAGE = 2 * (SA + SB);
  constexpr int LDT = BN + 1;  // row stride of the output tile in shared memory
  static_assert(BM * LDT <= 2 * STAGE, "the output tile must fit the stages");
  extern __shared__ __align__(128) float eht_smem[];
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k0 = blockIdx.z * p.split_k;
  const int k1 = min(p.K, k0 + p.split_k);
  const bool vec_a = ((reinterpret_cast<uintptr_t>(p.A) & 15) | (p.lda & 3)) == 0;
  const bool vec_b = ((reinterpret_cast<uintptr_t>(p.B) & 15) | (p.ldb & 3)) == 0;

  // acc: the tensor cores' sums over one slice; sum: the slices', in float32
  // registers. The tensor cores' float32 accumulation truncates, so a sum
  // over a long inner dimension left in them drifts further from the exact
  // product than a float32 matmul does; moved out after every slice it stays
  // nearer than one (tools/dev_fused_wide_gpu.py --variants holds both).
  float acc[BN / 2], sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i] = 0.0f;
  // weight mode, the first column of tiles: db, the sums of A's rows (dZ^T),
  // from the fetched slices; thread e's rows are those of its items
  const bool rowsums = p.mode == EHW_WEIGHT && blockIdx.x == 0;
  float rs[IA];
#pragma unroll
  for (int q = 0; q < IA; ++q) rs[q] = 0.0f;
  // slice t + 1 is staged while the tensor cores work on slice t, from
  // registers fetched one slice earlier still, so each fetch has a whole
  // slice's time to arrive
  float ra[IA][8], rb[IB][8];
  const int slices = (k1 - k0 + EHW_TC_BK - 1) / EHW_TC_BK;
  eht_fetch<IA, THREADS>(ra, p.A, p.lda, m0, p.M, k0, k1, vec_a);
  eht_fetch<IB, THREADS>(rb, p.B, p.ldb, n0, p.N, k0, k1, vec_b);
  if (rowsums) eht_row_sums(rs, ra);
  eht_stage<IA, THREADS, GA>(eht_smem, eht_smem + SA, ra);
  eht_stage<IB, THREADS, GB>(eht_smem + 2 * SA, eht_smem + 2 * SA + SB, rb);
  if (slices > 1) {
    eht_fetch<IA, THREADS>(ra, p.A, p.lda, m0, p.M, k0 + EHW_TC_BK, k1, vec_a);
    eht_fetch<IB, THREADS>(rb, p.B, p.ldb, n0, p.N, k0 + EHW_TC_BK, k1, vec_b);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  for (int t = 0; t < slices; ++t) {
    const float* a_big = eht_smem + (t & 1) * STAGE;
    const float* a_small = a_big + SA;
    const float* b_big = a_small + SA;
    const float* b_small = b_big + SB;
    eht_fence(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // the small cross terms first and big x big last, so that the tensor
    // cores' truncating adds see the large sums as few times as they can
#pragma unroll
    for (int ks = 0; ks < EHW_TC_BK / 8; ++ks) {
      const int ca = (2 * ks * GA + 8 * wg) * 32;  // this warpgroup's 64 rows, k-step ks
      const int cb = 2 * ks * GB * 32;
      eht_wgmma(acc, eht_desc(a_big + ca, GA * 128), eht_desc(b_small + cb, GB * 128), ks > 0);
      eht_wgmma(acc, eht_desc(a_small + ca, GA * 128), eht_desc(b_big + cb, GB * 128), 1);
    }
#pragma unroll
    for (int ks = 0; ks < EHW_TC_BK / 8; ++ks) {
      const int ca = (2 * ks * GA + 8 * wg) * 32;
      const int cb = 2 * ks * GB * 32;
      eht_wgmma(acc, eht_desc(a_big + ca, GA * 128), eht_desc(b_big + cb, GB * 128), 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (t + 1 < slices) {
      float* next = eht_smem + ((t + 1) & 1) * STAGE;
      if (rowsums) eht_row_sums(rs, ra);
      eht_stage<IA, THREADS, GA>(next, next + SA, ra);
      eht_stage<IB, THREADS, GB>(next + 2 * SA, next + 2 * SA + SB, rb);
      if (t + 2 < slices) {
        const int k = k0 + (t + 2) * EHW_TC_BK;
        eht_fetch<IA, THREADS>(ra, p.A, p.lda, m0, p.M, k, k1, vec_a);
        eht_fetch<IB, THREADS>(rb, p.B, p.ldb, n0, p.N, k, k1, vec_b);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    eht_fence(acc);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i];
    __syncthreads();  // the next slice staged by all; this one read by every warpgroup
  }

  // the accumulators to the output tile in shared memory, then ehw_finish
  float* tile = eht_smem;
  {
    const int lane = tid % 32;
    const int r0 = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
    const int c0 = 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      tile[(r0 + 8 * ((i / 2) % 2)) * LDT + c0 + 8 * (i / 4) + i % 2] = sum[i];
  }
  ehw_finish<BM, BN, THREADS>(p, tile, m0, n0);
  const int64_t mn = (int64_t)p.M * p.N;
  float* part = p.out + (int64_t)blockIdx.z * p.M * (p.N + 1);  // weight: this piece's tile
  if (rowsums) {  // the four threads that fetched a row's chunks hold its sums
#pragma unroll
    for (int q = 0; q < IA; ++q) {
      rs[q] += __shfl_xor_sync(0xffffffffu, rs[q], 8);
      rs[q] += __shfl_xor_sync(0xffffffffu, rs[q], 16);
      const int e = tid + q * THREADS;
      const int r = m0 + (e / 32) * 8 + e % 8;
      if ((e / 8) % 4 == 0 && r < p.M) part[mn + r] = rs[q];
    }
  }
}

// Launches `kernel` over `grid` with grid z as one thread-block cluster per
// (x, y); returns the launch's error.
template <typename... Params, typename... Args>
static cudaError_t ehw_launch_cluster(void (*kernel)(Params...), dim3 grid, int threads,
                                      size_t smem, cudaStream_t s, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int BM, int BN>
static cudaError_t eht_launch(const EhwProduct& p, int splits, cudaStream_t s) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, splits);
  if (p.mode != EHW_WEIGHT)
    return ehw_launch_cluster(eh_wide_tc_kernel<BM, BN>, grid, 2 * BM, eht_smem_bytes<BM, BN>(),
                              s, p);
  eh_wide_tc_kernel<BM, BN><<<grid, 2 * BM, eht_smem_bytes<BM, BN>(), s>>>(p);
  return cudaGetLastError();
}

static bool eht_shape_ok(int bm, int bn) { return (bm == 64 || bm == 128) && bn == 64; }

// Allows each instance its shared memory (above the default 48 KB).
static cudaError_t eht_allow_smem() {
  cudaFuncSetAttribute(eh_wide_tc_kernel<64, 64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)eht_smem_bytes<64, 64>());
  cudaFuncSetAttribute(eh_wide_tc_kernel<128, 64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)eht_smem_bytes<128, 64>());
  return cudaGetLastError();
}

static cudaError_t eht_run(int bm, const EhwProduct& p, int splits, cudaStream_t s) {
  return bm == 64 ? eht_launch<64, 64>(p, splits, s) : eht_launch<128, 64>(p, splits, s);
}

static cudaError_t ehw_fma_run(bool forward, const EhwProduct& p, int splits, cudaStream_t s) {
  const dim3 grid((p.N + EHW_TILE - 1) / EHW_TILE, (p.M + EHW_TILE - 1) / EHW_TILE, splits);
  return ehw_launch_cluster(forward ? eh_wide_forward_kernel : eh_wide_bwd_data_kernel, grid,
                            EHW_THREADS, 0, s, p);
}

// ---------------------------------------------------------------------------
// the step's other kernels
// ---------------------------------------------------------------------------

// The batch's rows through the row index, normed: one thread per (row,
// feature); also feature-major where layer 0 is on the tensor cores.
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
  if (a.tc[0]) a.ws[a.ws_off_ht[0] + (int64_t)k * a.batch + r] = h;
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
    // layer's activation (also feature-major where that layer is on the
    // tensor cores)
    float* dt = a.tc[L - 1] ? a.ws + a.ws_off_dt[L - 1] : nullptr;
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
      if (dt) dt[(int64_t)j * a.batch + r] = dl[j];
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
#pragma unroll 8
      for (int r = r0; r < r1; ++r) s = fmaf(d0[(int64_t)r * F + k], xh[(int64_t)r * F + k], s);
    } else {
#pragma unroll 8
      for (int r = r0; r < r1; ++r) s += d0[(int64_t)r * F + k];
    }
    out[q] = s;
  }
}

// The tiles of EHW_UTILE x EHW_UTILE of the tensor-core layers' W, layer by
// layer, each row-major: tile b's layer and first row and column of W, or
// false past the last tile.
__device__ __forceinline__ bool ehw_weight_tile(const EhFusedWideArgs& a, int b, int* l, int* j0,
                                                int* k0) {
  for (int q = 0; q < a.n_layers; ++q) {
    if (!a.tc[q]) continue;
    const int cols = (a.dims[q] + EHW_UTILE - 1) / EHW_UTILE;
    const int n = cols * ((a.dims[q + 1] + EHW_UTILE - 1) / EHW_UTILE);
    if (b < n) {
      *l = q;
      *j0 = (b / cols) * EHW_UTILE;
      *k0 = (b % cols) * EHW_UTILE;
      return true;
    }
    b -= n;
  }
  return false;
}

// W^T of every tensor-core layer from the parameters, one tile a block: the
// copy the data gradients read, made at the start of every call.
__global__ void __launch_bounds__(256)
eh_wide_transpose_kernel(const __grid_constant__ EhFusedWideArgs a) {
  __shared__ float tile[EHW_UTILE][EHW_UTILE + 1];
  int l, j0, k0;
  if (!ehw_weight_tile(a, blockIdx.x, &l, &j0, &k0)) return;
  const int din = a.dims[l];
  const int dout = a.dims[l + 1];
  const int tx = threadIdx.x % EHW_UTILE;
  const int ty = threadIdx.x / EHW_UTILE;
  for (int i = ty; i < EHW_UTILE; i += 256 / EHW_UTILE)
    if (j0 + i < dout && k0 + tx < din)
      tile[i][tx] = a.params[a.p_off_w[l] + (int64_t)(j0 + i) * din + k0 + tx];
  __syncthreads();
  float* wt = a.ws + a.ws_off_wt[l];
  for (int i = ty; i < EHW_UTILE; i += 256 / EHW_UTILE)
    if (k0 + i < din && j0 + tx < dout) wt[(int64_t)(k0 + i) * dout + j0 + tx] = tile[tx][i];
}

// The update. Blocks below `tiles`: one tile of a tensor-core layer's W each
// (its gradient from the partials in split order, the update, and the new W
// written transposed as well). The others: one thread per remaining
// parameter (the norm's, the FMA layers' W, every b, the globals, in packed
// order), and one more that adds the batch loss to its epoch's sum. Pass 1
// updates; pass 0 (lamb only, before pass 1) writes this block's part of
// every leaf's squared norms of the parameters and of the update directions
// into its row of lamb_parts. Six blocks a multiprocessor: the kernel moves
// the parameters, moments and partials once, and a register budget of 40 a
// thread keeps enough of their loads in flight (at 48, ptxas's own choice,
// the adam update took 32 us a step of the tower against 27 on an NVIDIA
// H100 80GB HBM3 at 700 W).
__global__ void __launch_bounds__(256, 6)
eh_wide_update_kernel(const __grid_constant__ EhFusedWideArgs a, int step, int tiles, int pass) {
  const EhOptimizer& o = a.optimizer;
  const int F = a.dims[0];
  const int L = a.n_layers;
  const int G = a.n_globals;
  const bool valid = a.valid[step] > 0.0f;
  if (pass == 0 && !valid) return;  // the whole grid alike
  const bool lamb = o.rule == OPT_LAMB;
  EhOptStep st = {1.0f, 1.0f, 0.0f};
  if (valid) st = ehe_opt_step(o, fmaxf(a.tcount[step], 1.0f));
  __shared__ float tr[EH_MAX_LEAVES];
  float* my_parts = a.lamb_parts + (int64_t)blockIdx.x * o.n_leaves * 2;
  // the packed index of the update's element e past the tiles, or -1 (the
  // loss, or none)
  auto element = [&](int64_t e) -> int64_t {
    if (a.norm_mode != NORM_NONE) {
      if (e < 2 * F) return e;
      e -= 2 * F;
    }
    for (int l = 0; l < L; ++l) {
      const int64_t w = a.tc[l] ? 0 : (int64_t)a.dims[l + 1] * a.dims[l];
      if (e < w) return a.p_off_w[l] + e;
      e -= w;
      if (e < a.dims[l + 1]) return a.p_off_b[l] + e;
      e -= a.dims[l + 1];
    }
    return e < G ? a.p_off_g + e : -1;
  };

  if ((int)blockIdx.x < tiles) {
    __shared__ float tile[EHW_UTILE][EHW_UTILE + 1];
    int l, j0, k0;
    ehw_weight_tile(a, blockIdx.x, &l, &j0, &k0);
    const int din = a.dims[l];
    const int dout = a.dims[l + 1];
    const int64_t size = (int64_t)dout * (din + 1);
    const int tx = threadIdx.x % EHW_UTILE;
    const int ty = threadIdx.x / EHW_UTILE;
    constexpr int PER = EHW_UTILE * EHW_UTILE / 256;
    const float* part = a.partials + a.part_off[l];
    float g[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) g[q] = 0.0f;
#pragma unroll 4
    for (int s = 0; s < a.splits[l]; ++s) {  // loads of several splits in flight, added in order
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int j = j0 + ty + q * (256 / EHW_UTILE);
        const int k = k0 + tx;
        if (j < dout && k < din) g[q] += part[s * size + (int64_t)j * din + k];
      }
    }
    if (pass == 0) {
      float ps = 0.0f, ds = 0.0f;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int j = j0 + ty + q * (256 / EHW_UTILE);
        const int k = k0 + tx;
        if (j >= dout || k >= din) continue;
        const int64_t gid = a.p_off_w[l] + (int64_t)j * din + k;
        const float pv = a.params[gid];
        float mm = a.m[gid], vv = a.v[gid];
        const float d = ehe_lamb_direction(o, st, pv, g[q], mm, vv);
        ps += pv * pv;
        ds += d * d;
      }
      ehe_block_leaf_sums(ps, ds, ehe_leaf_of(o, a.p_off_w[l]), o.n_leaves, my_parts);
      return;
    }
    float trust = 1.0f;
    if (pass == 1 && valid && lamb) {
      const int leaf = ehe_leaf_of(o, a.p_off_w[l]);
      ehe_leaf_trust_ratios(a.lamb_parts, gridDim.x, o.n_leaves, leaf, leaf, tr);
      trust = tr[leaf];
    }
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int i = ty + q * (256 / EHW_UTILE);
      const int j = j0 + i;
      const int k = k0 + tx;
      if (j >= dout || k >= din) continue;
      const int64_t gid = a.p_off_w[l] + (int64_t)j * din + k;
      if (valid) ehe_update(o, st, &a.params[gid], &a.m[gid], &a.v[gid], &a.u[gid], g[q], trust);
      tile[i][tx] = a.params[gid];
    }
    __syncthreads();
    float* wt = a.ws + a.ws_off_wt[l];
    for (int i = ty; i < EHW_UTILE; i += 256 / EHW_UTILE)
      if (k0 + i < din && j0 + tx < dout) wt[(int64_t)(k0 + i) * dout + j0 + tx] = tile[tx][i];
    return;
  }

  const int64_t e0 = (int64_t)(blockIdx.x - tiles) * blockDim.x;
  const int64_t e = e0 + threadIdx.x;
  const int64_t gid = element(e);
  int64_t loose = a.n_params;  // the elements past the tiles; the next thread adds the loss
  for (int l = 0; l < L; ++l)
    if (a.tc[l]) loose -= (int64_t)a.dims[l] * a.dims[l + 1];
  if (pass == 1 && valid && lamb) {  // the leaves of this block's elements, in packed order
    const int64_t last = min(e0 + (int64_t)blockDim.x, loose) - 1;
    ehe_leaf_trust_ratios(a.lamb_parts, gridDim.x, o.n_leaves,
                          last >= e0 ? ehe_leaf_of(o, element(e0)) : 0,
                          last >= e0 ? ehe_leaf_of(o, element(last)) : -1, tr);
  }
  if (e == loose && pass == 1 && valid) {
    float loss = 0.0f;
    for (int b = 0; b < a.head_blocks; ++b) loss += a.head_partials[(int64_t)b * (1 + G)];
    a.epoch_loss[step / a.n_batches] += loss;
  }
  float g = 0.0f;
  if (gid < 0) {
  } else if (gid >= a.p_off_g) {
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
#pragma unroll 4
    for (int s = 0; s < a.splits[l]; ++s) g += part[s * size];
  }
  if (pass == 0) {
    float pv = 0.0f, d = 0.0f;
    if (gid >= 0) {
      pv = a.params[gid];
      float mm = a.m[gid], vv = a.v[gid];
      d = ehe_lamb_direction(o, st, pv, g, mm, vv);
    }
    ehe_block_leaf_sums(pv * pv, d * d, gid >= 0 ? ehe_leaf_of(o, gid) : -1, o.n_leaves, my_parts);
    return;
  }
  if (gid >= 0 && valid)
    ehe_update(o, st, &a.params[gid], &a.m[gid], &a.v[gid], &a.u[gid], g,
               lamb ? tr[ehe_leaf_of(o, gid)] : 1.0f);
}

extern "C" int eh_fused_wide_args_size(void) { return (int)sizeof(EhFusedWideArgs); }

static inline int ehw_ceil_div(int a, int b) { return (a + b - 1) / b; }

// `splits` pieces of `split_k`, a whole number of `depth`, that cover
// `inner` with none empty.
static bool ehw_split_ok(int inner, int splits, int split_k, int depth) {
  return splits >= 1 && split_k >= depth && split_k % depth == 0 &&
         (int64_t)(splits - 1) * split_k < inner && (int64_t)splits * split_k >= inner;
}

// A forward or data product's tile and pieces: the pieces of a tile form a
// cluster of at most 8 blocks, each finishing an equal band of its rows.
static bool ehw_product_ok(bool tc, int bm, int bn, int inner, int splits, int split_k) {
  if (tc ? !eht_shape_ok(bm, bn) : (bm != EHW_TILE || bn != EHW_TILE)) return false;
  return ehw_split_ok(inner, splits, split_k, tc ? EHW_TC_BK : EHW_BK) && splits <= 8 &&
         bm % splits == 0;
}

// Tiles of the tensor-core layers' W (the update's first blocks) and the
// parameters outside them.
static int ehw_weight_tiles(const EhFusedWideArgs& a) {
  int n = 0;
  for (int l = 0; l < a.n_layers; ++l)
    if (a.tc[l])
      n += ehw_ceil_div(a.dims[l], EHW_UTILE) * ehw_ceil_div(a.dims[l + 1], EHW_UTILE);
  return n;
}

static int64_t ehw_loose_params(const EhFusedWideArgs& a) {
  int64_t n = a.n_params;
  for (int l = 0; l < a.n_layers; ++l)
    if (a.tc[l]) n -= (int64_t)a.dims[l] * a.dims[l + 1];
  return n;
}

#define EHW_TRY(call)                        \
  do {                                       \
    const cudaError_t err_ = (call);         \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

// Enqueue every step of the call on `stream`; returns the first launch
// error, or cudaGetLastError() (0 on success). The caller checks shapes,
// devices and the envelope first; the plan's tile shapes and pieces are
// checked here.
extern "C" int eh_fused_wide(const EhFusedWideArgs* args, void* stream) {
  const EhFusedWideArgs& a = *args;
  if (a.n_epochs <= 0 || a.n_batches <= 0) return 0;
  const int L = a.n_layers;
  if (L < 1 || L > EH_MAX_LAYERS || a.batch < 1 || a.n_args > EH_MAX_ARGS || a.n_targets < 1 ||
      a.n_targets > EH_MAX_TARGETS || a.n_globals + a.n_fixed > EH_MAX_SCALARS ||
      a.optimizer.n_leaves < 1 || a.optimizer.n_leaves > EH_MAX_LEAVES ||
      a.head_blocks * EHW_HEAD_THREADS < a.batch || (a.norm_mode != NORM_NONE && a.norm_splits < 1))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l <= L; ++l)
    if (a.dims[l] < 1 || a.dims[l] > EH_WIDE_MAX_WIDTH) return (int)cudaErrorInvalidValue;
  const bool norm = a.norm_mode != NORM_NONE;
  const int B = a.batch;
  for (int l = 0; l < L; ++l) {
    const int din = a.dims[l];
    const int dout = a.dims[l + 1];
    const bool tc = a.tc[l] != 0;
    if (tc && (din < EHW_TC_MIN || dout < EHW_TC_MIN)) return (int)cudaErrorInvalidValue;
    if (!ehw_split_ok(B, a.splits[l], a.split_rows[l], tc ? EHW_TC_BK : EHW_BK) ||
        (tc && !eht_shape_ok(a.wgt_bm[l], a.wgt_bn[l])) ||
        !ehw_product_ok(tc, a.fwd_bm[l], a.fwd_bn[l], din, a.fwd_splits[l], a.fwd_split_k[l]) ||
        ((l > 0 || norm) &&
         !ehw_product_ok(tc, a.dat_bm[l], a.dat_bn[l], dout, a.dat_splits[l], a.dat_split_k[l])))
      return (int)cudaErrorInvalidValue;
  }

  cudaStream_t s = (cudaStream_t)stream;
  const int F = a.dims[0];
  float* ws = a.ws;
  const int gather_blocks = (int)(((int64_t)B * F + 255) / 256);
  const int tiles = ehw_weight_tiles(a);
  const int update_blocks = tiles + (int)((ehw_loose_params(a) + 1 + 255) / 256);
  EHW_TRY(eht_allow_smem());
  if (tiles > 0) {
    eh_wide_transpose_kernel<<<tiles, 256, 0, s>>>(a);
    EHW_TRY(cudaGetLastError());
  }
  const int steps = a.n_epochs * a.n_batches;
  for (int step = 0; step < steps; ++step) {
    eh_wide_gather_kernel<<<gather_blocks, 256, 0, s>>>(a, step);
    EHW_TRY(cudaGetLastError());
    for (int l = 0; l < L; ++l) {  // A = act(H W^T + b), and H^T of the next layer where it takes it
      const int din = a.dims[l];
      EhwProduct p = {};
      p.A = ws + (l == 0 ? a.ws_off_h0 : a.ws_off_a[l - 1]);
      p.lda = din;
      p.B = a.params + a.p_off_w[l];
      p.ldb = din;
      p.M = B;
      p.N = a.dims[l + 1];
      p.K = din;
      p.split_k = a.fwd_split_k[l];
      p.mode = EHW_FORWARD;
      p.act = a.acts[l];
      p.bias = a.params + a.p_off_b[l];
      p.out = ws + a.ws_off_a[l];
      p.da = ws + a.ws_off_d[l];
      p.out_t = l + 1 < L && a.tc[l + 1] ? ws + a.ws_off_ht[l + 1] : nullptr;
      EHW_TRY(a.tc[l] ? eht_run(a.fwd_bm[l], p, a.fwd_splits[l], s)
                      : ehw_fma_run(true, p, a.fwd_splits[l], s));
    }
    eh_wide_head_kernel<<<a.head_blocks, EHW_HEAD_THREADS, 0, s>>>(a, step);
    EHW_TRY(cudaGetLastError());
    for (int l = L - 1; l >= 0; --l) {
      const int din = a.dims[l];
      const int dout = a.dims[l + 1];
      const float* dz = ws + a.ws_off_d[l];
      if (a.tc[l]) {  // dW = dZ^T H and db over the batch's pieces, from the feature-major copies
        EhwProduct p = {};
        p.A = ws + a.ws_off_dt[l];
        p.lda = B;
        p.B = ws + a.ws_off_ht[l];
        p.ldb = B;
        p.M = dout;
        p.N = din;
        p.K = B;
        p.split_k = a.split_rows[l];
        p.mode = EHW_WEIGHT;
        p.out = a.partials + a.part_off[l];
        EHW_TRY(eht_run(a.wgt_bm[l], p, a.splits[l], s));
      } else {
        const float* h = ws + (l == 0 ? a.ws_off_h0 : a.ws_off_a[l - 1]);
        const dim3 wgrid(ehw_ceil_div(din, EHW_TILE), ehw_ceil_div(dout, EHW_TILE), a.splits[l]);
        eh_wide_bwd_weight_kernel<<<wgrid, EHW_THREADS, 0, s>>>(dz, h, a.partials + a.part_off[l],
                                                                dout, din, B, a.split_rows[l]);
        EHW_TRY(cudaGetLastError());
      }
      if (l > 0 || norm) {  // dZ_prev = (dZ W) * act'_prev in place, and its copy where needed
        EhwProduct p = {};
        p.A = dz;
        p.lda = dout;
        p.B = a.tc[l] ? ws + a.ws_off_wt[l] : a.params + a.p_off_w[l];
        p.ldb = a.tc[l] ? dout : din;
        p.M = B;
        p.N = din;
        p.K = dout;
        p.split_k = a.dat_split_k[l];
        p.mode = EHW_DATA;
        p.scale_in_place = l > 0 ? 1 : 0;
        p.out = ws + (l > 0 ? a.ws_off_d[l - 1] : a.ws_off_d0);
        p.out_t = l > 0 && a.tc[l - 1] ? ws + a.ws_off_dt[l - 1] : nullptr;
        EHW_TRY(a.tc[l] ? eht_run(a.dat_bm[l], p, a.dat_splits[l], s)
                        : ehw_fma_run(false, p, a.dat_splits[l], s));
      }
    }
    if (norm) eh_wide_norm_grad_kernel<<<a.norm_splits, 128, 0, s>>>(a);
    if (a.optimizer.rule == OPT_LAMB)  // its leaves' norms first
      eh_wide_update_kernel<<<update_blocks, 256, 0, s>>>(a, step, tiles, 0);
    eh_wide_update_kernel<<<update_blocks, 256, 0, s>>>(a, step, tiles, 1);
    EHW_TRY(cudaGetLastError());
  }
  return (int)cudaGetLastError();
}

// One tensor-core product alone, C = A B^T (M x K by N x K, k contiguous),
// with the launch geometry given (its pieces a cluster): for the GPU tests.
extern "C" int eh_wide_tc_product(const float* A, int lda, const float* B, int ldb, float* C,
                                  int M, int N, int K, int bm, int bn, int splits, int split_k,
                                  void* stream) {
  if (M < 1 || N < 1 || K < 1 || lda < K || ldb < K || !ehw_product_ok(true, bm, bn, K, splits, split_k))
    return (int)cudaErrorInvalidValue;
  EHW_TRY(eht_allow_smem());
  EhwProduct p = {};
  p.A = A;
  p.lda = lda;
  p.B = B;
  p.ldb = ldb;
  p.M = M;
  p.N = N;
  p.K = K;
  p.split_k = split_k;
  p.mode = EHW_RAW;
  p.out = C;
  return (int)eht_run(bm, p, splits, (cudaStream_t)stream);
}
