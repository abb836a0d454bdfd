// Fused training epochs of a wide MLP hybrid for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel built by make_fused_epoch in
// easyhybrid_tpu/ops/fused_epoch.py (pallas_call at :2662) on an MLP hybrid
// too wide for one block: its batch-chunked variant kernel_body_elem (:1541),
// chosen at :2374 when _pick_batch_chunks (:409) gives more than one chunk
// (the tower [1024, 512, 256, 128, 64] at batch 1,024), and its unchunked
// kernel_body (:1268) on such a tower (batch 64, the reference's GPU
// tutorial), which also takes a trainable input BatchNorm (forward_mlp, :716)
// and the losses whose cotangents need the whole batch's predictions (rmse
// and the statistic losses, :1414-1450). There each batch rides one grid
// step, or several at chunk width with the chunks' gradients summed in
// carried tiles. The function, without the TPU's chunking: per optimizer
// step, the whole-batch gradient of the masked loss (any of eh_device.cuh's
// loss layer) of an MLP hybrid with no, a static or a trainable input norm,
// summed in a fixed order, then one gated update of every parameter and of
// the norm's running statistics. One call of the launcher enqueues every step
// of n_epochs x n_batches batches on one stream; the host never waits between
// steps. Each step:
//   0. under a trainable norm, eh_wide_norm_stats_kernel: every feature's
//      mean and biased variance over the whole gathered batch (padding rows
//      included, as forward_mlp takes them), and the running statistics' EMA,
//      gated by the batch's validity like the update;
//   1. eh_wide_gather_kernel: the batch's rows through the row index
//      perm[e][b * batch + r], the input norm (static, or the batch's
//      statistics) and its scale and bias;
//   2. per layer forward, A = act(H W^T + b), with act'(z) kept beside it;
//   3. eh_wide_head_kernel, one thread per row: sigmoid bound scaling, the
//      mechanistic model in its kernel form with its partials, the masked loss
//      and its cotangent with the batch-wide scale computed by the caller, the
//      last layer's pre-activation cotangent, and per-block sums of the loss
//      and of every global's gradient. rmse and the statistic losses run it
//      twice: phase 0 keeps the predictions and each block's first moment
//      (sum of (pred - y)^2 m for rmse, of pred m for the others);
//      eh_wide_moments_kernel (the statistic losses) adds those in block order
//      into the batch's mean prediction and takes each block's centred sums of
//      dh^2 and dh dy; phase 1 adds every block's sums in block order, takes
//      the loss value and the partials of g (ehe_stat_loss) and the rows'
//      cotangents from them;
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
// The branch view (a MultiNN model: the JAX kernel's branches, kernel_body at
// easyhybrid_tpu/ops/fused_epoch.py:1304-1315, :1497-1530, kernel_body_elem
// at :1582-1591, :1682-1689, the branch view built at :1229-1260): 1 to
// EH_MAX_NETS single-output MLPs, one a neural parameter, each over its own
// predictor columns. The layers of every branch form one list (layer_net[l]
// its branch; branch b's widths at dims[net_first[b] + b]), so the branch
// count is a runtime field and one build takes any. The gather writes every
// branch's normed columns side by side (batch x n_features), and a branch's
// first layer reads its own columns there (rows n_features apart); the
// forward products run branch after branch, the head reads each neural
// output from its branch's last layer and writes its cotangent there, and
// each branch's backward runs from its last layer to its first, whose data
// gradient (with a norm) fills the branch's columns of the norm's cotangent.
// The norm's gradient sums over every column and the update walks every
// branch's leaves. One network is the one branch, with the launches, tiles
// and orders it had before the branches.
//
// The member axis (population training, replacing the JAX kernel under
// jax.vmap in easyhybrid_tpu/training/population.py:215-285): one call trains
// n_members models side by side, each of a step's launches over all of them.
// The member is a grid dimension: blockIdx.y of the step's other kernels, and
// in the layer products, whose z is a tile's pieces (a cluster), it is folded
// into x, the output tile's column (blockIdx.x = member tiles_x + column).
// Member k's parameters, slots, running statistics, workspace, partial sums,
// loss scales, validity, step counts and loss sit k strides further on (its
// rows of the state arrays, EhwMember); its row index perm_stride further on
// (0 where the members share it); its data is where its row index points;
// its optimizer numbers are row k of member_opt, or the shared struct's. A
// member's blocks compute what a launch of it alone computes, in the same
// tiles, pieces and orders (the geometry depends on the widths and the batch
// alone), so each member's bits are those of its call alone.
//
// The declarative weight-L2 extra_loss (l2_extra_loss; the JAX kernel's,
// ops/fused_epoch.py:1217-1225, :2365-2372, its chunked form :2418-2457), a
// runtime field of the arguments (l2_leaves 0: none): the update adds
// l2_coeff w, w the parameter before the update, to each penalised
// parameter's gradient, after its partials' sum and ahead of the rule; each
// update block also writes the sum of squares of its penalised parameters
// after the update into l2_parts, a ring of two rows a member, which are the
// next step's parameters before its update (eh_wide_transpose_kernel writes
// the first step's at the start of the call); the update's loss block adds
// that row in block order and the loss thread adds l2_outer (l2_value S) to
// the batch's loss, once a batch, as the JAX kernel's chunked body does at a
// batch's last chunk. The penalty adds no launch where a tensor-core layer
// has the transpose launched anyway.
//
// The bf16 build (-DEH_BF16, eh_device.cuh; a model with
// compute_dtype=bfloat16: forward_mlp / backward_mlp of the JAX kernel with
// bf16 operands, fused_epoch.py:716-841, the bench's large_mlp_bf16 row):
// the gather rounds the first layer's input to bf16 and each forward but
// the last rounds its output as it stores it (the next layer's cast input
// and the residual the weight gradient reads); a layer's weights are
// rounded as its products stage them. A bf16 value is exact in TF32, its
// small half zero, so a tensor-core product issues only the passes whose
// operands are not both zero: the forward big x big alone, the data and
// weight gradients (an f32 cotangent against bf16 weights or inputs)
// small x big and big x big. Each data gradient is rounded to bf16 before
// the activation derivative below multiplies it (and before the norm's
// gradient reads it), each weight's gradient after the update has summed
// its partials in split order, before the rule. The norm, the head, the
// loss, the bias gradients and the update stay float32, and parameters and
// activations stay float32 in memory.
//
// Built without --use_fast_math, as fused_forward.cu.

#include "eh_device.cuh"

#include <stddef.h>
#include <stdint.h>

#include <utility>

#define EH_WIDE_MAX_WIDTH 4096
#define EHW_MAX_LAYERS 20      // the layers of every branch together: two leaves each, EH_MAX_LEAVES
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
  const float* x;                        // (n_rows, n_features) row-major: every branch's columns
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
  float* bn;                             // running mean, var (2 n_features); a trainable norm's in place
  const float* consts;                   // neural lo, span; global lo, span; fixed
  float* ws;                             // one step's activations (ws_off_*)
  float* partials;                       // weight-gradient partial tiles (part_off*)
  float* head_partials;                  // (head_blocks, 1 + n_globals): loss, globals
  float* epoch_loss;                     // (n_epochs) sum of valid batch losses, zero on entry
  float* lamb_parts;                     // lamb: (update blocks, 2 n_leaves) scratch, else unused
  int64_t n_rows;
  int64_t ws_off_h0;                     // (batch, n_features) the first layers' input
  int64_t ws_off_xhat;                   // (batch, n_features) normed input, with a norm
  int64_t ws_off_d0;                     // (batch, n_features) its cotangent, with a norm
  int64_t ws_off_a[EHW_MAX_LAYERS];      // (batch, dout) layer l's output (din, dout: ehw_din)
  int64_t ws_off_d[EHW_MAX_LAYERS];      // (batch, dout) act'(z), then dZ
  int64_t part_off[EHW_MAX_LAYERS];      // layer l: splits[l] tiles of [dW (dout x din), db]
  int64_t part_off_norm;                 // norm_splits rows of [dscale, dbias]
  int64_t ws_off_ht[EHW_MAX_LAYERS];     // (din, batch) layer l's input, feature-major (tc[l])
  int64_t ws_off_dt[EHW_MAX_LAYERS];     // (dout, batch) layer l's dZ, feature-major (tc[l])
  int64_t ws_off_wt[EHW_MAX_LAYERS];     // (din, dout) layer l's W transposed (tc[l])
  int n_epochs;
  int n_batches;
  int batch;
  int n_layers;                          // every branch's layers, in turn
  int dims[EHW_MAX_LAYERS + EH_MAX_NETS];  // each branch's widths: branch b's from net_first[b] + b
  int acts[EHW_MAX_LAYERS];
  int norm_mode;                         // NORM_NONE, NORM_STATIC, NORM_TRAIN
  float norm_eps;
  int n_params;
  int p_off_w[EHW_MAX_LAYERS];
  int p_off_b[EHW_MAX_LAYERS];
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
  int loss_kind;                         // LOSS_* (eh_device.cuh)
  EhOptimizer optimizer;                 // the rule and its hyperparameters
  int splits[EHW_MAX_LAYERS];            // batch splits of layer l's weight gradient
  int split_rows[EHW_MAX_LAYERS];        // rows of one split, a multiple of its product's depth
  int norm_splits;
  int norm_split_rows;
  int head_blocks;
  int tc[EHW_MAX_LAYERS];                // 1: layer l's three products on the tensor cores
  int fwd_bm[EHW_MAX_LAYERS];            // layer l's forward: output tile rows (of the batch)
  int fwd_bn[EHW_MAX_LAYERS];            //   output tile columns (of dout)
  int fwd_splits[EHW_MAX_LAYERS];        //   pieces of its inner dimension (din), a cluster
  int fwd_split_k[EHW_MAX_LAYERS];       //   inner extent of one piece
  int dat_bm[EHW_MAX_LAYERS];            // layer l's data gradient: tile rows (of the batch)
  int dat_bn[EHW_MAX_LAYERS];            //   tile columns (of din)
  int dat_splits[EHW_MAX_LAYERS];        //   pieces of its inner dimension (dout), a cluster
  int dat_split_k[EHW_MAX_LAYERS];       //   inner extent of one piece
  int wgt_bm[EHW_MAX_LAYERS];            // layer l's weight gradient: tile rows (of dout)
  int wgt_bn[EHW_MAX_LAYERS];            //   tile columns (of din); its batch splits above
  const int* halt;                       // the halt word (eh_halted), or null
  const float* tmom;                     // rmse, the statistic losses: (n_epochs, n_batches,
                                         //   n_targets, 3) max(sum m, 1), target mean, SST
  int64_t ws_off_stats;                  // NORM_TRAIN: (2 n_features) the batch's mean, variance
  int64_t ws_off_pred;                   // two-pass losses: (n_targets, batch) predictions
  int64_t ws_off_mom;                    //   (head_blocks, n_targets, 3) each block's moments
  float momentum;                        // the running statistics' EMA weight of the batch's
  float one_minus_momentum;
  int n_members;                         // models trained side by side (1: train())
  int64_t perm_stride;                   // ints between two members' row indexes (0: one shared)
  const float* member_opt;               // (n_members, EHW_OPT_SCALARS) optimizer numbers, or null
  int64_t ws_stride;                     // floats between two members' workspaces
  int64_t part_stride;                   // floats between two members' partial tiles
  int64_t lamb_stride;                   // lamb: floats between two members' lamb_parts
  float* l2_parts;                       // the penalty: (n_members, 2, update blocks) sums of w^2
  int64_t l2_stride;                     //   floats between two members' rows: 2 update blocks
  float l2_coeff;                        // the weight-L2 penalty: ex_outer 2 scale / norm_div,
  float l2_value;                        //   scale / norm_div,
  float l2_outer;                        //   ex_outer (0.5 under agg mean, else 1),
  int64_t l2_leaves;                     //   bit l: leaf l penalised (0: no penalty)
  int n_nets;                            // networks: one, or a MultiNN model's branches
  int n_features;                        // F: every branch's predictor columns, side by side
  int n_neural;                          // P: every branch's outputs, in neural order
  int layer_net[EHW_MAX_LAYERS];         // layer l's branch (the layers: every branch's in turn)
  int net_first[EH_MAX_NETS];            // branch b's first layer
  int net_layers[EH_MAX_NETS];           //   its layers
  int net_col[EH_MAX_NETS];              //   its first column of x
  int net_out[EH_MAX_NETS];              //   its first neural output
};
// A member's optimizer numbers: EhOptimizer's floats from lr to rect_den, in
// its order, as kernel 2 takes them (csrc/fused_epoch.cu, EHE_OPT_SCALARS).
#define EHW_OPT_SCALARS 13
#define EHW_OPT_FIRST 2
static_assert(offsetof(EhOptimizer, lr) == EHW_OPT_FIRST * sizeof(float) &&
                  offsetof(EhOptimizer, rect_den) ==
                      (EHW_OPT_FIRST + EHW_OPT_SCALARS - 1) * sizeof(float),
              "EhOptimizer's numbers from lr to rect_den");

// Layer l's inputs and outputs (l over every branch's layers in turn).
__host__ __device__ __forceinline__ int ehw_din(const EhFusedWideArgs& a, int l) {
  return a.dims[l + a.layer_net[l]];
}
__host__ __device__ __forceinline__ int ehw_dout(const EhFusedWideArgs& a, int l) {
  return a.dims[l + a.layer_net[l] + 1];
}
__host__ __device__ __forceinline__ bool ehw_first(const EhFusedWideArgs& a, int l) {
  return l == a.net_first[a.layer_net[l]];
}
__host__ __device__ __forceinline__ bool ehw_last(const EhFusedWideArgs& a, int l) {
  const int b = a.layer_net[l];
  return l == a.net_first[b] + a.net_layers[b] - 1;
}

// Where neural output j sits: its branch's last layer and its column there.
struct EhwOut {
  int layer;  // the branch's last layer
  int width;  // its outputs, the row stride of its activations
  int col;    // j's column
};

__device__ __forceinline__ EhwOut ehw_out(const EhFusedWideArgs& a, int j) {
  int b = 0;
  while (b + 1 < a.n_nets && j >= a.net_out[b + 1]) ++b;
  EhwOut o;
  o.layer = a.net_first[b] + a.net_layers[b] - 1;
  o.width = ehw_dout(a, o.layer);
  o.col = j - a.net_out[b];
  return o;
}

// Member k's rows of the per-member arrays (k = 0: train()'s call).
struct EhwMember {
  float* params;
  float* m;
  float* v;
  float* u;
  float* bn;
  float* ws;
  float* partials;
  float* head_partials;
  float* epoch_loss;
  float* lamb_parts;
  float* l2_parts;
  const int* perm;
  const float* scale;
  const float* valid;
  const float* tcount;
  const float* tmom;
};

__device__ __forceinline__ EhwMember ehw_member(const EhFusedWideArgs& a, int64_t k) {
  const int64_t np = a.n_params;
  const int64_t steps = (int64_t)a.n_epochs * a.n_batches;
  EhwMember M;
  M.params = a.params + k * np;
  M.m = a.m + k * np;
  M.v = a.v + k * np;
  M.u = a.u != nullptr ? a.u + k * np : nullptr;
  M.bn = a.bn + k * 2 * a.n_features;
  M.ws = a.ws + k * a.ws_stride;
  M.partials = a.partials + k * a.part_stride;
  M.head_partials = a.head_partials + k * a.head_blocks * (1 + a.n_globals);
  M.epoch_loss = a.epoch_loss + k * a.n_epochs;
  M.lamb_parts = a.lamb_parts != nullptr ? a.lamb_parts + k * a.lamb_stride : nullptr;
  M.l2_parts = a.l2_parts != nullptr ? a.l2_parts + k * a.l2_stride : nullptr;
  M.perm = a.perm + k * a.perm_stride;
  M.scale = a.scale + k * steps * a.n_targets;
  M.valid = a.valid + k * steps;
  M.tcount = a.tcount + k * steps;
  M.tmom = a.tmom != nullptr ? a.tmom + k * steps * a.n_targets * 3 : nullptr;
  return M;
}
// Packed parameters: [norm scale, norm bias] (n_features each, with a norm);
// per layer, every branch's in turn, W (dout x din, row-major) at p_off_w[l],
// then b (dout) at p_off_b[l]; the raw globals at p_off_g.


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
  int ldo;             // raw, forward, data: out's row stride (N, or a branch's columns of F)
  float* da;           // forward: act'(C + b)
  float* out_t;        // forward, data: out again, feature-major (N x M), or null
  const int* halt;     // the step's halt word (eh_halted), or null
  int round_out;       // forward, in the bf16 build: out rounded to bf16 (the next layer's input)
  int members;         // the member axis: blockIdx.x = member tiles_x + the tile's column
  int tiles_x;
  int64_t sa, sb, sbias, sout, sda, sout_t;  // floats between two members' A, B, bias, out, da, out_t
};

// The product of blockIdx.x's member (its operands sa, sb, ... further on)
// and its column of tiles (bx).
__device__ __forceinline__ EhwProduct ehw_member_product(const EhwProduct& g, int* bx) {
  const int k = (int)blockIdx.x / g.tiles_x;
  *bx = (int)blockIdx.x - k * g.tiles_x;
  EhwProduct p = g;
  p.A = g.A + k * g.sa;
  p.B = g.B + k * g.sb;
  if (g.bias != nullptr) p.bias = g.bias + k * g.sbias;
  p.out = g.out + k * g.sout;
  if (g.da != nullptr) p.da = g.da + k * g.sda;
  if (g.out_t != nullptr) p.out_t = g.out_t + k * g.sout_t;
  return p;
}

// Finishes the BM x BN output tile at (m0, n0) whose block has left its sums
// over its piece of the inner dimension in `tile` (row stride BN + 1). With
// more than one piece (forward, data, raw) the pieces' blocks form a
// thread-block cluster: after a cluster barrier each takes a band of
// BM / pieces rows, adds the pieces' sums of it from every block's shared
// memory in piece order, and finishes those rows; no partial goes to device
// memory and no atomic is needed. Each thread finishes column tid % BN of its
// rows; the feature-major copy is written after, neighbouring threads on
// neighbouring rows. BF16 (the bf16 build): a forward's output rounded to
// bf16 where p.round_out asks, a data gradient before its scale.
template <int BM, int BN, int THREADS, bool BF16 = false>
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
  float* out = p.out + (int64_t)(m0 + rb0) * p.ldo + c;
  if (col && p.mode == EHW_FORWARD) {
    const float bias = p.bias[c];
    float* da = p.da + (int64_t)(m0 + rb0) * p.N + c;
    for (int rl = tid / BN; rl < rows; rl += RSTEP) {
      float d;
      const float act = ehe_act(p.act, t[rl * LDT] + bias, &d);
      const float y = BF16 && p.round_out ? ehe_bf16(act) : act;
      out[(int64_t)rl * p.ldo] = y;
      da[(int64_t)rl * p.N] = d;
      t[rl * LDT] = y;
    }
  } else if (col && p.mode == EHW_DATA) {
#pragma unroll 4
    for (int rl = tid / BN; rl < rows; rl += RSTEP) {
      const float c = BF16 ? ehe_bf16(t[rl * LDT]) : t[rl * LDT];
      const float y = p.scale_in_place ? c * out[(int64_t)rl * p.ldo] : c;
      out[(int64_t)rl * p.ldo] = y;
      t[rl * LDT] = y;
    }
  } else if (col) {  // weight: this piece's partial tile; raw: the product
    const bool weight = p.mode == EHW_WEIGHT;
    float* dst = weight ? p.out + (int64_t)blockIdx.z * p.M * (p.N + 1) + (int64_t)m0 * p.N + c
                        : out;
    const int ld = weight ? p.N : p.ldo;
#pragma unroll 4
    for (int rl = tid / BN; rl < rows; rl += RSTEP) dst[(int64_t)rl * ld] = t[rl * LDT];
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

// Registers to the shared tile dst[k][i]; with RND rounded to bf16.
template <bool KC, bool RND = false>
__device__ __forceinline__ void ehw_stage(float (*dst)[EHW_LD], const float (&reg)[EHW_SHARE]) {
#pragma unroll
  for (int q = 0; q < EHW_SHARE; ++q) {
    int i, k;
    ehw_tile_index<KC>(q, &i, &k);
    dst[k][i] = RND ? ehe_bf16(reg[q]) : reg[q];
  }
}

// acc[i][j] = sum over k in [k0, k1) of A(m0 + 4 ty + i, k) B(k, n0 + 4 tx + j),
// k ascending, with ty = threadIdx.x / 16 and tx = threadIdx.x % 16. A(m, k) is
// A[m * lda + k] (AKC) or A[k * lda + m]; B(k, n) is B[n * ldb + k] (BKC) or
// B[k * ldb + n]. With want_rowsum, thread t < EHW_TILE also returns the sum
// over k of A(m0 + t, k), k ascending. The next tiles are fetched into
// registers while the current ones are multiplied. RB (the bf16 build's
// weights): B rounded to bf16 as it is staged.
template <bool AKC, bool BKC, bool RB = false>
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
    ehw_stage<BKC, RB>(Bs, rb);
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
// data gradient's W). BF16: W rounded to bf16 (ehw_product) and the
// bf16 build's finish.
template <bool BKC, bool BF16>
__device__ __forceinline__ void ehw_fma_product(const EhwProduct& g) {
  __shared__ float tile[EHW_TILE * (EHW_TILE + 1)];
  int bx;
  const EhwProduct p = ehw_member_product(g, &bx);
  const int m0 = blockIdx.y * EHW_TILE;
  const int n0 = bx * EHW_TILE;
  const int k0 = blockIdx.z * p.split_k;
  float acc[4][4];
  ehw_product<true, BKC, BF16>(p.A, p.lda, p.B, p.ldb, m0, p.M, n0, p.N, k0,
                               min(p.K, k0 + p.split_k), false, acc);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) tile[(ty * 4 + i) * (EHW_TILE + 1) + tx * 4 + j] = acc[i][j];
  ehw_finish<EHW_TILE, EHW_TILE, EHW_THREADS, BF16>(p, tile, m0, n0);
}

// A = act(H W^T + b), DA = act'(H W^T + b): M rows, N = dout outputs, K = din
// inputs. Grid (ceil(N / 64), ceil(M / 64), pieces).
template <bool BF16>
__global__ void __launch_bounds__(EHW_THREADS)
eh_wide_forward_kernel(const __grid_constant__ EhwProduct p) {
  if (eh_halted(p.halt)) return;
  ehw_fma_product<true, BF16>(p);
}

// dZ_prev = (dZ W) times act'(z) of the layer below, in place: M rows, N =
// din, K = dout.
template <bool BF16>
__global__ void __launch_bounds__(EHW_THREADS)
eh_wide_bwd_data_kernel(const __grid_constant__ EhwProduct p) {
  if (eh_halted(p.halt)) return;
  ehw_fma_product<false, BF16>(p);
}

// Split blockIdx.z of the batch: dW[j][k] = sum_r dZ[r][j] H[r][k] over the
// split's rows, written to part[split][j * din + k], and db[j] = sum_r dZ[r][j]
// to part[split][dout * din + j]: M = dout, N = din, H's rows ldh apart (din,
// or F for a branch's first layer, which reads its columns of the input). The
// member axis as the products' (blockIdx.x = member tiles_x + column; its dZ
// and H ws_stride further on, its partials part_stride).
__global__ void __launch_bounds__(EHW_THREADS)
eh_wide_bwd_weight_kernel(const float* __restrict__ dZ, const float* __restrict__ H, int ldh,
                          float* __restrict__ part, int M, int N, int batch, int split_rows,
                          const int* halt, int tiles_x, int64_t ws_stride, int64_t part_stride) {
  if (eh_halted(halt)) return;
  const int k = (int)blockIdx.x / tiles_x;
  const int bx = (int)blockIdx.x - k * tiles_x;
  dZ += k * ws_stride;
  H += k * ws_stride;
  part += k * part_stride;
  const int m0 = blockIdx.y * EHW_TILE;
  const int n0 = bx * EHW_TILE;
  const int r0 = blockIdx.z * split_rows;
  const int r1 = min(batch, r0 + split_rows);
  const bool bias = bx == 0;
  float acc[4][4];
  const float rowsum = ehw_product<false, false>(dZ, M, H, ldh, m0, M, n0, N, r0, r1, bias, acc);
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
// on) sits at floats (c G + g) 32, its row i at + 4 i. With BF16 (a bf16
// operand) x is rounded to bf16 first: exact in TF32, its small half is zero,
// is not stored and no product reads it.
template <int I, int THREADS, int G, bool BF16 = false>
__device__ __forceinline__ void eht_stage(float* big, float* small, const float (&r)[I][8]) {
#pragma unroll
  for (int q = 0; q < I; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int o = (2 * ((e / 8) % 4) * G + e / 32) * 32 + (e % 8) * 4;
    float b[8], s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x = BF16 ? ehe_bf16(r[q][j]) : r[q][j];
      b[j] = eht_tf32(x);
      s[j] = eht_tf32(x - b[j]);
    }
    *reinterpret_cast<float4*>(big + o) = make_float4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<float4*>(big + o + G * 32) = make_float4(b[4], b[5], b[6], b[7]);
    if constexpr (!BF16) {
      *reinterpret_cast<float4*>(small + o) = make_float4(s[0], s[1], s[2], s[3]);
      *reinterpret_cast<float4*>(small + o + G * 32) = make_float4(s[4], s[5], s[6], s[7]);
    }
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

// The tensor-core product's operands: both float32 (3xTF32, three passes),
// B bf16 (the bf16 build's data and weight gradients: A's small half against
// B's big, then big x big), or both bf16 (its forward: big x big alone).
enum { EHT_F32 = 0, EHT_BF16_B, EHT_BF16_AB };

template <int BM, int BN>
constexpr size_t eht_smem_bytes() {
  return (size_t)2 * 2 * (BM + BN) * EHW_TC_BK * sizeof(float);  // two stages of big and small
}

// The output tile (blockIdx.y, blockIdx.x) of BM x BN over piece blockIdx.z of
// the inner dimension, by BM / 64 warpgroups: 3xTF32 products of the staged
// slices (the passes PREC leaves), k ascending, then the mode's epilogue
// through shared memory. Registers are capped so that three blocks of
// 64 x 64, or two of 128 x 64, fit a multiprocessor beside their shared
// memory.
template <int BM, int BN, int PREC = EHT_F32>
__global__ void __launch_bounds__(2 * BM, BM == 64 ? 3 : 2) eh_wide_tc_kernel(const __grid_constant__ EhwProduct pg) {
  if (eh_halted(pg.halt)) return;
  int bx;
  const EhwProduct p = ehw_member_product(pg, &bx);
  constexpr int THREADS = 2 * BM;
  constexpr int GA = BM / 8;
  constexpr int GB = BN / 8;
  constexpr int IA = BM * 4 / THREADS;
  constexpr int IB = BN * 4 / THREADS;
  constexpr int SA = BM * EHW_TC_BK;  // floats of one copy of an operand's slice
  constexpr int SB = BN * EHW_TC_BK;
  constexpr int STAGE = 2 * (SA + SB);
  constexpr int LDT = BN + 1;  // row stride of the output tile in shared memory
  constexpr bool RA = PREC == EHT_BF16_AB;  // A rounded to bf16 as it is staged
  constexpr bool RB = PREC != EHT_F32;      // B rounded to bf16 as it is staged
  static_assert(BM * LDT <= 2 * STAGE, "the output tile must fit the stages");
  extern __shared__ __align__(128) float eht_smem[];
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int m0 = blockIdx.y * BM;
  const int n0 = bx * BN;
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
  const bool rowsums = p.mode == EHW_WEIGHT && bx == 0;
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
  eht_stage<IA, THREADS, GA, RA>(eht_smem, eht_smem + SA, ra);
  eht_stage<IB, THREADS, GB, RB>(eht_smem + 2 * SA, eht_smem + 2 * SA + SB, rb);
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
      if constexpr (PREC == EHT_F32) {
        eht_wgmma(acc, eht_desc(a_big + ca, GA * 128), eht_desc(b_small + cb, GB * 128), ks > 0);
        eht_wgmma(acc, eht_desc(a_small + ca, GA * 128), eht_desc(b_big + cb, GB * 128), 1);
      } else if constexpr (PREC == EHT_BF16_B) {
        eht_wgmma(acc, eht_desc(a_small + ca, GA * 128), eht_desc(b_big + cb, GB * 128), ks > 0);
      }
    }
#pragma unroll
    for (int ks = 0; ks < EHW_TC_BK / 8; ++ks) {
      const int ca = (2 * ks * GA + 8 * wg) * 32;
      const int cb = 2 * ks * GB * 32;
      eht_wgmma(acc, eht_desc(a_big + ca, GA * 128), eht_desc(b_big + cb, GB * 128),
                PREC == EHT_BF16_AB ? ks > 0 : 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (t + 1 < slices) {
      float* next = eht_smem + ((t + 1) & 1) * STAGE;
      if (rowsums) eht_row_sums(rs, ra);
      eht_stage<IA, THREADS, GA, RA>(next, next + SA, ra);
      eht_stage<IB, THREADS, GB, RB>(next + 2 * SA, next + 2 * SA + SB, rb);
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
  ehw_finish<BM, BN, THREADS, PREC != EHT_F32>(p, tile, m0, n0);
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

template <int BM, int BN, int PREC>
static cudaError_t eht_launch(const EhwProduct& p, int splits, cudaStream_t s) {
  if (p.tiles_x != (p.N + BN - 1) / BN) return cudaErrorInvalidValue;
  const dim3 grid(p.tiles_x * p.members, (p.M + BM - 1) / BM, splits);
  if (p.mode != EHW_WEIGHT)
    return ehw_launch_cluster(eh_wide_tc_kernel<BM, BN, PREC>, grid, 2 * BM,
                              eht_smem_bytes<BM, BN>(), s, p);
  eh_wide_tc_kernel<BM, BN, PREC><<<grid, 2 * BM, eht_smem_bytes<BM, BN>(), s>>>(p);
  return cudaGetLastError();
}

static bool eht_shape_ok(int bm, int bn) { return (bm == 64 || bm == 128) && bn == 64; }

// Allows each instance its shared memory (above the default 48 KB).
template <int PREC>
static cudaError_t eht_allow_smem() {
  cudaFuncSetAttribute(eh_wide_tc_kernel<64, 64, PREC>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)eht_smem_bytes<64, 64>());
  cudaFuncSetAttribute(eh_wide_tc_kernel<128, 64, PREC>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)eht_smem_bytes<128, 64>());
  return cudaGetLastError();
}

template <int PREC>
static cudaError_t eht_run(int bm, const EhwProduct& p, int splits, cudaStream_t s) {
  return bm == 64 ? eht_launch<64, 64, PREC>(p, splits, s) : eht_launch<128, 64, PREC>(p, splits, s);
}

template <bool BF16>
static cudaError_t ehw_fma_run(bool forward, const EhwProduct& p, int splits, cudaStream_t s) {
  if (p.tiles_x != (p.N + EHW_TILE - 1) / EHW_TILE) return cudaErrorInvalidValue;
  const dim3 grid(p.tiles_x * p.members, (p.M + EHW_TILE - 1) / EHW_TILE, splits);
  return ehw_launch_cluster(forward ? eh_wide_forward_kernel<BF16> : eh_wide_bwd_data_kernel<BF16>,
                            grid, EHW_THREADS, 0, s, p);
}

// ---------------------------------------------------------------------------
// the step's other kernels
// ---------------------------------------------------------------------------

// The sum over a block of EHW_HEAD_THREADS threads of each thread's v,
// pairwise in a fixed order; every thread gets it. Every thread must call it.
__device__ __forceinline__ float ehw_block_sum(float* red, float v) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = EHW_HEAD_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

// A trainable norm's statistics of the step's batch, block k for feature k:
// the mean and the biased variance about it over every row of the gathered
// batch, padding rows included (forward_mlp's bn_train branch,
// easyhybrid_tpu/ops/fused_epoch.py:720-745), each a pass over the rows in a
// fixed order (a thread's rows in order, then a pairwise tree), into
// ws_off_stats; and the running statistics' EMA with the norm's momentum
// where the batch holds a valid target (the update's gate; kernel 2's EMA,
// csrc/fused_epoch.cu). Bound by its reads: 2 batch x F floats a step
// through the row index, at batch 64 and F = 2 a few microseconds of launch.
__global__ void __launch_bounds__(EHW_HEAD_THREADS)
eh_wide_norm_stats_kernel(const __grid_constant__ EhFusedWideArgs a, int step) {
  if (eh_halted(a.halt)) return;
  __shared__ float red[EHW_HEAD_THREADS];
  const EhwMember M = ehw_member(a, blockIdx.y);
  const int F = a.n_features;
  const int B = a.batch;
  const int k = blockIdx.x;
  const int* idx = M.perm + (int64_t)step * B;
  float sum = 0.0f;
  for (int r = threadIdx.x; r < B; r += EHW_HEAD_THREADS) sum += a.x[(int64_t)idx[r] * F + k];
  const float mean = ehw_block_sum(red, sum) / (float)B;
  float dev = 0.0f;
  for (int r = threadIdx.x; r < B; r += EHW_HEAD_THREADS) {
    const float d = a.x[(int64_t)idx[r] * F + k] - mean;
    dev += d * d;
  }
  const float var = ehw_block_sum(red, dev) / (float)B;
  if (threadIdx.x == 0) {
    M.ws[a.ws_off_stats + k] = mean;
    M.ws[a.ws_off_stats + F + k] = var;
    if (M.valid[step] > 0.0f) {  // the running statistics' EMA, gated like the update
      M.bn[k] = a.one_minus_momentum * M.bn[k] + a.momentum * mean;
      M.bn[F + k] = a.one_minus_momentum * M.bn[F + k] + a.momentum * var;
    }
  }
}

// The batch's rows through the row index, normed (by the running statistics
// of a static norm, or by the batch's own, eh_wide_norm_stats_kernel): one
// thread per (row, feature) of every branch's columns; also feature-major
// where the column's branch has its first layer on the tensor cores. BF16:
// the first layers' input rounded to bf16.
template <bool BF16>
__global__ void __launch_bounds__(256)
eh_wide_gather_kernel(const __grid_constant__ EhFusedWideArgs a, int step) {
  if (eh_halted(a.halt)) return;
  const int F = a.n_features;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)a.batch * F) return;
  const EhwMember M = ehw_member(a, blockIdx.y);
  const int r = (int)(e / F);
  const int k = (int)(e % F);
  const int64_t row = M.perm[(int64_t)step * a.batch + r];
  float h = a.x[row * F + k];
  if (a.norm_mode != NORM_NONE) {
    const float* st = a.norm_mode == NORM_TRAIN ? M.ws + a.ws_off_stats : M.bn;
    const float xh = (h - st[k]) * rsqrtf(st[F + k] + a.norm_eps);
    M.ws[a.ws_off_xhat + e] = xh;
    h = xh * M.params[k] + M.params[F + k];
  }
  if constexpr (BF16) h = ehe_bf16(h);
  M.ws[a.ws_off_h0 + e] = h;
  int b = 0;  // the column's branch
  while (b + 1 < a.n_nets && k >= a.net_col[b + 1]) ++b;
  const int l = a.net_first[b];
  if (a.tc[l]) M.ws[a.ws_off_ht[l] + (int64_t)(k - a.net_col[b]) * a.batch + r] = h;
}

// The kernel form's arguments of the batch's row r, slot `row` of the data
// (its raw network outputs in the member's workspace `ws`, each in its
// branch's last layer, the member's parameters `params`) and the form's
// outputs and partials.
__device__ __forceinline__ void ehw_head_form(const EhFusedWideArgs& a, const float* params,
                                              const float* ws, int r, int64_t row,
                                              float (&out)[EH_MAX_OUT],
                                              float (&pd)[EH_MAX_OUT][EH_MAX_ARGS]) {
  const int P = a.n_neural;
  const int G = a.n_globals;
  const float* nlo = a.consts;
  const float* nspan = a.consts + P;
  const float* glo = a.consts + 2 * P;
  const float* gspan = a.consts + 2 * P + G;
  const float* fixed = a.consts + 2 * P + 2 * G;
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
        case SRC_NEURAL: {
          const EhwOut o = ehw_out(a, id);
          val = ws[a.ws_off_a[o.layer] + (int64_t)r * o.width + o.col];
          if (a.scale_nn_outputs) val = nlo[id] + nspan[id] * ehe_sigmoid(val);
          break;
        }
        case SRC_SCALAR:
          val = id < G ? glo[id] + gspan[id] * ehe_sigmoid(params[a.p_off_g + id])
                       : fixed[id - G];
          break;
        default: val = a.arg_const[i]; break;
      }
    }
    av[i] = val;
  }
  ehe_form(a.form, av, out, pd);
}

__host__ __device__ __forceinline__ bool ehw_two_pass(int kind) {
  return kind == LOSS_RMSE || ehe_loss_is_stat(kind);
}

// One thread per row: from the raw network outputs to the last layer's
// pre-activation cotangent, and the block's sums of the loss and of the
// globals' gradients (phase 1; kernel_body's head, fused_epoch.py:1380-1470,
// its cotangent the chunked kernel's as well). TWO_PASS, the build rmse and
// the statistic losses take (ehw_two_pass), first runs phase 0: each row's
// prediction per target into ws_off_pred, and the block's sum of
// (pred - y)^2 m (rmse) or pred m (the others) into its row of ws_off_mom;
// its phase 1 then adds every block's moments in block order (the same bits
// in every block) into the coefficients of ehe_loss_row, and block 0 adds
// the batch's loss value, agg g or agg r a target. The other losses take the
// build without those paths, the parent's code. Bound by launch latency: a
// few floats a row.
template <bool TWO_PASS>
__global__ void __launch_bounds__(EHW_HEAD_THREADS)
eh_wide_head_kernel(const __grid_constant__ EhFusedWideArgs a, int step, int phase) {
  if (eh_halted(a.halt)) return;
  __shared__ float red[EHW_HEAD_THREADS];
  __shared__ float lc[8 * EH_MAX_TARGETS];  // two-pass losses: each target's coefficients
  __shared__ float lv[EH_MAX_TARGETS];      //   and its loss value
  const int tid = threadIdx.x;
  const int r = blockIdx.x * EHW_HEAD_THREADS + tid;
  const int P = a.n_neural;
  const int G = a.n_globals;
  const int T = a.n_targets;
  const int LK = a.loss_kind;
  const float* nspan = a.consts + P;
  const EhwMember M = ehw_member(a, blockIdx.y);
  float* mom = M.ws + a.ws_off_mom;

  if (TWO_PASS && phase == 0) {  // the predictions and the first moments
    float acc[EH_MAX_TARGETS];
#pragma unroll
    for (int j = 0; j < EH_MAX_TARGETS; ++j) acc[j] = 0.0f;
    if (r < a.batch) {
      const int64_t row = M.perm[(int64_t)step * a.batch + r];
      float out[EH_MAX_OUT];
      float pd[EH_MAX_OUT][EH_MAX_ARGS];
      ehw_head_form(a, M.params, M.ws, r, row, out, pd);
#pragma unroll
      for (int j = 0; j < EH_MAX_TARGETS; ++j) {
        if (j < T) {
          const bool on = a.mask[j][row] > 0.0f;
          const float pred = ehe_pick<EH_MAX_OUT>(out, a.target_out[j]);
          M.ws[a.ws_off_pred + (int64_t)j * a.batch + r] = pred;
          const float diff = on ? pred - a.y[j][row] : 0.0f;
          acc[j] = LK == LOSS_RMSE ? diff * diff : (on ? pred : 0.0f);
        }
      }
    }
    for (int j = 0; j < T; ++j) {
      const float v = ehw_block_sum(red, ehe_pick<EH_MAX_TARGETS>(acc, j));
      if (tid == 0) mom[((int64_t)blockIdx.x * T + j) * 3] = v;
    }
    return;
  }

  if (TWO_PASS) {  // every block's moments, in block order, into each target's coefficients
    if (tid < T) {
      const int j = tid;
      const float* tm = M.tmom + ((int64_t)step * T + j) * 3;
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
      for (int b = 0; b < a.head_blocks; ++b) {
        const float* q = mom + ((int64_t)b * T + j) * 3;
        s0 += q[0];
        s1 += q[1];
        s2 += q[2];
      }
      const float agg = M.scale[(int64_t)step * T + j];
      const float n = tm[0];
      float* c = lc + 8 * j;
      c[0] = agg;
      c[1] = 0.0f;
      c[2] = n;
      c[3] = c[5] = c[6] = c[7] = 0.0f;
      c[4] = tm[1];
      if (LK == LOSS_RMSE) {
        const float rr = sqrtf(s0 / n);
        c[1] = agg / (n * ehe_max_nan(rr, 1e-30f));
        lv[j] = agg * rr;
      } else {
        const float mh = s0 / n;
        float d[3];
        const float g = ehe_stat_loss(LK, mh, s1, s2, tm[2], tm[1], n, d);
        c[3] = mh;
        c[5] = d[0];
        c[6] = 2.0f * d[1];
        c[7] = d[2];
        lv[j] = agg * g;
      }
    }
    __syncthreads();
  }

  float term = 0.0f;
  float gg[EH_MAX_SCALARS];
#pragma unroll
  for (int j = 0; j < EH_MAX_SCALARS; ++j) gg[j] = 0.0f;

  if (r < a.batch) {
    const int64_t row = M.perm[(int64_t)step * a.batch + r];
    float out[EH_MAX_OUT];
    float pd[EH_MAX_OUT][EH_MAX_ARGS];
    ehw_head_form(a, M.params, M.ws, r, row, out, pd);

    // masked loss and its cotangent; the mask selects, so a NaN target that
    // the caller did not zero cannot reach the sums
    float cot[EH_MAX_TARGETS];
#pragma unroll
    for (int j = 0; j < EH_MAX_TARGETS; ++j) {
      cot[j] = 0.0f;
      if (j < T) {
        const bool on = a.mask[j][row] > 0.0f;
        const float pred = ehe_pick<EH_MAX_OUT>(out, a.target_out[j]);
        const float yv = a.y[j][row];
        const float diff = on ? pred - yv : 0.0f;
        EhLossCoef c = {};
        if (TWO_PASS) {
          const float* q = lc + 8 * j;
          c.c0 = q[0];
          c.c1 = q[1];
          c.n = q[2];
          c.mu_h = q[3];
          c.mu_y = q[4];
          c.k_mu = q[5];
          c.k_h = q[6];
          c.k_c = q[7];
        } else {
          c.c0 = M.scale[(int64_t)step * T + j];
          c.c1 = 2.0f * c.c0;
        }
        term += ehe_loss_row<TWO_PASS>(LK, c, on ? pred : 0.0f, on ? yv : 0.0f, on ? 1.0f : 0.0f,
                                       diff, cot[j]);
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
    // layer's activation of each output's branch (also feature-major where
    // that layer is on the tensor cores)
    for (int j = 0; j < P; ++j) {
      const EhwOut o = ehw_out(a, j);
      const int64_t at = (int64_t)r * o.width + o.col;
      float* dl = M.ws + a.ws_off_d[o.layer] + at;
      float dn = 0.0f;
#pragma unroll
      for (int i = 0; i < EH_MAX_ARGS; ++i)
        if (i < a.n_args && a.arg_src[i] == SRC_NEURAL && a.arg_idx[i] == j) dn += c[i];
      float dsc = 1.0f;
      if (a.scale_nn_outputs) {
        const float sg = ehe_sigmoid(M.ws[a.ws_off_a[o.layer] + at]);
        dsc = nspan[j] * (sg * (1.0f - sg));
      }
      *dl = (dn * dsc) * *dl;
      if (a.tc[o.layer]) M.ws[a.ws_off_dt[o.layer] + (int64_t)o.col * a.batch + r] = *dl;
    }
  }
  if (TWO_PASS && blockIdx.x == 0 && tid == 0)  // the batch's loss value, a target at a time
    for (int j = 0; j < T; ++j) term += lv[j];

  // the block's sums, pairwise in a fixed order
  for (int q = 0; q <= G; ++q) {
    const float v = ehw_block_sum(red, q == 0 ? term : ehe_pick<EH_MAX_SCALARS>(gg, q - 1));
    if (tid == 0) M.head_partials[(int64_t)blockIdx.x * (1 + G) + q] = v;
  }
}

// The statistic losses' second moments (kernel_body's centred sums,
// fused_epoch.py:1414-1450), one thread per row: every block adds the
// blocks' sums of pred m in block order into the batch's mean prediction
// mu_h = sum / n (the same bits in every block), then takes its rows' dh =
// (pred m - mu_h) m and dy = (y - mean y) m and writes the block's sums of
// dh^2 and dh dy, pairwise in a fixed order, beside its first moment. Bound
// by launch latency: three floats a row.
__global__ void __launch_bounds__(EHW_HEAD_THREADS)
eh_wide_moments_kernel(const __grid_constant__ EhFusedWideArgs a, int step) {
  if (eh_halted(a.halt)) return;
  __shared__ float red[EHW_HEAD_THREADS];
  __shared__ float mu[EH_MAX_TARGETS];
  const int tid = threadIdx.x;
  const int r = blockIdx.x * EHW_HEAD_THREADS + tid;
  const int T = a.n_targets;
  const EhwMember M = ehw_member(a, blockIdx.y);
  float* mom = M.ws + a.ws_off_mom;
  if (tid < T) {
    float s0 = 0.0f;
    for (int b = 0; b < a.head_blocks; ++b) s0 += mom[((int64_t)b * T + tid) * 3];
    mu[tid] = s0 / M.tmom[((int64_t)step * T + tid) * 3];
  }
  __syncthreads();
  const int64_t row = r < a.batch ? M.perm[(int64_t)step * a.batch + r] : -1;
  for (int j = 0; j < T; ++j) {
    float dh = 0.0f, dy = 0.0f;
    if (row >= 0) {
      const bool on = a.mask[j][row] > 0.0f;
      const float m = on ? 1.0f : 0.0f;
      const float pred = on ? M.ws[a.ws_off_pred + (int64_t)j * a.batch + r] : 0.0f;
      const float yv = on ? a.y[j][row] : 0.0f;
      dh = (pred * m - mu[j]) * m;
      dy = (yv - M.tmom[((int64_t)step * T + j) * 3 + 1]) * m;
    }
    const float shh = ehw_block_sum(red, dh * dh);
    const float chy = ehw_block_sum(red, dh * dy);
    if (tid == 0) {
      float* q = mom + ((int64_t)blockIdx.x * T + j) * 3;
      q[1] = shh;
      q[2] = chy;
    }
  }
}

// Block s sums its rows of the norm's gradients: dscale[k] = sum_r d0 xhat,
// dbias[k] = sum_r d0, in row order.
__global__ void __launch_bounds__(128)
eh_wide_norm_grad_kernel(const __grid_constant__ EhFusedWideArgs a) {
  if (eh_halted(a.halt)) return;
  const EhwMember M = ehw_member(a, blockIdx.y);
  const int F = a.n_features;
  const int r0 = blockIdx.x * a.norm_split_rows;
  const int r1 = min(a.batch, r0 + a.norm_split_rows);
  const float* d0 = M.ws + a.ws_off_d0;
  const float* xh = M.ws + a.ws_off_xhat;
  float* out = M.partials + a.part_off_norm + (int64_t)blockIdx.x * 2 * F;
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
    const int cols = (ehw_din(a, q) + EHW_UTILE - 1) / EHW_UTILE;
    const int n = cols * ((ehw_dout(a, q) + EHW_UTILE - 1) / EHW_UTILE);
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

// The packed index of the update's element e past the tiles (the norm's,
// the FMA layers' W, every b, the globals, in packed order), or -1 (the
// loss's thread, or none).
__device__ __forceinline__ int64_t ehw_element(const EhFusedWideArgs& a, int64_t e) {
  if (a.norm_mode != NORM_NONE) {
    if (e < 2 * a.n_features) return e;
    e -= 2 * a.n_features;
  }
  for (int l = 0; l < a.n_layers; ++l) {
    const int dout = ehw_dout(a, l);
    const int64_t w = a.tc[l] ? 0 : (int64_t)dout * ehw_din(a, l);
    if (e < w) return a.p_off_w[l] + e;
    e -= w;
    if (e < dout) return a.p_off_b[l] + e;
    e -= dout;
  }
  return e < a.n_globals ? a.p_off_g + e : -1;
}

// Whether packed element gid is in a leaf the weight-L2 penalty takes.
__device__ __forceinline__ bool ehw_penalised(const EhFusedWideArgs& a, const EhOptimizer& o,
                                              int64_t gid) {
  return a.l2_leaves != 0 && gid >= 0 && ((a.l2_leaves >> ehe_leaf_of(o, gid)) & 1ull);
}

// The sum over a block (whole warps, at most 256 threads) of each thread's v:
// a shuffle tree a warp, then the warps' sums in warp order; every thread
// gets the same bits. Every thread of the block must call it.
__device__ __forceinline__ float ehw_block_total(float v) {
  __shared__ float w[8];
  v = ehe_warp_sum(v);
  if ((threadIdx.x & 31) == 0) w[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += w[i];
  __syncthreads();
  return s;
}

// W^T of every tensor-core layer from the parameters, one tile a block: the
// copy the data gradients read, made at the start of every call (blockIdx.y
// the member). With the weight-L2 penalty every update block's sum of
// squares of its penalised parameters (the update's blocks: the tiles, then
// the other elements, as eh_wide_update_kernel cuts them, the same threads
// and orders) into the first row of the member's l2_parts: the first step's
// parameters before its update.
__global__ void __launch_bounds__(256)
eh_wide_transpose_kernel(const __grid_constant__ EhFusedWideArgs a, int tiles) {
  if (eh_halted(a.halt)) return;
  const EhwMember M = ehw_member(a, blockIdx.y);
  float sq = 0.0f;
  if ((int)blockIdx.x < tiles) {
    __shared__ float tile[EHW_UTILE][EHW_UTILE + 1];
    int l, j0, k0;
    ehw_weight_tile(a, blockIdx.x, &l, &j0, &k0);
    const int din = ehw_din(a, l);
    const int dout = ehw_dout(a, l);
    const int tx = threadIdx.x % EHW_UTILE;
    const int ty = threadIdx.x / EHW_UTILE;
    for (int i = ty; i < EHW_UTILE; i += 256 / EHW_UTILE)
      if (j0 + i < dout && k0 + tx < din) {
        const float w = M.params[a.p_off_w[l] + (int64_t)(j0 + i) * din + k0 + tx];
        tile[i][tx] = w;
        sq += w * w;
      }
    __syncthreads();
    float* wt = M.ws + a.ws_off_wt[l];
    for (int i = ty; i < EHW_UTILE; i += 256 / EHW_UTILE)
      if (k0 + i < din && j0 + tx < dout) wt[(int64_t)(k0 + i) * dout + j0 + tx] = tile[tx][i];
    if (a.l2_leaves == 0) return;
    if (!((a.l2_leaves >> ehe_leaf_of(a.optimizer, a.p_off_w[l])) & 1ull)) sq = 0.0f;
  } else {
    const int64_t gid = ehw_element(a, (int64_t)(blockIdx.x - tiles) * blockDim.x + threadIdx.x);
    if (ehw_penalised(a, a.optimizer, gid)) sq = M.params[gid] * M.params[gid];
  }
  sq = ehw_block_total(sq);
  if (threadIdx.x == 0) M.l2_parts[blockIdx.x] = sq;
}

// The update, blockIdx.y the member. Blocks below `tiles`: one tile of a
// tensor-core layer's W each (its gradient from the partials in split order,
// the update, and the new W written transposed as well). The others: one
// thread per remaining parameter (ehw_element), and one more that adds the
// batch loss to its epoch's sum. Pass 1 updates; pass 0 (lamb only, before
// pass 1) writes this block's part of every leaf's squared norms of the
// parameters and of the update directions into its row of lamb_parts. The
// rule and its numbers (a member's in place) sit in shared memory. The
// weight-L2 penalty: l2_coeff w added to a penalised gradient before the
// rule; in pass 1 every block writes the sum of squares of its penalised
// parameters after the update to the member's next row of l2_parts, and the
// loss's block adds this step's row (written by the step before, or the
// transpose) in block order for the loss. Six blocks a multiprocessor: the
// kernel moves the parameters, moments and partials once, and a register
// budget of 40 a thread keeps enough of their loads in flight (at 48,
// ptxas's own choice, the adam update took 32 us a step of the tower against
// 27 on an NVIDIA H100 80GB HBM3 at 700 W). BF16: each weight's gradient
// rounded to bf16 after its sum, before the rule.
template <bool BF16>
__global__ void __launch_bounds__(256, 6)
eh_wide_update_kernel(const __grid_constant__ EhFusedWideArgs a, int step, int tiles, int pass) {
  if (eh_halted(a.halt)) return;
  const int member = blockIdx.y;
  const EhwMember M = ehw_member(a, member);
  const int L = a.n_layers;
  const int G = a.n_globals;
  const int F = a.n_features;
  const bool valid = M.valid[step] > 0.0f;
  if (pass == 0 && !valid) return;  // the whole member alike
  __shared__ EhOptimizer os;
  {
    const int* src = reinterpret_cast<const int*>(&a.optimizer);
    const float* row = a.member_opt != nullptr ? a.member_opt + (int64_t)member * EHW_OPT_SCALARS
                                               : nullptr;
    int* dst = reinterpret_cast<int*>(&os);
    for (int i = threadIdx.x; i < (int)(sizeof(EhOptimizer) / sizeof(int)); i += blockDim.x) {
      const bool swept = row != nullptr && i >= EHW_OPT_FIRST && i < EHW_OPT_FIRST + EHW_OPT_SCALARS;
      dst[i] = swept ? __float_as_int(row[i - EHW_OPT_FIRST]) : src[i];
    }
    __syncthreads();
  }
  const EhOptimizer& o = os;
  const bool lamb = o.rule == OPT_LAMB;
  const bool l2 = a.l2_leaves != 0;
  EhOptStep st = {1.0f, 1.0f, 0.0f};
  if (valid) st = ehe_opt_step(o, fmaxf(M.tcount[step], 1.0f));
  __shared__ float tr[EH_MAX_LEAVES];
  float* my_parts = M.lamb_parts + (int64_t)blockIdx.x * o.n_leaves * 2;
  float* l2_next = l2 ? M.l2_parts + (int64_t)((step + 1) & 1) * gridDim.x : nullptr;

  if ((int)blockIdx.x < tiles) {
    __shared__ float tile[EHW_UTILE][EHW_UTILE + 1];
    int l, j0, k0;
    ehw_weight_tile(a, blockIdx.x, &l, &j0, &k0);
    const int din = ehw_din(a, l);
    const int dout = ehw_dout(a, l);
    const int64_t size = (int64_t)dout * (din + 1);
    const int tx = threadIdx.x % EHW_UTILE;
    const int ty = threadIdx.x / EHW_UTILE;
    constexpr int PER = EHW_UTILE * EHW_UTILE / 256;
    const float* part = M.partials + a.part_off[l];
    const bool pen = l2 && ((a.l2_leaves >> ehe_leaf_of(o, a.p_off_w[l])) & 1ull);
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
    if constexpr (BF16) {
#pragma unroll
      for (int q = 0; q < PER; ++q) g[q] = ehe_bf16(g[q]);
    }
    if (pen) {  // the penalty's term at the weights before the update
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int j = j0 + ty + q * (256 / EHW_UTILE);
        const int k = k0 + tx;
        if (j < dout && k < din) g[q] = g[q] + a.l2_coeff * M.params[a.p_off_w[l] + (int64_t)j * din + k];
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
        const float pv = M.params[gid];
        float mm = M.m[gid], vv = M.v[gid];
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
      ehe_leaf_trust_ratios(M.lamb_parts, gridDim.x, o.n_leaves, leaf, leaf, tr);
      trust = tr[leaf];
    }
    float sq = 0.0f;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int i = ty + q * (256 / EHW_UTILE);
      const int j = j0 + i;
      const int k = k0 + tx;
      if (j >= dout || k >= din) continue;
      const int64_t gid = a.p_off_w[l] + (int64_t)j * din + k;
      if (valid) ehe_update(o, st, &M.params[gid], &M.m[gid], &M.v[gid], &M.u[gid], g[q], trust);
      const float w = M.params[gid];
      tile[i][tx] = w;
      sq += w * w;
    }
    if (l2) {  // the next step's sum of squares before its update, this block's part
      sq = ehw_block_total(pen ? sq : 0.0f);
      if (threadIdx.x == 0) l2_next[blockIdx.x] = sq;
    }
    __syncthreads();
    float* wt = M.ws + a.ws_off_wt[l];
    for (int i = ty; i < EHW_UTILE; i += 256 / EHW_UTILE)
      if (k0 + i < din && j0 + tx < dout) wt[(int64_t)(k0 + i) * dout + j0 + tx] = tile[tx][i];
    return;
  }

  const int64_t e0 = (int64_t)(blockIdx.x - tiles) * blockDim.x;
  const int64_t e = e0 + threadIdx.x;
  const int64_t gid = ehw_element(a, e);
  int64_t loose = a.n_params;  // the elements past the tiles; the next thread adds the loss
  for (int l = 0; l < L; ++l)
    if (a.tc[l]) loose -= (int64_t)ehw_din(a, l) * ehw_dout(a, l);
  if (pass == 1 && valid && lamb) {  // the leaves of this block's elements, in packed order
    const int64_t last = min(e0 + (int64_t)blockDim.x, loose) - 1;
    ehe_leaf_trust_ratios(M.lamb_parts, gridDim.x, o.n_leaves,
                          last >= e0 ? ehe_leaf_of(o, ehw_element(a, e0)) : 0,
                          last >= e0 ? ehe_leaf_of(o, ehw_element(a, last)) : -1, tr);
  }
  // the penalty's sum of squares at this step's parameters before the update:
  // every block's part in block order, by the loss's block
  float l2_sum = 0.0f;
  if (l2 && pass == 1 && valid && e0 <= loose && loose < e0 + (int64_t)blockDim.x) {
    const float* prev = M.l2_parts + (int64_t)(step & 1) * gridDim.x;
    float v = 0.0f;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x) v += prev[b];
    l2_sum = ehw_block_total(v);
  }
  if (e == loose && pass == 1 && valid) {
    float loss = 0.0f;
    for (int b = 0; b < a.head_blocks; ++b) loss += M.head_partials[(int64_t)b * (1 + G)];
    if (l2) loss = loss + a.l2_outer * (a.l2_value * l2_sum);
    M.epoch_loss[step / a.n_batches] += loss;
  }
  float g = 0.0f;
  if (gid < 0) {
  } else if (gid >= a.p_off_g) {
    const int gi = (int)(gid - a.p_off_g);
    for (int b = 0; b < a.head_blocks; ++b) g += M.head_partials[(int64_t)b * (1 + G) + 1 + gi];
    const int P = a.n_neural;
    const float span = a.consts[2 * P + G + gi];
    const float sg = ehe_sigmoid(M.params[gid]);
    g = g * (span * (sg * (1.0f - sg)));
  } else if (a.norm_mode != NORM_NONE && gid < 2 * F) {
    const float* part = M.partials + a.part_off_norm + gid;
    for (int s = 0; s < a.norm_splits; ++s) g += part[(int64_t)s * 2 * F];
  } else {
    int l = 0;
    while (l + 1 < L && gid >= a.p_off_w[l + 1]) ++l;
    const int64_t size = (int64_t)ehw_dout(a, l) * (ehw_din(a, l) + 1);
    const float* part = M.partials + a.part_off[l] + (gid - a.p_off_w[l]);
#pragma unroll 4
    for (int s = 0; s < a.splits[l]; ++s) g += part[s * size];
    if constexpr (BF16) g = gid < a.p_off_b[l] ? ehe_bf16(g) : g;  // a weight, not the bias
  }
  const bool pen = l2 && ehw_penalised(a, o, gid);
  if (pen) g = g + a.l2_coeff * M.params[gid];  // at the parameter before the update
  if (pass == 0) {
    float pv = 0.0f, d = 0.0f;
    if (gid >= 0) {
      pv = M.params[gid];
      float mm = M.m[gid], vv = M.v[gid];
      d = ehe_lamb_direction(o, st, pv, g, mm, vv);
    }
    ehe_block_leaf_sums(pv * pv, d * d, gid >= 0 ? ehe_leaf_of(o, gid) : -1, o.n_leaves, my_parts);
    return;
  }
  if (gid >= 0 && valid)
    ehe_update(o, st, &M.params[gid], &M.m[gid], &M.v[gid], &M.u[gid], g,
               lamb ? tr[ehe_leaf_of(o, gid)] : 1.0f);
  if (l2) {  // the next step's sum of squares before its update, this block's part
    const float sq = ehw_block_total(pen ? M.params[gid] * M.params[gid] : 0.0f);
    if (threadIdx.x == 0) l2_next[blockIdx.x] = sq;
  }
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
      n += ehw_ceil_div(ehw_din(a, l), EHW_UTILE) * ehw_ceil_div(ehw_dout(a, l), EHW_UTILE);
  return n;
}

static int64_t ehw_loose_params(const EhFusedWideArgs& a) {
  int64_t n = a.n_params;
  for (int l = 0; l < a.n_layers; ++l)
    if (a.tc[l]) n -= (int64_t)ehw_din(a, l) * ehw_dout(a, l);
  return n;
}

#define EHW_TRY(call)                        \
  do {                                       \
    const cudaError_t err_ = (call);         \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

// Whether the branches' fields describe every layer once, in turn: branch b's
// layers from net_first[b] on, within EH_MAX_LAYERS, its widths within the
// cap, its columns and outputs after the branch before's.
static bool ehw_branches_ok(const EhFusedWideArgs& a) {
  if (a.n_nets < 1 || a.n_nets > EH_MAX_NETS || a.n_layers < 1 || a.n_layers > EHW_MAX_LAYERS)
    return false;
  int next = 0, col = 0, out = 0;
  for (int b = 0; b < a.n_nets; ++b) {
    const int n = a.net_layers[b];
    if (a.net_first[b] != next || n < 1 || n > EH_MAX_LAYERS || next + n > a.n_layers ||
        a.net_col[b] != col || a.net_out[b] != out)
      return false;
    for (int i = 0; i <= n; ++i)
      if (a.dims[next + b + i] < 1 || a.dims[next + b + i] > EH_WIDE_MAX_WIDTH) return false;
    for (int l = next; l < next + n; ++l)
      if (a.layer_net[l] != b) return false;
    col += a.dims[next + b];
    out += a.dims[next + b + n];
    next += n;
  }
  return next == a.n_layers && col == a.n_features && out == a.n_neural;
}

// Enqueue every step of the call on `stream`; returns the first launch
// error, or cudaGetLastError() (0 on success). The caller checks shapes,
// devices and the envelope first; the branches, the plan's tile shapes and
// pieces, and the member axis's strides, are checked here.
extern "C" int eh_fused_wide(const EhFusedWideArgs* args, void* stream) {
  const EhFusedWideArgs& a = *args;
  if (a.n_epochs <= 0 || a.n_batches <= 0) return 0;
  const int L = a.n_layers;
  if (!ehw_branches_ok(a) || a.batch < 1 || a.n_args > EH_MAX_ARGS ||
      !eh_form_built(a.form) || a.n_targets < 1 || !eh_loss_built(a.loss_kind) ||
      a.n_targets > EH_MAX_TARGETS || a.n_globals + a.n_fixed > EH_MAX_SCALARS ||
      a.optimizer.n_leaves < 1 || a.optimizer.n_leaves > EH_MAX_LEAVES ||
      a.head_blocks * EHW_HEAD_THREADS < a.batch || (a.norm_mode != NORM_NONE && a.norm_splits < 1) ||
      a.norm_mode < NORM_NONE || a.norm_mode > NORM_TRAIN || (ehw_two_pass(a.loss_kind) && !a.tmom) ||
      a.n_members < 1 || a.n_members > 65535 || a.perm_stride < 0 || a.ws_stride < 0 ||
      a.part_stride < 0)
    return (int)cudaErrorInvalidValue;
  const bool norm = a.norm_mode != NORM_NONE;
  const int B = a.batch;
  const int K = a.n_members;
  for (int l = 0; l < L; ++l) {
    const int din = ehw_din(a, l);
    const int dout = ehw_dout(a, l);
    const bool tc = a.tc[l] != 0;
    if (tc && (din < EHW_TC_MIN || dout < EHW_TC_MIN)) return (int)cudaErrorInvalidValue;
    if (!ehw_split_ok(B, a.splits[l], a.split_rows[l], tc ? EHW_TC_BK : EHW_BK) ||
        (tc && !eht_shape_ok(a.wgt_bm[l], a.wgt_bn[l])) ||
        !ehw_product_ok(tc, a.fwd_bm[l], a.fwd_bn[l], din, a.fwd_splits[l], a.fwd_split_k[l]) ||
        ((!ehw_first(a, l) || norm) &&
         !ehw_product_ok(tc, a.dat_bm[l], a.dat_bn[l], dout, a.dat_splits[l], a.dat_split_k[l])))
      return (int)cudaErrorInvalidValue;
  }

  // the bf16 build's products: the forward's operands both bf16, the
  // gradients' B (weights, layer inputs) bf16 against an f32 cotangent
  constexpr bool BF16 = EH_BF16_BUILD;
  constexpr int FWD = BF16 ? EHT_BF16_AB : EHT_F32;
  constexpr int BWD = BF16 ? EHT_BF16_B : EHT_F32;
  cudaStream_t s = (cudaStream_t)stream;
  const int F = a.n_features;
  float* ws = a.ws;
  const int gather_blocks = (int)(((int64_t)B * F + 255) / 256);
  const int tiles = ehw_weight_tiles(a);
  const int update_blocks = tiles + (int)((ehw_loose_params(a) + 1 + 255) / 256);
  const bool l2 = a.l2_leaves != 0;
  if ((a.optimizer.rule == OPT_LAMB &&
       (!a.lamb_parts || a.lamb_stride != (int64_t)update_blocks * 2 * a.optimizer.n_leaves)) ||
      (l2 && (!a.l2_parts || a.l2_stride != 2 * (int64_t)update_blocks)))
    return (int)cudaErrorInvalidValue;
  const int64_t np = a.n_params;
  // a product's operands: a member's workspace ws_stride further on, its
  // parameters n_params, its partial tiles part_stride
  auto product = [&](int n_out) {
    EhwProduct p = {};
    p.halt = a.halt;
    p.members = K;
    p.tiles_x = ehw_ceil_div(n_out, 64);
    return p;
  };
  EHW_TRY(eht_allow_smem<FWD>());
  if (BWD != FWD) EHW_TRY(eht_allow_smem<BWD>());
  if (tiles > 0 || l2) {  // with the penalty: every update block's first sum of squares too
    eh_wide_transpose_kernel<<<dim3(l2 ? update_blocks : tiles, K), 256, 0, s>>>(a, tiles);
    EHW_TRY(cudaGetLastError());
  }
  const int steps = a.n_epochs * a.n_batches;
  const bool two_pass = ehw_two_pass(a.loss_kind);
  for (int step = 0; step < steps; ++step) {
    if (a.norm_mode == NORM_TRAIN)
      eh_wide_norm_stats_kernel<<<dim3(F, K), EHW_HEAD_THREADS, 0, s>>>(a, step);
    eh_wide_gather_kernel<BF16><<<dim3(gather_blocks, K), 256, 0, s>>>(a, step);
    EHW_TRY(cudaGetLastError());
    for (int l = 0; l < L; ++l) {  // A = act(H W^T + b), and H^T of the next layer where it takes it
      const int b = a.layer_net[l];  // every branch's layers in turn; a first reads its columns
      const bool first = ehw_first(a, l);
      const bool last = ehw_last(a, l);
      const int din = ehw_din(a, l);
      const int dout = ehw_dout(a, l);
      EhwProduct p = product(dout);
      p.A = ws + (first ? a.ws_off_h0 + a.net_col[b] : a.ws_off_a[l - 1]);
      p.sa = a.ws_stride;
      p.lda = first ? F : din;
      p.B = a.params + a.p_off_w[l];
      p.sb = np;
      p.ldb = din;
      p.M = B;
      p.N = dout;
      p.K = din;
      p.split_k = a.fwd_split_k[l];
      p.mode = EHW_FORWARD;
      p.act = a.acts[l];
      p.bias = a.params + a.p_off_b[l];
      p.sbias = np;
      p.out = ws + a.ws_off_a[l];
      p.ldo = dout;
      p.sout = a.ws_stride;
      p.da = ws + a.ws_off_d[l];
      p.sda = a.ws_stride;
      p.out_t = !last && a.tc[l + 1] ? ws + a.ws_off_ht[l + 1] : nullptr;
      p.sout_t = a.ws_stride;
      p.round_out = !last;
      EHW_TRY(a.tc[l] ? eht_run<FWD>(a.fwd_bm[l], p, a.fwd_splits[l], s)
                      : ehw_fma_run<BF16>(true, p, a.fwd_splits[l], s));
    }
    const dim3 heads(a.head_blocks, K);
    if (two_pass) {  // the batch's prediction moments first
      eh_wide_head_kernel<true><<<heads, EHW_HEAD_THREADS, 0, s>>>(a, step, 0);
      if (ehe_loss_is_stat(a.loss_kind))
        eh_wide_moments_kernel<<<heads, EHW_HEAD_THREADS, 0, s>>>(a, step);
      eh_wide_head_kernel<true><<<heads, EHW_HEAD_THREADS, 0, s>>>(a, step, 1);
    } else {
      eh_wide_head_kernel<false><<<heads, EHW_HEAD_THREADS, 0, s>>>(a, step, 1);
    }
    EHW_TRY(cudaGetLastError());
    for (int b = 0; b < a.n_nets; ++b) {  // each branch from its last layer to its first
      const int l0 = a.net_first[b];
      for (int l = l0 + a.net_layers[b] - 1; l >= l0; --l) {
        const bool first = l == l0;
        const int din = ehw_din(a, l);
        const int dout = ehw_dout(a, l);
        const float* dz = ws + a.ws_off_d[l];
        if (a.tc[l]) {  // dW = dZ^T H and db over the batch's pieces, from the feature-major copies
          EhwProduct p = product(din);
          p.A = ws + a.ws_off_dt[l];
          p.sa = a.ws_stride;
          p.lda = B;
          p.B = ws + a.ws_off_ht[l];
          p.sb = a.ws_stride;
          p.ldb = B;
          p.M = dout;
          p.N = din;
          p.K = B;
          p.split_k = a.split_rows[l];
          p.mode = EHW_WEIGHT;
          p.out = a.partials + a.part_off[l];
          p.sout = a.part_stride;
          EHW_TRY(eht_run<BWD>(a.wgt_bm[l], p, a.splits[l], s));
        } else {
          const float* h = ws + (first ? a.ws_off_h0 + a.net_col[b] : a.ws_off_a[l - 1]);
          const int tiles_x = ehw_ceil_div(din, EHW_TILE);
          const dim3 wgrid(tiles_x * K, ehw_ceil_div(dout, EHW_TILE), a.splits[l]);
          eh_wide_bwd_weight_kernel<<<wgrid, EHW_THREADS, 0, s>>>(
              dz, h, first ? F : din, a.partials + a.part_off[l], dout, din, B, a.split_rows[l],
              a.halt, tiles_x, a.ws_stride, a.part_stride);
          EHW_TRY(cudaGetLastError());
        }
        if (!first || norm) {  // dZ_prev = (dZ W) * act'_prev in place (or the branch's columns
                               // of the norm's cotangent), and its copy where needed
          EhwProduct p = product(din);
          p.A = dz;
          p.sa = a.ws_stride;
          p.lda = dout;
          p.B = a.tc[l] ? ws + a.ws_off_wt[l] : a.params + a.p_off_w[l];
          p.sb = a.tc[l] ? a.ws_stride : np;
          p.ldb = a.tc[l] ? dout : din;
          p.M = B;
          p.N = din;
          p.K = dout;
          p.split_k = a.dat_split_k[l];
          p.mode = EHW_DATA;
          p.scale_in_place = first ? 0 : 1;
          p.out = ws + (first ? a.ws_off_d0 + a.net_col[b] : a.ws_off_d[l - 1]);
          p.ldo = first ? F : din;
          p.sout = a.ws_stride;
          p.out_t = !first && a.tc[l - 1] ? ws + a.ws_off_dt[l - 1] : nullptr;
          p.sout_t = a.ws_stride;
          EHW_TRY(a.tc[l] ? eht_run<BWD>(a.dat_bm[l], p, a.dat_splits[l], s)
                          : ehw_fma_run<BF16>(false, p, a.dat_splits[l], s));
        }
      }
    }
    if (norm) eh_wide_norm_grad_kernel<<<dim3(a.norm_splits, K), 128, 0, s>>>(a);
    if (a.optimizer.rule == OPT_LAMB)  // its leaves' norms first
      eh_wide_update_kernel<BF16><<<dim3(update_blocks, K), 256, 0, s>>>(a, step, tiles, 0);
    eh_wide_update_kernel<BF16><<<dim3(update_blocks, K), 256, 0, s>>>(a, step, tiles, 1);
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
  EHW_TRY(eht_allow_smem<EHT_F32>());
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
  p.ldo = N;
  p.members = 1;
  p.tiles_x = ehw_ceil_div(N, bn);
  return (int)eht_run<EHT_F32>(bm, p, splits, (cudaStream_t)stream);
}
