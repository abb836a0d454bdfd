// Fused training epochs for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel built by make_fused_epoch in
// easyhybrid_tpu/ops/fused_epoch.py (run_kernel_epoch at :2128, its kernel at
// :2269 with kernel_body at :1268; pallas_call at :2662). One launch runs
// n_epochs x n_batches SGD steps of an MLP hybrid in the JAX kernel's branch
// view: one network giving every neural parameter (SingleNN), one
// single-output network per neural parameter over its own predictor columns
// (MultiNN, up to EH_MAX_NETS branches, each an EhNet), or none (globals
// only). Each step:
//   1. gathers the batch's rows through the permutation index perm[e][i*B + r];
//   2. input norm over every network's columns at once: trainable BatchNorm
//      (batch mean and biased variance, two passes over the batch's rows,
//      padding rows included, then the EMA of the running statistics),
//      static (the carried statistics) or none;
//   3. each network's forward on its own columns, saving each layer's input
//      and activation derivative, its outputs into its neural slots; sigmoid
//      bound scaling of the neural outputs; the scaled globals;
//   4. the mechanistic model in its kernel form, with its partials;
//   5. the masked loss and its cotangent, n = max(sum(mask), 1) per target,
//      agg sum or mean: every loss of the JAX kernel (eh_device.cuh's loss
//      layer): mse, mae, nseLoss (its target SST taken a step ahead), a traced
//      elementwise loss, and rmse, pearsonLoss, kgeLoss and pbkgeLoss, whose
//      cotangents need the batch's prediction moments first;
//   6. the hand-written backward through the form's partials, the bound
//      scaling and each network from its slots' cotangents, including the
//      norm's affine scale and bias;
//   7. the batch-validity gate: an all-masked batch changes nothing;
//   8. the update by any of the optax rules of the JAX kernel (eh_device.cuh,
//      ehe_update; lamb's per-leaf norms first, in a pass of their own).
// Parameters, moments, the step counter and the BatchNorm statistics are read
// into shared memory once, stay there across every step of the launch, and
// are written back once at the end, with the last epoch's mean batch loss.
//
// The member axis (population training, replacing the JAX kernel under
// jax.vmap in easyhybrid_tpu/training/population.py:825 with the streamed
// optimizer scalars of make_fused_epoch(traced_hyper=...), ops/fused_epoch.py
// :1130-1200 and :2349-2360): one launch trains n_members models side by
// side, a thread-block cluster each (the grid (cluster, n_members), the
// member blockIdx.y). Member k's parameters, slots, step count, statistics
// and loss are the k-th rows of the state arrays (a fold's input norm is
// its statistics row); its row index sits perm_stride further on (0 where
// the members share it); its data is where its row index points (a fold's
// rows follow the folds before it); its optimizer numbers are row k of
// member_opt, or the shared struct's where that is null. The constants
// (bounds and fixed values) are the model's, one set for every member. The members share nothing and
// never wait on one another: each cluster runs the one-model code on its own
// numbers, so a member's bits are those of a launch of it alone.
//
// What bounds it on an H100: every step needs the previous step's update, so
// a launch is a chain of n_epochs x n_batches dependent steps, and a step of
// a [16, 16] network on 512 rows is ~1 MFLOP and 12 KB of rows: nothing for
// the card's arithmetic or memory rate, everything for latency. A step costs
// what its longest dependent path costs: device-memory round trips, block
// and cluster barriers, sums taken by one thread, and one thread's own
// instruction stream, which on this card is paced as much by instruction
// fetch (taken branches, straight-line code that is skipped) as by
// arithmetic.
//
// What the design does about it:
//   * The whole batch in flight: one row per thread, blocks of up to 256 rows
//     while a thread-block cluster of up to 8 blocks has room (two warps a
//     scheduler on two multiprocessors ran the main shape faster than four on
//     one), then up to 512 threads a block. Only a batch beyond that, or a
//     model whose state leaves little shared memory, walks tiles serially.
//   * Rows gathered once, ahead of the chain: a step's rows (predictors,
//     forcing, targets, masks) are staged in shared memory by cp.async
//     through the index, and step s + 1's rows are in flight while step s
//     computes, across epoch boundaries too; every pass over a batch (mean,
//     variance, forward) reads the stage.
//   * Every sum is a tree of fixed shape: warp shuffles, then per-warp
//     partials added by a warp in warp order, then (in a cluster) the blocks'
//     partials read through distributed shared memory in rank order. Every
//     block ends with the same bits and two runs give the same bits; there
//     are no float atomics. The parameter gradients are cut into units of
//     4 x 4 (cotangent feature x input feature); a warp takes a unit, its
//     lanes split the rows, and one folding shuffle tree of 16 shuffles
//     leaves all 16 sums. The units are described once a launch.
//   * Layers at their own size: a row's products loop over the layer's own
//     outputs, four at a time; weights sit in shared memory with rows padded
//     to 4 floats and are read as one 16-byte broadcast load per four
//     products; the activation is chosen by one branch per four outputs, and
//     its sigmoid carries no branch, so the four interleave. Only the
//     layer's input vector is unrolled to the kernel's width (it lives in
//     registers); the row's small vectors (outputs, cotangents of the
//     globals) live in the row's column of the tile and are walked by loops
//     of their own length, which costs less in instruction fetch than code
//     unrolled to the width and predicated off.
//   * Every block of a cluster keeps the whole state and applies the same
//     update from the same gradient bits, so nothing is sent back.
//   * What does not depend on the parameters leaves the critical barriers: a
//     step's mask counts and batch mean are taken at the end of the step
//     before and exchanged with its gradient, and what the optimizer rule
//     takes from the step count (bias corrections, radam's rectification) is
//     computed then too, by the warp with the fewest units.
//   * rmse and the statistic losses: with the block's rows in flight at once,
//     a row keeps its residuals, form outputs and partials while the block
//     exchanges the batch's moments (the sums of the predictions, then their
//     centred squares and products with the targets), each exchange the fixed
//     tree of every other sum; a warp a target then takes g and its partials
//     (ehe_stat_loss) into shared memory. A block that walks tiles takes the
//     moments first, in passes whose forwards save nothing. The targets'
//     mean and SST (nseLoss, the statistic losses) are taken at the end of the
//     step before, beside its counts.
//   * Lamb's trust ratio needs the norms of a leaf's parameters and update
//     directions: a warp takes a leaf, its lanes in a fixed stride and then a
//     shuffle tree, so every block of a cluster gets the same bits from the
//     same gradient; the directions are computed again in the update rather
//     than kept, so the state needs no more shared memory.
// Per step, with a trainable norm: an exchange barrier (the cluster's, or the
// block's without a cluster) for the variance, one for the gradient, the loss
// and the next step's counts and mean; and 3 block barriers (after the
// variance, between the rows' pass and the gradient units, after the
// update). Without a trainable norm the variance barrier goes and the one
// after the update is an exchange barrier, so that no block overwrites
// partials another still reads.
//
// The declarative weight-L2 extra_loss (l2_extra_loss; the JAX kernel's,
// ops/fused_epoch.py:1217-1225, :2365-2372, :2525-2557), a runtime field of
// the arguments (l2_leaves 0: none), taken by the builds of the losses besides
// mse (the launcher runs a penalised mse on the rows' build, which computes it
// too), so that mse's own build keeps the code it had before the penalty came
// and its time: each penalised parameter's gradient gets
// l2_coeff w, w before the update, ahead of the rule; the batch loss gets
// l2_outer (l2_value S), S the sum of squares of the penalised parameters
// before the update. S is taken off the step's chain: the thread that
// updates a parameter adds its square after the update (or as it stands, in
// a step without a valid target) into its warp's partial of the next step's
// S (a shuffle tree), two steps' rows of partials in shared memory (XL2); at
// the start of the launch the same threads take the first step's; warp 0
// adds the warps' partials in warp order where it adds the batch loss.
//
// The bf16 build (-DEH_BF16, eh_device.cuh; a model with
// compute_dtype=bfloat16, forward_mlp / backward_mlp of the JAX kernel with
// bf16 operands, fused_epoch.py:716-841): each block keeps a second copy of
// the parameters in the padded layout, rounded to bf16, from which the row
// code reads every layer's weights (refreshed by the thread that updates a
// parameter, right after its update); a row's normed input and each layer's
// outputs are rounded to bf16 where they are stored as the next layer's
// input and residual, each layer's input cotangent before the activation
// derivative multiplies it; each weight's gradient is rounded to bf16 after
// its whole-batch sum in the fixed order (the cluster's partials included),
// before the rule. The norm, the biases, the globals and the update stay
// float32.
//
// Built without --use_fast_math, as fused_forward.cu.

#include <cstddef>

#include "eh_device.cuh"

// Mirrored field by field by _Args in easyhybrid_tpu_torch/ops/fused_epoch.py;
// eh_fused_epoch_args_size() lets the wrapper check the two agree.
struct EhFusedEpochArgs {
  const float* x;                        // (n_rows, n_features) row-major
  const float* forcing[EH_MAX_FORCING];  // (n_rows,) each
  const float* y[EH_MAX_TARGETS];        // (n_rows,) each, 0 where masked
  const float* mask[EH_MAX_TARGETS];     // (n_rows,) each, 0 or 1
  const int* perm;                       // (n_epochs, n_rows) row index
  float* params;                         // packed parameters, in place
  float* m;                              // first moments, in place
  float* v;                              // second moments, in place
  float* u;                              // amsgrad's third slot, in place (else unused)
  float* bn;                             // running means, vars (2 n_features), in place
  int* t;                                // step counter (1), in place
  const float* consts;                   // neural lo, span; global lo, span; fixed
  float* loss;                           // (1) last epoch's mean batch loss
  int64_t n_rows;
  int n_epochs;
  int n_batches;
  int batch;
  int n_features;                        // predictor columns: every network's, side by side
  int n_neural;                          // neural outputs: every network's, in turn
  int norm_mode;                         // 0 none, 1 static, 2 trainable
  float norm_eps;
  float momentum;
  float one_minus_momentum;
  int n_params;
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
  float agg_scale;
  int loss_kind;                         // LOSS_* (eh_device.cuh)
  int loss_sst;                          // 1: the batch's target mean and SST (nseLoss, statistic losses)
  int loss_sum;                          // 1: a traced loss summed (scale agg), 0: by mean (agg / n)
  EhOptimizer optimizer;                 // the rule and its hyperparameters
  int tile_rows;                         // threads of a block: rows it takes at once
  int res_floats;
  int r_off_xhat;
  int r_off_d0;
  int r_off_g;
  int r_off_out;                         // the networks' outputs, then their cotangents
  int r_off_dsc;                         // the bound scaling's derivative
  int r_off_one;                         // a feature that is 1 on every row
  int n_forcing;
  int n_padded;                          // parameters with weight rows padded to 4
  int pp_off_g;
  int block_rows;                        // rows of a batch one block owns
  int stages;                            // 2: rows staged and prefetched; 0: read in place
  int cluster;                           // blocks over a batch's rows
  int moments_shared;                    // 1: m, v in shared memory; 2: u too; 0: in device memory
  int n_unit_table;                      // gradient units described once a launch (the first ones)
  int n_nets;                            // networks: 0 (globals only), 1, or a MultiNN model's branches
  EhNet nets[EH_MAX_NETS];
  long long* stamps;                     // (EHE_N_STAMPS) cycles per stage, or null
  const int* halt;                       // the halt word (eh_halted), or null
  float l2_coeff;                        // the weight-L2 penalty: ex_outer 2 scale / norm_div,
  float l2_value;                        //   scale / norm_div,
  float l2_outer;                        //   ex_outer (0.5 under agg mean, else 1),
  int64_t l2_leaves;                     //   bit l: leaf l penalised (0: no penalty)
  int n_members;                         // models trained side by side, a cluster each (1: train())
  int64_t perm_stride;                   // ints between two members' row indexes (0: one shared)
  const float* member_opt;               // (n_members, EHE_OPT_SCALARS) optimizer numbers, or null
};
// A member's optimizer numbers: EhOptimizer's floats from lr to rect_den, in
// its order, filled by the host as the struct's own; the rule, sgd's Nesterov
// flag and lamb's leaves stay the shared struct's. Each block copies the
// struct into shared memory with its member's numbers in place
// (EHE_OPT_WORDS floats of the layout).
#define EHE_OPT_SCALARS 13
#define EHE_OPT_WORDS 56
#define EHE_OPT_FIRST 2
static_assert(sizeof(EhOptimizer) == EHE_OPT_WORDS * sizeof(float), "EhOptimizer's size");
static_assert(offsetof(EhOptimizer, lr) == EHE_OPT_FIRST * sizeof(float) &&
                  offsetof(EhOptimizer, rect_den) ==
                      (EHE_OPT_FIRST + EHE_OPT_SCALARS - 1) * sizeof(float),
              "EhOptimizer's numbers from lr to rect_den");
// Packed parameters: [norm scales, norm biases] (n_features each, with a
// norm: every network's columns); per network, per layer W (dout x din,
// row-major) at nets[b].p_off_w[l], b (dout) at nets[b].p_off_b[l]; raw
// globals at p_off_g. In shared memory the parameters (not the moments)
// use the padded layout: the same order, every W row padded with zeros to a
// multiple of 4 floats and every W starting on a 16-byte boundary. The
// optimizer's slots follow the parameters: m and v, and with moments_shared 2
// amsgrad's u and a pad of the same size (the shared-memory formula counts
// slots in pairs). Where the state would leave no room for 32 residual rows
// the slots stay in device memory (one block only: each element is then one
// thread's alone).
// Shared memory: the parameters, slots, gradient partial and small vectors,
// the unit table, the optimizer struct with the member's numbers, the residual
// tile, the stages and the loss's moments (ehe_smem_floats).
// Residual tile: word (off + k) * tile_rows + r for feature k of row r: the
// normed columns (r_off_xhat) and their cotangents (r_off_d0), then each
// network's input and layers (nets[b].r_off_h, r_off_d), the globals'
// cotangents (r_off_g), the networks' outputs (r_off_out), the bound
// scaling's derivative (r_off_dsc) and a feature of ones (r_off_one).

// This source is built twice. As fused_epoch.cu it takes one network, a
// compile-time count (MULTI false): its code is the kernel's before it took
// branches, which a branch loop of a run-time count slowed by up to 5% a
// one-network step where a loss build kept more values live. As
// fused_epoch_multinn.cu (EHE_MULTI_NETS defined) it takes 0 to EH_MAX_NETS
// networks, its launcher eh_fused_epoch_multinn.
#ifdef EHE_MULTI_NETS
#define EHE_MULTI true
#define EHE_LAUNCHER eh_fused_epoch_multinn
#else
#define EHE_MULTI false
#define EHE_LAUNCHER eh_fused_epoch
#endif
#define EHE_CAT2(a, b) a##b
#define EHE_CAT(a, b) EHE_CAT2(a, b)

// The networks of a launch: the args' count, or one.
template <bool MULTI>
__device__ __forceinline__ int ehe_n_nets(const EhFusedEpochArgs& a) {
  return MULTI ? a.n_nets : 1;
}

// Kernel 2's padded position of packed parameter p: the norm's scales and
// biases keep theirs, a network's layers and the globals move.
template <bool MULTI>
__device__ __forceinline__ int ehe_epoch_padded_index(const EhFusedEpochArgs& a, int p) {
  if (p >= a.p_off_g) return a.pp_off_g + (p - a.p_off_g);
  const int nn = ehe_n_nets<MULTI>(a);
  if (nn == 0 || p < a.nets[0].p_off_w[0]) return p;
  int b = 0;
  while (b + 1 < nn && p >= a.nets[b + 1].p_off_w[0]) ++b;
  return ehe_layer_padded_index(a.nets[b], p);
}

// Kernel 2's gradient units: every network's layers in turn, then the norm
// over all their columns, then the globals.
template <bool MULTI>
__device__ __forceinline__ int ehe_epoch_n_units(const EhFusedEpochArgs& a) {
  int n = 0;
  for (int b = 0; b < ehe_n_nets<MULTI>(a); ++b) n += ehe_layer_units(a.nets[b]);
  const int F = a.n_features;
  if (a.norm_mode != NORM_NONE) n += F + ((F + 3) >> 2);
  return n + ((a.n_globals + 3) >> 2);
}

template <bool MULTI>
__device__ __forceinline__ EheUnit ehe_epoch_unit(const EhFusedEpochArgs& a, int u) {
  EheUnit x;
  x.nk = 1;
  x.pstride = 1;
  x.voff = a.r_off_one;
  for (int b = 0; b < ehe_n_nets<MULTI>(a); ++b)
    if (ehe_layer_unit(a.nets[b], u, x)) return x;
  return ehe_tail_unit(a, u, a.n_features, x);
}

// Whether packed parameter p is a layer weight of one of the networks (not a
// bias, the norm's or a global): the bf16 build rounds its gradient.
template <bool MULTI>
__device__ __forceinline__ bool ehe_epoch_is_weight(const EhFusedEpochArgs& a, int p) {
  for (int b = 0; b < ehe_n_nets<MULTI>(a); ++b)
    for (int l = 0; l < a.nets[b].n_layers; ++l)
      if (p >= a.nets[b].p_off_w[l] && p < a.nets[b].p_off_b[l]) return true;
  return false;
}

// Unit u from the table UT of the first n_unit_table units, or computed.
template <bool MULTI>
__device__ __forceinline__ EheUnit ehe_epoch_unit_at(const EhFusedEpochArgs& a, const int* UT,
                                                    int u) {
  if (u >= a.n_unit_table) return ehe_epoch_unit<MULTI>(a, u);
  const int* ut = UT + 8 * u;
  EheUnit un;
  un.uoff = ut[0], un.nj = ut[1], un.voff = ut[2], un.nk = ut[3];
  un.pbase = ut[4], un.pstride = ut[5];
  return un;
}

// Built with -DEHE_STAMPS, thread 0 of block 0 adds the clock64() cycles it
// spends in each stage of a step to a.stamps when the kernel ends: 0 the wait
// for the step's staged rows, 1 counts and mean, 2 starting the next step's
// copies, 3 variance (0 to 3: gather and statistics), 4 forward to loss,
// 5 backward, 6 gradient sum, 7 update, 8 the whole kernel. Built with
// -DEHE_CHAIN_ONLY, the rows' arithmetic is left out: barriers, exchanges,
// staging and the update remain.
#define EHE_N_STAMPS 9
#ifdef EHE_STAMPS
#define EHE_STAMP(k)                      \
  do {                                    \
    if (tid == 0 && rank == 0) {          \
      const long long now = clock64();    \
      stamp_acc[k] += now - stamp_last;   \
      stamp_last = now;                   \
    }                                     \
  } while (0)
#else
#define EHE_STAMP(k)
#endif

// Threads a block may have: the registers of 512 threads (128 each) hold a
// row of width 32; a row of width 64 takes 256.
#define EHE_MAX_THREADS(W) ((W) == 64 ? 256 : 512)

// The builds by loss, which the launcher picks by a.loss_kind and a.loss_sst:
// mse alone, with the code of the kernel before the other losses came (a
// step's chain is paced by instruction fetch, and even code that a uniform
// branch skips costs it time); the other losses a row takes (mae, nseLoss
// with its target moments, a traced elementwise loss), by the loss layer's
// runtime switch; rmse and the statistic losses, which exchange the batch's
// prediction moments inside a step.
enum { EHE_LOSS_MSE = 0, EHE_LOSS_ROWS, EHE_LOSS_MOMENTS };

template <int W, int LOSSES, bool MULTI>
__global__ void __launch_bounds__(EHE_MAX_THREADS(W))
eh_fused_epoch_kernel(const __grid_constant__ EhFusedEpochArgs a) {
  if (eh_halted(a.halt)) return;
  constexpr bool BF16 = EH_BF16_BUILD;
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.cluster;
  const int rank = (int)cluster.block_rank();  // in the member's cluster
  const int64_t member = blockIdx.y;            // a population's member, 0 for train()
  const int tid = threadIdx.x;
  const int nth = blockDim.x;  // == a.tile_rows
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nth >> 5;
  const int ld = nth;  // row stride of the residual tile and of a stage
  const int F = a.n_features;
  const int P = a.n_neural;
  const int L1 = a.nets[0].n_layers;  // the one network's layers (MULTI false)
  const int G = a.n_globals;
  const int K = a.n_fixed;
  const int T = a.n_targets;
  const int NF = a.n_forcing;
  const int NP = a.n_params;
  const int B = a.batch;
  const int n_consts = 2 * P + 2 * G + K;
  const int NS = T + F;             // counts, then the predictors' sums
  const int cols = F + NF + 2 * T;  // a stage's columns
  const bool staged = a.stages > 0;

  // member k's state: the k-th rows of the state arrays
  float* const params = a.params + member * NP;
  float* const bn = a.bn + member * 2 * F;
  int* const tk = a.t + member;
  const int* const perm = a.perm + member * a.perm_stride;
  float* Pm = sm;                 // parameters, padded layout
  // the weights the rows read: the parameters, or in the bf16 build their
  // copy rounded to bf16 beside them
  float* PW = BF16 ? Pm + a.n_padded : Pm;
  float* PE = Pm + (BF16 ? 2 : 1) * a.n_padded;  // past the parameters
  // the optimizer's slots: beside the parameters, or in device memory where
  // the state would leave no room for 32 rows (each element is one thread's
  // alone)
  float* Mm = a.moments_shared ? PE : a.m + member * NP;
  float* Vm = a.moments_shared ? Mm + NP : a.v + member * NP;
  float* Um = a.moments_shared == 2 ? Vm + NP : (a.u != nullptr ? a.u + member * NP : nullptr);
  float* Gr = PE + 2 * a.moments_shared * NP;  // this block's gradient partial
  float* XL = Gr + NP;            // this block's loss partials, one a warp
  float* XS1 = XL + nw;           // count and mean partials, NS a warp
  float* XS2 = XS1 + nw * NS;     // variance partials, F a warp
  float* BN = XS2 + nw * F;       // running mean, var
  float* Cc = BN + 2 * F;         // constants
  float* SC = Cc + n_consts;      // scaled globals, then fixed values
  float* DG = SC + G + K;         // d scaled global / d raw
  float* BM = DG + G;             // batch (or running) mean
  float* BR = BM + F;             // rsqrt(var + eps)
  float* NT = BR + F;             // max(sum(mask), 1) per target
  float* MISC = NT + T;           // [0..1] batch valid, [2..7] the rule's step numbers: two steps'
  int* UT = reinterpret_cast<int*>(MISC + 8);  // the first units, 8 ints each
  float* OS = MISC + 8 + 8 * a.n_unit_table;   // the optimizer struct, the member's numbers in it
  float* RES = OS + EHE_OPT_WORDS;             // residual tile
  float* ST = RES + a.res_floats * ld;  // the stages
  // the loss's batch moments (ehe_loss_floats; none for mse, mae and a traced loss)
  float* YM = ST + a.stages * cols * ld;  // the targets' batch mean
  float* LC = YM + T;             // each target's coefficients of the step, 8 a target
  float* XY = LC + 8 * T;         // the next step's target sums, T a warp
  float* XQ = XY + nw * T;        // the next step's centred target squares, T a warp
  float* XM1 = XQ + nw * T;       // the predictions' sums (rmse: squared differences), T a warp
  float* XM2 = XM1 + nw * T;      // their centred squares and products with the targets', 2 T a warp
  const int LK = a.loss_kind;
  // the weight-L2 penalty's sums of squares, a warp's partial each, two steps' rows
  // (after the loss's moments, which only the losses that take them have)
  const bool l2 = LOSSES != EHE_LOSS_MSE && a.l2_leaves != 0;
  float* XL2 = YM + ((a.loss_sst || LK == LOSS_RMSE || ehe_loss_is_stat(LK)) ? 9 * T + 5 * nw * T : 0);
  // rmse and the statistic losses need the batch's predictions before any
  // row's cotangent: with the block's rows in flight at once (one tile) the
  // moments are exchanged between a row's forward and its cotangent, each row
  // keeping its residuals; a block that walks tiles takes them first, in
  // passes of their own whose residuals the tiles' pass overwrites
  constexpr bool MOMENTS = LOSSES == EHE_LOSS_MOMENTS;
  // nseLoss and the statistic losses: the targets' batch mean and SST
  const bool loss_sst = LOSSES != EHE_LOSS_MSE && a.loss_sst;
  const bool inline_moments = MOMENTS && a.block_rows <= nth;

  for (int i = tid; i < a.n_padded; i += nth) {
    Pm[i] = 0.0f;
    if constexpr (BF16) PW[i] = 0.0f;
  }
  {
    // the rule and its numbers: the shared struct's, a member's numbers in place
    const int* src = reinterpret_cast<const int*>(&a.optimizer);
    const float* row = a.member_opt != nullptr ? a.member_opt + member * EHE_OPT_SCALARS : nullptr;
    int* dst = reinterpret_cast<int*>(OS);
    for (int i = tid; i < EHE_OPT_WORDS; i += nth) {
      const bool swept = row != nullptr && i >= EHE_OPT_FIRST && i < EHE_OPT_FIRST + EHE_OPT_SCALARS;
      dst[i] = swept ? __float_as_int(row[i - EHE_OPT_FIRST]) : src[i];
    }
  }
  __syncthreads();
  const EhOptimizer& o = *reinterpret_cast<const EhOptimizer*>(OS);
  for (int i = tid; i < NP; i += nth) {
    Pm[ehe_epoch_padded_index<MULTI>(a, i)] = params[i];
    if constexpr (BF16) PW[ehe_epoch_padded_index<MULTI>(a, i)] = ehe_bf16(params[i]);
    if (a.moments_shared) {
      Mm[i] = a.m[member * NP + i];
      Vm[i] = a.v[member * NP + i];
    }
    if (a.moments_shared == 2) Um[i] = a.u[member * NP + i];
  }
  for (int i = tid; i < 2 * F; i += nth) BN[i] = a.norm_mode != NORM_NONE ? bn[i] : 0.0f;
  for (int i = tid; i < n_consts; i += nth) Cc[i] = a.consts[i];
  for (int i = tid; i < K; i += nth) SC[G + i] = a.consts[2 * P + 2 * G + i];
  RES[a.r_off_one * ld + tid] = 1.0f;
  for (int u = tid; u < a.n_unit_table; u += nth) {
    const EheUnit un = ehe_epoch_unit<MULTI>(a, u);
    int* ut = UT + 8 * u;
    ut[0] = un.uoff, ut[1] = un.nj, ut[2] = un.voff, ut[3] = un.nk;
    ut[4] = un.pbase, ut[5] = un.pstride;
  }
  __syncthreads();
  if (tid == nth - 1)  // the first step's numbers
    ehe_opt_step_store(ehe_opt_step(o, (float)tk[0] + 1.0f), MISC + 2);
  if (a.norm_mode == NORM_STATIC) {
    for (int k = tid; k < F; k += nth) {
      BM[k] = BN[k];
      BR[k] = rsqrtf(BN[F + k] + a.norm_eps);
    }
  }

  const float* nlo = Cc;
  const float* nspan = Cc + P;
  const float* glo = Cc + 2 * P;
  const float* gspan = Cc + 2 * P + G;
  const int row0 = rank * a.block_rows;  // this block's rows of a batch
  const int mine = max(0, min(a.block_rows, B - row0));
  const int n_units = ehe_epoch_n_units<MULTI>(a);
  const int pp_first = tid < NP ? ehe_epoch_padded_index<MULTI>(a, tid) : 0;  // of the thread's first parameter
  // the weight-L2 penalty: whether packed parameter p (the thread's first: a
  // register) is penalised; the thread's parameters' squares into its warp's
  // partial of a step's sum, in row `row` of XL2; the first step's now
  const bool pen_first = l2 && tid < NP && ((a.l2_leaves >> ehe_leaf_of(o, tid)) & 1ll);
  auto penalised = [&](int p) {
    return p == tid ? pen_first : ((a.l2_leaves >> ehe_leaf_of(o, p)) & 1ll) != 0;
  };
  auto l2_partial = [&](int row) {
    float sq = 0.0f;
    for (int p = tid; p < NP; p += nth) {
      if (!penalised(p)) continue;
      const float w = Pm[p == tid ? pp_first : ehe_epoch_padded_index<MULTI>(a, p)];
      sq += w * w;
    }
    sq = ehe_warp_sum(sq);
    if (lane == 0) XL2[row * nw + warp] = sq;
  };
  if (l2) l2_partial(0);
  const int n_steps = a.n_epochs * a.n_batches;
  float t = (float)tk[0];    // every thread carries the same step count
  float last_loss = 0.0f;    // warp 0 only
  float epoch_loss = 0.0f;   // warp 0 only
#ifdef EHE_STAMPS
  long long stamp_acc[EHE_N_STAMPS] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  const long long stamp_first = clock64();
  long long stamp_last = stamp_first;
#endif

  // Start the copies of step `step`'s row `row` into its stage.
  auto stage_row = [&](int step, int64_t row) {
    float* dst = ST + (step & 1) * cols * ld + tid;
    for (int k = 0; k < F; ++k) ehe_cp_async4(dst + k * ld, a.x + row * F + k);
    for (int f = 0; f < NF; ++f) ehe_cp_async4(dst + (F + f) * ld, a.forcing[f] + row);
    for (int j = 0; j < T; ++j) {
      ehe_cp_async4(dst + (F + NF + j) * ld, a.y[j] + row);
      ehe_cp_async4(dst + (F + NF + T + j) * ld, a.mask[j] + row);
    }
  };
  auto step_index = [&](int step) {
    const int e = step / a.n_batches;
    return perm + (int64_t)e * a.n_rows + (int64_t)(step - e * a.n_batches) * B + row0;
  };
  // The sum over every block's and warp's partial i of `width`, taken by a
  // whole warp: lane e adds entries e, e + 32, ... of the blocks' partials in
  // rank and warp order, then a shuffle tree; the same bits in every lane of
  // every block.
  auto exchanged = [&](float* part, int width, int i) {
    float s = 0.0f;
    for (int e = lane; e < C * nw; e += 32) {
      const int rk = e / nw;
      const float* p = C > 1 ? cluster.map_shared_rank(part, rk) : part;
      s += p[(e - rk * nw) * width + i];
    }
    return ehe_warp_sum(s);
  };
  auto exchange_barrier = [&]() {
    if (C > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  };

  // A row's target j and its mask, from the stage or in place.
  auto target_of = [&](const float* st, const int* idx, int r, int j, float& yv, float& mk) {
    if (staged) {
      yv = st[(F + NF + j) * ld + r];
      mk = st[(F + NF + T + j) * ld + r];
    } else {
      const int64_t row = idx[r];
      yv = a.y[j][row];
      mk = a.mask[j][row];
    }
  };
  // A step's mask counts and, for the trainable norm, its predictors' sums
  // (for nseLoss and the statistic losses its targets' sums too): every
  // warp's partials. They depend on the rows alone, not on the parameters, so
  // step s + 1's are taken at the end of step s, off the chain.
  auto stat_partials = [&](int step) {
    const int* idx = step_index(step);
    const float* st = ST + (step & 1) * cols * ld;
    const int n = a.norm_mode == NORM_TRAIN ? NS : T;
    for (int i = 0; i < n; ++i) {  // target i's mask, then predictor i - T
      float v = 0.0f;
      for (int r = tid; r < mine; r += nth) {
        if (staged) {
          v += st[(i < T ? F + NF + T + i : i - T) * ld + r];
        } else {
          const int64_t row = idx[r];
          v += i < T ? a.mask[i][row] : a.x[row * F + (i - T)];
        }
      }
      v = ehe_warp_sum(v);
      if (lane == 0) XS1[warp * NS + i] = v;
    }
    if (loss_sst) {  // the targets' sums (0 where masked), for their batch mean
      for (int j = 0; j < T; ++j) {
        float v = 0.0f;
        for (int r = tid; r < mine; r += nth) {
          float yv, mk;
          target_of(st, idx, r, j, yv, mk);
          v += yv;
        }
        v = ehe_warp_sum(v);
        if (lane == 0) XY[warp * T + j] = v;
      }
    }
  };
  // Target j's batch mean from the partials, the same bits in every warp.
  auto target_mean = [&](int j) {
    return exchanged(XY, T, j) / fmaxf(exchanged(XS1, NS, j), 1.0f);
  };
  // After stat_sums(step): every warp's partials of the targets' centred
  // squares sum(((y - mean) m)^2), for nseLoss's SST and the statistic
  // losses' Syy, which the step reads after the exchange barrier ending this
  // one.
  auto sst_partials = [&](int step) {
    const int* idx = step_index(step);
    const float* st = ST + (step & 1) * cols * ld;
    for (int j = 0; j < T; ++j) {
      const float mean = target_mean(j);
      float v = 0.0f;
      for (int r = tid; r < mine; r += nth) {
        float yv, mk;
        target_of(st, idx, r, j, yv, mk);
        const float dv = (yv - mean) * mk;
        v += dv * dv;
      }
      v = ehe_warp_sum(v);
      if (lane == 0) XQ[warp * T + j] = v;
    }
  };
  // After an exchange barrier: step `step`'s counts, batch mean and validity
  // (MISC[step & 1]) from the partials, a warp per sum.
  auto stat_sums = [&](int step) {
    for (int i = warp; i < NS; i += nw) {
      if (i < T) {
        const float v = exchanged(XS1, NS, i);
        if (lane == 0) NT[i] = fmaxf(v, 1.0f);
      } else if (a.norm_mode == NORM_TRAIN) {
        const float v = exchanged(XS1, NS, i);
        if (lane == 0) BM[i - T] = v / (float)B;
      }
    }
    if (warp == nw - 1) {  // validity: any target counted
      float total = 0.0f;
      for (int j = 0; j < T; ++j) total += exchanged(XS1, NS, j);
      if (lane == 0) MISC[step & 1] = total > 0.0f ? 1.0f : 0.0f;
    }
    if (loss_sst) {
      for (int j = warp; j < T; j += nw) {
        const float mean = target_mean(j);
        if (lane == 0) YM[j] = mean;
      }
    }
  };
  // rmse and the statistic losses, from each thread's sums over its rows
  // (acc[j]: target j's (pred - y)^2 m for rmse, pred m for the others): the
  // first exchange; rmse's coefficients into LC, or every warp's mu_h.
  auto moments_first = [&](const float (&acc)[EH_MAX_TARGETS], float (&mu_h)[EH_MAX_TARGETS]) {
    for (int j = 0; j < T; ++j) {
      const float v = ehe_warp_sum(ehe_pick<EH_MAX_TARGETS>(acc, j));
      if (lane == 0) XM1[warp * T + j] = v;
    }
    exchange_barrier();
    if (LK == LOSS_RMSE) {
      for (int j = warp; j < T; j += nw) {
        const float sse = exchanged(XM1, T, j);
        if (lane == 0) {
          const float n = NT[j];
          const float r = sqrtf(sse / n);
          LC[8 * j] = a.agg_scale;
          LC[8 * j + 1] = a.agg_scale / (n * ehe_max_nan(r, 1e-30f));
          LC[8 * j + 7] = a.agg_scale * r;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < EH_MAX_TARGETS; ++j)
        mu_h[j] = j < T ? exchanged(XM1, T, j) / NT[j] : 0.0f;
    }
  };
  // The statistic losses' second exchange, of each thread's sums acc2[2 j]
  // of dh^2 and acc2[2 j + 1] of dh dy, then g and its partials a target,
  // into LC.
  auto moments_second = [&](const float (&acc2)[2 * EH_MAX_TARGETS],
                            const float (&mu_h)[EH_MAX_TARGETS]) {
    for (int q = 0; q < 2 * T; ++q) {
      const float v = ehe_warp_sum(ehe_pick<2 * EH_MAX_TARGETS>(acc2, q));
      if (lane == 0) XM2[warp * 2 * T + q] = v;
    }
    exchange_barrier();
    for (int j = warp; j < T; j += nw) {
      const float shh = exchanged(XM2, 2 * T, 2 * j);
      const float c = exchanged(XM2, 2 * T, 2 * j + 1);
      const float mh = ehe_pick<EH_MAX_TARGETS>(mu_h, j);
      float d[3];
      const float g = ehe_stat_loss(LK, mh, shh, c, LC[8 * j + 2], YM[j], NT[j], d);
      if (lane == 0) {
        LC[8 * j] = a.agg_scale;
        LC[8 * j + 1] = 0.0f;
        LC[8 * j + 3] = mh;
        LC[8 * j + 4] = d[0];
        LC[8 * j + 5] = 2.0f * d[1];
        LC[8 * j + 6] = d[2];
        LC[8 * j + 7] = a.agg_scale * g;
      }
    }
  };
  // Target j's coefficients for this step's rows (ehe_loss_row).
  auto row_coef = [&](int j) {
    EhLossCoef c;
    const float n = NT[j];
    c.c0 = a.loss_sum ? a.agg_scale : a.agg_scale / n;
    c.c1 = (2.0f * a.agg_scale) / n;
    c.n = n;
    c.mu_h = c.mu_y = c.k_mu = c.k_h = c.k_c = 0.0f;
    if (loss_sst || MOMENTS) {  // the step's, in LC
      const float* lc = LC + 8 * j;
      c.c0 = lc[0];
      c.c1 = lc[1];
      c.mu_h = lc[3];
      c.mu_y = YM[j];
      c.k_mu = lc[4];
      c.k_h = lc[5];
      c.k_c = lc[6];
    }
    return c;
  };

  if (staged && tid < mine) {
    stage_row(0, step_index(0)[tid]);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  stat_partials(0);
  exchange_barrier();
  stat_sums(0);
  if (loss_sst) sst_partials(0);
  exchange_barrier();

  for (int s = 0; s < n_steps; ++s) {
    const int* idx = step_index(s);
    const float* st = ST + (s & 1) * cols * ld;  // this step's staged rows, landed
    const float valid = MISC[s & 1];
    int64_t next_row = -1;
    if (staged && s + 1 < n_steps && tid < mine) next_row = step_index(s + 1)[tid];
    if (tid < G) {
      const float sg = ehe_sigmoid_nb(Pm[a.pp_off_g + tid]);
      SC[tid] = glo[tid] + gspan[tid] * sg;
      DG[tid] = gspan[tid] * (sg * (1.0f - sg));
    }
    if (a.norm_mode == NORM_TRAIN) {
      // second pass: the biased variance around the batch mean
      for (int k = 0; k < F; ++k) {
        const float mean = BM[k];
        float v = 0.0f;
        for (int r = tid; r < mine; r += nth) {
          const float dv = (staged ? st[k * ld + r] : a.x[(int64_t)idx[r] * F + k]) - mean;
          v += dv * dv;
        }
        v = ehe_warp_sum(v);
        if (lane == 0) XS2[warp * F + k] = v;
      }
      exchange_barrier();
      for (int k = warp; k < F; k += nw) {
        const float v = exchanged(XS2, F, k) / (float)B;
        if (lane == 0) {
          BR[k] = rsqrtf(v + a.norm_eps);
          if (valid > 0.0f) {  // the running statistics' EMA, gated like the update
            BN[k] = a.one_minus_momentum * BN[k] + a.momentum * BM[k];
            BN[F + k] = a.one_minus_momentum * BN[F + k] + a.momentum * v;
          }
        }
      }
    }
    if (loss_sst) {
      // the step's target SST (the partials were taken at the end of the
      // step before, and an exchange barrier has passed since): nseLoss's scale
      for (int j = warp; j < T; j += nw) {
        const float sst = exchanged(XQ, T, j);
        if (lane == 0) {
          LC[8 * j + 2] = sst;
          LC[8 * j] = a.agg_scale / ehe_max_nan(sst, 1e-12f);
          LC[8 * j + 1] = 2.0f * LC[8 * j];
        }
      }
    }
    __syncthreads();
    EHE_STAMP(3);
    // the next step's copies go out here, off the chain of barriers and sums
    // above: scattered 4-byte copies keep the load-store unit busy for ~1.3
    // cycles each, which the rows' arithmetic hides
    if (next_row >= 0) {
      stage_row(s + 1, next_row);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    EHE_STAMP(2);

    // Row r's forward to the kernel form's arguments: each network on its
    // own columns, through the input norm (its residuals in the row's column
    // of the tile, its outputs in its neural slots), the bound scaling (the
    // scaled outputs in place, their derivative beside them); the arguments
    // in av.
    auto row_arguments = [&](int r, float (&av)[EH_MAX_ARGS]) {
      const int64_t row = staged ? 0 : idx[r];
      float* res = RES + tid;
      for (int b = 0; b < ehe_n_nets<MULTI>(a); ++b) {
        const EhNet& net = a.nets[b];
        const int fb = net.dims[0];
        const int c = MULTI ? net.col : 0;  // one network: its columns from 0, folded
        float h[1][W];
#pragma unroll
        for (int k = 0; k < W; ++k) {
          float x = 0.0f;
          if (k < fb) {
            x = staged ? st[(c + k) * ld + r] : a.x[row * F + c + k];
            if (a.norm_mode != NORM_NONE) {
              const float xh = (x - BM[c + k]) * BR[c + k];
              res[(a.r_off_xhat + c + k) * ld] = xh;
              x = xh * Pm[c + k] + Pm[F + c + k];
            }
            if constexpr (BF16) x = ehe_bf16(x);  // the first layer's cast input
            res[(net.r_off_h[0] + k) * ld] = x;
          }
          h[0][k] = x;
        }
        ehe_row_forward<W, 1, true, BF16>(net, Pm, h, res, ld, 0, PW);
      }

      // From here on the row's small vectors (the network's P outputs, the
      // G globals' cotangents) live in the row's column of the tile and are
      // walked by loops of their own length: code unrolled to the kernel's
      // width for them costs more in instruction fetch than it saves.
      // Bound scaling of the neural outputs: the scaled value in place, its
      // derivative beside it.
      float* outv = res + a.r_off_out * ld;
      float* dscv = res + a.r_off_dsc * ld;
      for (int j = 0; j < P; ++j) {
        float y = outv[j * ld];
        float ds = 1.0f;
        if (a.scale_nn_outputs) {
          const float sg = ehe_sigmoid_nb(y);
          ds = nspan[j] * (sg * (1.0f - sg));
          y = nlo[j] + nspan[j] * sg;
        }
        outv[j * ld] = y;
        dscv[j * ld] = ds;
      }

#pragma unroll
      for (int i = 0; i < EH_MAX_ARGS; ++i) {
        float val = 0.0f;
        if (i < a.n_args) {
          const int id = a.arg_idx[i];
          switch (a.arg_src[i]) {
            case SRC_FORCING: val = staged ? st[(F + id) * ld + r] : a.forcing[id][row]; break;
            case SRC_NEURAL: val = outv[id * ld]; break;
            case SRC_SCALAR: val = SC[id]; break;
            default: val = a.arg_const[i]; break;
          }
        }
        av[i] = val;
      }
    };

    // ---- rmse, the statistic losses: the batch's moments, where tiles are walked
    if constexpr (MOMENTS) if (!inline_moments) {
      // a pass over the tiles for the predictions' sums and, for the statistic
      // losses, another for their centred moments, each row's forward again
      // (the tiles' pass below overwrites its residuals)
      float acc[EH_MAX_TARGETS] = {0.0f, 0.0f, 0.0f, 0.0f};
      float acc2[2 * EH_MAX_TARGETS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float mu_h[EH_MAX_TARGETS];
      for (int pass = 0; pass < (LK == LOSS_RMSE ? 1 : 2); ++pass) {
        for (int t0 = 0; t0 < mine; t0 += nth) {
          const int r = t0 + tid;
          if (r < mine) {
            float av[EH_MAX_ARGS];
            row_arguments(r, av);
            float out[EH_MAX_OUT];
            float pd[EH_MAX_OUT][EH_MAX_ARGS];
            ehe_form(a.form, av, out, pd);
#pragma unroll
            for (int j = 0; j < EH_MAX_TARGETS; ++j) {
              if (j < T) {
                float yv, mk;
                target_of(st, idx, r, j, yv, mk);
                const float pred = ehe_pick<EH_MAX_OUT>(out, a.target_out[j]);
                if (LK == LOSS_RMSE) {
                  const float diff = (pred - yv) * mk;
                  acc[j] += diff * diff;
                } else if (pass == 0) {
                  acc[j] += pred * mk;
                } else {
                  const float dh = (pred * mk - mu_h[j]) * mk;
                  const float dy = (yv - YM[j]) * mk;
                  acc2[2 * j] += dh * dh;
                  acc2[2 * j + 1] += dh * dy;
                }
              }
            }
          }
        }
        if (pass == 0) {
          moments_first(acc, mu_h);
        } else {
          moments_second(acc2, mu_h);
        }
      }
      __syncthreads();  // the coefficients in LC
    }

    // ---- tiles: forward, loss, backward per row; gradient sums ---------------
    float loss_part = 0.0f;
    if (mine == 0 && !inline_moments)
      for (int p = tid; p < NP; p += nth) Gr[p] = 0.0f;
    // with the moments exchanged inside it, one tile in every block, rows or not
    const int tile_end = inline_moments ? 1 : mine;
    for (int t0 = 0; t0 < tile_end; t0 += nth) {
      const int r = t0 + tid;
      const int rows_here = max(0, min(nth, mine - t0));
      float out[EH_MAX_OUT];
      float pd[EH_MAX_OUT][EH_MAX_ARGS];
      // Row r's loss a target and its cotangent (the loss layer of
      // eh_device.cuh; mse's own code in its build), the cotangents through the
      // form's partials, and the row's backward; returns the row's term.
      auto row_backward = [&](int r, const float (&out)[EH_MAX_OUT],
                              const float (&pd)[EH_MAX_OUT][EH_MAX_ARGS]) {
        float* res = RES + tid;
        float* outv = res + a.r_off_out * ld;
        float* dscv = res + a.r_off_dsc * ld;

        float cot[EH_MAX_TARGETS];
        float term = 0.0f;
#pragma unroll
        for (int j = 0; j < EH_MAX_TARGETS; ++j) {
          cot[j] = 0.0f;
          if (j < T) {
            float yv, mk;
            target_of(st, idx, r, j, yv, mk);
            const float pred = ehe_pick<EH_MAX_OUT>(out, a.target_out[j]);
            const float diff = (pred - yv) * mk;
            if constexpr (LOSSES == EHE_LOSS_MSE) {
              const float scale = a.agg_scale / NT[j];
              term += scale * diff * diff;
              cot[j] = (2.0f * a.agg_scale / NT[j]) * diff;
            } else {
              term += ehe_loss_row<MOMENTS>(LK, row_coef(j), pred, yv, mk, diff, cot[j]);
            }
          }
        }
        EHE_STAMP(4);

        // cotangents of the neural outputs (gathered where the outputs were)
        // and of the scaled globals
        for (int j = 0; j < P; ++j) outv[j * ld] = 0.0f;
        for (int j = 0; j < G; ++j) res[(a.r_off_g + j) * ld] = 0.0f;
#pragma unroll
        for (int i = 0; i < EH_MAX_ARGS; ++i) {
          if (i < a.n_args) {
            const int src = a.arg_src[i];
            const int id = a.arg_idx[i];
            if (src == SRC_NEURAL || (src == SRC_SCALAR && id < G)) {
              float c = 0.0f;
#pragma unroll
              for (int j = 0; j < EH_MAX_TARGETS; ++j) {
                if (j < T) {
                  float part = 0.0f;
#pragma unroll
                  for (int o = 0; o < EH_MAX_OUT; ++o)
                    part = (o == a.target_out[j]) ? pd[o][i] : part;
                  c += cot[j] * part;
                }
              }
              float* slot = src == SRC_NEURAL ? outv + id * ld : res + (a.r_off_g + id) * ld;
              *slot += c;
            }
          }
        }
        // each network's last pre-activation cotangent from its slots, then
        // backward through the network
        for (int b = 0; b < ehe_n_nets<MULTI>(a); ++b) {
          const EhNet& net = a.nets[b];
          // one network: the kernel-wide layer count and outputs (registers)
          const int nl = MULTI ? net.n_layers : L1;
          const int o = MULTI ? net.out : 0;
          float* zd = res + net.r_off_d[nl - 1] * ld;
          const float* ov = outv + o * ld;
          const float* dv = dscv + o * ld;
          for (int j = 0; j < (MULTI ? net.dims[nl] : P); ++j)
            zd[j * ld] = (ov[j * ld] * dv[j * ld]) * zd[j * ld];
          ehe_row_backward<W, BF16>(net, Pm, res, ld, PW);
        }
        EHE_STAMP(5);
        return term;
      };
#ifndef EHE_CHAIN_ONLY
      if (r < mine) {
        float av[EH_MAX_ARGS];
        row_arguments(r, av);
        ehe_form(a.form, av, out, pd);
        if constexpr (!MOMENTS) loss_part += row_backward(r, out, pd);
      }
#endif
      if constexpr (MOMENTS) {
        if (inline_moments) {
          // the block's rows are all in flight: the moments from the rows'
          // predictions here, each row keeping its residuals across the exchanges
          float acc[EH_MAX_TARGETS], acc2[2 * EH_MAX_TARGETS], mu_h[EH_MAX_TARGETS];
#pragma unroll
          for (int j = 0; j < EH_MAX_TARGETS; ++j) {
            acc[j] = 0.0f;
            if (j < T && r < mine) {
              float yv, mk;
              target_of(st, idx, r, j, yv, mk);
              const float pred = ehe_pick<EH_MAX_OUT>(out, a.target_out[j]);
              const float diff = (pred - yv) * mk;
              acc[j] = LK == LOSS_RMSE ? diff * diff : pred * mk;
            }
          }
          moments_first(acc, mu_h);
          if (LK != LOSS_RMSE) {
#pragma unroll
            for (int j = 0; j < EH_MAX_TARGETS; ++j) {
              acc2[2 * j] = acc2[2 * j + 1] = 0.0f;
              if (j < T && r < mine) {
                float yv, mk;
                target_of(st, idx, r, j, yv, mk);
                const float pred = ehe_pick<EH_MAX_OUT>(out, a.target_out[j]);
                const float dh = (pred * mk - mu_h[j]) * mk;
                const float dy = (yv - YM[j]) * mk;
                acc2[2 * j] = dh * dh;
                acc2[2 * j + 1] = dh * dy;
              }
            }
            moments_second(acc2, mu_h);
          }
          __syncthreads();  // the coefficients in LC
        }
#ifndef EHE_CHAIN_ONLY
        if (r < mine) loss_part += row_backward(r, out, pd);
#endif
      }
      __syncthreads();

      // a warp per unit of 4 x 4 parameters; its lanes split the tile's rows
      for (int u = warp; u < n_units; u += nw) {
        const EheUnit un = ehe_epoch_unit_at<MULTI>(a, UT, u);
#ifndef EHE_CHAIN_ONLY
        const float total = ehe_unit_sum(un, RES, ld, rows_here, lane);
#else
        const float total = ehe_unit_sum<false>(un, RES, ld, rows_here, lane);
#endif
        const int p = ehe_unit_param(un, lane);
        if (p >= 0) Gr[p] = t0 == 0 ? total : Gr[p] + total;
      }
      if (t0 + nth < mine) __syncthreads();  // the next tile overwrites the residuals
      EHE_STAMP(6);
    }

    // ---- the next step's counts and mean; batch loss, validity gate, update ----
    if (s + 1 < n_steps) {
      if (staged) asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // its rows have landed
      EHE_STAMP(0);
      stat_partials(s + 1);
      EHE_STAMP(1);
    }
    if (tid == nth - 1) {
      // the rule's numbers for the next step if its batch is valid (they are
      // not read if it is not), off that step's chain and in the warp that
      // has the fewest units: the step count after this step, plus one, is
      // never below the clamp at 1
      ehe_opt_step_store(ehe_opt_step(o, t + valid + 1.0f), MISC + 2 + 3 * ((s + 1) & 1));
    }
    {
      const float v = ehe_warp_sum(loss_part);
      if (lane == 0) XL[warp] = v;
    }
    exchange_barrier();
    if (s + 1 < n_steps) stat_sums(s + 1);
    if (loss_sst && s + 1 < n_steps) sst_partials(s + 1);
    if (warp == 0 && valid > 0.0f) {
      float bl = exchanged(XL, 1, 0);
      if constexpr (MOMENTS) {  // rmse's and the statistic losses' value: a term a target
        bl = LC[7];
        for (int j = 1; j < T; ++j) bl = bl + LC[8 * j + 7];
      }
      if (l2) {  // the sum of squares before this step's update: the warps' partials in order
        float sq = 0.0f;
        for (int w = 0; w < nw; ++w) sq += XL2[(s & 1) * nw + w];
        bl = bl + a.l2_outer * (a.l2_value * sq);
      }
      epoch_loss += bl;
    }
    if (valid > 0.0f) {
      const EhOptStep st = ehe_opt_step_at(MISC + 2 + 3 * (s & 1));
      // parameter p's gradient: the blocks' partials in rank order, and the
      // penalty's term at its value pv before the update
      auto grad = [&](int p, float pv) {
        float g = 0.0f;
        for (int rk = 0; rk < C; ++rk) g += (C > 1 ? cluster.map_shared_rank(Gr, rk) : Gr)[p];
        if (p >= a.p_off_g) g = g * DG[p - a.p_off_g];
        if constexpr (BF16) g = ehe_epoch_is_weight<MULTI>(a, p) ? ehe_bf16(g) : g;
        if (l2 && penalised(p)) g = g + a.l2_coeff * pv;
        return g;
      };
      // lamb: each leaf's trust ratio, a warp a leaf, into the residual tile
      // (free until the next step's rows)
      float* TR = RES;
      if (o.rule == OPT_LAMB) {
        for (int l = warp; l < o.n_leaves; l += nw) {
          float ps = 0.0f, ds = 0.0f;
          for (int p = (int)ehe_leaf_start(o, l) + lane; p < o.leaf_end[l]; p += 32) {
            const float pv = Pm[ehe_epoch_padded_index<MULTI>(a, p)];
            float mm = Mm[p], vv = Vm[p], w = 0.0f;
            const float d = ehe_direction(o, st, pv, grad(p, pv), mm, vv, w);
            ps += pv * pv;
            ds += d * d;
          }
          ps = ehe_warp_sum(ps);
          ds = ehe_warp_sum(ds);
          if (lane == 0) TR[l] = ehe_trust_ratio(ps, ds);
        }
        __syncthreads();
      }
      for (int p = tid; p < NP; p += nth) {
        const int pp = p == tid ? pp_first : ehe_epoch_padded_index<MULTI>(a, p);
        ehe_update(o, st, &Pm[pp], &Mm[p], &Vm[p], &Um[p], grad(p, Pm[pp]),
                   o.rule == OPT_LAMB ? TR[ehe_leaf_of(o, p)] : 1.0f);
        if constexpr (BF16) PW[pp] = ehe_bf16(Pm[pp]);
      }
    }
    if (l2) l2_partial((s + 1) & 1);  // the next step's sum, before its update
    t += valid;
    // A cluster's blocks must all have read this step's partials before any
    // writes the next step's. With a trainable norm the next step's variance
    // barrier sees to that (the partials it guards are written after it), and
    // the block's own barrier is enough here.
    if (a.norm_mode == NORM_TRAIN) {
      __syncthreads();
    } else {
      exchange_barrier();
    }
    EHE_STAMP(7);
    if (s % a.n_batches == a.n_batches - 1) {
      last_loss = epoch_loss / (float)a.n_batches;
      epoch_loss = 0.0f;
    }
  }

  if (rank == 0) {
    for (int i = tid; i < NP; i += nth) {
      params[i] = Pm[ehe_epoch_padded_index<MULTI>(a, i)];
      if (a.moments_shared) {
        a.m[member * NP + i] = Mm[i];
        a.v[member * NP + i] = Vm[i];
      }
      if (a.moments_shared == 2) a.u[member * NP + i] = Um[i];
    }
    if (a.norm_mode != NORM_NONE)
      for (int i = tid; i < 2 * F; i += nth) bn[i] = BN[i];
    if (tid == 0) {
      tk[0] = (int)lrintf(t);
      a.loss[member] = last_loss;
#ifdef EHE_STAMPS
      if (a.stamps != nullptr && member == 0) {
        stamp_acc[EHE_N_STAMPS - 1] = clock64() - stamp_first;
        for (int k = 0; k < EHE_N_STAMPS; ++k) a.stamps[k] = stamp_acc[k];
      }
#endif
    }
  }
  if (C > 1) cluster.sync();  // no block leaves while another may read its partials
}

extern "C" int EHE_CAT(EHE_LAUNCHER, _args_size)(void) {
  return (int)sizeof(EhFusedEpochArgs);
}

// Shared-memory floats of the loss's batch moments; ops/fused_epoch.py::_loss_floats
// computes the same.
static int ehe_loss_floats(const EhFusedEpochArgs* a, int NW, int T) {
  const int k = a->loss_kind;
  return (a->loss_sst || k == LOSS_RMSE || ehe_loss_is_stat(k)) ? 9 * T + 5 * NW * T : 0;
}

// Shared-memory floats of one launch (56: EHE_OPT_WORDS), with the weight-L2
// penalty's two rows of warp partials; ops/fused_epoch.py::_smem_floats
// computes the same.
static_assert(EHE_OPT_WORDS == 56, "ehe_smem_floats counts the optimizer struct as 56 floats");
static size_t ehe_smem_floats(const EhFusedEpochArgs* a) {
  const int F = a->n_features;
  const int P = a->n_neural;
  const int G = a->n_globals, K = a->n_fixed, T = a->n_targets;
  const int NW = a->tile_rows / 32;
  const int COLS = F + a->n_forcing + 2 * T;
  return (size_t)a->n_padded + (1 + 2 * a->moments_shared) * a->n_params + NW * (1 + T + 2 * F) + 2 * F +
         (2 * P + 2 * G + K) + 2 * G + K + 2 * F + T + 8 + 8 * a->n_unit_table + 56 +
         (size_t)a->tile_rows * (a->res_floats + a->stages * COLS) + ehe_loss_floats(a, NW, T) +
         2 * NW * (a->l2_leaves != 0);
}

template <int W, int LOSSES>
static int ehe_launch_build(const EhFusedEpochArgs* args, size_t smem, cudaStream_t s) {
  // allow the full 227 KB once per build: setting the attribute at every
  // launch would cost a host call that may wait for the device
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(eh_fused_epoch_kernel<W, LOSSES, EHE_MULTI>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 EH_MAX_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  return (int)eh_launch_cluster(eh_fused_epoch_kernel<W, LOSSES, EHE_MULTI>, *args, args->cluster,
                                args->tile_rows, smem, s, args->n_members);
}

template <int W>
static int ehe_launch(const EhFusedEpochArgs* args, size_t smem, cudaStream_t s) {
  if (args->tile_rows > EHE_MAX_THREADS(W)) return (int)cudaErrorInvalidValue;
  const int k = args->loss_kind;
  if (k == LOSS_RMSE || ehe_loss_is_stat(k)) return ehe_launch_build<W, EHE_LOSS_MOMENTS>(args, smem, s);
  if (k == LOSS_SQUARED && !args->loss_sst && !args->l2_leaves)
    return ehe_launch_build<W, EHE_LOSS_MSE>(args, smem, s);
  return ehe_launch_build<W, EHE_LOSS_ROWS>(args, smem, s);
}

template <int W>
static int ehe_launch_built(const EhFusedEpochArgs* args, size_t smem, cudaStream_t s) {
  if constexpr (EH_HAS_WIDTH(W)) return ehe_launch<W>(args, smem, s);
  else return (int)cudaErrorInvalidValue;
}

// Whether the networks are ones this build takes: one, or up to EH_MAX_NETS
// (EHE_MULTI_NETS), each of 1 to EH_MAX_LAYERS layers.
static bool ehe_nets_valid(const EhFusedEpochArgs* a) {
  if (EHE_MULTI ? a->n_nets < 0 || a->n_nets > EH_MAX_NETS : a->n_nets != 1) return false;
  for (int b = 0; b < a->n_nets; ++b)
    if (a->nets[b].n_layers < 1 || a->nets[b].n_layers > EH_MAX_LAYERS) return false;
  return true;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// checks shapes, devices and the envelope before it gets here.
extern "C" int EHE_LAUNCHER(const EhFusedEpochArgs* args, int width, void* stream) {
  if (args->n_epochs <= 0 || args->n_batches <= 0) return 0;
  // the bf16 build keeps the parameters rounded to bf16 beside them
  const size_t smem =
      (ehe_smem_floats(args) + (EH_BF16_BUILD ? (size_t)args->n_padded : 0)) * sizeof(float);
  const int tr = args->tile_rows;
  const int c = args->cluster;
  if (smem > EH_MAX_SMEM_BYTES || !ehe_nets_valid(args) ||
      args->n_args > EH_MAX_ARGS || !eh_form_built(args->form) || args->n_targets < 1 ||
      args->n_targets > EH_MAX_TARGETS || !eh_loss_built(args->loss_kind) ||
      args->n_globals + args->n_fixed > EH_MAX_SCALARS || args->n_forcing > EH_MAX_FORCING ||
      tr < 32 || tr % 32 != 0 || (c != 1 && c != 2 && c != 4 && c != 8) ||
      (int64_t)args->block_rows * c < args->batch || args->n_padded % 4 != 0 ||
      args->n_unit_table < 0 ||
      args->moments_shared < 0 || args->moments_shared > 2 ||
      (args->moments_shared == 0 && c != 1) ||
      (args->optimizer.rule == OPT_AMSGRAD && args->moments_shared == 1) ||
      args->optimizer.n_leaves < 1 || args->optimizer.n_leaves > EH_MAX_LEAVES ||
      (args->stages != 0 && (args->stages != 2 || tr < args->block_rows)) ||
      args->n_members < 1 || args->n_members > 65535 ||
      args->perm_stride < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 16: return ehe_launch_built<16>(args, smem, s);
    case 32: return ehe_launch_built<32>(args, smem, s);
    case 64: return ehe_launch_built<64>(args, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
