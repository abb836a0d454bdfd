// Kernel 2 over 0 to EH_MAX_NETS networks (a MultiNN model's branches, one
// neural parameter each, or none: a model with globals only): fused_epoch.cu
// built with EHE_MULTI_NETS, its launcher eh_fused_epoch_multinn and
// eh_fused_epoch_multinn_args_size. fused_epoch.cu itself is the build of
// one network, whose code is the kernel's before it took branches.

#define EHE_MULTI_NETS
#include "fused_epoch.cu"
