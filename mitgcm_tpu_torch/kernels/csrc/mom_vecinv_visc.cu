// The float32 entry point of the dissipation variants of kernel V
// (mom_vecinv.cu; its notes are there), in a source of its own so that
// nvcc compiles it beside the others.

#define MITGCM_VISC
#include "mom_vecinv.cu"
