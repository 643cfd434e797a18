// The float64 entry point of the plain variants of kernel V
// (mom_vecinv.cu; its notes are there), in a source of its own so that
// nvcc compiles it beside the others.

#define MITGCM_F64
#include "mom_vecinv.cu"
