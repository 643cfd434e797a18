// The float64 entry points of mom_visc.cu (its notes are there), in a
// source of their own so that nvcc compiles them beside the float32 ones.

#define MITGCM_F64
#include "mom_visc.cu"
