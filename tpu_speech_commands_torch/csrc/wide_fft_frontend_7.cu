// Route ct's wide register FFT, build unit 7 of 8: the plans of
// ops/fft_plan.py::WIDE_PLANS whose index in sorted order is 7 modulo
// WIDE_UNITS (n_fft 6144, 8448, 10496, 12544, 14592).  The kernel, its
// contract and its design: csrc/wide_fft.cuh.

#include "wide_fft.cuh"

// (n_fft / 2, values a lane, the launch bounds' blocks an SM, the passes'
// radices): WIDE_PLANS' n_fft -> (values, radices, blocks, warps); the
// warps a block are the launch's argument
#define TSC_WIDE_PLANS(X)        \
  X(3072, 48, 3, 16, 8, 8, 3)    \
  X(4224, 33, 4, 16, 8, 3, 11)   \
  X(5248, 41, 4, 16, 8, 41)      \
  X(6272, 49, 3, 16, 8, 7, 7)    \
  X(7296, 57, 3, 16, 8, 3, 19)

TSC_REGISTER_ENTRY(tsc_wide_fft_frontend_7, TSC_WIDE_PLANS)
