// Route ct's wide register FFT, build unit 5 of 8: the plans of
// ops/fft_plan.py::WIDE_PLANS whose index in sorted order is 5 modulo
// WIDE_UNITS (n_fft 5632, 7680, 9984, 12032, 14080).  The kernel, its
// contract and its design: csrc/wide_fft.cuh.

#include "wide_fft.cuh"

// (n_fft / 2, values a lane, the launch bounds' blocks an SM, the passes'
// radices): WIDE_PLANS' n_fft -> (values, radices, blocks, warps); the
// warps a block are the launch's argument
#define TSC_WIDE_PLANS(X)        \
  X(2816, 44, 4, 16, 16, 11)     \
  X(3840, 60, 3, 16, 16, 3, 5)   \
  X(4992, 39, 4, 16, 8, 3, 13)   \
  X(6016, 47, 3, 16, 8, 47)      \
  X(7040, 55, 3, 16, 8, 5, 11)

TSC_REGISTER_ENTRY(tsc_wide_fft_frontend_5, TSC_WIDE_PLANS)
