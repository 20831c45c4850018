// Route ct's wide register FFT, build unit 6 of 8: the plans of
// ops/fft_plan.py::WIDE_PLANS whose index in sorted order is 6 modulo
// WIDE_UNITS (n_fft 5888, 7936, 10240, 12288, 14336).  The kernel, its
// contract and its design: csrc/wide_fft.cuh.

#include "wide_fft.cuh"

// (n_fft / 2, values a lane, the launch bounds' blocks an SM, the passes'
// radices): WIDE_PLANS' n_fft -> (values, radices, blocks, warps); the
// warps a block are the launch's argument
#define TSC_WIDE_PLANS(X)        \
  X(2944, 46, 4, 16, 8, 23)      \
  X(3968, 62, 3, 16, 8, 31)      \
  X(5120, 40, 4, 16, 8, 8, 5)    \
  X(6144, 48, 3, 16, 16, 8, 3)   \
  X(7168, 56, 3, 16, 8, 8, 7)

TSC_REGISTER_ENTRY(tsc_wide_fft_frontend_6, TSC_WIDE_PLANS)
