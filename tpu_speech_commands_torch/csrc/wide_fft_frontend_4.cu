// Route ct's wide register FFT, build unit 4 of 8: the plans of
// ops/fft_plan.py::WIDE_PLANS whose index in sorted order is 4 modulo
// WIDE_UNITS (n_fft 5376, 7424, 9728, 11776, 13824, 15872).  The kernel,
// its contract and its design: csrc/wide_fft.cuh.

#include "wide_fft.cuh"

// (n_fft / 2, values a lane, the launch bounds' blocks an SM, the passes'
// radices): WIDE_PLANS' n_fft -> (values, radices, blocks, warps); the
// warps a block are the launch's argument
#define TSC_WIDE_PLANS(X)           \
  X(2688, 42, 4, 16, 8, 3, 7)       \
  X(3712, 58, 3, 16, 8, 29)         \
  X(4864, 38, 4, 16, 16, 19)        \
  X(5888, 46, 3, 16, 16, 23)        \
  X(6912, 54, 3, 16, 16, 3, 3, 3)   \
  X(7936, 62, 3, 16, 16, 31)

TSC_REGISTER_ENTRY(tsc_wide_fft_frontend_4, TSC_WIDE_PLANS)
