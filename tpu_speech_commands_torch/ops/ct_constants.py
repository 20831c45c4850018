"""Constants of the Cooley-Tukey (CT) split DFT frontend, built in float64
numpy and stored row-major as float32 (the port's own counterparts of
`tpu_speech_commands/ops/pallas_frontend.py::_ct_eligible`, `_ct_matrices`
and `_dft8_real`'s tables, and of the duplicated-row filterbank of the
`mel='dup'` / `ppmel` variants).

Decimation n = 128 a + b (a < n2 = n_fft / 128, b < 128):

    T[s, b]       = sum_a x[128 a + b] W_n2^(s a)                 stage 1
    X[n2 j + s]   = sum_b T[s, b] W_nfft^((n2 j + s) b),  j < 64  stage 2

Real input, so T[n2 - s] = conj(T[s]) and stage 1 needs s <= n2 / 2 only.
Per residue s, stage 2 packs the real and imaginary parts of the 64 bins
n2 j + s into one 128-column product, [Xr | Xi] = T_re @ E2a[s] +- T_im @
E2b[s] (+ for s < n2 / 2, - above; residues 0 and n2 / 2 have T_im = 0), with
E2a = [Er | Ei], E2b = [-Ei | Er] pre-scaled by 1 / sqrt(n_fft) so that |X|^2
is the power.  The Nyquist bin n_fft / 2 is sum_b (-1)^b T[0, b] /
sqrt(n_fft).  The power lands permuted, row s * 64 + j for bin n2 j + s, and
the filterbank rows are permuted to match, with an all-ones energy column.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from ..frontend.filterbanks import dct_t_matrix, filterbank_matrix
from ..params import ListenerParams

LANES = 128  # b: the split's inner length
CT_J = 64    # stage-2 bins of a residue: k = n2 j + s, j < 64


def ct_eligible(p: ListenerParams) -> bool:
    """n_fft = 128 n2 with n2 even, and window == n_fft: the configs the
    JAX package's CT kernel takes (its `_ct_eligible`)."""
    n2 = p.n_fft // LANES
    return (p.n_fft % LANES == 0 and n2 >= 2 and n2 % 2 == 0
            and p.window_samples == p.n_fft)


@dataclasses.dataclass(frozen=True)
class CtMatrices:
    """The CT split's constants for one (n_fft, n_filt, sample_rate,
    feature_type), each row-major:

    - stage1 (2, n2, n2): cos(2 pi s a / n2) and -sin(...), with the values
      that are zero in exact arithmetic stored as 0;
    - e2a, e2b (n2, 128, 128): the packed stage-2 matrices;
    - filt_half (n_fft / 2, n_filt + 1): row s * 64 + j the filterbank row of
      bin n2 j + s, column n_filt all ones (the energy);
    - filt_nyq (n_filt + 1,): the Nyquist bin's row, energy 1;
    - dct_t (n_filt, n_filt): the transposed DCT-II."""

    n2: int
    stage1: np.ndarray
    e2a: np.ndarray
    e2b: np.ndarray
    filt_half: np.ndarray
    filt_nyq: np.ndarray
    dct_t: np.ndarray

    @property
    def half(self) -> int:
        return self.n2 // 2

    def stage2_pack(self, paired: bool) -> np.ndarray:
        """The stage-2 operands as the kernel streams them, K = [T_re | T_im]:

        - unpaired, (n2, 256, 128): residue s is [E2a[s]; sign E2b[s]], sign
          -1 above n2 / 2 (zero rows for residues 0 and n2 / 2);
        - paired, (n2 / 2 + 1, 256, 256): group s < n2 / 2 shares T[s] between
          the conjugate residues s and n2 - s, [[E2a[s], E2a[n2 - s]],
          [E2b[s], -E2b[n2 - s]]]; groups 0 and n2 / 2 fill columns < 128."""
        n2, half = self.n2, self.half
        if not paired:
            pack = np.zeros((n2, 2 * LANES, LANES), np.float32)
            for s in range(n2):
                pack[s, :LANES] = self.e2a[s]
                if s not in (0, half):
                    pack[s, LANES:] = self.e2b[s] if s < half else -self.e2b[s]
            return pack
        pack = np.zeros((half + 1, 2 * LANES, 2 * LANES), np.float32)
        for s in range(half + 1):
            pack[s, :LANES, :LANES] = self.e2a[s]
            if s not in (0, half):
                pack[s, :LANES, LANES:] = self.e2a[n2 - s]
                pack[s, LANES:, :LANES] = self.e2b[s]
                pack[s, LANES:, LANES:] = -self.e2b[n2 - s]
        return pack

    def filt_dup(self) -> np.ndarray:
        """(n2, 128, n_filt + 1): the per-piece filterbank, rows j and j + 64
        of residue s both the row of bin n2 j + s (the Xr^2 and Xi^2
        halves of the unfolded squares)."""
        rows = self.filt_half.reshape(self.n2, CT_J, -1)
        return np.ascontiguousarray(np.concatenate([rows, rows], axis=1))

    def piece_ranges(self) -> np.ndarray:
        """(n_filt + 1, n2, 2) int32: for filter m and residue s the j range
        [lo, hi) from the first to the last nonzero weight of
        filt_half[s * 64 + j, m] ((0, 0) when there is none); the energy
        column's ranges are [0, 64)."""
        w = self.filt_half.reshape(self.n2, CT_J, -1).transpose(2, 0, 1)
        nz = w != 0
        any_nz = nz.any(-1)
        lo = np.where(any_nz, nz.argmax(-1), 0)
        hi = np.where(any_nz, CT_J - nz[..., ::-1].argmax(-1), 0)
        return np.ascontiguousarray(np.stack([lo, hi], -1), dtype=np.int32)


@lru_cache()
def ct_matrices(n_fft: int, n_filt: int, sample_rate: int,
                feature_type: str) -> CtMatrices:
    """The CT constants for n_fft = 128 n2 (n2 even)."""
    n2 = n_fft // LANES
    if n_fft % LANES or n2 < 2 or n2 % 2:
        raise ValueError(f"the CT split needs n_fft = 128 n2 with n2 even, "
                         f"got {n_fft}")
    ang1 = 2.0 * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2
    stage1 = np.stack([np.cos(ang1), -np.sin(ang1)])
    stage1[np.abs(stage1) < 1e-12] = 0.0  # zeros of exact arithmetic

    scale = 1.0 / np.sqrt(n_fft)
    b = np.arange(LANES, dtype=np.float64)[:, None]
    e2a = np.zeros((n2, LANES, LANES), np.float32)
    e2b = np.zeros((n2, LANES, LANES), np.float32)
    for s in range(n2):
        k = n2 * np.arange(CT_J, dtype=np.float64)[None, :] + s
        ang2 = 2.0 * np.pi * b * k / n_fft
        er, ei = scale * np.cos(ang2), -scale * np.sin(ang2)
        e2a[s, :, :CT_J], e2a[s, :, CT_J:] = er, ei
        e2b[s, :, :CT_J], e2b[s, :, CT_J:] = -ei, er

    p = ListenerParams(n_fft=n_fft, n_filt=n_filt, sample_rate=sample_rate)
    filt = filterbank_matrix(p, feature_type)  # (n_fft / 2 + 1, n_filt)
    filt_half = np.zeros((n2 * CT_J, n_filt + 1), np.float32)
    for s in range(n2):
        filt_half[s * CT_J:(s + 1) * CT_J, :n_filt] = filt[n2 * np.arange(CT_J) + s]
    filt_half[:, n_filt] = 1.0
    filt_nyq = np.ones(n_filt + 1, np.float32)
    filt_nyq[:n_filt] = filt[n_fft // 2]
    return CtMatrices(n2=n2, stage1=np.ascontiguousarray(stage1, np.float32),
                      e2a=e2a, e2b=e2b, filt_half=filt_half, filt_nyq=filt_nyq,
                      dct_t=np.ascontiguousarray(dct_t_matrix(n_filt)))
