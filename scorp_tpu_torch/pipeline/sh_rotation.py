"""Rotation of real spherical-harmonic coefficients (degrees 1..3); a copy
of `scorp_tpu.pipeline.sh_rotation` (numpy only), so that the port imports
nothing of the JAX package.

The reference rotates SH features with e3nn Wigner-D matrices plus a yzx
axis permutation (its `utils/gaussians.py`). Without e3nn, the real-SH
rotation matrices are built directly with
the Ivanic & Ruedenberg recursion (J. Phys. Chem. 1996; erratum 1998) —
the standard real-basis algorithm used throughout graphics.

Contract (verified by tests/test_pipeline_utils.py and, for this copy,
tests/test_torch_pipeline_utils.py): for coefficients `sh`
in the renderer's hardcoded real-SH basis (core/sh.py),

    eval_sh(rotate_sh(sh, R), d) == eval_sh(sh, Rᵀ d)

i.e. rotating a Gaussian cloud's positions by R and its SH by rotate_sh
leaves view-dependent colors consistent.
"""

from __future__ import annotations

import numpy as np


def _p_func(i, a, b, ell, d1, dlm1):
    """Ivanic P_i(l; a, b) helper. Indices are SH orders (can be negative)."""
    if abs(b) < ell:
        return d1[i + 1, 1] * dlm1[a + ell - 1, b + ell - 1]
    if b == ell:
        return (
            d1[i + 1, 2] * dlm1[a + ell - 1, 2 * ell - 2]
            - d1[i + 1, 0] * dlm1[a + ell - 1, 0]
        )
    # b == -ell
    return (
        d1[i + 1, 2] * dlm1[a + ell - 1, 0]
        + d1[i + 1, 0] * dlm1[a + ell - 1, 2 * ell - 2]
    )


def _wigner_next(ell, d1, dlm1):
    """D^ell [2l+1, 2l+1] from D^1 [3,3] and D^(l-1)."""
    size = 2 * ell + 1
    out = np.zeros((size, size))
    for m in range(-ell, ell + 1):
        for n in range(-ell, ell + 1):
            if abs(n) < ell:
                denom = (ell + n) * (ell - n)
            else:
                denom = (2 * ell) * (2 * ell - 1)
            u = np.sqrt((ell + m) * (ell - m) / denom)
            v = (
                np.sqrt((1.0 + (m == 0)) * (ell + abs(m) - 1) * (ell + abs(m)) / denom)
                * (1.0 - 2.0 * (m == 0))
                * 0.5
            )
            w = (
                np.sqrt((ell - abs(m) - 1) * (ell - abs(m)) / denom)
                * (1.0 - (m == 0))
                * (-0.5)
            )

            val = 0.0
            if u != 0.0:
                val += u * _p_func(0, m, n, ell, d1, dlm1)
            if v != 0.0:
                if m == 0:
                    vv = _p_func(1, 1, n, ell, d1, dlm1) + _p_func(-1, -1, n, ell, d1, dlm1)
                elif m > 0:
                    vv = _p_func(1, m - 1, n, ell, d1, dlm1) * np.sqrt(1.0 + (m == 1)) \
                        - _p_func(-1, -m + 1, n, ell, d1, dlm1) * (1.0 - (m == 1))
                else:
                    vv = _p_func(1, m + 1, n, ell, d1, dlm1) * (1.0 - (m == -1)) \
                        + _p_func(-1, -m - 1, n, ell, d1, dlm1) * np.sqrt(1.0 + (m == -1))
                val += v * vv
            if w != 0.0:
                if m > 0:
                    ww = _p_func(1, m + 1, n, ell, d1, dlm1) + _p_func(-1, -m - 1, n, ell, d1, dlm1)
                else:
                    ww = _p_func(1, m - 1, n, ell, d1, dlm1) - _p_func(-1, -m + 1, n, ell, d1, dlm1)
                val += w * ww
            out[m + ell, n + ell] = val
    return out


def real_sh_rotation_matrices(R: np.ndarray, max_degree: int = 3) -> list[np.ndarray]:
    """Real-SH rotation matrices [D^1, ..., D^max_degree] for rotation R.

    Defined so that coefficients c' = D^l @ c satisfy
    eval_band_l(c', d) = eval_band_l(c, Rᵀ d) in the renderer's basis.
    """
    R = np.asarray(R, np.float64)
    # degree-1 real SH order is (-1, 0, +1) ~ (y, z, x); the band transforms
    # with R itself expressed in that permuted basis
    perm = [1, 2, 0]
    d1 = R[np.ix_(perm, perm)]
    mats = [d1]
    prev = d1
    for ell in range(2, max_degree + 1):
        prev = _wigner_next(ell, d1, prev)
        mats.append(prev)
    # the renderer's hardcoded basis folds (-1)^m signs into its constants
    # (core/sh.py C1..C3 sign pattern); conjugate by S_l = diag((-1)^m)
    out = []
    for ell, D in enumerate(mats, start=1):
        s = np.array([(-1.0) ** m for m in range(-ell, ell + 1)])
        out.append(s[:, None] * D * s[None, :])
    return out


def rotate_sh(f_rest: np.ndarray, R: np.ndarray) -> np.ndarray:
    """Rotate [N, K-1, 3] rest-band SH coefficients by rotation matrix R.

    Supports K-1 in {0, 3, 8, 15} (degrees 1..3); the DC band is invariant.
    """
    n, bands, _ = f_rest.shape
    if bands == 0:
        return f_rest
    degree = int(round((bands + 1) ** 0.5)) - 1
    assert (degree + 1) ** 2 - 1 == bands, f"unsupported band count {bands}"
    mats = real_sh_rotation_matrices(R, degree)
    out = f_rest.copy()
    offset = 0
    for ell in range(1, degree + 1):
        size = 2 * ell + 1
        block = f_rest[:, offset : offset + size, :]   # [N, size, 3]
        out[:, offset : offset + size, :] = np.einsum(
            "ij,njc->nic", mats[ell - 1].astype(f_rest.dtype), block
        )
        offset += size
    return out
