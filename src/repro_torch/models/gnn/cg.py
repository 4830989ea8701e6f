"""Clebsch-Gordan coefficients in the REAL spherical-harmonic basis (l ≤ 4),
the port of ``repro/models/gnn/cg.py``: the tables are the reference's
float64 numpy, computed the same way.

Complex CG via Racah's closed form, then the unitary change of basis to real
harmonics with the phase fixed so the result is purely real. Checked by
tests/test_torch_gnn.py: the real-basis identities (1⊗1→0 is the dot
product, 1⊗1→1 the cross product), and the rotation invariance of the MACE
energy.
"""
from __future__ import annotations

from functools import lru_cache
from math import factorial, sqrt

import numpy as np
import torch


def _cg_complex_element(l1: int, m1: int, l2: int, m2: int, L: int, M: int) -> float:
    """⟨l1 m1 l2 m2 | L M⟩ (Condon–Shortley), Racah's formula."""
    if m1 + m2 != M or L < abs(l1 - l2) or L > l1 + l2 or abs(m1) > l1 or abs(m2) > l2 or abs(M) > L:
        return 0.0
    pref = (2 * L + 1) * (
        factorial(l1 + l2 - L) * factorial(l1 - l2 + L) * factorial(-l1 + l2 + L)
    ) / factorial(l1 + l2 + L + 1)
    pref *= (
        factorial(L + M) * factorial(L - M)
        * factorial(l1 - m1) * factorial(l1 + m1)
        * factorial(l2 - m2) * factorial(l2 + m2)
    )
    total = 0.0
    for k in range(0, l1 + l2 - L + 1):
        denoms = [
            k,
            l1 + l2 - L - k,
            l1 - m1 - k,
            l2 + m2 - k,
            L - l2 + m1 + k,
            L - l1 - m2 + k,
        ]
        if any(d < 0 for d in denoms):
            continue
        term = 1.0
        for d in denoms:
            term *= factorial(d)
        total += (-1.0) ** k / term
    return sqrt(pref) * total


@lru_cache(maxsize=None)
def complex_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """(2l1+1, 2l2+1, 2l3+1) with m indices ordered -l..l."""
    out = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    for i, m1 in enumerate(range(-l1, l1 + 1)):
        for j, m2 in enumerate(range(-l2, l2 + 1)):
            for k, m3 in enumerate(range(-l3, l3 + 1)):
                out[i, j, k] = _cg_complex_element(l1, m1, l2, m2, l3, m3)
    return out


@lru_cache(maxsize=None)
def real_to_complex(l: int) -> np.ndarray:
    """U with Y_real = U @ Y_complex (rows: real m' = -l..l; cols: complex m)."""
    n = 2 * l + 1
    u = np.zeros((n, n), dtype=complex)
    for m in range(-l, l + 1):
        row = m + l
        if m == 0:
            u[row, l] = 1.0
        elif m > 0:
            u[row, m + l] = (-1) ** m / sqrt(2)
            u[row, -m + l] = 1 / sqrt(2)
        else:  # m < 0
            am = -m
            u[row, -am + l] = 1j / sqrt(2)
            u[row, am + l] = -1j * (-1) ** am / sqrt(2)
    return u


@lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis intertwiner C with T_r[k] = Σ C[i,j,k] u_r[i] v_r[j]."""
    c = complex_cg(l1, l2, l3)
    u1 = real_to_complex(l1)
    u2 = real_to_complex(l2)
    u3 = real_to_complex(l3)
    cr = np.einsum("kc,ia,jb,abc->ijk", u3, u1.conj(), u2.conj(), c.astype(complex))
    # overall phase: result is real or purely imaginary depending on l1+l2+l3
    if np.abs(cr.imag).max() > np.abs(cr.real).max():
        cr = cr * (-1j)
    assert np.abs(cr.imag).max() < 1e-10, (l1, l2, l3, np.abs(cr.imag).max())
    return np.ascontiguousarray(cr.real)


# --------------------------------------------------------------------------
# real spherical harmonics (explicit, unit vectors), m ordered -l..l
# --------------------------------------------------------------------------
def sh_l(vec, l: int):
    """vec: (..., 3) unit vectors → (..., 2l+1). Tensors and numpy arrays."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    pi = np.pi
    if l == 0:
        return _stack([0.5 / sqrt(pi) + 0.0 * x])
    if l == 1:
        c = sqrt(3 / (4 * pi))
        return _stack([c * y, c * z, c * x])
    if l == 2:
        return _stack(
            [
                0.5 * sqrt(15 / pi) * x * y,
                0.5 * sqrt(15 / pi) * y * z,
                0.25 * sqrt(5 / pi) * (3 * z * z - 1.0),
                0.5 * sqrt(15 / pi) * x * z,
                0.25 * sqrt(15 / pi) * (x * x - y * y),
            ]
        )
    raise NotImplementedError(l)


def _stack(parts):
    if isinstance(parts[0], torch.Tensor):
        return torch.stack(parts, dim=-1)
    return np.stack(parts, axis=-1)
