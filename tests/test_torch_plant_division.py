"""The argument behind the plant kernel's branch-free division.

``csrc/div_rn.cuh`` divides with ``div_rn``: a float estimate of 1 / b
(``__fdividef``, the card's approximate reciprocal), two Newton steps in
double, a * y in double, and one rounding to float.  Its claim is that this
is the correctly rounded quotient, the value IEEE division gives, for b
normal with |b| < 2^126.  This file checks the argument, not the compiled
code: it takes the same steps in double (each FMA formed exactly and
rounded once) from an estimate off by up to 2^-20 either way, far more
than the hardware's, and holds the result to numpy's float32 division bit
for bit, over seeded quotients of the sizes the plant divides (forces by
stiffness, force limits by force norms) and over divisors whose
significand is all ones, where reciprocal refinement is at its weakest.
The compiled ``div_rn`` is held to IEEE division on the same kind of
operands by ``tests/test_torch_device_helpers.py``, on the card and
emulated.
"""

from fractions import Fraction

import numpy as np
import pytest


def _fma(x: float, y: float, z: float) -> float:
    return float(Fraction(x) * Fraction(y) + Fraction(z))


def _div_rn(a: np.float32, b: np.float32, rel_err: float) -> np.float32:
    y = float(np.float32(float(Fraction(1) / Fraction(float(b))) * (1.0 + rel_err)))
    bd = float(b)
    y = _fma(_fma(-bd, y, 1.0), y, y)
    y = _fma(_fma(-bd, y, 1.0), y, y)
    return np.float32(float(a) * y)            # a double product, then one rounding


def _cases(rng, n):
    a = (rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(-12, 6, n)).astype(np.float32)
    b = (10.0 ** rng.uniform(-9, 6, n)).astype(np.float32)
    ones = np.frombuffer((np.arange(n, dtype=np.uint32) % 40 + 100 << 23 | 0x7FFFFF)
                         .astype(np.uint32).tobytes(), dtype=np.float32)
    return np.concatenate([a, a]), np.concatenate([b, ones])


@pytest.mark.parametrize("rel_err", [-2.0 ** -20, 0.0, 2.0 ** -20])
def test_division_is_correctly_rounded(rel_err):
    a, b = _cases(np.random.default_rng(11), 600)
    want = a / b
    got = np.array([_div_rn(x, y, rel_err) for x, y in zip(a, b)], dtype=np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_division_keeps_the_sign_of_a_zero_dividend():
    for a in (np.float32(0.0), np.float32(-0.0)):
        for b in (np.float32(3.5e3), np.float32(1e-9)):
            got = _div_rn(a, b, 2.0 ** -20)
            assert got == 0.0 and np.signbit(got) == np.signbit(a / b)
