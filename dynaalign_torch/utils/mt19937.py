"""Minimal MT19937 matching C++ ``std::mt19937`` output.

The reference draws its MinHash seed family from
``std::mt19937 gen(seed); std::uniform_int_distribution<uint32_t> dis;``
(src/minHash.cpp:67-81).  For a full-range ``uint32`` distribution libstdc++
returns the generator's raw 32-bit outputs, so reproducing the *seeded* C++
hash family only needs a faithful MT19937.  (The reference itself seeds from
``std::random_device`` — i.e. it is nondeterministic run-to-run; our
framework makes the seed explicit, defaulting to 0, and matches the
reference statistically rather than bitwise.  See SURVEY.md §7 hard part 3.)

This pure-Python implementation follows the published MT19937 algorithm
(Matsumoto & Nishimura 1998) with the standard ``init_genrand`` scalar
seeding used by std::mt19937.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER_MASK = 0x80000000
_LOWER_MASK = 0x7FFFFFFF
_U32 = 0xFFFFFFFF


class MT19937:
    """MT19937 with std::mt19937-compatible scalar seeding."""

    def __init__(self, seed: int):
        self.mt = [0] * _N
        self.mti = _N
        self.mt[0] = seed & _U32
        for i in range(1, _N):
            self.mt[i] = (
                1812433253 * (self.mt[i - 1] ^ (self.mt[i - 1] >> 30)) + i
            ) & _U32

    def _generate(self) -> None:
        mt = self.mt
        for i in range(_N):
            y = (mt[i] & _UPPER_MASK) | (mt[(i + 1) % _N] & _LOWER_MASK)
            mt[i] = mt[(i + _M) % _N] ^ (y >> 1)
            if y & 1:
                mt[i] ^= _MATRIX_A
        self.mti = 0

    def next_u32(self) -> int:
        if self.mti >= _N:
            self._generate()
        y = self.mt[self.mti]
        self.mti += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & _U32


def hash_family_seeds(n_hash: int, seed: int) -> np.ndarray:
    """The n_hash murmur seeds a seeded C++ HashFamily would draw.

    Equivalent to ``HashFamily(n_hash, seed)`` in the reference
    (src/minHash.cpp:73-81) when compiled with libstdc++, where
    ``uniform_int_distribution<uint32_t>`` over the full range passes
    mt19937 outputs through unchanged.
    """
    gen = MT19937(seed)
    return np.array([gen.next_u32() for _ in range(n_hash)], dtype=np.uint32)
