"""xoshiro256** RNG, seeded via splitmix64, with the Box-Muller gaussian
sampler used by the reference for ensemble tree perturbation
(``lib/src/tlrng.c``); a copy of kalign_tpu/utils/rng.py.  Bit-exact:
doubles are generated as x / 2^64 with the zero-rejection loop, and the
gaussian caches its second deviate.
"""

import math

_MASK = (1 << 64) - 1


class XoshiroRng:
    def __init__(self, seed: int):
        assert seed != 0, "seed must be nonzero for reproducibility"
        self.s = [0, 0, 0, 0]
        while True:
            ok = 0
            for i in range(4):
                seed = (seed + 0x9E3779B97F4A7C15) & _MASK
                z = seed
                z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
                z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
                self.s[i] = z ^ (z >> 31)
                if self.s[i]:
                    ok += 1
            if ok:
                break
        self._gen = False
        self._z1 = 0.0

    def next_u64(self) -> int:
        s = self.s
        result = (self._rotl((s[1] * 5) & _MASK, 7) * 9) & _MASK
        t = (s[1] << 17) & _MASK
        s[2] ^= s[0]
        s[3] ^= s[1]
        s[1] ^= s[2]
        s[0] ^= s[3]
        s[2] ^= t
        s[3] = self._rotl(s[3], 45)
        return result

    @staticmethod
    def _rotl(x: int, k: int) -> int:
        return ((x << k) | (x >> (64 - k))) & _MASK

    def random_double(self) -> float:
        while True:
            y = self.next_u64() / 18446744073709551616.0
            if y != 0.0:
                return y

    def random_int(self, a: int) -> int:
        return int(self.random_double() * a)

    def gaussian(self, mu: float, sigma: float) -> float:
        self._gen = not self._gen
        if not self._gen:
            return self._z1 * sigma + mu
        while True:
            u1 = self.random_double()
            u2 = self.random_double()
            if u1 > 2.220446049250313e-16:  # DBL_EPSILON
                break
        z0 = math.sqrt(-2.0 * math.log(u1)) * math.cos(2.0 * math.pi * u2)
        self._z1 = math.sqrt(-2.0 * math.log(u1)) * math.sin(2.0 * math.pi * u2)
        return z0 * sigma + mu
