"""BLS12-381 curve parameters.

Role-equivalent to the constants baked into the ``blst`` backend used by the
reference (``crypto/bls/src/impls/blst.rs``).  Everything here is a plain
Python integer; all derived quantities are asserted in ``tests/test_bls_fields.py``
rather than trusted.
"""

# Base field modulus.
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

# Subgroup order (scalar field modulus).
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# BLS parameter x (negative for BLS12-381).  t = x + 1 is the trace of Frobenius.
X = -0xD201000000010000
X_ABS = -X

# G1 cofactor h1 = (x - 1)^2 / 3 (asserted in tests: h1 * r == p + 1 - (x + 1)).
H1 = (X - 1) ** 2 // 3

# G2 (twist) cofactor h2 = (x^8 - 4x^7 + 5x^6 - 4x^4 + 6x^3 - 4x^2 - 4x + 13) / 9.
H2 = (X**8 - 4 * X**7 + 5 * X**6 - 4 * X**4 + 6 * X**3 - 4 * X**2 - 4 * X + 13) // 9

# Curve equations: E1/Fp: y^2 = x^3 + 4;  E2/Fp2: y^2 = x^3 + 4(1 + i).
B1 = 4
B2 = (4, 4)  # 4 + 4i as an Fp2 pair (c0, c1)

# Standard generators (zcash serialization spec); asserted on-curve/in-subgroup in tests.
G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

G2_X_C0 = 0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8
G2_X_C1 = 0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E
G2_Y_C0 = 0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801
G2_Y_C1 = 0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE

# Domain separation tag for eth2 signatures (crypto/bls/src/impls/blst.rs:13).
DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

# Batch-verification random-weight size in bits (crypto/bls/src/impls/blst.rs:14).
RAND_BITS = 64

# RFC 9380 8.8.2 SSWU parameters for the 3-isogenous curve E' over Fp2:
# E': y^2 = x^3 + A' x + B' with A' = 240*i, B' = 1012*(1+i), Z = -(2+i).
SSWU_A = (0, 240)
SSWU_B = (1012, 1012)
SSWU_Z = (P - 2, P - 1)

assert (X - 1) ** 2 % 3 == 0
assert (X**8 - 4 * X**7 + 5 * X**6 - 4 * X**4 + 6 * X**3 - 4 * X**2 - 4 * X + 13) % 9 == 0
assert (P - 1) % 6 == 0, "tower construction requires p ≡ 1 (mod 6)"
