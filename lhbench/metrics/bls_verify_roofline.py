"""``bls_verify_roofline``: per cent of the device time of the traced window's
batch verifications that the card would need at its roofline.  Numerator:
the least time (``least_seconds``) of the Fq products (``fq_products``) that
each of the window's batches needs, counted from its live shape (its flight
record: live sets and live keys; padding is not counted), whatever kernels
compute it, at the SM clock sampled beside the window. Denominator: the
union of the intervals in which a kernel ran on the card in the traced
window (``torch.profiler``), which holds nothing but the batches' programs.
Layer: the kernels (``ops/cuda_fq.py``, ``csrc/fq_mul.cu`` and every kernel
the program launches).  Moves ``sets_per_s``: the share of the card's least
time that the batches' kernels reach; a program that does the same work in
fewer, fuller kernels raises it."""

from lhbench import peaks
from lhbench.harness import union

#: One Fq product as 12-word Montgomery multiplication: 2 * 12**2 + 12
#: int32 multiply-adds; its two operands read and its result written once.
MACS_PER_PRODUCT = 2 * 12 * 12 + 12
BYTES_PER_PRODUCT = 3 * 48

G1_MADD, G1_DBL, G1_ADD = 11, 7, 16
G2_DBL, G2_ADD = 16, 43
WEIGHT_DOUBLINGS, WEIGHT_ADDITIONS = 63, 15
MILLER_PAIR = 63 * (25 + 39) + 5 * (41 + 39)
MILLER_SHARED = 62 * 36
FINAL_EXP = 2 * 54 + 5 * (63 * 12 + 5 * 54) + 8 * 54


def fq_products(n_sets: int, n_keys: int) -> int:
    """Fq products (products in the 381-bit base field) one batch
    verification of ``n_sets`` live sets over ``n_keys`` live keys needs.
    Additions, subtractions, Frobenius maps, conjugations and inversions are
    not counted, so this is a lower bound.

    - Fq2 product 3 (Karatsuba), Fq2 square 2 (complex squaring); Fq12
      product 54 (18 Fq2 products).
    - Key sums: ``n_keys - n_sets`` G1 mixed additions (cached keys are
      affine), 11 each (EFD ``madd-2007-bl``: 7M + 4S).
    - ``[r_i] aggpk_i``, 64-bit weights: 63 doublings (EFD ``dbl-2009-l``:
      2M + 5S = 7) and 15 additions (``add-2007-bl``: 11M + 5S = 16) by
      4-bit windows, 681 a set.
    - ``sum_i [r_i] sig_i`` in G2: 15 additions a set (43 each: 11 Fq2
      products and 5 squares) and 63 shared doublings a batch (16 each).
    - One Miller loop a pair, ``n_sets + 1`` pairs (Aranha, Karabina, Longa,
      Gebotys and Lopez, "Faster explicit formulas for computing pairings
      over ordinary curves", Eurocrypt 2011): for |x| = 0xd201000000010000,
      63 doubling steps (3 Fq2 products, 6 squares, 2 Fq2-by-Fq scalings:
      25) and 5 addition steps (11 products, 2 squares, 2 scalings: 41),
      each with a sparse line multiplication (13 Fq2 products: 39): 4,432 a
      pair.  Shared by all pairs: 62 Fq12 squarings (2 Fq6 products, 36
      each): 2,232.
    - One final exponentiation a batch: the easy part's 2 Fq12 products; the
      hard part as ``(x-1)^2 (x+p) (x^2+p^2-1) + 3``: 5 exponentiations by
      |x| (63 cyclotomic squarings of 12 each, Granger-Scott, and 5 Fq12
      products) and 8 Fq12 products: 5,670.
    """
    per_set = (WEIGHT_DOUBLINGS * G1_DBL + WEIGHT_ADDITIONS * G1_ADD
               + WEIGHT_ADDITIONS * G2_ADD + MILLER_PAIR)
    per_batch = WEIGHT_DOUBLINGS * G2_DBL + MILLER_PAIR + MILLER_SHARED + FINAL_EXP
    return G1_MADD * (n_keys - n_sets) + per_set * n_sets + per_batch


def least_seconds(products: int, sm_clock_mhz: float) -> float:
    """The larger of the products' multiply-adds over the card's int32 peak
    at ``sm_clock_mhz`` and their bytes over the HBM bandwidth; above 826
    MHz it is the bytes that bound it."""
    compute = products * MACS_PER_PRODUCT / peaks.int32_macs_per_s(sm_clock_mhz)
    memory = products * BYTES_PER_PRODUCT / peaks.HBM_BYTES_PER_S
    return max(compute, memory)


def read(run):
    if run.trace is None or not run.flight:
        return None
    busy = sum(e - s for s, e in union([(s, e) for _, s, e in run.trace.kernels]))
    if busy <= 0:
        return None
    clock = run.trace.sm_clock_mhz or peaks.BOOST_CLOCK_MHZ
    least = sum(least_seconds(fq_products(r["n_live"], r.get("live_keys", r["n_live"])), clock)
                for r in run.flight)
    return 100.0 * least / busy
