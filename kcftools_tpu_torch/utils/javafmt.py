"""Java-compatible numeric text formatting.

The KCF text format was defined by a Java implementation, so byte-identical
output requires Java's formatting semantics, which differ from Python's in
two places:

* ``String.format("%.2f", x)`` rounds the *exact* decimal expansion of the
  double with HALF_UP (ties away from zero). Python's ``format(x, ".2f")``
  uses round-half-even. (reference: Data/Data.java:129-130 and every other
  ``%.2f`` site.)
* ``String.valueOf(double)`` / ``Float.toString`` print the shortest
  decimal that round-trips, with ``.0`` appended to integral values and a
  Java-style exponent form outside [1e-3, 1e7).
  (reference: KCFHeader param emission, Window INFO "MV=" float concat.)
"""

import decimal
import math

import numpy as np

_D2 = decimal.Decimal("0.01")


def f2(x) -> str:
    """Java String.format(Locale.US, "%.2f", x) for a double.

    Python's ``.2f`` and Java agree except when the exact decimal expansion
    of the double is a tie (ends in ...5 at the third decimal), where Java
    rounds away from zero and Python to even. The tie test below is cheap
    and conservative; only suspected ties pay for exact Decimal handling.
    """
    x = float(x)
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "Infinity" if x > 0 else "-Infinity"
    scaled = abs(x) * 100.0
    if abs(scaled - math.floor(scaled) - 0.5) <= 1e-9 * max(1.0, scaled):
        return str(decimal.Decimal(x).quantize(_D2, rounding=decimal.ROUND_HALF_UP))
    return format(x, ".2f")


def _java_sci(x: float, digits: str, exp: int) -> str:
    # digits is the shortest digit string, exp is the power of ten of the
    # first digit. Java: d.ddddEx with at least one fraction digit.
    mant = digits[0] + "." + (digits[1:] if len(digits) > 1 else "0")
    return f"{mant}E{exp}"


def _shortest_digits(x: float, repr_fn) -> tuple:
    """Return (digits_without_dot, decimal_exponent_of_first_digit)."""
    s = repr_fn(x)
    if "e" in s or "E" in s:
        mant, _, e = s.replace("E", "e").partition("e")
        exp = int(e)
    else:
        mant, exp = s, 0
    if "." in mant:
        ip, fp = mant.split(".")
    else:
        ip, fp = mant, ""
    digits = (ip + fp).lstrip("0")
    if not digits:
        return "0", 0
    # exponent of first significant digit
    lead_zeros = len(ip + fp) - len(digits)
    exp10 = exp + len(ip) - 1 - lead_zeros
    return digits.rstrip("0") or "0", exp10


def _java_fp_str(x: float, repr_fn) -> str:
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "Infinity" if x > 0 else "-Infinity"
    if x == 0.0:
        return "-0.0" if math.copysign(1.0, x) < 0 else "0.0"
    sign = "-" if x < 0 else ""
    digits, exp10 = _shortest_digits(abs(x), repr_fn)
    if -3 <= exp10 < 7:
        if exp10 >= 0:
            ip = digits[: exp10 + 1].ljust(exp10 + 1, "0")
            fp = digits[exp10 + 1:] or "0"
            return f"{sign}{ip}.{fp}"
        return sign + "0." + "0" * (-exp10 - 1) + digits
    return sign + _java_sci(abs(x), digits, exp10)


def dbl(x) -> str:
    """Java String.valueOf(double)."""
    return _java_fp_str(float(x), repr)


def flt(x) -> str:
    """Java Float.toString for a float32 value."""
    v = np.float32(x)
    if np.isnan(v):
        return "NaN"
    if np.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    return _java_fp_str(
        float(v),
        lambda y: np.format_float_scientific(np.float32(y), unique=True, trim="-"),
    )
