"""Double-float (df32) arithmetic in plain jnp.

A value is an unevaluated pair (hi, lo) of float32 with hi + lo carrying
about 48 significant bits. Used by the jitted finalize
(api._device_finalize) to reduce f32 partial sums to f64 grade without
enabling x64 in the caller's program. Every operation is ordinary f32
arithmetic, so it runs on any backend; the error-free transforms below
rely on IEEE round-to-nearest and on the compiler not reassociating
float adds, which XLA guarantees.
"""

import numpy as np


def _two_sum(a, b):
    """Error-free a+b -> (s, e) with s+e == a+b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _quick_two_sum(a, b):
    """Error-free a+b assuming |a| >= |b| (Dekker)."""
    s = a + b
    return s, b - (s - a)


def _veltkamp_split(a):
    """a == hi + lo with hi carrying the top 12 mantissa bits."""
    c = a * 4097.0  # 2**12 + 1
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """Error-free a*b -> (p, e) with p+e == a*b exactly (Dekker, no FMA)."""
    p = a * b
    ah, al = _veltkamp_split(a)
    bh, bl = _veltkamp_split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(x, y):
    s, e = _two_sum(x[0], y[0])
    return _quick_two_sum(s, e + x[1] + y[1])


def df_div(x, y):
    """df/df with one Newton correction (~2 ulp of df32)."""
    q1 = x[0] / y[0]
    p, e = _two_prod(q1, y[0])
    s, f = _two_sum(x[0], -p)
    r = (s + ((f - e) + x[1])) - q1 * y[1]
    return _quick_two_sum(q1, r / y[0])


def df_const(v: float):
    """A Python float as a df32 constant pair."""
    hi = np.float32(v)
    return (float(hi), float(np.float32(v - float(hi))))
