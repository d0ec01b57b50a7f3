"""JAX's threefry random streams in torch: the same seed, key and shape give
the same bits as ``jax.random`` (the partitionable threefry mode, the
default of the JAX versions this repository runs).

Threefry2x32 is an integer hash of a 64-bit counter under a 64-bit key, so
torch reproduces it exactly: the uint32 words live in int64 arrays masked
with ``0xFFFFFFFF`` after every add and shift (torch's ``>>`` on int64 is
arithmetic, and masked words are never negative). Keys are pairs of Python
ints ``(hi, lo)`` and are derived on the host; only the draws make tensors,
each on the ``device`` its caller names. A key's words may also be integer
arrays of one shape, a batch of keys: :func:`fold_in` folds an array of
data into one, and a draw under it has the batch's shape in front of its
own, hashed on the host in one numpy pass (a dispatch's scalar draws).

- :func:`seed_key`, :func:`fold_in` and :func:`split` derive keys as
  ``jax.random.PRNGKey``, ``fold_in`` and ``split`` do;
- :func:`random_bits` hashes the flat index of every element, as its
  (hi, lo) 32-bit halves, under the key: 32-bit draws are ``bits1 ^
  bits2``, 64-bit draws ``bits1 << 32 | bits2``;
- :func:`uniform`, :func:`randint` and :func:`normal` are
  ``jax.random``'s samplers on those bits, op for op: the mantissa trick,
  the two-draw modular integer, and ``sqrt(2) * erf_inv(u)`` with XLA's own
  ``log1p`` and ``erf_inv`` polynomials (:func:`erf_inv`).

The reference the floats are held to is jax 0.9.0 on its CPU backend,
whose LLVM code contracts a multiply feeding an add into one fused
multiply-add. The module rounds those steps once too (:func:`_fma`, exact
arithmetic in plain operations), so a bounded uniform is bitwise that
backend's and a normal within a few ulp of it (the ``log`` above
``log1p``'s rational range is computed in float64, :func:`_log`). Whether
JAX's TPU or GPU backends contract the same steps is not known here: their
bounded uniforms and normals may part from these by an ulp. The bits, unit
uniforms and integers do not depend on it.

The hash is counter-based, so a draw is computed ``chunk`` counters at a
time and gives the same bits: a ``[50, 1332, 1000]`` draw never holds more
than a chunk's int64 words (:data:`CHUNK` on the card, :data:`HOST_CHUNK`
on the CPU, unless the caller names one). JAX's default widths are
float64/int64 under ``jax_enable_x64`` and float32/int32 without it; the
port's counterpart of that flag is ``torch.get_default_dtype()``, which the
samplers take when no dtype is given.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["CHUNK", "HOST_CHUNK", "default_int", "erf_inv", "fold_in",
           "normal", "numpy_dtype", "randint", "random_bits", "seed_key",
           "split", "threefry2x32", "uniform"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

#: counters hashed at a time on the card: ~4 int64 words of 32 MiB each
#: live at once, whatever the draw's size
CHUNK = 1 << 22
#: on the CPU: a chunk's words (2 MiB each) stay in cache, where chunks of
#: CHUNK spent ~4.5x the time in fresh memory
HOST_CHUNK = 1 << 18
# CPU draws of at most this many counters hash through numpy
_HOST_WORDS = 1 << 12


def default_int() -> torch.dtype:
    """JAX's default integer width: int64 where torch's default float is
    float64 (x64 on), int32 where it is float32."""
    return (torch.int64 if torch.get_default_dtype() == torch.float64
            else torch.int32)


def numpy_dtype(dtype: torch.dtype | None = None) -> np.dtype:
    """The numpy dtype of a torch ``dtype``; of torch's default float, JAX's
    default width, where None."""
    dtype = torch.get_default_dtype() if dtype is None else dtype
    return torch.empty((), dtype=dtype).numpy().dtype


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(key, x0, x1):
    """Threefry2x32 of the counter words ``(x0, x1)`` under ``key``: 20
    rounds, a key injection every 4. The words (the key's too) are Python
    ints or int64 arrays (numpy or torch) in ``[0, 2**32)``, broadcast
    together; returns the two hashed words alike."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def seed_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)``: ``(seed >> 32, seed & 0xFFFFFFFF)`` of
    the seed as a 64-bit integer."""
    seed = int(seed)
    return (seed >> 32) & _MASK, seed & _MASK


def fold_in(key: tuple, data) -> tuple:
    """``jax.random.fold_in``: the key's hash of the counter ``(0, data)``
    (``data`` taken as uint32). An integer array of ``data`` folds into a
    batch of keys of its shape."""
    data = (np.asarray(data, np.int64) & _MASK if np.ndim(data)
            else int(data) & _MASK)
    return threefry2x32(key, 0, data)


def split(key: tuple, num: int = 2) -> tuple:
    """``jax.random.split(key, num)`` in the partitionable mode: key ``i``
    is the hash of the counter ``(0, i)``, the keys a tuple."""
    return tuple(threefry2x32(key, 0, i) for i in range(int(num)))


def _words(key: tuple, start: int, stop: int, device):
    """The two hashed words of the flat counters ``[start, stop)``, one row
    a key for a batch of keys: a batch, and a few counters on the CPU,
    through numpy arrays, whose operations cost a fraction of torch's
    dispatch; the rest on ``device``."""
    batch = np.ndim(key[0]) > 0
    if batch or (stop - start <= _HOST_WORDS
                 and torch.device(device).type == "cpu"):
        if batch:
            key = tuple(np.reshape(w, (-1, 1)) for w in key)
        i = np.arange(start, stop, dtype=np.int64)
        return tuple(torch.from_numpy(w).to(device)
                     for w in threefry2x32(key, i >> 32, i & _MASK))
    i = torch.arange(start, stop, dtype=torch.int64, device=device)
    return threefry2x32(key, i >> 32, i & _MASK)


def _draw(key: tuple, shape, dtype, device, chunk, fn) -> torch.Tensor:
    """``fn(bits1, bits2)`` over the flat counters of ``shape``, ``chunk``
    at a time (None: the device's), into a new tensor of ``dtype`` (of the
    key batch's shape and ``shape`` for a batch of keys)."""
    shape = tuple(int(s) for s in shape)
    batch = np.shape(key[0])
    n = math.prod(shape)
    out = torch.empty((math.prod(batch), n), dtype=dtype, device=device)
    if chunk is None:
        chunk = HOST_CHUNK if torch.device(device).type == "cpu" else CHUNK
    step = max(int(chunk), 1)
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        out[:, lo:hi] = fn(*_words(key, lo, hi, device))
    return out.reshape(batch + shape)


def _halves_to_u64(hi, lo):
    """The uint64 ``hi << 32 | lo`` as the int64 of the same bits."""
    return torch.where(hi >= 1 << 31, hi - (1 << 32), hi) * (1 << 32) + lo


def random_bits(key: tuple, width: int, shape, *, device,
                chunk: int | None = None) -> torch.Tensor:
    """``jax.random.bits`` of ``width`` 32 or 64: an int64 tensor, the
    uint32 values for 32 bits, the uint64 bit patterns for 64."""
    if width == 32:
        fn = torch.bitwise_xor
    elif width == 64:
        fn = _halves_to_u64
    else:
        raise ValueError(f"width must be 32 or 64, got {width}")
    return _draw(key, shape, torch.int64, device, chunk, fn)


def _unit(dtype):
    """The draw in ``[0, 1)``: mantissa bits under the exponent of 1.0,
    minus 1 (``jax.random.uniform``'s bit trick)."""
    if dtype == torch.float32:
        def fn(b1, b2):
            bits = ((b1 ^ b2) >> 9) | 0x3F800000
            return bits.to(torch.int32).view(torch.float32) - 1.0
    elif dtype == torch.float64:
        def fn(b1, b2):
            # the top 52 bits of the 64-bit draw b1 << 32 | b2
            bits = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
            return bits.view(torch.float64) - 1.0
    else:
        raise ValueError(f"uniform draws float32 or float64, got {dtype}")
    return fn


def _two_sum(a, b):
    """``(s, e)``: ``s = a + b`` rounded and ``e`` its exact error."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """``(p, e)``: ``p = a * b`` rounded and ``e`` its exact error, float64
    (Dekker's product on Veltkamp's halves, no fused multiply-add)."""
    def halves(x):
        t = x * 134217729.0
        hi = t - (t - x)
        return hi, x - hi

    p = a * b
    ah, al = halves(a)
    bh, bl = halves(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _round_odd(s, e):
    """The float64 sum ``s + e`` (``e`` its exact error) rounded to odd:
    ``s`` where exact or odd, else its neighbour toward ``e``."""
    bits = s.view(torch.int64)
    fix = (e != 0) & ((bits & 1) == 0)
    away = (e > 0) == (s > 0)
    return torch.where(fix, torch.where(away, bits + 1, bits - 1),
                       bits).view(torch.float64)


def _fma(a, b, c):
    """``a * b + c`` with one rounding, as XLA's CPU backend contracts a
    multiply feeding an add: float32 through the exact float64 product and
    a sum rounded to odd; float64 by Boldo and Melquiond's emulation (exact
    product, exact sum with ``c``, the tails rounded to odd). ``b`` and
    ``c`` may be numbers, taken in ``a``'s type."""
    b, c = (torch.as_tensor(v, dtype=a.dtype, device=a.device)
            for v in (b, c))
    if a.dtype == torch.float32:
        s, e = _two_sum(a.double() * b.double(), c.double())
        return _round_odd(s, e).float()
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _round_odd(*_two_sum(tl, ul))


def uniform(key: tuple, shape=(), dtype=None, minval=0.0, maxval=1.0, *,
            device, chunk: int | None = None) -> torch.Tensor:
    """``jax.random.uniform``: ``max(minval, u * (maxval - minval) +
    minval)`` of the unit draw ``u``, in ``dtype`` (the default width if
    None). The multiply-add rounds once, as XLA fuses it; where the span is
    a power of two the product is exact and plain operations give that
    rounding."""
    dtype = torch.get_default_dtype() if dtype is None else dtype
    lo = torch.tensor(minval, dtype=dtype, device=device)
    hi = torch.tensor(maxval, dtype=dtype, device=device)
    span = hi - lo
    unit = _unit(dtype)
    exact = math.frexp(abs(float(span)))[0] == 0.5
    scale = (lambda u: u * span + lo) if exact else (
        lambda u: _fma(u, span, lo))

    def fn(b1, b2):
        return torch.maximum(lo, scale(unit(b1, b2)))

    return _draw(key, shape, dtype, device, chunk, fn)


def randint(key: tuple, shape, minval: int, maxval: int, dtype=None, *,
            device, chunk: int | None = None) -> torch.Tensor:
    """``jax.random.randint`` in ``[minval, maxval)`` for int32 or int64
    (the default width if None): two draws of the type's width under the
    key's split, combined modulo the span. The span must be below 2**31
    (the products then stay inside int64); a 64-bit draw's unsigned modulo
    is taken from its 32-bit halves."""
    dtype = default_int() if dtype is None else dtype
    if dtype not in (torch.int32, torch.int64):
        raise ValueError(f"randint draws int32 or int64, got {dtype}")
    lo, hi = int(minval), int(maxval)
    span = 1 if hi <= lo else hi - lo
    if span >= 1 << 31:
        raise ValueError(f"span {span} of randint must be below 2**31")
    k1, k2 = split(key)
    if dtype == torch.int32:
        # uint32 arithmetic: 2**16 squared wraps to 0 past a span of 2**16
        mult = (1 << 16) % span
        mult = (mult * mult & _MASK) % span

        def part(b1, b2):
            return (b1 ^ b2) % span
    else:
        mult = (1 << 32) % span
        mult = mult * mult % span
        wrap = (1 << 32) % span

        def part(b1, b2):
            return ((b1 % span) * wrap + b2 % span) % span

    higher = _draw(k1, shape, torch.int64, device, chunk, part)
    lower = _draw(k2, shape, torch.int64, device, chunk, part)
    if dtype == torch.int32:
        offset = ((higher * mult) & _MASK) + lower
        offset = (offset & _MASK) % span
    else:
        offset = (higher * mult + lower) % span
    return (offset + lo).to(dtype)


# XLA's log1p: Cephes' rational form below sqrt(2) - 1, log(1 + x) above
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)

# XLA's erf_inv (the `ErfInv32`/`ErfInv64` of its math library): Giles'
# polynomials in w = -log1p(-x*x), highest degree first, each with the
# shift of its argument
_ERFINV32 = (
    ((2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
      0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
      1.50140941), 2.5),
    ((-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
      0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
      2.83297682), 3.0),
)
_ERFINV64 = (
    ((-3.6444120640178196996e-21, -1.685059138182016589e-19,
      1.2858480715256400167e-18, 1.115787767802518096e-17,
      -1.333171662854620906e-16, 2.0972767875968561637e-17,
      6.6376381343583238325e-15, -4.0545662729752068639e-14,
      -8.1519341976054721522e-14, 2.6335093153082322977e-12,
      -1.2975133253453532498e-11, -5.4154120542946279317e-11,
      1.051212273321532285e-09, -4.1126339803469836976e-09,
      -2.9070369957882005086e-08, 4.2347877827932403518e-07,
      -1.3654692000834678645e-06, -1.3882523362786468719e-05,
      0.0001867342080340571352, -0.00074070253416626697512,
      -0.0060336708714301490533, 0.24015818242558961693,
      1.6536545626831027356), 3.125),
    ((2.2137376921775787049e-09, 9.0756561938885390979e-08,
      -2.7517406297064545428e-07, 1.8239629214389227755e-08,
      1.5027403968909827627e-06, -4.013867526981545969e-06,
      2.9234449089955446044e-06, 1.2475304481671778723e-05,
      -4.7318229009055733981e-05, 6.8284851459573175448e-05,
      2.4031110387097893999e-05, -0.0003550375203628474796,
      0.00095328937973738049703, -0.0016882755560235047313,
      0.0024914420961078508066, -0.0037512085075692412107,
      0.005370914553590063617, 1.0052589676941592334,
      3.0838856104922207635), 3.25),
    ((-2.7109920616438573243e-11, -2.5556418169965252055e-10,
      1.5076572693500548083e-09, -3.7894654401267369937e-09,
      7.6157012080783393804e-09, -1.4960026627149240478e-08,
      2.9147953450901080826e-08, -6.7711997758452339498e-08,
      2.2900482228026654717e-07, -9.9298272942317002539e-07,
      4.5260625972231537039e-06, -1.9681778105531670567e-05,
      7.5995277030017761139e-05, -0.00021503011930044477347,
      -0.00013871931833623122026, 1.0103004648645343977,
      4.8499064014085844221), 5.0),
)


def _horner(coeffs, x):
    """The polynomial at ``x``, each step one fused multiply-add."""
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = _fma(p, x, c)
    return p


def _log(y: torch.Tensor) -> torch.Tensor:
    """``log(y)`` in float64, rounded to ``y``'s type: on the CPU through
    numpy's, one thread's arithmetic (torch's CPU ``log`` is MKL's, whose
    worker threads have returned float32 logs ~1500 ulp off on a first
    call), on the card through torch's."""
    wide = y.double()
    if wide.device.type == "cpu":
        with np.errstate(divide="ignore", invalid="ignore"):
            out = torch.from_numpy(np.asarray(np.log(wide.numpy())))
    else:
        out = torch.log(wide)
    return out.to(y.dtype)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's ``log1p``: below ``sqrt(2) - 1`` in magnitude ``x - x**2 / 2 +
    x**3 * P(x) / Q(x)``, its multiply-adds fused; above, ``log(1 + x)``
    (:func:`_log`, which may part from XLA's by an ulp)."""
    x2 = x * x
    ratio = _horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x)
    small = x + _fma(x2, -0.5, (x * x2) * ratio)
    return torch.where(x.abs() < _LOG1P_SMALL, small, _log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's ``erf_inv`` for float32 and float64: the polynomial of each
    branch of ``w = -log1p(-x*x)`` (float32: ``w < 5`` in ``w - 2.5``, else
    ``sqrt(w) - 3``; float64: ``w < 6.25`` in ``w - 3.125``, ``w < 16`` in
    ``sqrt(w) - 3.25``, else ``sqrt(w) - 5``), times ``x``; ``+-1`` map to
    ``+-inf``. Each element takes its own branch's chain of operations, so
    evaluating every branch and selecting is XLA's per-coefficient select;
    the multiply-adds round once, as XLA's CPU backend fuses them."""
    if x.dtype == torch.float32:
        branches, cuts = _ERFINV32, (5.0,)
    elif x.dtype == torch.float64:
        branches, cuts = _ERFINV64, (6.25, 16.0)
    else:
        raise ValueError(f"erf_inv takes float32 or float64, got {x.dtype}")
    w = -_log1p(x * -x)
    root = torch.sqrt(w)
    (c0, s0), *rest = branches
    p = _horner(c0, w - s0)
    for (coeffs, shift), cut in zip(rest, cuts):
        p = torch.where(w < cut, p, _horner(coeffs, root - shift))
    return torch.where(x.abs() == 1, x * float("inf"), p * x)


def normal(key: tuple, shape=(), dtype=None, *, device,
           chunk: int | None = None) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt(2) * erf_inv(u)`` of a uniform on
    ``[nextafter(-1, 0), 1)``, in ``dtype`` (the default width if None)."""
    dtype = torch.get_default_dtype() if dtype is None else dtype
    npt = np.float32 if dtype == torch.float32 else np.float64
    lo = float(np.nextafter(npt(-1.0), npt(0.0)))
    u = uniform(key, shape, dtype, lo, 1.0, device=device, chunk=chunk)
    return float(npt(np.sqrt(2.0))) * erf_inv(u)
