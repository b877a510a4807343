"""The JAX package's initial weights, drawn with numpy.

``run/make_quality.py`` trains its chains from ``model.init(PRNGKey(0),
batch)``: flax draws every param from a key folded out of the root key by
the param's scope path and its place among its scope's params, with JAX's
threefry generator. The port's seeded init (``build_model(seed=...)``)
draws other numbers, and two of the nine chains land on either side of the
record's bars by their init alone, in the JAX package as in the port
(``enhax_torch/quality.py``); to train from the record's own init, this
module draws it without JAX:

  * ``threefry2x32``, ``fold_in``, ``random_bits`` (``jax_threefry_partitionable``:
    the counter is the element's index), ``uniform``, ``normal`` and
    ``truncated_normal`` as ``jax.random`` computes them in float32, with
    XLA's single-precision ``erf_inv`` (Giles' approximation);
  * flax's key of a param: ``fold_in(root, sha1(path..., count)[:4])``,
    ``count`` the param's rank among its scope's params (``Scope.make_rng``);
  * the initializers the quality chains' models use (``INITS``).

Which initializer, key path and shape each param has is model structure the
port does not otherwise hold; ``enhax_torch/convert/jax_init_specs.json``
lists it for the quality chains' models, written by
``tools/gen_jax_init_specs.py`` (which holds every drawn value to JAX's
own). ``jax_init_state_dict`` draws a model's params from it and lays them
out through the weight bridge. Sums and transcendental functions round as
numpy's float32 does, so a value may differ from JAX's by an ulp or two.
"""

from __future__ import annotations

import hashlib
import json
import math
from pathlib import Path

import numpy as np

SPECS = Path(__file__).resolve().parent / "jax_init_specs.json"
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32


def threefry2x32(key: np.ndarray, x1: np.ndarray, x2: np.ndarray) -> tuple:
    """JAX's Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)."""
    k1, k2 = _U32(key[0]), _U32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [x1.astype(_U32) + ks[0], x2.astype(_U32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = (x[1] << _U32(r)) | (x[1] >> _U32(32 - r))
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s key data."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], _U32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the hash of the counter pair (0, data)."""
    a, b = threefry2x32(key, np.array([0], _U32), np.array([data & 0xFFFFFFFF], _U32))
    return np.array([a[0], b[0]], _U32)


def random_bits(key: np.ndarray, shape: tuple) -> np.ndarray:
    """32 random bits an element, the partitionable way: element i hashes the
    counter pair (i >> 32, i & 0xFFFFFFFF) and XORs the two words."""
    n = math.prod(shape)
    idx = np.arange(n, dtype=np.uint64)
    b1, b2 = threefry2x32(key, (idx >> np.uint64(32)).astype(_U32),
                          (idx & np.uint64(0xFFFFFFFF)).astype(_U32))
    return (b1 ^ b2).reshape(shape)


def uniform(key: np.ndarray, shape: tuple, minval=0.0, maxval=1.0) -> np.ndarray:
    """float32 in [minval, maxval): the mantissa from the bits, as JAX."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> _U32(9)) | np.array(1.0, np.float32).view(_U32)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, floats * (hi - lo) + lo).astype(np.float32)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 inverse error function (Giles' approximation)."""
    x = x.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(-x * x).astype(np.float32)
    small = w < np.float32(5.0)
    ws = (w - np.float32(2.5)).astype(np.float32)
    wl = (np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    ps = np.full_like(x, 2.81022636e-08)
    for c in (3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
              -0.00125372503, -0.00417768164, 0.246640727, 1.50140941):
        ps = (np.float32(c) + ps * ws).astype(np.float32)
    pl = np.full_like(x, -0.000200214257)
    for c in (0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
              -0.0076224613, 0.00943887047, 1.00167406, 2.83297682):
        pl = (np.float32(c) + pl * wl).astype(np.float32)
    out = (np.where(small, ps, pl) * x).astype(np.float32)
    return np.where(np.abs(x) == 1, np.copysign(np.float32(np.inf), x), out).astype(np.float32)


def normal(key: np.ndarray, shape: tuple) -> np.ndarray:
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(math.sqrt(2)) * erf_inv(u)).astype(np.float32)


def truncated_normal(key: np.ndarray, lower: float, upper: float, shape: tuple) -> np.ndarray:
    sqrt2 = np.float32(math.sqrt(2))
    lo, hi = np.float32(lower), np.float32(upper)
    a, b = np.float32(math.erf(lo / sqrt2)), np.float32(math.erf(hi / sqrt2))
    out = (sqrt2 * erf_inv(uniform(key, shape, a, b))).astype(np.float32)
    return np.clip(out, np.nextafter(lo, np.float32(np.inf)),
                   np.nextafter(hi, np.float32(-np.inf))).astype(np.float32)


def flax_param_key(root: np.ndarray, path: tuple, count: int) -> np.ndarray:
    """The key flax hands a param's initializer: the root folded once with
    the first 4 bytes of the SHA-1 of the scope names and the param's count
    (1 for its scope's first param)."""
    m = hashlib.sha1()
    for x in (*path, count):
        m.update(x.encode() if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return fold_in(root, int.from_bytes(m.digest()[:4], byteorder="big"))


def lecun_normal(key: np.ndarray, shape: tuple) -> np.ndarray:
    """flax's default kernel init: a normal truncated at +-2 sigma with
    variance 1/fan_in, fan_in every axis but the last."""
    fan_in = math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
    std = np.float32(math.sqrt(1.0 / fan_in) / 0.87962566103423978)
    return (truncated_normal(key, -2, 2, shape) * std).astype(np.float32)


# name -> (args) -> initializer(key, shape): those of the quality chains' models
INITS = {
    "zeros": lambda: lambda key, shape: np.zeros(shape, np.float32),
    "ones": lambda: lambda key, shape: np.ones(shape, np.float32),
    "lecun_normal": lambda: lecun_normal,
    "normal": lambda std: lambda key, shape: (normal(key, shape) * np.float32(std)).astype(
        np.float32),
    "uniform": lambda lo, hi: lambda key, shape: uniform(key, shape, lo, hi),
}


def draw(spec: list, seed: int = 0) -> dict:
    """Flat params ``{"params/a/b/kernel": array}`` from a spec: rows of
    (path, count, init name, init args, shape)."""
    root = prng_key(seed)
    out = {}
    for path, count, name, args, shape in spec:
        key = flax_param_key(root, tuple(path[:-1]), count)
        out["params/" + "/".join(path)] = INITS[name](*args)(key, tuple(shape))
    return out


def load_spec(chain: str) -> dict:
    """A quality chain's entry of ``jax_init_specs.json``: model, model_cfg,
    example shape and the params' rows."""
    specs = json.loads(SPECS.read_text())
    if chain not in specs:
        raise KeyError(f"no JAX init spec for {chain!r}: tools/gen_jax_init_specs.py writes "
                       f"them ({sorted(specs)})")
    return specs[chain]


def jax_init_state_dict(chain: str, seed: int = 0) -> dict:
    """The JAX package's ``model.init(PRNGKey(seed), ...)`` of a quality
    chain's model, as the port's state dict (through the weight bridge)."""
    from enhax_torch.convert.from_jax import jax_to_torch_state_dict
    spec = load_spec(chain)
    return jax_to_torch_state_dict(spec["model"], draw(spec["params"], seed))
