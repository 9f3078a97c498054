"""The port's rounding (repro_torch.core.quantize) against the JAX
package's (repro.core.quantize): bit for bit, f32 and f64 carriers.

Inputs are raw bit patterns made with numpy, so NaN payloads, ±inf, carrier
subnormals and values near the carrier max all occur. One exclusion, the
reference's own (``quantize_to_format``'s docstring): on carrier-SUBNORMAL
inputs XLA's CPU flush-to-zero makes the reference's range handling
inconsistent, so ``quantize_to_format`` is compared on carrier-normal
inputs (plus 0/±inf/NaN); the port rounds subnormals exactly
(:func:`test_port_rounds_carrier_subnormals_onto_the_format_grid`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, st

from repro.core import formats as jformats
from repro.core import quantize as JQ
from repro_torch.core import formats as tformats
from repro_torch.core import quantize as TQ

CARRIERS = {
    "f32": (np.float32, np.uint32, jnp.float32, torch.float32, 24, 126),
    "f64": (np.float64, np.uint64, jnp.float64, torch.float64, 53, 1022),
}


def _from_bits(words, carrier):
    ndt, udt = CARRIERS[carrier][:2]
    return np.asarray(words, dtype=np.uint64).astype(udt).view(ndt)


def _special_values(carrier):
    ndt, udt = CARRIERS[carrier][:2]
    fi = np.finfo(ndt)
    nbits = 8 * np.dtype(ndt).itemsize
    exp_all = (np.uint64(1) << np.uint64(nbits - 1)) - (
        np.uint64(1) << np.uint64(fi.nmant))   # exponent all ones
    payloads = [exp_all | np.uint64(p) for p in
                (1, 2, 3, (1 << fi.nmant) - 1, 1 << (fi.nmant - 1))]
    nans = _from_bits(payloads, carrier)
    vals = np.asarray([0.0, -0.0, np.inf, -np.inf, fi.max, -fi.max,
                       fi.max * 0.9999, np.nextafter(fi.max, 0), 1.0, -1.0,
                       1.5, 2.5, 3.5, fi.tiny, -fi.tiny,
                       fi.tiny * 2 ** -3, fi.smallest_subnormal], ndt)
    return np.concatenate([nans, -nans, vals])


def _bits(a, carrier):
    return np.asarray(a).view(CARRIERS[carrier][1])


def _random_words(rng, n, carrier):
    hi = rng.randint(0, 2 ** 32, n, dtype=np.uint64)
    if carrier == "f32":
        return hi
    lo = rng.randint(0, 2 ** 32, n, dtype=np.uint64)
    return (hi << np.uint64(32)) | lo


def _pair(x, carrier, fn_j, fn_t):
    want = fn_j(jnp.asarray(x))
    got = fn_t(torch.from_numpy(x.copy()))
    return _bits(np.asarray(want), carrier), _bits(got.numpy(), carrier)


def _carrier_normal(x, carrier):
    tiny = np.finfo(CARRIERS[carrier][0]).tiny
    return (np.abs(x) >= tiny) | (x == 0) | ~np.isfinite(x)


@pytest.mark.parametrize("carrier", ["f32", "f64"])
def test_quantize_to_k_fixed_cases_every_k(carrier):
    x = _special_values(carrier)
    x = np.concatenate([x, _from_bits(_random_words(
        np.random.RandomState(0), 512, carrier), carrier)])
    for k in range(1, CARRIERS[carrier][4] + 3):
        want, got = _pair(x, carrier, lambda a: JQ.quantize_to_k(a, k),
                          lambda a: TQ.quantize_to_k(a, k))
        assert np.array_equal(want, got), k
        want, got = _pair(x, carrier, lambda a: JQ._quantize_normal(a, k),
                          lambda a: TQ._quantize_normal(a, k))
        assert np.array_equal(want, got), k


@pytest.mark.parametrize("carrier", ["f32", "f64"])
@given(st.lists(st.integers(0, 2 ** 64 - 1), min_size=1, max_size=64),
       st.integers(1, 55))
def test_property_quantize_to_k_bitwise(carrier, words, k):
    mask = (1 << 32) - 1 if carrier == "f32" else (1 << 64) - 1
    x = _from_bits([w & mask for w in words], carrier)
    want, got = _pair(x, carrier, lambda a: JQ.quantize_to_k(a, k),
                      lambda a: TQ.quantize_to_k(a, k))
    assert np.array_equal(want, got)
    want, got = _pair(x, carrier, lambda a: JQ._quantize_normal(a, k),
                      lambda a: TQ._quantize_normal(a, k))
    assert np.array_equal(want, got)


@pytest.mark.parametrize("carrier", ["f32", "f64"])
def test_pow2_every_exponent(carrier):
    _, _, jdt, tdt, _, _ = CARRIERS[carrier]
    lo, hi = (-160, 140) if carrier == "f32" else (-1090, 1040)
    for e in range(lo, hi):
        want = np.asarray(JQ.pow2(e, jdt))
        got = TQ.pow2(e, tdt).numpy()
        assert want.tobytes() == got.tobytes(), e
    es = np.arange(lo, hi, dtype=np.int32)
    want = np.asarray(JQ.pow2(jnp.asarray(es), jdt))
    got = TQ.pow2(torch.from_numpy(es), tdt).numpy()
    assert want.tobytes() == got.tobytes()


def _fmt_cases():
    zoo = [jformats.BINARY32, jformats.FP16, jformats.BFLOAT16,
           jformats.DLFLOAT16, jformats.FP8_E5M2]
    cases = [(f.k, f.emax, f.emin, f.has_subnormals, f.saturating)
             for f in zoo]
    for k, e in [(2, 2), (5, 4), (8, 4), (12, 5), (16, 6), (24, 8)]:
        f = jformats.from_bits(k, e)
        for subn in (True, False):
            for sat in (True, False):
                cases.append((f.k, f.emax, f.emin, subn, sat))
    return cases


@pytest.mark.parametrize("carrier", ["f32", "f64"])
@pytest.mark.parametrize("fmt", _fmt_cases())
def test_quantize_to_format_fixed_cases(carrier, fmt):
    k, emax, emin, subn, sat = fmt
    rng = np.random.RandomState(k * 100 + emax)
    ndt = CARRIERS[carrier][0]
    with np.errstate(over="ignore"):   # overflow to ±inf is a case too
        scaled = (rng.randn(256) * 10.0 ** rng.uniform(-40, 40, 256)
                  ).astype(ndt)
    x = np.concatenate([_special_values(carrier), scaled,
                        _from_bits(_random_words(rng, 256, carrier),
                                   carrier)])
    x = x[_carrier_normal(x, carrier)]
    want, got = _pair(
        x, carrier,
        lambda a: JQ.quantize_to_format(a, k, emax, emin, subn, sat),
        lambda a: TQ.quantize_to_format(a, k, emax, emin, subn, sat))
    assert np.array_equal(want, got)


@given(st.tuples(st.integers(2, 24), st.integers(2, 8)),
       st.booleans(), st.booleans(), st.integers(0, 10 ** 6))
def test_property_quantize_to_format_bitwise_f32(ke, subn, sat, seed):
    """The format strategy of tests/test_quantize.py, random bit patterns."""
    k, e = ke
    f = jformats.from_bits(k, e)
    rng = np.random.RandomState(seed % 2 ** 31)
    x = np.concatenate([
        _from_bits(_random_words(rng, 128, "f32"), "f32"),
        (rng.randn(128) * 10.0 ** rng.uniform(-35, 35, 128)).astype(
            np.float32)])
    x = x[_carrier_normal(x, "f32")]
    want, got = _pair(
        x, "f32",
        lambda a: JQ.quantize_to_format(a, f.k, f.emax, f.emin, subn, sat),
        lambda a: TQ.quantize_to_format(a, f.k, f.emax, f.emin, subn, sat))
    assert np.array_equal(want, got)


@given(st.tuples(st.integers(2, 53), st.integers(2, 11)),
       st.booleans(), st.integers(0, 10 ** 6))
def test_property_quantize_to_format_bitwise_f64(ke, sat, seed):
    k, e = ke
    f = jformats.from_bits(k, e)
    rng = np.random.RandomState(seed % 2 ** 31)
    x = np.concatenate([
        _from_bits(_random_words(rng, 128, "f64"), "f64"),
        rng.randn(128) * 10.0 ** rng.uniform(-300, 300, 128)])
    x = x[_carrier_normal(x, "f64")]
    want, got = _pair(
        x, "f64",
        lambda a: JQ.quantize_to_format(a, f.k, f.emax, f.emin, True, sat),
        lambda a: TQ.quantize_to_format(a, f.k, f.emax, f.emin, True, sat))
    assert np.array_equal(want, got)


def test_quantize_to_format_max_finite_override():
    f = jformats.FP8_E4M3
    x = np.asarray([460.0, -460.0, 447.0, 500.0, 1e30], np.float32)
    want = JQ.quantize_to_format(jnp.asarray(x), f.k, f.emax, f.emin,
                                 f.has_subnormals, True,
                                 max_finite=f.max_finite)
    got = TQ.quantize_to_format(torch.from_numpy(x), f.k, f.emax, f.emin,
                                f.has_subnormals, True,
                                max_finite=f.max_finite)
    assert np.array_equal(_bits(np.asarray(want), "f32"),
                          _bits(got.numpy(), "f32"))
    assert got[0].item() == 448.0


def test_port_rounds_carrier_subnormals_onto_the_format_grid():
    """Where the reference is excluded, the port still follows the format's
    definition: a carrier subnormal is far below a narrow format's subnormal
    grid (2^-25 for k=12, e[-14, 15]) and rounds to a signed zero; in
    binary32 itself (k=24, e[-126, 127]) it is representable and kept."""
    words = np.random.RandomState(5).randint(1, 1 << 23, 256)
    x = np.concatenate([_from_bits(words, "f32"),
                        -_from_bits(words, "f32")])
    got = TQ.quantize_to_format(torch.from_numpy(x), 12, 15, -14).numpy()
    assert np.all(got == 0.0)
    assert np.array_equal(np.signbit(got), np.signbit(x))
    same = TQ.quantize_to_format(torch.from_numpy(x), 24, 127, -126).numpy()
    assert np.array_equal(_bits(same, "f32"), _bits(x, "f32"))


@pytest.mark.parametrize("fmt", [(12, 15, -14), (8, 7, -6), (24, 127, -126)])
def test_numeric_health_matches(fmt):
    rng = np.random.RandomState(1)
    x = (rng.randn(500) * 10.0 ** rng.uniform(-12, 6, 500)).astype(np.float32)
    x[:3] = [np.nan, np.inf, 0.0]
    want = JQ.numeric_health(jnp.asarray(x), *fmt)
    got = TQ.numeric_health(torch.from_numpy(x), *fmt)
    assert set(want) == set(got)
    for key in want:
        assert float(want[key]) == float(got[key]), key


def test_formats_copy_matches_reference():
    """The port's pure-Python copy of the format zoo is the reference's."""
    assert {n: f.to_dict() for n, f in tformats.REGISTRY.items()} == \
        {n: f.to_dict() for n, f in jformats.REGISTRY.items()}
    for name in ["binary32", "custom_k12", "custom_k8e5", 9]:
        assert tformats.get(name).to_dict() == jformats.get(name).to_dict()
    d = {"name": "x", "k": 7, "emax": 15, "emin": -14, "extra": 1}
    assert tformats.from_dict(d).to_dict() == jformats.from_dict(d).to_dict()
    assert tformats.custom(11).max_finite == jformats.custom(11).max_finite


def test_carrier_must_be_float():
    with pytest.raises(TypeError):
        TQ.quantize_to_k(torch.zeros(3, dtype=torch.int32), 8)
    with pytest.raises(TypeError):
        TQ.quantize_to_format(torch.zeros(3, dtype=torch.bfloat16), 8, 7, -6)
