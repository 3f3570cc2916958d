"""The port's sampling (``repro_torch.launch.prng`` / ``sampling``) held
to the JAX package's on the CPU.

  * the PRNG bit for bit: ``PRNGKey``, ``fold_in``, ``request_key``,
    32-bit random bits (the partitionable threefry layout of jax 0.9) and
    ``uniform`` — over seeds, data words and shapes, odd sizes, sizes
    past 2^16 and vocabulary-sized rows; Gumbel noise within one ulp
    (``log`` rounds differently) and ``categorical``'s draws equal;
  * ``sample_tokens`` / ``sample_token_block`` give JAX's tokens on
    random logits under temperature only, top-k, top-p and both, for
    mixed greedy and sampled rows (``merge_rows``) and scalar or per-row
    positions; temperature 0 and top-k 1 are bit-identical to greedy;
    ``SamplingParams`` validates as JAX's does (``tests/test_sampling.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.launch import sampling as jsamp
from repro_torch.launch import prng
from repro_torch.launch import sampling as tsamp

SEEDS = st.integers(min_value=-2**31, max_value=2**40)
WORDS = st.integers(min_value=0, max_value=2**32 - 1)
HYP = settings(max_examples=25, deadline=None)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


@HYP
@given(seed=SEEDS)
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(_np(prng.prng_key(seed)),
                                  np.asarray(_jkey(seed)))


@HYP
@given(seed=SEEDS, data=WORDS)
def test_fold_in_matches_jax(seed, data):
    want = np.asarray(jax.random.fold_in(_jkey(seed), data))
    np.testing.assert_array_equal(_np(prng.fold_in(prng.prng_key(seed),
                                                   data)), want)


def test_fold_in_batched_rows_match_jax():
    """A (B, 2) batch of keys folded with per-row data is vmap of JAX's
    fold_in; int32 positions wrap to uint32 as JAX's conversion does."""
    seeds = np.asarray([0, 7, 11, 2**31 - 1])
    data = np.asarray([0, 1, 4096, 2**31 - 1], np.int32)
    keys = jnp.stack([_jkey(int(s)) for s in seeds])
    want = np.asarray(jax.vmap(jax.random.fold_in)(keys, jnp.asarray(data)))
    mine = torch.stack([prng.prng_key(int(s)) for s in seeds])
    np.testing.assert_array_equal(
        _np(prng.fold_in(mine, torch.from_numpy(data))), want)


@HYP
@given(seed=st.integers(0, 2**31 - 1), row=st.integers(0, 1024))
def test_request_key_matches_jax(seed, row):
    np.testing.assert_array_equal(_np(tsamp.request_key(seed, row)),
                                  np.asarray(jsamp.request_key(seed, row)))


# odd sizes, sizes past 2^16, multi-axis shapes, vocabulary-sized rows
BIT_SHAPES = [(1,), (7,), (512,), (3, 5), (2, 3, 7), (65537,), (256000,)]


@pytest.mark.parametrize("shape", BIT_SHAPES, ids=str)
def test_random_bits_match_jax(shape):
    key = jax.random.fold_in(_jkey(11), 5)
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    mine = prng.random_bits(prng.fold_in(prng.prng_key(11), 5), shape)
    assert mine.shape == shape
    np.testing.assert_array_equal(_np(mine), want)


@HYP
@given(seed=SEEDS, data=WORDS, n=st.integers(1, 3000))
def test_random_bits_match_jax_over_keys(seed, data, n):
    key = jax.random.fold_in(_jkey(seed), data)
    want = np.asarray(jax.random.bits(key, (n,), jnp.uint32))
    mine = prng.random_bits(prng.fold_in(prng.prng_key(seed), data), (n,))
    np.testing.assert_array_equal(_np(mine), want)


@pytest.mark.parametrize("shape", BIT_SHAPES, ids=str)
def test_uniform_is_bit_exact(shape):
    key = jax.random.fold_in(_jkey(3), 99)
    want = np.asarray(jax.random.uniform(key, shape))
    mine = prng.uniform(prng.fold_in(prng.prng_key(3), 99), shape).numpy()
    np.testing.assert_array_equal(mine.view(np.uint32), want.view(np.uint32))
    tiny = float(jnp.finfo(jnp.float32).tiny)
    want = np.asarray(jax.random.uniform(key, shape, minval=tiny))
    mine = prng.uniform(prng.fold_in(prng.prng_key(3), 99), shape,
                        minval=tiny).numpy()
    np.testing.assert_array_equal(mine.view(np.uint32), want.view(np.uint32))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in units in the last place between fp32 arrays of one
    sign."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("shape", [(512,), (65537,), (256000,)], ids=str)
def test_gumbel_within_one_ulp(shape):
    """g = -log(-log(u)) on JAX's bit-exact u: each ``log`` is within
    one ulp of XLA's, so g is within one ulp of JAX's plus the inner
    log's ulp carried through (eps absolute: d(-log(-l)) = dl / l)."""
    key = jax.random.fold_in(_jkey(5), 17)
    tiny = float(jnp.finfo(jnp.float32).tiny)
    u = np.asarray(jax.random.uniform(key, shape, minval=tiny))
    inner = torch.log(torch.from_numpy(u.copy())).numpy()
    assert _ulps(inner, np.asarray(jnp.log(u))).max() <= 1
    want = np.asarray(jax.random.gumbel(key, shape))
    mine = prng.gumbel(prng.fold_in(prng.prng_key(5), 17), shape).numpy()
    tol = np.spacing(np.abs(want)) + np.finfo(np.float32).eps
    assert np.all(np.abs(mine - want) <= tol)


def test_categorical_matches_jax():
    """vmap of ``jax.random.categorical`` over rows, with -inf entries
    (the truncation masks) in the logits."""
    rng = np.random.RandomState(0)
    logits = (rng.randn(64, 512) * 2).astype(np.float32)
    logits[:, ::3] = -np.inf
    keys = jnp.stack([jax.random.fold_in(_jkey(9), r) for r in range(64)])
    want = np.asarray(jax.vmap(jax.random.categorical)(
        keys, jnp.asarray(logits)))
    mine = prng.categorical(
        prng.fold_in(prng.prng_key(9).expand(64, 2), torch.arange(64)),
        torch.from_numpy(logits))
    np.testing.assert_array_equal(mine.numpy(), want)


# ---------------------------------------------------------------------------
# The sampling rule
# ---------------------------------------------------------------------------

MODES = {
    "temperature": dict(temperature=0.8),
    "top_k": dict(temperature=1.1, top_k=20),
    "top_p": dict(temperature=0.9, top_p=0.9),
    "top_k_top_p": dict(temperature=0.9, top_k=50, top_p=0.95),
}


def _logits(seed, b=6, v=512):
    return (np.random.RandomState(seed).randn(b, v) * 3).astype(np.float32)


def _both(**kw):
    return jsamp.SamplingParams(**kw), tsamp.SamplingParams(**kw)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "rows"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_sample_tokens_match_jax(mode, per_row):
    for trial in range(4):
        jsp, tsp = _both(seed=trial, **MODES[mode])
        logits = _logits(trial)
        b = logits.shape[0]
        pos = (np.random.RandomState(100 + trial).randint(0, 500, b)
               .astype(np.int32) if per_row else 37 + trial)
        want = np.asarray(jsamp.sample_tokens(
            jnp.asarray(logits), jsamp.sample_state(jsp, b),
            jnp.asarray(pos)))
        got = tsamp.sample_tokens(
            torch.from_numpy(logits), tsamp.sample_state(tsp, b, "cpu"),
            torch.from_numpy(pos) if per_row else pos)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=mode)


def test_sample_state_matches_jax():
    for kw in MODES.values():
        jsp, tsp = _both(seed=5, **kw)
        want = jsamp.sample_state(jsp, 3)
        got = tsamp.sample_state(tsp, 3, "cpu")
        assert set(got) == set(want)
        np.testing.assert_array_equal(_np(got["key"]),
                                      np.asarray(want["key"]))
        for name in set(got) - {"key"}:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))


def test_merge_rows_mixed_greedy_and_sampled_match_jax():
    """The scheduler's per-slot state: greedy rows at temperature 0 with
    the no-op truncation values, sampled rows with their own seeds."""
    params = [None, dict(temperature=0.7, top_k=10, seed=1), None,
              dict(temperature=1.2, top_p=0.8, seed=2),
              dict(temperature=0.5, seed=3), None]
    jrows, trows = [], []
    for p in params:
        if p is None:
            jrows.append((np.zeros((2,), np.uint32), None))
            trows.append((torch.zeros((2,), dtype=torch.int64), None))
        else:
            jsp, tsp = _both(**p)
            jrows.append((np.asarray(jsamp.request_key(p["seed"])), jsp))
            trows.append((tsamp.request_key(p["seed"]), tsp))
    jstate = jsamp.merge_rows(jrows)
    tstate = tsamp.merge_rows(trows, "cpu")
    assert set(tstate) == set(jstate)
    for name in set(tstate) - {"key"}:
        np.testing.assert_array_equal(tstate[name].numpy(),
                                      np.asarray(jstate[name]))
    logits = _logits(7, b=len(params))
    pos = np.arange(len(params), dtype=np.int32) * 13 + 5
    want = np.asarray(jsamp.sample_tokens(jnp.asarray(logits), jstate,
                                          jnp.asarray(pos)))
    got = tsamp.sample_tokens(torch.from_numpy(logits), tstate,
                              torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want)
    greedy = np.argmax(logits, -1)
    for i, p in enumerate(params):
        if p is None:
            assert got[i] == greedy[i]


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "rows"])
def test_sample_token_block_matches_jax(per_row):
    """The verifier's rule: offset i of a chunk keyed at pos + 1 + i."""
    jsp, tsp = _both(seed=4, **MODES["top_k_top_p"])
    rng = np.random.RandomState(8)
    logits = (rng.randn(3, 5, 512) * 3).astype(np.float32)
    pos = rng.randint(0, 100, 3).astype(np.int32) if per_row else 21
    want = np.asarray(jsamp.sample_token_block(
        jnp.asarray(logits), jsamp.sample_state(jsp, 3), jnp.asarray(pos)))
    got = tsamp.sample_token_block(
        torch.from_numpy(logits), tsamp.sample_state(tsp, 3, "cpu"),
        torch.from_numpy(pos) if per_row else pos)
    np.testing.assert_array_equal(got.numpy(), want)
    # the block's column i is single-token sampling at pos + 1 + i
    col = tsamp.sample_tokens(torch.from_numpy(logits[:, 2]),
                              tsamp.sample_state(tsp, 3, "cpu"),
                              (torch.from_numpy(pos) if per_row else pos)
                              + 3)
    np.testing.assert_array_equal(got[:, 2].numpy(), col.numpy())


def test_temperature_zero_and_top_k_one_are_greedy():
    """Bitwise: temperature 0 takes the argmax branch; top-k 1 keeps
    only the argmax at any temperature (ties: first index, as
    ``jnp.argmax``)."""
    logits = _logits(2)
    logits[0, 10] = logits[0, 20] = logits[0].max() + 1.0   # a tie
    t = torch.from_numpy(logits)
    greedy = tsamp.sample_tokens(t, None, 0)
    assert greedy[0] == 10
    for sp in (tsamp.SamplingParams(temperature=0.0, seed=3),
               tsamp.SamplingParams(temperature=0.0, top_k=5, top_p=0.5),
               tsamp.SamplingParams(temperature=5.0, top_k=1, seed=9)):
        got = tsamp.sample_tokens(t, tsamp.sample_state(sp, t.shape[0],
                                                        "cpu"), 17)
        np.testing.assert_array_equal(got.numpy(), greedy.numpy())
    np.testing.assert_array_equal(greedy.numpy(),
                                  np.argmax(logits, -1).astype(np.int32))


def test_sampled_streams_depend_on_seed_and_position():
    logits = torch.from_numpy(_logits(3, b=2, v=64) * 0.1)
    sp = tsamp.SamplingParams(temperature=1.5, seed=1)
    a = [tsamp.sample_tokens(logits, tsamp.sample_state(sp, 2, "cpu"), p)
         for p in range(16)]
    b = [tsamp.sample_tokens(logits, tsamp.sample_state(sp, 2, "cpu"), p)
         for p in range(16)]
    c = [tsamp.sample_tokens(logits, tsamp.sample_state(
        dataclasses.replace(sp, seed=2), 2, "cpu"), p) for p in range(16)]
    a, b, c = (torch.stack(x).numpy() for x in (a, b, c))
    np.testing.assert_array_equal(a, b)
    assert not (a == c).all()
    assert len(set(a[:, 0].tolist())) > 1     # positions key the draws
    assert not (a[:, 0] == a[:, 1]).all()     # rows get their own streams


def test_sampling_params_validation():
    for cls in (jsamp.SamplingParams, tsamp.SamplingParams):
        with pytest.raises(ValueError, match="temperature"):
            cls(temperature=-0.1)
        with pytest.raises(ValueError, match="top_k"):
            cls(top_k=0)
        with pytest.raises(ValueError, match="top_p"):
            cls(top_p=0.0)
        with pytest.raises(ValueError, match="top_p"):
            cls(top_p=1.5)
        cls(temperature=0.0, top_k=1, top_p=1.0)    # boundary values ok
