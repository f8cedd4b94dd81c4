"""dsjax_torch's exact top-k (K6) on CPU tensors against dsjax's.

On the CPU ``ops.topk.topk`` runs its plain version (a stable descending
sort of the scores' total-order keys, cut to k); it must give exactly what
``jax.lax.top_k`` gives: the same values, bit for bit, and the same
indices, ties to the lower index, for k up to and beyond 128, with -0.0
below +0.0 and subnormals in their order. dsjax's Pallas kernel in
interpret mode (as tests/test_topk_pallas.py runs it) gives the same on
ordinary scores, and differs on signed zeros and subnormals, where the port
follows ``jax.lax.top_k``. The kernel itself is held against this plain
version on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dsjax.ops.topk_pallas import topk_pallas
from dsjax_torch.ops import topk


def beam_like(rng, b, n):
    s = rng.standard_normal((b, n)).astype(np.float32)
    s[:, ::7] = np.float32(-1e30)          # the pool's dead-slot ties
    s[:, 1::5] = np.float32(0.5)           # mid-range ties
    return s


def assert_matches(s, k, pallas=True):
    got_v, got_i = topk.topk(torch.from_numpy(s), k)
    assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32
    want_v, want_i = jax.lax.top_k(jnp.asarray(s), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    if pallas:
        pv, pi = topk_pallas(jnp.asarray(s), k, interpret=True)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(pv))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(pi))


@pytest.mark.parametrize("b,n,k", [
    (16, 3840, 128),   # the width-128 beam pool: 128 + 128 * 29
    (20, 300, 10),     # the width-10 pool: 10 + 10 * 29
    (5, 700, 33),      # n not a multiple of 128, k not a power of two
    (9, 129, 64),      # k above half the pool
    (1, 1, 1),
])
def test_matches_lax_top_k_and_pallas(b, n, k, rng):
    assert_matches(beam_like(rng, b, n), k)


@pytest.mark.parametrize("b,n,k", [(4, 7680, 256), (3, 600, 129), (2, 200, 200)])
def test_k_above_128_matches_lax_top_k(b, n, k, rng):
    """dsjax's kernel stops at k = 128; the port's covers any k <= N."""
    assert_matches(beam_like(rng, b, n), k, pallas=False)


@pytest.mark.parametrize("row", ["equal", "ascending", "descending", "dead"])
def test_degenerate_rows(row):
    n = 640
    values = {"equal": np.zeros(n), "ascending": np.arange(n, dtype=np.float64),
              "descending": -np.arange(n, dtype=np.float64),
              "dead": np.full(n, -1e30)}[row]
    s = np.tile(values.astype(np.float32), (4, 1))
    assert_matches(s, 17)
    assert_matches(s, 200, pallas=False)


def test_bad_arguments_raise():
    s = torch.zeros((2, 10))
    for bad in (0, 11):
        with pytest.raises(ValueError, match="k="):
            topk.topk(s, bad)
    with pytest.raises(TypeError, match="float32"):
        topk.topk(s.double(), 3)
    with pytest.raises(ValueError, match=r"\(B, N\)"):
        topk.topk(torch.zeros(10), 3)


# signed zeros, subnormals, -inf and the beam pool's dead-slot score, where
# jax.lax.top_k's total order and a comparison of floats part
EDGE_ROW = [0.0, -0.0, 0.0, -0.0, 1.0, -np.inf, -1e30, 5e-45, -5e-45]
EDGE_POOL = np.array([0.0, -0.0, 5e-45, -5e-45, 1e-40, -1e-40, 1e-38, -1e-38, -np.inf, -1e30,
                      1.0, -1.0], np.float32)


def edge_rows(seed, b, n):
    return np.random.default_rng(seed).choice(EDGE_POOL, (b, n)).astype(np.float32)


@pytest.mark.parametrize("name,k", [("row", 9), ("row", 4), ("pool", 1), ("pool", 64),
                                    ("pool", 300), ("wide pool", 128)])
def test_signed_zeros_and_subnormals_follow_lax_top_k(name, k):
    """Indices equal and values equal bit for bit (-0.0 is not +0.0 here)."""
    s = {"row": np.array([EDGE_ROW] * 3, np.float32), "pool": edge_rows(k, 8, 300),
         "wide pool": edge_rows(7, 4, 3840)}[name]
    got_v, got_i = topk.topk(torch.from_numpy(s), k)
    want_v, want_i = jax.lax.top_k(jnp.asarray(s), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy().view(np.int32), np.asarray(want_v).view(np.int32))


def test_pallas_top_k_differs_from_lax_top_k_on_signed_zeros():
    """The standing note: dsjax's Pallas top-k ties -0.0 with +0.0 and
    flushes subnormals, so it parts from jax.lax.top_k on EDGE_ROW
    (ROADMAP Queue 3); dsjax stays as it is and the port follows lax."""
    s = jnp.asarray(np.array([EDGE_ROW], np.float32))
    _, lax_i = jax.lax.top_k(s, len(EDGE_ROW))
    _, pallas_i = topk_pallas(s, len(EDGE_ROW), interpret=True)
    np.testing.assert_array_equal(np.asarray(lax_i)[0], [4, 7, 0, 2, 1, 3, 8, 6, 5])
    np.testing.assert_array_equal(np.asarray(pallas_i)[0], [4, 0, 1, 2, 3, 7, 8, 6, 5])
    _, port_i = topk.topk(torch.from_numpy(np.asarray(s)), len(EDGE_ROW))
    np.testing.assert_array_equal(port_i.numpy(), np.asarray(lax_i))
