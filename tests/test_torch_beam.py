"""dsjax_torch's device beam search (without LM) against dsjax's, on the CPU.

The same numpy log-probabilities go through dsjax's ``_beam_scan`` (its
XLA scan, ``lax.top_k``) and the port's (the plain top-k on CPU tensors).
Backpointers, emitted chars and the h1/h2 hash histories must be equal
exactly; totals and the float half of the carry within atol 1e-5 (XLA's
and torch's CPU exp/log1p differ in the last ulp: measured up to 9.5e-7).
The plain version of K7 is held against dsjax's Pallas kernel in interpret
mode at T <= 12, B <= 2, W <= 8 (interpret mode is slow), also on a pool of
signed zeros and exact ties and followed by the backtrack; the backtrack's
plain version against dsjax's exactly, and K7's selection key against its
float order. The decoders are
compared on strings, offsets (emission frames and ctcdecode-parity
timesteps) and scores, and streaming against the one-shot decode; the
no-LM groups of tests/test_beam_fuzz.py run at a reduced case count.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dsjax.decode.beam_device import DeviceBeamDecoder as JaxBeamDecoder
from dsjax.decode.beam_device import _backtrack as jax_backtrack
from dsjax.decode.beam_device import _beam_scan as jax_beam_scan
from dsjax.ops.beam_pallas import fused_beam_scan as jax_fused_beam_scan
from dsjax_torch.decode.beam_device import DeviceBeamDecoder, _backtrack, _beam_scan
from dsjax_torch.labels import DEFAULT_LABELS
from dsjax_torch.ops import beam
from tests.test_beam_fuzz import _adversarial_probs

TOTAL_ATOL = 1e-5
FUZZ_CASES = 40          # per group; tests/test_beam_fuzz.py runs 100


def posteriors(rng, b, t, c, ties=True):
    logits = rng.standard_normal((b, t, c)) * 3.0
    e = np.exp(logits - logits.max(-1, keepdims=True))
    p = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    if ties:      # clipped flat frames force heavy score ties
        p[0, : t // 2] = np.maximum(p[0, : t // 2], 1e-30)
    return p


def ragged(b, t):
    sizes = np.full(b, t, np.int32)
    sizes[0] = max(1, t - 3)
    if b > 1:
        sizes[1] = 0
    if b > 2:
        sizes[2] = 1
    return sizes


def assert_scan_equal(got, want):
    """got: the port's outputs (torch), want: dsjax's (jax arrays)."""
    for name, g, w in (("backptr", got[0], want[0]), ("emit", got[1], want[1]),
                       ("h1", got[2][0], want[2][0]), ("h2", got[2][1], want[2][1])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=TOTAL_ATOL, rtol=0)
    for i, (g, w) in enumerate(zip(got[4], want[4][0])):
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"carry[{i}]")
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOTAL_ATOL, rtol=0)


@pytest.mark.parametrize("b,t,c,w,blank,top_n,cprob", [
    (3, 12, 5, 8, 0, 10 ** 9, 1.0),     # merges, dead slots, ragged sizes
    (2, 30, 29, 16, 0, 10 ** 9, 1.0),   # the full label set
    (1, 7, 4, 128, 0, 10 ** 9, 1.0),    # exhaustive width: every prefix merges
    (4, 20, 29, 10, 0, 10 ** 9, 1.0),   # the reference's default width
    (2, 25, 6, 32, 2, 10 ** 9, 1.0),    # a nonzero blank index
    (3, 15, 6, 8, 0, 3, 1.0),           # pruning by cutoff_top_n < C
    (3, 15, 6, 8, 0, 10 ** 9, 0.8),     # pruning by cutoff_prob < 1
    (3, 15, 29, 12, 1, 5, 0.9),         # both
])
def test_scan_matches_dsjax(b, t, c, w, blank, top_n, cprob, rng):
    lp = np.log(np.maximum(posteriors(rng, b, t, c), 1e-30))
    sizes = ragged(b, t)
    want = jax_beam_scan(jnp.asarray(lp), jnp.asarray(sizes), w, blank,
                         cutoff_top_n=top_n, cutoff_prob=cprob)
    got = _beam_scan(torch.from_numpy(lp), torch.from_numpy(sizes), w, blank,
                     cutoff_top_n=top_n, cutoff_prob=cprob)
    assert_scan_equal(got, want)


@pytest.mark.parametrize("top_n", [10 ** 9, 3])
def test_resumed_carry_matches_dsjax(top_n, rng):
    """Chunk by chunk from a carried state: equal to dsjax resuming from its
    own carry, also when the port resumes from dsjax's carry."""
    b, t, c, w = 2, 16, 6, 12
    lp = np.log(np.maximum(posteriors(rng, b, t, c, ties=False), 1e-30))
    sizes = np.full(b, t // 2, np.int32)
    first_j = jax_beam_scan(jnp.asarray(lp[:, :t // 2]), jnp.asarray(sizes), w, 0,
                            cutoff_top_n=top_n)
    first_t = _beam_scan(torch.from_numpy(lp[:, :t // 2]), torch.from_numpy(sizes), w, 0,
                         cutoff_top_n=top_n)
    assert_scan_equal(first_t, first_j)
    want = jax_beam_scan(jnp.asarray(lp[:, t // 2:]), jnp.asarray(sizes), w, 0,
                         cutoff_top_n=top_n, carry0=first_j[4])
    for carry in (first_t[4], tuple(torch.from_numpy(np.array(a)) for a in first_j[4][0])):
        got = _beam_scan(torch.from_numpy(lp[:, t // 2:]), torch.from_numpy(sizes), w, 0,
                         cutoff_top_n=top_n, carry0=carry)
        assert_scan_equal(got, want)


def test_hashes_wrap_like_dsjax():
    """A peaked path of 12 distinct emissions overflows the int32 prefix
    hashes several times; the port's best beam holds the mod-2^32 value
    that dsjax's does."""
    labels = 6
    seq = [1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 1, 2]
    p = np.full((1, len(seq), labels), 0.01, np.float32)
    for i, c in enumerate(seq):
        p[0, i, c] = 0.95
    lp = np.log(p)
    sizes = np.array([len(seq)], np.int32)
    got = _beam_scan(torch.from_numpy(lp), torch.from_numpy(sizes), 4, 0)
    want = jax_beam_scan(jnp.asarray(lp), jnp.asarray(sizes), 4, 0)
    assert_scan_equal(got, want)
    h1, h2 = 1, 1
    for c in seq:
        h1 = (h1 * 1000003 + c + 1) & 0xFFFFFFFF
        h2 = (h2 * 10007 + c + 1) & 0xFFFFFFFF
    as_i32 = lambda h: h - (1 << 32) if h >= 1 << 31 else h
    best = int(torch.argmax(got[3][0]))
    assert (int(got[4][3][0, best]), int(got[4][4][0, best])) == (as_i32(h1), as_i32(h2))
    assert h1 != 1 + sum(seq)  # it did wrap


@pytest.mark.parametrize("b,t,c,w,blank,resume", [(2, 12, 5, 8, 0, True), (1, 9, 4, 8, 2, False),
                                                  (2, 10, 6, 3, 0, False)])
def test_fused_plain_version_matches_pallas_kernel(b, t, c, w, blank, resume, rng):
    """K7's plain version (the port's fused_beam_scan on CPU tensors)
    against dsjax's fused kernel in interpret mode, and once a resume."""
    lp = np.log(np.maximum(posteriors(rng, b, t, c), 1e-30))
    sizes = np.full(b, t, np.int32)
    sizes[0] = t - 3
    want = jax_fused_beam_scan(jnp.asarray(lp), jnp.asarray(sizes), w, blank, interpret=True)
    got = beam.fused_beam_scan(torch.from_numpy(lp), torch.from_numpy(sizes), w, blank)
    assert beam.LAUNCHES == 0
    assert_scan_equal(got[:5], want)
    order = torch.from_numpy(np.argsort(-np.asarray(want[3]), axis=1, kind="stable"))
    assert torch.equal(got[5][1].long(), order)
    if not resume:
        return
    half = t // 2
    first = jax_beam_scan(jnp.asarray(lp[:, :half]), jnp.asarray(sizes), w, blank)
    want2 = jax_fused_beam_scan(jnp.asarray(lp[:, half:]), jnp.asarray(sizes - half), w, blank,
                                carry0=first[4], interpret=True)
    carry = tuple(torch.from_numpy(np.array(a)) for a in first[4][0])
    got2 = beam.fused_beam_scan(torch.from_numpy(lp[:, half:]), torch.from_numpy(sizes - half),
                                w, blank, carry0=carry)
    assert_scan_equal(got2[:5], want2)


LABELS6 = ["_", "'", "A", "B", "C", " "]


@pytest.mark.parametrize("ctc_offsets", [False, True])
@pytest.mark.parametrize("top_n,cprob", [(10 ** 9, 1.0), (3, 1.0), (10 ** 9, 0.9)])
def test_decoder_matches_dsjax(ctc_offsets, top_n, cprob, rng):
    """Strings, offsets and scores of every hypothesis, n_best above the
    width (both clamp to the width) and below it."""
    probs = posteriors(rng, 4, 14, len(LABELS6))
    sizes = np.array([14, 9, 1, 0], np.int32)
    kw = dict(beam_width=8, cutoff_top_n=top_n, cutoff_prob=cprob, ctc_offsets=ctc_offsets)
    port, ref = DeviceBeamDecoder(LABELS6, **kw), JaxBeamDecoder(LABELS6, **kw)
    for n_best in (20, 3):
        got = port.decode(probs, sizes, n_best=n_best, with_scores=True)
        want = ref.decode(probs, sizes, n_best=n_best, with_scores=True)
        assert got[0] == want[0]
        assert len(got[0][0]) == min(n_best, 8)
        for a, b in zip(got[1], want[1]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
                assert x.dtype == y.dtype
        np.testing.assert_allclose(got[2], want[2], atol=TOTAL_ATOL, rtol=0)
    # all beams by default, and torch tensors in
    got = port.decode(torch.from_numpy(probs), torch.from_numpy(sizes))
    assert got[0] == ref.decode(probs, sizes)[0]


def test_streaming_matches_one_shot_and_dsjax(rng):
    probs = posteriors(rng, 1, 24, len(DEFAULT_LABELS), ties=False)
    port = DeviceBeamDecoder(DEFAULT_LABELS, beam_width=6)
    ref = JaxBeamDecoder(DEFAULT_LABELS, beam_width=6)
    state = ref_state = None
    for lo, hi in ((0, 7), (7, 8), (8, 24)):
        text, state = port.decode_chunk(probs[:, lo:hi], state)
        ref_text, ref_state = ref.decode_chunk(probs[:, lo:hi], ref_state)
        assert text == ref_text and state.strings == ref_state.strings
    assert text == port.decode(probs)[0][0][0]


@pytest.mark.parametrize("seed,top_n,cprob", [
    (100, 10 ** 9, 1.0), (101, 3, 1.0), (102, 10 ** 9, 0.85), (103, 2, 0.6)])
def test_fuzz_no_lm_groups_match_dsjax(seed, top_n, cprob):
    """tests/test_beam_fuzz.py:185-199's no-LM groups (C=4, W=128, T=4,
    adversarial posteriors, sizes 0 and 1 included; the same seeds) at
    FUZZ_CASES cases a group: strings, ctcdecode offsets and scores equal
    to dsjax's DeviceBeamDecoder(ctc_offsets=True)."""
    labels4 = ["_", "A", "B", " "]
    rng = np.random.default_rng(seed)
    probs = np.stack([_adversarial_probs(rng, 4, 4, 3) for _ in range(FUZZ_CASES)])
    sizes = rng.integers(0, 5, size=FUZZ_CASES).astype(np.int32)
    sizes[0], sizes[1] = 0, 1
    sizes[2:] = np.maximum(sizes[2:], 2)
    kw = dict(beam_width=128, ctc_offsets=True, cutoff_top_n=top_n, cutoff_prob=cprob)
    got = DeviceBeamDecoder(labels4, **kw).decode(probs, sizes, n_best=1, with_scores=True)
    want = JaxBeamDecoder(labels4, **kw).decode(probs, sizes, n_best=1, with_scores=True)
    assert got[0] == want[0]
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        np.testing.assert_array_equal(a[0], b[0], err_msg=f"case {i} size {sizes[i]}")
    np.testing.assert_allclose(got[2], want[2], atol=TOTAL_ATOL, rtol=0)


def test_fused_route_needs_cuda_tensors(monkeypatch, rng):
    """DSJAX_FUSED_BEAM=1 is read on every decode and takes K7 only for
    CUDA posteriors; on CPU tensors the fused scan is its plain version,
    equal to the scan."""
    monkeypatch.setenv("DSJAX_FUSED_BEAM", "1")
    dec = DeviceBeamDecoder(DEFAULT_LABELS, beam_width=8)
    lp = torch.from_numpy(np.log(posteriors(rng, 2, 9, len(DEFAULT_LABELS))))
    assert not dec._fused_ok(lp)
    sizes = torch.tensor([9, 4], dtype=torch.int32)
    a = _beam_scan(lp, sizes, 8, 0, fused=True)
    b = _beam_scan(lp, sizes, 8, 0)
    for x, y in zip(a[:2] + a[2] + (a[3],) + a[4], b[:2] + b[2] + (b[3],) + b[4]):
        assert torch.equal(x, y)
    assert beam.LAUNCHES == 0


@pytest.mark.parametrize("t", [0, 1, 577])
def test_backtrack_matches_dsjax(t, rng):
    """The backtrack's plain version (and the wrapper on CPU tensors)
    against dsjax's _backtrack on seeded pointers: chars and start slots
    exactly equal, T = 0 and 1 included; 577 frames as an evaluation batch."""
    b, w, k = 5, 10, 4
    backptr = rng.integers(0, w, (t, b, w)).astype(np.int32)
    emit = rng.integers(-1, 29, (t, b, w)).astype(np.int32)
    order = rng.integers(0, w, (b, k)).astype(np.int32)
    want = jax_backtrack(jnp.asarray(backptr), jnp.asarray(emit), jnp.asarray(order))
    args = (torch.from_numpy(backptr), torch.from_numpy(emit), torch.from_numpy(order))
    for got in (_backtrack(*args), beam.backtrack(*args)):
        assert got[0].dtype == torch.int16 and got[1].dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert beam.BACKTRACK_LAUNCHES == 0


def signed_zero_problem(rng, b, t, c, w):
    """Log-probs of 0.0, -0.0, -1 and -2 only (blank 0), and a carry whose
    live slots hold p_b = -0.0 with distinct last chars (slot q's is q + 1)
    and prefixes no slot extends: in the first frame the stays score -1
    and every extend +0.0 but slot 0's by its last char, -0.0 + -0.0 =
    -0.0, first in pool order (tests/test_torch_cuda.py builds the same)."""
    lp = rng.choice(np.array([0.0, -0.0, -1.0, -2.0], np.float32), (b, t, c))
    lp[:, 0, 0] = -1.0
    lp[:, 0, 1:] = rng.choice(np.array([0.0, -0.0], np.float32), (b, c - 1))
    lp[:, 0, 1] = -0.0
    live = min(w, c - 1)
    slot = np.arange(w, dtype=np.int32)
    sentinel = -(slot + 2)
    p_b = np.full((b, w), -1e30, np.float32)
    p_b[:, :live] = -0.0
    ints = [np.where(slot < live, a, sentinel).astype(np.int32)
            for a in (7 * slot + 11, 13 * slot + 5, 7 * slot + 100014, 13 * slot + 100024)]
    last = np.where(slot < live, slot % (c - 1) + 1, -1).astype(np.int32)
    carry = (p_b, np.full((b, w), -1e30, np.float32)) + tuple(
        np.ascontiguousarray(np.broadcast_to(a, (b, w))) for a in [last] + ints)
    return lp, carry


@pytest.mark.parametrize("w", [3, 4])
def test_fused_plain_version_and_backtrack_match_pallas_on_signed_zeros(w, rng):
    """K7's plain version then the backtrack against dsjax's fused kernel
    (interpret mode) then dsjax's _backtrack, resumed from a carry whose
    pools hold -0.0, +0.0 and exact ties: the scan's outputs as
    assert_scan_equal holds them (integers exactly, floats to 1e-5), the
    chars and start slots of every ranked beam exactly. The first frame's
    selection takes the -0.0 extend first among the ties, where
    jax.lax.top_k's total order would not."""
    b, t, c = 2, 4, 5
    lp, carry = signed_zero_problem(rng, b, t, c, w)
    sizes = np.full(b, t, np.int32)
    want = jax_fused_beam_scan(jnp.asarray(lp), jnp.asarray(sizes), w, 0,
                               carry0=(tuple(jnp.asarray(a) for a in carry), None), interpret=True)
    got = beam.fused_beam_scan(torch.from_numpy(lp), torch.from_numpy(sizes), w, 0,
                               carry0=tuple(torch.from_numpy(a) for a in carry))
    assert_scan_equal(got[:5], want)
    assert int(got[1][0, 0, 0]) == 1, "the -0.0 extend no longer leads the first frame"
    order = got[5][1]
    chars, start = _backtrack(got[0], got[1], order)
    want_chars, want_start = jax_backtrack(want[0], want[1], jnp.asarray(order.numpy()))
    np.testing.assert_array_equal(chars.numpy(), np.asarray(want_chars))
    np.testing.assert_array_equal(start.numpy(), np.asarray(want_start))


def test_selection_key_orders_like_the_float_comparison(rng):
    """K7's selection key (csrc/beam_scan.cu:score_key: -0.0 made +0.0,
    then radix::order_key, the bits flipped so that unsigned order is the
    IEEE order), ties broken by the lower index, sorts a pool of signed
    zeros, ties, -1e30 and -inf as K7's plain selection does."""
    values = np.array([0.0, -0.0, -1e30, -np.inf, 1.0, -1.0, 5e-45, -5e-45, -3.25], np.float32)
    pool = rng.choice(values, (4, 600)).astype(np.float32)
    canon = np.where(pool == 0, np.float32(0.0), pool)
    bits = canon.view(np.uint32).astype(np.uint64)
    key = np.where(bits & 0x80000000, bits ^ 0xFFFFFFFF, bits ^ 0x80000000)
    index = np.broadcast_to(np.arange(pool.shape[1]), pool.shape)
    order = np.lexsort((index, -key.astype(np.int64)), axis=1)
    _, want = beam._float_order_top_k(torch.from_numpy(pool), pool.shape[1])
    np.testing.assert_array_equal(order, want.numpy())
