"""dsjax_torch's device LM and the LM-fused beam scan against dsjax's, on the CPU.

The packed tables of ``decode.lm_device`` must equal dsjax's bit for bit
(from ARPA text, from a DSLMBIN2 binary, and on the dense-collision and
load-factor LMs of tests/test_lm_device.py), and ``score_word_ln`` dsjax's
within 1e-6. The scan with the LM (``_beam_scan(..., lm=...)``, the plain
top-k on CPU tensors) is held against dsjax's XLA scan (``pallas=False``):
backptr, emit, the h1/h2 histories, the integer carry and the LM hashes
exactly, totals and the float carry within 1e-5 plus 1e-6 of their size:
XLA's and torch's CPU exp/log1p differ in the last ulp, and XLA contracts
``alpha * score + beta`` into one fused multiply-add where torch rounds the
product first, so at the alpha/beta extremes (totals near 420, where a
float32 ulp is 3e-5) the word bonuses part by an ulp or two. Then the
decoder, streaming, the K7 refusal and ``load_decoder``'s dispatch.
"""

import types
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dsjax.cpp import beam_binding as jax_native
from dsjax.decode.beam_device import DeviceBeamDecoder as JaxBeamDecoder
from dsjax.decode.beam_device import _beam_scan as jax_beam_scan
from dsjax.decode.lm import ArpaLM as JaxArpaLM
from dsjax.decode.lm_device import DeviceNgramLM as JaxDeviceNgramLM
from dsjax.decode.lm_device import score_word_ln as jax_score_word_ln
from dsjax_torch.config import DecoderType, LMConfig
from dsjax_torch.decode import lm_device
from dsjax_torch.decode.beam import BeamCTCDecoder
from dsjax_torch.decode.beam_device import DeviceBeamDecoder, _beam_scan, _fusable
from dsjax_torch.decode.lm_device import DeviceNgramLM, score_word_ln
from dsjax_torch.decode.native_beam import build_lm_binary
from dsjax_torch.inference import load_decoder
from dsjax_torch.labels import DEFAULT_LABELS, LabelMap
from dsjax_torch.ops import beam, topk
from tests.test_lm_device import ARPA3, LABELS
from tests.synthetic_lm import seeded_trigram, write_arpa

TOTAL_ATOL = 1e-5
TOTAL_RTOL = 1e-6           # about 8 float32 ulps; see the module docstring
SCORE_ATOL = 1e-6
SPACE = LABELS.index(" ")


@pytest.fixture(scope="module")
def lm_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("lmdev")
    (d / "t3.arpa").write_text(ARPA3)
    files = {"arpa3": str(d / "t3.arpa"), "seeded": write_arpa(d / "s3.arpa", seeded_trigram())}
    for name in ("arpa3", "seeded"):
        build_lm_binary(files[name], str(d / f"{name}.bin"))
        files[name + ".bin"] = str(d / f"{name}.bin")
    return files


def collision_lm(seed=5):
    """tests/test_lm_device.py:test_packed_tables_at_scale's 600-word 3-gram
    (dense hash collisions over a 3-letter alphabet), as ngrams dicts."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("ABC"))
    words, seen = [], set()
    while len(words) < 600:
        w = "".join(rng.choice(letters, size=rng.integers(1, 7)))
        if w not in seen:
            seen.add(w)
            words.append(w)
    n1 = {(w,): (float(-rng.uniform(1, 5)), float(-rng.uniform(0.1, 1))) for w in words}
    n1[("<unk>",)] = (-9.0, 0.0)
    n2 = {(words[a], words[b]): (float(-rng.uniform(1, 6)), float(-rng.uniform(0.1, 1)))
          for a, b in rng.integers(0, len(words), size=(4000, 2))}
    n3 = {(words[a], words[b], words[c]): (float(-rng.uniform(1, 7)), 0.0)
          for a, b, c in rng.integers(0, len(words), size=(8000, 3))}
    return [n1, n2, n3]


def load_factor_lm(seed=11):
    """tests/test_lm_device.py:test_table_load_factor's 2000-word 2-gram."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("ABC"))
    words, seen = [], set()
    while len(words) < 2000:
        w = "".join(rng.choice(letters, size=rng.integers(2, 9)))
        if w not in seen:
            seen.add(w)
            words.append(w)
    n1 = {(w,): (-2.0, -0.3) for w in words}
    n2 = {(words[a], words[b]): (-3.0, -0.3)
          for a, b in rng.integers(0, len(words), size=(40000, 2))}
    return [n1, n2]


def fake_arpa(ngrams):
    return types.SimpleNamespace(order=len(ngrams), ngrams=ngrams)


def host_lm(ngrams):
    """dsjax's ArpaLM over in-memory ngrams (tests/test_lm_device.py's way)."""
    ref = JaxArpaLM.__new__(JaxArpaLM)
    ref.ngrams, ref.order, ref.unk = ngrams, len(ngrams), ("<unk>",)
    ref.has_unk = ("<unk>",) in ngrams[0]
    return ref


def assert_tables_equal(got: DeviceNgramLM, want):
    assert (got.order, got.unk_logp, got.n_vocab) == (want.order, want.unk_logp, want.n_vocab)
    assert len(got.tables) == len(want.tables)
    for a, b in zip(got.tables, want.tables):
        assert a.data.dtype == np.uint32 and a.data.shape == b.data.shape
        np.testing.assert_array_equal(a.data, b.data)
        assert (a.mask, a.depth) == (b.mask, b.depth)
    packed, ref = got.device("cpu"), want.device()
    assert packed.ngrams.dtype == torch.int32
    np.testing.assert_array_equal(packed.ngrams.numpy().view(np.uint32), np.asarray(ref.ngrams))
    assert (packed.bases, packed.masks, packed.depths) == (ref.bases, ref.masks, ref.depths)
    assert (packed.order, packed.unk_logp) == (ref.order, ref.unk_logp)


@pytest.mark.parametrize("case", ["arpa3", "arpa3.bin", "seeded", "seeded.bin",
                                  "dense collisions", "load factor"])
def test_packed_tables_bit_equal_to_dsjax(lm_files, case):
    if case in lm_files:
        got = DeviceNgramLM(lm_files[case], LABELS)
        want = JaxDeviceNgramLM(lm_files[case], LABELS)
    else:
        ngrams = collision_lm() if case == "dense collisions" else load_factor_lm()
        got, want = DeviceNgramLM(fake_arpa(ngrams), LABELS), JaxDeviceNgramLM(
            fake_arpa(ngrams), LABELS)
    assert_tables_equal(got, want)
    # the binary packs the same tables as its ARPA text, bucket for bucket;
    # within a bucket the slots keep their insertion order, the ARPA's file
    # order or the binary's word ids, so they are compared sorted
    if case.endswith(".bin"):
        text = DeviceNgramLM(lm_files[case[:-4]], LABELS)
        for a, b in zip(text.tables, got.tables):
            np.testing.assert_array_equal(bucket_sorted(a.data), bucket_sorted(b.data))


def bucket_sorted(data):
    """(S, 4) slots with each bucket's slots in lexicographic order."""
    rows = data.reshape(-1, lm_device.BUCKET, 4)
    keys = rows[..., 0].astype(np.uint64) << np.uint64(32) | rows[..., 1]
    order = np.argsort(keys, axis=1, kind="stable")
    return np.take_along_axis(rows, order[..., None], axis=1)


def test_table_load_factor():
    """The tables build at their designed load, as dsjax's test requires."""
    for t in DeviceNgramLM(fake_arpa(load_factor_lm()), LABELS).tables:
        assert int((t.data[:, 0] != 0xFFFFFFFF).sum()) / len(t.data) >= 0.0625


def word_pairs(words, lmap):
    """(N, 2) int64 canonical hash pairs of words; CTX_ABSENT rows for None."""
    absent = int(lm_device.CTX_ABSENT)
    return np.array([lm_device._word_hash([lmap.char_to_int[c] for c in w]) if w is not None
                     else (absent, absent) for w in words], np.int64)


def sampled_queries(words, n, order, seed):
    """n (word, context) samples: words of the LM, words it lacks, contexts
    of every length up to order-1 (absent slots on the left)."""
    rng = np.random.default_rng(seed)
    pool = list(words) + ["CCCCCCCCC", "A'B", "BBBBBBBBBA"]
    target = [pool[rng.integers(len(pool))] for _ in range(n)]
    ctxs = []
    for _ in range(n):
        k = int(rng.integers(0, order))
        ctxs.append([None] * (order - 1 - k) + [pool[rng.integers(len(pool))] for _ in range(k)])
    return target, ctxs


@pytest.mark.parametrize("name", ["arpa3", "seeded", "dense collisions"])
def test_score_word_ln_matches_dsjax_and_arpa(lm_files, name):
    """score_word_ln on 400 samples, the context backoffs probed and
    carried: equal to dsjax's within 1e-6 (the pairs and new carries
    exactly) and to ArpaLM within 1e-5."""
    if name == "dense collisions":
        ngrams = collision_lm()
        dev, jdev, host = (DeviceNgramLM(fake_arpa(ngrams), LABELS),
                           JaxDeviceNgramLM(fake_arpa(ngrams), LABELS), host_lm(ngrams))
    else:
        dev, jdev = DeviceNgramLM(lm_files[name], LABELS), JaxDeviceNgramLM(lm_files[name], LABELS)
        host = JaxArpaLM(lm_files[name])
    lmap = LabelMap(LABELS)
    words = [w for (w,) in host.ngrams[0] if w not in DeviceNgramLM.SPECIALS]
    target, ctxs = sampled_queries(words, 400, dev.order, seed=3)
    cur = word_pairs(target, lmap)
    ctx = np.stack([word_pairs(c, lmap) for c in ctxs])          # (N, order-1, 2)
    packed, jpacked = dev.device("cpu"), jdev.device()
    got = score_word_ln(packed, torch.from_numpy(cur[:, 0]), torch.from_numpy(cur[:, 1]),
                        torch.from_numpy(ctx))
    want = jax_score_word_ln(jpacked, jnp.asarray(cur[:, 0].astype(np.uint32)),
                             jnp.asarray(cur[:, 1].astype(np.uint32)),
                             jnp.asarray(ctx.astype(np.uint32)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]).astype(np.int64))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for j, (w, c) in enumerate(zip(target, ctxs)):
        ref = host.score_word_ln(w, [x for x in c if x is not None])
        assert abs(ref - float(got[0][j])) < 1e-4, (w, c, ref, float(got[0][j]))
    # with the context backoffs carried (the scan's form): the same scores;
    # bos[:, j] is the backoff of the context's length-(j+1) suffix
    bos = torch.zeros((len(ctx), dev.order - 1))
    for i, c in enumerate(ctxs):
        for j in range(dev.order - 1):
            suffix = tuple(c[len(c) - 1 - j:])
            if None not in suffix and all(x in words for x in suffix):
                bos[i, j] = host.ngrams[j].get(suffix, (0.0, 0.0))[1]
    carried = score_word_ln(packed, torch.from_numpy(cur[:, 0]), torch.from_numpy(cur[:, 1]),
                            torch.from_numpy(ctx), bos)
    np.testing.assert_array_equal(carried[0].numpy(), got[0].numpy())


def test_hash_arithmetic_wraps_like_uint32(rng):
    """The int64 mixer and fold give numpy's uint32 results bit for bit on
    keys across the whole 32-bit range, EMPTY_KEY included."""
    k = rng.integers(0, 2 ** 32, size=(2, 4096), dtype=np.uint64).astype(np.uint32)
    k[:, :3] = [[0xFFFFFFFF, 0, 0x80000000], [0xFFFFFFFF, 0xFFFFFFFF, 0x7FFFFFFF]]
    t1, t2 = torch.from_numpy(k[0].astype(np.int64)), torch.from_numpy(k[1].astype(np.int64))
    for mask in (7, 0xFFFF, 0x7FFFFF):
        np.testing.assert_array_equal(lm_device._mix_index_t(t1, t2, mask).numpy(),
                                      lm_device._mix_index(k[0], k[1], np.uint32(mask)))
    cols = np.stack([k[0], k[1], k[1], k[0]], -1).astype(np.int64)
    h1, h2, valid = lm_device._fold_pairs([(t1, t2), (t2, t1)])
    np.testing.assert_array_equal(h1.numpy(), lm_device._fold_ids(cols, lm_device.FOLD_A1, True))
    np.testing.assert_array_equal(h2.numpy(), lm_device._fold_ids(cols, lm_device.FOLD_A2))
    np.testing.assert_array_equal(valid.numpy(), (k[0] != 0xFFFFFFFF) & (k[1] != 0xFFFFFFFF))
    np.testing.assert_array_equal(lm_device._bits_i32(t1).numpy(), k[0].view(np.int32))


def spaceful_log_probs(rng, b, t, c=len(LABELS)):
    """tests/test_lm_device.py's word-and-space-biased posteriors, as logs."""
    bias = np.array([0.5, 0.0, 1.2, 1.0, 0.4, 1.4])[:c]
    logits = rng.standard_normal((b, t, c)) * 1.5 + bias
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)


def lms(lm_files, name):
    path = lm_files[name]
    return DeviceNgramLM(path, LABELS).device("cpu"), JaxDeviceNgramLM(path, LABELS).device()


def run_both(lp, sizes, w, packed, jpacked, alpha, beta, top_n=10 ** 9, cprob=1.0,
             carry=None, jcarry=None):
    got = _beam_scan(torch.from_numpy(lp), torch.from_numpy(sizes), w, 0, cutoff_top_n=top_n,
                     cutoff_prob=cprob, lm=packed, alpha=alpha, beta=beta, space=SPACE,
                     carry0=carry)
    want = jax_beam_scan(jnp.asarray(lp), jnp.asarray(sizes), w, 0, lm=jpacked,
                         alpha=jnp.float32(alpha), beta=jnp.float32(beta), space=SPACE,
                         cutoff_top_n=top_n, cutoff_prob=cprob, carry0=jcarry, pallas=False)
    return got, want


def assert_lm_scan_equal(got, want):
    for name, g, w in (("backptr", got[0], want[0]), ("emit", got[1], want[1]),
                       ("h1", got[2][0], want[2][0]), ("h2", got[2][1], want[2][1])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=TOTAL_ATOL,
                               rtol=TOTAL_RTOL)
    (core, lm_state), (jcore, jlm_state) = got[4], want[4]
    for i, (g, w) in enumerate(list(zip(core, jcore)) + list(zip(lm_state, jlm_state))):
        w = np.asarray(w)
        if g.dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), w, atol=TOTAL_ATOL, rtol=TOTAL_RTOL,
                                       err_msg=f"carry {i}")
        else:
            np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype),
                                          err_msg=f"carry {i}")


@pytest.mark.parametrize("w,top_n,cprob,alpha,beta", [
    (1, 10 ** 9, 1.0, 0.8, 0.3),
    (10, 10 ** 9, 1.0, 0.8, 0.3),
    (32, 10 ** 9, 1.0, 0.8, 0.3),
    (10, 3, 1.0, 5.0, -5.0),          # pruning by cutoff_top_n, the fuzz file's extremes
    (32, 10 ** 9, 0.8, -5.0, 5.0),    # pruning by cutoff_prob
    (10, 4, 0.9, 0.0, 0.0),           # both, and an LM that adds nothing
])
@pytest.mark.parametrize("name", ["arpa3", "seeded"])
def test_lm_scan_matches_dsjax(lm_files, name, w, top_n, cprob, alpha, beta):
    rng = np.random.default_rng(w + top_n % 97)
    b, t = 3, 16
    lp = spaceful_log_probs(rng, b, t)
    sizes = np.array([t, t - 5, 1], np.int32)
    packed, jpacked = lms(lm_files, name)
    got, want = run_both(lp, sizes, w, packed, jpacked, alpha, beta, top_n, cprob)
    assert_lm_scan_equal(got, want)
    # the selection took space extensions, which carry the LM bonus
    assert bool((got[1] == SPACE).any())


def test_lm_scan_resumes_like_dsjax(lm_files):
    """A second chunk from the carried (core, LM state), the port's or
    dsjax's: dsjax's second chunk exactly."""
    rng = np.random.default_rng(9)
    lp = spaceful_log_probs(rng, 2, 18)
    sizes = np.full(2, 9, np.int32)
    packed, jpacked = lms(lm_files, "seeded")
    first, jfirst = run_both(lp[:, :9], sizes, 10, packed, jpacked, 0.8, 0.3)
    assert_lm_scan_equal(first, jfirst)
    want = jax_beam_scan(jnp.asarray(lp[:, 9:]), jnp.asarray(sizes), 10, 0, lm=jpacked,
                         alpha=jnp.float32(0.8), beta=jnp.float32(0.3), space=SPACE,
                         carry0=jfirst[4], pallas=False)
    theirs = (tuple(torch.from_numpy(np.array(a)) for a in jfirst[4][0]),
              tuple(torch.from_numpy(np.array(a).astype(np.int64)) if np.array(a).dtype == np.uint32
                    else torch.from_numpy(np.array(a)) for a in jfirst[4][1]))
    for carry in (first[4], theirs):
        got = _beam_scan(torch.from_numpy(lp[:, 9:]), torch.from_numpy(sizes), 10, 0,
                         lm=packed, alpha=0.8, beta=0.3, space=SPACE, carry0=carry)
        assert_lm_scan_equal(got, want)


@pytest.mark.parametrize("ctc_offsets", [False, True])
def test_decoder_matches_dsjax(lm_files, ctc_offsets):
    """DeviceBeamDecoder with the LM: strings, offsets and scores of every
    beam equal to dsjax's; reset_params moves it without a rebuild."""
    rng = np.random.default_rng(31)
    probs = np.exp(spaceful_log_probs(rng, 4, 14))
    sizes = np.array([14, 9, 0, 1], np.int32)
    kw = dict(beam_width=12, lm_path=lm_files["seeded"], alpha=0.9, beta=0.35,
              ctc_offsets=ctc_offsets)
    port, ref = DeviceBeamDecoder(LABELS, **kw), JaxBeamDecoder(LABELS, **kw)
    for alpha, beta in ((0.9, 0.35), (3.0, -1.0)):
        port.reset_params(alpha, beta)
        ref.reset_params(alpha, beta)
        got = port.decode(probs, sizes, with_scores=True)
        want = ref.decode(probs, sizes, with_scores=True)
        assert got[0] == want[0]
        for a, b in zip(got[1], want[1]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(got[2], want[2], atol=TOTAL_ATOL, rtol=TOTAL_RTOL)


@pytest.mark.parametrize("alpha,beta", [(5.0, -5.0), (-5.0, 5.0), (0.75, 0.3)])
def test_fuzz_lm_groups_match_dsjax_and_host(lm_files, alpha, beta):
    """tests/test_beam_fuzz.py's LM groups (ARPA3, T=3, W=256 exhaustive,
    adversarial posteriors, sizes 0 and 1 included), 24 cases a group:
    strings, ctcdecode offsets and scores equal to dsjax's device decoder,
    and the top string to the port's host beam."""
    from tests.test_beam_fuzz import _adversarial_probs

    rng = np.random.default_rng(200 + int(alpha))
    n = 24
    probs = np.stack([_adversarial_probs(rng, 3, len(LABELS), SPACE) for _ in range(n)])
    sizes = rng.integers(0, 4, size=n).astype(np.int32)
    sizes[0], sizes[1] = 0, 1
    sizes[2:] = np.maximum(sizes[2:], 2)
    kw = dict(beam_width=256, lm_path=lm_files["arpa3"], alpha=alpha, beta=beta,
              ctc_offsets=True)
    got = DeviceBeamDecoder(LABELS, **kw).decode(probs, sizes, n_best=1, with_scores=True)
    want = JaxBeamDecoder(LABELS, **kw).decode(probs, sizes, n_best=1, with_scores=True)
    assert got[0] == want[0]
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        np.testing.assert_array_equal(a[0], b[0], err_msg=f"case {i}")
    np.testing.assert_allclose(got[2], want[2], atol=TOTAL_ATOL, rtol=TOTAL_RTOL)
    host = BeamCTCDecoder(LABELS, lm_path=lm_files["arpa3"], alpha=alpha, beta=beta,
                          beam_width=256, num_processes=1)
    assert [s[:1] for s in host.decode(probs, sizes)[0]] == got[0]


@pytest.mark.parametrize("with_lm", [False, True])
def test_lm_stream_equals_one_shot(lm_files, with_lm):
    """decode_chunk over three chunks, carrying the LM word state, gives the
    one-shot decode's text and every beam's hypothesis, as dsjax's does."""
    rng = np.random.default_rng(23)
    probs = np.exp(spaceful_log_probs(rng, 1, 20))
    kw = dict(lm_path=lm_files["seeded"], alpha=0.8, beta=0.3) if with_lm else {}
    port, ref = DeviceBeamDecoder(LABELS, beam_width=16, **kw), JaxBeamDecoder(
        LABELS, beam_width=16, **kw)
    whole = port.decode(probs)[0][0]
    state = ref_state = None
    for lo, hi in ((0, 7), (7, 8), (8, 20)):
        text, state = port.decode_chunk(probs[:, lo:hi], state)
        ref_text, ref_state = ref.decode_chunk(probs[:, lo:hi], ref_state)
        assert text == ref_text and state.strings == ref_state.strings
    assert text == whole[0] and sorted(state.strings) == sorted(whole)
    assert isinstance(state.carry[0], tuple) == with_lm


def test_k7_takes_no_lm_decode(lm_files, monkeypatch):
    """Under DSJAX_FUSED_BEAM=1 an LM decode stays off K7, as dsjax's
    _fused_ok refuses it; on CPU tensors neither kernel launches."""
    monkeypatch.setenv("DSJAX_FUSED_BEAM", "1")
    card = types.SimpleNamespace(is_cuda=True, shape=(2, 9, len(LABELS)))
    with_lm = DeviceBeamDecoder(LABELS, beam_width=8, lm_path=lm_files["arpa3"])
    assert not with_lm._fused_ok(card)
    assert DeviceBeamDecoder(LABELS, beam_width=8)._fused_ok(card)
    assert not _fusable(2, len(LABELS), 8, 10 ** 9, 1.0, with_lm._lm)
    rng = np.random.default_rng(4)
    lp = torch.from_numpy(spaceful_log_probs(rng, 2, 9))
    sizes = torch.tensor([9, 5], dtype=torch.int32)
    kw = dict(lm=with_lm._lm, alpha=0.8, beta=0.3, space=SPACE)
    launches = beam.LAUNCHES, topk.LAUNCHES
    a, b = _beam_scan(lp, sizes, 8, 0, fused=True, **kw), _beam_scan(lp, sizes, 8, 0, **kw)
    for x, y in zip(a[:2] + a[2] + (a[3],) + a[4][0] + a[4][1],
                    b[:2] + b[2] + (b[3],) + b[4][0] + b[4][1]):
        assert torch.equal(x, y)
    assert (beam.LAUNCHES, topk.LAUNCHES) == launches


def test_lm_needs_a_space_label(lm_files):
    with pytest.raises(ValueError, match="space label"):
        DeviceBeamDecoder(["_", "A", "B", "C"], lm_path=lm_files["arpa3"])


def test_load_decoder_dispatch(lm_files, tmp_path):
    """dsjax's four LM cases (tests/test_lm_device.py:202-216, 423-440):
    device_beam with ARPA or DSLMBIN2 -> the device beam with the LM;
    device_beam with DSLMBIN1 -> a warning and the host beam; no
    device_beam -> the host beam with lm_workers threads. Without an LM the
    device beam; greedy otherwise."""
    beam_cfg = dict(decoder_type=DecoderType.beam, alpha=1.0, beta=0.5, beam_width=8,
                    lm_workers=3)
    for path in (lm_files["arpa3"], lm_files["arpa3.bin"]):
        dec = load_decoder(LABELS, LMConfig(lm_path=path, device_beam=True, **beam_cfg),
                           want_offsets=True)
        assert isinstance(dec, DeviceBeamDecoder) and dec._lm is not None
        assert (dec.alpha, dec.beta, dec.beam_width, dec.ctc_offsets) == (1.0, 0.5, 8, True)
    host = load_decoder(LABELS, LMConfig(lm_path=lm_files["arpa3"], **beam_cfg))
    assert isinstance(host, BeamCTCDecoder) and host.lm is not None
    assert (host.num_processes, host.alpha, host.beam_width) == (3, 1.0, 8)
    blob = bytearray(open(lm_files["arpa3.bin"], "rb").read())
    blob[7:8] = b"1"
    v1 = tmp_path / "lm1.bin"
    v1.write_bytes(bytes(blob))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        dec_v1 = load_decoder(LABELS, LMConfig(lm_path=str(v1), device_beam=True, **beam_cfg))
    assert isinstance(dec_v1, BeamCTCDecoder)
    assert any("DSLMBIN1" in str(w.message) for w in rec)
    no_lm = load_decoder(DEFAULT_LABELS, LMConfig(decoder_type=DecoderType.beam, beam_width=7),
                         want_offsets=True)
    assert isinstance(no_lm, DeviceBeamDecoder) and no_lm._lm is None
    assert (no_lm.beam_width, no_lm.ctc_offsets) == (7, True)
    assert type(load_decoder(LABELS, LMConfig(lm_path=lm_files["arpa3"]))).__name__ == (
        "GreedyDecoder")
    # the dsjax reference of the v2 binary loads the same bytes
    theirs = str(tmp_path / "dsjax.bin")
    jax_native.build_lm_binary(lm_files["arpa3"], theirs)
    assert open(theirs, "rb").read() == open(lm_files["arpa3.bin"], "rb").read()
