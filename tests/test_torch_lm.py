"""dsjax_torch's word n-gram LM and host beam search against dsjax's, on the CPU.

``decode.lm`` (ArpaLM, the DSLMBIN2 reader, MmapLM, load_word_lm) must give
dsjax's scores exactly on tests/test_lm_device.py's ARPA3 and on a seeded
3-gram of 2,000 words; the port's DSLMBIN2 bytes must equal dsjax's. The
host ``BeamCTCDecoder``, native (the port's copy of dsjax's C++) and plain
(``native=False``, the Python twin), must equal dsjax's native and Python
decoders on the no-LM and LM cases of tests/test_beam_fuzz.py's generator:
strings and offsets exactly, scores at that file's tolerance (rtol 1e-5,
atol 1e-6).
"""

import numpy as np
import pytest
import torch

from dsjax.cpp import beam_binding as jax_native
from dsjax.decode.beam import BeamCTCDecoder as JaxBeamCTCDecoder
from dsjax.decode.lm import ArpaLM as JaxArpaLM
from dsjax.decode.lm import MmapLM as JaxMmapLM
from dsjax.decode.lm import load_word_lm as jax_load_word_lm
from dsjax.decode.lm import read_binary_lm_v2 as jax_read_binary_lm_v2
from dsjax_torch.audio import native
from dsjax_torch.decode.beam import BeamCTCDecoder
from dsjax_torch.decode.lm import ArpaLM, MmapLM, load_word_lm, read_binary_lm_v2
from dsjax_torch.decode.native_beam import build_lm_binary
from dsjax_torch.labels import DEFAULT_LABELS
from tests.test_beam_fuzz import _adversarial_probs
from tests.synthetic_lm import seeded_trigram, write_arpa
from tests.test_lm_device import ARPA3, LABELS

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)     # tests/test_beam_fuzz.py's
FUZZ_CASES = 160                            # tests/test_beam_fuzz.py runs 520


@pytest.fixture(scope="module")
def lm_files(tmp_path_factory):
    """ARPA3 and the seeded 3-gram as ARPA text, each with the DSLMBIN2
    binary the port's native build writes."""
    d = tmp_path_factory.mktemp("lm")
    (d / "t3.arpa").write_text(ARPA3)
    files = {"arpa3": str(d / "t3.arpa"), "seeded": write_arpa(d / "s3.arpa", seeded_trigram())}
    for name in list(files):
        build_lm_binary(files[name], str(d / f"{name}.bin"))
        files[name + ".bin"] = str(d / f"{name}.bin")
    return files


def queries(seed, words, n):
    """n (word, context) pairs: in-vocabulary and OOV words, contexts of 0-3
    words, some of them OOV."""
    rng = np.random.default_rng(seed)
    pool = list(words) + ["CCCCCCCC", "BB'A", "ZZ"]
    return [(pool[rng.integers(len(pool))],
             [pool[rng.integers(len(pool))] for _ in range(rng.integers(0, 4))])
            for _ in range(n)]


@pytest.mark.parametrize("name", ["arpa3", "seeded"])
def test_arpa_lm_matches_dsjax(lm_files, name):
    got, want = ArpaLM(lm_files[name]), JaxArpaLM(lm_files[name])
    assert got.order == want.order and got.ngrams == want.ngrams
    assert got.has_unk == want.has_unk
    words = [w for (w,) in want.ngrams[0]]
    for word, ctx in queries(1, words, 400):
        assert got.score_word(word, ctx) == want.score_word(word, ctx), (word, ctx)
        assert got.score_word_ln(word, ctx) == want.score_word_ln(word, ctx)
    sent = words[:5]
    assert got.score_sentence(sent) == want.score_sentence(sent)


@pytest.mark.parametrize("name", ["arpa3", "seeded"])
def test_binary_matches_dsjax(lm_files, name, tmp_path):
    """The port's DSLMBIN2 is dsjax's byte for byte, and both readers parse
    it to the same arrays."""
    theirs = str(tmp_path / "dsjax.bin")
    jax_native.build_lm_binary(lm_files[name], theirs)
    with open(theirs, "rb") as a, open(lm_files[name + ".bin"], "rb") as b:
        assert a.read() == b.read()
    got, want = read_binary_lm_v2(lm_files[name + ".bin"]), jax_read_binary_lm_v2(theirs)
    assert got.keys() == want.keys()
    for key in ("order", "words", "unk_id"):
        assert got[key] == want[key]
    for key in ("uni_logp", "uni_backoff"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("ids", "logp", "backoff"):
        assert got[key].keys() == want[key].keys()
        for n in got[key]:
            np.testing.assert_array_equal(got[key][n], want[key][n])


def test_binary_reader_refuses_v1_and_text(lm_files, tmp_path):
    blob = bytearray(open(lm_files["arpa3.bin"], "rb").read())
    blob[7:8] = b"1"
    v1 = tmp_path / "v1.bin"
    v1.write_bytes(bytes(blob))
    for path in (str(v1), lm_files["arpa3"]):
        with pytest.raises(ValueError, match="DSLMBIN2"):
            read_binary_lm_v2(path)


@pytest.mark.parametrize("name", ["arpa3", "seeded"])
def test_mmap_lm_and_loader_match_dsjax(lm_files, name):
    """MmapLM on the binary scores as dsjax's does, and as ArpaLM does on
    the text; load_word_lm picks the same class for either file."""
    got, want = MmapLM(lm_files[name + ".bin"]), JaxMmapLM(lm_files[name + ".bin"])
    text = ArpaLM(lm_files[name])
    assert got.order == want.order == text.order
    words = [w for (w,) in text.ngrams[0]]
    for word, ctx in queries(2, words, 300):
        s = got.score_word(word, ctx)
        assert s == want.score_word(word, ctx), (word, ctx)
        assert s == pytest.approx(text.score_word(word, ctx), abs=1e-5), (word, ctx)
    for path in (lm_files[name], lm_files[name + ".bin"]):
        assert type(load_word_lm(path)).__name__ == type(jax_load_word_lm(path)).__name__


def fuzz_case(rng, case, dec):
    """tests/test_beam_fuzz.py:test_fuzz_cpp_matches_python_twin's settings
    for ``case`` on ``dec`` (width, pruning, alpha/beta extremes) and its
    posteriors."""
    widths = [1, 2, 3, 8, 17]
    top_ns = [1, 2, 5, 10 ** 9]
    cprobs = [0.3, 0.7, 1.0]
    ab_extremes = [(-5.0, 5.0), (5.0, -5.0), (0.75, 0.3), (0.0, 0.0), (-0.6, 0.0)]
    t = int(rng.integers(1, 13))
    dec.beam_width = widths[case % len(widths)]
    dec.cutoff_top_n = top_ns[(case // 2) % len(top_ns)]
    dec.cutoff_prob = cprobs[(case // 3) % len(cprobs)]
    dec.alpha, dec.beta = ab_extremes[(case // 5) % len(ab_extremes)]
    return _adversarial_probs(rng, t, len(dec.labels), dec.space_index)


def assert_hyps_equal(got, want, ctx):
    assert [h[0] for h in got] == [h[0] for h in want], f"{ctx}: hypotheses differ"
    assert [h[1] for h in got] == [h[1] for h in want], f"{ctx}: offsets differ"
    np.testing.assert_allclose([h[2] for h in got], [h[2] for h in want], err_msg=ctx,
                               **SCORE_TOL)


@pytest.mark.parametrize("with_lm", [False, True])
def test_fuzz_host_beam_matches_dsjax(lm_files, with_lm):
    """FUZZ_CASES cases of the fuzz file's generator (seed 2024): the port's
    native and plain decoders each equal dsjax's native and Python ones,
    every hypothesis in order."""
    labels = LABELS if with_lm else list(DEFAULT_LABELS)
    lm = lm_files["arpa3"] if with_lm else None
    port = BeamCTCDecoder(labels, lm_path=lm, num_processes=1)
    plain = BeamCTCDecoder(labels, lm_path=lm, num_processes=1, native=False)
    ref = JaxBeamCTCDecoder(labels, lm_path=lm, num_processes=1)
    assert port._cpp is not None and plain._cpp is None and ref._cpp is not None
    rng = np.random.default_rng(2024 + with_lm)
    for case in range(FUZZ_CASES):
        # every other case, as the fuzz file alternates its LM decoder
        probs = fuzz_case(rng, 2 * case + with_lm, ref)
        for dec in (port, plain):
            dec.beam_width, dec.cutoff_top_n, dec.cutoff_prob = (
                ref.beam_width, ref.cutoff_top_n, ref.cutoff_prob)
            dec.reset_params(ref.alpha, ref.beta)
        alpha, beta = (ref.alpha, ref.beta) if with_lm else (0.0, 0.0)
        ctx = (f"case {case}: t={len(probs)} w={ref.beam_width} top_n={ref.cutoff_top_n} "
               f"cprob={ref.cutoff_prob} a={alpha} b={beta}")
        want_native = ref._cpp.decode(probs, alpha, beta, ref.beam_width, ref.cutoff_top_n,
                                      ref.cutoff_prob)
        want_py = ref._decode_one(probs)
        got_native = port._cpp.decode(probs, alpha, beta, port.beam_width, port.cutoff_top_n,
                                      port.cutoff_prob)
        assert got_native == want_native, f"{ctx}: native decoders differ"
        assert_hyps_equal(plain._decode_one(probs), want_py, ctx + " (Python twins)")
        # the public decode: strings and offsets of every beam
        batch = probs[None]
        got_s, got_o = port.decode(batch)
        want_s, want_o = ref.decode(batch)
        assert got_s == want_s, ctx
        for a, b in zip(got_o[0], want_o[0]):
            np.testing.assert_array_equal(a, b, err_msg=ctx)
        assert plain.decode(batch)[0] == got_s, f"{ctx}: the plain decoder differs"


def test_decode_takes_tensors_and_threads(lm_files, rng):
    """decode takes tensors (the evaluation hands the device's posteriors
    over as they are) and sizes as a tensor; a pool of threads gives the
    serial decode's results; empty and length-1 utterances included."""
    probs = np.stack([_adversarial_probs(rng, 14, len(LABELS), 5) for _ in range(6)])
    sizes = np.array([14, 0, 1, 9, 14, 3], np.int32)
    kw = dict(lm_path=lm_files["seeded"], alpha=0.9, beta=0.4, beam_width=8)
    serial = BeamCTCDecoder(LABELS, num_processes=1, **kw).decode(probs, sizes)
    pooled = BeamCTCDecoder(LABELS, num_processes=4, **kw)
    got = pooled.decode(torch.from_numpy(probs), torch.from_numpy(sizes))
    assert got[0] == serial[0]
    for a, b in zip(got[1], serial[1]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert got[0][1] == [""] and got[1][1][0].size == 0
    want = JaxBeamCTCDecoder(LABELS, num_processes=4, **kw).decode(probs, sizes)
    assert got[0] == want[0]
    assert pooled.decode(probs, sizes, n_best=1)[0] == [s[:1] for s in serial[0]]


def test_reset_params_and_no_lm_inert(lm_files, rng):
    """reset_params changes the LM weights in place; without an LM alpha and
    beta have no effect (ctcdecode applies them only through its scorer)."""
    probs = np.stack([_adversarial_probs(rng, 10, len(LABELS), 5) for _ in range(3)])
    dec = BeamCTCDecoder(LABELS, lm_path=lm_files["arpa3"], beam_width=8, num_processes=1)
    for alpha, beta in ((0.0, 0.0), (2.5, -1.0), (0.8, 0.3)):
        dec.reset_params(alpha, beta)
        assert (dec.alpha, dec.beta) == (alpha, beta)
        ref = JaxBeamCTCDecoder(LABELS, lm_path=lm_files["arpa3"], alpha=alpha, beta=beta,
                                beam_width=8, num_processes=1)
        assert dec.decode(probs)[0] == ref.decode(probs)[0]
    plain = BeamCTCDecoder(LABELS, beam_width=8, alpha=3.0, beta=2.0, num_processes=1)
    assert plain.decode(probs)[0] == BeamCTCDecoder(LABELS, beam_width=8,
                                                    num_processes=1).decode(probs)[0]


def test_failed_native_build_raises(monkeypatch):
    """The native beam is the decoder's path: a library that cannot build
    raises; only native=False takes the Python version."""
    def fail():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native, "load_library", fail)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        BeamCTCDecoder(LABELS)
    assert BeamCTCDecoder(LABELS, native=False)._cpp is None


def test_build_lm_binary_entry_point(lm_files, tmp_path, capsys):
    from dsjax_torch.build_lm_binary import main

    out = str(tmp_path / "cli.bin")
    assert main([lm_files["arpa3"], out]) == 0
    assert open(out, "rb").read() == open(lm_files["arpa3.bin"], "rb").read()
    assert "wrote" in capsys.readouterr().out
    assert main([lm_files["arpa3"]]) == 2
    with pytest.raises(IOError, match="binary LM build failed"):
        build_lm_binary(str(tmp_path / "missing.arpa"), str(tmp_path / "x.bin"))
