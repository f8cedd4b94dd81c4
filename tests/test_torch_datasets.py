"""The port's dataset preparers and manifest CLIs against dsjax's, on the same
seeded inputs, each package in a directory of its own with its own copy of
the input: every written file byte for byte (wavs and transcripts exactly:
both packages run the same numpy/scipy code and copies of the same C++
decoders), the manifests with their absolute root_path mapped, the printed
lines, exit codes and errors. No network: every archive lies where
``download`` skips it, and VoxForge's speaker tarballs are file:// URLs."""

import dataclasses
import io
import json
import os
import re
import runpy
import shutil
import subprocess
import sys
import tarfile
import urllib.request

import numpy as np
import pytest

import dsjax.cpp.audio_binding
import dsjax.datasets.an4
import dsjax.datasets.common
import dsjax.datasets.common_voice
import dsjax.datasets.librispeech
import dsjax.datasets.ted
import dsjax.datasets.voxforge
import dsjax_torch.audio.native
import dsjax_torch.datasets.an4
import dsjax_torch.datasets.common
import dsjax_torch.datasets.common_voice
import dsjax_torch.datasets.librispeech
import dsjax_torch.datasets.ted
import dsjax_torch.datasets.voxforge
from dsjax_torch.audio.io import save_wav
from tests import codec_fixtures as fx
from tests.flac_encoder import encode_flac
from tests.synthetic_corpora import (pcm16, tar_directory, tone, transcript,
                                     write_an4_archive, write_sphere)
from tests.synthetic_manifest import write_manifest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPORA = ("an4", "common", "common_voice", "librispeech", "ted", "voxforge")
SIDES = {
    "dsjax": {name: getattr(dsjax.datasets, name) for name in CORPORA},
    "port": {name: getattr(dsjax_torch.datasets, name) for name in CORPORA},
}
CODECS = {"dsjax": dsjax.cpp.audio_binding, "port": dsjax_torch.audio.native}
# the root CLIs and the port's entry modules
CLIS = {"merge_manifests": (os.path.join(ROOT, "data", "merge_manifests.py"),
                            "dsjax_torch.data.merge_manifests"),
        "verify_manifest": (os.path.join(ROOT, "data", "verify_manifest.py"),
                            "dsjax_torch.data.verify_manifest")}


def snapshot(base):
    """{path under base: content} of every entry: "dir", a symlink's target,
    a JSON file parsed with an absolute root_path made relative to base, or
    the file's bytes."""
    entries = {}
    for dirpath, dirnames, filenames in os.walk(base):
        rel = os.path.relpath(dirpath, base)
        for d in dirnames:
            entries[os.path.join(rel, d)] = "dir"
        for f in filenames:
            path = os.path.join(dirpath, f)
            if os.path.islink(path):
                entries[os.path.join(rel, f)] = ("link", os.path.relpath(os.readlink(path), base))
            elif f.endswith(".json"):
                doc = json.load(open(path))
                if isinstance(doc, dict) and "root_path" in doc:
                    doc["root_path"] = os.path.relpath(doc["root_path"], base)
                entries[os.path.join(rel, f)] = doc
            else:
                entries[os.path.join(rel, f)] = open(path, "rb").read()
    return entries


def normalise(text, base):
    """Printed text with base and the names of temporary directories masked."""
    return re.sub(r"tmp[a-z0-9_]{8}", "<tmp>", text.replace(str(base), "<base>"))


def run_both(tmp_path, monkeypatch, capsys, setup, fn):
    """setup(base) then fn(modules) for each package in tmp_path/<side>, as
    the working directory; returns {side: (printed text, error)} and holds
    the two trees equal."""
    results = {}
    for side, modules in SIDES.items():
        base = tmp_path / side
        base.mkdir()
        setup(base)
        monkeypatch.chdir(base)
        err = None
        try:
            fn(side, modules)
        except (Exception, SystemExit) as e:
            err = (type(e).__name__, normalise(str(e), base))
        results[side] = (normalise(capsys.readouterr().out, base), err)
    monkeypatch.chdir(tmp_path)
    want, got = snapshot(tmp_path / "dsjax"), snapshot(tmp_path / "port")
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path] == want[path], path
    assert results["port"] == results["dsjax"]
    return results["port"]


def manifest_names(path):
    return [os.path.basename(s["wav_path"]) for s in json.load(open(path))["samples"]]


# ---------------------------------------------------------------------------
# AN4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["download_an4", "main"])
def test_an4(tmp_path, monkeypatch, capsys, entry):
    archive = str(tmp_path / "an4.tar.gz")
    written = write_an4_archive(archive, seed=0, n_train=4, n_val=2, n_test=2)
    if entry == "main":
        monkeypatch.setattr(sys, "argv", ["an4", "--target-dir", "an4_dataset",
                                          "--manifest-dir", "data/"])

    def go(side, m):
        if entry == "main":
            m["an4"].main()
        else:
            m["an4"].download_an4("an4_dataset", "data", 1, 15)

    out, err = run_both(tmp_path, monkeypatch, capsys,
                        lambda base: shutil.copy(archive, base / "an4.tar.gz"), go)
    assert err is None and out == "Creating manifests...\n"
    data = tmp_path / "port" / "data"
    train = manifest_names(data / "an4_train_manifest.json")
    test = manifest_names(data / "an4_test_manifest.json")
    # --min-duration 1 prunes the 0.5 s train utterance; test is never pruned
    assert sorted(train) == sorted(f"{n}.wav" for n, _ in written["train"][:-1])
    assert test[0] == "an4_test_short.wav" and len(test) == len(written["test"])
    assert len(manifest_names(data / "an4_val_manifest.json")) == 2


# ---------------------------------------------------------------------------
# LibriSpeech
# ---------------------------------------------------------------------------

def librispeech_archive(archive, seed):
    """dev-clean.tar.gz: LibriSpeech/dev-clean/<speaker>/<chapter>/ with FLAC
    utterances (one chapter at 8 kHz) and the chapter's .trans.txt."""
    rng = np.random.default_rng(seed)
    stage = os.path.dirname(archive) + "/libri_stage"
    for speaker, chapter, rate in (("84", "121123", 16000), ("174", "50561", 8000)):
        d = os.path.join(stage, "LibriSpeech", "dev-clean", speaker, chapter)
        os.makedirs(d)
        lines = []
        for utt, seconds in enumerate((0.6, float(rng.uniform(1.0, 1.5)))):
            stem = f"{speaker}-{chapter}-{utt:04d}"
            x = np.round(tone(rng, seconds, rate) * 32767).astype(np.int32)
            with open(os.path.join(d, stem + ".flac"), "wb") as f:
                f.write(encode_flac(x, rate, bps=16))
            lines.append(f"{stem} {transcript(rng, seconds).lower()}")
        with open(os.path.join(d, f"{speaker}-{chapter}.trans.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return tar_directory(stage, archive)


@pytest.mark.parametrize("entry", ["prepare", "main"])
def test_librispeech(tmp_path, monkeypatch, capsys, entry):
    archive = librispeech_archive(str(tmp_path / "dev-clean.tar.gz"), seed=1)
    if entry == "main":
        monkeypatch.setattr(sys, "argv", ["librispeech", "--target-dir", "LibriSpeech_dataset",
                                          "--manifest-dir", "data",
                                          "--files-to-use", "dev-clean.tar.gz"])

    def setup(base):
        # prepare deletes its archive: a copy for each package
        os.makedirs(base / "LibriSpeech_dataset")
        shutil.copy(archive, base / "LibriSpeech_dataset" / "dev-clean.tar.gz")

    def go(side, m):
        if entry == "main":
            m["librispeech"].main()
        else:
            m["librispeech"].prepare("LibriSpeech_dataset", "data", ["dev-clean.tar.gz"],
                                     16000, 1, 15)

    out, err = run_both(tmp_path, monkeypatch, capsys, setup, go)
    assert err is None and "creating manifest for val..." in out
    target = tmp_path / "port" / "LibriSpeech_dataset"
    assert not (target / "dev-clean.tar.gz").exists()
    assert not (target / "val" / "LibriSpeech").exists()
    assert len(manifest_names(tmp_path / "port" / "data" / "libri_val_manifest.json")) == 4
    assert sorted(os.listdir(tmp_path / "port" / "data")) == ["libri_val_manifest.json"]


# ---------------------------------------------------------------------------
# TED-LIUM
# ---------------------------------------------------------------------------

STM_LINES = ("{talk} 1 spk 0.50 2.50 <o,f0,male> hello there\n"
             "{talk} 1 spk 2.50 3.00 <o,f0,male> ignore_time_segment_in_scoring\n"
             "{talk} 1 spk 3.00 3.60 <o,f0,male> too short\n"
             "{talk} 1 spk 3.60 6.90 <o,f0,female> café isn’t {{BAD}} ñ\n"
             "malformed line\n")


def ted_archive(archive, seed):
    """TEDLIUM_release2/{train,dev,test}/{sph,stm}: little- and big-endian PCM,
    8 kHz, mu-law and two channels, and a talk with no STM."""
    rng = np.random.default_rng(seed)
    stage = os.path.dirname(archive) + "/ted_stage"
    talks = {"train": [("TalkA", {}), ("TalkB", dict(sample_rate=8000, byte_format="10")),
                       ("TalkC", {})],
             "dev": [("TalkD", dict(sample_rate=8000, coding="ulaw", n_bytes=1))],
             "test": [("TalkE", dict(channels=2))]}
    for split, items in talks.items():
        for sub in ("sph", "stm"):
            os.makedirs(os.path.join(stage, "TEDLIUM_release2", split, sub))
        for talk, kw in items:
            rate, channels = kw.get("sample_rate", 16000), kw.get("channels", 1)
            if kw.get("coding") == "ulaw":
                data = rng.integers(0, 256, 7 * rate, dtype=np.uint8).tobytes()
            else:
                data = pcm16(tone(rng, 7.0, rate, channels), kw.get("byte_format") == "10")
            root = os.path.join(stage, "TEDLIUM_release2", split)
            write_sphere(os.path.join(root, "sph", talk + ".sph"), data, **kw)
            if talk != "TalkC":
                with open(os.path.join(root, "stm", talk + ".stm"), "w", encoding="utf-8") as f:
                    f.write(STM_LINES.format(talk=talk))
    return tar_directory(stage, archive)


def test_ted(tmp_path, monkeypatch, capsys):
    archive = ted_archive(str(tmp_path / "ted.tar.gz"), seed=2)
    monkeypatch.setattr(sys, "argv", ["ted", "--target-dir", "TEDLIUM_dataset",
                                      "--tar-path", archive, "--manifest-dir", "data"])
    out, err = run_both(tmp_path, monkeypatch, capsys, lambda base: None,
                        lambda side, m: m["ted"].main())
    assert err is None and out == "Unpacking corpus...\nCreating manifests...\n"
    train = tmp_path / "port" / "TEDLIUM_dataset" / "TEDLIUM_release2" / "train"
    assert sorted(os.listdir(train / "converted" / "wav")) == [
        "TalkA_0.wav", "TalkA_1.wav", "TalkB_0.wav", "TalkB_1.wav"]
    assert (train / "converted" / "txt" / "TalkB_1.txt").read_text() == "CAFE ISNT {BAD} N"


def test_parse_stm(tmp_path):
    stm = tmp_path / "talk.stm"
    stm.write_text(STM_LINES.format(talk="T1") + "T2 A x 1e0 4.25 <o> Ünïcode  words\t\n"
                   "T2 A x 5 6 <o>\n" "T2 A x 7 8 <o>   ignore_time_segment_in_scoring  \n",
                   encoding="utf-8")
    got = dsjax_torch.datasets.ted.parse_stm(str(stm))
    want = dsjax.datasets.ted.parse_stm(str(stm))
    assert [dataclasses.asdict(s) for s in got] == [dataclasses.asdict(s) for s in want]
    assert [s.duration for s in got] == [s.duration for s in want]
    assert [s.text for s in got] == ["hello there", "too short", "cafe isnt {BAD} n",
                                     "Unicode  words"]


# ---------------------------------------------------------------------------
# SPHERE and the other containers
# ---------------------------------------------------------------------------

def sphere_case(path, case, rng):
    y = tone(rng, 0.7, 16000)
    if case == "not_sphere":
        with open(path, "wb") as f:
            f.write(b"RIFF" + bytes(2000))
        return
    if case == "no_fields":
        with open(path, "wb") as f:
            f.write(b"NIST_1A\n   1024\nend_head\n".ljust(1024, b" ") + pcm16(y))
        return
    kw, data = {}, pcm16(y)
    if case == "pcm_be":
        kw, data = dict(byte_format="10"), pcm16(y, big_endian=True)
    elif case == "ulaw":
        kw, data = dict(coding="ulaw", n_bytes=1), bytes(range(256)) * 40
    elif case == "ulaw_stereo_8k":
        kw = dict(coding="ulaw", n_bytes=1, channels=2, sample_rate=8000)
        data = rng.integers(0, 256, 8001, dtype=np.uint8).tobytes()
    elif case == "stereo":
        kw, data = dict(channels=2), pcm16(tone(rng, 0.7, 16000, 2)) + b"\x01\x00"
    elif case == "8khz":
        kw, data = dict(sample_rate=8000), pcm16(tone(rng, 0.9, 8000))
    elif case == "unsupported":
        kw, data = dict(n_bytes=1), bytes(range(256))
    write_sphere(path, data, **kw)


def outcome(fn):
    try:
        return fn()
    except Exception as e:
        return (type(e), str(e))


@pytest.mark.parametrize("case", ["pcm_le", "pcm_be", "ulaw", "ulaw_stereo_8k", "stereo", "8khz",
                                  "no_fields", "not_sphere", "unsupported"])
def test_read_sphere(tmp_path, case):
    path = str(tmp_path / "a.sph")
    sphere_case(path, case, np.random.default_rng(len(case)))
    got = outcome(lambda: dsjax_torch.datasets.common.read_sphere(path))
    want = outcome(lambda: dsjax.datasets.common.read_sphere(path))
    if isinstance(want[0], type):
        assert want[0] is ValueError and got == want
    else:
        assert got[1] == want[1] and got[0].dtype == want[0].dtype == np.float32
        assert got[0].shape == want[0].shape and got[0].tobytes() == want[0].tobytes()
    # and to a 16 kHz WAV (8 kHz resampled)
    results = [outcome(lambda m=m, side=side: m["common"].convert_to_wav(
        path, str(tmp_path / side / "a.wav"))) for side, m in SIDES.items()]
    assert results[0] == results[1]
    if results[0] is None:
        assert (tmp_path / "port" / "a.wav").read_bytes() == \
            (tmp_path / "dsjax" / "a.wav").read_bytes()


def container(path, case, rng):
    if case == "wav_stereo_44k":
        save_wav(path, tone(rng, 0.8, 44100, 2).T, 44100)
    elif case == "wav_16k":
        save_wav(path, tone(rng, 0.8), 16000)
    elif case == "flac_stereo_22k":
        x = np.round(tone(rng, 0.8, 22050, 2) * 32767).astype(np.int32)
        open(path, "wb").write(encode_flac(x, 22050, bps=16))
    elif case == "flac_24bit":
        x = np.round(tone(rng, 0.8) * 8388607).astype(np.int32)
        open(path, "wb").write(encode_flac(x, 16000, bps=24))
    else:  # a container with no decoder
        open(path, "wb").write(b"OggS" + bytes(100))


@pytest.mark.parametrize("case,ext", [("wav_stereo_44k", ".wav"), ("wav_16k", ".wav"),
                                      ("flac_stereo_22k", ".flac"), ("flac_24bit", ".flac"),
                                      ("unknown", ".ogg")])
def test_convert_to_wav(tmp_path, case, ext):
    src = str(tmp_path / ("a" + ext))
    container(src, case, np.random.default_rng(len(case)))
    results = {side: outcome(lambda m=m, side=side: m["common"].convert_to_wav(
        src, str(tmp_path / side / "out" / "a.wav"))) for side, m in SIDES.items()}
    assert results["port"] == results["dsjax"]
    if case == "unknown":
        assert results["port"][0] is ValueError
    else:
        assert results["port"] is None
        assert (tmp_path / "port" / "out" / "a.wav").read_bytes() == \
            (tmp_path / "dsjax" / "out" / "a.wav").read_bytes()


# ---------------------------------------------------------------------------
# Common Voice
# ---------------------------------------------------------------------------

TSV_HEADER = "client_id\tpath\tsentence\tup_votes\tdown_votes\tage\tgender\taccent\n"


def common_voice_archive(archive, seed, mp3=None):
    """en.tar.gz: cv-corpus-5.1-2020-06-22/en/{test,dev,train}.tsv and clips/
    (wav at 48 kHz in two channels and at 16 kHz, flac), or, given mp3 bytes,
    test.tsv alone with one mp3 clip."""
    rng = np.random.default_rng(seed)
    stage = os.path.dirname(archive) + "/cv_stage"
    lang = os.path.join(stage, dsjax_torch.datasets.common_voice.VERSION, "en")
    os.makedirs(os.path.join(lang, "clips"))
    splits = {"test": [".wav", ".flac"], "dev": [".flac"], "train": [".wav", ".wav", ".flac"]}
    if mp3 is not None:
        splits = {"test": [".mp3"]}
    clip = 0
    for split, exts in splits.items():
        rows = []
        for ext in exts:
            name = f"common_voice_en_{clip}{ext}"
            path = os.path.join(lang, "clips", name)
            seconds = 0.5 if clip == 3 else float(rng.uniform(1.0, 1.6))
            if ext == ".mp3":
                open(path, "wb").write(mp3)
            elif ext == ".flac":
                x = np.round(tone(rng, seconds, 16000) * 32767).astype(np.int32)
                open(path, "wb").write(encode_flac(x, 16000, bps=16))
            elif clip % 2:
                save_wav(path, tone(rng, seconds, 48000, 2).T, 48000)
            else:
                save_wav(path, tone(rng, seconds), 16000)
            rows.append(f"c{clip}\t{name}\t  {transcript(rng, seconds).lower()}, ok? \t2\t0\t\t\t\n")
            clip += 1
        with open(os.path.join(lang, f"{split}.tsv"), "w") as f:
            f.write(TSV_HEADER + "".join(rows))
    return tar_directory(stage, archive)


def test_common_voice(tmp_path, monkeypatch, capsys):
    archive = common_voice_archive(str(tmp_path / "en.tar.gz"), seed=3)
    monkeypatch.setattr(sys, "argv", ["cv", "--target-dir", "CommonVoice_dataset",
                                      "--tar-path", archive, "--manifest-dir", "data"])
    out, err = run_both(tmp_path, monkeypatch, capsys, lambda base: None,
                        lambda side, m: m["common_voice"].main())
    assert err is None and out.startswith("Unpacking corpus...\nConverting clips for ")
    data = tmp_path / "port" / "data"
    assert len(manifest_names(data / "commonvoice_test_manifest.json")) == 2
    assert manifest_names(data / "commonvoice_dev_manifest.json") == ["common_voice_en_2.wav"]
    # the 0.5 s clip is train's first: --min-duration 1 prunes it
    assert sorted(manifest_names(data / "commonvoice_train_manifest.json")) == [
        "common_voice_en_4.wav", "common_voice_en_5.wav"]


@pytest.mark.parametrize("branch", ["in_process", "binary", "none"])
def test_common_voice_mp3(tmp_path, monkeypatch, capsys, branch):
    """The mp3 branch: decoded in-process where the host library has mp3
    (else as "none"), by an ffmpeg/mpg123 binary found on PATH (the command
    recorded, not run), or the same RuntimeError on both sides."""
    mp3 = fx.encode_mp3(tone(np.random.default_rng(4), 1.2, 16000), 16000)
    native = all(c.available_formats() & 1 for c in CODECS.values()) and mp3 is not None
    if branch == "in_process" and not native:
        branch = "none"
    archive = common_voice_archive(str(tmp_path / "en.tar.gz"), seed=4,
                                   mp3=mp3 or b"ID3" + bytes(400))
    monkeypatch.setattr(sys, "argv", ["cv", "--target-dir", "CommonVoice_dataset",
                                      "--tar-path", archive, "--files-to-process", "test.tsv",
                                      "--sample-rate", "8000"])
    calls = []
    if branch != "in_process":
        for codec in CODECS.values():
            monkeypatch.setattr(codec, "available_formats", lambda: 0)
        found = {"binary": {"mpg123"}, "none": set()}[branch]
        monkeypatch.setattr(shutil, "which", lambda tool: f"/usr/bin/{tool}"
                            if tool in found else None)
        monkeypatch.setattr(subprocess, "check_call",
                            lambda cmd: calls.append([normalise(c, os.getcwd()) for c in cmd]))
    out, err = run_both(tmp_path, monkeypatch, capsys, lambda base: None,
                        lambda side, m: m["common_voice"].main())
    if branch == "none":
        assert err[0] == "RuntimeError" and "libmpg123" in err[1]
    elif branch == "binary":
        assert err is None and len(calls) == 2 and calls[0] == calls[1]
        assert calls[0][:3] == ["mpg123", "-q", "-w"] and calls[0][-1].endswith(".mp3")
    else:
        assert err is None
        assert len(manifest_names(tmp_path / "port" / "commonvoice_test_manifest.json")) == 1


# ---------------------------------------------------------------------------
# VoxForge
# ---------------------------------------------------------------------------

VOX_SPEAKERS = ("alice-20080101-abc", "bob-20090202-def", "carol-20100303-ghi",
                "dave-20110404-jkl")


def voxforge_tarballs(serve, seed):
    """Speaker tarballs under serve/: wav (at 48 kHz, two channels, and one
    file that is not a WAV), flac, one with no audio directory and one with
    no PROMPTS."""
    rng = np.random.default_rng(seed)
    os.makedirs(serve)
    for speaker in VOX_SPEAKERS:
        stage = os.path.join(serve, "stage")
        root = os.path.join(stage, speaker)
        os.makedirs(os.path.join(root, "etc"))
        prompts = []
        for i in range(4):
            utt, seconds = f"a{i:04d}", float(rng.uniform(1.0, 1.5))
            prompts.append(f"{speaker}/mfc/{utt} {transcript(rng, seconds).lower()}")
            if speaker.startswith("alice") and i < 3:
                os.makedirs(os.path.join(root, "wav"), exist_ok=True)
                path = os.path.join(root, "wav", utt + ".wav")
                if i == 2:
                    open(path, "wb").write(b"not a wav")
                else:
                    save_wav(path, tone(rng, seconds, 48000, 1 + i).T, 48000)
            elif speaker.startswith("bob"):
                os.makedirs(os.path.join(root, "flac"), exist_ok=True)
                x = np.round(tone(rng, seconds) * 32767).astype(np.int32)
                open(os.path.join(root, "flac", utt + ".flac"), "wb").write(encode_flac(x, 16000))
        if not speaker.startswith("dave"):
            open(os.path.join(root, "etc", "PROMPTS"), "w").write("\n".join(prompts) + "\nbad\n")
        tar_directory(stage, os.path.join(serve, speaker + ".tgz"))
        shutil.rmtree(stage)


def test_voxforge_prepare_sample(tmp_path, monkeypatch, capsys):
    serve = str(tmp_path / "serve")
    voxforge_tarballs(serve, seed=5)

    def go(side, m):
        for speaker in VOX_SPEAKERS:
            m["voxforge"].prepare_sample(speaker, f"file://{serve}/{speaker}.tgz", "vox")
        # a re-run: the markers skip alice and bob without fetching
        for speaker in VOX_SPEAKERS[:2]:
            m["voxforge"].prepare_sample(speaker, f"file://{serve}/gone.tgz", "vox")

    out, err = run_both(tmp_path, monkeypatch, capsys, lambda base: None, go)
    assert err is None
    assert re.match(r"skipping \S*<tmp>/alice-20080101-abc/wav/a0002\.wav: ", out)
    assert out.endswith("skipping carol-20100303-ghi: no wav/ or flac/ directory\n")
    vox = tmp_path / "port" / "vox"
    assert sorted(os.listdir(vox / ".done")) == list(VOX_SPEAKERS[:2])
    assert len(os.listdir(vox / "wav")) == len(os.listdir(vox / "txt")) == 6


def test_voxforge_main(tmp_path, monkeypatch, capsys):
    serve = str(tmp_path / "serve")
    voxforge_tarballs(serve, seed=6)
    index_url = f"file://{serve}/"
    index = "".join(f'<a href="{s}.tgz">{s}.tgz</a>\n' for s in VOX_SPEAKERS * 2)
    index += '<a href="README">x</a> <a href="../">up</a>'
    real = urllib.request.urlopen

    def urlopen(url, *args, **kwargs):
        # the index alone is served from memory; the tarballs are file:// URLs
        return io.BytesIO(index.encode()) if url == index_url else real(url, *args, **kwargs)

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    for m in SIDES.values():
        monkeypatch.setattr(m["voxforge"], "VOXFORGE_URL_16kHz", index_url)
    monkeypatch.setattr(sys, "argv", ["vox", "--target-dir", "vox", "--manifest-dir", "data",
                                      "--min-duration", "0"])
    out, err = run_both(tmp_path, monkeypatch, capsys, lambda base: None,
                        lambda side, m: m["voxforge"].main())
    assert err is None and out.endswith("Creating manifests...\n")
    assert len(manifest_names(tmp_path / "port" / "data" / "voxforge_train_manifest.json")) == 6


# ---------------------------------------------------------------------------
# The manifest CLIs and every entry point's --help
# ---------------------------------------------------------------------------

def run_cli(side, name, args):
    """A root CLI (dsjax) or the port's entry module as ``__main__``; returns
    its exit code (0 when it returns)."""
    path, module = CLIS[name]
    sys.argv = [name] + args
    try:
        if side == "dsjax":
            runpy.run_path(path, run_name="__main__")
        else:
            runpy.run_module(module, run_name="__main__", alter_sys=True)
    except SystemExit as e:
        return e.code
    return 0


@pytest.mark.parametrize("case", ["merge", "verify_ok", "verify_missing"])
def test_manifest_clis(tmp_path, monkeypatch, capsys, case):
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    codes = {}

    def setup(base):
        write_manifest(str(base / "a"), "a", [1.0, 0.6], seed=7)
        write_manifest(str(base / "b"), "b", [0.8], seed=8)
        if case == "verify_missing":
            os.remove(base / "b" / "wav" / "b_0.wav")
            os.remove(base / "a" / "txt" / "a_1.txt")

    def go(side, m):
        if case == "merge":
            args = ["a/a.json", "b/b.json", "--name", "merged", "--out", "out"]
            codes[side] = run_cli(side, "merge_manifests", args)
        else:
            codes[side] = run_cli(side, "verify_manifest", ["a/a.json", "b/b.json"])

    out, err = run_both(tmp_path, monkeypatch, capsys, setup, go)
    assert err is None and codes["port"] == codes["dsjax"]
    if case == "merge":
        assert codes["port"] == 0 and out == "out/merged_manifest.json\n"
        assert len(os.listdir(tmp_path / "port" / "out" / "merged" / "wav")) == 3
    elif case == "verify_ok":
        assert codes["port"] == 0 and out == "a/a.json: OK\nb/b.json: OK\n"
    else:
        assert codes["port"] == 1
        assert out == "MISSING: <base>/a/txt/a_1.txt\nMISSING: <base>/b/wav/b_0.wav\n"


@pytest.mark.parametrize("entry", ["an4", "librispeech", "ted", "common_voice", "voxforge",
                                   "merge_manifests", "verify_manifest"])
def test_help(monkeypatch, capsys, entry):
    """Every entry point lists the same options, defaults and help as dsjax's."""
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    printed = {}
    for side, m in SIDES.items():
        if entry in CLIS:
            code = run_cli(side, entry, ["--help"])
        else:
            sys.argv = [entry, "--help"]
            with pytest.raises(SystemExit) as e:
                m[entry].main()
            code = e.value.code
        printed[side] = (code, capsys.readouterr().out)
    assert printed["port"] == printed["dsjax"] and printed["port"][0] == 0
    assert "usage: " + entry in printed["port"][1]


def test_archives_hold_their_layout(tmp_path):
    """The synthetic AN4 archive is laid out as {train,val,test}/{wav,txt}."""
    archive = str(tmp_path / "an4.tar.gz")
    written = write_an4_archive(archive, seed=9, n_train=2, n_val=1, n_test=1)
    with tarfile.open(archive) as t:
        names = {n for n in t.getnames() if n.endswith((".wav", ".txt"))}
    want = {f"{split}/{kind}/{name}.{kind}" for split, items in written.items()
            for name, _ in items for kind in ("wav", "txt")}
    assert names == want
