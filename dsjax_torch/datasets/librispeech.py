"""LibriSpeech dataset prep: a copy of dsjax/datasets/librispeech.py
(reference parity: data/librispeech.py:23-120).

Downloads the OpenSLR tarballs, decodes flac -> 16k mono wav with the native
FLAC decoder (no sox), writes per-utterance txt transcripts (uppercased),
and builds duration-sorted manifests. Each archive and its extracted tree
are deleted once converted.

    python -m dsjax_torch.datasets.librispeech --target-dir LibriSpeech_dataset/ \
        --files-to-use dev-clean.tar.gz
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Dict, List

from dsjax_torch.data.manifest import create_manifest
from dsjax_torch.datasets.common import add_data_opts, convert_to_wav, download, extract

LIBRI_SPEECH_URLS: Dict[str, List[str]] = {
    "train": ["http://www.openslr.org/resources/12/train-clean-100.tar.gz",
              "http://www.openslr.org/resources/12/train-clean-360.tar.gz",
              "http://www.openslr.org/resources/12/train-other-500.tar.gz"],
    "val": ["http://www.openslr.org/resources/12/dev-clean.tar.gz",
            "http://www.openslr.org/resources/12/dev-other.tar.gz"],
    "test_clean": ["http://www.openslr.org/resources/12/test-clean.tar.gz"],
    "test_other": ["http://www.openslr.org/resources/12/test-other.tar.gz"],
}


def _preprocess_transcript(phrase: str) -> str:
    return phrase.strip().upper()


def _process_file(wav_dir: str, txt_dir: str, base_filename: str,
                  root_dir: str, sample_rate: int) -> None:
    full_recording_path = os.path.join(root_dir, base_filename)
    wav_path = os.path.join(wav_dir, base_filename.replace(".flac", ".wav"))
    convert_to_wav(full_recording_path, wav_path, sample_rate)
    txt_path = os.path.join(txt_dir, base_filename.replace(".flac", ".txt"))
    transcript_file = os.path.join(
        root_dir, "-".join(base_filename.split("-")[:-1]) + ".trans.txt")
    transcriptions = open(transcript_file).read().strip().split("\n")
    transcriptions = {t.split()[0].split("-")[-1]: " ".join(t.split()[1:])
                      for t in transcriptions}
    key = base_filename.replace(".flac", "").split("-")[-1]
    with open(txt_path, "w") as f:
        f.write(_preprocess_transcript(transcriptions[key]))


def prepare(target_dir: str, manifest_dir: str, files_to_use: List[str],
            sample_rate: int, min_duration: float, max_duration: float) -> None:
    os.makedirs(target_dir, exist_ok=True)
    for split, urls in LIBRI_SPEECH_URLS.items():
        split_dir = os.path.join(target_dir, split)
        wav_dir = os.path.join(split_dir, "wav")
        txt_dir = os.path.join(split_dir, "txt")
        os.makedirs(wav_dir, exist_ok=True)
        os.makedirs(txt_dir, exist_ok=True)
        extracted_dir = os.path.join(split_dir, "LibriSpeech")
        for url in urls:
            name = url.rsplit("/", 1)[1]
            if files_to_use and name not in files_to_use:
                print(f"skipping {name}")
                continue
            tar_path = os.path.join(target_dir, name)
            download(url, tar_path)
            print(f"unpacking {name}...")
            extract(tar_path, split_dir)
            print("converting flac files to wav and extracting transcripts...")
            for root, _, files in os.walk(extracted_dir):
                for fname in files:
                    if fname.endswith(".flac"):
                        _process_file(wav_dir, txt_dir, fname, root, sample_rate)
            shutil.rmtree(extracted_dir, ignore_errors=True)
            os.remove(tar_path)
        if os.listdir(wav_dir):
            print(f"creating manifest for {split}...")
            if split.startswith("train"):
                create_manifest(split_dir, f"libri_{split}_manifest.json", manifest_dir,
                                min_duration=min_duration, max_duration=max_duration)
            else:
                create_manifest(split_dir, f"libri_{split}_manifest.json", manifest_dir)


def main() -> None:
    parser = argparse.ArgumentParser(description="Processes and downloads LibriSpeech dataset.")
    parser = add_data_opts(parser)
    parser.add_argument("--target-dir", default="LibriSpeech_dataset/", type=str)
    parser.add_argument("--files-to-use",
                        default="train-clean-100.tar.gz,train-clean-360.tar.gz,"
                                "train-other-500.tar.gz,dev-clean.tar.gz,dev-other.tar.gz,"
                                "test-clean.tar.gz,test-other.tar.gz", type=str)
    args = parser.parse_args()
    prepare(args.target_dir, args.manifest_dir,
            [s.strip() for s in args.files_to_use.split(",") if s.strip()],
            args.sample_rate, args.min_duration, args.max_duration)


if __name__ == "__main__":
    main()
