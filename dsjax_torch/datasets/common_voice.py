"""Mozilla CommonVoice dataset prep: a copy of dsjax/datasets/common_voice.py
(reference parity: data/common_voice.py).

Reads the TSV clip lists, writes per-clip uppercased transcripts, and
converts clips to 16k mono wav. CommonVoice ships mp3, decoded IN-PROCESS
by the port's native host library (dsjax_torch/csrc/host, via the system
libmpg123) — no ffmpeg/sox binary needed (the reference shells out to sox,
data/common_voice.py:22-60). An ffmpeg/mpg123 binary on PATH is used only
when the codec libraries are absent.

    python -m dsjax_torch.datasets.common_voice --target-dir CommonVoice_dataset/ \
        --tar-path en.tar.gz
"""

from __future__ import annotations

import argparse
import csv
import os
import shutil
import subprocess

from dsjax_torch.audio import native
from dsjax_torch.audio.io import resample, save_wav
from dsjax_torch.data.manifest import create_manifest
from dsjax_torch.datasets.common import add_data_opts, convert_to_wav, download, extract

VERSION = "cv-corpus-5.1-2020-06-22"
COMMON_VOICE_URL = ("https://voice-prod-bundler-ee1969a6ce8178826482b88e843c335139bd3fb4"
                    ".s3.amazonaws.com/{}/en.tar.gz".format(VERSION))


def _mp3_to_wav(src: str, dst: str, sample_rate: int) -> None:
    if native.available_formats() & 1:  # native in-process mp3 decode
        y, sr = native.decode_file(src)
        if sr != sample_rate:
            y = resample(y, sr, sample_rate)
        save_wav(dst, y, sample_rate)
        return
    for tool, cmd in (("ffmpeg", ["ffmpeg", "-y", "-v", "quiet", "-i", src,
                                  "-ar", str(sample_rate), "-ac", "1", dst]),
                      ("mpg123", ["mpg123", "-q", "-w", dst, "-r", str(sample_rate),
                                  "-m", src])):
        if shutil.which(tool):
            subprocess.check_call(cmd)
            return
    raise RuntimeError(
        "mp3 decoding needs the system libmpg123 or an ffmpeg/mpg123 binary; "
        "none found. Pre-convert CommonVoice clips to wav.")


def convert_split(tsv_file: str, target_dir: str, sample_rate: int) -> None:
    wav_dir = os.path.join(target_dir, "wav")
    txt_dir = os.path.join(target_dir, "txt")
    os.makedirs(wav_dir, exist_ok=True)
    os.makedirs(txt_dir, exist_ok=True)
    clips = os.path.join(os.path.dirname(tsv_file), "clips")
    print(f"Converting clips for {tsv_file}.")
    with open(tsv_file) as f:
        reader = csv.DictReader(f, delimiter="\t")
        for row in reader:
            file_path, text = row["path"], row["sentence"]
            name = os.path.splitext(os.path.basename(file_path))[0]
            with open(os.path.join(txt_dir, name + ".txt"), "w") as tf:
                tf.write(text.strip().upper())
            src = os.path.join(clips, file_path)
            dst = os.path.join(wav_dir, name + ".wav")
            if src.lower().endswith(".mp3"):
                _mp3_to_wav(src, dst, sample_rate)
            else:
                convert_to_wav(src, dst, sample_rate)


def main() -> None:
    parser = argparse.ArgumentParser(description="Downloads and processes Mozilla Common Voice dataset.")
    parser = add_data_opts(parser)
    parser.add_argument("--target-dir", default="CommonVoice_dataset/", type=str)
    parser.add_argument("--tar-path", type=str, default=None)
    parser.add_argument("--language-dir", default="en", type=str)
    parser.add_argument("--files-to-process", nargs="+",
                        default=["test.tsv", "dev.tsv", "train.tsv"], type=str)
    args = parser.parse_args()

    target_dir = args.target_dir
    os.makedirs(target_dir, exist_ok=True)
    tar_path = args.tar_path or os.path.join(target_dir, "en.tar.gz")
    if not os.path.exists(tar_path):
        download(COMMON_VOICE_URL, tar_path)
    extracted = os.path.join(target_dir, VERSION)
    if not os.path.exists(extracted):
        print("Unpacking corpus...")
        extract(tar_path, target_dir)
    lang_dir = os.path.join(extracted, args.language_dir)
    for tsv in args.files_to_process:
        split = os.path.splitext(tsv)[0]
        split_dir = os.path.join(target_dir, split)
        convert_split(os.path.join(lang_dir, tsv), split_dir, args.sample_rate)
        name = f"commonvoice_{split}_manifest.json"
        if split == "train":
            create_manifest(split_dir, name, args.manifest_dir,
                            min_duration=args.min_duration,
                            max_duration=args.max_duration)
        else:
            create_manifest(split_dir, name, args.manifest_dir)


if __name__ == "__main__":
    main()
