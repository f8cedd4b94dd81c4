"""VoxForge dataset prep: a copy of dsjax/datasets/voxforge.py (reference
parity: data/voxforge.py:15-105).

Scrapes the VoxForge 16kHz corpus index, downloads each recording tarball,
pairs wav/flac audio with prompt transcripts, and builds a manifest.

    python -m dsjax_torch.datasets.voxforge --target-dir voxforge_dataset/
"""

from __future__ import annotations

import argparse
import io
import os
import re
import tarfile
import tempfile
import urllib.request

from dsjax_torch.data.manifest import create_manifest
from dsjax_torch.datasets.common import add_data_opts, convert_to_wav

VOXFORGE_URL_16kHz = ("http://www.repository.voxforge1.org/downloads/SpeechCorpus/"
                      "Trunk/Audio/Main/16kHz_16bit/")


def _read_prompts(prompts_file: str):
    """PROMPTS lines: ``<path/utt_id> <word> <word> ...`` ->
    {utt_id: UPPERCASED transcript}."""
    prompts = {}
    with open(prompts_file, errors="replace") as f:
        for line in f:
            head, _, text = line.strip().partition(" ")
            if head and text:
                prompts[os.path.basename(head)] = text.upper()
    return prompts


def prepare_sample(recording_name: str, url: str, target_folder: str,
                   sample_rate: int = 16000) -> None:
    """Download one speaker tarball and emit wav/txt pairs for every prompt
    that has a matching wav or flac recording. A per-recording marker file
    under .done/ makes re-runs resumable without re-downloading."""
    wav_dir = os.path.join(target_folder, "wav")
    txt_dir = os.path.join(target_folder, "txt")
    done_dir = os.path.join(target_folder, ".done")
    for d in (wav_dir, txt_dir, done_dir):
        os.makedirs(d, exist_ok=True)
    marker = os.path.join(done_dir, recording_name)
    if os.path.exists(marker):
        return
    with urllib.request.urlopen(url) as resp:
        content = resp.read()
    with tempfile.TemporaryDirectory() as dirpath:
        with tarfile.open(fileobj=io.BytesIO(content)) as tar:
            tar.extractall(dirpath)
        root = os.path.join(dirpath, recording_name)
        prompts_file = os.path.join(root, "etc", "PROMPTS")
        if not os.path.exists(prompts_file):
            return
        audio_dirs = [(k, os.path.join(root, k)) for k in ("wav", "flac")
                      if os.path.isdir(os.path.join(root, k))]
        if not audio_dirs:
            print(f"skipping {recording_name}: no wav/ or flac/ directory")
            return
        for utt_id, transcript in _read_prompts(prompts_file).items():
            src = next((os.path.join(d, f"{utt_id}.{k}") for k, d in audio_dirs
                        if os.path.exists(os.path.join(d, f"{utt_id}.{k}"))),
                       None)
            if src is None:
                continue
            stem = f"{recording_name}_{utt_id}"
            try:
                convert_to_wav(src, os.path.join(wav_dir, stem + ".wav"),
                               sample_rate)
            except Exception as e:
                print(f"skipping {src}: {e}")
                continue
            with open(os.path.join(txt_dir, stem + ".txt"), "w") as tf:
                tf.write(transcript)
    with open(marker, "w") as mf:
        mf.write(url)


def main() -> None:
    parser = argparse.ArgumentParser(description="Processes and downloads VoxForge dataset.")
    parser = add_data_opts(parser)
    parser.add_argument("--target-dir", default="voxforge_dataset/", type=str)
    args = parser.parse_args()
    target_dir = args.target_dir
    os.makedirs(target_dir, exist_ok=True)
    with urllib.request.urlopen(VOXFORGE_URL_16kHz) as resp:
        index = resp.read().decode("utf8", errors="replace")
    names = sorted(set(re.findall(r'href="([\w\-.]+\.tgz)"', index)))
    for archive in names:
        prepare_sample(archive.replace(".tgz", ""),
                       VOXFORGE_URL_16kHz + archive, target_dir,
                       args.sample_rate)
    print("Creating manifests...")
    create_manifest(target_dir, "voxforge_train_manifest.json", args.manifest_dir,
                    min_duration=args.min_duration, max_duration=args.max_duration)


if __name__ == "__main__":
    main()
