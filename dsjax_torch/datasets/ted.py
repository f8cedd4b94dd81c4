"""TED-LIUM v2 dataset prep: a copy of dsjax/datasets/ted.py (reference
parity: data/ted.py:20-146).

Segments each talk's NIST SPHERE recording by its STM utterance timings into
per-utterance 16k mono wav + txt pairs, then builds manifests. SPHERE
parsing and trimming are native (no sox).

    python -m dsjax_torch.datasets.ted --target-dir TEDLIUM_dataset/ \
        --tar-path TEDLIUM_release2.tar.gz
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import unicodedata
from typing import List

from dsjax_torch.audio.io import resample, save_wav
from dsjax_torch.data.manifest import create_manifest
from dsjax_torch.datasets.common import add_data_opts, download, extract, read_sphere

TED_LIUM_V2_DL_URL = "http://www.openslr.org/resources/19/TEDLIUM_release2.tar.gz"

# STM label marking non-scoreable regions (inter-talk silence etc.)
_NON_SCORED = "ignore_time_segment_in_scoring"


@dataclasses.dataclass
class StmSegment:
    """One scoreable segment of an NIST STM transcript file."""

    recording: str
    start: float
    end: float
    text: str

    @property
    def duration(self) -> float:
        return self.end - self.start


def parse_stm(stm_file: str) -> List[StmSegment]:
    """Parse an STM segment list.

    Line layout: ``<recording> <channel> <speaker> <start> <end> <label>
    <transcript...>``. Non-scoreable segments are dropped, and the text is
    NFKD-folded to ASCII (TED-LIUM transcripts carry typographic apostrophes
    and accented characters the 29-char label alphabet cannot express;
    accent-stripped letters survive where raw bytes would be dropped by the
    label encoder).
    """
    segments: List[StmSegment] = []
    with open(stm_file, encoding="utf-8") as fh:
        for raw in fh:
            fields = raw.split(None, 6)
            if len(fields) < 7:
                continue
            text = fields[6].strip()
            if text == _NON_SCORED:
                continue
            folded = unicodedata.normalize("NFKD", text)
            folded = folded.encode("ascii", "ignore").decode("ascii")
            segments.append(StmSegment(recording=fields[0],
                                       start=float(fields[3]),
                                       end=float(fields[4]),
                                       text=folded))
    return segments


def prepare_dir(ted_dir: str, sample_rate: int, min_len_sec: float = 1.0) -> None:
    converted = os.path.join(ted_dir, "converted")
    wav_dir = os.path.join(converted, "wav")
    txt_dir = os.path.join(converted, "txt")
    os.makedirs(wav_dir, exist_ok=True)
    os.makedirs(txt_dir, exist_ok=True)
    for sph_file in sorted(os.listdir(os.path.join(ted_dir, "sph"))):
        talk = sph_file.split(".sph")[0]
        stm_path = os.path.join(ted_dir, "stm", f"{talk}.stm")
        if not os.path.exists(stm_path):
            continue
        segments = [s for s in parse_stm(stm_path) if s.duration > min_len_sec]
        audio, sr = read_sphere(os.path.join(ted_dir, "sph", sph_file))
        if sr != sample_rate:
            audio = resample(audio, sr, sample_rate)
            sr = sample_rate
        for uid, seg in enumerate(segments):
            clip = audio[int(seg.start * sr):int(seg.end * sr)]
            stem = f"{seg.recording}_{uid}"
            save_wav(os.path.join(wav_dir, stem + ".wav"), clip, sr)
            with open(os.path.join(txt_dir, stem + ".txt"), "w",
                      encoding="utf-8") as f:
                f.write(seg.text.strip().upper())


def main() -> None:
    parser = argparse.ArgumentParser(description="Processes and downloads TED-LIUMv2 dataset.")
    parser = add_data_opts(parser)
    parser.add_argument("--target-dir", default="TEDLIUM_dataset/", type=str)
    parser.add_argument("--tar-path", type=str, default=None,
                        help="Path to the TEDLIUM_release tar if downloaded (Optional).")
    args = parser.parse_args()

    os.makedirs(args.target_dir, exist_ok=True)
    unpacked = os.path.join(args.target_dir, "TEDLIUM_release2")
    if args.tar_path and os.path.exists(args.tar_path):
        target_file = args.tar_path
    else:
        target_file = os.path.join(args.target_dir, "TEDLIUM_release2.tar.gz")
        download(TED_LIUM_V2_DL_URL, target_file)
    if not os.path.exists(unpacked):
        print("Unpacking corpus...")
        extract(target_file, args.target_dir)

    train_dir = os.path.join(unpacked, "train")
    val_dir = os.path.join(unpacked, "dev")
    test_dir = os.path.join(unpacked, "test")
    for d in (train_dir, val_dir, test_dir):
        prepare_dir(d, args.sample_rate)
    print("Creating manifests...")
    create_manifest(train_dir, "ted_train_manifest.json", args.manifest_dir,
                    min_duration=args.min_duration, max_duration=args.max_duration)
    create_manifest(val_dir, "ted_val_manifest.json", args.manifest_dir)
    create_manifest(test_dir, "ted_test_manifest.json", args.manifest_dir)


if __name__ == "__main__":
    main()
