"""AN4 dataset prep: a copy of dsjax/datasets/an4.py (reference parity:
data/an4.py:11-57).

Downloads the V3.0 an4.tar.gz (wav + txt already paired) into the working
directory, extracts train/val/test, and writes duration-sorted manifests.

    python -m dsjax_torch.datasets.an4 --target-dir an4_dataset --manifest-dir data/
"""

from __future__ import annotations

import argparse
import os

from dsjax_torch.data.manifest import create_manifest
from dsjax_torch.datasets.common import add_data_opts, download, extract

AN4_URL = "https://github.com/SeanNaren/deepspeech.pytorch/releases/download/V3.0/an4.tar.gz"


def download_an4(target_dir: str, manifest_dir: str, min_duration: float,
                 max_duration: float, num_workers: int = 0) -> None:
    raw_tar_path = "an4.tar.gz"
    download(AN4_URL, raw_tar_path)
    extract(raw_tar_path, target_dir)
    print("Creating manifests...")
    create_manifest(data_path=os.path.join(target_dir, "train"),
                    output_name="an4_train_manifest.json",
                    manifest_path=manifest_dir,
                    min_duration=min_duration, max_duration=max_duration)
    create_manifest(data_path=os.path.join(target_dir, "val"),
                    output_name="an4_val_manifest.json",
                    manifest_path=manifest_dir,
                    min_duration=min_duration, max_duration=max_duration)
    create_manifest(data_path=os.path.join(target_dir, "test"),
                    output_name="an4_test_manifest.json",
                    manifest_path=manifest_dir)


def main() -> None:
    parser = argparse.ArgumentParser(description="Processes and downloads an4.")
    parser = add_data_opts(parser)
    parser.add_argument("--target-dir", default="an4_dataset/", help="Path to save dataset")
    args = parser.parse_args()
    assert args.sample_rate == 16000, "AN4 only supports sample rate of 16000 currently."
    download_an4(args.target_dir, args.manifest_dir, args.min_duration,
                 args.max_duration, args.num_workers)


if __name__ == "__main__":
    main()
