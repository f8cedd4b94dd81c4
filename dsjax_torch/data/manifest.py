"""Manifest creation/verification utilities: a copy of dsjax/data/manifest.py.

Reference format (deepspeech_pytorch/data/utils.py:13-68): a JSON file
{"root_path": str, "samples": [{"wav_path": rel, "transcript_path": rel}]}
sorted by audio duration with optional min/max duration pruning. Directory
mode pairs ``**/*.wav`` with ``/wav/ -> /txt/`` transcript paths
(reference: loader/data_loader.py:221-235).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Optional, Tuple

from dsjax_torch.audio.io import duration as wav_duration


def parse_input(input_path: str) -> List[Tuple[str, str]]:
    """Manifest file or dataset dir -> [(wav_path, transcript_path)]."""
    ids: List[Tuple[str, str]] = []
    if os.path.isdir(input_path):
        for wav_path in sorted(Path(input_path).rglob("*.wav")):
            transcript_path = str(wav_path).replace("/wav/", "/txt/").replace(".wav", ".txt")
            ids.append((str(wav_path), transcript_path))
    else:
        with open(input_path) as f:
            manifest = json.load(f)
        root = manifest.get("root_path", "")
        for sample in manifest["samples"]:
            ids.append((os.path.join(root, sample["wav_path"]),
                        os.path.join(root, sample["transcript_path"])))
    return ids


def create_manifest(data_path: str, output_name: str, manifest_path: str,
                    num_workers: int = 0, min_duration: Optional[float] = None,
                    max_duration: Optional[float] = None, file_extension: str = "wav"
                    ) -> str:
    """Build a duration-sorted manifest from a dataset directory
    (reference: deepspeech_pytorch/data/utils.py:13-44)."""
    data_path = os.path.abspath(data_path)
    file_paths = sorted(str(p) for p in Path(data_path).rglob(f"*.{file_extension}"))
    if min_duration is not None or max_duration is not None:
        lo = min_duration if min_duration is not None else 0.0
        hi = max_duration if max_duration is not None else float("inf")
        file_paths = [p for p in file_paths if lo <= _safe_duration(p) <= hi]
    file_paths = sorted(file_paths, key=_safe_duration)

    os.makedirs(manifest_path, exist_ok=True)
    out = os.path.join(manifest_path, output_name)
    samples = []
    for wav_path in file_paths:
        transcript_path = wav_path.replace("/wav/", "/txt/").replace(f".{file_extension}", ".txt")
        samples.append({
            "wav_path": os.path.relpath(wav_path, data_path),
            "transcript_path": os.path.relpath(transcript_path, data_path),
        })
    with open(out, "w") as f:
        json.dump({"root_path": data_path, "samples": samples}, f, indent=2)
    return out


def _safe_duration(path: str) -> float:
    try:
        return wav_duration(path)
    except Exception:
        return 0.0


def merge_manifests(manifest_paths: List[str], name: str, out_dir: str) -> str:
    """Merge manifests by symlinking audio/transcripts into one tree
    (reference: data/merge_manifests.py)."""
    root = os.path.abspath(os.path.join(out_dir, name))
    os.makedirs(os.path.join(root, "wav"), exist_ok=True)
    os.makedirs(os.path.join(root, "txt"), exist_ok=True)
    new_samples = []
    for mp in manifest_paths:
        with open(mp) as f:
            manifest = json.load(f)
        for s in manifest["samples"]:
            for key, sub in (("wav_path", "wav"), ("transcript_path", "txt")):
                src = os.path.join(manifest["root_path"], s[key])
                base = f"{len(new_samples)}_{os.path.basename(s[key])}"
                dst = os.path.join(root, sub, base)
                if not os.path.exists(dst):
                    os.symlink(os.path.abspath(src), dst)
                s[key] = os.path.join(sub, base)
            new_samples.append(s)
    out = os.path.join(out_dir, f"{name}_manifest.json")
    with open(out, "w") as f:
        json.dump({"root_path": root, "samples": new_samples}, f, indent=2)
    return out


def verify_manifest(manifest_path: str) -> List[str]:
    """Return missing file paths (reference: data/verify_manifest.py)."""
    with open(manifest_path) as f:
        manifest = json.load(f)
    missing = []
    for s in manifest["samples"]:
        for key in ("wav_path", "transcript_path"):
            p = os.path.join(manifest["root_path"], s[key])
            if not os.path.isfile(p):
                missing.append(p)
    return missing
