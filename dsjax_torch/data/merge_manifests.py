"""Merge manifests CLI: a copy of data/merge_manifests.py on the port's
manifest code (reference parity: data/merge_manifests.py).

    python -m dsjax_torch.data.merge_manifests a_manifest.json b_manifest.json \
        --name merged --out data/
"""
import argparse

from dsjax_torch.data.manifest import merge_manifests


def main() -> None:
    p = argparse.ArgumentParser(description="Merges all manifest JSON files found in input folder.")
    p.add_argument("manifests", metavar="m", nargs="+", help="Path to all manifest files you want to merge.")
    p.add_argument("-e", "--extension", default="wav", type=str, help="Audio file extension")
    p.add_argument("--name", default="merged_manifest", type=str, help="Merged dataset name")
    p.add_argument("--out", default="./", type=str, help="Output directory")
    args = p.parse_args()
    out = merge_manifests(args.manifests, args.name, args.out)
    print(out)


if __name__ == "__main__":
    main()
