"""Verify manifest CLI: a copy of data/verify_manifest.py on the port's
manifest code (reference parity: data/verify_manifest.py). Exits 1 when a
listed file is missing.

    python -m dsjax_torch.data.verify_manifest data/an4_*_manifest.json
"""
import argparse

from dsjax_torch.data.manifest import verify_manifest


def main() -> None:
    p = argparse.ArgumentParser(description="Verifies that all audio/transcript files in a manifest exist.")
    p.add_argument("manifests", metavar="m", nargs="+")
    args = p.parse_args()
    ok = True
    for m in args.manifests:
        missing = verify_manifest(m)
        for path in missing:
            ok = False
            print(f"MISSING: {path}")
        if not missing:
            print(f"{m}: OK")
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
