"""Convert an ARPA language model to the mmap-ready DSLMBIN2 binary.

Counterpart of dsjax's tools/build_lm_binary.py, the equivalent of KenLM's
build_binary (the reference's ctcdecode loads KenLM binaries, reference
decoder.py:69-74): the host beam loads it in O(1) through mmap and queries
it by binary search, and the device beam packs its tables from it.

    python -m dsjax_torch.build_lm_binary lm.arpa lm.bin
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

from dsjax_torch.decode.native_beam import build_lm_binary


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    build_lm_binary(argv[0], argv[1])
    print(f"wrote {argv[1]} ({os.path.getsize(argv[1])} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
