#!/usr/bin/env python3
"""Print the sha256 of B7's bf16 forward output and lse bits at the
prefill's layer (``chip_smoke.forward_bits``) as one JSON line, for the
repo's build or another checkout's.

    python3 tools/flash_fwd_bits.py [--src OTHER_CHECKOUT/src]

With ``--src`` the kernels come from that checkout's ``repro_torch`` (and
build into its own ``build/``).  Two checkouts whose forward kernels give
the same bits print the same line.  Needs one CUDA card.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (puts this repo's src on the path)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", help="a checkout's src directory to take "
                    "repro_torch from (default: this repo's)")
    args = ap.parse_args()
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("flash_fwd_bits: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    bits = chip_smoke.forward_bits(torch, torch.device("cuda"))
    print(json.dumps({"repro_torch": os.path.dirname(repro_torch.__file__),
                      **bits}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
