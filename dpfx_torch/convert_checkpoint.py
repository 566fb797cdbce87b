"""Convert a reference-layout torch checkpoint into the port's weights.

Usage:
    python -m dpfx_torch.convert_checkpoint CKPT.pt CONFIG --out WEIGHTS.pt \\
        [--rules rules.yaml] [--no-strict]

The tensors are renamed and transposed by ``dpfx_torch.compat.convert``'s
rules (``DEFAULT_RULES``, or a YAML rules file such as
``configs/convert_rules_example.yaml``) and checked against the model that
CONFIG builds; a key no rule matches raises unless ``--no-strict``. The
output is a ``.pt`` state dict that ``--weights`` of
``python -m dpfx_torch.generate`` and ``python -m dpfx_torch.evaluate``
read. Runs on the CPU.
"""

from __future__ import annotations

import argparse
import shlex
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("checkpoint")
    ap.add_argument("config")
    ap.add_argument("--out", required=True, help="the port's .pt state dict to write")
    ap.add_argument("--rules", default=None, help="a YAML rules file (default: DEFAULT_RULES)")
    ap.add_argument("--no-strict", action="store_true", help="skip keys no rule matches")
    args = ap.parse_args(argv)

    import torch

    from dpfx_torch.compat.convert import DEFAULT_RULES, load_rules_file, load_torch_checkpoint
    from dpfx_torch.config import load_config

    cfg = load_config(args.config)
    rules = load_rules_file(args.rules) if args.rules else DEFAULT_RULES
    sd = load_torch_checkpoint(args.checkpoint, cfg, rules, strict=not args.no_strict)
    torch.save(sd, args.out)
    print(f"[dpfx_torch] converted {args.checkpoint} -> {args.out} ({len(sd)} tensors, "
          "verified against the config)")
    print(f"[dpfx_torch] sample with: python -m dpfx_torch.generate {shlex.quote(args.config)} "
          f"--weights {shlex.quote(args.out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
