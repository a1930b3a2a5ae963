#!/usr/bin/env python
"""Validate telemetry JSONL streams and BENCH_*.json artifacts against
the versioned schemas, with the PyTorch port's own validator
(``pulsar_tlaplus_tpu_torch/obs/schema.py``; no JAX needed).

    python scripts/torch_check_telemetry_schema.py run.jsonl BENCH_r05.json
    python scripts/torch_check_telemetry_schema.py --all-bench
    python scripts/torch_check_telemetry_schema.py --trace out.json
    python scripts/torch_check_telemetry_schema.py --ledger ledger.jsonl
    python scripts/torch_check_telemetry_schema.py --metrics scrape.txt
    python scripts/torch_check_telemetry_schema.py --profile SIG.json
    python scripts/torch_check_telemetry_schema.py --tokens tokens.json
    python scripts/torch_check_telemetry_schema.py --warm STATE/warm/<dir>

File kind is sniffed by extension: ``.jsonl`` = event stream, ``.json``
= bench artifact (``--profile``: a tuned profile of ``cli tune``;
``--tokens``: a daemon tokens file; ``--warm``: a warm artifact dir or
its manifest.json).  Exit status: 0 clean, 1 violations (listed on
stderr), 2 usage.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import List

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from pulsar_tlaplus_tpu_torch.obs.schema import (  # noqa: E402
    validate_bench_artifact,
    validate_profile_file,
    validate_stream,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="validate telemetry streams (.jsonl) and bench "
        "artifacts (.json) against the versioned schemas"
    )
    ap.add_argument("files", nargs="*",
                    help=".jsonl streams / .json artifacts")
    ap.add_argument("--all-bench", action="store_true",
                    help="also validate every BENCH_*.json in the repo "
                    "root")
    ap.add_argument("--trace", action="store_true",
                    help="treat the .json files as exported traces "
                    "(cli.py trace output)")
    ap.add_argument("--ledger", action="store_true",
                    help="treat the .jsonl files as regression ledgers "
                    "(cli.py ledger output)")
    ap.add_argument("--metrics", action="store_true",
                    help="treat the files as Prometheus exposition text "
                    "(cli.py metrics output)")
    ap.add_argument("--profile", action="store_true",
                    help="treat the .json files as tuned-profile files "
                    "(cli tune output; tune/profiles.py)")
    ap.add_argument("--tokens", action="store_true",
                    help="treat the .json files as daemon tokens files "
                    "(serve --tokens; service/auth.py)")
    ap.add_argument("--warm", action="store_true",
                    help="treat the paths as warm-artifact dirs (or their "
                    "manifest.json): manifest shape, port tag, SHA-256 "
                    "digests (warm/store.py)")
    args = ap.parse_args(argv)
    files = list(args.files)
    if args.all_bench:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        files += sorted(glob.glob(os.path.join(root, "BENCH_*.json")))
    if not files:
        ap.error("nothing to validate (pass files or --all-bench)")
    errors: List[str] = []
    for p in files:
        if args.metrics:
            from pulsar_tlaplus_tpu_torch.obs.metrics import (
                validate_exposition,
            )

            try:
                with open(p) as fh:
                    errors += validate_exposition(fh.read(), label=p)
            except OSError as e:
                errors += [f"{p}: unreadable ({e})"]
        elif args.warm:
            from pulsar_tlaplus_tpu_torch.warm.store import validate_artifact

            errors += validate_artifact(p)
        elif p.endswith(".jsonl"):
            if args.ledger:
                from pulsar_tlaplus_tpu_torch.obs.ledger import (
                    validate_ledger,
                )

                errors += validate_ledger(p)
            else:
                errors += validate_stream(p)
        elif args.trace:
            from pulsar_tlaplus_tpu_torch.obs.trace import validate_trace

            errors += validate_trace(p)
        elif args.profile:
            errors += validate_profile_file(p)
        elif args.tokens:
            from pulsar_tlaplus_tpu_torch.service.auth import (
                validate_tokens_file,
            )

            errors += validate_tokens_file(p)
        else:
            errors += validate_bench_artifact(p)
    for e in errors:
        print(e, file=sys.stderr)
    print(f"{len(files)} file(s), {len(errors)} violation(s)",
          file=sys.stderr)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
