#!/usr/bin/env python
"""Host-sync check of the port: the `host-sync` rule of
`wam_tpu_torch.lint` with the output contract of
`scripts/check_host_syncs.py` (absolute-path findings in sorted-file order,
a ``torch_check_host_syncs: N files, M findings`` summary, exit 1 on any
finding). ``python -m wam_tpu_torch.lint --all`` runs it with the other
five rules, pragmas and JSON/SARIF output.

Usage: python scripts/torch_check_host_syncs.py [paths...]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from wam_tpu_torch.lint.compat import legacy_host_sync_main  # noqa: E402


def main(argv=None) -> int:
    return legacy_host_sync_main(argv)


if __name__ == "__main__":
    sys.exit(main())
