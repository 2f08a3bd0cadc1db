"""``python -m tpu_ddp_torch.main_no_ddp``: one process on one device, the
port's counterpart of the root ``main_no_ddp.py`` and of the reference's.

The reference's quirk is kept: its ``prepare()`` hard-codes batch 64, so
``--batch-size`` defaults to 64 here, and ``--n-devices`` to 1 (the root
``main_no_ddp.py`` passes it too; under the launcher it then refuses more
than one rank). Every other flag goes to
``python -m tpu_ddp_torch.cli.train`` as it is.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from tpu_ddp_torch.cli.train import main as train_main


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--batch-size") for a in argv):
        argv = ["--batch-size", "64"] + argv
    if not any(a.startswith("--n-devices") for a in argv):
        argv = ["--n-devices", "1"] + argv
    train_main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
