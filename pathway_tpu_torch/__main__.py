"""``python -m pathway_tpu_torch <command>``: the CLI of ``cli.py``
(``spawn``, ``spawn-from-env``, ``plan``, ``profile``, ``run``,
``dashboard``)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
