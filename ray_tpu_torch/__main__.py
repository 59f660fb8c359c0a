"""Command line: ``python -m ray_tpu_torch <command>``
(see scripts/cli.py)."""
from .scripts.cli import main

if __name__ == "__main__":
    main()
