"""Module entry point: ``python -m gblastn_tpu_torch <command> ...``."""
import sys

from gblastn_tpu_torch.cli.main import main

sys.exit(main())
