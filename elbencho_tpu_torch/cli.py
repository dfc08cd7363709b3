"""CLI entry point of the PyTorch/CUDA port (elbencho-tpu-torch).

Rebuild of the reference's source/Main.cpp: parse args, delegate to the
Coordinator, map top-level exceptions to exit codes (Main.cpp:10-64).
"""

from __future__ import annotations

import sys

from .config import config_from_args
from .coordinator import Coordinator
from .engine import NativeFileError
from .exceptions import ProgException
from .logger import LOGGER
from .utils.signals import install_early_interrupt_latch, register_fault_handlers


def main(argv: list[str] | None = None) -> int:
    install_early_interrupt_latch()
    register_fault_handlers()
    try:
        cfg = config_from_args(argv)
        LOGGER.level = cfg.log_level
        return Coordinator(cfg).main()
    except (ProgException, NativeFileError) as e:
        LOGGER.error(str(e))
        return 1
    except KeyboardInterrupt:
        LOGGER.error("killed by interrupt")
        return 130
    except BrokenPipeError:
        # output piped into a pager/head that closed early - not an error;
        # point stdout at devnull so interpreter-exit flushes stay quiet
        import os

        try:
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        except OSError:
            pass
        return 0


if __name__ == "__main__":
    sys.exit(main())
