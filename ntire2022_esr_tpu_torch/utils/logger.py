"""File + stream logging (counterpart of ``ntire2022_esr_tpu/utils/logger.py``)."""

from __future__ import annotations

import datetime
import logging
import sys


def logger_info(logger_name: str, log_path: str = "default_logger.log") -> None:
    """Idempotently set up a named logger writing to a file and stderr."""
    log = logging.getLogger(logger_name)
    if log.hasHandlers():
        log.info(f"LogHandlers exist! ({logger_name})")
        return
    formatter = logging.Formatter("%(asctime)s.%(msecs)03d : %(message)s", datefmt="%y-%m-%d %H:%M:%S")
    fh = logging.FileHandler(log_path, mode="a")
    fh.setFormatter(formatter)
    log.setLevel(logging.INFO)
    log.addHandler(fh)
    sh = logging.StreamHandler()
    sh.setFormatter(formatter)
    log.addHandler(sh)


def timestamp() -> str:
    return datetime.datetime.now().strftime("%y%m%d-%H%M%S")


class logger_print:
    """Tee what is written to stdout into a log file (the reference's
    ``utils_logger.logger_print``). Assign an instance to ``sys.stdout`` to
    mirror prints into ``log_path``; ``close()`` releases the file and
    restores nothing, as in the reference."""

    def __init__(self, log_path: str = "default.log"):
        self.terminal = sys.stdout
        self.log = open(log_path, "a")

    def write(self, message: str) -> None:
        self.terminal.write(message)
        self.log.write(message)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.log.close()
