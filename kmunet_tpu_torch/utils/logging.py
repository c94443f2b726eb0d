"""Logging: a rotating-file logger and CSV epoch logs (port of
``kmunet_tpu/utils/logging.py``; the reference's models/utils.py:28-49
``get_logger`` and the per-epoch CSV rows of train_shanghai.py:404-422)."""

from __future__ import annotations

import csv
import logging
import os
from logging.handlers import TimedRotatingFileHandler


def get_logger(filename: str, name: str = "kmunet", when: str = "D",
               backups: int = 7) -> logging.Logger:
    """The logger ``name`` at INFO, writing to ``filename`` (rotated every
    ``when``, ``backups`` kept) and to the console; made once per name."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    fh = TimedRotatingFileHandler(filename, when=when, backupCount=backups)
    fh.setFormatter(fmt)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger


class CSVLogger:
    """Append-per-row CSV with lazily-fixed header."""

    def __init__(self, path: str):
        self.path = path
        self._fields = None

    def log(self, row: dict) -> None:
        new = not os.path.exists(self.path)
        if self._fields is None:
            self._fields = list(row)
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields, extrasaction="ignore")
            if new:
                w.writeheader()
            w.writerow(row)
