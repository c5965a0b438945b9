"""Rank-gated console/file logger with padded banner lines.

Parity target: the reference ``Logger`` (src/utils.py:42-79): rank-0-only
logging to stdout and an optional file, ``pad=True`` centers the message in a
bed of '=' characters, ``line()`` prints a full separator row.
"""

import logging
import sys


class Logger:
    def __init__(self, log_file=None, enabled=True, pad_length=50):
        self._logger = self._build(log_file) if enabled else None
        self._pad_length = pad_length

    def _pad(self, message):
        return (" " + message + " ").center(self._pad_length, "=")

    def info(self, message, pad=False):
        if self._logger is not None:
            self._logger.info(self._pad(str(message)) if pad else message)

    def line(self):
        if self._logger is not None:
            self._logger.info("=" * self._pad_length)

    @staticmethod
    def _build(log_file=None):
        logger = logging.getLogger("kmbart_tpu")
        logger.setLevel(logging.DEBUG)
        logger.propagate = False
        # reset handlers so repeated construction doesn't duplicate output
        logger.handlers = []
        stream = logging.StreamHandler(sys.stdout)
        logger.addHandler(stream)
        if log_file is not None:
            fh = logging.FileHandler(log_file)
            fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
            logger.addHandler(fh)
        return logger
