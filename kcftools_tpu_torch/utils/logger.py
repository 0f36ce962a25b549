"""Timestamped console logger.

Mirrors the behavioral contract of the reference CLI's logger
(reference: Utils/Logger.java): INFO/WARNING/DEBUG go to stdout with a
timestamp; ``error`` is fail-fast and terminates the process with exit
code 1 (the reference has no recoverable error paths - every error is
fatal; see Utils/Logger.java:29-31).
"""

import os
import sys
import datetime


class KcfError(SystemExit):
    """Raised by Logger.error; carries exit status 1."""

    def __init__(self, message: str):
        self.message = message
        super().__init__(1)


class Logger:
    DEBUG_ENABLED = bool(os.environ.get("KCFTOOLS_DEBUG"))
    _EXIT_ON_ERROR = True

    @staticmethod
    def _stamp() -> str:
        return datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")

    @classmethod
    def info(cls, name: str, msg: str):
        print(f"[{cls._stamp()}] INFO  [{name}] {msg}", flush=True)

    @classmethod
    def warning(cls, name: str, msg: str):
        print(f"[{cls._stamp()}] WARN  [{name}] {msg}", flush=True)

    @classmethod
    def debug(cls, name: str, msg: str):
        if cls.DEBUG_ENABLED:
            print(f"[{cls._stamp()}] DEBUG [{name}] {msg}", flush=True)

    @classmethod
    def error(cls, name: str, msg: str):
        print(f"[{cls._stamp()}] ERROR [{name}] {msg}", file=sys.stderr, flush=True)
        raise KcfError(msg)
