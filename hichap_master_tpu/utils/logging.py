"""Logging/observability: rotating file logs with the reference's custom
level-21 "main" channel (scripts/hichap:453-484) plus a global excepthook
that records tracebacks in the log file."""

from __future__ import annotations

import logging
import logging.handlers
import sys

MAIN = 21
logging.addLevelName(MAIN, "main")


def get_logger(name: str = "hichap_master_tpu") -> logging.Logger:
    return logging.getLogger(name)


def setup_logging(logfile: str | None = None, console: bool = True) -> logging.Logger:
    """Install the file/console handlers, replacing the ones an earlier
    call installed (one process may run several CLI commands)."""
    root = logging.getLogger()
    root.setLevel(MAIN)
    for h in [h for h in root.handlers if getattr(h, "_hichap", False)]:
        root.removeHandler(h)
        h.close()
    fmt = logging.Formatter(
        fmt="%(asctime)s %(name)-22s %(levelname)-6s %(message)s",
        datefmt="%m-%d %H:%M:%S",
    )
    if logfile:
        fh = logging.handlers.RotatingFileHandler(
            logfile, maxBytes=10 * 1024 * 1024, backupCount=5
        )
        fh.setFormatter(fmt)
        fh.setLevel(MAIN)
        fh._hichap = True
        root.addHandler(fh)

        def excepthook(tp, value, tb):
            logging.getLogger("hichap_master_tpu").error(
                "Unhandled exception", exc_info=(tp, value, tb)
            )
            sys.__excepthook__(tp, value, tb)

        sys.excepthook = excepthook
    if console:
        ch = logging.StreamHandler()
        ch.setFormatter(fmt)
        ch.setLevel(MAIN)
        ch._hichap = True
        root.addHandler(ch)
    return get_logger()
