"""utils/logging: level-21 channel, rotating file handler, excepthook."""

import logging
import os
import sys

from hichap_master_tpu.utils.logging import MAIN, get_logger, setup_logging


def _teardown():
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    sys.excepthook = sys.__excepthook__


def test_level21_goes_to_file(tmp_path):
    logfile = str(tmp_path / "run.log")
    try:
        log = setup_logging(logfile, console=False)
        log.log(MAIN, "stage %s done", "alpha")
        logging.getLogger("hichap_master_tpu.sub").log(MAIN, "nested")
        for h in logging.getLogger().handlers:
            h.flush()
        text = open(logfile).read()
        assert "stage alpha done" in text and "nested" in text
        assert "main" in text  # the custom level name renders
    finally:
        _teardown()


def test_excepthook_records_traceback(tmp_path):
    logfile = str(tmp_path / "err.log")
    try:
        setup_logging(logfile, console=False)
        assert sys.excepthook is not sys.__excepthook__
        try:
            raise ValueError("boom-for-log")
        except ValueError:
            sys.excepthook(*sys.exc_info())
        for h in logging.getLogger().handlers:
            h.flush()
        text = open(logfile).read()
        assert "Unhandled exception" in text and "boom-for-log" in text
    finally:
        _teardown()


def test_get_logger_namespace():
    assert get_logger().name == "hichap_master_tpu"
    assert get_logger("x.y").name == "x.y"


def test_setup_twice_keeps_one_set_of_handlers(tmp_path):
    try:
        setup_logging(str(tmp_path / "a.log"))
        setup_logging(str(tmp_path / "b.log"))
        mine = [h for h in logging.getLogger().handlers
                if getattr(h, "_hichap", False)]
        assert len(mine) == 2  # one file, one console
        get_logger().log(MAIN, "only-in-b")
        for h in mine:
            h.flush()
        assert "only-in-b" in open(tmp_path / "b.log").read()
        assert "only-in-b" not in open(tmp_path / "a.log").read()
    finally:
        _teardown()
