"""Colored console printing (reference: pySLAM
``pyslam/utilities/logging.py`` ``Printer``).

Host-only module, copied from ``pyslam_tpu/utils/logging.py`` (the machine with the
card has no JAX, so the port cannot import the reference).
"""

from __future__ import annotations

import sys


class Colors:
    RESET = "\033[0m"
    RED = "\033[31m"
    GREEN = "\033[32m"
    YELLOW = "\033[33m"
    BLUE = "\033[34m"
    MAGENTA = "\033[35m"
    CYAN = "\033[36m"
    BOLD = "\033[1m"


def _tty() -> bool:
    return sys.stdout.isatty()


class Printer:
    @staticmethod
    def _p(color, *args):
        msg = " ".join(str(a) for a in args)
        if _tty():
            print(f"{color}{msg}{Colors.RESET}")
        else:
            print(msg)

    @staticmethod
    def red(*args):
        Printer._p(Colors.RED, *args)

    @staticmethod
    def green(*args):
        Printer._p(Colors.GREEN, *args)

    @staticmethod
    def yellow(*args):
        Printer._p(Colors.YELLOW, *args)

    @staticmethod
    def blue(*args):
        Printer._p(Colors.BLUE, *args)

    @staticmethod
    def cyan(*args):
        Printer._p(Colors.CYAN, *args)

    @staticmethod
    def gray(*args):
        Printer._p(Colors.CYAN, *args)

    @staticmethod
    def orange(*args):
        Printer._p(Colors.YELLOW, *args)

    @staticmethod
    def error(*args):
        Printer._p(Colors.RED + Colors.BOLD, "[ERROR]", *args)

    @staticmethod
    def warning(*args):
        Printer._p(Colors.YELLOW, "[WARNING]", *args)
