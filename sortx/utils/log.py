"""Channel-filtered file logger.

Analog of the reference's ``LogWriter`` singleton
(``Tahoe/Base/Config.inl:25-114``): a process-wide logger writing to
``sortx.log`` with a bitmask of channels (Base/Error/Debug/Io/Device/...)
and compile-time-style level filtering via ``SORTX_LOG_LEVEL``.
Unlike the reference (which reopens the file per message), we keep the
handle open and flush per message.
"""

from __future__ import annotations

import os
import threading
import time
from enum import IntFlag

__all__ = ["Channel", "LogWriter", "log", "log_error", "log_debug"]


class Channel(IntFlag):
    """Log channels (Tahoe/Base/Config.h:10-18 bitmask analog)."""

    NONE = 0
    BASE = 1 << 0
    ERROR = 1 << 1
    DEBUG = 1 << 2
    IO = 1 << 3
    DEVICE = 1 << 4  # reference: Gpu channel
    PERF = 1 << 5
    ALL = (1 << 6) - 1


class LogWriter:
    """Singleton file logger with channel filtering."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self, path: str | None = None, channels: Channel = Channel.ALL):
        self.path = path or os.environ.get("SORTX_LOG_FILE", "sortx.log")
        self.channels = channels
        self.level = int(os.environ.get("SORTX_LOG_LEVEL", "1"))
        self._fh = None
        self._fh_lock = threading.Lock()

    @classmethod
    def instance(cls) -> "LogWriter":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def set_channels(self, channels: Channel) -> None:
        self.channels = channels

    def write(self, channel: Channel, msg: str) -> None:
        if self.level <= 0 or not (channel & self.channels):
            return
        with self._fh_lock:
            if self._fh is None:
                self._fh = open(self.path, "a", buffering=1)
            ts = time.strftime("%H:%M:%S")
            self._fh.write(f"[{ts}] [{channel.name}] {msg}\n")

    def close(self) -> None:
        with self._fh_lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def log(msg: str, channel: Channel = Channel.BASE) -> None:
    LogWriter.instance().write(channel, msg)


def log_error(msg: str) -> None:
    LogWriter.instance().write(Channel.ERROR, msg)


def log_debug(msg: str) -> None:
    if LogWriter.instance().level >= 3:
        LogWriter.instance().write(Channel.DEBUG, msg)
