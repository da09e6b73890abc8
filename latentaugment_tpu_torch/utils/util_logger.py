"""Stdout/stderr tee logger (counterpart:
latentaugment_tpu/utils/util_logger.py). Installing a Logger redirects
sys.stdout and sys.stderr so that everything printed is also appended to
a log file."""

import sys


class Logger:
    """Tee stdout/stderr to a file. Safe to stack; `close()` restores."""

    def __init__(self, file_name=None, file_mode="a", should_flush=True):
        self.file = open(file_name, file_mode) if file_name is not None else None
        self.should_flush = should_flush
        self.stdout = sys.stdout
        self.stderr = sys.stderr
        sys.stdout = self
        sys.stderr = self

    def __enter__(self):
        return self

    def __exit__(self, *_):
        self.close()

    def write(self, text):
        if len(text) == 0:
            return
        if self.file is not None:
            self.file.write(text)
        self.stdout.write(text)
        if self.should_flush:
            self.flush()

    def flush(self):
        if self.file is not None:
            self.file.flush()
        self.stdout.flush()

    def close(self):
        self.flush()
        if sys.stdout is self:
            sys.stdout = self.stdout
        if sys.stderr is self:
            sys.stderr = self.stderr
        if self.file is not None:
            self.file.close()
            self.file = None
